"""Box-constrained QP solvers (projected gradient / FISTA).

BASELINE config #4: quadrotor 12-state trajopt, 4096 scenarios,
box-constrained QP via projected gradient — "logic + clip ops" in reference
terms (src/logic.c comparisons + double_math.c float_clip). Here the whole
solver is ONE jitted program per batch shape:

    U <- clip(U - (1/L) (U H' + g), lo, hi)        [PG]
    plus Nesterov momentum with adaptive restart    [FISTA]

The per-iteration core is a single (N, Tm) @ (Tm, Tm) GEMM; clip and
momentum fuse into one elementwise pass (XLA fusion — the structural win
over the reference's one-kernel-per-op eager dispatch, SURVEY.md §3.2).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from numpower_tpu.models.condensed import (
    CondensedQP, default_coarse_iters, gradient_offset,
)


class BoxQPResult(NamedTuple):
    U: jax.Array          # (N, Tm) or (Tm,) solutions
    iterations: jax.Array  # scalar: iterations executed
    residual: jax.Array    # max projected-gradient residual across batch


def solve_boxqp_pg(H, g, lo, hi, L=None, iters: int = 60, U0=None) -> BoxQPResult:
    """Plain projected gradient with fixed step 1/L. g may be batched (N, d).

    Static iteration count -> fixed-shape compiled program (the 10 ms budget
    forbids data-dependent trip counts; SURVEY.md §7 latency).
    """
    batched = g.ndim == 2
    d = H.shape[0]
    if L is None:
        L = jnp.linalg.norm(H, ord=2)
    step = 1.0 / L
    U_init = jnp.zeros_like(g) if U0 is None else U0

    def body(U, _):
        grad = U @ H.T + g if batched else H @ U + g
        U_new = jnp.clip(U - step * grad, lo, hi)
        return U_new, None

    U, _ = lax.scan(body, U_init, None, length=iters)
    grad = U @ H.T + g if batched else H @ U + g
    resid = jnp.max(jnp.abs(U - jnp.clip(U - step * grad, lo, hi)))
    return BoxQPResult(U=U, iterations=jnp.asarray(iters), residual=resid)


def solve_boxqp_fista(H, g, lo, hi, L=None, iters: int = 40, U0=None,
                      coarse_iters: int = 0) -> BoxQPResult:
    """FISTA (accelerated PG) with gradient-based adaptive restart.

    ~sqrt(kappa) fewer iterations than plain PG for the same tolerance —
    fewer GEMMs per solve.

    coarse_iters > 0 runs that many leading iterations with the GEMM in
    bf16 (bf16 operands, fp32 accumulation); the remaining
    iterations run at fp32-highest and contract the iterate to the same
    fixed point (the projection/momentum arithmetic stays fp32 throughout,
    so only the gradient is coarse). Validated to hold the 1e-4 parity
    bound in tests/test_mpc.py.
    """
    batched = g.ndim == 2
    if L is None:
        L = jnp.linalg.norm(H, ord=2)
    step = 1.0 / L
    U_init = jnp.zeros_like(g) if U0 is None else U0
    H_bf = H.astype(jnp.bfloat16)

    def make_body(coarse: bool):
        def body(carry, _):
            U, Y, t = carry
            if coarse:
                gemm = jnp.matmul(
                    Y.astype(jnp.bfloat16), H_bf.T,
                    precision=jax.lax.Precision.DEFAULT,
                    preferred_element_type=jnp.float32,
                ) if batched else jnp.matmul(
                    H_bf, Y.astype(jnp.bfloat16),
                    precision=jax.lax.Precision.DEFAULT,
                    preferred_element_type=jnp.float32,
                )
            else:
                gemm = Y @ H.T if batched else H @ Y
            grad = gemm + g
            U_new = jnp.clip(Y - step * grad, lo, hi)
            t_new = 0.5 * (1.0 + jnp.sqrt(1.0 + 4.0 * t * t))
            beta = (t - 1.0) / t_new
            # Adaptive restart (per-batch): if momentum points uphill, reset.
            dU = U_new - U
            uphill = jnp.sum(grad * dU, axis=-1, keepdims=True) > 0
            beta_eff = jnp.where(uphill, 0.0, beta)
            Y_new = U_new + beta_eff * dU
            t_eff = jnp.where(jnp.any(uphill), 1.0, t_new)
            return (U_new, Y_new, t_eff), None

        return body

    carry = (U_init, U_init, jnp.asarray(1.0, g.dtype))
    coarse_iters = min(coarse_iters, iters)
    if coarse_iters > 0:
        carry, _ = lax.scan(make_body(True), carry, None, length=coarse_iters)
        # restart momentum at the precision switch
        carry = (carry[0], carry[0], jnp.asarray(1.0, g.dtype))
    (U, _, _), _ = lax.scan(make_body(False), carry, None, length=iters - coarse_iters)
    grad = U @ H.T + g if batched else H @ U + g
    resid = jnp.max(jnp.abs(U - jnp.clip(U - step * grad, lo, hi)))
    return BoxQPResult(U=U, iterations=jnp.asarray(iters), residual=resid)


def prediction_chain(qp: CondensedQP, x_ref: Optional[jax.Array] = None):
    """(W, bias) with gradient_offset(qp, x0s, x_ref) = x0s @ W + bias:
    W = Sx'(Su'Qbar)' (n, d) folds the prediction chain into one matrix,
    bias = -Xref (Su'Qbar)' is shared by every scenario."""
    W = qp.Sx.T @ qp.SuTQ.T
    if x_ref is None:
        return W, jnp.zeros((qp.H.shape[0],), qp.H.dtype)
    xref_stack = jnp.tile(x_ref, qp.T) if x_ref.ndim == 1 else x_ref.reshape(-1)
    return W, -(xref_stack @ qp.SuTQ.T)


def solve_mpc_boxqp(
    qp: CondensedQP,
    x0s: jax.Array,
    u_lo: float,
    u_hi: float,
    x_ref: Optional[jax.Array] = None,
    iters: int = 40,
    method: str = "auto",
    U0: Optional[jax.Array] = None,
    coarse_iters: Optional[int] = None,
    interpret: bool = False,
) -> BoxQPResult:
    """Batched-scenario MPC solve on a condensed QP.

    x0s (N, n) initial states -> controls (N, T*m) clipped to [u_lo, u_hi].
    H is shared; only g varies per scenario. Warm starts via U0 (shifted
    previous solution) cut iteration counts in receding-horizon use.

    method: "auto" (the fused kernel of kernels/boxqp.py on a GPU inside
    its envelope, the XLA scan elsewhere — utils/platform.route), "pallas"
    (the kernel; the interpret flag runs it in the Pallas interpreter), "xla"
    (FISTA scan) or "pg" (plain projected gradient).

    Default precision policy: leading FISTA iterations run the GEMM with
    bf16 operands; an fp32 tail of ceil(6.5 sqrt(kappa)) iterations
    (kappa = qp.lipschitz/qp.mu, see condensed.default_coarse_iters)
    contracts to the fp32 fixed point. Pass coarse_iters=0 to force
    all-fp32. Inside jit (traced qp) the default degrades to all-fp32
    unless condense() ran eagerly — pass coarse_iters explicitly there.
    """
    from numpower_tpu.kernels import boxqp as kernels
    from numpower_tpu.utils.platform import route

    if coarse_iters is None:
        coarse_iters = default_coarse_iters(qp, iters)
    if method == "pg":
        g = gradient_offset(qp, x0s, x_ref)
        return solve_boxqp_pg(qp.H, g, u_lo, u_hi, L=qp.lipschitz,
                              iters=iters, U0=U0)
    path = route(method, fits=kernels.fits(qp.H.shape[0], qp.n) and
                 x0s.ndim == 2, interpret=interpret)
    if path != "xla":
        W, bias = prediction_chain(qp, x_ref)
        U, resid = kernels.fista_mpc(
            qp.H, W, bias, x0s, u_lo, u_hi, qp.lipschitz, iters=iters,
            coarse_iters=coarse_iters, U0=U0,
            interpret=path == "interpret")
        return BoxQPResult(U=U, iterations=jnp.asarray(iters), residual=resid)
    g = gradient_offset(qp, x0s, x_ref)
    return solve_boxqp_fista(qp.H, g, u_lo, u_hi, L=qp.lipschitz, iters=iters,
                             U0=U0, coarse_iters=coarse_iters)
