"""Condensed QP formation for linear MPC.

Eliminates states to produce a dense QP over the stacked control sequence
U = [u_0; ...; u_{T-1}] (dimension T*m):

    X = Sx x0 + Su U
    J(U) = 1/2 U' H U + (g(x0))' U + const
    H = Su' Qbar Su + Rbar          (shared across scenarios for LTI plants)
    g(x0) = Su' Qbar (Sx x0 - Xref)

The key structure (BASELINE north star): H is scenario-INDEPENDENT, so a
4096-scenario solve is projected-gradient iterations whose core op is one
(N, T*m) x (T*m, T*m) matmul — a static-shape batched GEMM — instead of
4096 tiny Riccati factorizations. For quadrotor T=30, m=4 the GEMM is
(4096, 120) @ (120, 120).

The reference could only express this as thousands of eager nd::matmul calls
(SURVEY.md §3.2-3.4); here formation and solve are each one jitted program.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax


_STATIC = dict(static=True)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class CondensedQP:
    """Dense condensed QP data. H (Tm, Tm); Sx (Tn, n); Su (Tn, Tm);
    SuTQ (Tm, Tn) caches Su' Qbar for fast g(x0) formation.

    A pytree whose (T, n, m) dims are static aux data, so a CondensedQP can
    be passed as a jit ARGUMENT. Closure-capturing it instead would embed the
    device arrays as HLO constants, forcing device->host fetches at trace
    time."""

    H: jax.Array
    Sx: jax.Array
    Su: jax.Array
    SuTQ: jax.Array
    lipschitz: jax.Array  # largest eigenvalue of H (PG step size 1/L)
    mu: jax.Array  # strong-convexity lower bound: lam_min(R) <= lam_min(H)
    T: int = dataclasses.field(metadata=_STATIC)
    n: int = dataclasses.field(metadata=_STATIC)
    m: int = dataclasses.field(metadata=_STATIC)
    # Static condition-number bound lipschitz/mu, snapshotted at condense()
    # time (where it is concrete). Because it is aux data, jitted consumers
    # can derive a STATIC mixed-precision schedule from it without a device
    # readback (see default_coarse_iters). None when condense() itself was
    # traced.
    kappa: Optional[float] = dataclasses.field(default=None, metadata=_STATIC)


def prediction_matrices(A, B, horizon: int):
    """Sx = [A; A^2; ...; A^T], Su lower-block-triangular with blocks
    A^{i-j-1} B. Built with a scan over powers (T matmuls, one compile)."""
    n, m = A.shape[0], B.shape[1]
    T = horizon

    def power_step(Ak, _):
        Ak_next = A @ Ak
        return Ak_next, Ak

    _, A_pows = lax.scan(power_step, jnp.eye(n, dtype=A.dtype), None, length=T + 1)
    # A_pows[k] = A^k, k = 0..T
    Sx = jnp.concatenate([A_pows[k] for k in range(1, T + 1)], axis=0)  # (T n, n)

    # Su block (i, j) = A^{i-j-1} B for i > j else 0  (block row i = state x_{i+1})
    AB = jax.vmap(lambda Ak: Ak @ B)(A_pows)  # AB[k] = A^k B
    blocks = []
    zeros = jnp.zeros((n, m), A.dtype)
    for i in range(T):
        row = [AB[i - j] if i >= j else zeros for j in range(T)]
        blocks.append(jnp.concatenate(row, axis=1))
    Su = jnp.concatenate(blocks, axis=0)  # (T n, T m)
    return Sx, Su


def _power_iteration_lmax(H, iters: int = 50):
    """Largest eigenvalue of symmetric PSD H by power iteration (static
    iteration count; runs once at formation time, inside jit)."""
    v0 = jnp.ones((H.shape[0],), H.dtype) / jnp.sqrt(jnp.asarray(H.shape[0], H.dtype))

    def step(v, _):
        w = H @ v
        return w / (jnp.linalg.norm(w) + 1e-30), None

    v, _ = lax.scan(step, v0, None, length=iters)
    return v @ (H @ v)


def condense(A, B, Q, R, QF, horizon: int) -> CondensedQP:
    """Form the condensed QP for an LTI plant with stage costs
    sum_{t=1..T} x_t' Qt x_t + sum_t u_t' R u_t (Qt = Q for t<T, QF at T)."""
    n, m = A.shape[0], B.shape[1]
    T = horizon
    Sx, Su = prediction_matrices(A, B, T)
    # Qbar = blockdiag(Q, ..., Q, QF); apply blockwise without materializing.
    Qbar = jax.scipy.linalg.block_diag(*([Q] * (T - 1) + [QF]))
    Rbar = jax.scipy.linalg.block_diag(*([R] * T))
    SuTQ = Su.T @ Qbar
    H = SuTQ @ Su + Rbar
    H = 0.5 * (H + H.T)
    lmax = _power_iteration_lmax(H)
    # H = Su' Qbar Su + Rbar >= Rbar, so lam_min(H) >= lam_min(R): a cheap,
    # usually-tight strong-convexity bound (m is tiny, eigvalsh is free).
    # Consumers use lipschitz/mu as the condition-number bound to size the
    # fp32 tail of mixed-precision solves and the ADMM penalty rho.
    mu = jnp.linalg.eigvalsh(0.5 * (R + R.T))[0].astype(H.dtype)
    try:
        # Concrete at eager condense() time: one setup-time scalar readback
        # buys every downstream jitted solve a static schedule (no warning,
        # no lost bf16 phase). Under a traced condense() this stays None.
        kappa = max(float(lmax) / max(float(mu), 1e-12), 1.0)
    except (jax.errors.TracerArrayConversionError,
            jax.errors.ConcretizationTypeError, TypeError):
        kappa = None
    return CondensedQP(H=H, Sx=Sx, Su=Su, SuTQ=SuTQ, T=T, n=n, m=m,
                       lipschitz=lmax, mu=mu, kappa=kappa)


def _resolve_kappa(qp: CondensedQP, caller: str):
    """Condition-number bound for the mixed-precision schedules, or None.

    qp.kappa is STATIC aux data snapshotted at condense() time, so this
    works under jit with no device readback. Only when condense() itself
    was traced (kappa=None) does it fall back to reading lipschitz/mu, and
    if those are tracers too it returns None with a one-time warning — the
    caller must then use an all-fp32 schedule."""
    if qp.kappa is not None:
        return qp.kappa
    try:
        return max(float(qp.lipschitz) / max(float(qp.mu), 1e-12), 1.0)
    except (jax.errors.TracerArrayConversionError,
            jax.errors.ConcretizationTypeError, TypeError):
        import warnings

        warnings.warn(
            f"{caller} called with a traced CondensedQP that has no static "
            "kappa: falling back to all-fp32 (no bf16 coarse phase, ~6x "
            "slower hot GEMMs). Condense eagerly or pass coarse_iters= "
            "explicitly.",
            stacklevel=4,
        )
        return None


def default_coarse_iters(qp: CondensedQP, iters: int) -> int:
    """Static bf16-coarse iteration count for mixed-precision FISTA.

    The fp32 tail must contract the bf16 fixed-point offset (~bf16_eps *
    kappa relative) below the 1e-4 parity bound; with restart-FISTA's linear
    rate (1 - 1/sqrt(kappa)) that takes O(sqrt(kappa)) iterations. Empirical
    calibration (tests/test_solvers_extra.py): tail = ceil(6.5 sqrt(kappa))
    gives ~1e-5 error at kappa=37 and reduces to the long-validated 12-13
    iteration tail on the well-conditioned flagship QP (kappa~3.6).

    Jit-safe via the static qp.kappa (_resolve_kappa); traced callers keep
    the ~6x bf16 coarse phase automatically.
    """
    import math

    kappa = _resolve_kappa(qp, "default_coarse_iters")
    if kappa is None:
        return 0
    tail = max(12, math.ceil(6.5 * math.sqrt(kappa)))
    return max(0, iters - tail)


def admm_coarse_iters(qp: CondensedQP, iters: int) -> int:
    """Static bf16-coarse iteration count for mixed-precision ADMM
    (kernels/boxqp.admm_mpc).

    Exact-solve over-relaxed ADMM contracts at rate ~(sqrt(kappa)-1)/
    (sqrt(kappa)+1) per iteration — much stronger than FISTA's at the same
    kappa, but NOT condition-independent: the fp32 tail that washes out the
    bf16 coarse-phase offset still grows as O(sqrt(kappa)). tail =
    max(8, ceil(3 sqrt(kappa))) gives the flagship (kappa~3.6) a tail of 8
    and scales ill-conditioned QPs (kappa=37 -> 19); chip_smoke.py checks
    the flagship against the fp64 optimum at 1e-4.
    Same static-kappa jit story as default_coarse_iters (_resolve_kappa).
    """
    import math

    kappa = _resolve_kappa(qp, "admm_coarse_iters")
    if kappa is None:
        return 0
    tail = max(8, math.ceil(3.0 * math.sqrt(kappa)))
    return max(0, iters - tail)


def gradient_offset(qp: CondensedQP, x0, x_ref: Optional[jax.Array] = None):
    """g(x0) = Su' Qbar (Sx x0 - Xref); x0 (n,) or batched (N, n).

    Batched path is transpose-free row-major: (x0s @ Sx') @ SuTQ' lowers to
    two clean dot_generals with no materialized transposed intermediates
    (the (SuTQ @ (Sx @ x0s.T)).T form cost an extra HBM pass per transpose).
    """
    if x0.ndim == 2:
        target = x0 @ qp.Sx.T  # (N, Tn)
        if x_ref is not None:
            xref_stack = jnp.tile(x_ref, qp.T) if x_ref.ndim == 1 else x_ref.reshape(-1)
            target = target - xref_stack
        return target @ qp.SuTQ.T  # (N, Tm)
    target = qp.Sx @ x0
    if x_ref is not None:
        xref_stack = jnp.tile(x_ref, qp.T) if x_ref.ndim == 1 else x_ref.reshape(-1)
        target = target - xref_stack
    return qp.SuTQ @ target
