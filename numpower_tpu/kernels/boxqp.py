"""Fused box-QP kernels for NVIDIA Hopper (Pallas, Triton route).

Both kernels solve the condensed MPC box-QP of BASELINE config #4,

    min 1/2 U'HU + g(x0)'U   s.t.  lo <= U <= hi,   g(x0) = x0 W + b,

for a batch of scenarios that share H. The XLA path (models/boxqp.py,
models/admm.py) issues one GEMM plus one fused elementwise pass per
iteration; at N=4096, d=120 each GEMM is ~0.12 GFLOP, too small to fill
the card, so the loop is bound by launches and round trips to HBM. Here one
program owns a tile of TILE_N scenario rows for the whole solve:

- H (or rho Minv), padded to (d_pad, d_pad), and the folded prediction chain
  W (n_pad, d_pad) are loaded once per program;
- g (or c = Minv g) is formed in the kernel from the x0 tile; the bias row b
  (the x_ref offset) rides in W as the row hit by a constant-1 column of x0;
- the iterates stay on chip for all iterations, inside `lax.fori_loop`;
- each program writes its U tile and a per-row residual; one `max` outside
  the kernel finishes the residual (blocks cannot pass values to each other).

Precision: the first `coarse_iters` products take bf16 operands with fp32
accumulation; the tail, the g/c formation and the residual products run as
3xTF32 (`_dot3`: operands split into a TF32 head and an fp32 remainder, three
tensor-core products, the remainder-by-remainder term dropped), which keeps
~fp32 accuracy.

FISTA here follows the static momentum schedule t_{k+1} = (1 + sqrt(1 +
4 t_k^2)) / 2 (no adaptive restart: restart needs a batch-wide reduction),
restarted once at the switch from the coarse phase to the tail.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

# The kernels hold one (D_MAX, D_MAX) matrix on chip per program.
D_MAX = 128
# Scenario rows per program and warps per program: the fastest of tiles
# 16/32/64 x warps 4/8 for both kernels on an H100 at the flagship QP
# (PERF.md, kernel decisions).
TILE_N = 16
NUM_WARPS = 8
_TF32_MASK = -8192  # 0xFFFFE000: keep sign, exponent and 10 mantissa bits


def _pow2(x: int, least: int) -> int:
    p = least
    while p < x:
        p *= 2
    return p


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def fits(d: int, n: int) -> bool:
    """True when a QP with d decision variables and n states fits the kernels'
    tiles: d padded to a power of two at most D_MAX, n plus the bias column
    at most D_MAX."""
    return _pow2(d, 16) <= D_MAX and _pow2(n + 1, 16) <= D_MAX


def _tf32_split(x):
    hi = lax.bitcast_convert_type(
        lax.bitcast_convert_type(x, jnp.int32) & _TF32_MASK, jnp.float32)
    return hi, x - hi


def _dot3(a, b_hi, b_lo):
    """a @ b in 3xTF32 (b pre-split by _tf32_split)."""
    a_hi, a_lo = _tf32_split(a)
    hp = lax.Precision.HIGH
    return (pl.dot(a_hi, b_hi, precision=hp) + pl.dot(a_hi, b_lo, precision=hp)
            + pl.dot(a_lo, b_hi, precision=hp))


def _dot_bf16(a, b_bf16):
    return pl.dot(a.astype(jnp.bfloat16), b_bf16)


def _pad_inputs(M, W, bias, x0s, U0, u0_fill):
    """Zero-pad the shared (d, d) matrix, the (n, d) chain plus bias row and
    the batch to power-of-two tiles. Returns the padded operands and sizes."""
    N, n = x0s.shape
    d = M.shape[0]
    d_pad, n_pad = _pow2(d, 16), _pow2(n + 1, 16)
    N_pad = _round_up(N, TILE_N)
    dt = jnp.float32
    M_p = jnp.zeros((d_pad, d_pad), dt).at[:d, :d].set(M)
    W_p = jnp.zeros((n_pad, d_pad), dt).at[:n, :d].set(W).at[n, :d].set(bias)
    x0_p = (jnp.zeros((N_pad, n_pad), dt).at[:N, :n].set(x0s)
            .at[:, n].set(1.0))
    u0_p = jnp.full((N_pad, d_pad), u0_fill, dt)
    if U0 is not None:
        u0_p = u0_p.at[:N, :d].set(U0)
    return M_p, W_p, x0_p, u0_p, (N, d, N_pad, n_pad, d_pad)


def _specs(n_pad, d_pad, n_out_rows):
    row = lambda i: (i, 0)  # noqa: E731
    whole = lambda i: (0, 0)  # noqa: E731
    in_specs = [
        pl.BlockSpec((TILE_N, n_pad), row),     # x0 tile (+ constant-1 column)
        pl.BlockSpec((n_pad, d_pad), whole),    # folded chain W (+ bias row)
        pl.BlockSpec((d_pad, d_pad), whole),    # H or rho Minv
        pl.BlockSpec((8,), lambda i: (0,)),     # scalar parameters
        pl.BlockSpec((TILE_N, d_pad), row),     # warm start
    ]
    out_specs = [pl.BlockSpec((TILE_N, d_pad), row)] + [
        pl.BlockSpec((TILE_N,), lambda i: (i,))] * n_out_rows
    return in_specs, out_specs


def _params(*vals):
    vals = [jnp.asarray(v, jnp.float32) for v in vals]
    return jnp.stack(vals + [jnp.float32(0)] * (8 - len(vals)))


def _fista_kernel(x0_ref, w_ref, h_ref, prm_ref, u0_ref, u_ref, r_ref, *,
                  iters: int, coarse_iters: int, d: int):
    step, lo, hi = prm_ref[0], prm_ref[1], prm_ref[2]
    h_hi, h_lo = _tf32_split(h_ref[...])
    h_bf = h_ref[...].astype(jnp.bfloat16)
    w_hi, w_lo = _tf32_split(w_ref[...])
    g = _dot3(x0_ref[...], w_hi, w_lo)

    def body(coarse, _, carry):
        U, Y, t = carry
        gemm = _dot_bf16(Y, h_bf) if coarse else _dot3(Y, h_hi, h_lo)
        U_new = jnp.clip(Y - step * (gemm + g), lo, hi)
        t_new = 0.5 * (1.0 + jnp.sqrt(1.0 + 4.0 * t * t))
        Y_new = U_new + ((t - 1.0) / t_new) * (U_new - U)
        return U_new, Y_new, t_new

    U = u0_ref[...]
    one = jnp.float32(1.0)
    if coarse_iters > 0:
        U, _, _ = lax.fori_loop(0, coarse_iters,
                                functools.partial(body, True), (U, U, one))
    U, _, _ = lax.fori_loop(0, iters - coarse_iters,
                            functools.partial(body, False), (U, U, one))
    u_ref[...] = U
    grad = _dot3(U, h_hi, h_lo) + g
    r = jnp.abs(U - jnp.clip(U - step * grad, lo, hi))
    cols = lax.broadcasted_iota(jnp.int32, r.shape, 1)
    r_ref[...] = jnp.max(jnp.where(cols < d, r, 0.0), axis=1)


@functools.partial(jax.jit, static_argnames=(
    "iters", "coarse_iters", "interpret"))
def fista_mpc(H, W, bias, x0s, lo, hi, lipschitz, iters: int = 40,
              coarse_iters: int = 0, U0: Optional[jax.Array] = None,
              interpret: bool = False):
    """Batched FISTA box-QP with g = x0s @ W + bias formed in the kernel.

    H (d, d) symmetric PSD; W (n, d) the folded prediction chain
    Sx'(Su'Qbar)'; bias (d,) the shared offset of g; x0s (N, n). Returns
    (U (N, d), max projected-gradient residual)."""
    M_p, W_p, x0_p, u0_p, (N, d, N_pad, n_pad, d_pad) = _pad_inputs(
        H, W, bias, x0s, U0, 0.0)
    in_specs, out_specs = _specs(n_pad, d_pad, 1)
    kernel = functools.partial(_fista_kernel, iters=iters,
                               coarse_iters=min(coarse_iters, iters), d=d)
    U, r = pl.pallas_call(
        kernel,
        grid=(N_pad // TILE_N,),
        in_specs=in_specs,
        out_specs=out_specs,
        out_shape=[jax.ShapeDtypeStruct((N_pad, d_pad), jnp.float32),
                   jax.ShapeDtypeStruct((N_pad,), jnp.float32)],
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=NUM_WARPS,
                                                 num_stages=1),
        interpret=interpret,
        name="fista_mpc",
    )(x0_p, W_p, M_p, _params(1.0 / lipschitz, lo, hi), u0_p)
    return U[:N, :d], jnp.max(r[:N])


def _admm_kernel(x0_ref, w_ref, m_ref, prm_ref, s0_ref, z_ref, rp_ref,
                 rd_ref, *, iters: int, coarse_iters: int, d: int):
    """s-form ADMM: carry s = x_r + y, so z = clip(s), y = s - z and

        p = clip(s); t = 2p - s (= z - y); u = t (rho Minv); s += a (u - c - p)

    with c = Minv g formed once per tile."""
    rho, lo, hi, alpha = prm_ref[0], prm_ref[1], prm_ref[2], prm_ref[3]
    m_hi, m_lo = _tf32_split(m_ref[...])
    m_bf = m_ref[...].astype(jnp.bfloat16)
    w_hi, w_lo = _tf32_split(w_ref[...])
    c = _dot3(x0_ref[...], w_hi, w_lo)

    def body(coarse, _, s):
        p = jnp.clip(s, lo, hi)
        t = 2.0 * p - s
        u = _dot_bf16(t, m_bf) if coarse else _dot3(t, m_hi, m_lo)
        return s + alpha * (u - c - p)

    s = s0_ref[...]
    if coarse_iters > 0:
        s = lax.fori_loop(0, coarse_iters, functools.partial(body, True), s)
    s = lax.fori_loop(0, iters - coarse_iters, functools.partial(body, False),
                      s)
    z = jnp.clip(s, lo, hi)
    z_ref[...] = z
    # residuals at the final (z, y = s - z), as in models/admm.py:
    # x = (rho (z - y) - g) Minv = (2z - s)(rho Minv) - c
    x = _dot3(2.0 * z - s, m_hi, m_lo) - c
    z_next = jnp.clip(s + alpha * (x - z), lo, hi)
    cols = lax.broadcasted_iota(jnp.int32, z.shape, 1) < d
    rp_ref[...] = jnp.max(jnp.where(cols, jnp.abs(x - z), 0.0), axis=1)
    rd_ref[...] = rho * jnp.max(jnp.where(cols, jnp.abs(z_next - z), 0.0),
                                axis=1)


@functools.partial(jax.jit, static_argnames=(
    "iters", "coarse_iters", "interpret"))
def admm_mpc(Minv, W, bias, x0s, lo, hi, rho, over_relax, iters: int = 40,
             coarse_iters: int = 0, U0: Optional[jax.Array] = None,
             interpret: bool = False):
    """Batched over-relaxed ADMM box-QP with c = Minv g formed in the kernel.

    Minv = (H + rho I)^{-1} (d, d); W (n, d), bias (d,) as in fista_mpc.
    U0 warm-starts z (clipped); cold start is z = clip(0). Returns
    (z (N, d), max primal residual, max dual residual)."""
    Wc = jnp.dot(W, Minv, precision=lax.Precision.HIGHEST)
    bc = jnp.dot(bias, Minv, precision=lax.Precision.HIGHEST)
    U0 = None if U0 is None else jnp.clip(U0, lo, hi)
    M_p, W_p, x0_p, s0_p, (N, d, N_pad, n_pad, d_pad) = _pad_inputs(
        rho * Minv, Wc, bc, x0s, U0, jnp.clip(0.0, lo, hi))
    in_specs, out_specs = _specs(n_pad, d_pad, 2)
    kernel = functools.partial(_admm_kernel, iters=iters,
                               coarse_iters=min(coarse_iters, iters), d=d)
    z, rp, rd = pl.pallas_call(
        kernel,
        grid=(N_pad // TILE_N,),
        in_specs=in_specs,
        out_specs=out_specs,
        out_shape=[jax.ShapeDtypeStruct((N_pad, d_pad), jnp.float32),
                   jax.ShapeDtypeStruct((N_pad,), jnp.float32),
                   jax.ShapeDtypeStruct((N_pad,), jnp.float32)],
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=NUM_WARPS,
                                                 num_stages=1),
        interpret=interpret,
        name="admm_mpc",
    )(x0_p, W_p, M_p, _params(rho, lo, hi, over_relax), s0_p)
    return z[:N, :d], jnp.max(rp[:N]), jnp.max(rd[:N])
