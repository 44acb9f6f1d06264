"""iLQR (iterative LQR) for nonlinear plants.

BASELINE config #3: cartpole iLQR with finite-difference Jacobians
(exercises elementwise ops, reductions, indexing — the reference user's
toolkit). Structure:

 - linearization: one vmap over the horizon (exact jacfwd or central FD)
 - backward pass: lax.scan with Levenberg-style regularization on Q_uu
 - forward pass: ALL line-search step sizes rolled out in parallel via vmap
   (8 alphas = one batched scan), best-cost candidate selected with argmin —
   no host round-trips, no data-dependent branching
 - outer loop: fixed iteration count (static shape; 10 ms-budget style)

Everything compiles to a single XLA program; the reference equivalent is
thousands of eager PHP-dispatched kernels (SURVEY.md §3.2).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from numpower_tpu.models.lqr import _psd_solve
from numpower_tpu.models.rollout import linearize_trajectory, rollout_nonlinear


class ILQRResult(NamedTuple):
    us: jax.Array     # (T, m) optimal controls
    xs: jax.Array     # (T+1, n) trajectory
    cost: jax.Array   # scalar final cost
    costs: jax.Array  # (iters,) cost per outer iteration


def _total_cost(xs, us, Q, R, QF, x_goal):
    dx = xs[:-1] - x_goal
    dxf = xs[-1] - x_goal
    return (
        jnp.einsum("ti,ij,tj->", dx, Q, dx)
        + jnp.einsum("ti,ij,tj->", us, R, us)
        + dxf @ QF @ dxf
    )


def _backward_pass(As, Bs, xs, us, Q, R, QF, x_goal, reg,
                   lu_pen=None, luu_pen=None, unroll: int = 1):
    """LQ backward pass on the linearized system with quadratic tracking
    cost. Returns feedforward ks (T, m) and feedback Ks (T, m, n).

    lu_pen/luu_pen ((T, m) each, optional) add per-timestep gradient and
    DIAGONAL Hessian terms on u — the augmented-Lagrangian active-set
    penalty (models/al_ilqr._al_terms). One recursion serves both plain
    iLQR and AL-iLQR."""
    T, m = us.shape
    VX_T = 2.0 * (QF @ (xs[-1] - x_goal))
    VXX_T = 2.0 * QF
    if lu_pen is None:
        lu_pen = jnp.zeros((T, m), us.dtype)
    if luu_pen is None:
        luu_pen = jnp.zeros((T, m), us.dtype)
    eye_m = jnp.eye(m, dtype=us.dtype)

    def step(carry, inputs):
        Vx, Vxx = carry
        A, B, x, u, lu_p, luu_p = inputs
        lx = 2.0 * (Q @ (x - x_goal))
        lu = 2.0 * (R @ u) + lu_p
        lxx = 2.0 * Q
        luu = 2.0 * R + jnp.diag(luu_p)
        Qx = lx + A.T @ Vx
        Qu = lu + B.T @ Vx
        Qxx = lxx + A.T @ Vxx @ A
        Quu = luu + B.T @ Vxx @ B + reg * eye_m
        Qux = B.T @ Vxx @ A
        # one unrolled SPD solve for [k | K] (utils/smallmat.py): avoids
        # XLA's cholesky/triangular-solve custom calls inside the scan,
        # which are latency-bound at m ~ 1..4 and block scan unrolling
        sol = _psd_solve(0.5 * (Quu + Quu.T),
                         jnp.concatenate([Qu[:, None], Qux], axis=1))
        k = -sol[:, 0]
        K = -sol[:, 1:]
        Vx_new = Qx + K.T @ Quu @ k + K.T @ Qu + Qux.T @ k
        Vxx_new = Qxx + K.T @ Quu @ K + K.T @ Qux + Qux.T @ K
        Vxx_new = 0.5 * (Vxx_new + Vxx_new.T)
        return (Vx_new, Vxx_new), (k, K)

    xs_t = xs[:-1]
    # unroll is caller-controlled: it is meant for single-scenario solves
    # where per-step ops are tiny and the rolled scan is loop-overhead-
    # bound; under vmap the per-step ops carry the batch, so batched
    # callers keep the default 1
    _, (ks_rev, Ks_rev) = lax.scan(
        step, (VX_T, VXX_T),
        (As[::-1], Bs[::-1], xs_t[::-1], us[::-1],
         lu_pen[::-1], luu_pen[::-1]),
        unroll=unroll,
    )
    return jnp.flip(ks_rev, 0), jnp.flip(Ks_rev, 0)


def _forward_pass(f, x0, xs_nom, us_nom, ks, Ks, alpha, unroll: int = 1):
    """Closed-loop rollout u = u_nom + alpha*k + K(x - x_nom).

    unroll: see _backward_pass — single-scenario callers unroll, batched
    callers must keep 1."""

    def step(x, inputs):
        x_nom, u_nom, k, K = inputs
        u = u_nom + alpha * k + K @ (x - x_nom)
        x_next = f(x, u)
        return x_next, (u, x_next)

    _, (us, xs) = lax.scan(step, x0, (xs_nom[:-1], us_nom, ks, Ks),
                           unroll=unroll)
    return us, jnp.concatenate([x0[None], xs], axis=0)


def ilqr_solve(
    f: Callable,
    x0: jax.Array,
    Q: jax.Array,
    R: jax.Array,
    QF: jax.Array,
    x_goal: jax.Array,
    horizon: int,
    iters: int = 20,
    reg: float = 1e-3,
    use_fd: bool = False,
    fd_eps: float = 1e-4,
    us_init: Optional[jax.Array] = None,
    alphas: Tuple[float, ...] = (1.0, 0.6, 0.3, 0.1, 0.03, 0.01),
    unroll_scans: bool = False,
) -> ILQRResult:
    """Full iLQR solve, jit-compatible. vmap over x0 for batched scenarios.

    unroll_scans=True is the SINGLE-SCENARIO latency opt-in (h <= 64,
    BASELINE config #3); do not set it under vmap. Default False so the
    advertised vmap-over-x0 pattern is always safe."""
    m = R.shape[0]
    unroll = horizon if (unroll_scans and horizon <= 64) else 1
    us = (
        us_init
        if us_init is not None
        else jnp.zeros((horizon, m), dtype=x0.dtype)
    )
    xs = rollout_nonlinear(f, x0, us)
    cost0 = _total_cost(xs, us, Q, R, QF, x_goal)
    alphas_arr = jnp.asarray(alphas, dtype=x0.dtype)

    def outer(carry, _):
        xs, us, cost = carry
        As, Bs = linearize_trajectory(f, xs, us, use_fd=use_fd, eps=fd_eps)
        ks, Ks = _backward_pass(As, Bs, xs, us, Q, R, QF, x_goal, reg,
                                unroll=unroll)

        def try_alpha(alpha):
            us_a, xs_a = _forward_pass(f, x0, xs, us, ks, Ks, alpha,
                                       unroll=unroll)
            return _total_cost(xs_a, us_a, Q, R, QF, x_goal), us_a, xs_a

        costs_a, us_all, xs_all = jax.vmap(try_alpha)(alphas_arr)
        best = jnp.argmin(costs_a)
        improved = costs_a[best] < cost
        new_xs = jnp.where(improved, xs_all[best], xs)
        new_us = jnp.where(improved, us_all[best], us)
        new_cost = jnp.where(improved, costs_a[best], cost)
        return (new_xs, new_us, new_cost), new_cost

    (xs_f, us_f, cost_f), costs = lax.scan(outer, (xs, us, cost0), None, length=iters)
    return ILQRResult(us=us_f, xs=xs_f, cost=cost_f, costs=costs)


def ilqr_solve_batched(f, x0s, Q, R, QF, x_goal, horizon, **kwargs):
    """Batched iLQR over scenarios: ilqr_solve vmapped over x0s (N, n).
    Keyword arguments go to ilqr_solve (unroll_scans stays False: under
    vmap each step carries the batch and unrolling does not pay)."""
    kwargs.setdefault("unroll_scans", False)
    return jax.vmap(
        lambda x0: ilqr_solve(f, x0, Q, R, QF, x_goal, horizon, **kwargs)
    )(x0s)
