"""AL-iLQR: box-constrained iLQR via the augmented Lagrangian method.

Third solver family for constrained trajectory optimization alongside the
condensed box-QP (models/boxqp.py — LTI plants) and unconstrained iLQR
(models/ilqr.py — nonlinear plants). AL-iLQR handles BOTH: nonlinear
dynamics AND hard control box constraints, via the ALTRO-style scheme:

  outer loop (al_iters, static):
      inner: iLQR on the augmented cost
          J_aug = J + sum_t [ lam' c(u_t) + 1/2 c(u_t)' I_mu c(u_t) ]
      with c(u) = [u - hi; lo - u] <= 0 and I_mu the active-set penalty
      (mu where c_i > 0 or lam_i > 0, else 0)
      dual update: lam <- max(0, lam + mu c);  mu <- beta * mu

Structure (same discipline as models/ilqr.py):
  - the ENTIRE solve — outer AL loop, inner iLQR loops, line searches — is
    one jitted program: lax.scan over AL iterations, scan over iLQR
    iterations, vmapped parallel line search; static trip counts throughout
  - penalty derivatives (lu, luu contributions) are closed-form diagonal
    updates — no autodiff retrace per outer iteration, no host round-trips
  - multipliers/penalty ride the scan carry, so warm duals across AL
    iterations are free

Reference parity: the reference has no constrained solver (users hand-clip,
losing optimality); this matches its op-surface spirit — clip/maximum/
minimum (double_math.c float_clip, logic.c) — lifted to a convergent method.
vmap over x0 for batched scenarios.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from numpower_tpu.models.ilqr import (
    _backward_pass as _ilqr_backward_pass, _forward_pass, _total_cost,
)
from numpower_tpu.models.rollout import linearize_trajectory, rollout_nonlinear


class ALILQRResult(NamedTuple):
    us: jax.Array           # (T, m) controls (feasible up to max_violation)
    xs: jax.Array           # (T+1, n) trajectory
    cost: jax.Array         # true (unaugmented) cost of (xs, us)
    max_violation: jax.Array  # max box violation at the solution
    costs: jax.Array        # (al_iters,) true cost after each outer iter


def _al_terms(us, lam_hi, lam_lo, mu, u_lo, u_hi):
    """Penalty cost + its diagonal u-derivatives for the whole horizon.

    c_hi = u - hi, c_lo = lo - u (elementwise, (T, m)). Returns
    (cost_aug_total, lu_pen (T,m), luu_pen_diag (T,m))."""
    c_hi = us - u_hi
    c_lo = u_lo - us
    act_hi = ((c_hi > 0) | (lam_hi > 0)).astype(us.dtype) * mu
    act_lo = ((c_lo > 0) | (lam_lo > 0)).astype(us.dtype) * mu
    cost = jnp.sum(lam_hi * c_hi + 0.5 * act_hi * c_hi * c_hi)
    cost += jnp.sum(lam_lo * c_lo + 0.5 * act_lo * c_lo * c_lo)
    # d/du [lam c + 1/2 I c^2]: +1 sign for c_hi, -1 for c_lo
    lu_pen = (lam_hi + act_hi * c_hi) - (lam_lo + act_lo * c_lo)
    luu_pen = act_hi + act_lo
    return cost, lu_pen, luu_pen


def _backward_pass_al(As, Bs, xs, us, Q, R, QF, x_goal, reg,
                      lu_pen, luu_pen):
    """iLQR backward pass with additive penalty derivatives on u — the
    shared recursion in models/ilqr._backward_pass with its optional
    lu_pen/luu_pen terms (one implementation serves both solvers)."""
    return _ilqr_backward_pass(As, Bs, xs, us, Q, R, QF, x_goal, reg,
                               lu_pen=lu_pen, luu_pen=luu_pen)


def al_ilqr_solve(
    f: Callable,
    x0: jax.Array,
    Q: jax.Array,
    R: jax.Array,
    QF: jax.Array,
    x_goal: jax.Array,
    horizon: int,
    u_lo: float,
    u_hi: float,
    al_iters: int = 6,
    ilqr_iters: int = 8,
    mu0: float = 1.0,
    mu_scale: float = 8.0,
    reg: float = 1e-3,
    use_fd: bool = False,
    fd_eps: float = 1e-4,
    us_init: Optional[jax.Array] = None,
    alphas: Tuple[float, ...] = (1.0, 0.6, 0.3, 0.1, 0.03, 0.01),
) -> ALILQRResult:
    """Box-constrained iLQR solve; jit-compatible, vmap over x0 for batches.

    Returns controls satisfying u_lo <= u <= u_hi to within max_violation
    (drives to ~mu-tolerance; the final iterate is additionally projected so
    the returned plan is strictly feasible — projection error is bounded by
    max_violation and reported, never hidden)."""
    m = R.shape[0]
    T = horizon
    dt = x0.dtype
    us = us_init if us_init is not None else jnp.zeros((T, m), dtype=dt)
    us = jnp.clip(us, u_lo, u_hi)
    alphas_arr = jnp.asarray(alphas, dtype=dt)

    def aug_cost(xs, us, lam_hi, lam_lo, mu):
        pen, _, _ = _al_terms(us, lam_hi, lam_lo, mu, u_lo, u_hi)
        return _total_cost(xs, us, Q, R, QF, x_goal) + pen

    def inner_ilqr(xs, us, lam_hi, lam_lo, mu):
        cost0 = aug_cost(xs, us, lam_hi, lam_lo, mu)

        def it(carry, _):
            xs, us, cost = carry
            As, Bs = linearize_trajectory(f, xs, us, use_fd=use_fd, eps=fd_eps)
            _, lu_pen, luu_pen = _al_terms(us, lam_hi, lam_lo, mu, u_lo, u_hi)
            ks, Ks = _backward_pass_al(
                As, Bs, xs, us, Q, R, QF, x_goal, reg, lu_pen, luu_pen
            )

            def try_alpha(alpha):
                us_a, xs_a = _forward_pass(f, x0, xs, us, ks, Ks, alpha)
                return aug_cost(xs_a, us_a, lam_hi, lam_lo, mu), us_a, xs_a

            costs_a, us_all, xs_all = jax.vmap(try_alpha)(alphas_arr)
            best = jnp.argmin(costs_a)
            improved = costs_a[best] < cost
            new_xs = jnp.where(improved, xs_all[best], xs)
            new_us = jnp.where(improved, us_all[best], us)
            new_cost = jnp.where(improved, costs_a[best], cost)
            return (new_xs, new_us, new_cost), None

        (xs_f, us_f, _), _ = lax.scan(it, (xs, us, cost0), None,
                                      length=ilqr_iters)
        return xs_f, us_f

    def outer(carry, _):
        xs, us, lam_hi, lam_lo, mu = carry
        xs, us = inner_ilqr(xs, us, lam_hi, lam_lo, mu)
        c_hi = us - u_hi
        c_lo = u_lo - us
        lam_hi = jnp.maximum(0.0, lam_hi + mu * c_hi)
        lam_lo = jnp.maximum(0.0, lam_lo + mu * c_lo)
        mu = mu * mu_scale
        true_cost = _total_cost(xs, us, Q, R, QF, x_goal)
        return (xs, us, lam_hi, lam_lo, mu), true_cost

    xs0 = rollout_nonlinear(f, x0, us)
    lam0 = jnp.zeros((T, m), dtype=dt)
    carry0 = (xs0, us, lam0, lam0, jnp.asarray(mu0, dt))
    (xs_f, us_f, _, _, _), costs = lax.scan(outer, carry0, None,
                                            length=al_iters)
    viol = jnp.maximum(jnp.max(us_f - u_hi), jnp.max(u_lo - us_f))
    viol = jnp.maximum(viol, 0.0)
    us_proj = jnp.clip(us_f, u_lo, u_hi)
    xs_proj = rollout_nonlinear(f, x0, us_proj)
    cost_f = _total_cost(xs_proj, us_proj, Q, R, QF, x_goal)
    return ALILQRResult(us=us_proj, xs=xs_proj, cost=cost_f,
                        max_violation=viol, costs=costs)


def al_ilqr_solve_batched(f, x0s, *args, **kwargs) -> ALILQRResult:
    """Batched AL-iLQR over scenario initial states x0s (N, n):
    al_ilqr_solve vmapped over the batch."""
    return jax.vmap(lambda x0: al_ilqr_solve(f, x0, *args, **kwargs))(x0s)
