"""MPPI (Model Predictive Path Integral) sampling-based control.

A solver family the reference cannot express at all: its eager one-op-per-
dispatch model (SURVEY.md §3.2, numpower.c:193-282) makes K-thousand sampled
rollouts per control update intractable, while here the whole update is one
jitted program — sample, rollout, weight, update — dominated by a (K, T, m)
batched scan that XLA fuses.

Algorithm (Williams et al., information-theoretic MPC):
  1. draw K control perturbation sequences eps ~ N(0, sigma^2)
  2. roll out u_nom + eps through the plant (vmap over K samples)
  3. S_k = trajectory cost + temperature-weighted control coupling
  4. w_k = softmax(-S_k / lambda);  u_nom += sum_k w_k eps_k
  5. repeat `iters` times (static count — fixed-shape compiled program)

Design choices:
  - keyed jax.random (counter-based, reproducible, splittable per iteration)
    instead of the reference's unseedable libc rand() (initializers.c:517)
  - all K rollouts batched in ONE vmapped lax.scan — K is a tile dimension,
    not a loop
  - softmax via the standard max-shift (logsumexp-stable) — fp32 throughout
  - no data-dependent control flow: fixed iters, fixed K, fixed horizon
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from numpower_tpu.models.rollout import rollout_nonlinear


class MPPIResult(NamedTuple):
    us: jax.Array      # (T, m) updated nominal control sequence
    xs: jax.Array      # (T+1, n) rollout of the nominal sequence
    cost: jax.Array    # scalar cost of the nominal sequence
    ess: jax.Array     # effective sample size of the last weight set (1..K)


def _trajectory_cost(cost_fn, xs, us):
    """cost_fn(x, u, t) summed over the horizon + cost_fn(x_T, None, T)."""
    T = us.shape[0]
    ts = jnp.arange(T)
    stage = jnp.sum(jax.vmap(lambda x, u, t: cost_fn(x, u, t))(xs[:-1], us, ts))
    return stage + cost_fn(xs[-1], None, T)


def quadratic_mppi_cost(Q, R, QF, x_goal):
    """Standard quadratic tracking cost in MPPI's (x, u, t) callback form.

    Terminal stages (u is None) use QF. Matches the iLQR/_total_cost
    objective so the two solver families are directly comparable in tests."""

    def cost_fn(x, u, t):
        dx = x - x_goal
        if u is None:
            return dx @ QF @ dx
        return dx @ Q @ dx + u @ R @ u

    return cost_fn


def mppi_solve(
    f: Callable,
    x0: jax.Array,
    cost_fn: Callable,
    horizon: int,
    key: jax.Array,
    samples: int = 1024,
    iters: int = 8,
    lam: float = 1.0,
    sigma: float = 1.0,
    u_lo: Optional[float] = None,
    u_hi: Optional[float] = None,
    m: Optional[int] = None,
    us_init: Optional[jax.Array] = None,
    baseline_mix: float = 0.0,
) -> MPPIResult:
    """Full MPPI solve: `iters` importance-sampled updates of u_nom.

    f(x, u) -> x_next        pure jax plant (jit/vmap/scan-compatible)
    cost_fn(x, u, t) -> cost scalar stage cost; u is None at the terminal
                        stage (see quadratic_mppi_cost)
    key                      jax.random key (explicit — reproducible runs)
    lam                      softmax temperature (lower = greedier)
    sigma                    exploration std-dev (scalar or (m,) per input)
    u_lo/u_hi                optional box: samples AND the updated nominal
                             are clipped (projection-consistent with the
                             box-QP solvers in models/boxqp.py)
    baseline_mix             fraction of samples forced to pure noise around
                             zero (helps escape bad nominals early)

    jit-compatible end to end; vmap over (x0, key) for batched scenarios.
    """
    if m is None:
        if us_init is None:
            raise ValueError("pass m= (input dim) or us_init")
        m = us_init.shape[-1]
    T = horizon
    us = (
        us_init
        if us_init is not None
        else jnp.zeros((T, m), dtype=x0.dtype)
    )
    sigma_arr = jnp.broadcast_to(jnp.asarray(sigma, x0.dtype), (m,))
    inv_sig2 = 1.0 / (sigma_arr * sigma_arr)
    K = samples
    n_base = int(round(K * baseline_mix))

    def clipc(u):
        if u_lo is None and u_hi is None:
            return u
        return jnp.clip(u, u_lo, u_hi)

    def iteration(carry, it_key):
        us_nom = carry
        eps = jax.random.normal(it_key, (K, T, m), dtype=x0.dtype) * sigma_arr
        cand = us_nom[None] + eps
        if n_base > 0:
            # first n_base samples explore around zero instead of the nominal
            cand = cand.at[:n_base].set(eps[:n_base])
        cand = clipc(cand)
        eps_eff = cand - us_nom[None]  # clipping-consistent perturbations

        def one_rollout(u_seq):
            xs = rollout_nonlinear(f, x0, u_seq)
            return _trajectory_cost(cost_fn, xs, u_seq)

        costs = jax.vmap(one_rollout)(cand)  # (K,)
        # information-theoretic control coupling term: lam * u' Sigma^-1 eps
        couple = lam * jnp.einsum("ktm,tm->k", eps_eff, inv_sig2 * us_nom)
        S = costs + couple
        w = jax.nn.softmax(-S / lam)  # shift-invariant (internal max-shift)
        ess = 1.0 / jnp.sum(w * w)
        us_new = clipc(us_nom + jnp.einsum("k,ktm->tm", w, eps_eff))
        return us_new, ess

    keys = jax.random.split(key, iters)
    us_f, esses = lax.scan(iteration, us, keys)
    xs_f = rollout_nonlinear(f, x0, us_f)
    cost_f = _trajectory_cost(cost_fn, xs_f, us_f)
    return MPPIResult(us=us_f, xs=xs_f, cost=cost_f, ess=esses[-1])


def mppi_solve_batched(f, x0s, cost_fn, horizon, key, **kwargs
                       ) -> MPPIResult:
    """vmap over scenarios: x0s (N, n) with independent sample streams.

    N x K rollouts run as one fused program (N and K are both batch tile
    dims) — the BASELINE scaling axis (scenarios per device), applied to a
    sampling solver.
    """
    N = x0s.shape[0]
    keys = jax.random.split(key, N)
    return jax.vmap(
        lambda x0, k: mppi_solve(f, x0, cost_fn, horizon, k, **kwargs)
    )(x0s, keys)


def mppi_step(
    f,
    state,
    x_now,
    cost_fn,
    key,
    **kwargs,
) -> tuple[jax.Array, MPPIResult]:
    """Receding-horizon tick: re-solve from x_now warm-started with the
    previous plan shifted by one step (the standard MPC warm start — same
    pattern as models/mpc.py MPCController). Returns (u_apply, result)."""
    us_prev = state
    us_shift = jnp.concatenate([us_prev[1:], us_prev[-1:]], axis=0)
    res = mppi_solve(
        f, x_now, cost_fn, us_prev.shape[0], key, us_init=us_shift, **kwargs
    )
    return res.us[0], res
