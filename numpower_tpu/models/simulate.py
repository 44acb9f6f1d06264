"""Closed-loop simulation: plant + estimator + controller as ONE jitted scan.

The glue a deployment needs around the solver/estimator families:

    per tick t:   u_t     = controller(ctrl_state, x_hat_t, t)
                  x_{t+1} = f(x_t, u_t) + w_t              [process noise]
                  y_{t+1} = h(x_{t+1}) + v_t               [measurement]
                  x_hat   = estimator(est_state, y_{t+1}, u_t)

Structure: the WHOLE closed loop — N parallel rollouts, every
controller solve, every filter update — is one lax.scan inside one jit.
The reference user would run this as a PHP while-loop of eager nd:: calls
with a host round-trip per op (SURVEY.md §3.2); here a 4096-trajectory,
200-tick output-feedback MPC simulation is a single device program.

Everything is batched over the leading N axis; keyed jax.random drives the
noise (reproducible; reference RNG is unseedable rand(), initializers.c:517).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from numpower_tpu.models.estimation import _filter_step


class SimResult(NamedTuple):
    xs: jax.Array             # (steps+1, N, n) true states
    us: jax.Array             # (steps, N, m) applied controls
    ys: Optional[jax.Array]   # (steps, N, p) measurements (None if h is None)
    xhats: Optional[jax.Array]  # (steps, N, n) estimates (None if estimator is None)


def simulate_closed_loop(
    f: Callable,              # f(x, u) -> x_next, single trajectory (vmapped here)
    controller: Callable,     # (ctrl_state, x (N,n), t) -> (u (N,m), ctrl_state)
    ctrl_state0,
    x0s: jax.Array,           # (N, n) true initial states
    steps: int,
    key: Optional[jax.Array] = None,
    w_std=0.0,                # process noise std (scalar or (n,))
    h: Optional[Callable] = None,   # h(x) -> y, single trajectory
    v_std=0.0,                # measurement noise std (scalar or (p,))
    estimator: Optional[Callable] = None,
    # (est_state, y (N,p), u_prev (N,m)) -> (xhat (N,n), est_state)
    est_state0=None,
    xhat0: Optional[jax.Array] = None,  # initial estimates (default: x0s)
) -> SimResult:
    """Run N closed loops for `steps` ticks as one jitted scan.

    With estimator=None the controller sees the true state (full-state
    feedback); with an estimator it sees x_hat (output feedback). Wrap in
    jax.jit for repeated runs — everything inside is jit-compatible.
    Controller/estimator callbacks must carry their device arrays in
    ctrl_state0/est_state0, not closures (see lqr_feedback/kalman_estimator)."""
    if estimator is not None and h is None:
        raise ValueError("estimator requires a measurement model h "
                         "(the estimator consumes y = h(x) + noise)")
    N, n = x0s.shape
    dt = x0s.dtype
    f_b = jax.vmap(f)
    h_b = jax.vmap(h) if h is not None else None
    if key is None:
        key = jax.random.key(0)
    w_std_arr = jnp.broadcast_to(jnp.asarray(w_std, dt), (n,))
    xhat = x0s if xhat0 is None else xhat0

    def tick(carry, t):
        x, xh, cs, es, k = carry
        u, cs = controller(cs, xh if estimator is not None else x, t)
        k, kw, kv = jax.random.split(k, 3)
        x_next = f_b(x, u) + w_std_arr * jax.random.normal(kw, (N, n), dt)
        if h_b is not None:
            y = h_b(x_next)
            y = y + jnp.asarray(v_std, dt) * jax.random.normal(kv, y.shape, dt)
        else:
            y = None
        if estimator is not None:
            xh, es = estimator(es, y, u)
        out = (x_next, u, y if y is not None else 0.0,
               xh if estimator is not None else 0.0)
        return (x_next, xh, cs, es, k), out

    carry0 = (x0s, xhat, ctrl_state0, est_state0, key)
    _, (xs_tail, us, ys, xhats) = lax.scan(
        tick, carry0, jnp.arange(steps))
    xs = jnp.concatenate([x0s[None], xs_tail], axis=0)
    return SimResult(
        xs=xs, us=us,
        ys=ys if h is not None else None,
        xhats=xhats if estimator is not None else None,
    )


def lqr_feedback(u_lo=None, u_hi=None) -> Callable:
    """Static-gain controller callback: u = clip(-K x).

    The gain K rides the ctrl_state carry (pass ctrl_state0=K) rather than
    being closure-captured — captured device arrays become HLO constants and
    lowering fetches them D2H (CLAUDE.md / CondensedQP docstring). u_lo/u_hi
    are Python scalars, safe to close over."""
    def fn(state, x, t):
        u = -(x @ state.T)
        if u_lo is not None or u_hi is not None:
            u = jnp.clip(u, u_lo, u_hi)
        return u, state

    return fn


def kalman_estimator(A, C, Q, R, P0, B=None):
    """Batched Kalman estimator callback for simulate_closed_loop.

    Returns (make_state, update): make_state(xhat0 (N,n)) builds the carry —
    the filter matrices ride INSIDE it (scan-carried jit arguments, never
    closure-captured device constants) together with the (means, covs)
    state; update consumes one measurement batch per tick (reuses
    estimation._filter_step, vmapped over trajectories)."""
    n = A.shape[0]
    params = (A, C, Q, R, B)  # B may be None (valid empty pytree leaf)

    def make_state(xhat0: jax.Array):
        N = xhat0.shape[0]
        return (params, (xhat0, jnp.broadcast_to(P0, (N, n, n))))

    def update(state, y, u_prev):
        (A_, C_, Q_, R_, B_), (xh, P) = state
        u_term = u_prev @ B_.T if B_ is not None else jnp.zeros_like(xh)
        x_f, P_f, _, _, _ = jax.vmap(
            lambda x, p, yy, ut: _filter_step(A_, C_, Q_, R_, x, p, yy, ut)
        )(xh, P, y, u_term)
        return x_f, ((A_, C_, Q_, R_, B_), (x_f, P_f))

    return make_state, update
