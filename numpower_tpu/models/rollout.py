"""Dynamics rollouts + linearization.

The structural upgrade over the reference: where a NumPower user writes a PHP
loop of eager nd::matmul/nd::add calls per horizon step (one kernel dispatch
per op — the failure mode documented in SURVEY.md §3.2), a rollout here is a
single `lax.scan` inside one jitted program, batched over scenarios with
`vmap`. Jacobians come from `jax.jacfwd` (exact, idiomatic) or vmapped
finite differences (BASELINE config #3 exercises the finite-diff path to
mirror what a reference user could compute).
"""

from __future__ import annotations

from typing import Callable, Tuple

import jax
import jax.numpy as jnp
from jax import lax


def rollout_lti(A, B, x0, us):
    """x_{t+1} = A x_t + B u_t for a (T, m) control sequence.

    Returns xs (T+1, n) including x0. One fused scan — zero host round-trips.
    """

    def step(x, u):
        x_next = A @ x + B @ u
        return x_next, x_next

    _, xs = lax.scan(step, x0, us)
    return jnp.concatenate([x0[None], xs], axis=0)


def rollout_ltv(As, Bs, x0, us):
    """Time-varying x_{t+1} = A_t x_t + B_t u_t; As (T,n,n), Bs (T,n,m)."""

    def step(x, inputs):
        A, B, u = inputs
        x_next = A @ x + B @ u
        return x_next, x_next

    _, xs = lax.scan(step, x0, (As, Bs, us))
    return jnp.concatenate([x0[None], xs], axis=0)


def rollout_nonlinear(f: Callable, x0, us):
    """Nonlinear plant rollout; f(x, u) -> x_next must be jax-pure."""

    def step(x, u):
        x_next = f(x, u)
        return x_next, x_next

    _, xs = lax.scan(step, x0, us)
    return jnp.concatenate([x0[None], xs], axis=0)


def batched_rollout_lti(A, B, x0s, uss):
    """vmap over scenarios (BASELINE: 4096+ scenarios per chip).
    x0s (N, n); uss (N, T, m) -> (N, T+1, n)."""
    return jax.vmap(lambda x0, us: rollout_lti(A, B, x0, us))(x0s, uss)


def linearize(f: Callable, x, u) -> Tuple[jax.Array, jax.Array]:
    """Exact Jacobians (A, B) = (df/dx, df/du) at (x, u) via jacfwd."""
    A = jax.jacfwd(f, argnums=0)(x, u)
    B = jax.jacfwd(f, argnums=1)(x, u)
    return A, B


def linearize_finite_diff(f: Callable, x, u, eps: float = 1e-4):
    """Central finite-difference Jacobians via vmapped perturbations
    (BASELINE config #3). 2(n+m) plant evaluations batched into two vmaps —
    the batched equivalent of the reference user's per-column PHP loop."""
    n, m = x.shape[0], u.shape[0]
    ex = jnp.eye(n, dtype=x.dtype) * eps
    eu = jnp.eye(m, dtype=u.dtype) * eps

    fx = jax.vmap(lambda d: f(x + d, u))(ex)      # (n, n) rows: f(x+eps e_i)
    fx_m = jax.vmap(lambda d: f(x - d, u))(ex)
    A = (fx - fx_m).T / (2 * eps)

    fu = jax.vmap(lambda d: f(x, u + d))(eu)
    fu_m = jax.vmap(lambda d: f(x, u - d))(eu)
    B = (fu - fu_m).T / (2 * eps)
    return A, B


def linearize_trajectory(f: Callable, xs, us, use_fd: bool = False, eps: float = 1e-4):
    """Linearize along a trajectory: xs (T+1, n) or (T, n), us (T, m) ->
    As (T, n, n), Bs (T, n, m). One vmap over time — all T Jacobians in a
    single fused program."""
    xs_t = xs[: us.shape[0]]
    if use_fd:
        return jax.vmap(lambda x, u: linearize_finite_diff(f, x, u, eps))(xs_t, us)
    return jax.vmap(lambda x, u: linearize(f, x, u))(xs_t, us)


def quadratic_cost(Q, R, QF, x_ref=None):
    """Builds a stage-cost function for trajectory cost evaluation.
    cost = sum_t [(x_t-xref)'Q(x_t-xref) + u_t'R u_t] + terminal QF term."""

    def total(xs, us):
        xr = x_ref if x_ref is not None else jnp.zeros_like(xs[0])
        dx = xs[:-1] - xr
        dxf = xs[-1] - xr
        stage = jnp.einsum("ti,ij,tj->", dx, Q, dx) + jnp.einsum(
            "ti,ij,tj->", us, R, us
        )
        return stage + dxf @ QF @ dxf

    return total
