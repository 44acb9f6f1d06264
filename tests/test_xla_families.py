"""The families whose hand-written kernels were removed, on their XLA paths,
against the plain fp64 NumPy references of chip_smoke.py, at two batch
sizes each (chip_smoke.py runs the same checks at the bench sizes)."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import (  # noqa: E402
    DT_PEND, G_PEND, ekf_ref, flagship_costs, kalman_ref, rel_dev,
    riccati_ref, rts_ref, ukf_ref,
)
from numpower_tpu.models import (  # noqa: E402
    double_integrator, ilqr_solve_batched, kalman_filter_batched, mppi_solve,
    mppi_solve_batched, pendulum_step, quadratic_mppi_cost, quadrotor12,
    riccati_scan_per_scenario,
)
from numpower_tpu.models.estimation import (  # noqa: E402
    ekf_filter_batched, kalman_smoother_batched, ukf_filter_batched,
)

F32 = np.float32


@pytest.mark.parametrize("N", [3, 17])
def test_riccati_per_scenario_matches_fp64(N):
    rng = np.random.default_rng(N)
    A, B = quadrotor12(0.02)
    Q, R, QF = flagship_costs()
    As = (np.tile(A, (N, 1, 1)) + 0.01 * rng.standard_normal((N, 12, 12))
          ).astype(F32)
    Bs = np.broadcast_to(B, (N, 12, 4)).astype(F32)
    Ks, _ = riccati_scan_per_scenario(As, Bs, Q.astype(F32), R.astype(F32),
                                      QF.astype(F32), 20)
    for i in (0, N - 1):
        K_ref = riccati_ref(As[i].astype(float), B.astype(float), Q, R, QF, 20)
        assert rel_dev(Ks[i], K_ref) < 1e-4


@pytest.mark.parametrize("N", [2, 9])
def test_batched_ilqr_reaches_the_lqr_optimum(N):
    """iLQR on a linear plant is exact: its cost must reach the fp64 LQR
    optimum."""
    Ad, Bd = (np.asarray(M, float) for M in double_integrator(0.1))
    Q, R, QF = np.eye(2), 0.1 * np.eye(1), 10.0 * np.eye(2)
    x0s = np.random.default_rng(N).standard_normal((N, 2)).astype(F32)
    A32, B32 = jnp.asarray(Ad, jnp.float32), jnp.asarray(Bd, jnp.float32)
    res = ilqr_solve_batched(lambda s, u: A32 @ s + B32 @ u, jnp.asarray(x0s),
                             *(jnp.asarray(M, jnp.float32) for M in (Q, R, QF)),
                             jnp.zeros(2), horizon=30, iters=8)
    Ks = riccati_ref(Ad, Bd, Q, R, QF, 30)

    def cost(x, us):
        J = 0.0
        for u in us:
            J += x @ Q @ x + u @ R @ u
            x = Ad @ x + Bd @ u
        return J + x @ QF @ x

    for i in range(N):
        x, us = x0s[i].astype(float), []
        for K in Ks:
            us.append(-K @ x)
            x = Ad @ x + Bd @ us[-1]
        J_star = cost(x0s[i].astype(float), us)
        J = cost(x0s[i].astype(float), np.asarray(res.us[i], float))
        assert (J - J_star) / J_star < 1e-5


def _kf_problem(N, T=25, seed=0):
    rng = np.random.default_rng(seed + N)
    Ad, _ = double_integrator(0.1)
    Ad = np.asarray(Ad, float)
    C = np.array([[1.0, 0.0]])
    Q, R, P0 = 1e-3 * np.eye(2), 1e-2 * np.eye(1), 0.1 * np.eye(2)
    yss = rng.standard_normal((N, T, 1)).astype(F32)
    x0s = rng.standard_normal((N, 2)).astype(F32)
    return Ad, C, Q, R, P0, x0s, yss


@pytest.mark.parametrize("N", [3, 33])
def test_batched_kalman_filter_matches_fp64(N):
    Ad, C, Q, R, P0, x0s, yss = _kf_problem(N)
    filt = kalman_filter_batched(*(jnp.asarray(M, jnp.float32)
                                   for M in (Ad, C, Q, R)), x0s,
                                 jnp.asarray(P0, jnp.float32), yss)
    for i in (0, N - 1):
        xf, Pf, _, _ = kalman_ref(Ad, C, Q, R, x0s[i].astype(float), P0,
                                  yss[i].astype(float))
        assert rel_dev(filt.means[i], xf) < 1e-5
        assert rel_dev(filt.covs[i], Pf) < 1e-5


@pytest.mark.parametrize("N", [3, 33])
def test_batched_rts_smoother_matches_fp64(N):
    Ad, C, Q, R, P0, x0s, yss = _kf_problem(N, seed=7)
    A32 = jnp.asarray(Ad, jnp.float32)
    filt = kalman_filter_batched(A32, *(jnp.asarray(M, jnp.float32)
                                        for M in (C, Q, R)), x0s,
                                 jnp.asarray(P0, jnp.float32), yss)
    sm = kalman_smoother_batched(A32, filt)
    for i in (0, N - 1):
        ref = kalman_ref(Ad, C, Q, R, x0s[i].astype(float), P0,
                         yss[i].astype(float))
        assert rel_dev(sm.means[i], rts_ref(Ad, *ref)) < 1e-5


def _f_pend(x, u):
    return jnp.stack([x[0] + DT_PEND * x[1],
                      x[1] - DT_PEND * G_PEND * jnp.sin(x[0])
                      + DT_PEND * u[0]])


@pytest.mark.parametrize("kind", ["ekf", "ukf"])
@pytest.mark.parametrize("N", [2, 7])
def test_batched_nonlinear_filters_match_fp64(kind, N):
    rng = np.random.default_rng(N)
    T = 30
    ys = rng.standard_normal((N, T, 1)).astype(F32)
    us = (0.1 * rng.standard_normal((N, T, 1))).astype(F32)
    x0s = (0.3 * rng.standard_normal((N, 2))).astype(F32)
    batched, ref = {"ekf": (ekf_filter_batched, ekf_ref),
                    "ukf": (ukf_filter_batched, ukf_ref)}[kind]
    out = batched(_f_pend, lambda s: s[:1], jnp.eye(2) * 1e-3,
                  jnp.eye(1) * 1e-2, x0s, jnp.eye(2) * 0.1, ys, us)
    for i in (0, N - 1):
        x_ref = ref(1e-3 * np.eye(2), 1e-2 * np.eye(1), x0s[i].astype(float),
                    0.1 * np.eye(2), ys[i].astype(float), us[i].astype(float))
        assert rel_dev(out.means[i], x_ref) < 1e-4


@pytest.mark.parametrize("N", [2, 5])
def test_batched_mppi_matches_unbatched_on_the_same_keys(N):
    cost = quadratic_mppi_cost(jnp.diag(jnp.array([1.0, 0.1])),
                               jnp.eye(1) * 0.01,
                               jnp.diag(jnp.array([100.0, 10.0])),
                               jnp.zeros(2))
    x0s = jnp.asarray(np.random.default_rng(N).uniform(-np.pi, np.pi,
                                                       (N, 2)), jnp.float32)
    key = jax.random.key(N)
    kw = dict(samples=64, iters=3, m=1)
    res = mppi_solve_batched(pendulum_step, x0s, cost, 20, key, **kw)
    keys = jax.random.split(key, N)
    for i in (0, N - 1):
        one = mppi_solve(pendulum_step, x0s[i], cost, 20, keys[i], **kw)
        assert abs(float(res.cost[i]) / float(one.cost) - 1.0) < 1e-4
