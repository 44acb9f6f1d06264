"""Mesh-size-adaptive shard_map tests (VERDICT r4 #8).

Unlike test_parallel.py (pinned 8-device virtual CPU meshes), every test
here builds its mesh from WHATEVER the backend offers — 8 devices on the
virtual-CPU lane, the cards of a GPU host — so the same shard_map programs
run with the compiled kernels on a GPU (JAX_PLATFORMS=cuda) and in the
Pallas interpreter on the CPU.

Reference parity: the reference has no distributed execution at all
(SURVEY.md §2.5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from numpower_tpu.models import condense, quadrotor12
from numpower_tpu.parallel import make_mesh, shard_batch


def _D(cap: int = 8) -> int:
    return min(jax.device_count(), cap)


@pytest.fixture(scope="module")
def qp_setup():
    A, B = quadrotor12(0.02)
    qp = condense(A, B, jnp.eye(12), jnp.eye(4) * 0.1, jnp.eye(12) * 5.0, 8)
    rng = np.random.default_rng(0)
    x0s = jnp.asarray(0.3 * rng.standard_normal((64, 12)).astype(np.float32))
    return qp, x0s


def _interpret():
    """Compiled kernels on a GPU, the Pallas interpreter elsewhere."""
    return jax.default_backend() != "gpu"


def test_dp_fista_kernel_on_mesh(qp_setup):
    """shard_map-routed FISTA kernel vs the direct kernel, bit-tight."""
    from numpower_tpu.models import solve_mpc_boxqp
    from numpower_tpu.models.condensed import default_coarse_iters
    from numpower_tpu.parallel import solve_mpc_boxqp_dp

    qp, x0s = qp_setup
    mesh = make_mesh((_D(), 1))
    ci = default_coarse_iters(qp, 40)
    r_dp = solve_mpc_boxqp_dp(qp, shard_batch(x0s, mesh), -1.0, 1.0, mesh,
                              iters=40, method="pallas", coarse_iters=ci,
                              interpret=_interpret())
    U_direct = solve_mpc_boxqp(qp, x0s, -1.0, 1.0, iters=40,
                               method="pallas", coarse_iters=ci,
                               interpret=_interpret()).U
    np.testing.assert_allclose(np.asarray(r_dp.U), np.asarray(U_direct),
                               atol=1e-5)


def test_dp_admm_kernel_on_mesh(qp_setup):
    from numpower_tpu.models.condensed import admm_coarse_iters
    from numpower_tpu.parallel import (
        solve_mpc_boxqp_admm_dp, solve_mpc_boxqp_dp,
    )

    qp, x0s = qp_setup
    mesh = make_mesh((_D(), 1))
    ai = admm_coarse_iters(qp, 40)
    r_admm = solve_mpc_boxqp_admm_dp(qp, shard_batch(x0s, mesh), -1.0, 1.0,
                                     mesh, iters=40, method="pallas",
                                     coarse_iters=ai, interpret=_interpret())
    r_fista = solve_mpc_boxqp_dp(qp, shard_batch(x0s, mesh), -1.0, 1.0,
                                 mesh, iters=40)
    # two different solvers on the same strongly-convex QP
    np.testing.assert_allclose(np.asarray(r_admm.U), np.asarray(r_fista.U),
                               atol=2e-3)


def test_sp_riccati_sharded_any_mesh():
    from numpower_tpu.models.lqr import riccati_scan
    from numpower_tpu.parallel import riccati_associative_sharded

    A, B = quadrotor12(0.02)
    Aj, Bj = jnp.asarray(A), jnp.asarray(B)
    Q = jnp.eye(12)
    R = jnp.eye(4) * 0.1
    QF = jnp.eye(12) * 5.0
    mesh = make_mesh((_D(), 1))
    T = 96
    Ks_sh, Ps_sh = riccati_associative_sharded(Aj, Bj, Q, R, QF, T, mesh)
    Ks_ref, Ps_ref = riccati_scan(Aj, Bj, Q, R, QF, T)
    np.testing.assert_allclose(np.asarray(Ks_sh), np.asarray(Ks_ref),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(np.asarray(Ps_sh), np.asarray(Ps_ref),
                               rtol=1e-3, atol=1e-2)


def test_sp_kalman_sharded_any_mesh():
    from numpower_tpu.models import double_integrator, kalman_filter
    from numpower_tpu.parallel import kalman_filter_associative_sharded

    A, _ = double_integrator(0.1)
    Aj = jnp.asarray(A)
    C = jnp.asarray([[1.0, 0.0]])
    Q = jnp.eye(2) * 1e-3
    R = jnp.eye(1) * 1e-2
    x0 = jnp.asarray([1.0, 0.0])
    P0 = jnp.eye(2) * 0.1
    rng = np.random.default_rng(3)
    ys = jnp.asarray(rng.standard_normal((64, 1)).astype(np.float32))
    mesh = make_mesh((_D(), 1))
    sp = kalman_filter_associative_sharded(Aj, C, Q, R, x0, P0, ys, mesh)
    ref = kalman_filter(Aj, C, Q, R, x0, P0, ys)
    np.testing.assert_allclose(np.asarray(sp.means), np.asarray(ref.means),
                               rtol=1e-4, atol=1e-4)


def test_sampling_dp_any_mesh():
    from numpower_tpu.models import (
        mppi_solve_batched, particle_filter, pendulum_step,
        quadratic_mppi_cost,
    )
    from numpower_tpu.parallel import mppi_solve_dp, particle_filter_dp

    D = _D(4)
    mesh = make_mesh((D, 1))
    Qp = jnp.diag(jnp.asarray([1.0, 0.1], jnp.float32))
    Rp = jnp.eye(1, dtype=jnp.float32) * 0.01
    QFp = jnp.diag(jnp.asarray([100.0, 10.0], jnp.float32))
    cost_fn = quadratic_mppi_cost(Qp, Rp, QFp, jnp.zeros(2))
    x0s = jnp.asarray(np.random.default_rng(3).uniform(-1, 1, (8 * D, 2)),
                      jnp.float32)
    key = jax.random.key(0)
    r_dp = mppi_solve_dp(pendulum_step, shard_batch(x0s, mesh), cost_fn, 10,
                         key, mesh, samples=32, iters=3, m=1, u_lo=-2.0,
                         u_hi=2.0)
    r_ref = mppi_solve_batched(pendulum_step, x0s, cost_fn, 10, key,
                               samples=32, iters=3, m=1, u_lo=-2.0, u_hi=2.0)
    np.testing.assert_allclose(np.asarray(r_dp.us), np.asarray(r_ref.us),
                               atol=1e-3)

    ys = jnp.asarray(
        0.3 * np.random.default_rng(4).standard_normal((8, 1)), jnp.float32)
    us = jnp.zeros((8, 1), jnp.float32)
    p_dp = particle_filter_dp(
        pendulum_step, lambda x: x[:1], jnp.eye(2) * 1e-3, jnp.eye(1) * 1e-2,
        jnp.zeros(2), jnp.eye(2) * 0.1, ys, us, key, mesh,
        n_particles=64 * D, axis=mesh.axis_names[0])
    p_ref = particle_filter(
        pendulum_step, lambda x: x[:1], jnp.eye(2) * 1e-3, jnp.eye(1) * 1e-2,
        jnp.zeros(2), jnp.eye(2) * 0.1, ys, us, key, n_particles=64 * D)
    np.testing.assert_allclose(np.asarray(p_dp.means),
                               np.asarray(p_ref.means), atol=1e-3)


def test_solver_families_dp_any_mesh():
    """AL-iLQR + MHE DP wrappers on whatever mesh exists (r4 additions)."""
    from numpower_tpu.models import pendulum_step
    from numpower_tpu.parallel.solvers_dp import al_ilqr_solve_dp, mhe_solve_dp

    D = _D(4)
    mesh = make_mesh((D, 1))
    rng = np.random.default_rng(5)
    x0s = jnp.asarray(rng.uniform(-0.5, 0.5, (4 * D, 2)), jnp.float32)
    res, worst = al_ilqr_solve_dp(
        pendulum_step, x0s, jnp.eye(2), jnp.eye(1) * 0.01, jnp.eye(2) * 10.0,
        jnp.zeros(2), 10, -2.0, 2.0, mesh, al_iters=2, ilqr_iters=3)
    assert np.isfinite(float(worst))
    assert res.us.shape == (4 * D, 10, 1)

    A = jnp.asarray([[1.0, 0.1], [0.0, 1.0]])
    C = jnp.asarray([[1.0, 0.0]])
    B = jnp.asarray([[0.005, 0.01], [0.1, 0.05]])  # wide B, uss=None path
    yss = jnp.asarray(rng.standard_normal((4 * D, 10, 1)).astype(np.float32))
    mres, mworst = mhe_solve_dp(A, C, jnp.eye(2) * 1e-3, jnp.eye(1) * 1e-2,
                                jnp.eye(2) * 0.1, jnp.zeros((4 * D, 2)), yss,
                                mesh, B=B, uss=None, iters=20)
    assert np.isfinite(float(mworst))
    assert mres.xs.shape[0] == 4 * D


def test_kalman_batched_dp_any_mesh():
    """DP batched-KF on whatever mesh exists vs the unsharded filter."""
    from numpower_tpu.models.estimation import kalman_filter_batched
    from numpower_tpu.parallel.sharding import kalman_filter_batched_dp

    D = _D()
    mesh = make_mesh((D, 1))
    A = jnp.asarray([[1.0, 0.1], [0.0, 1.0]])
    C = jnp.asarray([[1.0, 0.0]])
    Q = jnp.eye(2) * 1e-3
    R = jnp.eye(1) * 1e-2
    P0 = jnp.eye(2) * 0.1
    rng = np.random.default_rng(8)
    N, T = 16 * D, 25
    yss = jnp.asarray(rng.standard_normal((N, T, 1)).astype(np.float32))
    x0s = jnp.asarray(rng.standard_normal((N, 2)).astype(np.float32))
    res, total_ll = kalman_filter_batched_dp(
        A, C, Q, R, shard_batch(x0s, mesh), P0, shard_batch(yss, mesh),
        mesh)
    ref = kalman_filter_batched(A, C, Q, R, x0s, P0, yss)
    np.testing.assert_allclose(np.asarray(res.means), np.asarray(ref.means),
                               atol=1e-5)
    np.testing.assert_allclose(float(total_ll),
                               float(jnp.sum(ref.log_likelihood)),
                               rtol=1e-5)


def test_estimator_kernels_batched_any_backend():
    """ukf/ekf_filter_batched on the active backend against a loop of the
    single-trajectory filters."""
    from numpower_tpu.models.estimation import (
        ekf_filter, ekf_filter_batched, ukf_filter, ukf_filter_batched,
    )

    def f_pend(x, u):
        th, om = x[0], x[1]
        return jnp.stack(
            [th + 0.05 * om, om - 0.05 * 9.81 * jnp.sin(th) + 0.05 * u[0]])

    def h_pend(x):
        return x[:1]

    rng = np.random.default_rng(4)
    B, T = 8, 12
    Q = jnp.eye(2) * 1e-3
    R = jnp.eye(1) * 1e-2
    P0 = jnp.eye(2) * 0.1
    ys = jnp.asarray(rng.standard_normal((B, T, 1)).astype(np.float32))
    us = jnp.asarray(0.1 * rng.standard_normal((B, T, 1)).astype(np.float32))
    x0s = jnp.asarray(0.3 * rng.standard_normal((B, 2)).astype(np.float32))
    for batched, single in ((ukf_filter_batched, ukf_filter),
                            (ekf_filter_batched, ekf_filter)):
        res = batched(f_pend, h_pend, Q, R, x0s, P0, ys, us)
        for i in (0, B - 1):
            ref = single(f_pend, h_pend, Q, R, x0s[i], P0, ys[i], us[i])
            np.testing.assert_allclose(np.asarray(res.means[i]),
                                       np.asarray(ref.means), atol=1e-4)
