"""MPC engine tests (BASELINE configs #1-#5 in miniature).

Parity strategy: each solver is checked against an independent fp64 numpy
implementation of the same math (the stand-in for the "CPU NumPower-op
reference control sequence", BASELINE.md <=1e-4 bound).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from numpower_tpu.models import (
    condense, double_integrator, quadrotor12, cartpole_step,
    gradient_offset, ilqr_solve, lqr_infinite_gain, lqr_solve,
    lqr_solve_batched, riccati_associative, riccati_scan,
    rollout_lti, rollout_nonlinear, linearize, linearize_finite_diff,
    solve_boxqp_fista, solve_boxqp_pg, solve_mpc_boxqp, tube_mpc_solve,
    prediction_matrices,
)


def np_riccati(A, B, Q, R, QF, T):
    """fp64 numpy reference Riccati (the NumPower-user equivalent)."""
    A, B, Q, R, QF = [np.asarray(M, np.float64) for M in (A, B, Q, R, QF)]
    P = QF
    Ks = []
    for _ in range(T):
        BtP = B.T @ P
        K = np.linalg.solve(R + BtP @ B, BtP @ A)
        P = Q + A.T @ P @ A - (BtP @ A).T @ K
        P = 0.5 * (P + P.T)
        Ks.append(K)
    return np.array(Ks[::-1]), P


@pytest.fixture(scope="module")
def di():
    return double_integrator(0.1)


@pytest.fixture(scope="module")
def quad():
    return quadrotor12(0.02)


def test_rollout_lti_matches_numpy(di):
    A, B = di
    x0 = jnp.array([1.0, 0.0])
    us = jnp.ones((5, 1)) * 0.1
    xs = np.asarray(rollout_lti(A, B, x0, us))
    x = np.array([1.0, 0.0])
    expect = [x]
    for t in range(5):
        x = np.asarray(A) @ x + np.asarray(B) @ np.asarray(us[t])
        expect.append(x)
    np.testing.assert_allclose(xs, np.stack(expect), rtol=1e-5, atol=1e-6)


def test_riccati_scan_parity_vs_fp64(di):
    A, B = di
    Q = jnp.eye(2); R = jnp.eye(1) * 0.1; QF = jnp.eye(2) * 10.0
    Ks, Ps = riccati_scan(A, B, Q, R, QF, 30)
    Ks_ref, P0_ref = np_riccati(A, B, Q, R, QF, 30)
    np.testing.assert_allclose(np.asarray(Ks), Ks_ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(Ps[0]), P0_ref, rtol=1e-4, atol=1e-3)


def test_riccati_associative_matches_sequential(di):
    A, B = di
    Q = jnp.eye(2); R = jnp.eye(1) * 0.1; QF = jnp.eye(2) * 10.0
    Ks_seq, Ps_seq = riccati_scan(A, B, Q, R, QF, 32)
    Ks_par, Ps_par = riccati_associative(A, B, Q, R, QF, 32)
    np.testing.assert_allclose(np.asarray(Ks_par), np.asarray(Ks_seq), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(np.asarray(Ps_par), np.asarray(Ps_seq), rtol=1e-3, atol=1e-3)


def test_riccati_associative_quadrotor(quad):
    A, B = quad
    Q = jnp.eye(12); R = jnp.eye(4) * 0.1; QF = jnp.eye(12) * 5.0
    Ks_seq, _ = riccati_scan(A, B, Q, R, QF, 30)
    Ks_par, _ = riccati_associative(A, B, Q, R, QF, 30)
    np.testing.assert_allclose(np.asarray(Ks_par), np.asarray(Ks_seq), rtol=1e-3, atol=1e-4)


def test_lqr_solve_drives_to_origin(di):
    A, B = di
    Q = jnp.eye(2); R = jnp.eye(1) * 0.1; QF = jnp.eye(2) * 100.0
    us, xs = lqr_solve(A, B, Q, R, QF, jnp.array([1.0, 0.0]), horizon=30)
    assert np.linalg.norm(np.asarray(xs[-1])) < 5e-2
    # parity vs fp64 forward rollout using fp64 gains (config #1 parity)
    Ks_ref, _ = np_riccati(A, B, Q, R, QF, 30)
    x = np.array([1.0, 0.0]); us_ref = []
    for K in Ks_ref:
        u = -K @ x
        us_ref.append(u)
        x = np.asarray(A, np.float64) @ x + np.asarray(B, np.float64) @ u
    np.testing.assert_allclose(np.asarray(us)[:, 0], np.array(us_ref)[:, 0],
                               rtol=1e-3, atol=1e-4)


def test_lqr_batched_scenarios(di):
    A, B = di
    Q = jnp.eye(2); R = jnp.eye(1) * 0.1; QF = jnp.eye(2) * 10.0
    x0s = jnp.stack([jnp.array([1.0, 0.0]), jnp.array([-2.0, 0.5]), jnp.array([0.0, 1.0])])
    us, xs = lqr_solve_batched(A, B, Q, R, QF, x0s, horizon=30)
    assert us.shape == (3, 30, 1) and xs.shape == (3, 31, 2)
    # scenario 0 must equal single solve
    us0, _ = lqr_solve(A, B, Q, R, QF, x0s[0], horizon=30)
    np.testing.assert_allclose(np.asarray(us[0]), np.asarray(us0), rtol=1e-5, atol=1e-6)


def test_lqr_infinite_gain_stabilizes(di):
    A, B = di
    K, P = lqr_infinite_gain(A, B, jnp.eye(2), jnp.eye(1) * 0.1)
    cl = np.asarray(A) - np.asarray(B) @ np.asarray(K)
    assert np.max(np.abs(np.linalg.eigvals(cl))) < 1.0


def test_prediction_matrices(di):
    A, B = di
    Sx, Su = prediction_matrices(A, B, 3)
    An, Bn = np.asarray(A, np.float64), np.asarray(B, np.float64)
    np.testing.assert_allclose(np.asarray(Sx), np.vstack([An, An @ An, An @ An @ An]), rtol=1e-5)
    # x2 = A^2 x0 + A B u0 + B u1: check Su block (1,0) = A B
    np.testing.assert_allclose(np.asarray(Su)[2:4, 0:1], An @ Bn, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(Su)[2:4, 1:2], Bn, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(Su)[0:2, 1:2], 0 * Bn, atol=1e-7)


def np_condensed(A, B, Q, R, QF, T):
    A, B, Q, R, QF = [np.asarray(M, np.float64) for M in (A, B, Q, R, QF)]
    n, m = A.shape[0], B.shape[1]
    Ap = [np.eye(n)]
    for _ in range(T):
        Ap.append(A @ Ap[-1])
    Sx = np.vstack(Ap[1:])
    Su = np.zeros((T * n, T * m))
    for i in range(T):
        for j in range(i + 1):
            Su[i * n:(i + 1) * n, j * m:(j + 1) * m] = Ap[i - j] @ B
    Qb = np.kron(np.eye(T), Q)
    Qb[-n:, -n:] = QF
    Rb = np.kron(np.eye(T), R)
    H = Su.T @ Qb @ Su + Rb
    return H, Sx, Su, Qb


def test_condense_matches_fp64(di):
    A, B = di
    Q = jnp.eye(2); R = jnp.eye(1) * 0.1; QF = jnp.eye(2) * 10.0
    qp = condense(A, B, Q, R, QF, 10)
    H_ref, Sx_ref, Su_ref, Qb = np_condensed(A, B, Q, R, QF, 10)
    np.testing.assert_allclose(np.asarray(qp.H), H_ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(qp.Sx), Sx_ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(qp.Su), Su_ref, rtol=1e-5, atol=1e-6)
    # lipschitz ~= lambda_max(H)
    lmax_ref = np.linalg.eigvalsh(H_ref).max()
    np.testing.assert_allclose(float(qp.lipschitz), lmax_ref, rtol=1e-3)
    # gradient offset
    x0 = jnp.array([1.0, -0.5])
    g = gradient_offset(qp, x0)
    g_ref = Su_ref.T @ Qb @ (Sx_ref @ np.asarray(x0, np.float64))
    np.testing.assert_allclose(np.asarray(g), g_ref, rtol=1e-4, atol=1e-4)


def _np_boxqp_exact(H, g, lo, hi, iters=20000):
    """fp64 projected gradient run to convergence — ground truth."""
    H = np.asarray(H, np.float64); g = np.asarray(g, np.float64)
    L = np.linalg.eigvalsh(H).max()
    U = np.zeros_like(g)
    for _ in range(iters):
        U = np.clip(U - (1.0 / L) * (U @ H.T + g), lo, hi)
    return U


def test_boxqp_unconstrained_matches_linear_solve(di):
    A, B = di
    Q = jnp.eye(2); R = jnp.eye(1) * 0.1; QF = jnp.eye(2) * 10.0
    qp = condense(A, B, Q, R, QF, 10)
    x0s = jnp.array([[0.3, -0.2]])
    g = gradient_offset(qp, x0s)
    # loose bounds -> unconstrained optimum -H^{-1} g
    res = solve_boxqp_fista(qp.H, g, -1e6, 1e6, L=qp.lipschitz, iters=300)
    U_ref = -np.linalg.solve(np.asarray(qp.H, np.float64), np.asarray(g[0], np.float64))
    np.testing.assert_allclose(np.asarray(res.U[0]), U_ref, rtol=1e-3, atol=1e-4)


def test_boxqp_constrained_parity(quad):
    A, B = quad
    Q = jnp.eye(12); R = jnp.eye(4) * 0.1; QF = jnp.eye(12) * 5.0
    qp = condense(A, B, Q, R, QF, 10)
    rng = np.random.default_rng(0)
    x0s = jnp.asarray(rng.standard_normal((4, 12)).astype(np.float32))
    g = gradient_offset(qp, x0s)
    res = solve_boxqp_fista(qp.H, g, -0.5, 0.5, L=qp.lipschitz, iters=200)
    for i in range(4):
        U_ref = _np_boxqp_exact(qp.H, np.asarray(g[i]), -0.5, 0.5)
        np.testing.assert_allclose(np.asarray(res.U[i]), U_ref, rtol=2e-3, atol=2e-4)
    # active bounds must be respected exactly
    assert float(jnp.max(jnp.abs(res.U))) <= 0.5 + 1e-6


def test_boxqp_pg_vs_fista_agree(di):
    A, B = di
    qp = condense(A, B, jnp.eye(2), jnp.eye(1) * 0.1, jnp.eye(2) * 10.0, 15)
    x0s = jnp.array([[1.0, 0.0], [0.0, -1.0]])
    g = gradient_offset(qp, x0s)
    r1 = solve_boxqp_pg(qp.H, g, -0.4, 0.4, L=qp.lipschitz, iters=2000)
    r2 = solve_boxqp_fista(qp.H, g, -0.4, 0.4, L=qp.lipschitz, iters=300)
    np.testing.assert_allclose(np.asarray(r1.U), np.asarray(r2.U), rtol=1e-3, atol=2e-4)


def test_solve_mpc_boxqp_end_to_end(quad):
    # config #4 in miniature: batched scenarios, box constraints
    A, B = quad
    Q = jnp.eye(12); R = jnp.eye(4) * 0.1; QF = jnp.eye(12) * 5.0
    qp = condense(A, B, Q, R, QF, 30)
    rng = np.random.default_rng(1)
    x0s = jnp.asarray(0.3 * rng.standard_normal((16, 12)).astype(np.float32))
    res = solve_mpc_boxqp(qp, x0s, -1.0, 1.0, iters=60)
    assert res.U.shape == (16, 120)
    assert float(res.residual) < 1e-2
    # controls must reduce cost vs zero controls
    for i in [0, 7]:
        U = np.asarray(res.U[i], np.float64)
        g = np.asarray(gradient_offset(qp, x0s)[i], np.float64)
        H = np.asarray(qp.H, np.float64)
        cost_u = 0.5 * U @ H @ U + g @ U
        assert cost_u < 0.0  # better than U=0


def test_linearize_fd_matches_jacfwd():
    x = jnp.array([0.1, 0.2, 0.0, -0.1])
    u = jnp.array([0.5])
    A1, B1 = linearize(cartpole_step, x, u)
    A2, B2 = linearize_finite_diff(cartpole_step, x, u, eps=1e-3)
    np.testing.assert_allclose(np.asarray(A1), np.asarray(A2), rtol=2e-2, atol=2e-3)
    np.testing.assert_allclose(np.asarray(B1), np.asarray(B2), rtol=2e-2, atol=2e-3)


def test_ilqr_cartpole_swingup_improves():
    # config #3 in miniature: drive cartpole toward upright
    x0 = jnp.array([0.0, jnp.pi, 0.0, 0.0])  # hanging down
    x_goal = jnp.zeros(4)  # upright at origin (theta=0 upright in this model)
    Q = jnp.diag(jnp.array([1.0, 10.0, 0.1, 0.1]))
    R = jnp.eye(1) * 0.01
    QF = jnp.diag(jnp.array([10.0, 100.0, 1.0, 1.0]))
    res = ilqr_solve(cartpole_step, x0, Q, R, QF, x_goal, horizon=60, iters=30)
    assert float(res.cost) < float(res.costs[0])  # strictly improved
    # monotone nonincreasing cost trace
    costs = np.asarray(res.costs)
    assert np.all(np.diff(costs) <= 1e-5)


def test_ilqr_finite_diff_matches_jacfwd_cartpole():
    x0 = jnp.array([0.0, 0.3, 0.0, 0.0])
    x_goal = jnp.zeros(4)
    Q = jnp.eye(4); R = jnp.eye(1) * 0.1; QF = jnp.eye(4) * 10.0
    r1 = ilqr_solve(cartpole_step, x0, Q, R, QF, x_goal, horizon=40, iters=15, use_fd=False)
    r2 = ilqr_solve(cartpole_step, x0, Q, R, QF, x_goal, horizon=40, iters=15, use_fd=True, fd_eps=1e-3)
    np.testing.assert_allclose(float(r1.cost), float(r2.cost), rtol=1e-2)


def test_tube_mpc(quad):
    A, B = quad
    Q = jnp.eye(12); R = jnp.eye(4) * 0.1; QF = jnp.eye(12) * 5.0
    qp = condense(A, B, Q, R, QF, 20)
    rng = np.random.default_rng(2)
    w = jnp.asarray(0.001 * rng.standard_normal((32, 20, 12)).astype(np.float32))
    x0 = jnp.asarray(0.2 * rng.standard_normal(12).astype(np.float32))
    res = tube_mpc_solve(qp, A, B, Q, R, x0, w, -1.0, 1.0)
    assert res.xs_scenarios.shape == (32, 21, 12)
    assert res.tube_radius.shape == (21,)
    assert float(res.tube_radius[0]) == 0.0  # all scenarios start at x0
    assert float(res.max_violation) <= 1e-6  # feedback clipped to bounds
    # disturbed trajectories stay near nominal (small disturbances)
    assert float(res.tube_radius.max()) < 0.5


def test_riccati_per_scenario_matches_vmapped(quad):
    from numpower_tpu.models import riccati_scan_per_scenario

    A, B = quad
    Q = jnp.eye(12); R = jnp.eye(4) * 0.1; QF = jnp.eye(12) * 5.0
    rng = np.random.default_rng(5)
    N = 6
    As = jnp.asarray(np.tile(np.asarray(A), (N, 1, 1))
                     + 0.01 * rng.standard_normal((N, 12, 12)).astype(np.float32))
    Bs = jnp.broadcast_to(jnp.asarray(B), (N, 12, 4))
    Ks, P0 = riccati_scan_per_scenario(As, Bs, Q, R, QF, 20)
    assert Ks.shape == (N, 20, 4, 12)
    # scenario i must match the single-system scan on (As[i], Bs[i])
    for i in [0, 3]:
        Ks_ref, Ps_ref = riccati_scan(As[i], Bs[i], Q, R, QF, 20)
        np.testing.assert_allclose(np.asarray(Ks[i]), np.asarray(Ks_ref),
                                   rtol=2e-3, atol=2e-4)
        np.testing.assert_allclose(np.asarray(P0[i]), np.asarray(Ps_ref[0]),
                                   rtol=2e-3, atol=2e-3)


def test_lqt_tracking_matches_condensed_solve(di):
    """LQT (affine Riccati) must equal the unconstrained condensed QP solve
    with the same stacked reference."""
    from numpower_tpu.models.lqr import lqt_solve

    A, B = di
    Q = jnp.eye(2); R = jnp.eye(1) * 0.1; QF = jnp.eye(2) * 10.0
    T = 12
    x0 = jnp.array([0.5, -0.2])
    # reference: ramp in position, zero velocity
    refs = jnp.stack([jnp.array([0.1 * t, 0.0]) for t in range(T + 1)])
    us, xs = lqt_solve(A, B, Q, R, QF, x0, refs, T)

    # condensed ground truth (fp64): min 1/2 U'HU + g'U with Xref stacking
    H_ref, Sx_ref, Su_ref, Qb = np_condensed(A, B, Q, R, QF, T)
    xref_stack = np.asarray(refs[1:], np.float64).reshape(-1)
    g = Su_ref.T @ Qb @ (Sx_ref @ np.asarray(x0, np.float64) - xref_stack)
    # J = sum (x-r)'Q(x-r) + u'Ru -> 0.5 U'(2H)U + (2g)'U: optimum -H^{-1} g
    U_opt = -np.linalg.solve(H_ref, g)
    np.testing.assert_allclose(np.asarray(us).reshape(-1), U_opt,
                               rtol=2e-3, atol=2e-3)
    # trajectory actually tracks the ramp mid-horizon
    mid = np.asarray(xs)[T // 2]
    assert abs(mid[0] - 0.1 * (T // 2)) < 0.2


def test_lqt_zero_reference_equals_lqr(di):
    from numpower_tpu.models.lqr import lqt_solve

    A, B = di
    Q = jnp.eye(2); R = jnp.eye(1) * 0.1; QF = jnp.eye(2) * 10.0
    x0 = jnp.array([1.0, 0.0])
    refs = jnp.zeros((21, 2))
    us_t, _ = lqt_solve(A, B, Q, R, QF, x0, refs, 20)
    us_r, _ = lqr_solve(A, B, Q, R, QF, x0, 20)
    np.testing.assert_allclose(np.asarray(us_t), np.asarray(us_r),
                               rtol=1e-4, atol=1e-5)


def test_riccati_associative_nopivot_matches(quad):
    """The fusion-friendly unpivoted combine solver must match the pivoted
    default on the quadrotor dims (PSD algebra keeps pivots >= 1)."""
    A, B = quad
    Q = jnp.eye(12); R = jnp.eye(4) * 0.1; QF = jnp.eye(12) * 5.0
    Ks_pv, Ps_pv = riccati_associative(A, B, Q, R, QF, 64)
    Ks_np, Ps_np = riccati_associative(A, B, Q, R, QF, 64, nopivot=True)
    np.testing.assert_allclose(np.asarray(Ks_np), np.asarray(Ks_pv),
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(np.asarray(Ps_np), np.asarray(Ps_pv),
                               rtol=1e-3, atol=1e-3)
