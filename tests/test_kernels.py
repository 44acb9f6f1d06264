"""Fused box-QP kernel tests (kernels/boxqp.py) in the Pallas interpreter.

The compiled kernels run only on a GPU: the `gpu`-marked tests at the end
cover them there, and chip_smoke.py checks them at the flagship width."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from numpower_tpu.kernels import boxqp as kernels
from numpower_tpu.models import (
    condense, gradient_offset, quadrotor12, solve_boxqp_fista,
    solve_mpc_boxqp, solve_mpc_boxqp_admm,
)
from numpower_tpu.models.admm import minv_factor
from numpower_tpu.models.boxqp import prediction_chain
from numpower_tpu.models.condensed import admm_coarse_iters, default_coarse_iters

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import boxqp_ref, condense_ref, flagship_costs, quadrotor_plant  # noqa: E402


def _quad_qp(T):
    A, B = quadrotor12(0.02)
    Q, R, QF = (jnp.asarray(M, jnp.float32) for M in flagship_costs())
    return condense(A, B, Q, R, QF, T)


@pytest.fixture(scope="module")
def qp_and_g():
    qp = _quad_qp(10)  # d = 40
    rng = np.random.default_rng(0)
    x0s = jnp.asarray(0.3 * rng.standard_normal((24, 12)).astype(np.float32))
    return qp, gradient_offset(qp, x0s), x0s


def _fista(qp, x0s, lo, hi, iters, coarse_iters=0, U0=None, x_ref=None):
    W, b = prediction_chain(qp, x_ref)
    return kernels.fista_mpc(qp.H, W, b, x0s, lo, hi, qp.lipschitz,
                             iters=iters, coarse_iters=coarse_iters, U0=U0,
                             interpret=True)


def _admm(qp, x0s, lo, hi, iters, coarse_iters=0, U0=None):
    W, b = prediction_chain(qp)
    rho = jnp.sqrt(qp.lipschitz * jnp.maximum(qp.mu, 1e-12))
    return kernels.admm_mpc(minv_factor(qp.H, rho), W, b, x0s, lo, hi, rho,
                            1.6, iters=iters, coarse_iters=coarse_iters,
                            U0=U0, interpret=True)


def test_fista_kernel_matches_xla(qp_and_g):
    qp, g, x0s = qp_and_g
    ref = solve_boxqp_fista(qp.H, g, -0.5, 0.5, L=qp.lipschitz, iters=60)
    U, _ = _fista(qp, x0s, -0.5, 0.5, 60)
    np.testing.assert_allclose(np.asarray(U), np.asarray(ref.U), rtol=1e-4,
                               atol=1e-5)


def test_fista_kernel_ragged_batch(qp_and_g):
    # N=24 with tile 16 -> padding path exercised
    qp, g, x0s = qp_and_g
    U, _ = _fista(qp, x0s, -0.5, 0.5, 30)
    assert U.shape == g.shape
    assert float(jnp.max(jnp.abs(U))) <= 0.5 + 1e-6


def test_fista_kernel_unconstrained_parity(qp_and_g):
    qp, g, x0s = qp_and_g
    U, _ = _fista(qp, x0s, -1e6, 1e6, 400)
    U_ref = -np.linalg.solve(np.asarray(qp.H, np.float64),
                             np.asarray(g, np.float64).T).T
    np.testing.assert_allclose(np.asarray(U), U_ref, rtol=2e-3, atol=1e-3)


def test_fista_kernel_warm_start(qp_and_g):
    qp, _, x0s = qp_and_g
    U_star, _ = _fista(qp, x0s, -0.5, 0.5, 300)
    # warm start from the solution: few iterations must stay at it
    U_warm, _ = _fista(qp, x0s, -0.5, 0.5, 5, U0=U_star)
    np.testing.assert_allclose(np.asarray(U_warm), np.asarray(U_star),
                               rtol=1e-4, atol=1e-5)


def test_fista_mpc_fused_g_matches_two_step(qp_and_g):
    """g formed in the kernel from x0 (and the x_ref bias row) == the XLA
    scan on the materialized g."""
    qp, _, x0s = qp_and_g
    x_ref = jnp.linspace(-0.2, 0.2, 12)
    g = gradient_offset(qp, x0s, x_ref)
    ref = solve_boxqp_fista(qp.H, g, -0.5, 0.5, L=qp.lipschitz, iters=300)
    U, _ = _fista(qp, x0s, -0.5, 0.5, 300, x_ref=x_ref)
    np.testing.assert_allclose(np.asarray(U), np.asarray(ref.U), rtol=1e-4,
                               atol=2e-5)


def test_fista_fused_res_warm_start(qp_and_g):
    """The kernel's per-row residual, reduced outside, is small at the
    converged solution and a warm-started solve stays there."""
    qp, _, x0s = qp_and_g
    U_star, _ = _fista(qp, x0s, -0.5, 0.5, 300)
    U_warm, resid = _fista(qp, x0s, -0.5, 0.5, 5, U0=U_star)
    np.testing.assert_allclose(np.asarray(U_warm), np.asarray(U_star),
                               rtol=1e-4, atol=1e-5)
    assert float(resid) < 1e-3


def test_admm_fused_res_warm_start(qp_and_g):
    """Same warm-start contract for the ADMM kernel (the ADMM serving
    path, models/mpc.MPCController(solver='admm'))."""
    qp, _, x0s = qp_and_g
    z_star, _, _ = _admm(qp, x0s, -0.5, 0.5, 300)
    z_warm, rp, _ = _admm(qp, x0s, -0.5, 0.5, 10, U0=z_star)
    np.testing.assert_allclose(np.asarray(z_warm), np.asarray(z_star),
                               rtol=1e-4, atol=5e-5)
    assert float(rp) < 1e-3


def test_admm_kernel_residuals_match_xla(qp_and_g):
    qp, _, x0s = qp_and_g
    z, rp, rd = _admm(qp, x0s, -0.5, 0.5, 60)
    ref = solve_mpc_boxqp_admm(qp, x0s, -0.5, 0.5, iters=60, method="xla")
    np.testing.assert_allclose(np.asarray(z), np.asarray(ref.U), atol=2e-5)
    np.testing.assert_allclose(float(rp), float(ref.primal_residual),
                               atol=2e-5)
    np.testing.assert_allclose(float(rd), float(ref.dual_residual),
                               atol=2e-5)


def test_flops_mfu_model():
    """utils/flops.py invariants: logical <= padded, the d=120->128 tile
    padding, the coarse/tail split and the MFU algebra."""
    from numpower_tpu.utils.flops import PEAKS, mfu_report, qp_kernel_cost

    h100 = PEAKS["NVIDIA H100 80GB HBM3"]
    c = qp_kernel_cost(N=4096, n=12, d=120, iters=40, coarse_iters=27)
    assert c.flops_logical < c.flops_padded
    assert c.flops_bf16 + c.flops_fp32 == pytest.approx(c.flops_padded)
    assert 0.10 < c.padding_waste < 0.25
    assert abs(c.mfu(c.sol_seconds(h100), h100) - 1.0) < 1e-12
    a = qp_kernel_cost(N=4096, n=12, d=120, iters=40, coarse_iters=32)
    # more coarse iterations -> a shorter tensor-core speed of light
    assert a.sol_seconds(h100) < c.sol_seconds(h100)
    assert "MFU n/a" in mfu_report("x", c, 60e-6, None)
    assert "MFU" in mfu_report("x", c, 60e-6, h100)


def test_fista_fused_long_horizon_envelope():
    """A horizon-100 quadrotor QP (d = 400) is outside the kernels' tiles:
    "auto" takes the XLA scan and an explicit kernel request refuses."""
    qp = _quad_qp(100)
    assert not kernels.fits(qp.H.shape[0], qp.n)
    x0s = jnp.zeros((4, 12), jnp.float32)
    res = solve_mpc_boxqp(qp, x0s, -0.5, 0.5, iters=5, method="auto")
    assert res.U.shape == (4, 400)
    with pytest.raises(ValueError, match="envelope"):
        solve_mpc_boxqp(qp, x0s, -0.5, 0.5, iters=5, method="pallas",
                        interpret=True)


# --- parity of both kernels with the fp64 optimum --------------------------

_REF_CACHE = {}


def _fp64_case(N, T):
    """(qp, x0s, U*) for the quadrotor at horizon T: U* from the plain fp64
    reference of chip_smoke.py."""
    if (N, T) not in _REF_CACHE:
        qp = _quad_qp(T)
        x0 = (0.3 * np.random.default_rng(N + T).standard_normal((N, 12))
              ).astype(np.float32)
        A, B = quadrotor_plant()
        H, G = condense_ref(A, B, *flagship_costs(), T)
        _REF_CACHE[(N, T)] = (qp, jnp.asarray(x0),
                              boxqp_ref(H, x0.astype(np.float64) @ G, -1.0,
                                        1.0))
    return _REF_CACHE[(N, T)]


@pytest.mark.parametrize("kernel", ["fista", "admm"])
@pytest.mark.parametrize("N", [1, 37, 200])
@pytest.mark.parametrize("T", [2, 30])                  # d = 8 and d = 120
@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("coarse", [True, False])
def test_qp_kernel_matches_fp64_reference(kernel, N, T, warm, coarse):
    qp, x0s, U_star = _fp64_case(N, T)
    iters = 40
    U0 = None
    if warm:
        # the shifted plan a serving tick passes: right values, one stage off
        m = qp.m
        U0 = jnp.asarray(np.concatenate([U_star[:, m:], U_star[:, -m:]], 1),
                         jnp.float32)
    if kernel == "fista":
        ci = default_coarse_iters(qp, iters) if coarse else 0
        U, resid = _fista(qp, x0s, -1.0, 1.0, iters, ci, U0)
    else:
        ci = admm_coarse_iters(qp, iters) if coarse else 0
        U, resid, _ = _admm(qp, x0s, -1.0, 1.0, iters, ci, U0)
    assert U.shape == (N, 4 * T)
    assert float(np.max(np.abs(np.asarray(U, np.float64) - U_star))) <= 1e-4
    assert float(resid) < 1e-3


# --- on the card ------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["fista", "admm"])
def test_compiled_kernel_matches_fp64_on_gpu(kernel):
    """The compiled Triton kernels (no interpreter) at the flagship width."""
    qp, x0s, U_star = _fp64_case(200, 30)
    solve = solve_mpc_boxqp if kernel == "fista" else solve_mpc_boxqp_admm
    U = solve(qp, x0s, -1.0, 1.0, iters=40, method="pallas").U
    assert float(np.max(np.abs(np.asarray(U, np.float64) - U_star))) <= 1e-4


@pytest.mark.gpu
def test_auto_route_lowers_to_triton_on_gpu():
    qp, x0s, _ = _fp64_case(200, 30)
    lowered = jax.jit(lambda x: solve_mpc_boxqp(qp, x, -1.0, 1.0,
                                                iters=40).U).lower(x0s)
    assert "__gpu$xla.gpu.triton" in lowered.as_text()
    assert "triton" in lowered.compile().as_text().lower()
