"""The route chooser (utils/platform.py), device peaks (utils/flops.py), the
compile-cache helper (utils/config.py), the registered-dataclass pytrees
and chip_smoke.py's refusal to run without a GPU."""

import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from numpower_tpu.utils.platform import KernelUnavailableError, platform, route

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# --- route --------------------------------------------------------------------

@pytest.mark.parametrize("fits", [True, False])
@pytest.mark.parametrize("interpret", [True, False])
def test_auto_never_picks_a_kernel_on_cpu(fits, interpret):
    assert route("auto", fits=fits, interpret=interpret, on="cpu") == "xla"


@pytest.mark.parametrize("on", ["cpu", "gpu", "rocm"])
@pytest.mark.parametrize("fits", [True, False])
def test_auto_never_picks_interpret(on, fits):
    assert route("auto", fits=fits, interpret=True, on=on) in ("xla", "kernel")


def test_auto_on_gpu_picks_the_kernel_inside_its_envelope():
    assert route("auto", fits=True, on="gpu") == "kernel"
    assert route("auto", fits=False, on="gpu") == "xla"


@pytest.mark.parametrize("on", ["cpu", "rocm"])
def test_explicit_kernel_request_raises_where_it_cannot_compile(on):
    with pytest.raises(KernelUnavailableError):
        route("pallas", fits=True, on=on)


def test_explicit_requests():
    assert route("pallas", fits=True, on="gpu") == "kernel"
    assert route("pallas", fits=True, interpret=True, on="cpu") == "interpret"
    assert route("xla", fits=True, on="gpu") == "xla"
    with pytest.raises(ValueError, match="envelope"):
        route("pallas", fits=False, interpret=True, on="cpu")
    with pytest.raises(ValueError, match="unknown method"):
        route("fused", fits=True, on="gpu")


def test_platform_of_default_backend_and_mesh():
    from numpower_tpu.parallel import make_mesh

    assert platform() == jax.default_backend() == "cpu"
    assert platform(make_mesh((2, 1), devices=jax.devices()[:2]).devices) == "cpu"


def test_public_solvers_refuse_a_kernel_on_cpu():
    from numpower_tpu.models import (
        condense, double_integrator, solve_mpc_boxqp, solve_mpc_boxqp_admm,
    )
    from numpower_tpu.parallel import make_mesh, solve_mpc_boxqp_dp

    A, B = double_integrator(0.1)
    qp = condense(A, B, jnp.eye(2), jnp.eye(1) * 0.1, jnp.eye(2), 8)
    x0s = jnp.zeros((8, 2))
    for solve in (solve_mpc_boxqp, solve_mpc_boxqp_admm):
        with pytest.raises(KernelUnavailableError):
            solve(qp, x0s, -1.0, 1.0, iters=4, method="pallas")
    mesh = make_mesh((8, 1))
    with pytest.raises(KernelUnavailableError):
        solve_mpc_boxqp_dp(qp, x0s, -1.0, 1.0, mesh, iters=4, method="pallas")


# --- device peaks -------------------------------------------------------------

def test_h100_peaks_from_the_data_sheet():
    from numpower_tpu.utils.flops import device_peaks

    p = device_peaks(SimpleNamespace(platform="gpu",
                                     device_kind="NVIDIA H100 80GB HBM3"))
    assert (p.bf16_tflops, p.tf32_tflops, p.fp32_tflops, p.hbm_gbps) == (
        989.0, 495.0, 67.0, 3350.0)


def test_unknown_accelerator_kind_raises_and_cpu_has_none():
    from numpower_tpu.utils.flops import device_peaks, roofline_report
    from numpower_tpu.utils.flops import RooflineCost

    with pytest.raises(ValueError, match="no published peaks"):
        device_peaks(SimpleNamespace(platform="gpu", device_kind="Mystery X1"))
    assert device_peaks() is None  # the CPU backend of this suite
    assert "utilization n/a" in roofline_report("x", RooflineCost(1.0, 1.0),
                                                1e-3)


# --- compile cache ------------------------------------------------------------

@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_defaults_to_the_checkout(monkeypatch,
                                                restore_cache_dir):
    from numpower_tpu.utils.config import enable_compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = enable_compile_cache()
    assert path == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    assert enable_compile_cache() == path  # fixed: no pid, time or temp name


def test_compile_cache_env_var_wins(monkeypatch, tmp_path, restore_cache_dir):
    from numpower_tpu.utils.config import enable_compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # nothing set


# --- registered dataclasses ----------------------------------------------------

def _qp(T=6, Qscale=1.0):
    from numpower_tpu.models import condense, double_integrator

    A, B = double_integrator(0.1)
    return condense(A, B, Qscale * jnp.eye(2), jnp.eye(1) * 0.1,
                    jnp.eye(2), T)


def test_condensed_qp_pytree_keeps_static_fields_out_of_the_leaves():
    qp = _qp()
    leaves, treedef = jax.tree_util.tree_flatten(qp)
    assert len(leaves) == 6  # H, Sx, Su, SuTQ, lipschitz, mu
    back = jax.tree_util.tree_unflatten(treedef, leaves)
    assert (back.T, back.n, back.m, back.kappa) == (qp.T, qp.n, qp.m, qp.kappa)


def test_condensed_qp_as_jit_argument_does_not_retrace():
    traces = []

    @jax.jit
    def f(qp, x):
        traces.append(qp.T)
        return qp.H @ x

    qp1, qp2 = _qp(), _qp(Qscale=2.0)
    assert qp1.kappa != qp2.kappa
    x = jnp.ones(6)
    f(qp1, x)
    f(qp1, x + 1.0)
    assert len(traces) == 1
    f(qp2, x)  # kappa is static metadata: a new value is a new program
    assert len(traces) == 2


def test_mpc_state_pytree_and_single_executable():
    from numpower_tpu.models import MPCController, double_integrator
    from numpower_tpu.models.mpc import MPCState

    st = MPCState(U_prev=jnp.zeros((2, 3)), tick=jnp.asarray(0))
    assert len(jax.tree_util.tree_leaves(st)) == 2
    A, B = double_integrator(0.1)
    ctrl = MPCController(A, B, np.eye(2, dtype=np.float32),
                         np.eye(1, dtype=np.float32), np.eye(2, dtype=np.float32),
                         horizon=5, u_lo=-1.0, u_hi=1.0, iters=5)
    state = ctrl.init(4)
    x0s = jnp.ones((4, 2))
    for _ in range(2):
        _, state = ctrl.step(state, x0s)
    assert ctrl.compile_cache_size() == 1
    assert int(state.tick) == 2


# --- chip_smoke.py ------------------------------------------------------------

def test_chip_smoke_refuses_the_cpu(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       capture_output=True, text=True, cwd=REPO, env=env,
                       timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    # alone in a directory, without the package, it fails too
    lone = tmp_path / "chip_smoke.py"
    lone.write_text(open(os.path.join(REPO, "chip_smoke.py")).read())
    r = subprocess.run([sys.executable, str(lone)], capture_output=True,
                       text=True, cwd=tmp_path, env=env, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_chip_smoke_fp64_reference_matches_the_xla_solvers():
    sys.path.insert(0, REPO)
    from chip_smoke import flagship_costs, flagship_reference, flagship_x0s
    from numpower_tpu.models import (
        condense, quadrotor12, solve_mpc_boxqp, solve_mpc_boxqp_admm,
    )

    x0 = flagship_x0s(16)
    U_star = flagship_reference(x0)
    A, B = quadrotor12(0.02)
    qp = condense(A, B, *(jnp.asarray(M, jnp.float32)
                          for M in flagship_costs()), 30)
    for solve in (solve_mpc_boxqp, solve_mpc_boxqp_admm):
        U = solve(qp, jnp.asarray(x0), -1.0, 1.0, iters=40).U
        assert float(np.max(np.abs(np.asarray(U, np.float64) - U_star))) < 1e-4
