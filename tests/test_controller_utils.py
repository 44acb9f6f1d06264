"""MPCController, profiler, checkpoint tests."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from numpower_tpu.models import MPCController, double_integrator, quadrotor12
from numpower_tpu.utils.checkpoint import load_checkpoint, save_checkpoint
from numpower_tpu.utils.profiler import Timer, time_compiled


def test_controller_regulates():
    A, B = double_integrator(0.1)
    ctrl = MPCController(A, B, np.eye(2, dtype=np.float32),
                         np.eye(1, dtype=np.float32) * 0.1,
                         np.eye(2, dtype=np.float32) * 10.0,
                         horizon=20, u_lo=-1.0, u_hi=1.0, iters=40)
    n_scen = 8
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((n_scen, 2)).astype(np.float32))
    state = ctrl.init(n_scen)
    A_j, B_j = jnp.asarray(A), jnp.asarray(B)
    norm0 = float(jnp.max(jnp.linalg.norm(x, axis=1)))
    for _ in range(80):
        u0, state = ctrl.step(state, x)
        assert float(jnp.max(jnp.abs(u0))) <= 1.0 + 1e-6
        x = x @ A_j.T + u0 @ B_j.T
    # closed loop regulates all scenarios toward the origin
    assert float(jnp.max(jnp.linalg.norm(x, axis=1))) < 0.2 * norm0


def test_controller_warm_start_reduces_residual():
    A, B = quadrotor12(0.02)
    ctrl = MPCController(A, B, np.eye(12, dtype=np.float32),
                         np.eye(4, dtype=np.float32) * 0.1,
                         np.eye(12, dtype=np.float32) * 5.0,
                         horizon=10, u_lo=-1.0, u_hi=1.0, iters=10,
                         coarse_iters=0)
    rng = np.random.default_rng(1)
    x = jnp.asarray(0.3 * rng.standard_normal((4, 12)).astype(np.float32))
    state = ctrl.init(4)
    _, state, r_cold = ctrl.step_with_residual(state, x)
    # same x0 again with warm start: residual must shrink
    _, state, r_warm = ctrl.step_with_residual(state, x)
    assert float(r_warm) < float(r_cold)


def test_checkpoint_npz_roundtrip(tmp_path):
    tree = {"U": jnp.arange(12.0).reshape(3, 4), "tick": jnp.asarray(7)}
    p = str(tmp_path / "state.npz")
    save_checkpoint(p, tree)
    restored = load_checkpoint(p, like=tree)
    np.testing.assert_array_equal(np.asarray(restored["U"]), np.asarray(tree["U"]))
    assert int(restored["tick"]) == 7


def test_checkpoint_nested_tree_and_path_check(tmp_path):
    tree = {"a": jnp.ones((2, 2)), "b": {"c": jnp.zeros(3)}}
    p = str(tmp_path / "ckpt.npz")
    save_checkpoint(p, tree)
    restored = load_checkpoint(p, like=tree)
    np.testing.assert_array_equal(np.asarray(restored["b"]["c"]), np.zeros(3))
    with pytest.raises(ValueError, match="npz"):
        save_checkpoint(str(tmp_path / "ckpt"), tree)


def test_timer_phases():
    t = Timer()
    with t.phase("a"):
        pass
    with t.phase("a"):
        pass
    s = t.summary()
    assert s["a"]["count"] == 2
    assert "a:" in t.report()


def test_time_compiled_returns_positive():
    f = jax.jit(lambda x: x * 2 + 1)
    x = jnp.ones((64, 64))
    dt = time_compiled(f, x, reps=2, inner=(2, 12))
    assert dt > 0


def test_controller_no_retrace_steady_state():
    """SURVEY.md §4 / VERDICT r1 #3: the serving tick must not recompile in
    steady state. 10 ticks with changing data -> exactly ONE compiled
    executable behind the jitted step."""
    A, B = double_integrator(0.1)
    ctrl = MPCController(A, B, np.eye(2, dtype=np.float32),
                         np.eye(1, dtype=np.float32) * 0.1,
                         np.eye(2, dtype=np.float32) * 10.0,
                         horizon=12, u_lo=-1.0, u_hi=1.0, iters=10)
    rng = np.random.default_rng(2)
    state = ctrl.init(4)
    A_j, B_j = jnp.asarray(A), jnp.asarray(B)
    x = jnp.asarray(rng.standard_normal((4, 2)).astype(np.float32))
    u0, state = ctrl.step(state, x)  # warmup: the one allowed compile
    assert ctrl.compile_cache_size() == 1
    for _ in range(10):
        x = x @ A_j.T + u0 @ B_j.T + jnp.asarray(
            0.01 * rng.standard_normal((4, 2)).astype(np.float32))
        u0, state = ctrl.step(state, x)
    assert ctrl.compile_cache_size() == 1, "serving tick retraced"


def test_controller_state_donated():
    """The warm-start state buffer is donated to the tick step: the donated
    input must be invalidated after the call (proof the donation is live,
    not silently dropped)."""
    A, B = double_integrator(0.1)
    ctrl = MPCController(A, B, np.eye(2, dtype=np.float32),
                         np.eye(1, dtype=np.float32) * 0.1,
                         np.eye(2, dtype=np.float32) * 10.0,
                         horizon=12, u_lo=-1.0, u_hi=1.0, iters=10)
    state = ctrl.init(4)
    x = jnp.zeros((4, 2), jnp.float32)
    old_u_prev = state.U_prev
    _, new_state = ctrl.step(state, x)
    assert new_state.U_prev.shape == old_u_prev.shape
    assert old_u_prev.is_deleted(), "donated warm-start buffer still live"
