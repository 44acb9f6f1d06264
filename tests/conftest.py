"""Test config: the CPU backend with 8 virtual devices (SURVEY.md §4).

JAX_PLATFORMS defaults to "cpu" here, so the suite runs on the 8-device
virtual CPU mesh the sharding tests need. Tests marked `gpu` need a CUDA GPU
and skip elsewhere; on the card run them with

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Skip `gpu`-marked tests unless JAX's default backend is a GPU
    (decided per test, never at import)."""
    if request.node.get_closest_marker("gpu") and jax.default_backend() != "gpu":
        pytest.skip("needs a CUDA GPU (JAX_PLATFORMS=cuda python -m pytest -m gpu)")


def pytest_sessionfinish(session, exitstatus):
    """Leak-mode gate (reference CI job `test_leak`, main.yml:75-138 —
    USE_ZEND_ALLOC=1 + NDARRAY_FREEBUFFER=1 makes the Zend debug allocator
    report per-request leaks). Analogue here: with NPTPU_LEAK_GATE=1 the
    whole suite runs with the buffer registry live, then after a forced GC
    every registered NDArray wrapper must have been unregistered."""
    if os.environ.get("NPTPU_LEAK_GATE") != "1" or exitstatus != 0:
        return
    import gc

    gc.collect()
    gc.collect()
    from numpower_tpu import runtime

    live = runtime.leak_check()
    stats = runtime.stats()
    print(f"\n[leak-gate] registry after GC: {stats}")
    if live != 0:
        session.exitstatus = 1
        raise pytest.UsageError(
            f"leak gate FAILED: {live} NDArray buffers still registered "
            f"after GC (stats: {stats})"
        )
    print("[leak-gate] OK: 0 live buffers")
