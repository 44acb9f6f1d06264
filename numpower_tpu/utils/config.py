"""Runtime configuration for numpower_tpu.

The reference (NumPower) configures itself with compile-time autoconf macros
(HAVE_AVX2/HAVE_CUBLAS/... — /root/reference/config.m4:13-117) and a handful of
env vars (NDARRAY_BUFFERLEAK / NDARRAY_VCHECK — /root/reference/numpower.c:5268-5277).
This build replaces that with one runtime dataclass + env overrides:
precision policy, mesh shape, and solver tolerances are runtime decisions under
XLA, not build-time ones.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import jax.numpy as jnp


@dataclasses.dataclass
class Config:
    # Default element type. The reference computes everything in contiguous
    # float32 (/root/reference/src/initializers.c:224); we keep fp32 as the
    # numerics default and use bf16 only where a kernel explicitly opts in.
    default_dtype: jnp.dtype = jnp.float32

    # Matmul precision ("highest" => full fp32 products, no TF32/bf16).
    matmul_precision: str = "highest"

    # Mesh axis names used throughout parallel/: data = MPC scenarios,
    # model = QP/condensed-matrix blocks.
    data_axis: str = "data"
    model_axis: str = "model"

    # Default mesh shape (data, model). None => all local devices on data.
    mesh_shape: Optional[Tuple[int, int]] = None

    # Solver tolerances.
    solver_atol: float = 1e-6
    qp_step_tol: float = 1e-7

    # Debug switches (env-overridable, mirroring NDARRAY_BUFFER_DEBUG etc.).
    buffer_debug: bool = bool(os.environ.get("NPTPU_BUFFER_DEBUG"))
    check_leaks: bool = bool(os.environ.get("NPTPU_VCHECK"))


config = Config()


def default_dtype() -> jnp.dtype:
    return config.default_dtype


# The checkout this package lives in (the compile cache's default home).
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    When JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing
    else is set here. Otherwise the cache goes to the fixed path
    <repo>/.jax_cache/ (listed in .gitignore), so that later processes in
    the same checkout find what earlier ones compiled. Called by the
    scripts (chip_smoke.py, bench.py, examples), never on import."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if path:
        return path
    path = os.path.join(REPO_ROOT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
