"""numpower_tpu — batched MPC and estimation engine with a NumPy-like array layer.

A from-scratch JAX framework with the full op-surface capabilities of
the NumPower reference (/root/reference — a PHP C extension with AVX2/CUDA
backends), re-designed for JAX/XLA/Pallas:

- `numpower_tpu.ops`      — functional op layer (fp32 default, full NumPy
                            broadcasting, XLA-fused; SURVEY.md §2.2-2.3 parity)
- `numpower_tpu.NDArray`  — object API mirroring the reference's PHP class
                            (~140 methods, operators, iteration)
- `numpower_tpu.models`   — plants + MPC/trajectory-optimization solvers
                            (LQR/Riccati, iLQR, box-QP, tube-MPC)
- `numpower_tpu.kernels`  — Pallas (Triton) GPU kernels for hot paths
- `numpower_tpu.parallel` — mesh/sharding/multi-host scaling
- `numpower_tpu.runtime`  — native C++ runtime (registry, IO, allocator)
"""

__version__ = "0.1.0"

import jax as _jax

# The BASELINE parity bound (<=1e-4 vs the fp32 CPU reference) requires fp32
# matmuls; an accelerator's default precision may run them in TF32 or bf16.
# Hot kernels that want bf16 opt in explicitly per-call.
_jax.config.update("jax_default_matmul_precision", "highest")

from numpower_tpu import ops  # noqa: F401
from numpower_tpu.ndarray import ArithmeticOperand, NDArray, nd  # noqa: F401
