"""Which accelerator the program is on, and whether a call may use a kernel.

Every solver that has a hand-written kernel resolves its `method=` here, so
the rules live in one place:

- `method="auto"` picks the compiled kernel only on a platform that can
  compile it (a CUDA GPU) and only inside the kernel's size envelope;
  everywhere else it picks the XLA path. It never picks interpret mode.
- `method="pallas"` asks for the kernel. It runs in interpret mode only when
  the caller sets `interpret` (the CPU tests do); on a platform that
  cannot compile the kernel, or outside its envelope, it raises.
- `method="xla"` always takes the XLA path.
"""

from __future__ import annotations

from typing import Optional

import jax

# Platforms the Pallas kernels (Triton route) compile for.
KERNEL_PLATFORMS = ("gpu",)


class KernelUnavailableError(RuntimeError):
    """An explicit kernel request that this platform cannot compile."""


def platform(devices=None) -> str:
    """JAX platform name ("gpu", "cpu", ...) of `devices` (a sequence or a
    mesh's device array), or of the default backend when None."""
    if devices is None:
        return jax.default_backend()
    first = devices.flat[0] if hasattr(devices, "flat") else devices[0]
    return first.platform


def route(method: str, *, fits: bool, interpret: bool = False,
          on: Optional[str] = None) -> str:
    """Resolve `method` to "xla", "kernel" (compiled for the card) or
    "interpret". `fits` says whether the problem is inside the kernel's
    envelope; `on` is the platform (default backend when None)."""
    if method == "xla":
        return "xla"
    plat = on or platform()
    if method == "auto":
        return "kernel" if (plat in KERNEL_PLATFORMS and fits) else "xla"
    if method != "pallas":
        raise ValueError(f"unknown method {method!r} (auto|pallas|xla)")
    if not fits:
        raise ValueError("problem is outside the kernel's size envelope")
    if interpret:
        return "interpret"
    if plat not in KERNEL_PLATFORMS:
        raise KernelUnavailableError(
            f"method='pallas' needs a GPU, not {plat!r}; set the interpret "
            "flag to run the kernel in the Pallas interpreter")
    return "kernel"
