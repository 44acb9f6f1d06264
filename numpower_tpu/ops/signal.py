"""2-D convolution / correlation (signal flavor).

Reference: /root/reference/src/ndmath/signal.c — SciPy-derived `_convolve2d`
scalar engine (signal.c:113-211) with modes full/same/valid and boundaries
fill/wrap(circular)/symm(reflect), flip flag distinguishing convolve vs
correlate; CPU-only.

Design: boundary handling becomes a `jnp.pad` (constant / wrap /
symmetric) and the convolution itself is one `lax.conv_general_dilated`,
which XLA lowers to the backend's convolution — no scalar loops.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from numpower_tpu.ops.creation import asarray

_MODES = ("full", "same", "valid")
_BOUNDARIES = ("fill", "wrap", "symm")


def _pad_amounts(mode: str, k: int):
    """Top/bottom pad for one spatial dim, in *convolution* orientation."""
    if mode == "full":
        return k - 1, k - 1
    if mode == "same":
        return k // 2, (k - 1) // 2
    return 0, 0  # valid


def _conv2d_core(a: jax.Array, kernel: jax.Array, mode: str, boundary: str,
                 fill_value: float) -> jax.Array:
    kh, kw = kernel.shape
    pt, pb = _pad_amounts(mode, kh)
    pl_, pr = _pad_amounts(mode, kw)
    if boundary == "fill":
        a = jnp.pad(a, ((pt, pb), (pl_, pr)), constant_values=fill_value)
    elif boundary == "wrap":
        a = jnp.pad(a, ((pt, pb), (pl_, pr)), mode="wrap")
    elif boundary == "symm":
        a = jnp.pad(a, ((pt, pb), (pl_, pr)), mode="symmetric")
    else:
        raise ValueError(f"boundary must be one of {_BOUNDARIES}, got {boundary!r}")
    # Convolution = correlation with a spatially flipped kernel.
    k = jnp.flip(kernel, (0, 1))
    out = lax.conv_general_dilated(
        a[None, None],                      # NCHW
        k[None, None].astype(a.dtype),      # OIHW
        window_strides=(1, 1),
        padding="VALID",
        precision=lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32,
    )
    return out[0, 0].astype(a.dtype)


def convolve2d(a, kernel, mode: str = "full", boundary: str = "fill",
               fill_value: float = 0.0) -> jax.Array:
    """NDArray_Convolve2D (signal.c:113-211; binding numpower.c:4379-4438)."""
    a, kernel = asarray(a), asarray(kernel)
    if a.ndim != 2 or kernel.ndim != 2:
        raise ValueError("convolve2d requires 2-d input and kernel")
    if mode not in _MODES:
        raise ValueError(f"mode must be one of {_MODES}, got {mode!r}")
    if mode == "valid" and (kernel.shape[0] > a.shape[0] or kernel.shape[1] > a.shape[1]):
        # SciPy semantics: 'valid' requires the kernel to fit inside the input;
        # the reference swaps operands in this case (signal.c:217-303).
        a, kernel = kernel, a
    return _conv2d_core(a, kernel, mode, boundary, fill_value)


def correlate2d(a, kernel, mode: str = "full", boundary: str = "fill",
                fill_value: float = 0.0) -> jax.Array:
    """NDArray_Correlate2D (signal.c:217-303) — convolution without the
    kernel flip."""
    a, kernel = asarray(a), asarray(kernel)
    if a.ndim != 2 or kernel.ndim != 2:
        raise ValueError("correlate2d requires 2-d input and kernel")
    if mode not in _MODES:
        raise ValueError(f"mode must be one of {_MODES}, got {mode!r}")
    # correlate(a, k) == convolve(a, flip(k))
    return _conv2d_core(a, jnp.flip(kernel, (0, 1)), mode, boundary, fill_value)


def convolve1d(a, kernel, mode: str = "full") -> jax.Array:
    """1-d convolution (jnp.convolve), completing the family."""
    return jnp.convolve(asarray(a), asarray(kernel), mode=mode)
