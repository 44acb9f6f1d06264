"""Image <-> tensor bridge.

Reference: the GD bridge (/root/reference/src/ndarray.c:90-283 —
NDArray_FromGD / NDArray_ToGD with AVX2-packed RGB(A) writes; bindings
numpower.c:481-508,2129-2149) converting PHP GdImage objects to 3xHxW (CHW)
or HxWx3 (HWC) fp32 tensors, with optional [0,1] normalization.

Design: GD does not exist here; the bridge accepts/produces the
Python ecosystem's interchange types — uint8 numpy arrays (and PIL images
when available, gated) — with identical CHW/HWC/fp32/normalize semantics.
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from numpower_tpu.ops.creation import asarray
from numpower_tpu.utils.config import default_dtype


def from_image(img: Any, channel_first: bool = True, normalize: bool = False) -> jax.Array:
    """NDArray_FromGD (ndarray.c:90-172): image → fp32 tensor.

    Accepts HxW (gray), HxWx3 / HxWx4 uint8 numpy arrays, or a PIL image.
    channel_first=True yields CHW (the reference default), else HWC.
    normalize=True scales to [0, 1] (reference divides by 255).
    """
    if hasattr(img, "convert") and hasattr(img, "size"):  # PIL duck-typing
        img = np.asarray(img)
    arr = np.asarray(img)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    x = jnp.asarray(arr, dtype=default_dtype())
    if normalize:
        x = x / 255.0
    if channel_first:
        x = jnp.transpose(x, (2, 0, 1))
    return x


def to_image(a, channel_first: bool = True, denormalize: bool = False) -> np.ndarray:
    """NDArray_ToGD (ndarray.c:174-283): fp32 tensor → uint8 HxWxC image
    array (the AVX2 packed-pixel write becomes a fused clip+cast)."""
    x = asarray(a)
    if x.ndim == 2:
        x = x[None] if channel_first else x[..., None]
    if channel_first:
        x = jnp.transpose(x, (1, 2, 0))
    if denormalize:
        x = x * 255.0
    x = jnp.clip(jnp.round(x), 0, 255).astype(jnp.uint8)
    out = np.asarray(jax.device_get(x))
    return out[..., 0] if out.shape[-1] == 1 else out
