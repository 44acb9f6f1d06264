"""Persistence: save / load / serialize.

Reference: raw-struct fwrite/fread NDArray_Save/Load
(/root/reference/src/ndarray.c:1356-1404 — Load has latent bugs: it freads
into unallocated `iterator`/`data` pointers) and PHP `__serialize` via nested
arrays (numpower.c:4959-4991; GPU arrays must be moved to CPU first).

Design (SURVEY.md §5): dtype/shape-tagged **.npy-compatible**
files — portable, versioned, self-describing — with no device restriction
(device→host transfer is implicit and explicit device placement is a
sharding, not a file property). When the C++ runtime is available its mmap'd
reader/writer is used for large arrays.
"""

from __future__ import annotations

import io as _io
import os
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from numpower_tpu.ops.creation import asarray


def save(path: str, a) -> None:
    """nd::save — .npy on disk (reference ndarray.c:1356-1372)."""
    arr = np.asarray(jax.device_get(asarray(a)))
    try:
        from numpower_tpu.runtime import npy_save_fast

        if npy_save_fast(path, arr):
            return
    except Exception:
        pass
    np.save(path, arr, allow_pickle=False)


# Below this size np.load's overhead is noise; above it the native mmap
# reader (one header parse + one bulk memcpy out of a read-only mapping)
# avoids np.load's buffered-read path.
_FAST_READ_MIN_BYTES = 1 << 20


def load(path: str) -> jax.Array:
    """nd::load — .npy from disk (reference ndarray.c:1378-1404, minus its
    unallocated-pointer bugs). Large files route through the native mmap'd
    reader (runtime.npy_read_fast) when the C++ runtime is available."""
    if not os.path.exists(path) and os.path.exists(path + ".npy"):
        path = path + ".npy"
    if os.path.getsize(path) >= _FAST_READ_MIN_BYTES:
        try:
            from numpower_tpu.runtime import npy_read_fast

            arr = npy_read_fast(path)
            if arr is not None:
                return jnp.asarray(arr)
        except Exception:
            pass
    arr = np.load(path, allow_pickle=False)
    return jnp.asarray(arr)


def serialize(a) -> bytes:
    """PHP __serialize analogue (numpower.c:4959-4991): self-describing bytes
    (npy format in-memory)."""
    buf = _io.BytesIO()
    np.save(buf, np.asarray(jax.device_get(asarray(a))), allow_pickle=False)
    return buf.getvalue()


def deserialize(data: bytes) -> jax.Array:
    """PHP __unserialize analogue."""
    return jnp.asarray(np.load(_io.BytesIO(data), allow_pickle=False))


def to_list(a) -> Any:
    """nd::toArray (numpower.c) — nested Python lists (the PHP-array return)."""
    return np.asarray(jax.device_get(asarray(a))).tolist()
