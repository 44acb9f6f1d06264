"""Type registry.

Reference: /root/reference/src/types.c — string descriptors "float32" /
"double64" with element-size lookup (get_type_size types.c:10, is_type
types.c:25). This build accepts those names (plus standard numpy names
and bf16) and maps them to jnp dtypes.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

# reference names (types.c) + numpy names + additions (bf16 etc.)
_DTYPE_MAP = {
    "float32": jnp.float32,
    "double64": jnp.float64,  # reference alias for double (types.c:13)
    "float64": jnp.float64,
    "bfloat16": jnp.bfloat16,
    "float16": jnp.float16,
    "int32": jnp.int32,
    "int64": jnp.int64,
    "int16": jnp.int16,
    "int8": jnp.int8,
    "uint8": jnp.uint8,
    "bool": jnp.bool_,
}


def resolve_dtype(dtype):
    """Accept reference-style strings, numpy dtypes, or jnp dtypes."""
    if dtype is None:
        return None
    if isinstance(dtype, str):
        if dtype not in _DTYPE_MAP:
            raise ValueError(
                f"unknown dtype {dtype!r}; known: {sorted(_DTYPE_MAP)}"
            )
        return _DTYPE_MAP[dtype]
    return dtype


def get_type_size(dtype) -> int:
    """Element size in bytes (reference get_type_size, types.c:10)."""
    return np.dtype(resolve_dtype(dtype)).itemsize


def is_type(dtype, name: str) -> bool:
    """Reference is_type (types.c:25)."""
    return np.dtype(resolve_dtype(dtype)) == np.dtype(resolve_dtype(name))
