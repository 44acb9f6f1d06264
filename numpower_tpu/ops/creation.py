"""Array creation / initializers.

Re-design of the reference initializer layer
(/root/reference/src/initializers.c): where the reference recursively probes
nested PHP arrays and memcpy's into a malloc'd fp32 buffer
(initializers.c:30-233), we coerce any nested sequence / numpy array / jax
array to an immutable device `jax.Array` in one `jnp.asarray` call and let XLA
own layout. All constructors default to float32 to match the reference's
contiguous-fp32 numerics (initializers.c:224).
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Union

import jax
import jax.numpy as jnp
import numpy as np

from numpower_tpu.ops.dtypes import resolve_dtype
from numpower_tpu.utils.config import default_dtype

Shape = Union[int, Sequence[int]]


def _normalize_shape(shape: Shape) -> tuple:
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(s) for s in shape)


def asarray(obj: Any, dtype=None) -> jax.Array:
    """Coerce scalars / nested sequences / numpy / jax arrays to a jax.Array.

    Equivalent of ZVAL_TO_NDARRAY (/root/reference/numpower.c:89-117) +
    Create_NDArray_FromZendArray (initializers.c:206-233), minus the copy:
    jnp.asarray is zero-copy for committed device arrays.
    """
    if dtype is None:
        # Preserve the dtype of real array inputs (floating AND integer —
        # index arrays from argsort/argmin must stay integral); only Python
        # natives (lists, ints, floats) coerce to the fp32 default like the
        # reference.
        if isinstance(obj, (jax.Array, np.ndarray)):
            return jnp.asarray(obj)
        return jnp.asarray(obj, dtype=default_dtype())
    return jnp.asarray(obj, dtype=resolve_dtype(dtype))


def array(obj: Any, dtype=None) -> jax.Array:
    """nd::array — reference binding /root/reference/numpower.c:4756."""
    return asarray(obj, dtype=dtype)


def zeros(shape: Shape, dtype=None) -> jax.Array:
    """nd::zeros — reference NDArray_Zeros (initializers.c:420)."""
    return jnp.zeros(_normalize_shape(shape), resolve_dtype(dtype) or default_dtype())


def ones(shape: Shape, dtype=None) -> jax.Array:
    """nd::ones — reference NDArray_Ones (initializers.c:447)."""
    return jnp.ones(_normalize_shape(shape), resolve_dtype(dtype) or default_dtype())


def full(shape: Shape, fill_value, dtype=None) -> jax.Array:
    """nd::full — reference binding numpower.c full()."""
    return jnp.full(_normalize_shape(shape), fill_value, resolve_dtype(dtype) or default_dtype())


def empty(shape: Shape, dtype=None) -> jax.Array:
    """Reference NDArray_Empty (initializers.c:380). XLA has no uninitialized
    alloc; zeros compiles to a fused broadcast and is equally cheap."""
    return jnp.zeros(_normalize_shape(shape), resolve_dtype(dtype) or default_dtype())


def empty_like(a, dtype=None) -> jax.Array:
    """Reference NDArray_EmptyLike (initializers.c:406)."""
    a = asarray(a)
    return jnp.zeros(a.shape, dtype or a.dtype)


def zeros_like(a, dtype=None) -> jax.Array:
    a = asarray(a)
    return jnp.zeros(a.shape, dtype or a.dtype)


def ones_like(a, dtype=None) -> jax.Array:
    a = asarray(a)
    return jnp.ones(a.shape, dtype or a.dtype)


def identity(n: int, dtype=None) -> jax.Array:
    """nd::identity — reference NDArray_Identity (initializers.c:466)."""
    return jnp.eye(int(n), dtype=resolve_dtype(dtype) or default_dtype())


def eye(n: int, m: Optional[int] = None, k: int = 0, dtype=None) -> jax.Array:
    return jnp.eye(int(n), m if m is None else int(m), k=k, dtype=resolve_dtype(dtype) or default_dtype())


def arange(start, stop=None, step=1, dtype=None) -> jax.Array:
    """nd::arange — reference NDArray_Arange (initializers.c:634).

    Reference signature is arange(stop, start, step); we expose the NumPy
    order (start, stop, step) and the NDArray class shim adapts.
    """
    if stop is None:
        start, stop = 0, start
    return jnp.arange(start, stop, step, dtype=resolve_dtype(dtype) or default_dtype())


def linspace(start, stop, num: int = 50, endpoint: bool = True, dtype=None) -> jax.Array:
    return jnp.linspace(start, stop, num, endpoint=endpoint, dtype=resolve_dtype(dtype) or default_dtype())


def diag(v, k: int = 0) -> jax.Array:
    """nd::diag — build diagonal matrix from 1-d / extract diagonal from 2-d
    (reference binding numpower.c diag; NDArray_Diagonal indexing.c:21-48)."""
    return jnp.diag(asarray(v), k=k)


def diagonal(a, offset: int = 0, axis1: int = 0, axis2: int = 1) -> jax.Array:
    """Reference NDArray_Diagonal (/root/reference/src/indexing.c:21-48),
    generalized to batched axes like NumPy."""
    return jnp.diagonal(asarray(a), offset=offset, axis1=axis1, axis2=axis2)


def fill(a, value) -> jax.Array:
    """Reference NDArray_Fill: in-place fill (initializers.c). jax arrays are
    immutable; returns a new filled array of the same shape/dtype."""
    a = asarray(a)
    return jnp.full(a.shape, value, a.dtype)


def copy(a) -> jax.Array:
    """Reference NDArray_Copy (initializers.c:742-790). Immutable arrays make
    defensive copies free; jnp.copy keeps API parity."""
    return jnp.copy(asarray(a))


def tri(n: int, m: Optional[int] = None, k: int = 0, dtype=None) -> jax.Array:
    return jnp.tri(int(n), m if m is None else int(m), k=k, dtype=resolve_dtype(dtype) or default_dtype())
