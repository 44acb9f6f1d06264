"""Comparison / logic ops.

Reference: /root/reference/src/logic.c — AVX2 `_mm256_cmp_ps`+blend loops and
CUDA compare kernels producing **fp32 0/1 mask arrays** (logic.c:68-164).
We keep that convention at this layer (masks are float32 0/1, not bool) so
parity tests and downstream arithmetic-on-masks behave identically; XLA fuses
the compare+select into a single elementwise op anyway. Full NumPy broadcasting —
superset of the reference's scalar-promote+partial-broadcast preamble.
"""

from __future__ import annotations

import jax.numpy as jnp

from numpower_tpu.ops.creation import asarray
from numpower_tpu.utils.config import default_dtype


def _mask(x):
    return x.astype(default_dtype())


def equal(a, b):
    """NDArray_Equal (logic.c pattern x6)."""
    return _mask(jnp.equal(asarray(a), asarray(b)))


def not_equal(a, b):
    return _mask(jnp.not_equal(asarray(a), asarray(b)))


def greater(a, b):
    return _mask(jnp.greater(asarray(a), asarray(b)))


def greater_equal(a, b):
    return _mask(jnp.greater_equal(asarray(a), asarray(b)))


def less(a, b):
    return _mask(jnp.less(asarray(a), asarray(b)))


def less_equal(a, b):
    return _mask(jnp.less_equal(asarray(a), asarray(b)))


def all(a, axis=None):  # noqa: A001
    """NDArray_All (logic.c:26-58) — AVX2 nonzero test; with axis support."""
    result = jnp.all(asarray(a) != 0, axis=axis)
    return _mask(result)


def any(a, axis=None):  # noqa: A001
    """NumPy-completing counterpart of all() (absent in reference)."""
    return _mask(jnp.any(asarray(a) != 0, axis=axis))


def allclose(a, b, rtol: float = 1e-5, atol: float = 1e-8) -> bool:
    """NDArray_AllClose (logic.c): |a-b| <= atol + rtol*|b|."""
    return bool(jnp.allclose(asarray(a), asarray(b), rtol=rtol, atol=atol))


def array_equal(a, b) -> bool:
    """NDArray_ArrayEqual — backs the reference's `==` object compare
    (numpower.c:175-186)."""
    return bool(jnp.array_equal(asarray(a), asarray(b)))


def isnan(a):
    return _mask(jnp.isnan(asarray(a)))


def isinf(a):
    return _mask(jnp.isinf(asarray(a)))


def isfinite(a):
    return _mask(jnp.isfinite(asarray(a)))


def where(cond, x, y):
    """Select — the fused XLA equivalent of the reference's compare+blend."""
    return jnp.where(asarray(cond) != 0, asarray(x), asarray(y))
