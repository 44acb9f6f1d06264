"""Reductions and arg-extrema.

Reference machinery: /root/reference/src/ndarray.c:394-578 — a recursive
first-axis iterator that launches one full binary-op kernel **per slice** of
the reduced axis (O(axis_len) kernel launches + temp allocations; see
SURVEY.md §3.4). Design: every reduction is a single XLA reduce; axis
handling, keepdims, and NaN semantics follow
NumPy, matching the reference where it defines behavior:

- argmin/argmax propagate NaN (first NaN wins — calculation.c:15-27);
  jnp matches NumPy here.
- min/max propagate NaN (C fmaxf in the reference scan ignores NaN only in
  some paths; we standardize on NumPy propagate).
"""

from __future__ import annotations

import jax.numpy as jnp

from numpower_tpu.ops.creation import asarray


def sum(a, axis=None, keepdims: bool = False):  # noqa: A001
    """NDArray_Sum_Float (arithmetics.c:59-71) / reduce(add) (ndarray.c:524)."""
    return jnp.sum(asarray(a), axis=axis, keepdims=keepdims)


def prod(a, axis=None, keepdims: bool = False):
    """NDArray_Float_Prod (arithmetics.c:37-49)."""
    return jnp.prod(asarray(a), axis=axis, keepdims=keepdims)


def mean(a, axis=None, keepdims: bool = False):
    """NDArray_Mean_Float (arithmetics.c:80-102, cblas_sasum path)."""
    return jnp.mean(asarray(a), axis=axis, keepdims=keepdims)


def median(a, axis=None, keepdims: bool = False):
    """NDArray_Median_Float (arithmetics.c:111-158 — qsort copy + midpoint).
    XLA sorts on-device; generalized to axis (reference is flat-only)."""
    return jnp.median(asarray(a), axis=axis, keepdims=keepdims)


def min(a, axis=None, keepdims: bool = False):  # noqa: A001
    """NDArray_Min (ndarray.c:753-772; GPU warp-reduce cuda_math.cu:703-765)."""
    return jnp.min(asarray(a), axis=axis, keepdims=keepdims)


def max(a, axis=None, keepdims: bool = False):  # noqa: A001
    """NDArray_Max (ndarray.c:940-959) + NDArray_MaxAxis (ndarray.c:782-844,
    CPU-only in the reference; one fused reduce here)."""
    return jnp.max(asarray(a), axis=axis, keepdims=keepdims)


def argmin(a, axis=None, keepdims: bool = False):
    """NDArray_ArgMinMaxCommon (calculation.c:73-194): NaN propagates (index
    of first NaN returned), keepdims supported. jnp/NumPy semantics match."""
    a = asarray(a)
    if axis is None and keepdims:
        return jnp.argmin(a).reshape((1,) * a.ndim)
    return jnp.argmin(a, axis=axis, keepdims=keepdims if axis is not None else False)


def argmax(a, axis=None, keepdims: bool = False):
    """See argmin; calculation.c:9-59 scanners."""
    a = asarray(a)
    if axis is None and keepdims:
        return jnp.argmax(a).reshape((1,) * a.ndim)
    return jnp.argmax(a, axis=axis, keepdims=keepdims if axis is not None else False)


def cumsum(a, axis=None):
    return jnp.cumsum(asarray(a), axis=axis)


def cumprod(a, axis=None):
    return jnp.cumprod(asarray(a), axis=axis)


def sort(a, axis=-1):
    """NumPy-completing addition (the reference sorts only internally, e.g.
    qsort in Median — arithmetics.c:111-158); XLA sorts on-device."""
    return jnp.sort(asarray(a), axis=axis)


def argsort(a, axis=-1):
    return jnp.argsort(asarray(a), axis=axis)


def take(a, indices, axis=None):
    return jnp.take(asarray(a), jnp.asarray(indices), axis=axis)


def searchsorted(a, v, side="left"):
    return jnp.searchsorted(asarray(a), asarray(v), side=side)
