"""NDArray — object API mirroring the reference PHP class.

Reference: class `NDArray` registered in /root/reference/numpower.c:5211-5244
with ~140 methods (method table numpower.c:5034-5209), operator overloads
(ndarray_do_operation, numpower.c:193-282), ArrayAccess/Iterator/Countable
protocols (numpower.c:4899-4957), and a uuid-keyed global buffer registry
(src/buffer.c).

Design: a thin immutable wrapper over one `jax.Array`. No strides,
no views-with-refcounts, no device tag — XLA owns layout, jax.Array owns
sharding/placement. What the reference models as mutation (offsetSet, fill)
becomes functional `.at[].set` updates that rebind the wrapper's value.
Object lifetime is tracked by the native runtime registry
(numpower_tpu.runtime) for the leak-accounting the reference gets from
buffer.c counters.

0-d results are returned as plain Python floats, exactly like the reference
(numpower.c:142-149).
"""

from __future__ import annotations

from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np

from numpower_tpu import ops
from numpower_tpu.utils import debug as _debug


def _unwrap(x):
    return x._value if isinstance(x, NDArray) else x


def _wrap(x):
    """Wrap op results; 0-d arrays become plain floats (numpower.c:142-149)."""
    if isinstance(x, jax.Array) and x.ndim == 0:
        return float(x)
    if isinstance(x, jax.Array):
        return NDArray(x)
    return x


def _accel_device() -> Optional[jax.Device]:
    """The accelerator selected by NDArray.setDevice (reference
    numpower.c:615-635 — cudaSetDevice is a global device switch honored by
    subsequent placements). Index is modulo the accelerator count so a
    single-chip host accepts any index, like CUDA's device-count clamp
    raises; we prefer graceful wraparound for portability."""
    accels = [d for d in jax.devices() if d.platform != "cpu"]
    if not accels:
        return None
    return accels[NDArray._default_device_index % len(accels)]


class NDArray:
    """User-facing n-dimensional array (fp32 default)."""

    __slots__ = ("_value", "_uuid", "_iter_pos", "__weakref__")

    _default_device_index: int = 0

    def __init__(self, data: Any, dtype=None):
        self._value = ops.asarray(_unwrap(data), dtype=dtype)
        self._iter_pos = 0
        from numpower_tpu import runtime

        self._uuid = runtime.register(self._value.nbytes)

    def __del__(self):
        try:
            from numpower_tpu import runtime

            runtime.unregister(self._uuid, self._value.nbytes)
        except Exception:
            pass

    # -- raw access ---------------------------------------------------------
    @property
    def value(self) -> jax.Array:
        """The underlying jax.Array (escape hatch for jit/vmap composition)."""
        return self._value

    def __jax_array__(self) -> jax.Array:
        return self._value

    # -- introspection ------------------------------------------------------
    @property
    def shape(self):
        return tuple(self._value.shape)

    @property
    def ndim(self) -> int:
        return self._value.ndim

    @property
    def size(self) -> int:
        return int(self._value.size)

    @property
    def dtype(self):
        return self._value.dtype

    def count(self) -> int:
        """Countable::count — length of first axis (numpower.c)."""
        return 0 if self.ndim == 0 else int(self.shape[0])

    def __len__(self) -> int:
        return self.count()

    def dump(self) -> str:
        return _debug.dump(self._value)

    @staticmethod
    def dumpDevices() -> str:  # noqa: N802 - reference name
        return _debug.dump_devices()

    def __repr__(self) -> str:
        return f"NDArray({_debug.array_repr(self._value)})"

    __str__ = __repr__

    def toArray(self):  # noqa: N802 - reference name
        return ops.to_list(self._value)

    def toImage(self, channel_first: bool = True, denormalize: bool = False):  # noqa: N802
        return ops.to_image(self._value, channel_first, denormalize)

    # -- device model (compat shims over jax placement; SURVEY.md §5) -------
    def gpu(self) -> "NDArray":
        """Reference $x->gpu() (numpower.c:512 → ndarray.c:1038). Places the
        array on the accelerator (GPU). No-op if none present."""
        dev = _accel_device()
        return NDArray(jax.device_put(self._value, dev)) if dev else self.copy()

    def cpu(self) -> "NDArray":
        """Reference $x->cpu() (numpower.c:532 → ndarray.c:1076)."""
        cpus = [d for d in jax.devices("cpu")] or None
        if cpus is None:
            return self.copy()
        return NDArray(jax.device_put(self._value, cpus[0]))

    def isGPU(self) -> bool:  # noqa: N802 - reference name
        """True when resident on an accelerator (reference device tag,
        ndarray.h:73)."""
        try:
            return any(d.platform != "cpu" for d in self._value.devices())
        except Exception:
            return False

    @staticmethod
    def setDevice(index: int) -> None:  # noqa: N802 - reference name
        """Reference NDArray::setDevice → cudaSetDevice (numpower.c:615-635).
        Selects which accelerator subsequent gpu() placements use."""
        NDArray._default_device_index = int(index)

    # -- constructors (static, mirroring nd:: surface) ----------------------
    @staticmethod
    def _check_shape(shape, method: str):
        """Reference-style shape validation with the reference's messages
        (tests/random/001-ndarray-standard_normal.phpt asserts these
        verbatim: "must be of type array", "Shape elements must be
        integers.", "Expected a non-empty array."). The functional ops layer
        stays permissive (jax-idiomatic); this strictness lives only on the
        NDArray compat surface."""
        if isinstance(shape, (str, bytes)) or not hasattr(shape, "__iter__"):
            raise TypeError(
                f"NDArray::{method}(): Argument #1 ($shape) must be of type "
                f"array, {type(shape).__name__} given"
            )
        shape = tuple(shape)
        if len(shape) == 0:
            raise ValueError("Invalid parameter: Expected a non-empty array.")
        for s in shape:
            if isinstance(s, bool) or not isinstance(s, (int, np.integer)):
                raise ValueError(
                    "Invalid parameter: Shape elements must be integers.")
            if s < 0:
                raise ValueError(
                    "Invalid parameter: Shape elements must be non-negative.")
        return shape

    @staticmethod
    def array(obj, dtype=None) -> "NDArray":
        return NDArray(obj, dtype=dtype)

    @staticmethod
    def zeros(shape) -> "NDArray":
        return NDArray(ops.zeros(NDArray._check_shape(shape, "zeros")))

    @staticmethod
    def ones(shape) -> "NDArray":
        return NDArray(ops.ones(NDArray._check_shape(shape, "ones")))

    @staticmethod
    def full(shape, value) -> "NDArray":
        return NDArray(ops.full(NDArray._check_shape(shape, "full"), value))

    @staticmethod
    def identity(n: int) -> "NDArray":
        return NDArray(ops.identity(n))

    @staticmethod
    def arange(stop, start=0, step=1) -> "NDArray":
        """Reference argument order: arange(stop, start, step)."""
        return NDArray(ops.arange(start, stop, step))

    @staticmethod
    def diag(v) -> "NDArray":
        return NDArray(ops.diag(_unwrap(v)))

    @staticmethod
    def uniform(shape, low: float = 0.0, high: float = 1.0) -> "NDArray":
        return NDArray(ops.random.uniform(
            NDArray._check_shape(shape, "uniform"), low, high))

    @staticmethod
    def normal(shape, loc: float = 0.0, scale: float = 1.0) -> "NDArray":
        return NDArray(ops.random.normal(
            NDArray._check_shape(shape, "normal"), loc, scale))

    @staticmethod
    def standard_normal(shape) -> "NDArray":
        return NDArray(ops.random.standard_normal(
            NDArray._check_shape(shape, "standard_normal")))

    @staticmethod
    def poisson(shape, lam: float = 1.0) -> "NDArray":
        return NDArray(ops.random.poisson(
            NDArray._check_shape(shape, "poisson"), lam))

    @staticmethod
    def random_binomial(shape, n: int, p: float) -> "NDArray":
        return NDArray(ops.random.random_binomial(
            NDArray._check_shape(shape, "random_binomial"), n, p))

    @staticmethod
    def load(path: str) -> "NDArray":
        return NDArray(ops.load(path))

    def save(self, path: str) -> None:
        ops.save(path, self._value)

    @staticmethod
    def fromImage(img, channel_first: bool = True, normalize: bool = False) -> "NDArray":  # noqa: N802
        return NDArray(ops.from_image(img, channel_first, normalize))

    # -- elementwise / arithmetic -------------------------------------------
    def copy(self) -> "NDArray":
        return NDArray(ops.copy(self._value))

    def astype(self, dtype) -> "NDArray":
        """Dtype conversion (accepts reference-style strings, e.g.
        "float32"/"double64" — ops/dtypes.py)."""
        from numpower_tpu.ops.dtypes import resolve_dtype

        return NDArray(self._value, dtype=resolve_dtype(dtype))

    def item(self) -> float:
        """Scalar extraction for 0-d/1-element arrays."""
        return float(self._value.reshape(()))

    def sort(self, axis=-1) -> "NDArray":
        return NDArray(ops.sort(self._value, axis))

    def argsort(self, axis=-1) -> "NDArray":
        return NDArray(ops.argsort(self._value, axis))

    def fill(self, value) -> "NDArray":
        """Reference mutates in place; immutably rebinds here."""
        self._value = ops.fill(self._value, value)
        return self

    # operators (ndarray_do_operation, numpower.c:193-282)
    def __add__(self, other):
        return _wrap(ops.add(self._value, _unwrap(other)))

    __radd__ = __add__

    def __sub__(self, other):
        return _wrap(ops.subtract(self._value, _unwrap(other)))

    def __rsub__(self, other):
        return _wrap(ops.subtract(_unwrap(other), self._value))

    def __mul__(self, other):
        return _wrap(ops.multiply(self._value, _unwrap(other)))

    __rmul__ = __mul__

    def __truediv__(self, other):
        return _wrap(ops.divide(self._value, _unwrap(other)))

    def __rtruediv__(self, other):
        return _wrap(ops.divide(_unwrap(other), self._value))

    def __pow__(self, other):
        return _wrap(ops.pow(self._value, _unwrap(other)))

    def __rpow__(self, other):
        return _wrap(ops.pow(_unwrap(other), self._value))

    def __mod__(self, other):
        return _wrap(ops.mod(self._value, _unwrap(other)))

    def __rmod__(self, other):
        return _wrap(ops.mod(_unwrap(other), self._value))

    def __neg__(self):
        return _wrap(ops.negative(self._value))

    def __pos__(self):
        return _wrap(ops.positive(self._value))

    def __abs__(self):
        return _wrap(ops.abs(self._value))

    def __matmul__(self, other):
        return _wrap(ops.matmul(self._value, _unwrap(other)))

    def __eq__(self, other):  # object compare = ArrayEqual (numpower.c:175-186)
        if isinstance(other, (NDArray, jax.Array, np.ndarray, list, int, float)):
            return ops.array_equal(self._value, _unwrap(other))
        return NotImplemented

    def __ne__(self, other):
        res = self.__eq__(other)
        return NotImplemented if res is NotImplemented else not res

    def __hash__(self):
        return id(self)

    def __array__(self, dtype=None):
        host = np.asarray(jax.device_get(self._value))
        return host.astype(dtype) if dtype is not None else host

    def __float__(self):
        return float(self._value)

    def __int__(self):
        return int(float(self._value))

    # -- ArrayAccess / Iterator protocols -----------------------------------
    def _check_bounds(self, idx) -> None:
        """jax clamps out-of-bounds indices inside jit; at this eager object
        API we surface the reference's error behavior (numpower.c offsetGet
        throws on bad offsets) instead of silently clamping."""
        specs = idx if isinstance(idx, tuple) else (idx,)
        for axis, spec in enumerate(specs):
            if isinstance(spec, int) and not (-self.shape[axis] <= spec < self.shape[axis]):
                raise IndexError(
                    f"index {spec} is out of bounds for axis {axis} with size {self.shape[axis]}"
                )

    def __getitem__(self, idx):
        """offsetGet (numpower.c:4899) — returns sub-array view."""
        self._check_bounds(idx)
        return _wrap(self._value[idx])

    def __setitem__(self, idx, value):
        """offsetSet (numpower.c:4920) — functional .at[].set rebind."""
        self._check_bounds(idx)
        self._value = self._value.at[idx].set(ops.asarray(_unwrap(value)))

    def __iter__(self):
        """Pythonic iteration over the first axis (sub-arrays)."""
        for i in range(self.count()):
            yield _wrap(self._value[i])

    # Explicit PHP Iterator protocol (reference iterators.c:39-76 /
    # numpower.c method table: rewind/valid/current/next/key) for API parity.
    def rewind(self) -> None:
        self._iter_pos = 0

    def valid(self) -> bool:
        return 0 <= self._iter_pos < self.count()

    def key(self) -> int:
        return self._iter_pos

    def current(self):
        return _wrap(self._value[self._iter_pos])

    def next(self) -> None:  # noqa: A003 - PHP protocol name
        self._iter_pos += 1

    def __contains__(self, item):
        return bool(jnp.any(self._value == ops.asarray(_unwrap(item))))

    # -- methods: manipulation ----------------------------------------------
    def reshape(self, shape) -> "NDArray":
        return NDArray(ops.reshape(self._value, shape))

    def transpose(self, axes=None) -> "NDArray":
        return NDArray(ops.transpose(self._value, axes))

    @property
    def T(self) -> "NDArray":
        return self.transpose()

    def flatten(self) -> "NDArray":
        return NDArray(ops.flatten(self._value))

    def flip(self, axis=None) -> "NDArray":
        return NDArray(ops.flip(self._value, axis))

    def expand_dims(self, axis) -> "NDArray":
        return NDArray(ops.expand_dims(self._value, axis))

    def squeeze(self, axis=None) -> "NDArray":
        return NDArray(ops.squeeze(self._value, axis))

    def swapaxes(self, a1: int, a2: int) -> "NDArray":
        return NDArray(ops.swapaxes(self._value, a1, a2))

    def rollaxis(self, axis: int, start: int = 0) -> "NDArray":
        return NDArray(ops.rollaxis(self._value, axis, start))

    def moveaxis(self, source, destination) -> "NDArray":
        return NDArray(ops.moveaxis(self._value, source, destination))

    def slice(self, *specs) -> "NDArray":
        return _wrap(ops.slice(self._value, *specs))

    def diagonal(self, offset: int = 0) -> "NDArray":
        return _wrap(ops.diagonal(self._value, offset))

    def append(self, values, axis=None) -> "NDArray":
        return NDArray(ops.append(self._value, _unwrap(values), axis))

    @staticmethod
    def concatenate(arrays, axis=0) -> "NDArray":
        return NDArray(ops.concatenate([_unwrap(a) for a in arrays], axis))

    @staticmethod
    def vstack(arrays) -> "NDArray":
        return NDArray(ops.vstack([_unwrap(a) for a in arrays]))

    @staticmethod
    def hstack(arrays) -> "NDArray":
        return NDArray(ops.hstack([_unwrap(a) for a in arrays]))

    @staticmethod
    def dstack(arrays) -> "NDArray":
        return NDArray(ops.dstack([_unwrap(a) for a in arrays]))

    @staticmethod
    def column_stack(arrays) -> "NDArray":
        return NDArray(ops.column_stack([_unwrap(a) for a in arrays]))

    @staticmethod
    def atleast_1d(a) -> "NDArray":
        return NDArray(ops.atleast_1d(_unwrap(a)))

    @staticmethod
    def atleast_2d(a) -> "NDArray":
        return NDArray(ops.atleast_2d(_unwrap(a)))

    @staticmethod
    def atleast_3d(a) -> "NDArray":
        return NDArray(ops.atleast_3d(_unwrap(a)))

    # -- methods: math -------------------------------------------------------
    def abs(self) -> "NDArray":
        return _wrap(ops.abs(self._value))

    def sqrt(self) -> "NDArray":
        return _wrap(ops.sqrt(self._value))

    def rsqrt(self) -> "NDArray":
        return _wrap(ops.rsqrt(self._value))

    def square(self) -> "NDArray":
        return _wrap(ops.square(self._value))

    def exp(self) -> "NDArray":
        return _wrap(ops.exp(self._value))

    def exp2(self) -> "NDArray":
        return _wrap(ops.exp2(self._value))

    def expm1(self) -> "NDArray":
        return _wrap(ops.expm1(self._value))

    def log(self) -> "NDArray":
        return _wrap(ops.log(self._value))

    def log2(self) -> "NDArray":
        return _wrap(ops.log2(self._value))

    def log10(self) -> "NDArray":
        return _wrap(ops.log10(self._value))

    def log1p(self) -> "NDArray":
        return _wrap(ops.log1p(self._value))

    def logb(self) -> "NDArray":
        return _wrap(ops.logb(self._value))

    def sin(self) -> "NDArray":
        return _wrap(ops.sin(self._value))

    def cos(self) -> "NDArray":
        return _wrap(ops.cos(self._value))

    def tan(self) -> "NDArray":
        return _wrap(ops.tan(self._value))

    def arcsin(self) -> "NDArray":
        return _wrap(ops.arcsin(self._value))

    def arccos(self) -> "NDArray":
        return _wrap(ops.arccos(self._value))

    def arctan(self) -> "NDArray":
        return _wrap(ops.arctan(self._value))

    def arctan2(self, other) -> "NDArray":
        return _wrap(ops.arctan2(self._value, _unwrap(other)))

    def sinh(self) -> "NDArray":
        return _wrap(ops.sinh(self._value))

    def cosh(self) -> "NDArray":
        return _wrap(ops.cosh(self._value))

    def tanh(self) -> "NDArray":
        return _wrap(ops.tanh(self._value))

    def arcsinh(self) -> "NDArray":
        return _wrap(ops.arcsinh(self._value))

    def arccosh(self) -> "NDArray":
        return _wrap(ops.arccosh(self._value))

    def arctanh(self) -> "NDArray":
        return _wrap(ops.arctanh(self._value))

    def degrees(self) -> "NDArray":
        return _wrap(ops.degrees(self._value))

    def radians(self) -> "NDArray":
        return _wrap(ops.radians(self._value))

    def rint(self) -> "NDArray":
        return _wrap(ops.rint(self._value))

    def fix(self) -> "NDArray":
        return _wrap(ops.fix(self._value))

    def floor(self) -> "NDArray":
        return _wrap(ops.floor(self._value))

    def ceil(self) -> "NDArray":
        return _wrap(ops.ceil(self._value))

    def trunc(self) -> "NDArray":
        return _wrap(ops.trunc(self._value))

    def round(self, decimals: int = 0) -> "NDArray":
        return _wrap(ops.round(self._value, decimals))

    def sinc(self) -> "NDArray":
        return _wrap(ops.sinc(self._value))

    def negative(self) -> "NDArray":
        return _wrap(ops.negative(self._value))

    def positive(self) -> "NDArray":
        return _wrap(ops.positive(self._value))

    def sign(self) -> "NDArray":
        return _wrap(ops.sign(self._value))

    def reciprocal(self) -> "NDArray":
        return _wrap(ops.reciprocal(self._value))

    def clip(self, a_min, a_max) -> "NDArray":
        return _wrap(ops.clip(self._value, a_min, a_max))

    def add(self, other) -> "NDArray":
        return _wrap(ops.add(self._value, _unwrap(other)))

    def subtract(self, other) -> "NDArray":
        return _wrap(ops.subtract(self._value, _unwrap(other)))

    def multiply(self, other) -> "NDArray":
        return _wrap(ops.multiply(self._value, _unwrap(other)))

    def divide(self, other) -> "NDArray":
        return _wrap(ops.divide(self._value, _unwrap(other)))

    def pow(self, other) -> "NDArray":
        return _wrap(ops.pow(self._value, _unwrap(other)))

    def mod(self, other) -> "NDArray":
        return _wrap(ops.mod(self._value, _unwrap(other)))

    def maximum(self, other) -> "NDArray":
        return _wrap(ops.maximum(self._value, _unwrap(other)))

    def minimum(self, other) -> "NDArray":
        return _wrap(ops.minimum(self._value, _unwrap(other)))

    # -- methods: logic ------------------------------------------------------
    def equal(self, other) -> "NDArray":
        return _wrap(ops.equal(self._value, _unwrap(other)))

    def not_equal(self, other) -> "NDArray":
        return _wrap(ops.not_equal(self._value, _unwrap(other)))

    def greater(self, other) -> "NDArray":
        return _wrap(ops.greater(self._value, _unwrap(other)))

    def greater_equal(self, other) -> "NDArray":
        return _wrap(ops.greater_equal(self._value, _unwrap(other)))

    def less(self, other) -> "NDArray":
        return _wrap(ops.less(self._value, _unwrap(other)))

    def less_equal(self, other) -> "NDArray":
        return _wrap(ops.less_equal(self._value, _unwrap(other)))

    def all(self, axis=None):
        return _wrap(ops.all(self._value, axis))

    def allclose(self, other, rtol: float = 1e-5, atol: float = 1e-8) -> bool:
        return ops.allclose(self._value, _unwrap(other), rtol, atol)

    # -- methods: reductions / statistics ------------------------------------
    def sum(self, axis=None, keepdims: bool = False):
        return _wrap(ops.sum(self._value, axis, keepdims))

    def prod(self, axis=None, keepdims: bool = False):
        return _wrap(ops.prod(self._value, axis, keepdims))

    def mean(self, axis=None, keepdims: bool = False):
        return _wrap(ops.mean(self._value, axis, keepdims))

    def median(self, axis=None, keepdims: bool = False):
        return _wrap(ops.median(self._value, axis, keepdims))

    def min(self, axis=None, keepdims: bool = False):
        return _wrap(ops.min(self._value, axis, keepdims))

    def max(self, axis=None, keepdims: bool = False):
        return _wrap(ops.max(self._value, axis, keepdims))

    def argmin(self, axis=None, keepdims: bool = False):
        return _wrap(ops.argmin(self._value, axis, keepdims))

    def argmax(self, axis=None, keepdims: bool = False):
        return _wrap(ops.argmax(self._value, axis, keepdims))

    def std(self, axis=None, keepdims: bool = False):
        return _wrap(ops.std(self._value, axis, keepdims=keepdims))

    def variance(self, axis=None, keepdims: bool = False):
        return _wrap(ops.variance(self._value, axis, keepdims=keepdims))

    def quantile(self, q, axis=None):
        return _wrap(ops.quantile(self._value, q, axis))

    def average(self, axis=None, weights=None):
        return _wrap(ops.average(self._value, axis, _unwrap(weights) if weights is not None else None))

    # -- methods: linalg ------------------------------------------------------
    def matmul(self, other) -> "NDArray":
        return _wrap(ops.matmul(self._value, _unwrap(other)))

    def dot(self, other):
        return _wrap(ops.dot(self._value, _unwrap(other)))

    def inner(self, other):
        return _wrap(ops.inner(self._value, _unwrap(other)))

    def outer(self, other) -> "NDArray":
        return _wrap(ops.outer(self._value, _unwrap(other)))

    def trace(self, offset: int = 0):
        return _wrap(ops.trace(self._value, offset))

    def cholesky(self) -> "NDArray":
        """Eager API surfaces non-PD failure as an error like the reference
        (linalg.c:1072 throws "Matrix is not positive definite"); the
        functional ops.cholesky stays jittable and returns NaN instead."""
        L = ops.cholesky(self._value)
        if bool(jnp.any(jnp.isnan(L))) and not bool(jnp.any(jnp.isnan(self._value))):
            raise ValueError("Matrix is not positive definite")
        return _wrap(L)

    def solve(self, b) -> "NDArray":
        return _wrap(ops.solve(self._value, _unwrap(b)))

    def inv(self) -> "NDArray":
        return _wrap(ops.inv(self._value))

    def det(self):
        return _wrap(ops.det(self._value))

    def lu(self):
        P, L, U = ops.lu(self._value)
        return (_wrap(P), _wrap(L), _wrap(U))

    def qr(self):
        Q, R = ops.qr(self._value)
        return (_wrap(Q), _wrap(R))

    def svd(self):
        U, S, Vt = ops.svd(self._value)
        return (_wrap(U), _wrap(S), _wrap(Vt))

    def eig(self):
        w, v = ops.eig(self._value)
        return (_wrap(w), _wrap(v))

    def norm(self, order="l2"):
        return _wrap(ops.norm(self._value, order))

    def cond(self, p=2):
        return _wrap(ops.cond(self._value, p))

    def matrix_rank(self, tol=None):
        r = ops.matrix_rank(self._value, tol)
        return int(r)

    def lstsq(self, b) -> "NDArray":
        return _wrap(ops.lstsq(self._value, _unwrap(b)))

    # -- methods: signal / dnn ------------------------------------------------
    def convolve2d(self, kernel, mode: str = "full", boundary: str = "fill",
                   fill_value: float = 0.0) -> "NDArray":
        return _wrap(ops.convolve2d(self._value, _unwrap(kernel), mode, boundary, fill_value))

    def correlate2d(self, kernel, mode: str = "full", boundary: str = "fill",
                    fill_value: float = 0.0) -> "NDArray":
        return _wrap(ops.correlate2d(self._value, _unwrap(kernel), mode, boundary, fill_value))

    @staticmethod
    def dnn_conv2d_forward(x, w, bias=None, stride=1, padding="SAME") -> "NDArray":
        return _wrap(ops.conv2d_forward(_unwrap(x), _unwrap(w),
                                        _unwrap(bias) if bias is not None else None,
                                        stride, padding))

    @staticmethod
    def dnn_conv2d_backward(x, w, grad):
        dx, dw = ops.conv2d_backward(_unwrap(x), _unwrap(w), _unwrap(grad))
        return (_wrap(dx), _wrap(dw))

    @staticmethod
    def dnn_conv1d_forward(x, w, stride=1, padding="same", dilation=1, groups=1) -> "NDArray":
        return _wrap(ops.conv1d_forward(_unwrap(x), _unwrap(w), stride, padding, dilation, groups))

    # -- serialization protocol ----------------------------------------------
    def __getstate__(self):
        return {"data": ops.serialize(self._value)}

    def __setstate__(self, state):
        self._value = ops.deserialize(state["data"])
        self._iter_pos = 0
        from numpower_tpu import runtime

        self._uuid = runtime.register(self._value.nbytes)


class ArithmeticOperand:
    """Compat shim for the reference's `ArithmeticOperand` helper class —
    registered alongside NDArray (numpower.c:5030, :5228-5244) with a no-arg
    constructor and no other methods (numpower.c:410-417). It exists in the
    reference as a placeholder operand type for the Zend operator-overload
    machinery; nothing in the reference's own tests or stubs ever
    instantiates it with state. Mirrored here so code porting over the full
    class surface finds it."""

    def __init__(self) -> None:
        pass


# Short alias matching the reference's `use NDArray as nd;` idiom.
nd = NDArray
