"""NumPower-user quickstart: the NDArray object API.

Run: PYTHONPATH=. python examples/01_ndarray_quickstart.py  (default backend;
JAX_PLATFORMS=cpu for a CPU run)

Mirrors the reference's README workflow (construction, operators, linalg,
persistence, iteration) on this array layer.
"""

from numpower_tpu.utils.config import enable_compile_cache

enable_compile_cache()

from numpower_tpu import NDArray, ops  # noqa: E402

# construction (fp32 like the reference) + operators + chaining
a = NDArray.array([[1.0, 2.0], [3.0, 4.0]])
b = (a @ a.T + 1.0).sqrt()
print("chained:", b)

# linalg: cholesky / solve / svd (all batched, unlike the reference)
spd = NDArray.array([[4.0, 2.0], [2.0, 3.0]])
print("cholesky:", spd.cholesky())
print("det:", spd.det(), " trace:", spd.trace())

# broadcasting strictly generalizes the reference's partial cases
row = NDArray.array([10.0, 20.0])
print("broadcast add:", a + row)

# reductions with axis/keepdims; 0-d results are Python floats
print("sum:", a.sum(), " mean(axis=0):", a.mean(axis=0))

# persistence: npy roundtrip (C++ fast path), pickle protocol
a.save("/tmp/example_a.npy")
print("reloaded:", NDArray.load("/tmp/example_a.npy"))

# iteration protocol (first-axis subviews, like the reference)
for row_view in a:
    print("row:", row_view)

# functional layer for jit/vmap composition
x = ops.convolve2d(ops.random.normal((8, 8)), ops.ones((3, 3)) / 9, mode="same")
print("conv out shape:", x.shape)
