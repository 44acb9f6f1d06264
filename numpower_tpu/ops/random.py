"""Random number generation.

Reference: libc `rand()`-based Box-Muller normal / uniform / Knuth Poisson /
Bernoulli-loop binomial (/root/reference/src/initializers.c:517-590,844-865),
seeded once per request from time^pid^clock (numpower.c:5246-5279) — draws are
irreproducible and user-unseedable.

Design: counter-based keyed `jax.random` (threefry) — reproducible,
splittable, traceable under jit/vmap, and generated on-device. For API parity
with the reference's implicit global stream, a module-level seedable stream is
provided; every call splits the global key. Parity tests compare
*distributions*, not values (SURVEY.md §7).
"""

from __future__ import annotations

import threading
import time
from typing import Optional, Sequence, Union

import jax
import jax.numpy as jnp

from numpower_tpu.utils.config import default_dtype

Shape = Union[int, Sequence[int]]


def _normalize_shape(shape: Shape) -> tuple:
    if isinstance(shape, int):
        return (shape,)
    return tuple(int(s) for s in shape)


class _GlobalStream:
    """Seedable global key stream (the reference's RINIT rand() seed analogue,
    numpower.c:5251). Thread-safe; each draw splits off a fresh subkey."""

    def __init__(self):
        self._lock = threading.Lock()
        # Lazily created on first draw: PRNGKey materializes a device array,
        # which would initialize the XLA backend at package-IMPORT time —
        # breaking jax.distributed.initialize (which must run before any
        # backend use; parallel/distributed.py) just to import the library.
        self._key: Optional[jax.Array] = None

    def seed(self, s: int) -> None:
        with self._lock:
            self._key = jax.random.PRNGKey(int(s))

    def next_key(self) -> jax.Array:
        with self._lock:
            if self._key is None:
                self._key = jax.random.PRNGKey(time.time_ns() % (2**31))
            self._key, sub = jax.random.split(self._key)
            return sub


_stream = _GlobalStream()


def seed(s: int) -> None:
    """Seed the global stream — capability the reference lacks (its rand()
    seed is fixed at request init)."""
    _stream.seed(s)


def key(s: int) -> jax.Array:
    """Explicit PRNG key construction for functional use."""
    return jax.random.PRNGKey(int(s))


def _resolve_key(k: Optional[jax.Array]) -> jax.Array:
    return _stream.next_key() if k is None else k


def uniform(shape: Shape = (), low: float = 0.0, high: float = 1.0, *, key=None, dtype=None):
    """nd::uniform — reference initializers.c:581-590."""
    return jax.random.uniform(
        _resolve_key(key), _normalize_shape(shape),
        minval=low, maxval=high, dtype=dtype or default_dtype(),
    )


def normal(shape: Shape = (), loc: float = 0.0, scale: float = 1.0, *, key=None, dtype=None):
    """nd::normal — reference Box-Muller (initializers.c:517-533)."""
    return loc + scale * jax.random.normal(
        _resolve_key(key), _normalize_shape(shape), dtype=dtype or default_dtype()
    )


def standard_normal(shape: Shape = (), *, key=None, dtype=None):
    """nd::standard_normal — reference initializers.c."""
    return jax.random.normal(_resolve_key(key), _normalize_shape(shape), dtype=dtype or default_dtype())


def poisson(shape: Shape = (), lam: float = 1.0, *, key=None, dtype=None):
    """nd::poisson — reference Knuth-style loop (initializers.c:553-572).
    jax.random.poisson uses rejection sampling on-device (no host loop)."""
    draws = jax.random.poisson(_resolve_key(key), lam, _normalize_shape(shape))
    return draws.astype(dtype or default_dtype())


def random_binomial(shape: Shape = (), n: int = 1, p: float = 0.5, *, key=None, dtype=None):
    """nd::random_binomial — reference Bernoulli loop (initializers.c:844-865).
    Implemented as a vectorized sum of Bernoulli draws over a static n (the
    reference loops n times per element on the host; here it is one fused
    on-device sample of shape (n, *shape) reduced over axis 0)."""
    shape_t = _normalize_shape(shape)
    k = _resolve_key(key)
    bern = jax.random.bernoulli(k, p, (int(n),) + shape_t)
    return jnp.sum(bern, axis=0).astype(dtype or default_dtype())


def randint(shape: Shape = (), low: int = 0, high: int = 2, *, key=None, dtype=jnp.int32):
    return jax.random.randint(_resolve_key(key), _normalize_shape(shape), low, high, dtype=dtype)


def truncated_normal(shape: Shape = (), lower: float = -2.0, upper: float = 2.0, *, key=None, dtype=None):
    return jax.random.truncated_normal(
        _resolve_key(key), lower, upper, _normalize_shape(shape), dtype=dtype or default_dtype()
    )
