"""Elementwise unary/binary math.

Covers the reference's full scalar-math surface
(/root/reference/src/ndmath/double_math.c — 40+ fp32 libm wrappers dispatched
through NDArray_Map scalar loops, ndarray.c:683-744) and binary arithmetic
(/root/reference/src/ndmath/arithmetics.c — AVX2 loops / per-op CUDA kernels).

Design: every op is a jnp primitive; XLA fuses chains of them into single
elementwise kernels, replacing both the AVX2 hand-vectorization and the
one-kernel-per-op CUDA dispatch (cuda_math.cu:1533-1560, no fusion) with
compiler fusion. Broadcasting follows full NumPy rules — a strict superset of
the reference's partial 2-d-only broadcast (ndarray.c:1167-1294, "@todo
Implement ND broadcast").
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from numpower_tpu.ops.creation import asarray

# ----------------------------------------------------------------------------
# Binary arithmetic — reference arithmetics.c
# ----------------------------------------------------------------------------


def add(a, b):
    """NDArray_Add_Float (arithmetics.c:160-278)."""
    return jnp.add(asarray(a), asarray(b))


def subtract(a, b):
    """NDArray_Subtract_Float (arithmetics.c:439)."""
    return jnp.subtract(asarray(a), asarray(b))


def multiply(a, b):
    """NDArray_Multiply_Float (arithmetics.c:293-430). The reference fixes up
    -0.0 products (arithmetics.c:280-284); IEEE-correct XLA needs no fixup,
    and parity tests compare values, for which -0.0 == 0.0."""
    return jnp.multiply(asarray(a), asarray(b))


def divide(a, b):
    """NDArray_Divide_Float (arithmetics.c:566)."""
    return jnp.divide(asarray(a), asarray(b))


def pow(a, b):  # noqa: A001 - mirrors reference name
    """NDArray_Pow_Float (arithmetics.c:700). Python-int exponents lower to
    exact repeated multiplication (lax integer_pow) like C powf's exact
    integer results; float exponents use the transcendental path."""
    if isinstance(b, (int, float)) and not isinstance(b, bool):
        bf = float(b)
        if bf.is_integer() and -64 <= bf <= 64:
            return jax.lax.integer_pow(asarray(a), int(bf))
    return jnp.power(asarray(a), asarray(b))


power = pow


def mod(a, b):
    """NDArray_Mod_Float (arithmetics.c:825) — C fmodf semantics (truncated,
    sign of dividend), not Python modulo."""
    return jnp.fmod(asarray(a), asarray(b))


def maximum(a, b):
    """NDArray_Maximum (ndarray.c:853-893) — pairwise max, generalized to
    broadcasting (reference requires identical shapes and is CPU-only)."""
    return jnp.maximum(asarray(a), asarray(b))


def minimum(a, b):
    """NDArray_Minimum (ndarray.c:895-931)."""
    return jnp.minimum(asarray(a), asarray(b))


def arctan2(a, b):
    """double_math.c arctan2 (two-operand dispatch arithmetics.c Map2F)."""
    return jnp.arctan2(asarray(a), asarray(b))


# ----------------------------------------------------------------------------
# Unary math — reference double_math.c:7-44 surface
# ----------------------------------------------------------------------------


def abs(a):  # noqa: A001
    return jnp.abs(asarray(a))


absolute = abs


def sqrt(a):
    return jnp.sqrt(asarray(a))


def rsqrt(a):
    """double_math.c float_rsqrt = 1/sqrt. jax.lax.rsqrt maps to the
    hardware's native reciprocal square root."""
    return jax.lax.rsqrt(asarray(a))


def exp(a):
    return jnp.exp(asarray(a))


def exp2(a):
    return jnp.exp2(asarray(a))


def expm1(a):
    return jnp.expm1(asarray(a))


def log(a):
    return jnp.log(asarray(a))


def log2(a):
    return jnp.log2(asarray(a))


def log10(a):
    return jnp.log10(asarray(a))


def log1p(a):
    return jnp.log1p(asarray(a))


def logb(a):
    """C logbf: exponent of |x| as a float (double_math.c float_logb)."""
    a = asarray(a)
    return jnp.where(
        a == 0,
        -jnp.inf,
        jnp.floor(jnp.log2(jnp.abs(a))),
    )


def sin(a):
    return jnp.sin(asarray(a))


def cos(a):
    return jnp.cos(asarray(a))


def tan(a):
    return jnp.tan(asarray(a))


def arcsin(a):
    return jnp.arcsin(asarray(a))


def arccos(a):
    return jnp.arccos(asarray(a))


def arctan(a):
    return jnp.arctan(asarray(a))


def sinh(a):
    return jnp.sinh(asarray(a))


def cosh(a):
    return jnp.cosh(asarray(a))


def tanh(a):
    return jnp.tanh(asarray(a))


def arcsinh(a):
    return jnp.arcsinh(asarray(a))


def arccosh(a):
    return jnp.arccosh(asarray(a))


def arctanh(a):
    return jnp.arctanh(asarray(a))


def degrees(a):
    return jnp.degrees(asarray(a))


def radians(a):
    return jnp.radians(asarray(a))


def rint(a):
    """C rintf — round-half-to-even (double_math.c float_rint)."""
    return jnp.rint(asarray(a))


def fix(a):
    """Round toward zero (double_math.c float_fix) — same as trunc."""
    return jnp.trunc(asarray(a))


def floor(a):
    return jnp.floor(asarray(a))


def ceil(a):
    return jnp.ceil(asarray(a))


def trunc(a):
    return jnp.trunc(asarray(a))


def round(a, decimals: int = 0):  # noqa: A001
    """double_math.c float_round + CUDA round-to-decimals
    (cuda_math.cu:207-215): scale, round-half-away-from-zero, unscale."""
    a = asarray(a)
    scale = jnp.asarray(10.0**decimals, a.dtype)
    scaled = a * scale
    # C roundf rounds half away from zero (not banker's rounding).
    return jnp.sign(scaled) * jnp.floor(jnp.abs(scaled) + 0.5) / scale


def sinc(a):
    """Normalized sinc sin(pi x)/(pi x) (double_math.c float_sinc)."""
    return jnp.sinc(asarray(a))


def negative(a):
    return jnp.negative(asarray(a))


def positive(a):
    return jnp.positive(asarray(a))


def sign(a):
    return jnp.sign(asarray(a))


def reciprocal(a):
    return jnp.reciprocal(asarray(a))


def square(a):
    return jnp.square(asarray(a))


def clip(a, a_min, a_max):
    """double_math.c float_clip(min,max)."""
    return jnp.clip(asarray(a), a_min, a_max)
