"""Dense linear algebra.

Reference: /root/reference/src/ndmath/linalg.c (1101 LoC) — CBLAS/LAPACKE on
CPU, cuBLAS/cuSOLVER on GPU, one library call per op with per-call handle
creation (linalg.c:55-71). Design: `jnp.linalg` / `lax.linalg` primitives
that XLA lowers to the backend's libraries; all ops accept **batched** inputs
(leading dims) — a strict superset of the reference, which rejects batched
matmul stacks (linalg.c:240-243) and leaves Nd·Nd dot unimplemented
(linalg.c:387-391). Matmuls run with fp32 accumulation
(preferred_element_type) to hold the 1e-4 parity bound.

Hot batched small-matrix paths (Cholesky + triangular solve for MPC state
dims n<=16) go through the unrolled elementwise forms of utils/smallmat.py;
these jnp versions are the semantic reference.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from numpower_tpu.ops.creation import asarray


def matmul(a, b) -> jax.Array:
    """NDArray_Matmul (linalg.c:217-245) → cblas_sgemm / cublasSgemm
    (linalg.c:45-79). Generalized to batched operands with NumPy matmul
    broadcasting; fp32 accumulation."""
    a, b = asarray(a), asarray(b)
    if a.ndim == 0 or b.ndim == 0:
        return a * b  # reference: 0-d matmul degrades to multiply
    return jnp.matmul(
        a, b, precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32,
    ).astype(jnp.promote_types(a.dtype, b.dtype))


def dot(a, b) -> jax.Array:
    """NDArray_Dot (linalg.c:355-393): 1d·1d→inner, 2d·2d→matmul, scalar→mul,
    Nd·1d→gemv. Generalized to full NumPy dot (the reference throws on
    Nd·Nd≥2 — linalg.c:387-391)."""
    a, b = asarray(a), asarray(b)
    return jnp.dot(
        a, b, precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32,
    ).astype(jnp.promote_types(a.dtype, b.dtype))


def inner(a, b) -> jax.Array:
    """NDArray_Inner (linalg.c:311-345) = multiply + sum over last axes."""
    return jnp.inner(asarray(a), asarray(b))


def outer(a, b) -> jax.Array:
    """NDArray_Outer (linalg.c:725-751) — cblas_sger / CUDA kernel
    (cuda_math.cu:70-77). Flattens inputs like NumPy."""
    return jnp.outer(asarray(a), asarray(b))


def trace(a, offset: int = 0) -> jax.Array:
    """NDArray_Trace (linalg.c:759-767) = sum of diagonal; batched."""
    return jnp.trace(asarray(a), offset=offset, axis1=-2, axis2=-1)


def cholesky(a, upper: bool = False) -> jax.Array:
    """NDArray_Cholesky (linalg.c:1057-1102) — LAPACKE_spotrf lower + AVX2
    upper-zeroing; CPU-only in the reference. Here: lax.linalg lowering,
    batched."""
    L = jnp.linalg.cholesky(asarray(a))
    return jnp.swapaxes(L, -1, -2) if upper else L


def solve(a, b) -> jax.Array:
    """NDArray_Solve (linalg.c:981-1028) — LAPACKE_sgesv, CPU-only in the
    reference; batched LU solve here."""
    a, b = asarray(a), asarray(b)
    unsqueeze = b.ndim == a.ndim - 1
    if unsqueeze:
        b = b[..., None]
    x = jnp.linalg.solve(a, b)
    return x[..., 0] if unsqueeze else x


def solve_triangular(a, b, lower: bool = True, trans: bool = False,
                     unit_diagonal: bool = False) -> jax.Array:
    """Triangular solve — the reference reaches LAPACKE only through sgesv;
    exposed directly because it is the Riccati hot path."""
    return jax.scipy.linalg.solve_triangular(
        asarray(a), asarray(b), lower=lower,
        trans=1 if trans else 0, unit_diagonal=unit_diagonal,
    )


def cho_solve(L, b, lower: bool = True) -> jax.Array:
    """Solve A x = b given the Cholesky factor of A (two triangular solves)."""
    return jax.scipy.linalg.cho_solve((asarray(L), lower), asarray(b))


def inv(a) -> jax.Array:
    """NDArray_Inverse (linalg.c:482-605) — sgetrf+sgetri; batched here."""
    return jnp.linalg.inv(asarray(a))


def det(a) -> jax.Array:
    """NDArray_Det (linalg.c:254-303) — LU + diag product + permutation
    parity; jnp does the same on-device, batched."""
    return jnp.linalg.det(asarray(a))


def lu(a) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """NDArray_Lu (linalg.c:514-566,614-658) — hand-rolled partial-pivot LU
    returning (P, L, U) with A = P @ L @ U."""
    P, L, U = jax.scipy.linalg.lu(asarray(a))
    return P, L, U


def qr(a, mode: str = "reduced"):
    """NDArray_Qr (linalg.c:909-970) — the reference runs sgeqrf but never
    forms Q via orgqr (incomplete, SURVEY.md §2.3); we return a full proper
    (Q, R)."""
    return jnp.linalg.qr(asarray(a), mode=mode)


def svd(a, full_matrices: bool = True):
    """NDArray_SVD (linalg.c:85-209) — sgesdd / cusolverDnSgesvdj. Returns
    (U, S, Vt) like the reference's 3-array return (numpower.c:340-393)."""
    return jnp.linalg.svd(asarray(a), full_matrices=full_matrices)


def svdvals(a) -> jax.Array:
    return jnp.linalg.svd(asarray(a), compute_uv=False)


def _eig_host(a: np.ndarray):
    """Host-side sgeev analogue. Runs on CPU inside jax.pure_callback."""
    w, v = np.linalg.eig(np.asarray(a))
    return w.astype(np.complex64), v.astype(np.complex64)


def eig_complex(a) -> Tuple[jax.Array, jax.Array]:
    """Full complex nonsymmetric eig — jittable and vmap-able.

    LAPACK geev runs on the host: eagerly via a direct device_get->numpy
    round trip, or under jit/vmap via jax.pure_callback (XLA has no
    nonsymmetric eig lowering on every backend). Returns complex64 (w, v) —
    a superset of the reference, which discards imaginary parts
    (linalg.c:770-838 frees the wi buffer `wivectors` unread)."""
    a = asarray(a)
    if not isinstance(a, jax.core.Tracer):
        w, v = _eig_host(np.asarray(jax.device_get(a)))
        return jnp.asarray(w), jnp.asarray(v)
    out_spec = (
        jax.ShapeDtypeStruct(a.shape[:-1], jnp.complex64),
        jax.ShapeDtypeStruct(a.shape, jnp.complex64),
    )
    return jax.pure_callback(_eig_host, out_spec, a,
                             vmap_method="expand_dims")


def eig(a) -> Tuple[jax.Array, jax.Array]:
    """NDArray_Eig (linalg.c:770-838) — LAPACKE_sgeev (GPU path disabled in
    the reference, linalg.c:826-833). Jittable: runs as a host pure_callback
    (see eig_complex). Matches reference semantics exactly: imaginary parts
    are discarded (the reference frees the `wivectors` wi buffer unread), so
    the return is real fp32. Use eig_complex for the full complex spectrum,
    or eigh for the symmetric case."""
    a = asarray(a)
    if not isinstance(a, jax.core.Tracer):
        # Eager: take real parts on the host.
        w, v = _eig_host(np.asarray(jax.device_get(a)))
        return (jnp.asarray(np.real(w)).astype(a.dtype),
                jnp.asarray(np.real(v)).astype(a.dtype))
    w, v = eig_complex(a)
    return jnp.real(w).astype(a.dtype), jnp.real(v).astype(a.dtype)


def eigh(a):
    """Symmetric/Hermitian eig — on the device (absent from the reference;
    required for spectral norms and covariance work)."""
    return jnp.linalg.eigh(asarray(a))


def eigvals(a) -> jax.Array:
    w, _ = eig(a)
    return w


def norm(a, order="l2") -> jax.Array:
    """NDArray_Norm (linalg.c:424-447): 'l1' = max abs column sum, 'l2' = max
    singular value (matrices) / Euclidean (vectors). Also accepts NumPy ord
    values ('fro', inf, integers)."""
    a = asarray(a)
    if order in ("l1", 1):
        ordv = 1
    elif order in ("l2", 2, None):
        ordv = 2
    else:
        ordv = order
    if a.ndim == 1:
        return jnp.linalg.norm(a, ord=None if ordv == 2 else ordv)
    return jnp.linalg.norm(a, ord=ordv)


def cond(a, p=2) -> jax.Array:
    """NDArray_Cond (linalg.c:1038-1047) = ||A|| * ||A^-1||."""
    return jnp.linalg.cond(asarray(a), p=p)


def matrix_rank(a, tol: Optional[float] = None) -> jax.Array:
    """NDArray_MatrixRank (linalg.c:668-715) — SVD + tolerance threshold."""
    return jnp.linalg.matrix_rank(asarray(a), tol=tol)


def lstsq(a, b):
    """NDArray_Lstsq (linalg.c:849-899) — LAPACKE_sgels. Returns the solution
    array (the reference returns only X)."""
    x, _, _, _ = jnp.linalg.lstsq(asarray(a), asarray(b))
    return x


def pinv(a) -> jax.Array:
    return jnp.linalg.pinv(asarray(a))


def matrix_power(a, n: int) -> jax.Array:
    return jnp.linalg.matrix_power(asarray(a), n)


def kron(a, b) -> jax.Array:
    return jnp.kron(asarray(a), asarray(b))


def einsum(subscripts: str, *operands) -> jax.Array:
    return jnp.einsum(subscripts, *[asarray(o) for o in operands],
                      precision=jax.lax.Precision.HIGHEST,
                      preferred_element_type=jnp.float32)
