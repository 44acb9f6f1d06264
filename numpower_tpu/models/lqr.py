"""Finite-horizon LQR via Riccati recursion.

BASELINE configs #1 (double-integrator LQR) and #2 (batched 256-scenario LTI
MPC Riccati). The reference exposes only the building blocks (matmul/
cholesky/solve — tests/linalg) and the user loops in PHP; here the whole
backward pass is one `lax.scan` inside a jitted program, with K_t computed by
Cholesky solves of (R + B'P B) — the PSD hot path flagged in SURVEY.md §7.

Two horizon engines:
 - `riccati_scan`          sequential O(T) scan (default; T=30 is cheap)
 - `riccati_associative`   parallel-in-time O(log T) depth via
                           jax.lax.associative_scan on conditional-value-
                           function elements (PAPERS.md "The Parallelization
                           of Riccati Recursion"-style; sequence
                           parallelism over the horizon axis)
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax


def _psd_solve(M, rhs):
    """Solve M x = rhs with M symmetric PD via Cholesky (two triangular
    solves). For n <= 16 the factorization+substitutions are UNROLLED at
    trace time into elementwise ops (utils/smallmat.py) — XLA's blocked
    cholesky/triangular-solve custom calls are both slow when batched over
    many tiny matrices and expensive to compile when a scan carrying them
    is unrolled. Same recurrence as LAPACK spotrf, identical numerics."""
    if M.shape[-1] <= 16:
        from numpower_tpu.utils.smallmat import psd_solve_unrolled

        return psd_solve_unrolled(M, rhs)
    L = jnp.linalg.cholesky(M)
    return jax.scipy.linalg.cho_solve((L, True), rhs)


def riccati_scan(A, B, Q, R, QF, horizon: int):
    """Backward Riccati recursion.

    Returns (Ks, Ps): Ks (T, m, n) feedback gains u_t = -K_t x_t;
    Ps (T+1, n, n) cost-to-go Hessians with Ps[0] = P_0, Ps[T] = QF.
    """

    def step(P_next, _):
        BtP = B.T @ P_next
        K = _psd_solve(R + BtP @ B, BtP @ A)
        AtP = A.T @ P_next
        P = Q + AtP @ A - (BtP @ A).T @ K
        P = 0.5 * (P + P.T)  # keep symmetric under fp32 accumulation
        return P, (K, P)

    P_final, (Ks_rev, Ps_rev) = lax.scan(step, QF, None, length=horizon)
    Ks = jnp.flip(Ks_rev, axis=0)
    Ps = jnp.concatenate([jnp.flip(Ps_rev, axis=0), QF[None]], axis=0)
    return Ks, Ps


class _RiccatiElement(NamedTuple):
    """Conditional value-function element (F, C, J): the suffix Bellman map
    P -> J + F' P (I + C P)^{-1} F, closed under composition."""

    F: jax.Array
    C: jax.Array
    J: jax.Array


def _combine(ei: _RiccatiElement, ej: _RiccatiElement,
             solve=None) -> _RiccatiElement:
    """Associative combine of element i (earlier stage) with element j
    (later stage block). Parallel-LQR combine rule (regulation case of the
    parallel LQT/dynamic-programming elements).

    solve: small-matrix solver for the (I + C_i J_j) denominator; default
    is the implicit-pivot unrolled LU (utils/smallmat.solve_small — XLA's
    batched LU runs per-matrix pivot loops, which costs the associative
    scan its advantage over the sequential recursion at n=12). Pass lu_solve_nopivot for the fusion-friendly
    unpivoted form ONLY when the combine chain is known well-conditioned:
    C, J PSD makes eig(CJ) >= 0, but unpivoted elimination pivots are NOT
    eigenvalues — ill-conditioned denominators can produce tiny/underflowed
    pivots and NaN or O(10%) fp32 error (advisor r4 Monte-Carlo; see
    lu_solve_nopivot's docstring for the measured envelope)."""
    n = ei.F.shape[-1]
    I = jnp.eye(n, dtype=ei.F.dtype)
    if solve is None:
        from numpower_tpu.utils.smallmat import solve_small as solve

    M = solve(I + ei.C @ ej.J, jnp.concatenate([ei.F, ei.C], axis=-1))
    MF, MC = M[..., :n], M[..., n:]
    F = ej.F @ MF
    C = ej.F @ MC @ ej.F.swapaxes(-1, -2) + ej.C
    # (I + J_j C_i)^{-1} J_j F_i  == J_j (I + C_i J_j)^{-1} F_i = J_j @ MF
    J = ei.F.swapaxes(-1, -2) @ ej.J @ MF + ei.J
    J = 0.5 * (J + J.swapaxes(-1, -2))
    C = 0.5 * (C + C.swapaxes(-1, -2))
    return _RiccatiElement(F, C, J)


def riccati_associative(A, B, Q, R, QF, horizon: int,
                        nopivot: bool = False):
    """Parallel-in-time Riccati: O(log T) depth associative scan.

    Produces the same (Ks, Ps) as riccati_scan (fp32 tolerance). Useful when
    the horizon is long (T >= 128) or when horizon stages are sharded across
    devices; for T~30 the sequential scan is typically faster.

    nopivot=True routes the combine denominators through the unpivoted
    unrolled LU (utils/smallmat.lu_solve_nopivot — every elimination op
    fuses; the pivoted form's masked argmax breaks fusion per column).
    It is an OPT-IN perf lever for
    well-conditioned problems (the benched quadrotor/KF regimes): C, J
    PSD does NOT bound the unpivoted pivots — ill-conditioned I + CJ can
    underflow a pivot and NaN or lose several digits (advisor r4
    Monte-Carlo, documented in lu_solve_nopivot). The default is the
    pivoted solver, which handles any invertible denominator.
    """
    n = A.shape[-1]
    solve = None
    if nopivot:
        from numpower_tpu.utils.smallmat import lu_solve_nopivot as solve
    # Stage element: F=A, C=B R^{-1} B', J=Q. Terminal element: (0, 0, QF).
    C_stage = B @ _psd_solve(R, B.T)
    Fs = jnp.broadcast_to(A, (horizon, n, n))
    Cs = jnp.broadcast_to(C_stage, (horizon, n, n))
    Js = jnp.broadcast_to(Q, (horizon, n, n))
    elems = _RiccatiElement(
        jnp.concatenate([Fs, jnp.zeros((1, n, n), A.dtype)], axis=0),
        jnp.concatenate([Cs, jnp.zeros((1, n, n), A.dtype)], axis=0),
        jnp.concatenate([Js, QF[None]], axis=0),
    )
    # Reverse associative scan: suffix composition from each stage to T.
    # Note: with reverse=True, lax.associative_scan calls fn(later, earlier)
    # (empirically: r[0] = fn(fn(e[n-1], e[n-2]), ... e[0])), so the earlier
    # element is the SECOND argument.
    combined = lax.associative_scan(
        lambda later, earlier: _combine(
            _RiccatiElement(earlier[0], earlier[1], earlier[2]),
            _RiccatiElement(later[0], later[1], later[2]),
            solve=solve,
        ),
        tuple(elems),
        reverse=True,
        axis=0,
    )
    Ps = combined[2]  # (T+1, n, n); Ps[t] = cost-to-go from stage t
    P_next = Ps[1:]  # (T, n, n)

    def gain(Pn):
        BtP = B.T @ Pn
        return _psd_solve(R + BtP @ B, BtP @ A)

    Ks = jax.vmap(gain)(P_next)
    return Ks, Ps


def lqt_solve(A, B, Q, R, QF, x0, x_refs, horizon: int):
    """Finite-horizon LQ TRACKING (affine Riccati): drive the state along a
    reference trajectory x_refs ((T+1, n): stage references r_1..r_T at
    indices 1..T; index 0 unused) minimizing
        sum_t (x_t - r_t)' Q (x_t - r_t) + u_t' R u_t  +  (x_T - r_T)' QF (x_T - r_T).

    Backward pass carries (P_t, p_t) with u* = -K_t x - k_t:
        S   = R + B' P B
        K   = S^{-1} B' P A,     k = S^{-1} B' p
        P'  = Q + A'PA - (B'PA)' K
        p'  = -Q r_t + (A - BK)' (p - P B k) + K' R k

    Returns (us (T, m), xs (T+1, n)). The reference has no tracking solver;
    its users hand-roll this loop in PHP over nd ops.
    """

    def step(carry, r_t):
        P, p = carry
        BtP = B.T @ P
        S = R + BtP @ B
        L = jnp.linalg.cholesky(0.5 * (S + S.T))
        K = jax.scipy.linalg.cho_solve((L, True), BtP @ A)
        k = jax.scipy.linalg.cho_solve((L, True), B.T @ p)
        Acl = A - B @ K
        P_new = Q + A.T @ P @ A - (BtP @ A).T @ K
        P_new = 0.5 * (P_new + P_new.T)
        p_new = -(Q @ r_t) + Acl.T @ (p - P @ (B @ k)) + K.T @ (R @ k)
        return (P_new, p_new), (K, k)

    P_T = QF
    p_T = -(QF @ x_refs[-1])
    # iteration i computes gains (K_{T-1-i}, k_{T-1-i}) from the carried
    # (P, p), THEN folds in the stage cost at t = T-1-i with r_{T-1-i}
    # (r_0 only shifts V_0 by a constant — it never affects any control)
    refs_rev = jnp.flip(x_refs[:-1], axis=0)
    (_, _), (Ks_rev, ks_rev) = lax.scan(step, (P_T, p_T), refs_rev)
    Ks = jnp.flip(Ks_rev, axis=0)
    ks = jnp.flip(ks_rev, axis=0)

    def fwd(x, Kk):
        K, k = Kk
        u = -(K @ x) - k
        x_next = A @ x + B @ u
        return x_next, (u, x_next)

    _, (us, xs) = lax.scan(fwd, x0, (Ks, ks))
    return us, jnp.concatenate([x0[None], xs], axis=0)


def lqr_infinite_gain(A, B, Q, R, iters: int = 200):
    """Infinite-horizon discrete LQR gain by Riccati fixed-point iteration
    (static iteration count — compiler-friendly control flow)."""

    def step(P, _):
        BtP = B.T @ P
        K = _psd_solve(R + BtP @ B, BtP @ A)
        P_new = Q + A.T @ P @ (A - B @ K)
        P_new = 0.5 * (P_new + P_new.T)
        return P_new, None

    P, _ = lax.scan(step, Q, None, length=iters)
    BtP = B.T @ P
    K = _psd_solve(R + BtP @ B, BtP @ A)
    return K, P


def lqr_solve(A, B, Q, R, QF, x0, horizon: int, parallel: bool = False):
    """Full LQR solve: backward Riccati + forward rollout.

    Returns (us, xs): optimal controls (T, m) and trajectory (T+1, n).
    BASELINE config #1 is this on the double integrator at horizon 30.
    """
    riccati = riccati_associative if parallel else riccati_scan
    Ks, _ = riccati(A, B, Q, R, QF, horizon)

    def fwd(x, K):
        u = -(K @ x)
        x_next = A @ x + B @ u
        return x_next, (u, x_next)

    _, (us, xs) = lax.scan(fwd, x0, Ks)
    return us, jnp.concatenate([x0[None], xs], axis=0)


def riccati_scan_per_scenario(As, Bs, Q, R, QF, horizon: int):
    """Backward Riccati for a BATCH of scenario-specific LTI systems:
    As (N, n, n), Bs (N, n, m) -> Ks (N, T, m, n), P0 (N, n, n).

    This is the per-scenario path (tube/robust MPC with per-scenario models,
    batched iLQR backward passes). The inner op K = (R+B'PB)^{-1}(B'PA) is a
    batch of tiny SPD solves, done by the unrolled elementwise factorisation
    of utils/smallmat.py (via _psd_solve) that XLA fuses.
    """
    N, n, _ = As.shape
    m = Bs.shape[-1]

    def spd_solve(S, rhs):
        return jax.vmap(_psd_solve)(S, rhs)

    Rb = jnp.broadcast_to(R, (N, m, m))
    Qb = jnp.broadcast_to(Q, (N, n, n))

    def step(P, _):
        BtP = jnp.einsum("nji,njk->nik", Bs, P)          # B' P    (N, m, n)
        S = Rb + jnp.einsum("nij,njk->nik", BtP, Bs)     # R+B'PB  (N, m, m)
        BtPA = jnp.einsum("nij,njk->nik", BtP, As)       # B'PA    (N, m, n)
        K = spd_solve(0.5 * (S + S.transpose(0, 2, 1)), BtPA)
        AtPA = jnp.einsum("nji,njk,nkl->nil", As, P, As)
        P_new = Qb + AtPA - jnp.einsum("nji,njk->nik", BtPA, K)
        P_new = 0.5 * (P_new + P_new.transpose(0, 2, 1))
        return P_new, K

    P0, Ks_rev = lax.scan(step, jnp.broadcast_to(QF, (N, n, n)), None, length=horizon)
    return jnp.flip(Ks_rev, axis=0).transpose(1, 0, 2, 3), P0


def lqr_solve_batched(A, B, Q, R, QF, x0s, horizon: int):
    """BASELINE config #2: batched scenarios share one backward pass (K_t is
    scenario-independent for LTI plants) — the backward Riccati runs ONCE and
    the forward rollout vmaps over scenarios. This is the structural win over
    per-scenario solves."""
    Ks, _ = riccati_scan(A, B, Q, R, QF, horizon)

    def fwd_one(x0):
        def fwd(x, K):
            u = -(K @ x)
            x_next = A @ x + B @ u
            return x_next, (u, x_next)

        _, (us, xs) = lax.scan(fwd, x0, Ks)
        return us, jnp.concatenate([x0[None], xs], axis=0)

    return jax.vmap(fwd_one)(x0s)
