"""State estimation: Kalman filter / RTS smoother / EKF.

The estimation side of the MPC loop (measure -> estimate -> solve -> act).
Composes exactly the reference user's op surface — matmul, cholesky, solve,
transpose (linalg.c:981-1102, SURVEY.md §2.3) — into scan-structured
estimators the reference's eager dispatch could never run at scale:

  - the whole filter/smoother over a horizon is ONE lax.scan (jit-compiled,
    static shapes), not T eager solves
  - batched over N independent trajectories with vmap (scenario axis =
    BASELINE's scaling dimension)
  - innovations are whitened with a Cholesky solve (no explicit inverse);
    covariances are symmetrized each step to hold fp32 PSD-ness
  - log-likelihood accumulates in the scan carry for system-ID / tuning

EKF reuses models/rollout.linearize (jacfwd) per step, keeping the nonlinear
plant API identical to the iLQR/MPPI solvers.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from numpower_tpu.models.rollout import linearize


class KalmanResult(NamedTuple):
    means: jax.Array        # (T, n) filtered means x_{t|t}
    covs: jax.Array         # (T, n, n) filtered covariances P_{t|t}
    pred_means: jax.Array   # (T, n) one-step predictions x_{t|t-1}
    pred_covs: jax.Array    # (T, n, n) prediction covariances P_{t|t-1}
    log_likelihood: jax.Array  # scalar sum of innovation log-densities


class SmootherResult(NamedTuple):
    means: jax.Array  # (T, n) smoothed means x_{t|T}
    covs: jax.Array   # (T, n, n) smoothed covariances



def _chol(S):
    """Cholesky routed through the trace-time-unrolled recurrence for
    n <= 16 (utils/smallmat.py) — avoids XLA's blocked custom call, which
    is latency-bound inside scans and slow when batched over tiny
    matrices. Same algorithm, identical numerics."""
    if S.shape[-1] <= 16:
        from numpower_tpu.utils.smallmat import cholesky_unrolled

        return cholesky_unrolled(S)
    return jnp.linalg.cholesky(S)


def _trisolve(L, rhs, lower=True):
    if L.shape[-1] <= 16:
        from numpower_tpu.utils.smallmat import tri_solve_unrolled

        return tri_solve_unrolled(L, rhs, lower=lower)
    return jax.scipy.linalg.solve_triangular(L, rhs, lower=lower)


def _chosolve(L, rhs):
    """(L L')^{-1} rhs given the lower Cholesky factor L."""
    if L.shape[-1] <= 16:
        z = _trisolve(L, rhs, lower=True)
        return _trisolve(L.swapaxes(-1, -2), z, lower=False)
    return jax.scipy.linalg.cho_solve((L, True), rhs)


def _filter_step(A, C, Q, R, x, P, y, u_term):
    """One predict+update. Returns (x_f, P_f, x_p, P_p, ll)."""
    n = x.shape[0]
    # predict
    x_p = A @ x + u_term
    P_p = A @ P @ A.T + Q
    P_p = 0.5 * (P_p + P_p.T)
    # update (innovation form, Cholesky-whitened)
    v = y - C @ x_p
    S = C @ P_p @ C.T + R
    S = 0.5 * (S + S.T)
    L = _chol(S)
    # K = P_p C' S^{-1}  via two triangular solves
    CP = C @ P_p                                   # (p, n)
    W = _chosolve(L, CP)  # S^{-1} C P_p  (p, n)
    x_f = x_p + W.T @ v
    P_f = P_p - W.T @ CP
    P_f = 0.5 * (P_f + P_f.T)
    # innovation log-density: -1/2 (v'S^-1 v + log det S + p log 2pi)
    alpha = _trisolve(L, v)
    p = y.shape[0]
    ll = -0.5 * (alpha @ alpha + p * jnp.log(2.0 * jnp.pi)) - jnp.sum(
        jnp.log(jnp.diagonal(L)))
    return x_f, P_f, x_p, P_p, ll


def kalman_filter(
    A: jax.Array,        # (n, n) transition
    C: jax.Array,        # (p, n) observation
    Q: jax.Array,        # (n, n) process noise cov
    R: jax.Array,        # (p, p) measurement noise cov
    x0: jax.Array,       # (n,) prior mean
    P0: jax.Array,       # (n, n) prior cov
    ys: jax.Array,       # (T, p) measurements
    B: Optional[jax.Array] = None,   # (n, m) input matrix
    us: Optional[jax.Array] = None,  # (T, m) known inputs
) -> KalmanResult:
    """LTI Kalman filter over the horizon as one scan; jit/vmap-compatible.

    vmap over (x0, ys[, us]) for batched trajectories
    (kalman_filter_batched)."""
    T = ys.shape[0]
    if us is None:
        u_terms = jnp.zeros((T, x0.shape[0]), x0.dtype)
    else:
        if B is None:
            raise ValueError("us requires B (the input matrix)")
        u_terms = us @ B.T

    def step(carry, inputs):
        x, P, ll = carry
        y, u_term = inputs
        x_f, P_f, x_p, P_p, l = _filter_step(A, C, Q, R, x, P, y, u_term)
        return (x_f, P_f, ll + l), (x_f, P_f, x_p, P_p)

    (_, _, ll), (xs_f, Ps_f, xs_p, Ps_p) = lax.scan(
        step, (x0, P0, jnp.asarray(0.0, x0.dtype)), (ys, u_terms))
    return KalmanResult(means=xs_f, covs=Ps_f, pred_means=xs_p,
                        pred_covs=Ps_p, log_likelihood=ll)


def _kalman_filter_batched_vmap(A, C, Q, R, x0s, P0, yss, B=None, uss=None
                                ) -> KalmanResult:
    """Reference path: vmap the full per-trajectory filter (covariance
    recursion replicated N times). Kept for parity testing of the
    shared-covariance fast path below."""
    if uss is None:
        return jax.vmap(
            lambda x0, ys: kalman_filter(A, C, Q, R, x0, P0, ys)
        )(x0s, yss)
    return jax.vmap(
        lambda x0, ys, us: kalman_filter(A, C, Q, R, x0, P0, ys, B=B, us=us)
    )(x0s, yss, uss)


def kalman_filter_batched(A, C, Q, R, x0s, P0, yss, B=None, uss=None,
                          mean_chunk: int = 0) -> KalmanResult:
    """Batched LTI Kalman filter: x0s (N, n), yss (N, T, p), uss (N, T, m).

    Shared-covariance fast path: with A/C/Q/R/P0 shared across the batch
    (this function's signature), the covariance/gain recursion does not
    depend on the data, so P_t, K_t, S_t are IDENTICAL for every
    trajectory. vmapping the full filter (the reference formulation —
    NumPower users would loop eager ops per trajectory,
    /root/reference/src/ndmath/linalg.c:770-1102) replicates that
    recursion N times in (N, n, n) batched small matmuls. Instead:

      1. one scan over T computes gains/covariances ONCE (tiny matrices),
      2. a second scan runs the batched MEAN recurrence — per step two
         (N,n)x(n,n)-shaped GEMMs + the whitened innovation — which is
         pure lane-parallel work XLA fuses into one loop,
      3. shared covariances are broadcast to the (N, T, n, n) result
         shape for API parity with the vmap path.

    Both scans are fully unrolled up to T=128 (capped at 16-way beyond):
    the per-step ops are tiny, so a rolled scan adds per-step loop overhead.

    Exact same algebra as _filter_step (Cholesky-whitened innovation,
    symmetrized covariances); parity asserted in
    tests/test_estimation.py::test_batched_fast_path_matches_vmap.

    mean_chunk=L (opt-in) replaces the sequential mean recurrence with
    chunk-parallel prefix-product recovery (_mean_pass_chunked): fewer
    sequential steps, but extra materialized (L, N, n) intermediates, so
    the default stays sequential. Large L blows up the inverse prefix
    products (4e-2 deviation at L=T=50) — keep chunks <= 16.
    """
    N, T, p = yss.shape
    n = x0s.shape[1]
    dt = x0s.dtype
    if uss is None:
        u_terms = jnp.zeros((N, T, n), dt)
    else:
        if B is None:
            raise ValueError("uss requires B (the input matrix)")
        u_terms = uss @ B.T
    eye_p = jnp.eye(p, dtype=dt)

    def cov_step(P, _):
        P_p = A @ P @ A.T + Q
        P_p = 0.5 * (P_p + P_p.T)
        S = C @ P_p @ C.T + R
        S = 0.5 * (S + S.T)
        L = _chol(S)
        CP = C @ P_p                                   # (p, n)
        W = _chosolve(L, CP)  # (p, n); K = W.T
        P_f = P_p - W.T @ CP
        P_f = 0.5 * (P_f + P_f.T)
        invL = _trisolve(L, eye_p)
        logdet = jnp.sum(jnp.log(jnp.diagonal(L)))
        return P_f, (W, P_p, P_f, invL, logdet)

    unroll = T if T <= 128 else 16
    _, (Ws, P_ps, P_fs, invLs, logdets) = lax.scan(
        cov_step, P0, None, length=T, unroll=unroll)

    ys_t = jnp.swapaxes(yss, 0, 1)          # (T, N, p)
    us_t = jnp.swapaxes(u_terms, 0, 1)      # (T, N, n)
    c0 = jnp.asarray(p * jnp.log(2.0 * jnp.pi), dt)

    if mean_chunk and mean_chunk > 1:
        # the inverse prefix products inside a chunk grow geometrically —
        # measured 4e-2 mean deviation at L=T=50 (docstring); refuse
        # silently-wrong results outside the supported envelope
        if mean_chunk > 16:
            raise ValueError(
                f"mean_chunk={mean_chunk} exceeds the supported envelope "
                f"(<= 16): fp32 inverse prefix products blow up with chunk "
                f"length (measured 4e-2 deviation at L=50)")
        xs_f, xs_p, ll = _mean_pass_chunked(
            A, C, x0s, ys_t, us_t, Ws, invLs, logdets, c0,
            int(mean_chunk))
    else:
        def mean_step(carry, inputs):
            x, ll = carry                    # (N, n), (N,)
            y, u, W, invL, logdet = inputs
            x_p = x @ A.T + u                # (N, n)
            v = y - x_p @ C.T                # (N, p)
            x_f = x_p + v @ W                # v @ (K.T).T == v @ W
            alpha = v @ invL.T               # whitened innovation
            ll = ll - 0.5 * (jnp.sum(alpha * alpha, axis=1) + c0) - logdet
            return (x_f, ll), (x_f, x_p)

        (_, ll), (xs_f, xs_p) = lax.scan(
            mean_step, (x0s, jnp.zeros((N,), dt)),
            (ys_t, us_t, Ws, invLs, logdets), unroll=unroll)

    covs = jnp.broadcast_to(P_fs, (N, T, n, n))
    pred_covs = jnp.broadcast_to(P_ps, (N, T, n, n))
    return KalmanResult(means=jnp.swapaxes(xs_f, 0, 1), covs=covs,
                        pred_means=jnp.swapaxes(xs_p, 0, 1),
                        pred_covs=pred_covs, log_likelihood=ll)


def _mean_pass_chunked(A, C, x0s, ys_t, us_t, Ws, invLs, logdets, c0,
                       L: int):
    """Chunked-parallel batched mean recurrence (kalman_filter_batched
    mean_chunk=L).

    The filtered mean obeys the shared-gain AFFINE recurrence
        x_t = x_{t-1} @ G_t' + c_t,   G_t' = A'(I - C'W_t),
        c_t = u_t (I - C'W_t) + y_t @ W_t,
    so within a chunk of L steps all means are recoverable IN PARALLEL
    from the chunk-anchor state via tiny shared prefix products:
        x_{s+k} = (x_s + sum_{j<=k} c_{s+j} @ P_j^{-1}) @ P_k,
        P_k = G_{s+1}' ... G_{s+k}'.
    That replaces L sequential (N, n) fusions with one batched GEMM + one
    cumsum + one batched GEMM per chunk; only T/L chunk boundaries stay sequential. The
    inverse prefix products grow like (1/spectral_radius)^L, so L is
    kept small (8-16) to bound fp32 blow-up; requires I - C'W_t
    invertible (true whenever the predicted covariance is PD).
    Predictions and the innovation log-likelihood are recovered
    batch-parallel from the full filtered sequence afterwards."""
    N, n = x0s.shape
    T = ys_t.shape[0]
    dt = x0s.dtype
    eye_n = jnp.eye(n, dtype=dt)

    Es = eye_n - jnp.einsum("pi,tpj->tij", C, Ws)        # (T, n, n)
    Gts = jnp.einsum("ij,tjk->tik", A.T, Es)             # G_t' stacks
    cs = jnp.einsum("tni,tij->tnj", us_t, Es) + jnp.einsum(
        "tnp,tpj->tnj", ys_t, Ws)                        # (T, N, n)
    invGts = _solve_small(Gts, jnp.broadcast_to(eye_n, Gts.shape))

    xs_chunks = []
    x = x0s
    for s in range(0, T, L):
        e = min(s + L, T)
        # tiny shared prefix products P_k and their inverses (trace-time
        # loop over the chunk; n x n matmuls)
        P = eye_n
        iP = eye_n
        Ps, iPs = [], []
        for t in range(s, e):
            P = P @ Gts[t]
            iP = invGts[t] @ iP
            Ps.append(P)
            iPs.append(iP)
        P_stack = jnp.stack(Ps)                          # (Lc, n, n)
        iP_stack = jnp.stack(iPs)
        d = jnp.einsum("kni,kij->knj", cs[s:e], iP_stack)
        cum = jnp.cumsum(d, axis=0)
        xs_c = jnp.einsum("kni,kij->knj", x[None] + cum, P_stack)
        xs_chunks.append(xs_c)
        x = xs_c[-1]
    xs_f = jnp.concatenate(xs_chunks, axis=0)            # (T, N, n)

    # batch-parallel prediction + innovation log-likelihood recovery
    x_prev = jnp.concatenate([x0s[None], xs_f[:-1]], axis=0)
    xs_p = jnp.einsum("tni,ji->tnj", x_prev, A) + us_t
    v = ys_t - jnp.einsum("tni,pi->tnp", xs_p, C)
    alpha = jnp.einsum("tnp,tqp->tnq", v, invLs)
    ll = (-0.5 * (jnp.sum(alpha * alpha, axis=(0, 2)) + T * c0)
          - jnp.sum(logdets))
    return xs_f, xs_p, ll


def kalman_smoother(A: jax.Array, filt: KalmanResult) -> SmootherResult:
    """RTS (Rauch-Tung-Striebel) backward smoother over the filter output —
    one reverse scan; gain G = P_f A' P_p^{-1} via a PSD Cholesky solve."""
    xs_f, Ps_f = filt.means, filt.covs
    xs_p, Ps_p = filt.pred_means, filt.pred_covs

    def step(carry, inputs):
        x_s, P_s = carry
        x_f, P_f, x_p_next, P_p_next = inputs
        L = _chol(P_p_next)
        # G = P_f A' P_p^{-1}  ->  G' = P_p^{-1} (A P_f)
        G_T = _chosolve(L, A @ P_f)
        x_new = x_f + G_T.T @ (x_s - x_p_next)
        P_new = P_f + G_T.T @ (P_s - P_p_next) @ G_T
        P_new = 0.5 * (P_new + P_new.T)
        return (x_new, P_new), (x_new, P_new)

    # iterate t = T-2 .. 0, conditioning on step t+1's prediction
    init = (xs_f[-1], Ps_f[-1])
    _, (xs_rev, Ps_rev) = lax.scan(
        step, init,
        (xs_f[:-1][::-1], Ps_f[:-1][::-1], xs_p[1:][::-1], Ps_p[1:][::-1]))
    xs_s = jnp.concatenate([jnp.flip(xs_rev, 0), xs_f[-1][None]], axis=0)
    Ps_s = jnp.concatenate([jnp.flip(Ps_rev, 0), Ps_f[-1][None]], axis=0)
    return SmootherResult(means=xs_s, covs=Ps_s)


def kalman_smoother_batched(A: jax.Array, filt: KalmanResult
                            ) -> SmootherResult:
    """Batched RTS smoother over kalman_filter_batched output: filt.means
    (N, T, n), filt.covs (N, T, n, n) with the covariances SHARED across
    the batch (the kalman_filter_batched contract — A/C/Q/R/P0 common).

    Same structural insight as the batched filter: the smoother gains
    G_t = P_f[t] A' P_p[t+1]^-1 and the smoothed covariances depend only
    on the (shared) filter covariances, so both recursions run ONCE on
    tiny (n, n) matrices; only the mean backward recurrence

        x_s[t] = x_s[t+1] @ G_t' + e_t,  e_t = x_f[t] - x_p[t+1] @ G_t'

    is batched — and e_t is batch-parallel (one einsum), leaving T
    sequential (N, n) affine updates. vmapping kalman_smoother instead
    would replicate the Cholesky/gain recursion N times in (N, n, n)
    batched small factorizations (the reference formulation — NumPower
    users would loop eager ops per trajectory,
    /root/reference/src/ndmath/linalg.c:770-1102).

    Parity asserted in
    tests/test_estimation.py::test_smoother_batched_matches_vmap.
    """
    xs_f = filt.means                       # (N, T, n)
    xs_p = filt.pred_means
    P_fs = filt.covs[0]                     # (T, n, n) shared
    P_ps = filt.pred_covs[0]
    N, T, n = xs_f.shape
    dt = xs_f.dtype
    if T == 1:
        return SmootherResult(means=xs_f, covs=filt.covs)

    # shared gains G_t' = P_p[t+1]^-1 (A P_f[t]) — once, tiny matrices
    def gain(P_f_t, P_p_next):
        L = _chol(P_p_next)
        return _chosolve(L, A @ P_f_t)      # (n, n) = G_t'

    G_Ts = jax.vmap(gain)(P_fs[:-1], P_ps[1:])          # (T-1, n, n)

    # shared smoothed-covariance backward recursion — once
    unroll = T if T <= 128 else 16

    def cov_step(P_s, inputs):
        P_f_t, P_p_next, G_T = inputs
        P_new = P_f_t + G_T.T @ (P_s - P_p_next) @ G_T
        P_new = 0.5 * (P_new + P_new.T)
        return P_new, P_new

    _, Ps_rev = lax.scan(
        cov_step, P_fs[-1],
        (P_fs[:-1][::-1], P_ps[1:][::-1], G_Ts[::-1]), unroll=unroll)
    Ps_s = jnp.concatenate([jnp.flip(Ps_rev, 0), P_fs[-1][None]], axis=0)

    # batched affine terms, computed batch-parallel in one einsum
    xs_p_t = jnp.swapaxes(xs_p, 0, 1)       # (T, N, n)
    xs_f_t = jnp.swapaxes(xs_f, 0, 1)
    es_t = xs_f_t[:-1] - jnp.einsum("tnj,tjk->tnk", xs_p_t[1:], G_Ts)

    def mean_step(x, inputs):
        e, G_T = inputs
        x_new = x @ G_T + e             # (N, n)
        return x_new, x_new

    _, xs_rev = lax.scan(
        mean_step, xs_f_t[-1], (es_t[::-1], G_Ts[::-1]), unroll=unroll)
    xs_s = jnp.concatenate([jnp.flip(xs_rev, 0), xs_f_t[-1][None]], axis=0)

    return SmootherResult(
        means=jnp.swapaxes(xs_s, 0, 1),
        covs=jnp.broadcast_to(Ps_s, (N, T, n, n)))


def kalman_smoother_associative(A: jax.Array, filt: KalmanResult
                                ) -> SmootherResult:
    """Parallel-in-time RTS smoother: O(log T) depth associative scan — the
    backward-pass companion of kalman_filter_associative (same outputs as
    kalman_smoother to fp32 tolerance).

    The RTS recursion is affine in the smoothed moments:
        x_s[k] = G_k x_s[k+1] + e_k,   e_k = x_f[k] - G_k x_p[k+1]
        P_s[k] = G_k P_s[k+1] G_k' + D_k,  D_k = P_f[k] - G_k P_p[k+1] G_k'
    so each step is an element (G, e, D) under the composition
        (G_i, e_i, D_i) o (G_j, e_j, D_j)
          = (G_i G_j, G_i e_j + e_i, G_i D_j G_i' + D_i)
    (i earlier than j), which is associative — one lax.associative_scan over
    the reversed horizon replaces the sequential backward scan (Sarkka & Garcia-Fernandez,
    "Temporal Parallelization of Bayesian Smoothers", IEEE TAC 2021)."""
    xs_f, Ps_f = filt.means, filt.covs
    xs_p, Ps_p = filt.pred_means, filt.pred_covs

    def make_element(x_f, P_f, x_p_next, P_p_next):
        # P_p is PD, so the adjugate solve applies; vmapped
        # jnp.linalg.cholesky would run XLA's slow batched factorization
        # over all T elements (see _solve_small)
        G = _solve_small(P_p_next, A @ P_f).T  # P_f A' P_p^-1
        e = x_f - G @ x_p_next
        D = P_f - G @ P_p_next @ G.T
        return G, e, 0.5 * (D + D.T)

    # elements for k = 0..T-2 (the last state is its own smoothed estimate)
    Gs, es, Ds = jax.vmap(make_element)(xs_f[:-1], Ps_f[:-1], xs_p[1:],
                                        Ps_p[1:])
    # boundary element: the identity-free anchor (G=0 absorbs x_s[T-1])
    n = xs_f.shape[1]
    G_last = jnp.zeros((n, n), xs_f.dtype)
    Gs = jnp.concatenate([Gs, G_last[None]], axis=0)
    es = jnp.concatenate([es, xs_f[-1][None]], axis=0)
    Ds = jnp.concatenate([Ds, Ps_f[-1][None]], axis=0)

    def combine(earlier, later):
        Gi, ei, Di = earlier
        Gj, ej, Dj = later
        G = Gi @ Gj
        e = _mv(Gi, ej) + ei
        D = Gi @ Dj @ Gi.swapaxes(-1, -2) + Di
        return G, e, 0.5 * (D + D.swapaxes(-1, -2))

    # reverse so the scan composes suffixes k..T-1: prefix r of the reversed
    # sequence spans original indices T-1-r..T-1. The scan hands combine
    # (prefix, next) = (later-in-time segment, earlier element), so the
    # functional composition swaps the arguments.
    rev = lambda t: jnp.flip(t, 0)
    _, es_s, Ds_s = lax.associative_scan(
        lambda a, b: combine(b, a), (rev(Gs), rev(es), rev(Ds)), axis=0)
    return SmootherResult(means=rev(es_s), covs=rev(Ds_s))


def ekf_filter(
    f: Callable,         # f(x, u) -> x_next  (pure jax plant, same API as iLQR)
    h: Callable,         # h(x) -> y          (measurement model)
    Q: jax.Array,
    R: jax.Array,
    x0: jax.Array,
    P0: jax.Array,
    ys: jax.Array,       # (T, p)
    us: jax.Array,       # (T, m)
) -> KalmanResult:
    """Extended Kalman filter: per-step jacfwd linearization of f and h
    (models/rollout.linearize — the same Jacobian machinery the iLQR solvers
    use), then the standard predict/update. One scan, jit/vmap-compatible."""

    def step(carry, inputs):
        x, P, ll = carry
        y, u = inputs
        A, _ = linearize(f, x, u)
        x_p = f(x, u)
        P_p = A @ P @ A.T + Q
        P_p = 0.5 * (P_p + P_p.T)
        C = jax.jacfwd(h)(x_p)
        v = y - h(x_p)
        S = C @ P_p @ C.T + R
        S = 0.5 * (S + S.T)
        L = _chol(S)
        CP = C @ P_p
        W = _chosolve(L, CP)
        x_f = x_p + W.T @ v
        P_f = P_p - W.T @ CP
        P_f = 0.5 * (P_f + P_f.T)
        alpha = _trisolve(L, v)
        p = y.shape[0]
        l = -0.5 * (alpha @ alpha + p * jnp.log(2.0 * jnp.pi)) - jnp.sum(
            jnp.log(jnp.diagonal(L)))
        return (x_f, P_f, ll + l), (x_f, P_f, x_p, P_p)

    (_, _, ll), (xs_f, Ps_f, xs_p, Ps_p) = lax.scan(
        step, (x0, P0, jnp.asarray(0.0, x0.dtype)), (ys, us))
    return KalmanResult(means=xs_f, covs=Ps_f, pred_means=xs_p,
                        pred_covs=Ps_p, log_likelihood=ll)


class SqrtKalmanResult(NamedTuple):
    means: jax.Array            # (T, n) filtered means
    chol_covs: jax.Array        # (T, n, n) lower-triangular S with P = S S'
    pred_means: jax.Array       # (T, n) one-step predictions
    pred_chol_covs: jax.Array   # (T, n, n) lower S_p with P_p = S_p S_p'
    log_likelihood: jax.Array   # scalar


def _positive_diag(L):
    """Flip column signs of a (block-)triangular factor so its diagonal is
    positive — QR is unique only up to column signs, and the innovation
    log-det needs log(diag) > 0. Preserves L @ L.T."""
    s = jnp.sign(jnp.diagonal(L))
    s = jnp.where(s == 0, 1.0, s)
    return L * s[None, :]


def _psd_sqrt(M):
    """Square root S with M = S S' for merely-PSD M (eigh-based — Cholesky
    NaNs out on singular inputs like a process noise that only drives some
    states). S is not triangular, but the array algorithm's QR
    re-triangularizes every pre-array, so ANY square root works here."""
    M = 0.5 * (M + M.T)
    w, V = jnp.linalg.eigh(M)
    return V * jnp.sqrt(jnp.clip(w, 0.0, None))[None, :]


def kalman_filter_sqrt(
    A: jax.Array,
    C: jax.Array,
    Q: jax.Array,
    R: jax.Array,
    x0: jax.Array,
    P0: jax.Array,
    ys: jax.Array,       # (T, p)
    B: Optional[jax.Array] = None,
    us: Optional[jax.Array] = None,
) -> SqrtKalmanResult:
    """Square-root (array) Kalman filter: propagates S = chol(P) via QR
    triangularization instead of P itself.

    The fp32-robust form: P = S S' is PSD **by construction** at any
    precision, where the covariance recursion `P - K C P` loses definiteness
    once kappa(P) approaches 1/eps_fp32 (~1.7e7). Condition numbers are also
    halved (kappa(S) = sqrt(kappa(P))). Per step: two small QR
    factorizations instead of the symmetrize-and-hope updates of
    kalman_filter — same means/likelihood to fp32 tolerance (tested), same
    scan structure, jit/vmap-compatible.

    Predict:  qr([S' A'; Sq']) -> R_up,  S_p = fix(R_up)'.
    Update:   qr([[S_p'C', S_p'], [Sr', 0]]) -> post-array
              [[S_y, 0], [Kbar, S_f]] with K = Kbar S_y^{-1} — the
              Kaminski/Grewal condensed array algorithm.

    R must make the innovation covariance C P_p C' + R positive DEFINITE
    (R itself PD is sufficient): a zero diagonal in the innovation factor
    S_y makes the log-likelihood -inf/NaN and the gain solve singular —
    the same failure mode as the covariance-form kalman_filter (this is
    parity, not extra robustness; the sqrt form's robustness is in the
    covariance PROPAGATION, which stays PSD by construction). Model
    degenerate sensors by adding a small diagonal floor to R, as
    models/particle.py requires for its measurement noise.
    """
    T = ys.shape[0]
    n = x0.shape[0]
    p = ys.shape[1]
    dt = x0.dtype
    if us is None:
        u_terms = jnp.zeros((T, n), dt)
    else:
        if B is None:
            raise ValueError("us requires B (the input matrix)")
        u_terms = us @ B.T

    # eigh-based square roots: Q/R/P0 may be PSD-singular (e.g. process
    # noise driving only some states) — Cholesky would emit silent NaNs.
    # The QR pre-arrays only need M = S S', not triangularity.
    Sq = _psd_sqrt(Q)
    Sr = _psd_sqrt(R)
    S0 = _psd_sqrt(P0)
    log2pi = jnp.asarray(jnp.log(2.0 * jnp.pi), dt)

    def step(carry, inputs):
        x, S, ll = carry
        y, u_term = inputs
        # predict
        x_p = A @ x + u_term
        pre_p = jnp.concatenate([S.T @ A.T, Sq.T], axis=0)      # (2n, n)
        S_p = _positive_diag(jnp.linalg.qr(pre_p, mode="r").T)  # (n, n) lower
        # update via one (n+p, p+n) QR
        pre_u = jnp.concatenate([
            jnp.concatenate([S_p.T @ C.T, S_p.T], axis=1),       # (n, p+n)
            jnp.concatenate([Sr.T, jnp.zeros((p, n), dt)], axis=1),  # (p, p+n)
        ], axis=0)
        L = _positive_diag(jnp.linalg.qr(pre_u, mode="r").T)    # (p+n, p+n)
        S_y = L[:p, :p]
        Kbar = L[p:, :p]
        S_f = L[p:, p:]
        v = y - C @ x_p
        alpha = _trisolve(S_y, v)
        x_f = x_p + Kbar @ alpha
        l = -0.5 * (alpha @ alpha + p * log2pi) - jnp.sum(
            jnp.log(jnp.diagonal(S_y)))
        return (x_f, S_f, ll + l), (x_f, S_f, x_p, S_p)

    (_, _, ll), (xs_f, Ss_f, xs_p, Ss_p) = lax.scan(
        step, (x0, S0, jnp.asarray(0.0, dt)), (ys, u_terms))
    return SqrtKalmanResult(means=xs_f, chol_covs=Ss_f, pred_means=xs_p,
                            pred_chol_covs=Ss_p, log_likelihood=ll)


def kalman_filter_sqrt_batched(A, C, Q, R, x0s, P0, yss, B=None, uss=None
                               ) -> SqrtKalmanResult:
    """Batched square-root filter with SHARED A/C/Q/R/P0: the S = chol(P)
    array recursion is data-independent, so it runs ONCE (T small QRs) and
    only the mean/likelihood recurrence is batched — the same fast-path
    structure as kalman_filter_batched, with the fp32-robust covariance
    propagation of kalman_filter_sqrt. The per-step gains feed the same
    affine mean recurrence (x_f = x_p + v @ W with W = (Kbar S_y^{-1})',
    whitening invL = S_y^{-1}). Parity vs the vmapped kalman_filter_sqrt
    asserted in tests."""
    N, T, p = yss.shape
    n = x0s.shape[1]
    dt = x0s.dtype
    if uss is None:
        u_terms = jnp.zeros((N, T, n), dt)
    else:
        if B is None:
            raise ValueError("uss requires B (the input matrix)")
        u_terms = uss @ B.T

    Sq = _psd_sqrt(Q)
    Sr = _psd_sqrt(R)
    S0 = _psd_sqrt(P0)
    eye_p = jnp.eye(p, dtype=dt)

    def cov_step(S, _):
        pre_p = jnp.concatenate([S.T @ A.T, Sq.T], axis=0)
        S_p = _positive_diag(jnp.linalg.qr(pre_p, mode="r").T)
        pre_u = jnp.concatenate([
            jnp.concatenate([S_p.T @ C.T, S_p.T], axis=1),
            jnp.concatenate([Sr.T, jnp.zeros((p, n), dt)], axis=1),
        ], axis=0)
        L = _positive_diag(jnp.linalg.qr(pre_u, mode="r").T)
        S_y = L[:p, :p]
        Kbar = L[p:, :p]
        S_f = L[p:, p:]
        invSy = _trisolve(S_y, eye_p)                  # S_y^{-1} (p, p)
        W = (Kbar @ invSy).T                           # (p, n)
        logdet = jnp.sum(jnp.log(jnp.diagonal(S_y)))
        return S_f, (W, invSy, logdet, S_f, S_p)

    unroll = T if T <= 128 else 16
    _, (Ws, invLs, logdets, Ss_f, Ss_p) = lax.scan(
        cov_step, S0, None, length=T, unroll=unroll)

    ys_t = jnp.swapaxes(yss, 0, 1)
    us_t = jnp.swapaxes(u_terms, 0, 1)
    c0 = jnp.asarray(p * jnp.log(2.0 * jnp.pi), dt)

    def mean_step(carry, inputs):
        x, ll = carry
        y, u, W, invL, logdet = inputs
        x_p = x @ A.T + u
        v = y - x_p @ C.T
        x_f = x_p + v @ W
        alpha = v @ invL.T
        ll = ll - 0.5 * (jnp.sum(alpha * alpha, axis=1) + c0) - logdet
        return (x_f, ll), (x_f, x_p)

    (_, ll), (xs_f, xs_p) = lax.scan(
        mean_step, (x0s, jnp.zeros((N,), dt)),
        (ys_t, us_t, Ws, invLs, logdets), unroll=unroll)

    return SqrtKalmanResult(
        means=jnp.swapaxes(xs_f, 0, 1),
        chol_covs=jnp.broadcast_to(Ss_f, (N, T, n, n)),
        pred_means=jnp.swapaxes(xs_p, 0, 1),
        pred_chol_covs=jnp.broadcast_to(Ss_p, (N, T, n, n)),
        log_likelihood=ll)


class _KFElement(NamedTuple):
    """Parallel-filter element (Sarkka & Garcia-Fernandez,
    "Temporal Parallelization of Bayesian Smoothers", IEEE TAC 2021): represents
    p(x_k | y_..., x_{k-1}) ~ N(A x_{k-1} + b, C) with information terms
    (eta, J) carrying the likelihood backward."""
    A: jax.Array
    b: jax.Array
    C: jax.Array
    eta: jax.Array
    J: jax.Array


def _mv(M, v):
    """Batch-safe matrix-vector product (associative_scan passes elements
    with an extra leading dim, where plain `@` misreads (B, n) as a matrix)."""
    return (M @ v[..., None])[..., 0]


from numpower_tpu.utils.smallmat import solve_small as _solve_small


def _kf_combine(ei: _KFElement, ej: _KFElement,
                solve=None) -> _KFElement:
    """Combine earlier element i with later element j (associative).

    solve: denominator solver (default utils/smallmat.solve_small);
    lu_solve_nopivot is usable here for well-conditioned chains — both
    denominators I + C_i J_j and I + J_j C_i have PSD factors so their
    EIGENVALUES stay >= 1, but unpivoted elimination pivots are not
    eigenvalues and can still underflow on ill-conditioned inputs
    (advisor r4; see lu_solve_nopivot's envelope)."""
    if solve is None:
        solve = _solve_small
    n = ei.A.shape[-1]
    I = jnp.eye(n, dtype=ei.A.dtype)
    # denom = I + C_i J_j; one solve reused for the A/b/C updates
    rhs = jnp.concatenate(
        [ei.A, ei.C, (ei.b + _mv(ei.C, ej.eta))[..., None]], axis=-1)
    M = solve(I + ei.C @ ej.J, rhs)
    MA, MC, Mb = M[..., :n], M[..., n:2 * n], M[..., 2 * n]
    A = ej.A @ MA
    b = _mv(ej.A, Mb) + ej.b
    C = ej.A @ MC @ ej.A.swapaxes(-1, -2) + ej.C
    # (I + J_j C_i)^{-1} applied to [eta_j - J_j b_i, J_j A_i]
    rhs2 = jnp.concatenate(
        [(ej.eta - _mv(ej.J, ei.b))[..., None], ej.J @ ei.A], axis=-1)
    M2 = solve(I + ej.J @ ei.C, rhs2)
    AiT = ei.A.swapaxes(-1, -2)
    eta = _mv(AiT, M2[..., 0]) + ei.eta
    J = AiT @ M2[..., 1:] + ei.J
    C = 0.5 * (C + C.swapaxes(-1, -2))
    J = 0.5 * (J + J.swapaxes(-1, -2))
    return _KFElement(A, b, C, eta, J)


def _kf_u_terms(dt, T, n, B, us):
    if us is None:
        return jnp.zeros((T, n), dt)
    if B is None:
        raise ValueError("us requires B (the input matrix)")
    return us @ B.T


def _kf_build_elements(A, C, Q, R, x0, P0, ys, cs):
    """Per-stage _KFElements for the associative filter: generic elements
    update against the process-noise prior; the FIRST element absorbs the
    (x0, P0) prior. Shared by kalman_filter_associative and the
    horizon-sharded parallel/kalman_sp.py."""
    n = x0.shape[0]
    dt = x0.dtype

    # generic element (k >= 2): update vs the PROCESS noise prior
    S = C @ Q @ C.T + R
    Ls = _chol(0.5 * (S + S.T))
    K = _chosolve(Ls, C @ Q).T     # Q C' S^-1
    IKC = jnp.eye(n, dtype=dt) - K @ C
    A_g = IKC @ A
    C_g = 0.5 * ((IKC @ Q) + (IKC @ Q).T)
    HtSinv = _chosolve(Ls, C).T    # C' S^-1  (n, p)
    J_g = A.T @ HtSinv @ C @ A
    J_g = 0.5 * (J_g + J_g.T)

    def make_generic(y, c):
        return _KFElement(
            A=A_g,
            b=K @ y + IKC @ c,
            C=C_g,
            eta=A.T @ (HtSinv @ (y - C @ c)),
            J=J_g,
        )

    elems = jax.vmap(make_generic)(ys, cs)

    # first element absorbs the prior (predict from (x0, P0), update on y_1)
    x1p = A @ x0 + cs[0]
    P1p = A @ P0 @ A.T + Q
    S1 = C @ P1p @ C.T + R
    L1 = _chol(0.5 * (S1 + S1.T))
    K1 = _chosolve(L1, C @ P1p).T
    C1 = (jnp.eye(n, dtype=dt) - K1 @ C) @ P1p
    first = _KFElement(
        A=jnp.zeros((n, n), dt),
        b=x1p + K1 @ (ys[0] - C @ x1p),
        C=0.5 * (C1 + C1.T),
        eta=jnp.zeros((n,), dt),
        J=jnp.zeros((n, n), dt),
    )
    return jax.tree_util.tree_map(
        lambda f, e: jnp.concatenate([f[None], e[1:]], axis=0), first, elems)


def _kf_predict_ll(A, C, Q, R, x_prev, P_prev, y, c):
    """One-step prediction + innovation log-density from the filtered
    previous state (the trailing recovery pass of the associative filter)."""
    p = y.shape[-1]
    x_p = A @ x_prev + c
    P_p = A @ P_prev @ A.T + Q
    P_p = 0.5 * (P_p + P_p.T)
    Sk = C @ P_p @ C.T + R
    Lk = _chol(0.5 * (Sk + Sk.T))
    v = y - C @ x_p
    alpha = _trisolve(Lk, v)
    ll = -0.5 * (alpha @ alpha + p * jnp.log(2.0 * jnp.pi)) - jnp.sum(
        jnp.log(jnp.diagonal(Lk)))
    return x_p, P_p, ll


def kalman_filter_associative(
    A: jax.Array,
    C: jax.Array,
    Q: jax.Array,
    R: jax.Array,
    x0: jax.Array,
    P0: jax.Array,
    ys: jax.Array,
    B: Optional[jax.Array] = None,
    us: Optional[jax.Array] = None,
    nopivot: bool = False,
) -> KalmanResult:
    """Parallel-in-time Kalman filter: O(log T) depth associative scan.

    Same outputs as kalman_filter (fp32 tolerance) — the SP analogue of
    models/lqr.riccati_associative, for long horizons (T >= ~128) or
    time-sharded execution. Per-step elements are built with vmap, the
    prefix composition runs as lax.associative_scan, and prediction/
    log-likelihood are recovered with one trailing vmap.

    nopivot=True routes the combine denominators through the unpivoted
    unrolled LU (fusion-friendly) — an OPT-IN lever for
    well-conditioned chains only: PSD factors bound the denominator's
    eigenvalues, not its unpivoted pivots, and ill-conditioned inputs
    can NaN or lose digits (advisor r4; lu_solve_nopivot's docstring has
    the measured envelope). The default pivoted solver handles any
    invertible denominator. n <= 3 systems use the adjugate either way.
    """
    T, p = ys.shape
    n = x0.shape[0]
    dt = x0.dtype
    cs = _kf_u_terms(x0.dtype, T, n, B, us)
    elems = _kf_build_elements(A, C, Q, R, x0, P0, ys, cs)

    solve = None
    if nopivot:
        from numpower_tpu.utils.smallmat import lu_solve_nopivot as solve

    combined = lax.associative_scan(
        lambda earlier, later: _kf_combine(
            _KFElement(*earlier), _KFElement(*later), solve=solve),
        tuple(elems), axis=0)
    xs_f = combined[1]   # b of the prefix = filtered means
    Ps_f = combined[2]   # C of the prefix = filtered covariances

    # predictions + innovation log-likelihood from the filtered sequence
    xs_prev = jnp.concatenate([x0[None], xs_f[:-1]], axis=0)
    Ps_prev = jnp.concatenate([P0[None], Ps_f[:-1]], axis=0)
    xs_p, Ps_p, lls = jax.vmap(
        lambda x_prev, P_prev, y, c: _kf_predict_ll(
            A, C, Q, R, x_prev, P_prev, y, c))(xs_prev, Ps_prev, ys, cs)
    return KalmanResult(means=xs_f, covs=Ps_f, pred_means=xs_p,
                        pred_covs=Ps_p, log_likelihood=jnp.sum(lls))


def ekf_filter_batched(
    f: Callable,
    h: Callable,
    Q: jax.Array,
    R: jax.Array,
    x0s: jax.Array,      # (B, n)
    P0: jax.Array,       # (n, n) shared prior
    yss: jax.Array,      # (B, T, p)
    uss: jax.Array,      # (B, T, m)
) -> KalmanResult:
    """Batched EKF over B trajectories: ekf_filter vmapped over the batch."""
    return jax.vmap(
        lambda x0, ys, us: ekf_filter(f, h, Q, R, x0, P0, ys, us)
    )(x0s, yss, uss)


def ukf_filter_batched(
    f: Callable,
    h: Callable,
    Q: jax.Array,
    R: jax.Array,
    x0s: jax.Array,      # (B, n)
    P0: jax.Array,       # (n, n) shared prior
    yss: jax.Array,      # (B, T, p)
    uss: jax.Array,      # (B, T, m)
    alpha: float = 1.0,
    beta: float = 2.0,
    kappa: float = 0.0,
) -> KalmanResult:
    """Batched UKF over B trajectories: ukf_filter vmapped over the batch."""
    return jax.vmap(
        lambda x0, ys, us: ukf_filter(f, h, Q, R, x0, P0, ys, us,
                                      alpha=alpha, beta=beta, kappa=kappa)
    )(x0s, yss, uss)


def ukf_filter(
    f: Callable,
    h: Callable,
    Q: jax.Array,
    R: jax.Array,
    x0: jax.Array,
    P0: jax.Array,
    ys: jax.Array,       # (T, p)
    us: jax.Array,       # (T, m)
    alpha: float = 1.0,
    beta: float = 2.0,
    kappa: float = 0.0,
) -> KalmanResult:
    """Unscented Kalman filter (Wan-Merwe sigma points).

    Derivative-free alternative to ekf_filter for plants where
    linearization is poor or f is not smooth: 2n+1 sigma points propagate
    through f/h exactly (vmapped — one batched plant eval per step), means/covariances reconstruct from weighted sums. Defaults
    alpha=1, kappa=0 (lambda=0, the cubature-style spread) are fp32-robust;
    the unscented transform is EXACT for linear f/h, so on LTI plants this
    reproduces kalman_filter (tested). Same scan structure and
    log-likelihood as the other filters.
    """
    n = x0.shape[0]
    dt = x0.dtype
    lam = alpha * alpha * (n + kappa) - n
    c = n + lam
    wm = jnp.concatenate([
        jnp.array([lam / c], dt), jnp.full((2 * n,), 0.5 / c, dt)])
    wc = wm.at[0].add(1.0 - alpha * alpha + beta)

    def sigma_points(x, P):
        S = _chol(c * (0.5 * (P + P.T))
                                + 1e-9 * jnp.eye(n, dtype=dt))
        return jnp.concatenate([x[None], x + S.T, x - S.T], axis=0)  # (2n+1, n)

    def step(carry, inputs):
        x, P, ll = carry
        y, u = inputs
        # predict: propagate sigma points through f
        pts = sigma_points(x, P)
        pts_f = jax.vmap(lambda s: f(s, u))(pts)
        x_p = wm @ pts_f
        dX = pts_f - x_p
        P_p = (wc[:, None] * dX).T @ dX + Q
        P_p = 0.5 * (P_p + P_p.T)
        # update: re-draw sigma points from the predicted density
        pts2 = sigma_points(x_p, P_p)
        pts_h = jax.vmap(h)(pts2)
        y_p = wm @ pts_h
        dY = pts_h - y_p
        S = (wc[:, None] * dY).T @ dY + R
        S = 0.5 * (S + S.T)
        Pxy = (wc[:, None] * (pts2 - x_p)).T @ dY
        L = _chol(S)
        # K = Pxy S^{-1}  ->  K' = S^{-1} Pxy'
        K_T = _chosolve(L, Pxy.T)
        v = y - y_p
        x_f = x_p + K_T.T @ v
        P_f = P_p - K_T.T @ S @ K_T
        P_f = 0.5 * (P_f + P_f.T)
        alpha_w = _trisolve(L, v)
        p = y.shape[0]
        l = -0.5 * (alpha_w @ alpha_w + p * jnp.log(2.0 * jnp.pi)) - jnp.sum(
            jnp.log(jnp.diagonal(L)))
        return (x_f, P_f, ll + l), (x_f, P_f, x_p, P_p)

    (_, _, ll), (xs_f, Ps_f, xs_p, Ps_p) = lax.scan(
        step, (x0, P0, jnp.asarray(0.0, dt)), (ys, us))
    return KalmanResult(means=xs_f, covs=Ps_f, pred_means=xs_p,
                        pred_covs=Ps_p, log_likelihood=ll)
