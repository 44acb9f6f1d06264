"""Particle filter (sequential Monte Carlo) — the non-Gaussian member of the
estimation family (estimation.py: KF / sqrt-KF / EKF / UKF / associative KF).

Completes the estimator lineup for plants where even the unscented transform
is wrong — multimodal posteriors, hard nonlinearities, non-Gaussian noise.
The reference's op surface (matmul/cholesky/solve, SURVEY.md §2.3) composed
into one static-shape program:

  - the whole filter is ONE lax.scan with static shapes: the particle cloud
    (N, n) propagates as a single vmapped plant eval per step (exactly the
    mppi.py rollout pattern)
  - systematic resampling is sort-free: cumsum + searchsorted + gather —
    O(N log N) comparisons, no data-dependent shapes
  - resampling triggers on effective sample size (ESS) via lax.cond; under
    vmap it lowers to a select, keeping the batched filter a single program
  - log-likelihood accumulates as logsumexp increments in the carry (same
    system-ID use as KalmanResult.log_likelihood)

Noise model: x' = f(x, u) + w, w ~ N(0, Q); y = h(x) + v, v ~ N(0, R) —
the same (f, h, Q, R) signature as ekf_filter/ukf_filter, so the filters are
drop-in interchangeable. Draws use keyed jax.random (the framework's RNG
design — ops/random.py replaces the reference's unseedable rand(),
/root/reference/src/initializers.c:517-590).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax


class ParticleFilterResult(NamedTuple):
    means: jax.Array           # (T, n) posterior means E[x_t | y_1..t]
    covs: jax.Array            # (T, n, n) posterior covariances
    ess: jax.Array             # (T,) effective sample size per step
    log_likelihood: jax.Array  # scalar log p(y_1..T)
    particles: jax.Array       # (N, n) final particle cloud
    log_weights: jax.Array     # (N,) final normalized log-weights


def _resample_slots(key, logw, N: int):
    """Integer slot boundaries of systematic resampling: particle j owns
    output slots [m_{j-1}, m_j) with m_j = clip(floor(N cum_j - u0) + 1,
    0, N) — exactly the searchsorted(cum, (i + u0)/N) assignment
    (element-exact, asserted by bench.py --verify pf_resampling_indices)."""
    w = jnp.exp(logw - jax.scipy.special.logsumexp(logw))
    u0 = jax.random.uniform(key, (), w.dtype)
    cum = jnp.cumsum(w)
    cum = cum / cum[-1]  # exact 1.0 endpoint under fp32
    return jnp.clip(jnp.floor(N * cum - u0).astype(jnp.int32) + 1, 0, N)


# Above this particle count the O(N^2) one-hot contraction gives way to the
# O(N) scatter+gather construction (see _systematic_resample). The crossover
# has not been measured on a GPU yet.
RESAMPLE_ONEHOT_MAX_N = 8192


def _systematic_resample(key, parts, logw, method: str = "auto"):
    """Systematic resampling: one uniform offset, N evenly spaced positions
    through the CDF — lower conditional variance than multinomial and fully
    static-shaped.

    Formulation: the resampled cloud is ONE one-hot matmul —
    out[i] = sum_j 1[m_{j-1} <= i < m_j] p[j] — built from pure broadcast
    comparisons on the integer slot boundaries: no scatter, no gather, no
    index vector under vmap. The slot math is integer-identical to
    searchsorted resampling.

    ENVELOPE: the one-hot contraction is O(N^2 n) work — quadratic in the
    particle count — while the scatter+gather construction is ~O(N) with a
    larger constant. method="auto" uses the one-hot through
    N <= RESAMPLE_ONEHOT_MAX_N and the gather construction past it;
    "onehot"/"gather" force a path."""
    N = parts.shape[0]
    m = _resample_slots(key, logw, N)
    if method == "auto":
        method = "onehot" if N <= RESAMPLE_ONEHOT_MAX_N else "gather"
    uniform = jnp.full((N,), -jnp.log(jnp.asarray(N, logw.dtype)))
    if method == "gather":
        # r3 construction: scatter-add a 1 at each particle's first output
        # slot (particles with zero slots collapse onto the next start and
        # accumulate), cumsum-1 gives the monotone source index, then one
        # gather. O(N) work; the batched gather's lowering constant is what
        # the one-hot beats at small N.
        m_prev = jnp.concatenate([jnp.zeros((1,), m.dtype), m[:-1]])
        hits = jnp.zeros((N,), jnp.int32).at[m_prev].add(1, mode="drop")
        idx = jnp.cumsum(hits) - 1
        return parts[idx], uniform
    m_prev = jnp.concatenate([jnp.zeros((1,), m.dtype), m[:-1]])
    i_idx = jnp.arange(N)
    oh = jnp.logical_and(i_idx[:, None] >= m_prev[None, :],
                         i_idx[:, None] < m[None, :])
    new_parts = oh.astype(parts.dtype) @ parts
    return new_parts, uniform


def particle_filter(
    f: Callable,          # f(x, u) -> x_next (pure jax plant, iLQR/EKF API)
    h: Callable,          # h(x) -> y
    Q: jax.Array,         # (n, n) process noise cov
    R: jax.Array,         # (p, p) measurement noise cov
    x0: jax.Array,        # (n,) prior mean
    P0: jax.Array,        # (n, n) prior cov
    ys: jax.Array,        # (T, p) measurements
    us: jax.Array,        # (T, m) known inputs
    key: jax.Array,       # jax.random key
    n_particles: int = 1024,
    resample_threshold: float = 0.5,
    resample_method: str = "auto",
) -> ParticleFilterResult:
    """Bootstrap particle filter. Resamples (systematic) when
    ESS < resample_threshold * n_particles; threshold 1.0 forces every step,
    0.0 never resamples. jit-compatible (static n_particles); vmap over
    (x0, ys, us, key) for batched trajectories. resample_method:
    "auto" (one-hot contraction up to RESAMPLE_ONEHOT_MAX_N particles,
    gather past it — see _systematic_resample's envelope), "onehot", or
    "gather"."""
    n = x0.shape[0]
    p = ys.shape[1]
    dt = x0.dtype
    N = int(n_particles)

    # Q/P0 only scale noise draws — any square root works, and eigh-based
    # sqrt tolerates PSD-singular inputs (noise driving only some states).
    # R must be strictly PD: the Gaussian observation density whitens with
    # a triangular solve against chol(R) (a singular R makes the density
    # itself degenerate).
    from numpower_tpu.models.estimation import _psd_sqrt

    L0 = _psd_sqrt(P0)
    Lq = _psd_sqrt(Q)
    Lr = jnp.linalg.cholesky(0.5 * (R + R.T))
    log_norm = (-jnp.sum(jnp.log(jnp.diagonal(Lr)))
                - 0.5 * p * jnp.log(2.0 * jnp.pi)).astype(dt)
    thr = jnp.asarray(resample_threshold * N, dt)

    key, k_init = jax.random.split(key)
    parts0 = x0 + jax.random.normal(k_init, (N, n), dt) @ L0.T
    logw0 = jnp.full((N,), -jnp.log(jnp.asarray(N, dt)))

    def step(carry, inputs):
        parts, logw, ll, key = carry
        y, u = inputs
        key, k_prop, k_res = jax.random.split(key, 3)
        # propagate through the plant + process noise (one batched eval)
        parts = jax.vmap(lambda s: f(s, u))(parts) + (
            jax.random.normal(k_prop, (N, n), dt) @ Lq.T)
        # Gaussian observation log-density, Cholesky-whitened
        v = y - jax.vmap(h)(parts)                              # (N, p)
        alpha = jax.scipy.linalg.solve_triangular(Lr, v.T, lower=True)
        logp = log_norm - 0.5 * jnp.sum(alpha * alpha, axis=0)  # (N,)
        # likelihood increment log sum_i w_i p(y | x_i), then renormalize
        inc = jax.scipy.special.logsumexp(logw + logp)
        logw = logw + logp - inc
        w = jnp.exp(logw)
        ess = 1.0 / jnp.sum(w * w)
        mean = w @ parts
        d = parts - mean
        cov = (w[:, None] * d).T @ d
        parts, logw = lax.cond(
            ess < thr,
            lambda a: _systematic_resample(k_res, *a,
                                           method=resample_method),
            lambda a: a,
            (parts, logw),
        )
        return (parts, logw, ll + inc, key), (mean, cov, ess)

    (parts, logw, ll, _), (means, covs, esss) = lax.scan(
        step, (parts0, logw0, jnp.asarray(0.0, dt), key), (ys, us))
    return ParticleFilterResult(means=means, covs=covs, ess=esss,
                                log_likelihood=ll, particles=parts,
                                log_weights=logw)


def particle_filter_batched(
    f: Callable, h: Callable, Q: jax.Array, R: jax.Array,
    x0s: jax.Array,       # (B, n)
    P0: jax.Array,
    yss: jax.Array,       # (B, T, p)
    uss: jax.Array,       # (B, T, m)
    key: jax.Array,
    n_particles: int = 1024,
    resample_threshold: float = 0.5,
    resample_method: str = "auto",
) -> ParticleFilterResult:
    """vmap over trajectories with independent per-trajectory key streams."""
    keys = jax.random.split(key, x0s.shape[0])
    return jax.vmap(
        lambda x0, ys, us, k: particle_filter(
            f, h, Q, R, x0, P0, ys, us, k,
            n_particles=n_particles, resample_threshold=resample_threshold,
            resample_method=resample_method)
    )(x0s, yss, uss, keys)
