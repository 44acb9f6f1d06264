"""Horizon-sharded parallel-in-time Kalman filter (multi-device SP).

The estimation-side companion of parallel/riccati_sp.py (SURVEY.md §2.5
SP row): models/estimation.kalman_filter_associative parallelizes time
WITHIN a device; this module shards the measurement horizon ACROSS the
mesh — for trajectories long enough that one device's scan latency or
its (T, n, ...) element stack dominates.

Blelloch-style two-level PREFIX scan over the conditional-density
elements (A, b, C, eta, J) of models/estimation.py (Sarkka &
Garcia-Fernandez, IEEE TAC 2021):

  1. local:  each device builds its block's elements from its ys shard
             and runs the O(log blk) forward associative scan -> local
             prefixes + the block total,
  2. global: block totals are all_gather'ed (D tiny element
             tuples) and every device folds the totals of EARLIER blocks
             into its before-block prefix P_d,
  3. apply:  _kf_combine(P_d, local prefix) gives the exact global
             prefix -> filtered (x_t, P_t); prediction moments and the
             innovation log-likelihood are recovered stage-locally (the
             block boundary state is P_d's (b, C)) and the masked ll
             contributions are psum'd over the axis.

Ragged T is handled like riccati_sp: the horizon is FRONT-padded with
combine-identity elements (A=I, b=0, C=0, eta=0, J=0) whose prefix is a
no-op, and padded outputs are sliced away; their ll contributions are
masked to zero by global stage index.

Cross-device traffic: ONE all_gather of D*(2n^2 + n(n+1)) floats per
solve — ~120 KB at n=12, D=64.

Reference parity: the reference has no distributed execution at all
(SURVEY.md §2.5); its users hand-roll sequential filters over
nd::matmul/cholesky/solve (/root/reference/src/ndmath/linalg.c:981-1102).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax, shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from numpower_tpu.models.estimation import (
    KalmanResult, _KFElement, _kf_build_elements, _kf_combine,
    _kf_predict_ll, _kf_u_terms,
)


def kalman_filter_associative_sharded(A, C, Q, R, x0, P0, ys, mesh: Mesh,
                                      B=None, us=None, axis: str = "model"
                                      ) -> KalmanResult:
    """Kalman filter with the T-step horizon sharded over `axis`.

    Returns the same KalmanResult as models/estimation.kalman_filter
    (fp32 tolerance). ANY horizon T is accepted (front padding with
    combine-identity elements when T % D != 0).
    """
    D = mesh.shape[axis]
    T, p = ys.shape
    n = x0.shape[0]
    dt = x0.dtype
    blk = -(-T // D)
    T_pad = blk * D
    pad = T_pad - T

    cs = _kf_u_terms(dt, T, n, B, us)
    elems = _kf_build_elements(A, C, Q, R, x0, P0, ys, cs)

    eye = jnp.eye(n, dtype=dt)
    ident = _KFElement(A=eye, b=jnp.zeros((n,), dt),
                       C=jnp.zeros((n, n), dt), eta=jnp.zeros((n,), dt),
                       J=jnp.zeros((n, n), dt))
    if pad:
        elems = jax.tree_util.tree_map(
            lambda i, e: jnp.concatenate(
                [jnp.broadcast_to(i, (pad,) + i.shape), e], axis=0),
            ident, elems)
    # ys/cs padded too (recovery inputs); padded stages' ll is masked off
    ys_pad = jnp.concatenate([jnp.zeros((pad, p), dt), ys], axis=0)
    cs_pad = jnp.concatenate([jnp.zeros((pad, n), dt), cs], axis=0)

    def per_device(eA, eb, eC, eeta, eJ, ys_b, cs_b,
                   A_r, C_r, Q_r, R_r, x0_r, P0_r):
        dev = lax.axis_index(axis)
        # combine identity rebuilt INSIDE the traced body (cheap trace-time
        # constants) — closure-capturing the eager `ident` device arrays
        # would fetch them D2H at lowering time
        ident_l = _KFElement(A=jnp.eye(n, dtype=dt), b=jnp.zeros((n,), dt),
                             C=jnp.zeros((n, n), dt), eta=jnp.zeros((n,), dt),
                             J=jnp.zeros((n, n), dt))

        # (1) local forward prefix scan over this device's block
        local = lax.associative_scan(
            lambda earlier, later: tuple(_kf_combine(
                _KFElement(*earlier), _KFElement(*later))),
            (eA, eb, eC, eeta, eJ), axis=0)
        total = _KFElement(*(t[-1] for t in local))

        # (2) gather block totals; fold EARLIER blocks into prefix P_d
        tots = [lax.all_gather(t, axis) for t in total]   # each (D, ...)
        Pfx = ident_l
        for b_i in range(D):                 # static unroll, D is small
            cand = _kf_combine(
                Pfx, _KFElement(*(t[b_i] for t in tots)))
            take = b_i < dev
            Pfx = _KFElement(*(jnp.where(take, c, s)
                               for c, s in zip(cand, Pfx)))

        # (3) exact global prefix for every local stage
        glob = jax.vmap(lambda *e: tuple(_kf_combine(
            Pfx, _KFElement(*e))))(*local)
        xs_f, Ps_f = glob[1], glob[2]        # (blk, n), (blk, n, n)

        # (4) stage-local recovery: boundary prev state comes from P_d;
        # the FIRST REAL stage (global index == pad, anywhere in the
        # padded leading block(s)) predicts from the true prior (x0, P0) —
        # its scan-side prefix is the identity padding, whose (b, C) are
        # zeros, not the prior
        xs_prev = jnp.concatenate([Pfx.b[None], xs_f[:-1]], axis=0)
        Ps_prev = jnp.concatenate([Pfx.C[None], Ps_f[:-1]], axis=0)
        gidx = dev * blk + jnp.arange(blk)
        at_first_real = gidx == pad
        xs_prev = jnp.where(at_first_real[:, None], x0_r, xs_prev)
        Ps_prev = jnp.where(at_first_real[:, None, None], P0_r, Ps_prev)
        xs_p, Ps_p, lls = jax.vmap(
            lambda x_prev, P_prev, y, c: _kf_predict_ll(
                A_r, C_r, Q_r, R_r, x_prev, P_prev, y, c)
        )(xs_prev, Ps_prev, ys_b, cs_b)

        # mask padded stages out of the likelihood (global index < pad)
        ll_local = jnp.sum(jnp.where(gidx >= pad, lls, 0.0))
        ll = lax.psum(ll_local, axis)
        return xs_f, Ps_f, xs_p, Ps_p, ll

    mapped = shard_map(
        per_device,
        mesh=mesh,
        in_specs=(P(axis),) * 7 + (P(),) * 6,
        out_specs=(P(axis), P(axis), P(axis), P(axis), P()),
    )
    # place shards/replicas up front (riccati_sp.py pattern: avoids the
    # SPMD partitioner's involuntary full rematerialization)
    shard_spec = NamedSharding(mesh, P(axis))
    repl = NamedSharding(mesh, P())
    sharded = [jax.device_put(x, shard_spec)
               for x in (*elems, ys_pad, cs_pad)]
    replicated = [jax.device_put(jnp.asarray(x), repl)
                  for x in (A, C, Q, R, x0, P0)]
    xs_f, Ps_f, xs_p, Ps_p, ll = jax.jit(mapped)(*sharded, *replicated)
    return KalmanResult(means=xs_f[pad:], covs=Ps_f[pad:],
                        pred_means=xs_p[pad:], pred_covs=Ps_p[pad:],
                        log_likelihood=ll)
