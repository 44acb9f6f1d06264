#!/usr/bin/env python
"""Benchmark harness.

Headline metric (BASELINE.json): MPC solves/s for the 4096-scenario
horizon-30 quadrotor box-constrained QP (config #4). The LAST stdout line is
a compact JSON summary:

    {"metric": ..., "value": N, "unit": ..., "vs_baseline": N,
     "device": {...}, "rows_file": ...}

and the full payload (every section row) is written to CERTIFY.json at the
repo root (not committed). vs_baseline is value / 10_000 (the BASELINE
north-star target; the reference itself publishes no numbers — BASELINE.md).
A section that fails makes the run exit non-zero.

Details (all configs, latency percentiles) go to stderr. `--full` runs every
BASELINE config; `--quick` shrinks shapes for CPU smoke tests.

On the GPU: `python bench.py` (one process owns the card).
"""

from __future__ import annotations

import argparse
import faulthandler
import json
import os
import signal
import sys
import time

import numpy as np

# kill -USR1 <pid> dumps all thread stacks to stderr (hang diagnosis).
faulthandler.register(signal.SIGUSR1, all_threads=True)


# Full payload of the last run (listed in .gitignore).
CERTIFY_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "CERTIFY.json")


def _log(*a):
    print(*a, file=sys.stderr, flush=True)


def _readback(out):
    """Force completion by fetching one scalar to the host."""
    import jax

    leaf = jax.tree_util.tree_leaves(out)[0]
    return float(leaf.ravel()[0])


def _device_time_per_call(body_fn, args, K: int = 64, reps: int = 5,
                          return_stats: bool = False):
    """Device seconds per body invocation: run K data-dependent body
    iterations inside ONE jitted scan (single dispatch), subtract the no-op
    scan baseline (dispatch plus readback), divide by K.

    >=5 in-process repeats; returns the MEDIAN per-call time, and with
    return_stats=True also the IQR."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    def make_rep(fn):
        @jax.jit
        def rep(*a):
            def body(acc, i):
                return acc + fn(*a, i), None

            acc, _ = lax.scan(body, jnp.float32(0.0), jnp.arange(K, dtype=jnp.float32))
            return acc

        return rep

    n = max(int(reps), 5)

    rep_base = make_rep(lambda *a: a[-1])
    rep_body = make_rep(body_fn)
    # compile + warm both
    float(jax.device_get(rep_base(*args)))
    float(jax.device_get(rep_body(*args)))

    # Interleave baseline/body sampling so drift hits both streams, and
    # subtract MEDIANS, not pairs, so one slow rep cannot flip a sign.
    base_ts, body_ts = [], []
    for _ in range(n):
        t = time.perf_counter()
        float(jax.device_get(rep_base(*args)))
        base_ts.append(time.perf_counter() - t)
        t = time.perf_counter()
        float(jax.device_get(rep_body(*args)))
        body_ts.append(time.perf_counter() - t)
    med = max(
        (float(np.median(body_ts)) - float(np.median(base_ts))) / K, 1e-9)
    if return_stats:
        # IQR of the baseline-subtracted per-call estimates, so median and
        # IQR describe the SAME quantity.
        diffs = (np.asarray(body_ts) - float(np.median(base_ts))) / K
        q25, q75 = np.percentile(diffs, [25, 75])
        return med, float(q75 - q25)
    return med


def bench_flagship(scenarios: int, horizon: int, iters: int, reps: int):
    """Config #4: quadrotor 12-state, box-constrained QP (method="auto":
    the fused kernel on a GPU, the XLA scan elsewhere; bf16 coarse + fp32
    tail precision policy)."""
    import jax
    import jax.numpy as jnp

    from numpower_tpu.models import condense, quadrotor12, solve_mpc_boxqp

    A, B = quadrotor12(0.02)
    n, m = 12, 4
    Q = np.eye(n, dtype=np.float32)
    R = np.eye(m, dtype=np.float32) * 0.1
    QF = np.eye(n, dtype=np.float32) * 5.0

    t0 = time.perf_counter()
    qp = jax.jit(condense, static_argnums=5)(A, B, Q, R, QF, horizon)
    jax.block_until_ready(qp.H)
    _log(f"[flagship] condense formed in {time.perf_counter()-t0:.1f}s")

    x0s = jnp.asarray(
        0.3 * np.random.default_rng(0).standard_normal((scenarios, n)), jnp.float32
    )

    # bf16-coarse schedule needs concrete kappa — compute it here and pass
    # it into the jitted body, where qp is traced.
    from numpower_tpu.models.condensed import default_coarse_iters

    ci = default_coarse_iters(qp, iters)
    _log(f"[flagship] FISTA precision schedule: {ci} bf16 + {iters - ci} fp32 iters")

    # ADMM schedule likewise resolved EAGERLY (qp is concrete here; inside
    # the jitted body it is traced and the schedule would silently degrade
    # to all-fp32 — the exact footgun VERDICT r2 weak #1 flagged).
    from numpower_tpu.models.condensed import admm_coarse_iters

    ai = admm_coarse_iters(qp, iters)
    _log(f"[flagship] ADMM precision schedule: {ai} bf16 + {iters - ai} fp32 iters")

    # full solve (g formation + FISTA) per body call; i-dependent input
    # defeats loop-invariant hoisting
    def body(qp, x0s, i):
        return solve_mpc_boxqp(qp, x0s + i * 1e-6, -1.0, 1.0, iters=iters,
                               coarse_iters=ci).U[0, 0]

    rows = {}
    K_flag = 32 if scenarios <= 512 else 512
    per_batch, iqr_f = _device_time_per_call(
        body, (qp, x0s), K=K_flag, reps=reps, return_stats=True)
    solves_per_sec = scenarios / per_batch
    rows["fista_flagship_us_per_batch"] = (per_batch * 1e6, "us")
    rows["fista_flagship_solves_per_sec"] = (solves_per_sec, "solves/s")
    _log(
        f"[flagship] quadrotor h={horizon} N={scenarios} iters={iters} (FISTA): "
        f"{per_batch*1e6:.1f} us/batch median (IQR {iqr_f*1e6:.1f} us) "
        f"-> {solves_per_sec:,.0f} solves/s/chip"
    )

    # MFU: tensor-core speed-of-light vs measured
    from numpower_tpu.utils.flops import (
        device_peaks, mfu_report, qp_kernel_cost,
    )

    d = qp.H.shape[0]
    peak = device_peaks()
    cost_f = qp_kernel_cost(scenarios, n, d, iters, ci)
    _log(mfu_report(f"FISTA N={scenarios} d={d}", cost_f, per_batch, peak))
    if peak:
        rows["fista_mfu"] = (cost_f.mfu(per_batch, peak), "fraction")

    # same QP via fused ADMM (exact-solve splitting; converges tighter at the
    # same iteration count — both solvers hit the same optimum within 1e-4,
    # so the headline is the faster of the two)
    from numpower_tpu.models import solve_mpc_boxqp_admm

    def body_admm(qp, x0s, i):
        return solve_mpc_boxqp_admm(qp, x0s + i * 1e-6, -1.0, 1.0,
                                    iters=iters, coarse_iters=ai).U[0, 0]

    per_admm, iqr_a = _device_time_per_call(
        body_admm, (qp, x0s), K=K_flag, reps=reps, return_stats=True)
    admm_per_sec = scenarios / per_admm
    rows["admm_flagship_us_per_batch"] = (per_admm * 1e6, "us")
    rows["admm_flagship_solves_per_sec"] = (admm_per_sec, "solves/s")
    _log(
        f"[flagship] quadrotor h={horizon} N={scenarios} iters={iters} (ADMM):  "
        f"{per_admm*1e6:.1f} us/batch median (IQR {iqr_a*1e6:.1f} us) "
        f"-> {admm_per_sec:,.0f} solves/s/chip"
    )
    cost_a = qp_kernel_cost(scenarios, n, d, iters, ai)
    _log(mfu_report(f"ADMM  N={scenarios} d={d}", cost_a, per_admm, peak))
    if peak:
        rows["admm_mfu"] = (cost_a.mfu(per_admm, peak), "fraction")
    if admm_per_sec > solves_per_sec:
        solves_per_sec, per_batch = admm_per_sec, per_admm

    # latency config: small batch for the 10 ms real-time budget
    def body_small(qp, x0s, i):
        return solve_mpc_boxqp(qp, x0s[:256] + i * 1e-6, -1.0, 1.0, iters=iters,
                               coarse_iters=ci).U[0, 0]

    per_small = _device_time_per_call(body_small, (qp, x0s), K=256, reps=reps)
    rows["latency_256batch_us"] = (per_small * 1e6, "us")
    _log(
        f"[latency]  256-scenario batch device time ~{per_small*1e6:.1f} us "
        f"(budget 10 ms)"
    )
    return solves_per_sec, per_batch * 1e3, rows


def bench_lqr(horizon: int, reps: int) -> dict:
    """Config #1: double-integrator LQR single rollout; #2: 256-scenario
    batched Riccati. Returns summary rows for the driver JSON."""
    import jax
    import jax.numpy as jnp

    from numpower_tpu.models import double_integrator, lqr_solve, lqr_solve_batched

    A, B = double_integrator(0.1)
    Q = np.eye(2, dtype=np.float32)
    R = np.eye(1, dtype=np.float32) * 0.1
    QF = np.eye(2, dtype=np.float32) * 100.0

    rows = {}
    x0 = jnp.array([1.0, 0.0])
    t1 = _device_time_per_call(
        lambda x0, i: lqr_solve(A, B, Q, R, QF, x0 + i * 1e-6, horizon)[0][0, 0],
        (x0,), K=256, reps=reps,
    )
    _log(f"[config1] double-integrator LQR h={horizon}: {t1*1e6:.1f} us/solve device")
    rows["config1_lqr_us"] = (t1 * 1e6, "us")

    x0s = jnp.asarray(np.random.default_rng(1).standard_normal((256, 2)), jnp.float32)
    t2 = _device_time_per_call(
        lambda xs, i: lqr_solve_batched(A, B, Q, R, QF, xs + i * 1e-6, horizon)[0][0, 0, 0],
        (x0s,), K=256, reps=reps,
    )
    _log(
        f"[config2] 256-scenario LTI Riccati h={horizon}: "
        f"{t2*1e6:.1f} us/batch -> {256/t2:,.0f} solves/s"
    )
    rows["config2_riccati_solves_per_sec"] = (256 / t2, "solves/s")

    # config #2b: per-scenario dynamics (the batched-small-cholesky path)
    from numpower_tpu.models import quadrotor12, riccati_scan_per_scenario

    Aq, Bq = quadrotor12(0.02)
    N = 1024
    rng = np.random.default_rng(4)
    As = jnp.asarray(
        np.tile(np.asarray(Aq), (N, 1, 1))
        + 0.01 * rng.standard_normal((N, 12, 12)).astype(np.float32)
    )
    Bs = jnp.broadcast_to(jnp.asarray(Bq), (N, 12, 4))
    Qq = np.eye(12, dtype=np.float32)
    Rq = np.eye(4, dtype=np.float32) * 0.1
    QFq = np.eye(12, dtype=np.float32) * 5.0
    t2b = _device_time_per_call(
        lambda As, Bs, i: riccati_scan_per_scenario(
            As + i * 1e-6, Bs, Qq, Rq, QFq, horizon
        )[0][0, 0, 0, 0],
        (As, Bs), K=64, reps=max(2, reps // 3),
    )
    _log(
        f"[config2b] {N}-scenario per-scenario Riccati h={horizon}: "
        f"{t2b*1e3:.2f} ms/batch -> {N/t2b:,.0f} solves/s"
    )
    from numpower_tpu.utils.flops import (
        riccati_per_scenario_cost, roofline_report,
    )

    _log(roofline_report(f"per-scenario Riccati N={N} h={horizon}",
                         riccati_per_scenario_cost(N, horizon, 12, 4), t2b))
    rows["config2b_riccati_per_scenario_solves_per_sec"] = (N / t2b,
                                                            "solves/s")

    # long-horizon parallel-in-time Riccati (the SP engine's in-device
    # primitive): sequential scan vs associative O(log T) at flagship dims
    from numpower_tpu.models.lqr import riccati_associative, riccati_scan

    T_long = 4096
    Aq_j, Bq_j = jnp.asarray(Aq), jnp.asarray(Bq)
    QFq_j = jnp.asarray(QFq)
    t_rs = _device_time_per_call(
        lambda QF_, i: riccati_scan(
            Aq_j, Bq_j, Qq, Rq, QF_ + i * 1e-6, T_long)[0][0, 0, 0],
        (QFq_j,), K=8, reps=max(2, reps // 3),
    )
    # nopivot=True: explicit opt-in — the quadrotor combine chain is
    # well-conditioned; the library default is the pivoted solver (PSD
    # factors do not bound unpivoted pivots on general inputs).
    t_ra = _device_time_per_call(
        lambda QF_, i: riccati_associative(
            Aq_j, Bq_j, Qq, Rq, QF_ + i * 1e-6, T_long,
            nopivot=True)[0][0, 0, 0],
        (QFq_j,), K=32, reps=max(2, reps // 3),
    )
    _log(
        f"[riccati] T={T_long} n=12 single: sequential {t_rs*1e3:.2f} ms vs "
        f"associative {t_ra*1e3:.2f} ms ({t_rs/t_ra:.1f}x)"
    )
    from numpower_tpu.utils.flops import riccati_associative_cost

    _log(roofline_report(f"assoc Riccati T={T_long} n=12",
                         riccati_associative_cost(T_long, 12), t_ra))
    rows["riccati_assoc_ms"] = (t_ra * 1e3, "ms")
    rows["riccati_assoc_speedup"] = (t_rs / t_ra, "x")
    return rows


def bench_ilqr(reps: int):
    """Config #3: cartpole iLQR with finite-diff Jacobians."""
    import jax
    import jax.numpy as jnp

    from numpower_tpu.models import cartpole_step, ilqr_solve

    Q = jnp.diag(jnp.array([1.0, 10.0, 0.1, 0.1]))
    R = jnp.eye(1) * 0.01
    QF = jnp.diag(jnp.array([10.0, 100.0, 1.0, 1.0]))
    x_goal = jnp.zeros(4)

    x0 = jnp.array([0.0, 0.5, 0.0, 0.0])
    t = _device_time_per_call(
        lambda x0, i: ilqr_solve(
            cartpole_step, x0 + i * 1e-6, Q, R, QF, x_goal,
            horizon=50, iters=10, use_fd=True, unroll_scans=True,
        ).cost,
        (x0,), K=32, reps=max(2, reps // 2),
    )
    _log(f"[config3] cartpole iLQR (fd, 10 iters, h=50): {t*1e3:.2f} ms/solve device")
    rows = {"config3_ilqr_ms": (t * 1e3, "ms")}

    # batched scenarios (config #3 at scale)
    x0s = jnp.asarray(
        np.random.default_rng(3).standard_normal((256, 4)) * 0.3, jnp.float32
    )
    from numpower_tpu.models import ilqr_solve_batched

    t = _device_time_per_call(
        lambda xs, i: jnp.sum(
            ilqr_solve_batched(
                cartpole_step, xs + i * 1e-6, Q, R, QF, x_goal,
                horizon=50, iters=10, use_fd=True,
            ).cost
        ),
        (x0s,), K=16, reps=3,
    )
    _log(
        f"[config3b] 256-scenario batched iLQR: "
        f"{t*1e3:.2f} ms/batch -> {256/t:,.0f} iLQR solves/s"
    )
    rows["config3b_batched_ilqr_solves_per_sec"] = (256 / t, "solves/s")

    return rows


def bench_solvers_extra(scenarios: int, horizon: int, iters: int, reps: int):
    """Beyond-reference solver families: ADMM condensed QP, AL-iLQR, MPPI."""
    import jax
    import jax.numpy as jnp

    from numpower_tpu.models import (
        al_ilqr_solve_batched, condense, mppi_solve_batched, pendulum_step,
        quadratic_mppi_cost, quadrotor12, solve_mpc_boxqp_admm,
    )

    # ADMM on the flagship condensed QP (exact-solve splitting: the
    # per-iteration core is the same (N, d) @ (d, d) GEMM as FISTA)
    A, B = quadrotor12(0.02)
    Q = np.eye(12, dtype=np.float32)
    R = np.eye(4, dtype=np.float32) * 0.1
    QF = np.eye(12, dtype=np.float32) * 5.0
    qp = jax.jit(condense, static_argnums=5)(A, B, Q, R, QF, horizon)
    x0s = jnp.asarray(
        0.3 * np.random.default_rng(7).standard_normal((scenarios, 12)), jnp.float32
    )
    # schedule resolved eagerly (qp is traced inside the body — see
    # bench_flagship)
    from numpower_tpu.models.condensed import admm_coarse_iters

    ai = admm_coarse_iters(qp, iters)
    t = _device_time_per_call(
        lambda qp, xs, i: solve_mpc_boxqp_admm(
            qp, xs + i * 1e-6, -1.0, 1.0, iters=iters, coarse_iters=ai
        ).U[0, 0],
        (qp, x0s), K=32 if scenarios <= 512 else 512, reps=reps,
    )
    _log(
        f"[admm]  quadrotor h={horizon} N={scenarios} iters={iters}: "
        f"{t*1e6:.1f} us/batch -> {scenarios/t:,.0f} solves/s/chip"
    )
    rows = {"solvers_admm_solves_per_sec": (scenarios / t, "solves/s")}

    # AL-iLQR: constrained nonlinear swingup, batched scenarios
    N_al = max(1, min(scenarios // 16, 256))
    Qp = jnp.diag(jnp.array([1.0, 0.1]))
    Rp = jnp.eye(1) * 0.01
    QFp = jnp.diag(jnp.array([100.0, 10.0]))
    x0s_p = jnp.asarray(
        np.random.default_rng(8).uniform(-np.pi, np.pi, (N_al, 2)), jnp.float32
    )
    t = _device_time_per_call(
        lambda xs, i: jnp.sum(al_ilqr_solve_batched(
            pendulum_step, xs + i * 1e-6, Qp, Rp, QFp, jnp.zeros(2),
            40, -2.0, 2.0, al_iters=4, ilqr_iters=6,
        ).cost),
        (x0s_p,), K=4, reps=max(2, reps // 3),
    )
    _log(
        f"[al-ilqr] {N_al}-scenario pendulum (h=40, 4x6 iters, box +-2): "
        f"{t*1e3:.2f} ms/batch -> {N_al/t:,.0f} solves/s"
    )
    rows["al_ilqr_solves_per_sec"] = (N_al / t, "solves/s")

    # MPPI: N scenarios x K samples batched rollouts
    N_mp, K_mp = max(1, min(scenarios // 16, 256)), 256
    cost_fn = quadratic_mppi_cost(Qp, Rp, QFp, jnp.zeros(2))
    key = jax.random.key(0)
    t = _device_time_per_call(
        lambda xs, k, i: jnp.sum(mppi_solve_batched(
            pendulum_step, xs + i * 1e-6, cost_fn, 40, k,
            samples=K_mp, iters=8, m=1,
        ).cost),
        (x0s_p[:N_mp], key), K=4 if scenarios <= 512 else 16,
        reps=max(2, reps // 3),
    )
    rollouts = N_mp * K_mp * 8
    _log(
        f"[mppi]  {N_mp}-scenario x {K_mp}-sample pendulum (h=40, 8 updates): "
        f"{t*1e3:.2f} ms/batch -> {N_mp/t:,.0f} solves/s "
        f"({rollouts/t/1e6:.1f} M rollouts/s)"
    )
    from numpower_tpu.utils.flops import mppi_batched_cost, roofline_report

    _log(roofline_report(f"MPPI N={N_mp} K={K_mp} T=40 iters=8",
                         mppi_batched_cost(N_mp, K_mp, 8, 40, 1), t))
    rows["mppi_rollouts_per_sec"] = (rollouts / t, "rollouts/s")
    return rows


def bench_estimation(scenarios: int, reps: int):
    """Batched Kalman filtering throughput (the estimation side of the MPC
    loop) + sequential-vs-associative parallel-in-time comparison."""
    import jax
    import jax.numpy as jnp

    from numpower_tpu.models import (
        double_integrator, kalman_filter, kalman_filter_associative,
        kalman_filter_batched,
    )

    A, B = double_integrator(0.1)
    C = jnp.array([[1.0, 0.0]])
    Q = jnp.eye(2) * 1e-3
    R = jnp.eye(1) * 1e-2
    P0 = jnp.eye(2) * 0.1
    N, T = scenarios, 50
    rng = np.random.default_rng(11)
    yss = jnp.asarray(rng.standard_normal((N, T, 1)).astype(np.float32))
    x0s = jnp.asarray(rng.standard_normal((N, 2)).astype(np.float32))
    t = _device_time_per_call(
        lambda x0s, yss, i: kalman_filter_batched(
            A, C, Q, R, x0s + i * 1e-6, P0, yss).log_likelihood[0],
        (x0s, yss), K=2048 if scenarios >= 2048 else 256, reps=reps,
    )
    if t <= 2e-8:
        _log(f"[kalman] {N}-trajectory batched filter T={T}: below timer "
             f"resolution (<{t*1e6:.2f} us/batch)")
    else:
        _log(
            f"[kalman] {N}-trajectory batched filter T={T}: {t*1e3:.2f} ms/batch "
            f"-> {N/t:,.0f} filters/s ({N*T/t/1e6:.1f}M updates/s)"
        )
    from numpower_tpu.utils.flops import (
        kalman_associative_cost, kalman_batched_cost, particle_filter_cost,
        roofline_report,
    )

    _log(roofline_report(f"batched KF N={N} T={T}",
                         kalman_batched_cost(N, T, 2, 1), t))
    rows = {"kalman_batched_updates_per_sec": (N * T / t, "updates/s")}

    # batched RTS smoother: shared gain/cov recursions once + the batched
    # backward mean pass. Timed over a precomputed filter result, perturbed
    # per-iteration so the smoother cannot hoist out of the timing loop.
    from numpower_tpu.models.estimation import kalman_smoother_batched
    from numpower_tpu.utils.flops import rts_batched_cost

    filt_sm = jax.tree.map(
        jax.block_until_ready,
        kalman_filter_batched(A, C, Q, R, x0s, P0, yss))
    t_sm = _device_time_per_call(
        lambda filt, i: kalman_smoother_batched(
            A, filt._replace(means=filt.means + i * 1e-6)).means[0, 0, 0],
        (filt_sm,), K=2048 if scenarios >= 2048 else 256, reps=reps,
    )
    _log(
        f"[rts]    {N}-trajectory batched RTS smoother T={T}: "
        f"{t_sm*1e6:.2f} us/batch -> {N*T/t_sm/1e6:.1f}M smoothed states/s"
    )
    _log(roofline_report(f"batched RTS N={N} T={T}",
                         rts_batched_cost(N, T, 2), t_sm))
    rows["rts_batched_states_per_sec"] = (N * T / t_sm, "states/s")

    # particle filter: batched nonlinear SMC throughput (plant evals/s is
    # the cost driver: N_traj x n_particles x T pendulum steps per call)
    from numpower_tpu.models import particle_filter_batched, pendulum_step

    N_pf, P_pf, T_pf = max(1, min(scenarios // 16, 256)), 1024, 50
    h_pf = lambda x: x[:1]
    ys_pf = jnp.asarray(rng.standard_normal((N_pf, T_pf, 1)).astype(np.float32))
    us_pf = jnp.zeros((N_pf, T_pf, 1), jnp.float32)
    x0s_pf = jnp.asarray(
        0.3 * rng.standard_normal((N_pf, 2)).astype(np.float32))
    key_pf = jax.random.key(0)
    t = _device_time_per_call(
        lambda x0s, yss, us, k, i: jnp.sum(particle_filter_batched(
            pendulum_step, h_pf, jnp.eye(2) * 1e-4, jnp.eye(1) * 2.5e-3,
            x0s + i * 1e-6, jnp.eye(2), yss, us, k,
            n_particles=P_pf).log_likelihood),
        (x0s_pf, ys_pf, us_pf, key_pf), K=4, reps=max(2, reps // 3),
    )
    _log(
        f"[pf]     {N_pf}-trajectory x {P_pf}-particle bootstrap PF T={T_pf} "
        f"(pendulum): {t*1e3:.2f} ms/batch -> {N_pf/t:,.0f} filters/s "
        f"({N_pf*P_pf*T_pf/t/1e6:.0f}M particle-steps/s)"
    )
    from numpower_tpu.utils.flops import pf_resample_cost

    _log(roofline_report(f"particle filter {N_pf}x{P_pf} T={T_pf} "
                         f"(propagate/weight)",
                         particle_filter_cost(N_pf, P_pf, T_pf, 2, 1), t))
    _log(roofline_report(f"particle filter {N_pf}x{P_pf} T={T_pf} "
                         f"(one-hot resample)",
                         pf_resample_cost(N_pf, P_pf, T_pf, 2), t))
    rows["pf_particle_steps_per_sec"] = (N_pf * P_pf * T_pf / t, "steps/s")

    # batched UKF (nonlinear estimator lineup), vmapped filter
    from numpower_tpu.models.estimation import ukf_filter_batched

    def f_pend(x, u):
        th, om = x[0], x[1]
        return jnp.stack(
            [th + 0.05 * om, om - 0.05 * 9.81 * jnp.sin(th) + 0.05 * u[0]])

    def h_pend(x):
        return x[:1]

    N_ukf, T_ukf = max(1, min(scenarios // 4, 1024)), 50
    ys_u = jnp.asarray(rng.standard_normal((N_ukf, T_ukf, 1)).astype(np.float32))
    us_u = jnp.zeros((N_ukf, T_ukf, 1), jnp.float32)
    x0_u = jnp.asarray(0.3 * rng.standard_normal((N_ukf, 2)).astype(np.float32))
    t_u = _device_time_per_call(
        lambda x0s, ys, us, i: ukf_filter_batched(
            f_pend, h_pend, Q, R, x0s + i * 1e-6, P0, ys,
            us).log_likelihood[0],
        (x0_u, ys_u, us_u), K=512 if scenarios >= 2048 else 32, reps=reps,
    )
    _log(
        f"[ukf]    {N_ukf}-trajectory vmapped UKF T={T_ukf} (pendulum): "
        f"{t_u*1e3:.2f} ms/batch -> {N_ukf*T_ukf/t_u/1e6:.1f}M updates/s"
    )
    from numpower_tpu.utils.flops import ekf_batched_cost, ukf_batched_cost

    _log(roofline_report(f"batched UKF N={N_ukf} T={T_ukf}",
                         ukf_batched_cost(N_ukf, T_ukf, 2, 1), t_u))
    rows["ukf_updates_per_sec"] = (N_ukf * T_ukf / t_u, "updates/s")

    # batched EKF, vmapped filter
    from numpower_tpu.models.estimation import ekf_filter_batched

    t_e = _device_time_per_call(
        lambda x0s, ys, us, i: ekf_filter_batched(
            f_pend, h_pend, Q, R, x0s + i * 1e-6, P0, ys,
            us).log_likelihood[0],
        (x0_u, ys_u, us_u), K=512 if scenarios >= 2048 else 32, reps=reps,
    )
    _log(
        f"[ekf]    {N_ukf}-trajectory batched EKF T={T_ukf} (pendulum): "
        f"{t_e*1e3:.3f} ms/batch -> {N_ukf*T_ukf/t_e/1e6:.1f}M updates/s"
    )
    _log(roofline_report(f"batched EKF N={N_ukf} T={T_ukf}",
                         ekf_batched_cost(N_ukf, T_ukf, 2, 1), t_e))
    rows["ekf_updates_per_sec"] = (N_ukf * T_ukf / t_e, "updates/s")

    # long-horizon: sequential scan vs associative O(log T)
    T_long = 4096
    ys_long = jnp.asarray(rng.standard_normal((T_long, 1)).astype(np.float32))
    x0 = jnp.array([1.0, 0.0])
    t_seq = _device_time_per_call(
        lambda ys, i: kalman_filter(
            A, C, Q, R, x0, P0, ys + i * 1e-6).log_likelihood,
        (ys_long,), K=8, reps=max(2, reps // 3),
    )
    # nopivot=True: explicit opt-in (the unpivoted Gauss-Jordan fuses);
    # the library default is the pivoted solver.
    t_par = _device_time_per_call(
        lambda ys, i: kalman_filter_associative(
            A, C, Q, R, x0, P0, ys + i * 1e-6,
            nopivot=True).log_likelihood,
        (ys_long,), K=64, reps=max(2, reps // 3),
    )
    _log(
        f"[kalman] T={T_long} single filter: sequential {t_seq*1e3:.2f} ms vs "
        f"associative {t_par*1e3:.2f} ms ({t_seq/t_par:.1f}x)"
    )
    _log(roofline_report(f"assoc KF T={T_long} n=2",
                         kalman_associative_cost(T_long, 2), t_par))
    rows["kalman_assoc_ms"] = (t_par * 1e3, "ms")
    rows["kalman_assoc_speedup"] = (t_seq / t_par, "x")
    return rows


def bench_tube(scenarios: int, reps: int):
    """Config #5 (single-host slice): tube-MPC scenario sweep."""
    import jax
    import jax.numpy as jnp

    from numpower_tpu.models import condense, quadrotor12, tube_mpc_solve

    A, B = quadrotor12(0.02)
    Q = np.eye(12, dtype=np.float32)
    R = np.eye(4, dtype=np.float32) * 0.1
    QF = np.eye(12, dtype=np.float32) * 5.0
    qp = jax.jit(condense, static_argnums=5)(A, B, Q, R, QF, 20)
    rng = np.random.default_rng(2)
    w = jnp.asarray(0.002 * rng.standard_normal((scenarios, 20, 12)), jnp.float32)
    x0 = jnp.asarray(0.2 * rng.standard_normal(12), jnp.float32)

    t = _device_time_per_call(
        lambda qp, x0, w, i: tube_mpc_solve(
            qp, A, B, Q, R, x0 + i * 1e-6, w, -1.0, 1.0
        ).tube_radius[0],
        (qp, x0, w), K=256, reps=reps,
    )
    _log(
        f"[config5] tube-MPC sweep N={scenarios}: {t*1e3:.3f} ms/sweep device "
        f"-> {scenarios/t:,.0f} scenario-rollouts/s"
    )
    rows = {"tube_sweep_rollouts_per_sec": (scenarios / t, "rollouts/s")}

    # Host-fed variant: the C++ ScenarioStream generates each sweep's
    # disturbance batch in worker threads (double-buffered ring) while the
    # device solves the previous one — jax's async dispatch overlaps the
    # device_put + solve with the next batch's RNG, so the sweep never
    # stalls on host generation (runtime/src/scenario_stream.cpp).
    from numpower_tpu.runtime.stream import ScenarioStream

    solve = jax.jit(lambda qp, x0, w: tube_mpc_solve(
        qp, A, B, Q, R, x0, w, -1.0, 1.0).tube_radius[0])
    n_batches = 8
    with ScenarioStream(batch=scenarios, shape=(20, 12), seed=0,
                        dist="normal", scale=0.002) as stream:
        w0 = jnp.asarray(next(stream))
        float(jax.device_get(solve(qp, x0, w0)))  # compile + warm
        t0 = time.perf_counter()
        outs = []
        for _, wb in zip(range(n_batches), stream):
            outs.append(solve(qp, x0, jnp.asarray(wb)))
        for o in outs:
            float(jax.device_get(o))
        dt = (time.perf_counter() - t0) / n_batches
        mb = w0.size * 4 / 1e6
        _log(
            f"[config5] host-fed sweep ({'native' if stream.native else 'numpy'}"
            f" stream, {n_batches} batches of {mb:.1f} MB): {dt*1e3:.3f} "
            f"ms/sweep wall -> {scenarios/dt:,.0f} scenario-rollouts/s "
            f"end-to-end ({mb/dt/1e3:.2f} GB/s host->device)"
        )
    return rows


def bench_micro(reps: int):
    """Initializer micro-benchmarks mirroring the reference's phpbench suite
    (/root/reference/benchmarks/initializers/*, shapes up to 1000x10000) —
    the only benchmark harness the reference ships."""
    import jax
    import jax.numpy as jnp

    from numpower_tpu import ops

    shapes = [(1000, 1, 1), (500, 1000, 1), (1000, 10000, 1)]
    # each entry: (label-shape description, thunk)
    cases = []
    for s in shapes:
        cases.append((f"zeros{s}", lambda i, s=s: ops.zeros(s) + i))
        cases.append((f"ones{s}", lambda i, s=s: ops.ones(s) * i))
        cases.append((f"full{s}", lambda i, s=s: ops.full(s, 7.0) + i))
    cases.append(("identity(1000)", lambda i: ops.identity(1000) + i))
    cases.append(("arange(10_000_000)", lambda i: ops.arange(10_000_000.0) + i))
    for label, fn in cases:
        t = _device_time_per_call(
            lambda i, fn=fn: jnp.sum(fn(i)), (), K=64, reps=max(2, reps // 3)
        )
        _log(f"[micro] {label}: {t*1e6:.1f} us (incl. consuming reduce)")


def bench_serving(scenarios: int, horizon: int, reps: int):
    """Production serving shape: receding-horizon warm-started closed-loop
    ticks (MPCController) — tick latency is the real-time number."""
    import jax
    import jax.numpy as jnp

    from numpower_tpu.models import MPCController, quadrotor12

    A, B = quadrotor12(0.02)
    ctrl = MPCController(
        A, B, np.eye(12, dtype=np.float32), np.eye(4, dtype=np.float32) * 0.1,
        np.eye(12, dtype=np.float32) * 5.0, horizon=horizon,
        u_lo=-1.0, u_hi=1.0, iters=20,
    )
    state0 = ctrl.init(scenarios)
    x0 = jnp.asarray(
        0.3 * np.random.default_rng(0).standard_normal((scenarios, 12)), jnp.float32
    )
    A_j, B_j = jnp.asarray(A), jnp.asarray(B)

    def tick(carry, i):
        state, x = carry
        u0, state, _ = ctrl._step_impl(ctrl.qp, state, x + i * 1e-7)
        x_next = x @ A_j.T + u0 @ B_j.T
        return (state, x_next), None

    import jax as _jax
    from jax import lax

    # 512 ticks/window, matching the flagship's K=512 methodology
    K = 32 if scenarios <= 512 else 512

    @_jax.jit
    def rep(state, x):
        (state, x), _ = lax.scan(tick, (state, x), jnp.arange(K, dtype=jnp.float32))
        return x[0, 0]

    @_jax.jit
    def rep0(state, x):
        return x[0, 0]

    # median + IQR like every other section
    def run_times(r):
        float(jax.device_get(r(state0, x0)))  # compile + warm
        ts = []
        for _ in range(max(5, reps)):
            t = time.perf_counter()
            float(jax.device_get(r(state0, x0)))
            ts.append(time.perf_counter() - t)
        return np.asarray(ts)

    baseline = float(np.median(run_times(rep0)))
    per_tick_samples = np.maximum((run_times(rep) - baseline) / K, 1e-9)
    per_tick = float(np.median(per_tick_samples))
    q25, q75 = np.percentile(per_tick_samples, [25, 75])
    _log(
        f"[serving] {scenarios}-scenario warm-started controller tick "
        f"(20 iters): {per_tick*1e6:.1f} us/tick median "
        f"(IQR {(q75-q25)*1e6:.1f} us) -> {scenarios/per_tick:,.0f} "
        f"control updates/s"
    )
    rows = {"serving_fista_tick_us": (per_tick * 1e6, "us")}

    # ADMM serving tick (the faster solver family; warm-started z iterate)
    ctrl_a = MPCController(
        A, B, np.eye(12, dtype=np.float32), np.eye(4, dtype=np.float32) * 0.1,
        np.eye(12, dtype=np.float32) * 5.0, horizon=horizon,
        u_lo=-1.0, u_hi=1.0, iters=20, solver="admm",
    )
    state0_a = ctrl_a.init(scenarios)

    def tick_a(carry, i):
        state, x = carry
        u0, state, _ = ctrl_a._step_impl(ctrl_a.qp, state, x + i * 1e-7)
        x_next = x @ A_j.T + u0 @ B_j.T
        return (state, x_next), None

    @_jax.jit
    def rep_a(state, x):
        (state, x), _ = lax.scan(tick_a, (state, x),
                                 jnp.arange(K, dtype=jnp.float32))
        return x[0, 0]

    def run_times_a(r):
        float(jax.device_get(r(state0_a, x0)))
        ts = []
        for _ in range(max(5, reps)):
            t = time.perf_counter()
            float(jax.device_get(r(state0_a, x0)))
            ts.append(time.perf_counter() - t)
        return np.asarray(ts)

    per_a = np.maximum((run_times_a(rep_a) - baseline) / K, 1e-9)
    med_a = float(np.median(per_a))
    q25a, q75a = np.percentile(per_a, [25, 75])
    _log(
        f"[serving] {scenarios}-scenario ADMM warm-started tick (20 iters): "
        f"{med_a*1e6:.1f} us/tick median (IQR {(q75a-q25a)*1e6:.1f} us) -> "
        f"{scenarios/med_a:,.0f} control updates/s"
    )
    rows["serving_admm_tick_us"] = (med_a * 1e6, "us")
    return rows


def bench_shardmap_overhead(scenarios: int, horizon: int, iters: int, reps: int):
    """shard_map over one device vs the single-device solver, both with
    method="auto": the sharded DP solver must keep the single-device
    throughput."""
    import jax
    import jax.numpy as jnp

    from numpower_tpu.models import condense, quadrotor12, solve_mpc_boxqp
    from numpower_tpu.models.condensed import default_coarse_iters
    from numpower_tpu.parallel import make_mesh, solve_mpc_boxqp_dp

    A, B = quadrotor12(0.02)
    Q = np.eye(12, dtype=np.float32)
    R = np.eye(4, dtype=np.float32) * 0.1
    QF = np.eye(12, dtype=np.float32) * 5.0
    qp = jax.jit(condense, static_argnums=5)(A, B, Q, R, QF, horizon)
    ci = default_coarse_iters(qp, iters)
    x0s = jnp.asarray(
        0.3 * np.random.default_rng(0).standard_normal((scenarios, 12)), jnp.float32
    )
    K = 32 if scenarios <= 512 else 512

    def t_direct_once():
        return _device_time_per_call(
            lambda qp, xs, i: solve_mpc_boxqp(
                qp, xs + i * 1e-6, -1.0, 1.0, iters=iters, coarse_iters=ci,
            ).U[0, 0],
            (qp, x0s), K=K, reps=reps,
        )

    mesh = make_mesh((1, 1), devices=jax.devices()[:1])

    def t_sharded_once():
        return _device_time_per_call(
            lambda qp, xs, i: solve_mpc_boxqp_dp(
                qp, xs + i * 1e-6, -1.0, 1.0, mesh, iters=iters,
                coarse_iters=ci,
            ).U[0, 0],
            (qp, x0s), K=K, reps=reps,
        )

    pairs = [(t_direct_once(), t_sharded_once()) for _ in range(3)]
    t_direct = float(np.median([p[0] for p in pairs]))
    t_sharded = float(np.median([p[1] for p in pairs]))
    _log(
        f"[shardmap] single-device solve {t_direct*1e6:.1f} us vs "
        f"shard_map(1dev) {t_sharded*1e6:.1f} us -> overhead "
        f"{100*(t_sharded/t_direct-1):+.1f}% (median of 3 interleaved pairs, "
        f"K={K})"
    )
    return {"shardmap_overhead_pct": (100 * (t_sharded / t_direct - 1),
                                      "%")}


def bench_scaling(scenarios: int, reps: int):
    """Scaling sweep: DP box-QP solves/s at 1..D devices (BASELINE: >=85%
    efficiency at 2+ hosts). On a virtual CPU mesh this validates the
    sharded program + harness; real efficiency numbers need real cards."""
    import jax
    import jax.numpy as jnp

    from numpower_tpu.models import condense, quadrotor12
    from numpower_tpu.parallel import make_mesh, shard_batch, solve_mpc_boxqp_dp
    from numpower_tpu.utils.profiler import time_compiled

    A, B = quadrotor12(0.02)
    Q = np.eye(12, dtype=np.float32)
    R = np.eye(4, dtype=np.float32) * 0.1
    QF = np.eye(12, dtype=np.float32) * 5.0
    qp = jax.jit(condense, static_argnums=5)(A, B, Q, R, QF, 16)

    D = jax.device_count()
    widths = [w for w in (1, 2, 4, 8, 16, 32) if w <= D]
    base_rate = None
    for w in widths:
        mesh = make_mesh((w, 1), devices=jax.devices()[:w])
        x0s = shard_batch(
            jnp.asarray(
                0.3 * np.random.default_rng(0).standard_normal((scenarios, 12)),
                jnp.float32,
            ),
            mesh,
        )
        fn = lambda qp, x0s: solve_mpc_boxqp_dp(qp, x0s, -1.0, 1.0, mesh, iters=30).U
        dt, iqr = time_compiled(fn, qp, x0s, reps=max(3, reps // 3),
                                return_stats=True)
        rate = scenarios / dt
        if base_rate is None:
            base_rate = rate
        eff = rate / (base_rate * w)
        _log(
            f"[scaling] devices={w}: {rate:,.0f} solves/s "
            f"(median, IQR {iqr/dt*100:.0f}%; efficiency vs linear-from-1: "
            f"{eff:.2f})"
        )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true", help="tiny shapes (CPU smoke)")
    ap.add_argument("--full", action="store_true", help="run all BASELINE configs")
    ap.add_argument("--scaling", action="store_true", help="DP scaling sweep over devices")
    ap.add_argument("--micro", action="store_true",
                    help="initializer micro-benchmarks (reference phpbench parity)")
    ap.add_argument("--skip-certify", action="store_true",
                    help="flagship only: skip the default pass over every "
                         "section")
    ap.add_argument("--scenarios", type=int, default=None)
    ap.add_argument("--horizon", type=int, default=30)
    ap.add_argument("--iters", type=int, default=40)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()

    import jax

    from numpower_tpu.utils.config import enable_compile_cache

    if args.quick:
        jax.config.update("jax_platforms", "cpu")
    enable_compile_cache()
    scenarios = args.scenarios or (256 if args.quick else 4096)
    reps = 3 if args.quick else args.reps

    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": jax.device_count()}
    _log(f"device: {dev.platform}:{dev.device_kind} x{jax.device_count()}")

    solves_per_sec, _, all_rows = bench_flagship(
        scenarios, args.horizon, args.iters, reps)

    # Every section by default (--skip-certify: flagship only; --quick keeps
    # the CPU smoke fast unless --full). A failed section is logged, the
    # remaining sections still run, and the process exits non-zero.
    failed = []
    run_sections = (not args.skip_certify) and (not args.quick or args.full)
    if run_sections:
        certify_reps = min(reps, 5)
        sections = [
            ("lqr", lambda: bench_lqr(args.horizon, certify_reps)),
            ("ilqr", lambda: bench_ilqr(certify_reps)),
            ("tube", lambda: bench_tube(
                min(scenarios * 4, 16384) if not args.quick else 512,
                certify_reps)),
            ("serving", lambda: bench_serving(
                scenarios, args.horizon, certify_reps)),
            ("solvers_extra", lambda: bench_solvers_extra(
                scenarios, args.horizon, args.iters, certify_reps)),
            ("estimation", lambda: bench_estimation(scenarios, certify_reps)),
            ("shardmap", lambda: bench_shardmap_overhead(
                scenarios, args.horizon, args.iters, certify_reps)),
        ]
        for name, fn in sections:
            t0 = time.perf_counter()
            try:
                all_rows.update(fn() or {})
            except Exception as e:  # noqa: BLE001 — finish the others first
                _log(f"[certify] SECTION FAILED {name}: "
                     f"{type(e).__name__}: {e}")
                failed.append(name)
            _log(f"[certify] section {name} done in "
                 f"{time.perf_counter()-t0:.0f}s")

    if args.scaling:
        bench_scaling(scenarios, reps)

    if args.micro:
        bench_micro(reps)

    target = 10_000.0  # BASELINE north star: solves/s
    solves_per_sec = max(
        [solves_per_sec] + [float(all_rows[k][0]) for k in (
            "fista_flagship_solves_per_sec", "admm_flagship_solves_per_sec")
            if k in all_rows])
    summary = {
        "metric": "mpc_solves_per_sec",
        "value": round(solves_per_sec, 1),
        "unit": "solves/s",
        "vs_baseline": round(solves_per_sec / target, 3),
        "device": device,
    }
    full = dict(summary, rows={
        k: {"value": round(float(v), 3), "unit": u}
        for k, (v, u) in all_rows.items()})
    if failed:
        full["failed_sections"] = failed
    with open(CERTIFY_PATH, "w") as f:
        json.dump(full, f, indent=1)
        f.write("\n")
    _log("[certify] full JSON: " + json.dumps(full))
    summary["rows_file"] = "CERTIFY.json"
    summary["rows_n"] = len(all_rows)
    if failed:
        summary["failed_sections"] = failed
    print(json.dumps(summary))
    if failed:
        sys.exit(1)


if __name__ == "__main__":
    main()
