"""Start-up proof on one NVIDIA GPU: the flagship MPC path, end to end.

    python chip_smoke.py               # one card: phases 1-4 below
    python chip_smoke.py --devices 4   # four cards: the sharded path only

Phases (each fatal on failure):
  1. flagship: condense quadrotor12 (T=30, d=120) and solve 4096 scenarios
     with solve_mpc_boxqp (FISTA) and solve_mpc_boxqp_admm, 40 iterations,
     method="auto" and the XLA path; every U is compared with a plain fp64
     NumPy reference (condensing and projected gradient to a KKT residual
     below 1e-10) at 1e-4;
  2. serving: MPCController, solver="fista" and "admm", five warm-started
     ticks at N=4096, one compiled executable, each tick's plan against the
     fp64 optimum for that tick's states at 1e-4;
  3. route check: no pallas_call of phases 1-2 runs in interpret mode, and
     each kernel the routes chose appears in the compiled HLO;
  4. the families on XLA (per-scenario Riccati, batched iLQR, KF and RTS,
     EKF and UKF, MPPI, particle filter and its resampling routes) at their
     bench sizes, the parallel-in-time Riccati and KF, and jit(eig), each
     against a plain reference at a stated tolerance.

--devices 4 runs solve_mpc_boxqp_dp and solve_mpc_boxqp_admm_dp on a (4, 1)
mesh and solve_mpc_boxqp_dp_tp on a (2, 2) mesh at N=16384, and mesh-mode
MPCControllers for 3 ticks; each result against the single-device result
(1e-5) and the fp64 reference (1e-4). One process drives all four cards.

Line 1 is the card's name and power limit (nvidia-smi) and jax.devices();
the last line of standard output is one JSON object naming the device. The
script refuses to run without a GPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

N_FLAGSHIP = 4096
N_MESH = 16384
T_FLAGSHIP = 30
ITERS = 40
BOUND = 1e-4          # BASELINE parity bound against the fp64 optimum
MESH_BOUND = 1e-5     # sharded vs single-device result


# --------------------------------------------------------------------------
# Plain fp64 references (NumPy only; nothing from the package under test)
# --------------------------------------------------------------------------

def quadrotor_plant(dt: float = 0.02):
    """The 12-state hover linearisation of BASELINE config #4, written out
    independently of the package's plant library."""
    g = 9.81
    n, m = 12, 4
    Ac = np.zeros((n, n))
    Ac[0:3, 3:6] = np.eye(3)
    Ac[3, 7] = g          # x-acceleration from pitch
    Ac[4, 6] = -g         # y-acceleration from roll
    Ac[6:9, 9:12] = np.eye(3)
    Bc = np.zeros((n, m))
    Bc[5, 0] = 1.0        # thrust -> vertical acceleration
    Bc[9:12, 1:4] = np.eye(3)
    return np.eye(n) + dt * Ac, dt * Bc


def flagship_costs(n: int = 12, m: int = 4):
    return np.eye(n), 0.1 * np.eye(m), 5.0 * np.eye(n)


def condense_ref(A, B, Q, R, QF, T):
    """fp64 condensed QP: H = Su'Qbar Su + Rbar and G with g = x0 @ G."""
    n, m = B.shape
    Sx = np.zeros((T * n, n))
    Su = np.zeros((T * n, T * m))
    powers = [np.eye(n)]
    for _ in range(T):
        powers.append(A @ powers[-1])
    for i in range(T):
        Sx[i * n:(i + 1) * n] = powers[i + 1]
        for j in range(i + 1):
            Su[i * n:(i + 1) * n, j * m:(j + 1) * m] = powers[i - j] @ B
    Qbar = np.kron(np.eye(T), Q)
    Qbar[-n:, -n:] = QF
    H = Su.T @ Qbar @ Su + np.kron(np.eye(T), R)
    H = 0.5 * (H + H.T)
    G = (Su.T @ Qbar @ Sx).T          # (n, T m): g = x0 @ G
    return H, G


def boxqp_ref(H, g, lo, hi, tol: float = 1e-10, max_iters: int = 100_000):
    """Projected gradient in fp64 until the KKT residual
    max|U - clip(U - (U H + g))| is below tol. g (N, d)."""
    L = float(np.linalg.eigvalsh(H)[-1])
    U = np.zeros_like(g)
    for _ in range(max_iters):
        grad = U @ H + g
        if np.max(np.abs(U - np.clip(U - grad, lo, hi))) < tol:
            return U
        U = np.clip(U - grad / L, lo, hi)
    raise RuntimeError("fp64 reference did not reach its KKT tolerance")


def flagship_reference(x0s, T: int = T_FLAGSHIP, lo=-1.0, hi=1.0):
    A, B = quadrotor_plant()
    H, G = condense_ref(A, B, *flagship_costs(), T)
    return boxqp_ref(H, np.asarray(x0s, np.float64) @ G, lo, hi)


def flagship_x0s(N: int, seed: int = 0):
    return (0.3 * np.random.default_rng(seed).standard_normal((N, 12))
            ).astype(np.float32)


def riccati_ref(A, B, Q, R, QF, T):
    """fp64 backward Riccati; gains K_0..K_{T-1} as (T, m, n)."""
    P, Ks = QF, []
    for _ in range(T):
        K = np.linalg.solve(R + B.T @ P @ B, B.T @ P @ A)
        P = Q + A.T @ P @ A - (B.T @ P @ A).T @ K
        P = 0.5 * (P + P.T)
        Ks.append(K)
    return np.stack(Ks[::-1])


def kalman_ref(A, C, Q, R, x0, P0, ys):
    """fp64 Kalman filter: filtered/predicted means and covariances."""
    x, P, out = x0, P0, []
    for y in ys:
        x_p, P_p = A @ x, A @ P @ A.T + Q
        K = P_p @ C.T @ np.linalg.inv(C @ P_p @ C.T + R)
        x, P = x_p + K @ (y - C @ x_p), P_p - K @ C @ P_p
        out.append((x, P, x_p, P_p))
    return tuple(np.stack(z) for z in zip(*out))


def rts_ref(A, xf, Pf, xp, Pp):
    """fp64 RTS smoother means over kalman_ref's output."""
    xs = [xf[-1]]
    for t in range(len(xf) - 2, -1, -1):
        G = Pf[t] @ A.T @ np.linalg.inv(Pp[t + 1])
        xs.append(xf[t] + G @ (xs[-1] - xp[t + 1]))
    return np.stack(xs[::-1])


DT_PEND, G_PEND = 0.05, 9.81


def pend_f(x, u):
    """The estimation bench's pendulum: theta, omega; h(x) = theta."""
    th, om = x
    return np.array([th + DT_PEND * om,
                     om - DT_PEND * G_PEND * np.sin(th) + DT_PEND * u[0]])


def ekf_ref(Q, R, x0, P0, ys, us):
    C = np.array([[1.0, 0.0]])
    x, P, out = x0, P0, []
    for y, u in zip(ys, us):
        F = np.array([[1.0, DT_PEND],
                      [-DT_PEND * G_PEND * np.cos(x[0]), 1.0]])
        x_p, P_p = pend_f(x, u), F @ P @ F.T + Q
        K = P_p @ C.T @ np.linalg.inv(C @ P_p @ C.T + R)
        x, P = x_p + K @ (y - C @ x_p), P_p - K @ C @ P_p
        out.append(x)
    return np.stack(out)


def ukf_ref(Q, R, x0, P0, ys, us):
    """fp64 UKF with alpha=1, beta=2, kappa=0: spread sqrt(n), weights
    wm = [0, 1/2n, ...], wc[0] = 2."""
    n = 2
    wm = np.r_[0.0, np.full(2 * n, 0.5 / n)]
    wc = wm.copy()
    wc[0] += 2.0

    def sigma(x, P):
        S = np.linalg.cholesky(n * P + 1e-9 * np.eye(n))
        return np.vstack([x, x + S.T, x - S.T])

    x, P, out = x0, P0, []
    for y, u in zip(ys, us):
        pts = np.array([pend_f(s, u) for s in sigma(x, P)])
        x_p = wm @ pts
        P_p = (wc[:, None] * (pts - x_p)).T @ (pts - x_p) + Q
        pts2 = sigma(x_p, P_p)
        y_p = wm @ pts2[:, :1]
        dY = pts2[:, :1] - y_p
        S = (wc[:, None] * dY).T @ dY + R
        K = ((wc[:, None] * (pts2 - x_p)).T @ dY) @ np.linalg.inv(S)
        x, P = x_p + K @ (y - y_p), P_p - K @ S @ K.T
        out.append(x)
    return np.stack(out)


# --------------------------------------------------------------------------
# Checks
# --------------------------------------------------------------------------

def _log(*a):
    print(*a, flush=True)


def max_dev(U, U_ref) -> float:
    return float(np.max(np.abs(np.asarray(U, np.float64) - U_ref)))


def rel_dev(X, X_ref) -> float:
    """max |X - X_ref| / max(1, max |X_ref|)."""
    return max_dev(X, X_ref) / max(1.0, float(np.max(np.abs(X_ref))))


def check(name: str, dev: float, bound: float, extra: str = ""):
    ok = dev <= bound
    _log(f"  {name}: {dev:.3e} (bound {bound:.0e}) "
         f"{'ok' if ok else 'FAILED'}{extra}")
    if not ok:
        raise AssertionError(f"{name}: {dev:.3e} > {bound:.0e}")


def pallas_calls(closed_jaxpr):
    """Every pallas_call equation in a jaxpr and its sub-jaxprs."""
    from jax.extend.core import ClosedJaxpr, Jaxpr

    found = []

    def walk(jx):
        for eqn in jx.eqns:
            if eqn.primitive.name == "pallas_call":
                found.append(eqn)
                continue
            for v in eqn.params.values():
                for sub in (v if isinstance(v, (tuple, list)) else (v,)):
                    if isinstance(sub, ClosedJaxpr):
                        walk(sub.jaxpr)
                    elif isinstance(sub, Jaxpr):
                        walk(sub)

    walk(closed_jaxpr.jaxpr)
    return found


# --------------------------------------------------------------------------
# Phases
# --------------------------------------------------------------------------

def flagship_setup(N: int):
    import jax.numpy as jnp

    from numpower_tpu.models import condense, quadrotor12

    A, B = quadrotor12(0.02)
    qp = condense(A, B, *(jnp.asarray(M, jnp.float32)
                          for M in flagship_costs()), T_FLAGSHIP)
    return A, B, qp, flagship_x0s(N)


def precision_note(path: str, solver: str, qp) -> str:
    from numpower_tpu.models.condensed import (
        admm_coarse_iters, default_coarse_iters,
    )

    if path == "xla" and solver == "admm":
        return "fp32 at matmul precision 'highest' throughout"
    ci = (admm_coarse_iters if solver == "admm"
          else default_coarse_iters)(qp, ITERS)
    if path == "xla":
        return (f"bf16 x{ci} coarse + fp32 'highest' x{ITERS - ci} tail")
    return (f"bf16 operands, fp32 accumulation x{ci} coarse + 3xTF32 "
            f"x{ITERS - ci} tail; 3xTF32 g/c and residual")


def solve_flagship(solver: str, method: str, interpret: bool = False):
    import jax

    from numpower_tpu.models import solve_mpc_boxqp, solve_mpc_boxqp_admm

    solve = solve_mpc_boxqp if solver == "fista" else solve_mpc_boxqp_admm
    return jax.jit(lambda qp, x: solve(qp, x, -1.0, 1.0, iters=ITERS,
                                       method=method, interpret=interpret))


def phase_flagship(N: int, interpret: bool = False):
    """Phase 1. Returns (name, fn, args) of each solve that took a kernel."""
    import jax

    from numpower_tpu.kernels.boxqp import fits
    from numpower_tpu.utils.platform import route

    _log(f"[1] flagship: quadrotor12 T={T_FLAGSHIP} d={4 * T_FLAGSHIP} "
         f"N={N} iters={ITERS}")
    t0 = time.perf_counter()
    _, _, qp, x0 = flagship_setup(N)
    U_ref = flagship_reference(x0)
    _log(f"  condense + fp64 reference {time.perf_counter() - t0:.1f}s, "
         f"kappa {qp.kappa:.3f}")
    x0s = jax.numpy.asarray(x0)
    auto = route("auto", fits=fits(qp.H.shape[0], qp.n))
    runs = [("auto", auto)] + ([("xla", "xla")] if auto != "xla" else [])
    if interpret:  # CPU rehearsal: the kernel in the Pallas interpreter
        runs = [("pallas", "interpret"), ("xla", "xla")]
    kernel_runs = []
    for solver in ("fista", "admm"):
        for method, path in runs:
            fn = solve_flagship(solver, method, interpret)
            t0 = time.perf_counter()
            res = jax.block_until_ready(fn(qp, x0s))
            check(f"{solver} method={method} ({path}) max|U - U*|",
                  max_dev(res.U, U_ref), BOUND,
                  f"; residual {float(res[2]):.3e}; "
                  f"{time.perf_counter() - t0:.1f}s with compile; "
                  f"{precision_note(path, solver, qp)}")
            if path != "xla":
                kernel_runs.append((f"{solver}/{method}", fn, (qp, x0s)))
    stats = jax.devices()[0].memory_stats() or {}
    _log(f"  peak_bytes_in_use {stats.get('peak_bytes_in_use', 'n/a')}")
    return kernel_runs


def phase_serving(N: int, ticks: int = 5, mesh=None, ref: bool = True):
    """Phase 2. Returns ({solver: [plan per tick]}, [(name, fn, args)])."""
    import jax
    import jax.numpy as jnp

    from numpower_tpu.models import MPCController
    from numpower_tpu.parallel import shard_batch

    A, B, _, x0 = flagship_setup(N)
    Q, R, QF = (np.asarray(M, np.float32) for M in flagship_costs())
    A64, B64 = quadrotor_plant()
    H, G = condense_ref(A64, B64, *flagship_costs(), T_FLAGSHIP)
    plans, steps = {}, []
    where = f" mesh {dict(mesh.shape)}" if mesh is not None else ""
    for solver in ("fista", "admm"):
        _log(f"[2] serving: MPCController solver={solver} N={N} "
             f"ticks={ticks}{where}")
        ctrl = MPCController(A, B, Q, R, QF, horizon=T_FLAGSHIP, u_lo=-1.0,
                             u_hi=1.0, iters=ITERS, solver=solver, mesh=mesh)
        state = ctrl.init(N)
        x = x0.astype(np.float64)
        plans[solver] = []
        for k in range(ticks):
            xk = jnp.asarray(x, jnp.float32)
            if mesh is not None:
                xk = shard_batch(xk, mesh)
            if k == 0:  # shapes only: ctrl.step donates the state
                steps.append((f"serving/{solver}", jax.jit(ctrl._step_impl),
                              jax.tree.map(lambda a: jax.ShapeDtypeStruct(
                                  a.shape, a.dtype), (ctrl.qp, state, xk))))
            t0 = time.perf_counter()
            u0, state = ctrl.step(state, xk)
            U = np.asarray(state.U_prev, np.float64)
            dt = time.perf_counter() - t0
            plans[solver].append(U)
            if ref:
                check(f"tick {k} max|U - U*|",
                      max_dev(U, boxqp_ref(H, x @ G, -1.0, 1.0)), BOUND,
                      f"; {dt:.2f}s")
            x = x @ A64.T + np.asarray(u0, np.float64) @ B64.T
        n_exe = ctrl.compile_cache_size()
        _log(f"  compile_cache_size() = {n_exe}")
        if n_exe != 1:
            raise AssertionError(f"serving {solver} retraced: {n_exe}")
    return plans, steps


def phase_routes(runs, expect_kernel: bool):
    """Phase 3: no pallas_call is interpreted; a chosen kernel is in the
    compiled HLO as a Triton call."""
    import jax

    _log("[3] route check")
    for name, fn, args in runs:
        calls = pallas_calls(jax.make_jaxpr(fn)(*args))
        if any(c.params.get("interpret") for c in calls):
            raise AssertionError(f"{name}: a pallas_call runs interpreted")
        lowered = jax.jit(fn).lower(*args)
        in_hlo = ("__gpu$xla.gpu.triton" in lowered.as_text()
                  and "triton" in lowered.compile().as_text().lower())
        names = sorted({str(c.params.get("name")) for c in calls})
        _log(f"  {name}: pallas_calls {names}, none interpreted; Triton "
             f"call in compiled HLO: {in_hlo}")
        if expect_kernel and not (calls and in_hlo):
            raise AssertionError(f"{name}: kernel missing from compiled HLO")


def phase_families(scale: float = 1.0):
    """Phase 4: the families whose hand-written kernels were removed, on XLA, at the
    bench sizes (scale < 1 shrinks the batches for a CPU rehearsal)."""
    import jax
    import jax.numpy as jnp

    from numpower_tpu.models import (
        cartpole_step, double_integrator, ilqr_solve_batched,
        kalman_filter_batched, mppi_solve, mppi_solve_batched,
        particle_filter_batched, pendulum_step, quadratic_mppi_cost,
        quadrotor12, riccati_scan_per_scenario,
    )
    from numpower_tpu.models.estimation import (
        ekf_filter_batched, kalman_smoother_batched, ukf_filter_batched,
    )

    def size(n):
        return max(2, int(n * scale))

    rng = np.random.default_rng(4)
    f32 = np.float32
    _log("[4] families on XLA")

    # per-scenario Riccati, N=4096, n=12, T=30
    N = size(4096)
    A, B = quadrotor12(0.02)
    Q, R, QF = flagship_costs()
    As = (np.tile(A, (N, 1, 1)) + 0.01 * rng.standard_normal((N, 12, 12))
          ).astype(f32)
    Bs = np.broadcast_to(B, (N, 12, 4)).astype(f32)
    Ks, _ = jax.jit(riccati_scan_per_scenario, static_argnums=5)(
        As, Bs, Q.astype(f32), R.astype(f32), QF.astype(f32), T_FLAGSHIP)
    dev = max(rel_dev(Ks[i], riccati_ref(As[i].astype(float), B.astype(float),
                                         Q, R, QF, T_FLAGSHIP))
              for i in (0, N - 1))
    check(f"per-scenario Riccati N={N} n=12 T={T_FLAGSHIP}: rel |K - K*| "
          "vs fp64", dev, 1e-3)

    # batched iLQR, 256 scenarios, h=50, 10 iterations: on the cartpole
    # (the bench) every scenario must descend; on a linear plant the fp64
    # LQR policy is the optimum, so iLQR's cost must reach it
    N = size(256)
    Qc = jnp.diag(jnp.array([1.0, 10.0, 0.1, 0.1]))
    Rc = jnp.eye(1) * 0.01
    QFc = jnp.diag(jnp.array([10.0, 100.0, 1.0, 1.0]))
    x0s = jnp.asarray(0.3 * rng.standard_normal((N, 4)), jnp.float32)
    res = jax.jit(lambda x: ilqr_solve_batched(
        cartpole_step, x, Qc, Rc, QFc, jnp.zeros(4), horizon=50, iters=10,
        use_fd=True))(x0s)
    costs = np.asarray(res.costs, np.float64)
    rise = float(np.max(np.maximum(np.diff(costs, axis=1), 0.0)
                        / np.abs(costs[:, :-1])))
    check(f"batched iLQR N={N} cartpole h=50: worst relative cost rise "
          "between iterations", rise if np.isfinite(costs).all() else
          np.inf, 1e-6)
    Ad, Bd = (np.asarray(M, float) for M in double_integrator(0.1))
    Ql, Rl, QFl = np.eye(2), 0.1 * np.eye(1), 10.0 * np.eye(2)
    x0l = rng.standard_normal((N, 2)).astype(f32)
    Al, Bl = jnp.asarray(Ad, jnp.float32), jnp.asarray(Bd, jnp.float32)
    lq = jax.jit(lambda x: ilqr_solve_batched(
        lambda s, u: Al @ s + Bl @ u, x, *(jnp.asarray(M, jnp.float32)
                                           for M in (Ql, Rl, QFl)),
        jnp.zeros(2), horizon=50, iters=10))(x0l)
    Ks = riccati_ref(Ad, Bd, Ql, Rl, QFl, 50)

    def lq_cost(x, us):  # fp64, the iLQR objective
        J = 0.0
        for u in us:
            J += x @ Ql @ x + u @ Rl @ u
            x = Ad @ x + Bd @ u
        return J + x @ QFl @ x

    gap = 0.0
    for i in (0, N - 1):
        x, us = x0l[i].astype(float), []
        for K in Ks:
            us.append(-K @ x)
            x = Ad @ x + Bd @ us[-1]
        J_star = lq_cost(x0l[i].astype(float), us)
        J = lq_cost(x0l[i].astype(float), np.asarray(lq.us[i], float))
        gap = max(gap, (J - J_star) / J_star)
    check(f"batched iLQR N={N} linear plant h=50: relative cost gap to the "
          "fp64 LQR optimum", gap, 1e-5)

    # batched KF and RTS, N=4096, T=50, double integrator
    N, T = size(4096), 50
    Ad, _ = double_integrator(0.1)
    Ad = np.asarray(Ad, float)
    C = np.array([[1.0, 0.0]])
    Qk, Rk, P0 = 1e-3 * np.eye(2), 1e-2 * np.eye(1), 0.1 * np.eye(2)
    yss = rng.standard_normal((N, T, 1)).astype(f32)
    x0k = rng.standard_normal((N, 2)).astype(f32)
    args = [jnp.asarray(M, jnp.float32) for M in (Ad, C, Qk, Rk)]
    filt = jax.jit(lambda x, y: kalman_filter_batched(
        args[0], args[1], args[2], args[3], x, jnp.asarray(P0, jnp.float32),
        y))(x0k, yss)
    sm = jax.jit(lambda fl: kalman_smoother_batched(args[0], fl))(filt)
    dkf = drts = 0.0
    for i in (0, N - 1):
        xf, Pf, xp, Pp = kalman_ref(Ad, C, Qk, Rk, x0k[i].astype(float), P0,
                                    yss[i].astype(float))
        dkf = max(dkf, rel_dev(filt.means[i], xf))
        drts = max(drts, rel_dev(sm.means[i], rts_ref(Ad, xf, Pf, xp, Pp)))
    check(f"batched KF N={N} T={T}: rel |x - x*| vs fp64", dkf, 1e-4)
    check(f"batched RTS N={N} T={T}: rel |x - x*| vs fp64", drts, 1e-4)

    # batched EKF and UKF, N=1024, T=50, pendulum (the estimation bench)
    N = size(1024)
    ys = rng.standard_normal((N, T, 1)).astype(f32)
    us = np.zeros((N, T, 1), f32)
    x0e = (0.3 * rng.standard_normal((N, 2))).astype(f32)

    def f_pend(x, u):
        return jnp.stack([x[0] + DT_PEND * x[1],
                          x[1] - DT_PEND * G_PEND * jnp.sin(x[0])
                          + DT_PEND * u[0]])

    Qe, Re = jnp.eye(2) * 1e-3, jnp.eye(1) * 1e-2
    P0e = jnp.eye(2) * 0.1
    for name, fn, ref in (("EKF", ekf_filter_batched, ekf_ref),
                          ("UKF", ukf_filter_batched, ukf_ref)):
        out = jax.jit(lambda x, y, u, fn=fn: fn(
            f_pend, lambda s: s[:1], Qe, Re, x, P0e, y, u))(x0e, ys, us)
        dev = max(rel_dev(out.means[i], ref(
            1e-3 * np.eye(2), 1e-2 * np.eye(1), x0e[i].astype(float),
            0.1 * np.eye(2), ys[i].astype(float), us[i].astype(float)))
            for i in (0, N - 1))
        check(f"batched {name} N={N} T={T} pendulum: rel |x - x*| vs fp64",
              dev, 1e-3)

    # MPPI, 256 scenarios x 256 samples, pendulum h=40, 8 updates
    N = size(256)
    Qp, Rp = jnp.diag(jnp.array([1.0, 0.1])), jnp.eye(1) * 0.01
    QFp = jnp.diag(jnp.array([100.0, 10.0]))
    cost = quadratic_mppi_cost(Qp, Rp, QFp, jnp.zeros(2))
    x0m = jnp.asarray(rng.uniform(-np.pi, np.pi, (N, 2)), jnp.float32)
    key = jax.random.key(0)
    kw = dict(samples=256, iters=8, m=1)
    res = jax.jit(lambda x, k: mppi_solve_batched(
        pendulum_step, x, cost, 40, k, **kw))(x0m, key)
    keys = jax.random.split(key, N)
    single = jax.jit(lambda x, k: mppi_solve(pendulum_step, x, cost, 40, k,
                                             **kw))
    dev = max(abs(float(res.cost[i]) / float(single(x0m[i], keys[i]).cost)
                  - 1.0) for i in (0, N - 1))
    check(f"MPPI N={N} K=256 h=40: rel cost vs unbatched mppi_solve on the "
          "same key", dev, 1e-3)

    # particle filter, 256 trajectories x 1024 particles, T=50, on a
    # linear-Gaussian plant where the fp64 Kalman filter is the exact
    # posterior mean
    N, Np = size(256), 1024
    xs = np.zeros((N, 2))
    ysp = np.zeros((N, T, 1))
    for t in range(T):
        xs = xs @ Ad.T + rng.multivariate_normal(np.zeros(2), Qk, N)
        ysp[:, t] = xs[:, :1] + 0.1 * rng.standard_normal((N, 1))
    pf = jax.jit(lambda y, k: particle_filter_batched(
        lambda x, u: args[0] @ x, lambda x: x[:1], args[2], args[3],
        jnp.zeros((N, 2)), jnp.asarray(P0, jnp.float32), y,
        jnp.zeros((N, T, 1)), k, n_particles=Np))(
            jnp.asarray(ysp, jnp.float32), jax.random.key(1))
    z = []
    for i in range(min(N, 8)):
        xf, Pf, _, _ = kalman_ref(Ad, C, Qk, Rk, np.zeros(2), P0, ysp[i])
        z.append((np.asarray(pf.means[i], np.float64) - xf)
                 / np.sqrt(np.diagonal(Pf, axis1=1, axis2=2)))
    check(f"particle filter {N}x{Np} T={T} linear-Gaussian: RMS of "
          "(mean - KF mean)/KF std", float(np.sqrt(np.mean(np.square(z)))),
          0.25)

    # resampling routes: the one-hot contraction and the gather give the
    # same cloud, element for element
    from numpower_tpu.models.particle import _systematic_resample

    parts = jnp.asarray(rng.standard_normal((Np, 2)), jnp.float32)
    logw = jnp.asarray(rng.standard_normal(Np), jnp.float32)
    resample = jax.jit(_systematic_resample, static_argnames="method")
    dev = max(max_dev(resample(k, parts, logw, method="onehot")[0],
                      np.asarray(resample(k, parts, logw, method="gather")[0],
                                 np.float64))
              for k in jax.random.split(jax.random.key(2), 4))
    check(f"PF resampling N={Np}: one-hot vs gather, 4 keys", dev, 0.0)

    # parallel-in-time Riccati and Kalman filter (T=512) vs fp64
    from numpower_tpu.models.estimation import kalman_filter_associative
    from numpower_tpu.models.lqr import riccati_associative

    T_long = 512
    Ks, _ = jax.jit(riccati_associative, static_argnums=5)(
        *(jnp.asarray(M, jnp.float32) for M in (A, B, Q, R, QF)), T_long)
    check(f"associative Riccati T={T_long} n=12: rel |K - K*| vs fp64",
          rel_dev(Ks, riccati_ref(A.astype(float), B.astype(float), Q, R, QF,
                                  T_long)), 1e-3)
    ys_long = rng.standard_normal((T_long, 1))
    kf = jax.jit(kalman_filter_associative)(
        *args, jnp.zeros(2), jnp.asarray(P0, jnp.float32),
        jnp.asarray(ys_long, jnp.float32))
    check(f"associative KF T={T_long}: rel |x - x*| vs fp64",
          rel_dev(kf.means, kalman_ref(Ad, C, Qk, Rk, np.zeros(2), P0,
                                       ys_long)[0]), 1e-4)

    # jit(eig): LAPACK through a host callback, inside a compiled program
    from numpower_tpu import ops

    M = rng.standard_normal((8, 8)).astype(f32)
    w, _ = jax.jit(ops.eig)(jnp.asarray(M))
    check("jit(eig) 8x8 eigenvalues vs NumPy", max_dev(
        np.sort(np.asarray(w)), np.sort(np.real(np.linalg.eigvals(M)))),
        1e-3)


def phase_mesh(N: int = N_MESH, ticks: int = 3):
    """--devices 4: the sharded solvers and mesh serving vs one device."""
    import jax

    from numpower_tpu.models import solve_mpc_boxqp, solve_mpc_boxqp_admm
    from numpower_tpu.parallel import (
        make_mesh, shard_batch, solve_mpc_boxqp_admm_dp, solve_mpc_boxqp_dp,
        solve_mpc_boxqp_dp_tp,
    )

    devices = jax.devices()[:4]
    if len(devices) < 4:
        raise AssertionError(f"--devices 4 needs 4 devices, have {len(devices)}")
    _log(f"[mesh] N={N} T={T_FLAGSHIP} iters={ITERS} on {len(devices)} "
         "devices")
    _, _, qp, x0 = flagship_setup(N)
    U_ref = flagship_reference(x0)
    x0s = jax.numpy.asarray(x0)
    single = {
        "fista": solve_mpc_boxqp(qp, x0s, -1.0, 1.0, iters=ITERS).U,
        "admm": solve_mpc_boxqp_admm(qp, x0s, -1.0, 1.0, iters=ITERS).U,
    }
    m41 = make_mesh((4, 1), devices=devices)
    m22 = make_mesh((2, 2), devices=devices)
    cases = (
        ("solve_mpc_boxqp_dp (4, 1)", "fista", lambda: solve_mpc_boxqp_dp(
            qp, shard_batch(x0s, m41), -1.0, 1.0, m41, iters=ITERS)),
        ("solve_mpc_boxqp_admm_dp (4, 1)", "admm",
         lambda: solve_mpc_boxqp_admm_dp(qp, shard_batch(x0s, m41), -1.0,
                                         1.0, m41, iters=ITERS)),
        ("solve_mpc_boxqp_dp_tp (2, 2)", "fista",
         lambda: solve_mpc_boxqp_dp_tp(qp, x0s, -1.0, 1.0, m22,
                                       iters=ITERS)),
    )
    for name, solver, run in cases:
        t0 = time.perf_counter()
        U = jax.block_until_ready(run().U)
        dt = time.perf_counter() - t0
        check(f"{name} vs single device", max_dev(U, np.asarray(
            single[solver], np.float64)), MESH_BOUND)
        check(f"{name} vs fp64", max_dev(U, U_ref), BOUND,
              f"; {dt:.1f}s with compile")
    plans_mesh, _ = phase_serving(N, ticks, mesh=m41)
    plans_one, _ = phase_serving(N, ticks, ref=False)
    for solver in plans_mesh:
        for k, (Um, U1) in enumerate(zip(plans_mesh[solver],
                                         plans_one[solver])):
            check(f"mesh serving {solver} tick {k} vs single-device "
                  "controller", max_dev(Um, U1), MESH_BOUND)


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, choices=(1, 4), default=1)
    args = ap.parse_args()

    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        print(f"chip_smoke: needs a GPU; JAX's default backend is "
              f"{backend!r}", file=sys.stderr)
        sys.exit(1)
    from numpower_tpu.utils.config import enable_compile_cache

    _log(card_line(), jax.devices())
    _log(f"compile cache: {enable_compile_cache()}")
    t0 = time.perf_counter()
    if args.devices == 4:
        phase_mesh()
    else:
        runs = phase_flagship(N_FLAGSHIP)
        _, steps = phase_serving(N_FLAGSHIP)
        phase_routes(runs + steps, expect_kernel=bool(runs))
        phase_families()
    _log(f"all phases passed in {time.perf_counter() - t0:.1f}s; "
         f"{card_line()}")
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
