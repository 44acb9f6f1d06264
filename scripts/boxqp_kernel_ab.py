"""Time the fused box-QP kernels against the XLA path on one GPU.

    python scripts/boxqp_kernel_ab.py [--scenarios 4096] [--reps 7]

Flagship QP (quadrotor12, T=30, d=120, 40 iterations). Each variant is one
jitted solve from x0s to (U, residual) through the public solvers
(method="xla" or "pallas", default and all-fp32 schedules); variants are
timed in turns inside one process (K back-to-back solves ending in
block_until_ready, median over reps) and each U is compared with the fp64
reference of chip_smoke.py.
Prints one line per variant and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenarios", type=int, default=4096)
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--k", type=int, default=20)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from chip_smoke import flagship_costs, flagship_reference, flagship_x0s
    from numpower_tpu.models import (
        condense, quadrotor12, solve_mpc_boxqp, solve_mpc_boxqp_admm,
    )
    from numpower_tpu.utils.config import enable_compile_cache

    enable_compile_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, jax.devices(), flush=True)

    A, B = quadrotor12(0.02)
    Q, R, QF = (np.asarray(M, np.float32) for M in flagship_costs())
    qp = condense(A, B, Q, R, QF, 30)
    x0_np = flagship_x0s(args.scenarios)
    x0s = jnp.asarray(x0_np)
    U_ref = flagship_reference(x0_np)

    variants = {}
    for method in ("xla", "pallas"):
        variants[f"fista_{method}"] = jax.jit(
            lambda qp, x, m=method: solve_mpc_boxqp(qp, x, -1.0, 1.0,
                                                    iters=40, method=m)[::2])
        variants[f"admm_{method}"] = jax.jit(
            lambda qp, x, m=method: solve_mpc_boxqp_admm(
                qp, x, -1.0, 1.0, iters=40, method=m)[::2])
    variants["fista_xla_fp32"] = jax.jit(
        lambda qp, x: solve_mpc_boxqp(qp, x, -1.0, 1.0, iters=40,
                                      method="xla", coarse_iters=0)[::2])
    variants["fista_pallas_fp32"] = jax.jit(
        lambda qp, x: solve_mpc_boxqp(qp, x, -1.0, 1.0, iters=40,
                                      method="pallas", coarse_iters=0)[::2])
    variants["admm_pallas_fp32"] = jax.jit(
        lambda qp, x: solve_mpc_boxqp_admm(qp, x, -1.0, 1.0, iters=40,
                                           method="pallas",
                                           coarse_iters=0)[::2])

    live = {}
    for name, f in variants.items():
        try:
            t0 = time.perf_counter()
            U, r = jax.block_until_ready(f(qp, x0s))
            dev = float(np.max(np.abs(np.asarray(U, np.float64) - U_ref)))
            print(f"{name}: compiled+ran {time.perf_counter() - t0:.1f}s "
                  f"dev_vs_fp64={dev:.3e} resid={float(r):.3e}", flush=True)
            live[name] = f
        except Exception as e:  # report and keep timing the others
            print(f"{name}: FAILED {type(e).__name__}: {str(e)[:2000]}",
                  flush=True)

    times = {name: [] for name in live}
    for _ in range(args.reps):
        for name, f in live.items():
            jax.block_until_ready(f(qp, x0s))
            t0 = time.perf_counter()
            for _ in range(args.k):
                out = f(qp, x0s)
            jax.block_until_ready(out)
            times[name].append((time.perf_counter() - t0) / args.k * 1e6)
    for name, ts in times.items():
        print(f"{name}: median {np.median(ts):.1f} us/solve "
              f"(min {min(ts):.1f}, max {max(ts):.1f}, reps {len(ts)}, "
              f"N={args.scenarios})", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
