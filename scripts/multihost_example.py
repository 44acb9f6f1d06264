#!/usr/bin/env python
"""Multi-host tube-MPC sweep example (BASELINE config #5 at pod scale).

Run ONE copy of this script per host of a multi-host cluster:

    # on every host (a cluster JAX auto-detects, e.g. SLURM):
    python scripts/multihost_example.py --scenarios 65536

jax.distributed.initialize() auto-detects the cluster (coordinator, process
id, device topology); elsewhere pass coordinator_address, num_processes and
process_id. Afterwards jax.devices() spans every card and the SAME mesh
programs used on one card scale out — XLA routes the collectives (NCCL
between GPUs). There is nothing else to configure (SURVEY.md §2.5).

Single-process environments fall back gracefully, so this file also serves
as a runnable smoke test:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
        python scripts/multihost_example.py --scenarios 512 --cpu
"""

import argparse
import sys

sys.path.insert(0, ".")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenarios", type=int, default=65536)
    ap.add_argument("--horizon", type=int, default=30)
    ap.add_argument("--steps", type=int, default=10, help="receding-horizon ticks")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from numpower_tpu.parallel import initialize, local_scenario_slice

    initialize()  # no-op on single process

    import jax.numpy as jnp
    import numpy as np

    from numpower_tpu.models import condense, quadrotor12
    from numpower_tpu.parallel import (
        make_mesh, shard_batch, solve_mpc_boxqp_dp, sweep_statistics_dp,
    )
    from numpower_tpu.runtime.stream import ScenarioStream
    from numpower_tpu.utils.profiler import time_compiled

    n_dev = jax.device_count()
    print(f"processes={jax.process_count()} devices={n_dev}")
    if args.scenarios % n_dev:
        args.scenarios -= args.scenarios % n_dev

    A, B = quadrotor12(0.02)
    Q = np.eye(12, dtype=np.float32)
    R = np.eye(4, dtype=np.float32) * 0.1
    QF = np.eye(12, dtype=np.float32) * 5.0
    qp = jax.jit(condense, static_argnums=5)(A, B, Q, R, QF, args.horizon)

    mesh = make_mesh((n_dev, 1))

    # host-local scenario generation feeding the global sharded batch: each
    # process generates only its slice (native C++ stream loader)
    sl = local_scenario_slice(args.scenarios)
    local_n = sl.stop - sl.start
    with ScenarioStream(batch=local_n, shape=(12,), seed=jax.process_index(),
                        dist="normal", scale=0.3) as stream:
        x0s_local = next(stream)
    if jax.process_count() > 1:
        # multi-host: assemble the global sharded array from per-process
        # local slices (device_put cannot address other hosts' devices)
        from numpower_tpu.parallel import data_sharding

        x0s = jax.make_array_from_process_local_data(
            data_sharding(mesh), x0s_local, (args.scenarios, 12)
        )
    else:
        x0s = shard_batch(jnp.asarray(x0s_local), mesh)

    res = solve_mpc_boxqp_dp(qp, x0s, -1.0, 1.0, mesh, iters=40)
    mean_u = sweep_statistics_dp(
        res.U.reshape(x0s.shape[0], args.horizon, 4), mesh
    )[0]
    print(f"sweep residual={float(res.residual):.2e} mean|u0|={float(jnp.abs(mean_u[0]).mean()):.4f}")

    dt = time_compiled(
        lambda qp, x0s: solve_mpc_boxqp_dp(qp, x0s, -1.0, 1.0, mesh, iters=40).U,
        qp, x0s, reps=3,
    )
    rate = x0s.shape[0] / dt
    print(f"{rate:,.0f} solves/s across {n_dev} devices "
          f"({rate/n_dev:,.0f} per device)")


if __name__ == "__main__":
    main()
