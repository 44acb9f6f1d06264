"""Multi-host runtime setup.

The reference is strictly single-process (SURVEY.md §2.5: no comm lib of any
kind). Here `jax.distributed.initialize` wires the multi-host XLA runtime;
collectives between GPUs go through NCCL. Solvers in numpower_tpu.parallel are written against a Mesh and
work unchanged on 1 chip, 1 host, or N hosts — only the mesh construction
differs (jax.devices() spans all hosts after initialize()).
"""

from __future__ import annotations

from typing import Optional

import jax


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize the multi-host runtime (idempotent, env-var driven when
    args are None — standard JAX cluster auto-detection; on a plain host
    pass coordinator_address, num_processes and process_id).

    Must run before any backend use: probing the backend first (even
    jax.process_count()) initializes a single-process runtime and the
    subsequent distributed init fails — use jax.distributed.is_initialized()
    for the idempotency check, never a device/process query. Executed for
    real by scripts/distributed_loopback.py (2-process CPU cluster)."""
    if jax.distributed.is_initialized():
        return  # already initialized
    if coordinator_address is not None:
        # Explicit cluster spec: let failures PROPAGATE — a silently
        # single-process "cluster" is the worst failure mode (every process
        # solves the full problem and collectives never cross hosts).
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
        return
    try:
        jax.distributed.initialize()
    except (ValueError, RuntimeError):
        # No cluster auto-detected (plain single-process env): run locally.
        pass


def is_multi_host() -> bool:
    return jax.process_count() > 1


def local_scenario_slice(n_total: int) -> slice:
    """Which slice of a global scenario batch this process owns (for
    host-local data loading feeding a data-axis-sharded array)."""
    per = n_total // jax.process_count()
    start = per * jax.process_index()
    return slice(start, start + per)


def scaling_report(solves_per_sec_1chip: float, solves_per_sec_now: float) -> dict:
    """Scaling efficiency vs linear (BASELINE: >=85% at 2+ hosts)."""
    n = jax.device_count()
    ideal = solves_per_sec_1chip * n
    eff = solves_per_sec_now / ideal if ideal > 0 else 0.0
    return {
        "devices": n,
        "processes": jax.process_count(),
        "solves_per_sec": solves_per_sec_now,
        "ideal": ideal,
        "efficiency": eff,
    }
