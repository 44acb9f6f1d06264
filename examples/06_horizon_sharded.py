"""Horizon-sharded (sequence-parallel) solvers: the time axis on the mesh.

Two engines for LONG horizons (SURVEY.md §2.5 SP/PP rows):

 1. riccati_associative_sharded — backward Riccati with the horizon sharded
    across devices (Blelloch two-level suffix scan; one all_gather of block
    totals per solve).
 2. rollout_lti_pipelined — batched forward rollouts pipelined through
    horizon stage groups (microbatches flow device-to-device via ppermute).

Run on any machine:
    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
        python examples/06_horizon_sharded.py
"""

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from numpower_tpu.models import batched_rollout_lti, double_integrator  # noqa: E402
from numpower_tpu.models.lqr import riccati_scan  # noqa: E402
from numpower_tpu.parallel import (  # noqa: E402
    make_mesh, riccati_associative_sharded, rollout_lti_pipelined,
)

A, B = double_integrator(0.05)
Q = jnp.eye(2)
R = jnp.eye(1) * 0.1
QF = jnp.eye(2) * 10.0

D = min(jax.device_count(), 8)
mesh = make_mesh((1, D), axis_names=("data", "model"))

# --- 1. horizon-sharded Riccati ---------------------------------------------
T = 64 * D  # must be a multiple of the horizon axis
Ks_sh, Ps_sh = riccati_associative_sharded(A, B, Q, R, QF, T, mesh)
Ks, _ = riccati_scan(A, B, Q, R, QF, T)
print(f"sharded Riccati T={T} over {D} devices: "
      f"max|dK| = {float(jnp.max(jnp.abs(Ks_sh - Ks))):.2e}")

# --- 2. pipelined rollout (ragged shapes welcome) ----------------------------
rng = np.random.default_rng(0)
N, T_roll = 13, 123            # deliberately not multiples of D
x0s = jnp.asarray(rng.standard_normal((N, 2)).astype(np.float32))
us = jnp.asarray(0.1 * rng.standard_normal((N, T_roll, 1)).astype(np.float32))
xs = rollout_lti_pipelined(jnp.asarray(A), jnp.asarray(B), x0s, us, mesh)
ref = batched_rollout_lti(A, B, x0s, us)
print(f"pipelined rollout N={N} T={T_roll}: full trajectories {xs.shape}, "
      f"max err = {float(jnp.max(jnp.abs(xs - ref))):.2e}")
