"""Output-feedback control: noisy sensing -> Kalman filter -> MPC, in one scan.

Run: PYTHONPATH=. python examples/04_output_feedback_loop.py  (default backend;
JAX_PLATFORMS=cpu for a CPU run)
"""

import jax

from numpower_tpu.utils.config import enable_compile_cache

enable_compile_cache()

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from numpower_tpu.models import (  # noqa: E402
    MPCController, double_integrator, kalman_estimator, simulate_closed_loop,
)

A, B = double_integrator(0.1)
C = jnp.array([[1.0, 0.0]])  # position-only sensing

ctrl = MPCController(A, B, np.eye(2, dtype=np.float32),
                     0.1 * np.eye(1, dtype=np.float32),
                     10 * np.eye(2, dtype=np.float32),
                     horizon=15, u_lo=-1.0, u_hi=1.0)
make_state, kf_update = kalman_estimator(
    A, C, jnp.eye(2) * 1e-4, jnp.eye(1) * 1e-2, jnp.eye(2) * 0.5, B=B)

N = 16  # parallel closed loops (thousands on a real chip)
x0s = jnp.asarray(np.random.default_rng(0).uniform(-2, 2, (N, 2)), jnp.float32)

res = simulate_closed_loop(
    lambda x, u: A @ x + B @ u,          # true plant
    ctrl.callback(), ctrl.callback_init(N),
    x0s, steps=80, key=jax.random.key(1),
    w_std=0.01,                           # process noise
    h=lambda x: x[:1], v_std=0.05,        # noisy position measurement
    estimator=kf_update, est_state0=make_state(x0s),
)

final = np.abs(np.asarray(res.xs[-1])).max()
vel_err = np.abs(np.asarray(res.xhats)[20:, :, 1]
                 - np.asarray(res.xs)[21:, :, 1]).mean()
print(f"{N} closed loops, 80 ticks, one jitted scan")
print(f"final max |x|: {final:.3f} (regulated from up to 2.0)")
print(f"velocity estimate error: {vel_err:.3f} (velocity never measured)")
print(f"controls respected the box: max|u| = "
      f"{float(jnp.max(jnp.abs(res.us))):.3f} <= 1.0")
