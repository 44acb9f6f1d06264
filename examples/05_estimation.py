"""Estimation family: KF / sqrt-KF / RTS smoother / EKF / UKF / PF / MHE.

Run: PYTHONPATH=. python examples/05_estimation.py  (default backend;
JAX_PLATFORMS=cpu for a CPU run)
"""

import jax

from numpower_tpu.utils.config import enable_compile_cache

enable_compile_cache()

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from numpower_tpu.models import (  # noqa: E402
    double_integrator, ekf_filter, kalman_filter, kalman_filter_associative,
    kalman_smoother, mhe_solve, pendulum_step, rollout_nonlinear, ukf_filter,
)

A, B = double_integrator(0.1)
C = jnp.array([[1.0, 0.0]])
Q = jnp.eye(2) * 1e-3
R = jnp.eye(1) * 1e-2

# simulate noisy data
rng = np.random.default_rng(0)
T = 50
x = np.array([1.0, 0.0]); ys = []; xs_true = []
for _ in range(T):
    x = np.asarray(A) @ x + rng.normal(0, 0.03, 2)
    ys.append([x[0] + rng.normal(0, 0.1)]); xs_true.append(x.copy())
ys = jnp.asarray(np.array(ys, np.float32)); xs_true = np.array(xs_true)
x0, P0 = jnp.array([1.0, 0.0]), jnp.eye(2) * 0.1

filt = kalman_filter(A, C, Q, R, x0, P0, ys)
sm = kalman_smoother(A, filt)
par = kalman_filter_associative(A, C, Q, R, x0, P0, ys)  # O(log T) depth
mhe = mhe_solve(A, C, Q, R, P0, x0, ys[:20],
                x_lo=jnp.array([-10.0, -1.0]), x_hi=jnp.array([10.0, 1.0]))

err = lambda m: np.abs(np.asarray(m)[:, 0] - xs_true[: len(np.asarray(m)), 0]).mean()
print(f"measurement err {np.abs(np.asarray(ys)[:,0]-xs_true[:,0]).mean():.4f}")
print(f"filter err      {err(filt.means):.4f}  (ll={float(filt.log_likelihood):.1f})")
print(f"smoother err    {err(sm.means):.4f}")
print(f"parallel == sequential: "
      f"{float(jnp.max(jnp.abs(par.means - filt.means))):.1e}")
print(f"MHE window (velocity bounded to [-1,1]): "
      f"max|v| = {float(jnp.max(jnp.abs(mhe.xs[:,1]))):.3f}")

# nonlinear: EKF vs UKF on the pendulum with angle-only sensing
us = jnp.zeros((40, 1))
xs_t = rollout_nonlinear(pendulum_step, jnp.array([0.8, 0.0]), us)
ys2 = jnp.asarray(np.asarray(xs_t[1:, :1])
                  + 0.03 * rng.standard_normal((40, 1)).astype(np.float32))
h = lambda x: x[:1]
for name, f in [("EKF", ekf_filter), ("UKF", ukf_filter)]:
    r = f(pendulum_step, h, jnp.eye(2) * 1e-4, jnp.eye(1) * 1e-3,
          jnp.array([0.5, 0.0]), jnp.eye(2), ys2, us)
    e = np.abs(np.asarray(r.means)[:, 0] - np.asarray(xs_t)[1:, 0]).mean()
    print(f"{name} pendulum angle err: {e:.4f}")

# square-root filter: identical posterior, PSD by construction in fp32
from numpower_tpu.models import kalman_filter_sqrt, particle_filter  # noqa: E402

sq = kalman_filter_sqrt(A, C, Q, R, x0, P0, ys)
print(f"sqrt-KF == KF: {float(jnp.max(jnp.abs(sq.means - filt.means))):.1e}")

# particle filter: the non-Gaussian member (pendulum, angle-only sensing)
pf = particle_filter(pendulum_step, h, jnp.eye(2) * 1e-4, jnp.eye(1) * 1e-3,
                     jnp.array([0.5, 0.0]), jnp.eye(2), ys2, us,
                     jax.random.key(0), n_particles=2048)
e = np.abs(np.asarray(pf.means)[:, 0] - np.asarray(xs_t)[1:, 0]).mean()
print(f"PF pendulum angle err: {e:.4f} (min ESS {float(pf.ess.min()):.0f})")

# batched fleets: ekf/ukf_filter_batched run B trajectories at once
from numpower_tpu.models import ekf_filter_batched, ukf_filter_batched  # noqa: E402

Bn = 16
ys_b = jnp.broadcast_to(ys2, (Bn,) + ys2.shape)
us_b = jnp.zeros((Bn, 40, 1))
x0s_b = jnp.asarray(
    np.tile([0.5, 0.0], (Bn, 1)) + 0.05 * rng.standard_normal((Bn, 2)),
    jnp.float32)
for name, fb in [("EKF", ekf_filter_batched), ("UKF", ukf_filter_batched)]:
    rb = fb(pendulum_step, h, jnp.eye(2) * 1e-4, jnp.eye(1) * 1e-3,
            x0s_b, jnp.eye(2), ys_b, us_b)
    print(f"batched {name}: {Bn} trajectories, "
          f"mean ll {float(rb.log_likelihood.mean()):.1f}")

# batched linear fleet + RTS: shared-covariance filter and shared-gain
# smoother run the tiny recursions once and batch only the mean passes
from numpower_tpu.models import (  # noqa: E402
    kalman_filter_batched, kalman_smoother_batched,
)

ys_lb = jnp.broadcast_to(ys, (Bn,) + ys.shape)
x0s_lb = jnp.asarray(
    np.tile([1.0, 0.0], (Bn, 1)) + 0.05 * rng.standard_normal((Bn, 2)),
    jnp.float32)
fb = kalman_filter_batched(A, C, Q, R, x0s_lb, P0, ys_lb)
smb = kalman_smoother_batched(A, fb)
print(f"batched KF+RTS: {Bn} trajectories, smoother err "
      f"{np.abs(np.asarray(smb.means)[:, :, 0] - xs_true[:, 0]).mean():.4f}")
