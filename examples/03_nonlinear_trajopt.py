"""Nonlinear trajectory optimization: iLQR, AL-iLQR (box constraints), MPPI.

Run: PYTHONPATH=. python examples/03_nonlinear_trajopt.py  (default backend;
JAX_PLATFORMS=cpu for a CPU run)
"""

import jax

from numpower_tpu.utils.config import enable_compile_cache

enable_compile_cache()

import jax.numpy as jnp  # noqa: E402

from numpower_tpu.models import (  # noqa: E402
    al_ilqr_solve, cartpole_step, ilqr_solve, mppi_solve, pendulum_step,
    quadratic_mppi_cost, unicycle_step,
)

# iLQR: cartpole swing toward upright
x0 = jnp.array([0.0, jnp.pi, 0.0, 0.0])
Q = jnp.diag(jnp.array([1.0, 10.0, 0.1, 0.1]))
R = jnp.eye(1) * 0.01
QF = jnp.diag(jnp.array([10.0, 100.0, 1.0, 1.0]))
res = ilqr_solve(cartpole_step, x0, Q, R, QF, jnp.zeros(4), horizon=60,
                 iters=30, unroll_scans=True)  # single-scenario latency opt-in
print(f"iLQR cartpole: cost {float(res.costs[0]):.1f} -> {float(res.cost):.1f}")

# AL-iLQR: pendulum swingup with |u| <= 2 (hard constraint, not a clip)
Qp = jnp.diag(jnp.array([1.0, 0.1]))
Rp = jnp.eye(1) * 0.01
QFp = jnp.diag(jnp.array([100.0, 10.0]))
res = al_ilqr_solve(pendulum_step, jnp.array([jnp.pi, 0.0]), Qp, Rp, QFp,
                    jnp.zeros(2), horizon=80, u_lo=-2.0, u_hi=2.0)
print(f"AL-iLQR pendulum: cost {float(res.cost):.1f}, "
      f"max|u| {float(jnp.max(jnp.abs(res.us))):.3f} (box 2.0), "
      f"violation {float(res.max_violation):.1e}")

# MPPI: sampling control on the nonholonomic unicycle
goal = jnp.array([1.0, 1.0, 0.0])
cost_fn = quadratic_mppi_cost(jnp.diag(jnp.array([1.0, 1.0, 0.0])),
                              jnp.eye(2) * 0.01,
                              jnp.diag(jnp.array([50.0, 50.0, 0.0])), goal)
res = mppi_solve(unicycle_step, jnp.zeros(3), cost_fn, horizon=30,
                 key=jax.random.key(0), samples=512, iters=15, lam=0.5,
                 sigma=1.0, m=2)
print(f"MPPI unicycle final position: {res.xs[-1][:2]} (goal [1, 1]), "
      f"ESS {float(res.ess):.0f}/512")
