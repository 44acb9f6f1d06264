"""Flagship MPC workflow: 4096-scenario quadrotor box-QP + serving controller.

Run: PYTHONPATH=. python examples/02_mpc_flagship.py  (default backend;
JAX_PLATFORMS=cpu for a CPU run)
On a GPU, method="auto" runs the fused box-QP kernels.
"""

import jax

from numpower_tpu.utils.config import enable_compile_cache

enable_compile_cache()

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from numpower_tpu.models import (  # noqa: E402
    MPCController, condense, quadrotor12, solve_mpc_boxqp,
    solve_mpc_boxqp_admm, solve_mpc_state_constrained,
)

A, B = quadrotor12(0.02)
Q = np.eye(12, dtype=np.float32)
R = 0.1 * np.eye(4, dtype=np.float32)
QF = 5 * np.eye(12, dtype=np.float32)
qp = jax.jit(condense, static_argnums=5)(A, B, Q, R, QF, 30)

N = 512  # 4096 on the GPU
x0s = jnp.asarray(0.3 * np.random.default_rng(0).standard_normal((N, 12)),
                  jnp.float32)

# one-shot batched solves: FISTA and ADMM converge to the same optimum
r1 = solve_mpc_boxqp(qp, x0s, -1.0, 1.0, iters=40)
r2 = solve_mpc_boxqp_admm(qp, x0s, -1.0, 1.0, iters=40)
print(f"FISTA residual {float(r1.residual):.1e}; "
      f"ADMM residuals {float(r2.primal_residual):.1e}/"
      f"{float(r2.dual_residual):.1e}; "
      f"max diff {float(jnp.max(jnp.abs(r1.U - r2.U))):.1e}")

# state constraints: full OSQP splitting. ALWAYS check primal_residual —
# bounds that the plant cannot satisfy with |u| <= 1 show up as a large
# residual (infeasibility), not an exception.
r3 = solve_mpc_state_constrained(qp, x0s[:32], -1.0, 1.0, -6.0, 6.0,
                                 iters=200)
print(f"state-constrained residual {float(r3.primal_residual):.1e} "
      f"(feasible bounds; +-2 would be infeasible here and report ~2.2)")

# receding-horizon serving: warm-started ticks
ctrl = MPCController(A, B, Q, R, QF, horizon=30, u_lo=-1.0, u_hi=1.0)
state = ctrl.init(N)
for tick in range(3):
    u0, state = ctrl.step(state, x0s)  # (N, 4) first-stage controls
print("tick controls shape:", u0.shape, " plan norm:",
      float(jnp.linalg.norm(u0)))
