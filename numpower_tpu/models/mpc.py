"""Receding-horizon MPC controller (production serving API).

Ties the stack together the way a deployment uses it: one controller object
holding a condensed QP, solving batches of scenarios every tick with warm
starts (shift the previous control plan one stage), all state checkpointable
(utils/checkpoint.py). The per-tick step is a single jitted program; the
controller object only shuffles device arrays — no host math on the tick
path (the 10 ms real-time budget, BASELINE.md).
"""

from __future__ import annotations

from typing import Optional

import dataclasses

import jax
import jax.numpy as jnp

from numpower_tpu.models.condensed import CondensedQP, condense


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class MPCState:
    """Warm-start state carried between ticks (checkpointable pytree)."""

    U_prev: jax.Array  # (N, T*m) previous optimal plans
    tick: jax.Array    # scalar int32


class MPCController:
    """Batched box-constrained linear MPC with warm starting.

    >>> ctrl = MPCController(A, B, Q, R, QF, horizon=30, u_lo=-1, u_hi=1)
    >>> state = ctrl.init(n_scenarios=4096)
    >>> u0, state = ctrl.step(state, x0s)   # (N, m) first-stage controls
    """

    def __init__(self, A, B, Q, R, QF, horizon: int, u_lo: float, u_hi: float,
                 iters: int = 30, coarse_iters: Optional[int] = None,
                 x_ref=None, mesh=None, solver: str = "fista"):
        """mesh: optional jax.sharding.Mesh for MULTI-CHIP serving — the tick
        solve runs the sharded DP solver (fused Pallas kernel per device,
        warm starts sharded with the scenarios over the first mesh axis).
        x_ref is not supported with a mesh (the sharded path is the
        regulation solve).

        solver: "fista" (default) or "admm" — the ADMM family is the faster
        solver at the flagship config (BASELINE.md) and warm-starts its z
        iterate from the shifted previous plan; available in both single-chip
        and mesh serving (VERDICT r2 weak #6). x_ref is FISTA-only."""
        if mesh is not None and x_ref is not None:
            raise ValueError("mesh serving does not support x_ref")
        if solver not in ("fista", "admm"):
            raise ValueError(f"unknown solver {solver!r} (fista|admm)")
        if solver == "admm" and x_ref is not None:
            raise ValueError("solver='admm' does not support x_ref")
        self.solver = solver
        self.mesh = mesh
        self.qp: CondensedQP = jax.jit(condense, static_argnums=5)(
            A, B, Q, R, QF, horizon
        )
        self.u_lo, self.u_hi = float(u_lo), float(u_hi)
        self.iters = int(iters)
        if coarse_iters is None:
            # qp is concrete here (condensed eagerly above), so the
            # condition-aware schedules apply (models/condensed.py)
            from numpower_tpu.models.condensed import (
                admm_coarse_iters, default_coarse_iters,
            )

            sched = admm_coarse_iters if solver == "admm" else default_coarse_iters
            self.coarse_iters = sched(self.qp, self.iters)
        else:
            self.coarse_iters = int(coarse_iters)
        self.x_ref = x_ref
        # Donate the warm-start state (arg 1): U_prev is (N, T*m) — the
        # largest tick-path buffer — and a new one of identical shape/dtype
        # is returned every tick, so donation lets XLA reuse the allocation
        # in place of an alloc+free per tick (SURVEY.md §7 "donation to
        # avoid allocs"). Callers must thread the returned state (the
        # donated input buffer is invalidated), which `step`'s API already
        # enforces.
        self._step = jax.jit(self._step_impl, donate_argnums=(1,))

    def init(self, n_scenarios: int) -> MPCState:
        d = self.qp.T * self.qp.m
        U_prev = jnp.zeros((n_scenarios, d), jnp.float32)
        tick = jnp.asarray(0, jnp.int32)
        if self.mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec

            # Place the state with the SAME shardings the jitted step emits
            # (U_prev over the data axis, tick replicated) so the second tick
            # sees identical input shardings and never retraces.
            U_prev = jax.device_put(
                U_prev,
                NamedSharding(self.mesh, PartitionSpec(self.mesh.axis_names[0])),
            )
            tick = jax.device_put(tick, NamedSharding(self.mesh, PartitionSpec()))
        return MPCState(U_prev=U_prev, tick=tick)

    def _step_impl(self, qp: CondensedQP, state: MPCState, x0s: jax.Array):
        from numpower_tpu.models.boxqp import solve_mpc_boxqp

        T, m = qp.T, qp.m
        # warm start: shift previous plan one stage, hold last input
        U_shift = jnp.concatenate(
            [state.U_prev[:, m:], state.U_prev[:, -m:]], axis=1
        )
        if self.mesh is not None:
            if self.solver == "admm":
                from numpower_tpu.parallel.sharding import (
                    solve_mpc_boxqp_admm_dp,
                )

                res = solve_mpc_boxqp_admm_dp(
                    qp, x0s, self.u_lo, self.u_hi, self.mesh,
                    iters=self.iters, coarse_iters=self.coarse_iters,
                    U0=U_shift,
                )
            else:
                from numpower_tpu.parallel.sharding import solve_mpc_boxqp_dp

                res = solve_mpc_boxqp_dp(
                    qp, x0s, self.u_lo, self.u_hi, self.mesh,
                    iters=self.iters, coarse_iters=self.coarse_iters,
                    U0=U_shift,
                )
        elif self.solver == "admm":
            from numpower_tpu.models.admm import solve_mpc_boxqp_admm

            res = solve_mpc_boxqp_admm(
                qp, x0s, self.u_lo, self.u_hi, iters=self.iters,
                U0=U_shift, coarse_iters=self.coarse_iters,
            )
        else:
            res = solve_mpc_boxqp(
                qp, x0s, self.u_lo, self.u_hi, x_ref=self.x_ref,
                iters=self.iters, U0=U_shift, coarse_iters=self.coarse_iters,
            )
        u0 = res.U[:, :m]
        resid = (res.primal_residual if self.solver == "admm"
                 else res.residual)
        return u0, MPCState(U_prev=res.U, tick=state.tick + 1), resid

    def step(self, state: MPCState, x0s: jax.Array):
        """One tick: returns ((N, m) first-stage controls, new state).

        `state` is DONATED to the jitted step — do not reuse the passed-in
        state object after this call; thread the returned one."""
        u0, new_state, _ = self._step(self.qp, state, x0s)
        return u0, new_state

    def compile_cache_size(self) -> int:
        """Number of distinct compiled executables behind the tick step.
        In steady state this must stay 1 (one batch shape): any growth means
        the serving path is RETRACING — shape/dtype churn or accidental
        python-object identity leaks — and blowing the latency budget.
        Asserted by tests/test_controller_utils.py::test_controller_no_retrace."""
        return self._step._cache_size()

    def step_with_residual(self, state: MPCState, x0s: jax.Array):
        return self._step(self.qp, state, x0s)

    def callback_init(self, n_scenarios: int):
        """Initial ctrl_state for models/simulate.simulate_closed_loop: the
        QP rides the scan carry as a jit ARGUMENT (closure-capturing it
        would embed H/Sx/Su as HLO constants fetched D2H at trace time —
        CondensedQP docstring)."""
        return (self.qp, self.init(n_scenarios))

    def callback(self):
        """(ctrl_state, x0s, t) -> (u0, ctrl_state) for simulate_closed_loop;
        pair with ctrl_state0=callback_init(N). t is ignored — the plan is
        re-solved each tick with a warm start."""
        def fn(state, x0s, t):
            qp, mpc_state = state
            u0, new_state, _ = self._step_impl(qp, mpc_state, x0s)
            return u0, (qp, new_state)

        return fn
