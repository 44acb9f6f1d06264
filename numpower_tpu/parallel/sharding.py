"""Sharded MPC solvers (shard_map + XLA collectives).

SURVEY.md §2.5: the reference has NO distributed execution; this module is
the from-scratch equivalent:

 - DP  (data axis)   : scenarios sharded; each device solves its shard of the
                       batch with the replicated condensed H. Embarrassingly
                       parallel; collectives only for sweep statistics
                       (psum / pmax over the data axis).
 - TP  (model axis)  : the condensed Hessian's columns sharded; each PG/FISTA
                       iteration computes a partial product U_shard @ H_cols
                       and `psum`s over the model axis — the QP block
                       reduction of BASELINE config #5.
 - SP  (horizon axis): riccati_associative in models/lqr.py parallelizes time
                       within a device; horizon sharding across devices would
                       use ppermute pipelining (documented, not yet needed at
                       T=30).

All solvers are shard_map'ped jitted programs: XLA sees the per-device
program + explicit collectives and overlaps them with compute.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from numpower_tpu.models.boxqp import BoxQPResult
from numpower_tpu.models.condensed import CondensedQP, default_coarse_iters


def _route(qp: CondensedQP, x0s, mesh: Mesh, method: str,
           interpret: bool) -> str:
    """utils/platform.route for the mesh's platform: "auto" runs the fused
    kernel per device on GPU meshes within its envelope, the XLA scan
    elsewhere (the virtual CPU test mesh included)."""
    from numpower_tpu.kernels.boxqp import fits
    from numpower_tpu.utils.platform import platform, route

    return route(method, fits=fits(qp.H.shape[0], qp.n) and x0s.ndim == 2,
                 interpret=interpret, on=platform(mesh.devices))


def solve_mpc_boxqp_dp(
    qp: CondensedQP,
    x0s: jax.Array,
    u_lo: float,
    u_hi: float,
    mesh: Mesh,
    iters: int = 40,
    method: str = "auto",
    coarse_iters=None,
    U0=None,
    interpret: bool = False,
) -> BoxQPResult:
    """Data-parallel batched box-QP: scenarios over the `data` axis.

    H/Sx/SuTQ replicated; x0s (and the optional U0 warm start) sharded on
    axis 0. Residual is a pmax over the data axis so every device returns
    the global sweep residual.

    method="pallas" runs the fused FISTA kernel (kernels/boxqp.py, g formed
    in the kernel) inside the shard_map body, so every device runs the
    single-device kernel; "auto" picks it on GPU meshes within the kernel's
    envelope (_route), "xla" forces the scan. An explicit interpret flag
    runs the kernel in the Pallas interpreter (the CPU tests).
    """
    path = _route(qp, x0s, mesh, method, interpret)
    if path != "xla":
        return _solve_mpc_boxqp_dp_kernel(
            qp, x0s, u_lo, u_hi, mesh, iters,
            default_coarse_iters(qp, iters) if coarse_iters is None
            else coarse_iters,
            (mesh.axis_names[0],),
            U0=U0, interpret=path == "interpret",
        )
    data_ax = mesh.axis_names[0]
    step = 1.0 / qp.lipschitz

    def per_device(H, SuTQ, Sx, x0s_shard, u0_shard):
        g = (SuTQ @ (Sx @ x0s_shard.T)).T  # (n_local, Tm)
        U = u0_shard  # zeros when cold (matches solve_boxqp_fista's U0)
        Y = U
        t = jnp.asarray(1.0, g.dtype)

        def body(carry, _):
            U, Y, t = carry
            grad = Y @ H.T + g
            U_new = jnp.clip(Y - step * grad, u_lo, u_hi)
            t_new = 0.5 * (1.0 + jnp.sqrt(1.0 + 4.0 * t * t))
            beta = (t - 1.0) / t_new
            dU = U_new - U
            uphill = jnp.sum(grad * dU, axis=-1, keepdims=True) > 0
            Y_new = U_new + jnp.where(uphill, 0.0, beta) * dU
            return (U_new, Y_new, t_new), None

        (U, _, _), _ = jax.lax.scan(body, (U, Y, t), None, length=iters)
        grad = U @ H.T + g
        resid_local = jnp.max(jnp.abs(U - jnp.clip(U - step * grad, u_lo, u_hi)))
        resid = jax.lax.pmax(resid_local, axis_name=data_ax)
        return U, resid

    if U0 is None:
        U0 = jnp.zeros((x0s.shape[0], qp.H.shape[0]), x0s.dtype)
    mapped = shard_map(
        per_device,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(data_ax), P(data_ax)),
        out_specs=(P(data_ax), P()),
    )
    U, resid = jax.jit(mapped)(qp.H, qp.SuTQ, qp.Sx, x0s, U0)
    return BoxQPResult(U=U, iterations=jnp.asarray(iters), residual=resid)


def _solve_mpc_boxqp_dp_kernel(
    qp: CondensedQP,
    x0s: jax.Array,
    u_lo: float,
    u_hi: float,
    mesh: Mesh,
    iters: int,
    coarse_iters: int,
    shard_axes,
    U0=None,
    interpret: bool = False,
) -> BoxQPResult:
    """Fused-kernel DP body: each device runs the single-device FISTA kernel
    on its x0 shard (g formed in the kernel, H and the folded prediction
    chain replicated). shard_axes may name one mesh axis (pure DP) or all of
    them (dp x tp meshes where H fits per device, so every device does
    scenario work)."""
    from numpower_tpu.kernels.boxqp import fista_mpc
    from numpower_tpu.models.boxqp import prediction_chain

    def per_device(H, W, bias, lip, x0s_shard, u0_shard):
        U, resid_local = fista_mpc(
            H, W, bias, x0s_shard, u_lo, u_hi, lip, iters=iters,
            coarse_iters=coarse_iters, U0=u0_shard, interpret=interpret,
        )
        resid = jax.lax.pmax(resid_local, axis_name=shard_axes)
        return U, resid

    if U0 is None:
        U0 = jnp.zeros((x0s.shape[0], qp.H.shape[0]), x0s.dtype)
    spec = P(shard_axes)
    # check_vma=False: pallas_call's out_shape carries no varying-mesh-axes
    # annotation, so jax's per-output vma inference cannot see through it.
    mapped = shard_map(
        per_device,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(), spec, spec),
        out_specs=(spec, P()),
        check_vma=False,
    )
    W, bias = prediction_chain(qp)
    U, resid = jax.jit(mapped)(qp.H, W, bias, qp.lipschitz, x0s, U0)
    return BoxQPResult(U=U, iterations=jnp.asarray(iters), residual=resid)


def solve_mpc_boxqp_dp_tp(
    qp: CondensedQP,
    x0s: jax.Array,
    u_lo: float,
    u_hi: float,
    mesh: Mesh,
    iters: int = 40,
    method: str = "auto",
    coarse_iters=None,
    interpret: bool = False,
) -> BoxQPResult:
    """2-D sharded box-QP: scenarios over `data`, H column-blocks over
    `model`. Each iteration:  partial = U_shard @ H_block' (local GEMM)
    then grad = psum(partial, model) — the QP block reduction of BASELINE
    config #5 expressed as an XLA collective.

    When the fused kernel takes the QP (kernels/boxqp.fits) the TP psum
    costs more than it saves, so the kernel path replicates H and shards
    SCENARIOS over BOTH mesh axes, running the kernel per device.
    method="xla" forces the column-sharded psum program (the right shape
    once d outgrows the kernel's tiles).
    """
    path = _route(qp, x0s, mesh, method, interpret)
    if path != "xla":
        return _solve_mpc_boxqp_dp_kernel(
            qp, x0s, u_lo, u_hi, mesh, iters,
            default_coarse_iters(qp, iters) if coarse_iters is None
            else coarse_iters,
            tuple(mesh.axis_names), interpret=path == "interpret",
        )
    data_ax, model_ax = mesh.axis_names
    step = 1.0 / qp.lipschitz
    d = qp.H.shape[0]

    def per_device(H_cols, SuTQ, Sx, x0s_shard):
        # H_cols: (d, d/model) column block; g computed fully then used
        g = (SuTQ @ (Sx @ x0s_shard.T)).T          # (n_local, d) replicated over model
        n_model = jax.lax.psum(1, axis_name=model_ax)
        my_col = jax.lax.axis_index(model_ax)
        cols = d // n_model

        def grad_of(Y):
            # local partial: Y's column slice times H column-block transposed
            Y_cols = jax.lax.dynamic_slice_in_dim(Y, my_col * cols, cols, axis=1)
            partial = Y_cols @ H_cols.T             # (n_local, d)
            return jax.lax.psum(partial, axis_name=model_ax) + g

        U = jnp.zeros_like(g)
        Y = U
        t = jnp.asarray(1.0, g.dtype)

        def body(carry, _):
            U, Y, t = carry
            grad = grad_of(Y)
            U_new = jnp.clip(Y - step * grad, u_lo, u_hi)
            t_new = 0.5 * (1.0 + jnp.sqrt(1.0 + 4.0 * t * t))
            beta = (t - 1.0) / t_new
            dU = U_new - U
            uphill = jnp.sum(grad * dU, axis=-1, keepdims=True) > 0
            Y_new = U_new + jnp.where(uphill, 0.0, beta) * dU
            return (U_new, Y_new, t_new), None

        (U, _, _), _ = jax.lax.scan(body, (U, Y, t), None, length=iters)
        grad = grad_of(U)
        resid_local = jnp.max(jnp.abs(U - jnp.clip(U - step * grad, u_lo, u_hi)))
        resid = jax.lax.pmax(resid_local, axis_name=data_ax)
        return U, resid

    # H sharded by columns over model axis: spec (None, model)
    mapped = shard_map(
        per_device,
        mesh=mesh,
        in_specs=(P(None, model_ax), P(), P(), P(data_ax)),
        out_specs=(P(data_ax), P()),
    )
    U, resid = jax.jit(mapped)(qp.H, qp.SuTQ, qp.Sx, x0s)
    return BoxQPResult(U=U, iterations=jnp.asarray(iters), residual=resid)


def sweep_statistics_dp(xs_scenarios: jax.Array, mesh: Mesh):
    """Cross-scenario tube statistics with data-axis collectives:
    returns (mean_traj, max_deviation) computed globally."""
    data_ax = mesh.axis_names[0]

    def per_device(xs_shard):
        n_total = jax.lax.psum(xs_shard.shape[0], axis_name=data_ax)
        mean = jax.lax.psum(jnp.sum(xs_shard, axis=0), axis_name=data_ax) / n_total
        dev = jnp.max(jnp.linalg.norm(xs_shard - mean[None], axis=-1), axis=0)
        max_dev = jax.lax.pmax(dev, axis_name=data_ax)
        return mean, max_dev

    mapped = shard_map(
        per_device, mesh=mesh, in_specs=(P(data_ax),), out_specs=(P(), P())
    )
    return jax.jit(mapped)(xs_scenarios)


def solve_mpc_boxqp_admm_dp(
    qp: CondensedQP,
    x0s: jax.Array,
    u_lo: float,
    u_hi: float,
    mesh: Mesh,
    rho=None,
    iters: int = 40,
    method: str = "auto",
    coarse_iters=None,
    U0=None,
    interpret: bool = False,
):
    """Data-parallel ADMM box-QP: scenarios over the `data` axis.

    The exact-solve splitting's factorization (Minv = (H + rho I)^{-1}) is
    computed ONCE and replicated; each device runs the iteration scan on its
    scenario shard (one local GEMM per iteration). Residuals are pmax'd over
    the data axis so every device reports the global sweep residual.
    Mirrors solve_mpc_boxqp_dp for the ADMM family (models/admm.py).

    method="pallas" ("auto" on GPU meshes, _route) runs the fused ADMM
    kernel (kernels/boxqp.py, c = Minv g formed in the kernel) per device.
    An explicit interpret flag runs it in the Pallas interpreter. U0 (N, d)
    warm-starts z (clipped), sharded with the scenarios — the mesh-serving
    tick path (models/mpc.MPCController(solver="admm", mesh=...)).
    """
    from numpower_tpu.models.admm import ADMMResult, minv_factor

    data_ax = mesh.axis_names[0]
    if rho is None:
        rho = jnp.sqrt(qp.lipschitz * jnp.maximum(qp.mu, 1e-12))
    Minv = minv_factor(qp.H, rho)
    over_relax = 1.6

    path = _route(qp, x0s, mesh, method, interpret)
    if path != "xla":
        from numpower_tpu.kernels.boxqp import admm_mpc
        from numpower_tpu.models.boxqp import prediction_chain

        if coarse_iters is None:
            from numpower_tpu.models.condensed import admm_coarse_iters

            coarse_iters = admm_coarse_iters(qp, iters)  # models/admm.py policy

        def per_device_pl(Minv, W, bias, rho_s, x0s_shard, u0_shard):
            z, rp_local, rd_local = admm_mpc(
                Minv, W, bias, x0s_shard, u_lo, u_hi, rho_s, over_relax,
                iters=iters, coarse_iters=coarse_iters, U0=u0_shard,
                interpret=path == "interpret",
            )
            rp = jax.lax.pmax(rp_local, axis_name=data_ax)
            rd = jax.lax.pmax(rd_local, axis_name=data_ax)
            return z, rp, rd

        if U0 is None:
            U0 = jnp.zeros((x0s.shape[0], qp.H.shape[0]), x0s.dtype)
        mapped = shard_map(
            per_device_pl,
            mesh=mesh,
            in_specs=(P(), P(), P(), P(), P(data_ax), P(data_ax)),
            out_specs=(P(data_ax), P(), P()),
            check_vma=False,  # pallas out_shape carries no vma annotation
        )
        W, bias = prediction_chain(qp)
        z, rp, rd = jax.jit(mapped)(Minv, W, bias,
                                    jnp.asarray(rho, jnp.float32), x0s, U0)
        return ADMMResult(U=z, iterations=jnp.asarray(iters),
                          primal_residual=rp, dual_residual=rd)

    def per_device(Minv, SuTQ, Sx, rho_s, x0s_shard, u0_shard):
        g = (SuTQ @ (Sx @ x0s_shard.T)).T          # (n_local, d)
        z = jnp.clip(u0_shard, u_lo, u_hi)
        y = jnp.zeros_like(g)

        def body(carry, _):
            z, y = carry
            rhs = rho_s * (z - y) - g
            x = rhs @ Minv.T
            x_r = over_relax * x + (1.0 - over_relax) * z
            z_new = jnp.clip(x_r + y, u_lo, u_hi)
            y_new = y + x_r - z_new
            return (z_new, y_new), None

        (z, y), _ = jax.lax.scan(body, (z, y), None, length=iters)
        x = (rho_s * (z - y) - g) @ Minv.T
        rp = jax.lax.pmax(jnp.max(jnp.abs(x - z)), axis_name=data_ax)
        z_next = jnp.clip(over_relax * x + (1.0 - over_relax) * z + y,
                          u_lo, u_hi)
        rd = jax.lax.pmax(rho_s * jnp.max(jnp.abs(z_next - z)),
                          axis_name=data_ax)
        return z, rp, rd

    if U0 is None:
        U0 = jnp.zeros((x0s.shape[0], qp.H.shape[0]), x0s.dtype)
    mapped = shard_map(
        per_device,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(data_ax), P(data_ax)),
        out_specs=(P(data_ax), P(), P()),
    )
    z, rp, rd = jax.jit(mapped)(Minv, qp.SuTQ, qp.Sx,
                                jnp.asarray(rho, jnp.float32), x0s, U0)
    return ADMMResult(U=z, iterations=jnp.asarray(iters),
                      primal_residual=rp, dual_residual=rd)


def kalman_filter_batched_dp(A, C, Q, R, x0s, P0, yss, mesh: Mesh):
    """Data-parallel batched Kalman filtering: trajectories over the `data`
    axis (the estimation-side analogue of solve_mpc_boxqp_dp — 65k-trajectory
    smoothing/likelihood sweeps shard embarrassingly; the per-device body is
    the same vmapped scan as models/estimation.kalman_filter_batched).

    Returns the KalmanResult with every leaf sharded on axis 0, plus the
    GLOBAL summed log-likelihood replicated on every device (psum over the
    data axis) — the quantity a sweep maximizes.
    """
    from numpower_tpu.models.estimation import kalman_filter_batched

    data_ax = mesh.axis_names[0]

    def per_device(A, C, Q, R, P0, x0_shard, ys_shard):
        res = kalman_filter_batched(A, C, Q, R, x0_shard, P0, ys_shard)
        total_ll = jax.lax.psum(jnp.sum(res.log_likelihood), axis_name=data_ax)
        return res, total_ll

    # check_vma=False: the filter scan's log-likelihood carry is initialized
    # from a replicated zero, which jax's varying-axes inference rejects
    # against the per-shard output; semantics are unaffected.
    mapped = shard_map(
        per_device,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(), P(data_ax), P(data_ax)),
        out_specs=(P(data_ax), P()),
        check_vma=False,
    )
    return jax.jit(mapped)(A, C, Q, R, P0, x0s, yss)


def kalman_smoother_batched_dp(A, filt, mesh: Mesh):
    """Data-parallel batched RTS smoother over kalman_filter_batched_dp
    output (every filt leaf sharded on axis 0): the backward mean pass is
    batch-local, so each device smooths its trajectory shard with the
    shared-gain fast path (models/estimation.kalman_smoother_batched) and
    no collectives are needed."""
    from numpower_tpu.models.estimation import (
        KalmanResult, kalman_smoother_batched,
    )

    data_ax = mesh.axis_names[0]

    def per_device(A, means, covs, pred_means, pred_covs, ll):
        return kalman_smoother_batched(
            A, KalmanResult(means, covs, pred_means, pred_covs, ll))

    mapped = shard_map(
        per_device,
        mesh=mesh,
        in_specs=(P(),) + (P(data_ax),) * 5,
        out_specs=P(data_ax),
    )
    return jax.jit(mapped)(A, *filt)
