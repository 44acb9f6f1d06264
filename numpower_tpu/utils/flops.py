"""FLOP, byte and roofline accounting against the card's published peaks.

Peaks are keyed by JAX's `device_kind`. The only entry is the H100 SXM, from
NVIDIA's data sheet (dense rates, no sparsity, at the 700 W power limit):
989 TFLOP/s bf16, 495 TF32, 67 fp32 outside the tensor cores, 3.35 TB/s of
HBM3. An accelerator that is not in the table is an error (no peak is
assumed); the CPU has no peak and gets None.

Two cost shapes:
  - KernelCost for the fused box-QP kernels (kernels/boxqp.py): products on
    the tensor cores, bf16 in the coarse phase and 3xTF32 (three TF32
    passes) in the tail, the g/c formation and the residual. Speed of light
    = bf16 FLOPs / bf16 peak + 3 x fp32-class FLOPs / TF32 peak.
  - RooflineCost for the elementwise and small-matrix paths: SoL =
    max(bytes / HBM peak, FLOPs / fp32 peak), with bytes a LOWER BOUND
    (algorithmically required reads + writes).
Reworking this per layer belongs to the benchmark.
"""

from __future__ import annotations

from typing import NamedTuple, Optional


class DevicePeaks(NamedTuple):
    bf16_tflops: float
    tf32_tflops: float
    fp32_tflops: float
    hbm_gbps: float


# device_kind -> published peaks (NVIDIA H100 SXM data sheet)
PEAKS = {
    "NVIDIA H100 80GB HBM3": DevicePeaks(989.0, 495.0, 67.0, 3350.0),
}


def device_peaks(device=None) -> Optional[DevicePeaks]:
    """Published peaks of `device` (default: the first JAX device); None on
    the CPU. Raises ValueError for an accelerator with no entry in PEAKS."""
    import jax

    if device is None:
        device = jax.devices()[0]
    if device.platform == "cpu":
        return None
    peaks = PEAKS.get(device.device_kind)
    if peaks is None:
        raise ValueError(
            f"no published peaks for device kind {device.device_kind!r}; "
            "add them to numpower_tpu.utils.flops.PEAKS")
    return peaks


def _pow2(x: int) -> int:
    p = 16
    while p < x:
        p *= 2
    return p


class KernelCost(NamedTuple):
    flops_logical: float   # useful FLOPs at the real problem dims
    flops_padded: float    # FLOPs on the power-of-two kernel tiles
    flops_bf16: float      # padded FLOPs of the bf16 (coarse) products
    flops_fp32: float      # padded FLOPs of the 3xTF32 products

    def sol_seconds(self, peaks: DevicePeaks) -> float:
        """Speed-of-light time on the tensor cores."""
        return (self.flops_bf16 / (peaks.bf16_tflops * 1e12)
                + 3.0 * self.flops_fp32 / (peaks.tf32_tflops * 1e12))

    def mfu(self, measured_seconds: float, peaks: DevicePeaks) -> float:
        return self.sol_seconds(peaks) / measured_seconds

    @property
    def padding_waste(self) -> float:
        return 1.0 - self.flops_logical / self.flops_padded


def qp_kernel_cost(N: int, n: int, d: int, iters: int,
                   coarse_iters: int) -> KernelCost:
    """kernels/boxqp.fista_mpc and admm_mpc: one (N, n+1) @ (n+1, d) g/c
    formation, `iters` (N, d) @ (d, d) iteration products (the first
    coarse_iters in bf16) and one residual product (ADMM's residual
    x-update)."""
    d_pad, n_pad = _pow2(d), _pow2(n + 1)
    it_l, it_p = 2.0 * N * d * d, 2.0 * N * d_pad * d_pad
    form_l, form_p = 2.0 * N * n * d, 2.0 * N * n_pad * d_pad
    tail = iters - coarse_iters + 1  # + the residual product
    return KernelCost(
        flops_logical=form_l + (iters + 1) * it_l,
        flops_padded=form_p + (iters + 1) * it_p,
        flops_bf16=coarse_iters * it_p,
        flops_fp32=form_p + tail * it_p,
    )


class RooflineCost(NamedTuple):
    """Lower-bound work inventory for a bandwidth- or fp32-bound program."""
    flops: float        # fp32 FLOPs
    bytes_moved: float  # algorithmic minimum HBM reads + writes

    def sol_seconds(self, peaks: DevicePeaks) -> float:
        return max(self.bytes_moved / (peaks.hbm_gbps * 1e9),
                   self.flops / (peaks.fp32_tflops * 1e12))

    def bound(self, peaks: DevicePeaks) -> str:
        mem = self.bytes_moved / (peaks.hbm_gbps * 1e9)
        return "HBM" if mem >= self.flops / (peaks.fp32_tflops * 1e12) \
            else "fp32"


def kalman_batched_cost(N: int, T: int, n: int, p: int) -> RooflineCost:
    """models/estimation.kalman_filter_batched (shared-covariance fast
    path): one tiny cov/gain scan (batch-independent) + the batched mean
    recurrence. Bytes: read yss once, write filtered+predicted means."""
    mean_flops = N * T * (2 * n * n + 4 * n * p + 2 * p * p + n + 4 * p)
    cov_flops = T * (8 * n ** 3 + 6 * n * n * p + 4 * n * p * p + p ** 3)
    bytes_moved = 4.0 * (N * T * p + 2 * N * T * n + N * n)
    return RooflineCost(float(mean_flops + cov_flops), float(bytes_moved))


def mppi_batched_cost(N: int, K: int, iters: int, T: int, m: int,
                      plant_flops: int = 12,
                      cost_flops: int = 14) -> RooflineCost:
    """models/mppi.mppi_solve_batched: iters full K-sample rollouts per
    scenario — per step one plant eval, one stage cost, candidate formation
    (~4 ops/input), plus the per-round coupling/softmax/update (~8 ops per
    (t, m) element). Bytes: the eps tensor read once plus x0/us I/O."""
    per_step = plant_flops + cost_flops + 4 * m
    flops = (N * K * iters * (T * per_step + 8 * T * m + 6)
             + N * T * m * iters * 4)
    bytes_moved = 4.0 * (iters * T * m * N * K + N * T * m + N * 2)
    return RooflineCost(float(flops), float(bytes_moved))


def rts_batched_cost(N: int, T: int, n: int) -> RooflineCost:
    """models/estimation.kalman_smoother_batched (shared-gain fast path):
    the e_t einsum (2n^2 per element) + the backward affine recurrence
    (2n^2). Bytes: read filtered+predicted means, write smoothed means."""
    mean_flops = N * T * 4 * n * n
    cov_flops = T * (10 * n ** 3)
    bytes_moved = 4.0 * (3 * N * T * n)
    return RooflineCost(float(mean_flops + cov_flops), float(bytes_moved))


def _associative_cost(T: int, elem_floats: int,
                      combine_flops: float) -> RooflineCost:
    """lax.associative_scan work model: ~2T combines total; each combine
    reads 2 elements and writes 1."""
    combines = 2.0 * T
    return RooflineCost(combines * combine_flops,
                        combines * 3.0 * elem_floats * 4.0)


def riccati_associative_cost(T: int, n: int) -> RooflineCost:
    """models/lqr.riccati_associative: element (F, C, J) = 3n^2 floats;
    combine ~= 18 n^3 FLOPs."""
    return _associative_cost(T, 3 * n * n, 18.0 * n ** 3)


def kalman_associative_cost(T: int, n: int) -> RooflineCost:
    """models/estimation.kalman_filter_associative: element (A, b, C,
    eta, J) = 3n^2 + 2n floats; combine ~= 22 n^3 FLOPs."""
    return _associative_cost(T, 3 * n * n + 2 * n, 22.0 * n ** 3)


def riccati_per_scenario_cost(N: int, T: int, n: int, m: int) -> RooflineCost:
    """models/lqr.riccati_scan_per_scenario: per scenario-step one Riccati
    update (~4n^3 + 4mn^2 + 4m^2n + m^3); reads As/Bs once, writes the
    (N, T, m, n) gain stack."""
    step = 4 * n ** 3 + 4 * m * n * n + 4 * m * m * n + m ** 3
    bytes_moved = 4.0 * (N * (n * n + n * m) + N * T * m * n + N * n * n)
    return RooflineCost(float(N * T * step), float(bytes_moved))


def particle_filter_cost(B: int, Np: int, T: int, n: int, p: int,
                         plant_flops: int = 40) -> RooflineCost:
    """models/particle.particle_filter_batched — propagate and weight:
    per particle-step one plant eval, a noise matmul (2n^2), weighting
    (2np + p^2); bytes: cloud read+write per step plus one more read+write
    feeding the resampler. Resampling is pf_resample_cost."""
    step = plant_flops + 2 * n * n + 2 * n * p + p * p
    bytes_moved = 4.0 * B * Np * T * n * 4.0
    return RooflineCost(float(B * Np * T * step), float(bytes_moved))


def pf_resample_cost(B: int, Np: int, T: int, n: int) -> RooflineCost:
    """models/particle._systematic_resample (one-hot contraction): per step
    one (Np, Np) @ (Np, n) product per trajectory. Under vmap the ESS
    lax.cond lowers to a select, so it runs every step."""
    return RooflineCost(2.0 * B * Np * Np * n * T, 4.0 * B * Np * n * T * 2)


def ekf_batched_cost(B: int, T: int, n: int, p: int,
                     plant_flops: int = 40) -> RooflineCost:
    """models/estimation.ekf_filter_batched: per step n f-jvps (~2x plant
    each), n h-jvps, A P A' (2n^3), C-side terms (~3pn^2 + p^2 n), the
    p-solve and the mean/ll updates. Bytes: ys/us reads + filtered and
    predicted means and covariances writes."""
    step = (2 * n * plant_flops + 2 * n * 2 * n * p + 2 * n ** 3
            + 3 * p * n * n + 2 * p * p * n + 4 * n * p + 6 * p)
    bytes_moved = 4.0 * B * T * (p + 1 + 2 * n + 2 * n * n)
    return RooflineCost(float(B * T * step), float(bytes_moved))


def ukf_batched_cost(B: int, T: int, n: int, p: int,
                     plant_flops: int = 40) -> RooflineCost:
    """models/estimation.ukf_filter_batched: per step two Cholesky
    factorizations (~n^3/3 each), 2n+1 plant + obs evals, the weighted
    moment sums and the p-solve/update."""
    K = 2 * n + 1
    step = (2 * (n ** 3) // 3 + K * (plant_flops + n * p)
            + 3 * K * n * n + 2 * K * n + 2 * K * p * p
            + 2 * p * p * n + 4 * n * p + 6 * p)
    bytes_moved = 4.0 * B * T * (p + 1 + 2 * n + 2 * n * n)
    return RooflineCost(float(B * T * step), float(bytes_moved))


def roofline_report(label: str, cost: RooflineCost, measured_seconds: float,
                    device=None) -> str:
    """One-line HBM/fp32 roofline report for the bench harness."""
    peaks = device_peaks(device)
    gbs = cost.bytes_moved / measured_seconds / 1e9
    tf = cost.flops / measured_seconds / 1e12
    if peaks is None:
        return (f"[roofline] {label}: {gbs:.1f} GB/s, {tf:.2f} TFLOP/s "
                f"achieved — no device peak (CPU), utilization n/a")
    sol = cost.sol_seconds(peaks)
    return (
        f"[roofline] {label}: {gbs:.1f} GB/s + {tf:.2f} TFLOP/s achieved; "
        f"{cost.bound(peaks)}-bound SoL {sol*1e6:.1f} us vs measured "
        f"{measured_seconds*1e6:.1f} us -> {100*sol/measured_seconds:.0f}% "
        f"of roofline (peaks {peaks.hbm_gbps:.0f} GB/s, "
        f"{peaks.fp32_tflops:.0f} fp32 TFLOP/s)"
    )


def mfu_report(label: str, cost: KernelCost, measured_seconds: float,
               peaks: Optional[DevicePeaks]) -> str:
    """One-line tensor-core utilization report for the bench harness."""
    ach = cost.flops_logical / measured_seconds / 1e12
    if peaks is None:
        return (f"[mfu] {label}: {ach:.1f} TFLOP/s logical — no device "
                f"peak (CPU), MFU n/a")
    sol = cost.sol_seconds(peaks)
    return (
        f"[mfu] {label}: {ach:.1f} TFLOP/s logical; tensor-core SoL "
        f"{sol*1e6:.1f} us vs measured {measured_seconds*1e6:.1f} us -> "
        f"MFU {100*sol/measured_seconds:.0f}% (bf16 {peaks.bf16_tflops:.0f} "
        f"/ TF32 {peaks.tf32_tflops:.0f} TFLOP/s; tile padding waste "
        f"{100*cost.padding_waste:.1f}%)"
    )
