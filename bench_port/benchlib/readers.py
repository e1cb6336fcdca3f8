"""What the per-layer readers share: each ``metrics/<metric>.py`` calls one
of these on the run's outcome. A reader that finds nothing to read returns
None, and the metric is left out of the line."""

from __future__ import annotations

from benchlib import peaks, work

GN_KERNELS = ("gn_act_onepass", "gn_stats", "gn_apply", "gn_bwd_onepass", "gn_bwd_stats",
              "gn_bwd_apply")
ADAMW_KERNELS = ("fused_adamw", "grad_norm_kernel")
# The encoder's and decoder's library products: cuDNN's convolution kernels
# (forward, data and weight gradients: ``sm90_xmma_{fprop,dgrad,wgrad}_*``,
# ``cutlass__5x_cudnn``, ``implicit_convolve_sgemm``) with its NCHW <-> NHWC
# layout transposes, and cuBLAS's matrix products (``nvjet_*``, its split-K
# reduction), which carry the kernel-size-1 convolutions and the linear
# layers, the readout's among them (all ``F.linear``). Counting both keeps
# the metric still when a product moves from one library to the other.
CONV_KERNELS = ("fprop", "dgrad", "wgrad", "implicit_gemm", "implicit_convolve", "conv2d",
                "convolve", "nchwtonhwc", "nhwctonchw", "winograd", "nvjet", "gemm",
                "splitkreduce", "cutlass")


def idle_share(run):
    t = run.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def mfu(run):
    w = run.window
    if not w.get("units") or not w.get("flops_per_unit"):
        return None
    return 100.0 * w["flops_per_unit"] * w["units"] / w["seconds"] / peaks.BF16_FLOPS


def launches_per_unit(run):
    if run.trace is None or run.traced_units <= 0 or run.trace.launches <= 0:
        return None
    return run.trace.launches / run.traced_units


def kernel_ms_per_unit(run, patterns):
    if run.trace is None or run.traced_units <= 0:
        return None
    s = run.trace.kernel_seconds(patterns)
    return None if s <= 0 else 1e3 * s / run.traced_units


def roofline(run, least_s_per_unit: float, patterns):
    """Share of the least time in the kernels' own device time."""
    if run.trace is None or run.traced_units <= 0:
        return None
    s = run.trace.kernel_seconds(patterns)
    return None if s <= 0 else 100.0 * least_s_per_unit * run.traced_units / s


def gn_roofline(run, train: bool):
    if run.trace is None:
        return None
    per_unit = work.gn_bytes(run.config, run.facts["batch"], train) / peaks.HBM_BYTES
    if not train:
        per_unit /= run.facts["batch"]  # per field
    return roofline(run, per_unit, GN_KERNELS)


def adamw_roofline(run):
    if run.trace is None:
        return None
    per_step = work.adamw_bytes(run.facts["param_count"], run.facts["moment_bytes"])
    return roofline(run, per_step / peaks.HBM_BYTES, ADAMW_KERNELS)
