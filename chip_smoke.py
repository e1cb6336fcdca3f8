#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (simulgen_vae_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--seed 0] [--reps 20] [--profile]
    python3 chip_smoke.py --ab {onepass,gn-bwd,gn-stats,gn-stats-clusters,readout-bwd} TREE ...

Phases, each printing its own lines; any failure exits non-zero:

1. build   : compile ops/csrc/*.cu with nvcc (one process per source, all at
             once) and print the card's name and power limit; the built
             readout_matmul_stats and readout_bwd_fused libraries' SASS must
             hold HGMMA (wgmma) and UTMALDG (TMA loads);
2. kernels : each GroupNorm forward kernel against its plain PyTorch version
             on the card, at the serving decode's shapes (B=16, T=200), f32
             within atol 2e-5 and bf16 within atol 1e-2, rtol 1e-2;
             gn_act_onepass gives the same bits on two calls and agrees at
             the engage rule's edge (f32, T = 1, C = 19360, G = 16), and a
             profiler trace of its launch shows >= 64 blocks, >= 2 a
             sample, launched by cudaLaunchKernelEx;
3. serve   : the flagship serving decode (200 x 95008 field, decoder filters
             128 256 512 1024, MLP conditioner on 484 inputs) with random
             weights from --seed in the JAX trees' layout, carried over by
             convert.py; 40 requests through generate(max_batch=16), every
             kernel's launch count must rise; the same batch through the
             plain GroupNorm on the card agrees within rel-L2 1e-2 (bf16) and
             max-abs 1e-4 (f32, TF32 off);
4. timing  : p50 of a batch-16 decode; bf16 torch.erfc, gelu and its
             gradient on the card against the CPU on 4096 values (at most 1%
             differing); the
             decode's p50, device time and kernel launches with the bf16
             layers before and after the two rounding repairs (the bias added
             after the product, gelu rounded per operation), in turns; per
             kernel at each main-path shape, its time beside its plain
             version, one PyTorch library call and the card's bound (HBM
             bytes at 3.35 TB/s, or operations at 67 TFLOP/s f32, whichever
             is larger); for gn_act_onepass and its library call also the
             device time alone (calls replayed from a CUDA graph), beside the
             time of its earlier design (a constant);
5. train   : the flagship VAE train step (bench.py's configuration: 64
             resident samples of 200 x 95008 made on the card from --seed,
             encoder filters 1024 512 256 128, batch 16, bf16 compute, f32
             master weights and AdamW moments, spectral norm every step,
             default augmentation) through VAETrainer.train_epoch: two
             warm-up steps, then each train kernel (gather_augment,
             gn_bwd_onepass, gn_bwd_stats, gn_bwd_apply) against its plain
             version at every shape the step gives it, in f32 and bf16
             (gn_bwd_onepass and gn_bwd_stats: two calls the same bits;
             gn_bwd_onepass also at its engage rule's edge, f32, T = 1, G =
             16), and profiler traces of both: B x 8 blocks launched by
             cudaLaunchKernelEx, gn_bwd_stats one kernel a call; two
             epochs (8 steps) whose loss and gradient norm must be finite and
             in which every train kernel must launch (gather_augment once per
             step); one step's loss and gradients through the kernels against
             the plain versions from the same state, batch and noise (bf16:
             loss within 1e-2 relative; f32 with TF32 off: loss within 1e-4,
             every gradient within rel-L2 1e-3); then the step's p50 and each
             train kernel's time per step beside its bound, plain and library
             times (gn_bwd_onepass and gn_bwd_stats also device only from a
             replayed CUDA graph, their kernels' own time in a profiler trace
             beside the library backward's measured the same way, and the
             times of their earlier designs, constants);
6. fused   : the fused-readout train path (VAETrainer(fused_readout=True)):
             each of its four kernels (readout_matmul_stats, readout_loss,
             readout_bwd_stats, readout_bwd_dy) against its plain version in
             f32 and bf16 at the flagship readout shape (B=16, T=200, F=1024,
             C=95008, G=8) and two small ragged ones (readout_matmul_stats:
             two calls the same bits); the same configuration,
             data and seed as phase 5 trained for one epoch (4 steps) with
             finite losses, each new kernel launched once per step and no
             GroupNorm kernel launched at C = 95008; one step from one state,
             batch and noise three ways (fused kernels, fused plain versions,
             unfused route; f32 with TF32 off: loss within 1e-4, every
             gradient and the readout's inv_sigma gradient within rel-L2 1e-3;
             bf16: loss within 1e-2); then per-kernel times beside their
             bounds (readout_matmul_stats also with its product alone, from a
             build without the epilogue, its epilogue's share, TFLOP/s and
             the time of its earlier design, a constant), the
             readout segment
             fused against unfused, and the fused against the unfused step
             p50, timed in turns; bwd="auto" must run the backward flavor
             ops.readout_chain.bwd_flavor answers at the flagship shape (its
             kernel once a step, the other flavor's never);
7. stack   : the benched train stack. readout_bwd_fused (the backward that
             never writes dy) against its plain version in bf16 and f32 at the
             flagship readout shape, three shapes with F = 128 and two ragged
             ones (dW, dh rel-L2 1e-5 f32 / 1e-2 bf16; d bias 1e-4 / 1e-3;
             d inv_sigma 2e-3; two runs the same bits; in bf16 also at six
             shapes of other cluster sizes and of ragged rows at F > 128;
             readout_matmul_stats,
             which makes its inputs, held against its plain version at each
             of these shapes on the way; its bf16 plan, as its library reports
             it, must match the wrapper's bwd_fused_cluster, and a profiler
             trace of one flagship call must show its two passes as cluster
             launches through cudaLaunchKernelExC with the plan's grid), and
             fused_adamw against
             the plain AdamW on leaves that include [95008, 1024], a conv
             weight, an odd vector and a scalar, for f32, round-to-nearest
             bf16 and stochastically rounded bf16 moments (parameters rel-L2
             1e-6, moments the same bits, gradient norm rtol 1e-6); phase 5's
             configuration, data and seed with opt_state_dtype="bfloat16",
             sn_cadence="epoch", VAETrainer(fused_readout=True,
             readout_bwd="fused") trained for one epoch (4 steps): finite
             metrics, one launch per step of each readout kernel on that route
             and of gather_augment, none of readout_bwd_dy, the counted
             fused_adamw sweeps, one power iteration in the epoch; fit for 3
             epochs of 2 steps with a CheckpointManager, a restore into a new
             trainer and one more epoch, bit-equal to an uninterrupted run; one
             streamed epoch of 4 steps from pinned host memory; one step from
             one state, batch and noise with the dy-free backward through its
             kernel, through its plain version and with the materializing
             backward (tolerances of phase 6), and the kernel AdamW against the
             plain one (parameters rel-L2 1e-6); then times in turns: the
             backward segment dy-free against materializing at every shape,
             device only from replayed CUDA graphs (the table behind
             ops.readout_chain.bwd_flavor), fused_adamw over
             the model's 403.5M parameters in its three modes beside the plain
             sweeps, torch's fused AdamW and the byte bounds, and the step p50
             of four stacks.

The line before the last is the kernels' JSON; the last line is
``{"ok": true, "device": {...}}``. --profile adds torch.profiler tables of
device time by kernel for three decodes, one train step, one fused train step
and two steps of the benched stack with either backward (written under
chiprun_out/). Without a CUDA device, or without the package beside it, the
script fails.

--ab MODE runs none of this: for each TREE (a directory holding a
simulgen_vae_tpu_torch package, e.g. an unpacked git archive of another
commit), in its own process and in the order given, it checks one family of
kernels against its plain version and times it from a replayed CUDA graph:
one JSON line per tree, then the card's name and power limit. MODE onepass:
one decode's gn_act_onepass launches (C = 128 x1, 256 x3, 512 x4; bf16, B =
16, T = 200) beside F.group_norm + gelu timed the same way. MODE gn-bwd: one
train step's GroupNorm backwards (bf16, B = 16, T = 200, G = 8: C = 128 x3,
256 x5, 512 x6, 1024 x4, 1280 x2, 2560 x2, 5120 x2, 95008 x1 with tanh),
each on that tree's own route, whole and kernel by kernel. MODE gn-stats:
gn_stats on each map of a decode and a step, with hashes of gn_bwd_stats'
outputs; gn-stats-clusters: gn_stats' measurement builds with clusters of 5
to 8. MODE readout-bwd: readout_bwd_fused and both backward segments
(dy-free, materializing) at every phase 7 shape, in bf16, device only, with
a hash of readout_matmul_stats' outputs at two shapes.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import re
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
F32_OPS_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
BF16_OPS_PER_S = 989e12       # H100 SXM dense bf16 on the tensor cores
B, T = 16, 200
DECODE_CALLS = 40             # p75 is then the highest percentile with 10 samples beyond
OUT_DIR = Path(__file__).resolve().parent / "chiprun_out"
TRACE_ATTEMPTS = 4            # profiler sessions tried where one records no kernel (traced)
PROFILER_MARGIN_S = 0.05      # host idle around a profiler session's warm-up and run (traced)
WARM_KERNELS = 16             # spin kernels that open each profiler session (traced)
WARM_KERNEL = "spin_kernel"   # their name, left out of every kernel row read (kernel_rows)
PROFILER_SESSIONS = {"sessions": 0, "taken_again": 0}
REPLACES = {
    "gn_act_onepass": "simulgen_vae_tpu/ops/groupnorm_gelu.py:109",
    "gn_stats": "simulgen_vae_tpu/ops/groupnorm_gelu.py:352",
    "gn_apply": "simulgen_vae_tpu/ops/groupnorm_gelu.py:366",
}
TRAIN_REPLACES = {
    "gather_augment": "simulgen_vae_tpu/ops/gather_augment.py:56",
    "gn_bwd_onepass": "simulgen_vae_tpu/ops/groupnorm_gelu.py:196",
    "gn_bwd_stats": "simulgen_vae_tpu/ops/groupnorm_gelu.py:436",
    "gn_bwd_apply": "simulgen_vae_tpu/ops/groupnorm_gelu.py:467",
}
READOUT_REPLACES = {
    "readout_matmul_stats": "simulgen_vae_tpu/ops/readout_chain.py:106",
    "readout_loss": "simulgen_vae_tpu/ops/readout_chain.py:129",
    "readout_bwd_stats": "simulgen_vae_tpu/ops/readout_chain.py:206",
    "readout_bwd_dy": "simulgen_vae_tpu/ops/readout_chain.py:309",
}
STACK_REPLACES = {
    "readout_bwd_fused": "simulgen_vae_tpu/ops/readout_chain.py:229",
    # no Pallas kernel: XLA's one-sweep fusion of FusedAdamW.apply
    "fused_adamw": "simulgen_vae_tpu/train/optim.py:127",
}
# Operations per element, counting erff / tanhf / expf / logf / sincospif as
# one each.
NORM_OPS, ACT_OPS, STATS_OPS = 4, {"gelu": 5, "tanh": 1, "none": 0}, 3
ACT_GRAD_OPS = {"gelu": 9, "tanh": 3, "none": 0}
BWD_SUM_OPS, BWD_DX_OPS = 8, 4       # four column sums; dx from dxn, m1, m2, inv
MIX_OPS, NOISE_OPS = 5, 33           # amp + mixup; Philox (25) + Box-Muller (8)
LOSS_OPS, LOSS_GRAD_OPS = 5, 8       # loss and squared error; dl/do, (1 - o^2), da
TRAIN_SAMPLES, TRAIN_EPOCHS, STEP_TIMING = 64, 1, 10
READOUT_F, READOUT_C, READOUT_G = 1024, 95008, 8
# The times of five kernels' earlier designs (one block per sample; an
# mma.sync tile fed by cp.async; one thread a column and a second launch) on
# an NVIDIA H100 80GB HBM3 at 700 W (PERF.md,
# the kernel table), per decode and per step, back to back: constants,
# printed beside this run's times on the timing lines and nowhere else.
EARLIER_MS = {"gn_act_onepass": 0.331, "readout_matmul_stats": 3.723, "gn_bwd_onepass": 0.514,
              "gn_bwd_stats": 2.014, "gn_stats": 0.579}
# The launches per step those two earlier times cover: #3 at C = 128 and 256;
# #6 from C = 512 up (the C = 512 maps take #3 now).
EARLIER_LAUNCHES = {"gn_bwd_onepass": 8, "gn_bwd_stats": 17}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    """Device time of one call of ``fn``: ``reps`` calls captured in a CUDA
    graph and replayed, so the host's launch cost drops out."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the default stream, as capture wants
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (3 * reps)


def traced(run, cpu: bool = True, expect: str | None = None, **kwargs):
    """A torch.profiler session around ``run()`` (then a synchronize), as
    (profiler, what ``run`` returned). On the card a session now and then
    loses the records of its first two or three kernels, though they ran and
    their results are right. So each session opens with WARM_KERNELS spin
    kernels (``torch.cuda._sleep``; ``kernel_rows`` and ``cluster_launch``
    leave them out) and a synchronize, and idles PROFILER_MARGIN_S on the
    host before the warm-up, before ``run`` and after it (the trace's kernel
    timestamps also stand up to milliseconds off the host's launch calls:
    see ``cluster_launch``). A session that still records no kernel (none
    whose name holds ``expect``, where given) is taken again, up to
    TRACE_ATTEMPTS times, and a run that no session records fails.
    PROFILER_SESSIONS counts the sessions and those taken again."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] * cpu + [ProfilerActivity.CUDA]
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        PROFILER_SESSIONS["sessions"] += 1
        with profile(activities=activities, **kwargs) as prof:
            time.sleep(PROFILER_MARGIN_S)
            for _ in range(WARM_KERNELS):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            time.sleep(PROFILER_MARGIN_S)
            out = run()
            torch.cuda.synchronize()
            time.sleep(PROFILER_MARGIN_S)
        if any(expect is None or expect in e.key for e in kernel_rows(prof)):
            return prof, out
        PROFILER_SESSIONS["taken_again"] += 1
        print(f"profiler: session {attempt} of {TRACE_ATTEMPTS} recorded no kernel"
              + (f" named {expect}" if expect else "") + "; tracing again")
    raise AssertionError(f"no kernel{' named ' + expect if expect else ''} recorded in "
                         f"{TRACE_ATTEMPTS} profiler sessions")


def kernel_rows(prof) -> list:
    """The kernel rows of a ``traced`` session's ``key_averages()``, without
    its warm-up kernels."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and WARM_KERNEL not in e.key]


def profiled_device_ms(fn, reps: int) -> float:
    """Device time of one call of ``fn``: its kernels' own time in a profiler
    trace of ``reps`` calls, for calls a CUDA graph cannot capture (autograd's
    backward of a library call)."""
    fn()
    torch.cuda.synchronize()
    prof, _ = traced(lambda: [fn() for _ in range(reps)], cpu=False)
    return sum(e.self_device_time_total for e in kernel_rows(prof)) / 1e3 / reps


# The libraries whose bf16 kernels rest on wgmma fed by TMA.
WGMMA_TMA_LIBS = ("readout_matmul_stats", "readout_bwd_fused")


def sass_check(_build) -> dict:
    """Each built library of WGMMA_TMA_LIBS holds in its SASS the Hopper
    instructions its design rests on: HGMMA (wgmma) and UTMALDG (TMA loads)."""
    tool = Path(_build.nvcc_path()).with_name("cuobjdump")
    out = {}
    for name in WGMMA_TMA_LIBS:
        sass = subprocess.run([str(tool), "-sass", str(_build.library_path(name))],
                              capture_output=True, text=True, check=True, timeout=120).stdout
        counts = {op: len(re.findall(rf"\b{op}\b", sass)) for op in ("HGMMA", "UTMALDG")}
        print(f"build: {name} SASS: {counts['HGMMA']} HGMMA, {counts['UTMALDG']} UTMALDG -> "
              f"{'ok' if all(counts.values()) else 'FAIL'}")
        if not all(counts.values()):
            raise AssertionError(f"{name} was not built with wgmma and TMA: {counts}")
        out[name] = counts
    return out


def product_alone_ms(rc, call, reps: int) -> float:
    """Time of ``call`` (a bf16 ``readout_matmul_stats``) with the library built
    with READOUT_PRODUCT_ONLY in place of the real one: the product without
    the epilogue and the finalize (y and the statistics are left unwritten)."""
    from simulgen_vae_tpu_torch.ops import _build

    real = _build.load("readout_matmul_stats")
    _build._LIBS["readout_matmul_stats"] = _build.load("readout_matmul_stats_product")
    try:
        return cuda_ms(call, reps)
    finally:
        _build._LIBS["readout_matmul_stats"] = real


def cluster_launch(name: str, call, what: str, alone: bool = True) -> dict:
    """``name``'s launch as a profiler trace records it for one ``call`` (at
    B = 16): the call launches ``name``'s kernel once (and no other kernel
    where ``alone``), with a grid of >= 64 blocks and >= 2 per sample,
    through cudaLaunchKernelEx (the call that takes a cluster dimension).
    Where the trace records the cluster size it must be >= 2; where it does
    not, the kernel's agreement with its plain version stands for it, as the
    kernel finds its sample from the cluster size it reads from the
    hardware, and its rows or columns from its rank. Also given: the
    kernel's start in the trace less its launch call's (negative where the
    trace's GPU clock stands behind the host's)."""
    call()
    torch.cuda.synchronize()
    prof, _ = traced(call, expect=f"{name}_kernel")
    trace = OUT_DIR / f"{name}_trace.json"
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text())["traceEvents"]
    launched = [e for e in events
                if e.get("cat") == "kernel" and WARM_KERNEL not in e.get("name", "")]
    kernel = [e for e in launched if f"{name}_kernel" in e.get("name", "")]
    if len(kernel) != 1 or "grid" not in kernel[0].get("args", {}):
        raise AssertionError(f"the trace holds {len(kernel)} {name} launches with a grid")
    args = kernel[0]["args"]
    api_events = [e for e in events if e.get("cat") == "cuda_runtime"
                  and e.get("args", {}).get("correlation") == args.get("correlation")]
    api = [e["name"] for e in api_events]
    lead_us = (float(kernel[0]["ts"]) - float(api_events[0]["ts"])) if api_events else None
    blocks = int(np.prod(args["grid"]))
    cluster = {k: v for k, v in args.items() if "cluster" in k.lower()}
    launch = dict(grid=args["grid"], block=args["block"], api=api, blocks_per_sample=blocks / B,
                  cluster=cluster or None, kernels_per_call=len(launched),
                  kernel_less_launch_us=lead_us)
    ok = ((len(launched) == 1 or not alone) and blocks >= 64 and blocks % B == 0 and blocks // B >= 2
          and any("LaunchKernelEx" in a for a in api)
          and all(int(np.prod(v)) >= 2 for v in cluster.values() if isinstance(v, (int, list))))
    print(f"{what}: {name} launch (profiler trace, B={B}): {len(launched)} kernel(s) per call, "
          f"grid {args['grid']}, block {args['block']}, {blocks // B} blocks per sample, "
          f"through {api} (kernel start less launch call: "
          + (f"{lead_us:.1f} us" if lead_us is not None else "no launch call") + "); cluster "
          + (f"{cluster}" if cluster else "not recorded by the trace (the agreement above needs "
             f"clusters of {blocks // B})") + f" -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} launch {launch}: wanted one kernel a call, >= 64 blocks, "
                             ">= 2 per sample, as clusters")
    return launch


def _map(c: int, dtype, gen):
    x = torch.randn((B, T, c), generator=gen, device="cuda").to(dtype)
    scale = 1.0 + 0.1 * torch.randn(c, generator=gen, device="cuda")
    bias = 0.1 * torch.randn(c, generator=gen, device="cuda")
    return x, scale, bias


def _err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def _assert_close(name, got, want, dtype):
    if dtype == torch.float32:
        ok = torch.allclose(got, want, atol=2e-5, rtol=0)
    else:
        ok = torch.allclose(got.float(), want.float(), atol=1e-2, rtol=1e-2)
    if not ok:
        raise AssertionError(f"{name}: max abs err {_err(got, want):.3g} ({dtype})")


def phase_kernels(gg, widths, gen) -> dict:
    """Each kernel vs its plain version at every (C, G, act) the decode uses."""
    errs = {k: {"float32": 0.0, "bfloat16": 0.0} for k in REPLACES}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        for c, g, act in widths:
            x, scale, bias = _map(c, dtype, gen)
            if gg.onepass_fits(T, c, g, x.element_size()):
                got = gg.gn_act_onepass(x, scale, bias, g, act=act)
                if not torch.equal(got, gg.gn_act_onepass(x, scale, bias, g, act=act)):
                    raise AssertionError(f"gn_act_onepass C={c} ({dtype}): two calls differ")
                want = gg.group_norm_act_reference(x, scale, bias, g, act=act)
                _assert_close(f"gn_act_onepass C={c}", got, want, dtype)
                errs["gn_act_onepass"][dname] = max(errs["gn_act_onepass"][dname],
                                                    _err(got, want))
                route = "gn_act_onepass (two calls the same bits)"
            else:
                stats = _check_stats(gg, x, g)
                want_stats = gg.group_stats_reference(x, g)
                errs["gn_stats"][dname] = max(errs["gn_stats"][dname],
                                              _err(stats, want_stats))
                got = gg.gn_apply(x, scale, bias, want_stats, g, act)
                want = gg.group_apply_reference(x, scale, bias, want_stats, g, act)
                _assert_close(f"gn_apply C={c}", got, want, dtype)
                errs["gn_apply"][dname] = max(errs["gn_apply"][dname], _err(got, want))
                both = gg.gn_apply(x, scale, bias, stats, g, act)
                _assert_close(f"gn_stats+gn_apply C={c}", both,
                              gg.group_norm_act_reference(x, scale, bias, g, act=act),
                              dtype)
                route = "gn_stats+gn_apply (gn_stats: two calls the same bits)"
            torch.cuda.synchronize()
            print(f"kernels: {dname} C={c} G={g} act={act} -> {route} ok")
    # gn_stats at ragged edges: T = 1 and C = 1000 (no multiple of 128); C =
    # 300 in bf16 (no multiple of a 16-byte vector: one element a load); G =
    # 128 (the JAX kernel's lane limit; 8-wide groups)
    for dtype, t, c, g in ((torch.float32, 1, 1000, 8), (torch.bfloat16, 37, 300, 4),
                           (torch.float32, 3, 1024, 128)):
        x = torch.randn((B, t, c), generator=gen, device="cuda").to(dtype)
        dname = str(dtype).split(".")[1]
        errs["gn_stats"][dname] = max(errs["gn_stats"][dname],
                                      _err(_check_stats(gg, x, g), gg.group_stats_reference(x, g)))
        print(f"kernels: {dname} T={t} C={c} G={g} -> gn_stats ok (two calls the same bits)")
    # the rule's edge: f32, T = 1, the widest C with G = 16 that onepass_fits
    # takes, where a block needs all the shared memory the rule counts
    c = 16
    while gg.onepass_fits(1, c + 16, 16, 4):
        c += 16
    x = torch.randn((2, 1, c), generator=gen, device="cuda")
    scale = 1.0 + 0.1 * torch.randn(c, generator=gen, device="cuda")
    bias = torch.zeros(c, device="cuda")
    got = gg.gn_act_onepass(x, scale, bias, 16)
    _assert_close(f"gn_act_onepass T=1 C={c}", got,
                  gg.group_norm_act_reference(x, scale, bias, 16), torch.float32)
    print(f"kernels: float32 T=1 C={c} G=16 (the engage rule's edge, "
          f"{gg.onepass_smem_bytes(1, c, 16, 4)} of {gg.ONEPASS_SMEM_LIMIT} bytes) -> "
          "gn_act_onepass ok")
    return errs


def _check_stats(gg, x, g):
    """gn_stats on ``x`` against its plain version (atol 2e-5, rtol 1e-5),
    the same bits on two calls."""
    stats = gg.gn_stats(x, g)
    want = gg.group_stats_reference(x, g)
    if not torch.allclose(stats, want, atol=2e-5, rtol=1e-5):
        raise AssertionError(f"gn_stats {tuple(x.shape)} {x.dtype} G={g}: {_err(stats, want):.3g}")
    if not torch.equal(stats, gg.gn_stats(x, g)):
        raise AssertionError(f"gn_stats {tuple(x.shape)} {x.dtype} G={g}: two calls differ")
    return stats


def gn_stats_launches(gg, gen) -> dict:
    """gn_stats as profiler traces record it at a narrow and the readout
    width: one kernel a call (no finalize launch), B x STATS_CLUSTER blocks
    through cudaLaunchKernelEx."""
    out = {}
    for c in (1024, 95008):
        x = _map(c, torch.bfloat16, gen)[0]
        out[c] = cluster_launch("gn_stats", lambda: gg.gn_stats(x, 8), f"kernels C={c}")
        if out[c]["blocks_per_sample"] != gg.STATS_CLUSTER:
            raise AssertionError(f"gn_stats C={c}: {out[c]['blocks_per_sample']} blocks a "
                                 f"sample, not {gg.STATS_CLUSTER}")
        del x
    return out


@contextlib.contextmanager
def plain_group_norm(blocks, gg):
    """Route the model's GroupNorm through the plain version, on the card."""
    real = blocks.group_norm_act
    blocks.group_norm_act = gg.group_norm_act_reference
    try:
        yield
    finally:
        blocks.group_norm_act = real


@contextlib.contextmanager
def pre_repair_layers(blocks):
    """The bf16 layers as they were before the two rounding repairs: the bias
    inside the product of a layer without spectral norm, and one fused
    ``F.gelu`` (for the before/after decode timing only)."""
    from simulgen_vae_tpu_torch.models import conditioner_mlp, decoder

    def fused_bias(product, x, w, b, inv_sigma):
        if inv_sigma is None:
            return product(x, w, b)
        return blocks._scaled(product(x, w), inv_sigma, b)

    patched = [(blocks, "_biased", fused_bias)] + [
        (m, "gelu", F.gelu) for m in (blocks, decoder, conditioner_mlp)]
    saved = [(m, name, getattr(m, name)) for m, name, _ in patched]
    for m, name, fn in patched:
        setattr(m, name, fn)
    try:
        yield
    finally:
        for m, name, fn in saved:
            setattr(m, name, fn)


def decode_device(fn, batch, calls: int = 3) -> dict:
    """Device time and kernel launches per decode from a profiler trace of
    ``calls`` decodes (kernel rows only)."""
    prof, _ = traced(lambda: [fn(batch) for _ in range(calls)])
    rows = kernel_rows(prof)
    return dict(device_ms=sum(e.self_device_time_total for e in rows) / 1e3 / calls,
                kernels=sum(e.count for e in rows) / calls)


def erfc_bits(blocks, gen, n: int = 4096) -> dict:
    """bf16 ``torch.erfc``, the port's bf16 ``gelu`` and its gradient on the
    card against the CPU's on ``n`` values ~ 3 N(0, 1) with a cotangent ~ N(0,
    1): the count of outputs whose bits differ (the repaired gelu rounds as
    JAX's only if the card's erfc and exp round as the CPU's, where the CPU
    tests hold it to JAX)."""
    x = (3.0 * torch.randn(n, generator=gen, device="cuda")).to(torch.bfloat16)
    ct = torch.randn(n, generator=gen, device="cuda").to(torch.bfloat16)
    xc = x.cpu()

    def grad(v, w):
        v = v.detach().requires_grad_()
        blocks.gelu(v).backward(w)
        return v.grad

    out = dict(values=n,
               erfc_differ=int((torch.erfc(x).cpu() != torch.erfc(xc)).sum()),
               gelu_differ=int((blocks.gelu(x).cpu() != blocks.gelu(xc)).sum()),
               gelu_grad_differ=int((grad(x, ct).cpu() != grad(xc, ct.cpu())).sum()))
    ok = max(out["erfc_differ"], out["gelu_differ"], out["gelu_grad_differ"]) <= n // 100
    print(f"serve: bf16 erfc on the card vs the CPU over {n} values: {out['erfc_differ']} "
          f"differ; bf16 gelu {out['gelu_differ']}, its gradient {out['gelu_grad_differ']} "
          f"differ -> {'ok' if ok else 'FAIL'} (at most 1%)")
    if not ok:
        raise AssertionError(f"bf16 erfc / gelu on the card round unlike the CPU: {out}")
    return out


@contextlib.contextmanager
def recording_calls(blocks, calls: list):
    """Record (C, G, act) of every GroupNorm the model calls."""
    real = blocks.group_norm_act

    def record(x, scale, bias, num_groups, eps=1e-5, act="gelu"):
        calls.append((x.shape[2], num_groups, act))
        return real(x, scale, bias, num_groups, eps, act)

    blocks.group_norm_act = record
    try:
        yield
    finally:
        blocks.group_norm_act = real


def _rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def kernel_timings(gg, calls, reps, gen, card) -> dict:
    """Per kernel and main-path shape: kernel, plain and library ms, bound."""
    per_shape = {k: [] for k in REPLACES}
    for (c, g, act), n in sorted({k: calls.count(k) for k in set(calls)}.items()):
        x, scale, bias = _map(c, torch.bfloat16, gen)
        elems, xb = B * T * c, B * T * c * x.element_size()
        xt = x.transpose(1, 2).contiguous()     # library layout [B, C, T], not timed
        s16, b16 = scale.to(x.dtype), bias.to(x.dtype)
        act_fn = {"gelu": F.gelu, "tanh": torch.tanh, "none": lambda v: v}[act]
        lib_gn = cuda_ms(lambda: act_fn(F.group_norm(xt, g, s16, b16, 1e-5)), reps)

        def row(name, ms, plain_ms, library_ms, nbytes, ops, library_call):
            t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
            per_shape[name].append(dict(
                C=c, G=g, act=act, per_decode=n, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, library_call=library_call,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations"))

        if gg.onepass_fits(T, c, g, x.element_size()):
            def kernel():
                return gg.gn_act_onepass(x, scale, bias, g, act=act)

            row("gn_act_onepass", cuda_ms(kernel, reps),
                cuda_ms(lambda: gg.group_norm_act_reference(x, scale, bias, g, act=act),
                        reps),
                lib_gn, 2 * xb + 8 * c, elems * (STATS_OPS + NORM_OPS + ACT_OPS[act]),
                "F.group_norm + activation")
            per_shape["gn_act_onepass"][-1].update(
                device_ms=graph_ms(kernel, reps),
                library_device_ms=graph_ms(
                    lambda: act_fn(F.group_norm(xt, g, s16, b16, 1e-5)), reps))
        else:
            stats = gg.gn_stats(x, g)
            cg = c // g
            def stats_kernel():
                return gg.gn_stats(x, g)

            def var_mean():
                return torch.var_mean(x.view(B, T, g, cg), dim=(1, 3))

            row("gn_stats", cuda_ms(stats_kernel, reps),
                cuda_ms(lambda: gg.group_stats_reference(x, g), reps),
                cuda_ms(var_mean, reps), xb + 8 * B * g, elems * STATS_OPS, "torch.var_mean")
            per_shape["gn_stats"][-1].update(device_ms=graph_ms(stats_kernel, reps),
                                             library_device_ms=graph_ms(var_mean, reps))
            row("gn_apply",
                cuda_ms(lambda: gg.gn_apply(x, scale, bias, stats, g, act), reps),
                cuda_ms(lambda: gg.group_apply_reference(x, scale, bias, stats, g, act),
                        reps),
                lib_gn, 2 * xb + 8 * c + 8 * B * g, elems * (NORM_OPS + ACT_OPS[act]),
                "F.group_norm + activation (whole GroupNorm)")
        print(f"timing: [{card}] C={c} G={g} act={act} x{n}/decode: " + ", ".join(
            f"{k} {v[-1]['ms']:.4f} ms (plain {v[-1]['plain_ms']:.4f}, library "
            f"{v[-1]['library_ms']:.4f}, bound {v[-1]['bound_ms']:.4f})"
            for k, v in per_shape.items() if v and v[-1]["C"] == c))
        for name in ("gn_act_onepass", "gn_stats"):
            r = per_shape[name][-1] if per_shape[name] else {}
            if r.get("C") == c:
                print(f"timing: [{card}] C={c} {name} device only (CUDA graph): "
                      f"{r['device_ms']:.4f} ms, library {r['library_device_ms']:.4f} ms")
    return per_shape


# -- 5. the train step --------------------------------------------------------

def _bwd_case(c, dtype, gen):
    x, scale, bias = _map(c, dtype, gen)
    return x, torch.randn((B, T, c), generator=gen, device="cuda").to(dtype), scale, bias


def _assert_sums_close(name, got, want, tol):
    """f32 sums over B * T rows (dscale, dbias and their partials)."""
    for part, a, b in zip(("dscale", "dbias"), got, want):
        if not torch.allclose(a, b, atol=tol, rtol=tol):
            raise AssertionError(f"{name} {part}: max abs err {_err(a, b):.3g}")


def _same_bits(name, call):
    """Two calls of ``call`` give the same bits in every output."""
    a, b = call(), call()
    if not all(torch.equal(u, v) for u, v in zip(a, b)):
        raise AssertionError(f"{name}: two calls differ")
    return a


def check_train_gn_kernels(gg, shapes, gen) -> dict:
    """#3, #6, #7 against their plain versions at every (C, G, act) of the
    step, on the route the step takes there, in f32 and bf16; #3 and #6 give
    the same bits on two calls; #3 also at its engage rule's edge."""
    errs = {k: {"float32": 0.0, "bfloat16": 0.0} for k in TRAIN_REPLACES if k != "gather_augment"}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        vec_tol = 1e-4 if dtype == torch.float32 else 1e-3
        for c, g, act in shapes:
            x, grad, scale, bias = _bwd_case(c, dtype, gen)
            route = ("onepass" if gg.bwd_onepass_engages(T, c, g, x.element_size())
                     else "two_phase")
            if route == "onepass":
                got = _same_bits(f"gn_bwd_onepass C={c} ({dtype})",
                                 lambda: gg.gn_bwd_onepass(x, scale, bias, grad, g, act=act))
                want = gg.group_norm_act_backward_reference(x, scale, bias, grad, g, act=act)
                _assert_close(f"gn_bwd_onepass C={c} dx", got[0], want[0], dtype)
                _assert_sums_close(f"gn_bwd_onepass C={c}", got[1:], want[1:], vec_tol)
                here = {"gn_bwd_onepass": max(_err(a, b) for a, b in zip(got, want))}
            else:
                stats = gg.group_stats_reference(x, g)
                got = _same_bits(f"gn_bwd_stats C={c} ({dtype})",
                                 lambda: gg.gn_bwd_stats(x, scale, bias, grad, stats, g, act))
                want = gg.gn_bwd_stats_reference(x, scale, bias, grad, stats, g, act)
                if not torch.allclose(got[0], want[0], atol=1e-6, rtol=1e-4):
                    raise AssertionError(f"gn_bwd_stats C={c} msums: {_err(got[0], want[0]):.3g}")
                _assert_sums_close(f"gn_bwd_stats C={c}", got[1:], want[1:], vec_tol)
                here = {"gn_bwd_stats": max(_err(a, b) for a, b in zip(got, want))}
                dx = gg.gn_bwd_apply(x, scale, bias, grad, stats, want[0], g, act)
                dx_want = gg.gn_bwd_apply_reference(x, scale, bias, grad, stats, want[0], g, act)
                _assert_close(f"gn_bwd_apply C={c}", dx, dx_want, dtype)
                here["gn_bwd_apply"] = _err(dx, dx_want)
                both = gg.gn_bwd_apply(x, scale, bias, grad, gg.gn_stats(x, g), got[0], g, act)
                _assert_close(f"gn_stats+gn_bwd_stats+gn_bwd_apply C={c}", both,
                              gg.group_norm_act_backward_reference(
                                  x, scale, bias, grad, g, act=act)[0], dtype)
            torch.cuda.synchronize()
            for k, e in here.items():
                errs[k][dname] = max(errs[k][dname], e)
            print(f"train kernels: {dname} C={c} G={g} act={act} -> {route} backward ok "
                  "(two calls the same bits); max abs err against the plain version: "
                  + ", ".join(f"{k} {e:.3g}" for k, e in here.items()))
            del x, grad
    # #3 at its rule's edge: f32, T = 1, the widest C with G = 16 that
    # onepass_bwd_fits takes, where rank 0 needs all the shared memory the
    # rule counts
    c = 16
    while gg.onepass_bwd_fits(1, c + 16, 16, 4):
        c += 16
    x = torch.randn((2, 1, c), generator=gen, device="cuda")
    grad = torch.randn((2, 1, c), generator=gen, device="cuda")
    scale = 1.0 + 0.1 * torch.randn(c, generator=gen, device="cuda")
    bias = torch.zeros(c, device="cuda")
    got = gg.gn_bwd_onepass(x, scale, bias, grad, 16)
    want = gg.group_norm_act_backward_reference(x, scale, bias, grad, 16)
    _assert_close(f"gn_bwd_onepass T=1 C={c} dx", got[0], want[0], torch.float32)
    _assert_sums_close(f"gn_bwd_onepass T=1 C={c}", got[1:], want[1:], 1e-4)
    print(f"train kernels: float32 T=1 C={c} G=16 (the one-pass backward rule's edge, "
          f"{gg.onepass_bwd_smem_bytes(1, c, 16, 4)} of {gg.ONEPASS_SMEM_LIMIT} bytes) -> "
          "gn_bwd_onepass ok")
    return errs


def gn_bwd_launches(gg, gen) -> dict:
    """#3 and #6 as profiler traces record them: B x 8 blocks through
    cudaLaunchKernelEx, and #6 one kernel a call (no finalize launch)."""
    x, grad, scale, bias = _bwd_case(512, torch.bfloat16, gen)
    out = {"gn_bwd_onepass": cluster_launch(
        "gn_bwd_onepass", lambda: gg.gn_bwd_onepass(x, scale, bias, grad, 8), "train kernels",
        alone=False)}  # the wrapper's batch sums of dscale, dbias follow it
    x, grad, scale, bias = _bwd_case(1024, torch.bfloat16, gen)
    stats = gg.group_stats_reference(x, 8)
    out["gn_bwd_stats"] = cluster_launch(
        "gn_bwd_stats", lambda: gg.gn_bwd_stats(x, scale, bias, grad, stats, 8), "train kernels")
    return out


def check_gather_augment(ga, data, gen) -> float:
    """#1 against its plain version at the step's shape: without noise the
    same bits; with noise sd = 0.05 on half the rows, (out - x) / sd has mean
    within 0.01 of 0 and std within 0.01 of 1, the other rows are unchanged,
    and the same seed gives the same bits. Returns the max abs error."""
    n, dname = data.shape[0], str(data.dtype).split(".")[1]
    idx = torch.randint(0, n, (B,), generator=gen, device="cuda", dtype=torch.int32)
    pidx = torch.randint(0, n, (B,), generator=gen, device="cuda", dtype=torch.int32)
    lam = torch.where(torch.rand(B, generator=gen, device="cuda") < 0.5,
                      0.1 + 0.8 * torch.rand(B, generator=gen, device="cuda"), 1.0)
    amp = torch.where(torch.rand(B, generator=gen, device="cuda") < 0.5,
                      0.9 + 0.2 * torch.rand(B, generator=gen, device="cuda"), 1.0)
    zero = torch.zeros(B, device="cuda")
    got = ga.gather_augment(data, idx, pidx, 7, lam, amp, zero)
    want = ga.gather_augment_reference(data, idx, pidx, None, lam, amp, zero)
    if not torch.equal(got, want):
        raise AssertionError(f"gather_augment ({dname}) differs without noise: "
                             f"{_err(got, want):.3g}")
    ones = torch.ones(B, device="cuda")
    sd = torch.tensor([0.05, 0.0] * (B // 2), device="cuda")
    noisy = ga.gather_augment(data, idx, idx, 11, ones, ones, sd)
    again = ga.gather_augment(data, idx, idx, 11, ones, ones, sd)
    x = data.index_select(0, idx.long())
    z = (noisy[0::2].float() - x[0::2].float()) / 0.05
    mean, std = float(z.mean()), float(z.std())
    same = torch.equal(noisy, again) and torch.equal(noisy[1::2], x[1::2])
    print(f"train kernels: gather_augment {dname} [{n}, {T}, {data.shape[2]}] -> "
          f"[{B}, {T}, {data.shape[2]}]: no-noise bits equal; noise mean {mean:.5f} "
          f"std {std:.5f}; sd=0 rows and repeat {'equal' if same else 'DIFFER'}")
    if abs(mean) > 0.01 or abs(std - 1.0) > 0.01 or not same:
        raise AssertionError("gather_augment noise is off")
    return _err(got, want)


def _grad_rel(a, b) -> float:
    nb = float(torch.linalg.vector_norm(b.float()))
    na = float(torch.linalg.vector_norm((a.float() - b.float())))
    return 0.0 if na == 0.0 else na / max(nb, 1e-30)


def compare_step(trainer, state, batch, blocks, gg, beta, label, loss_tol, grad_tol):
    """One loss-and-grads through the kernels and one through the plain
    GroupNorm on the card, same state, batch and reparameterisation noise."""
    out = {}
    for route in ("kernels", "plain"):
        gen = torch.Generator("cuda").manual_seed(7)
        ctx = plain_group_norm(blocks, gg) if route == "plain" else contextlib.nullcontext()
        with ctx:
            metrics, _, grads = trainer.loss_and_grads(state, batch, beta, generator=gen)
        out[route] = (float(metrics["loss"]), {k: g.clone() for k, g in grads.items()})
    (lk, gk), (lp, gp) = out["kernels"], out["plain"]
    loss_rel = abs(lk - lp) / abs(lp)
    rels = {k: _grad_rel(gk[k], gp[k]) for k in gk}
    worst = max(rels, key=rels.get)
    ok = loss_rel <= loss_tol and (grad_tol is None or rels[worst] <= grad_tol)
    print(f"train: kernels vs plain step, {label}: loss {lk:.6g} vs {lp:.6g} "
          f"(rel {loss_rel:.3g}), worst gradient rel-L2 {rels[worst]:.3g} ({worst}) "
          f"-> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"kernel and plain train steps disagree ({label})")
    return dict(loss_kernels=lk, loss_plain=lp, loss_rel=loss_rel,
                worst_grad_rel_l2=rels[worst], worst_grad=worst)


def train_kernel_timings(gg, ga, shapes, data, reps, gen, card) -> dict:
    """Per train kernel and step shape: kernel, plain and library ms, bound."""
    per_shape = {k: [] for k in TRAIN_REPLACES}

    def row(name, n, ms, plain_ms, library_ms, nbytes, ops, library_call, **shape):
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
        per_shape[name].append(dict(
            **shape, per_step=n, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
            library_call=library_call, bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations"))

    for (c, g, act), n in sorted(shapes.items()):
        x, grad, scale, bias = _bwd_case(c, torch.bfloat16, gen)
        elems, xb = B * T * c, B * T * c * x.element_size()
        act_fn = {"gelu": F.gelu, "tanh": torch.tanh, "none": lambda v: v}[act]
        xt = x.transpose(1, 2).contiguous().requires_grad_()
        w16 = scale.to(x.dtype).requires_grad_()
        b16 = bias.to(x.dtype).requires_grad_()
        lib_out = act_fn(F.group_norm(xt, g, w16, b16, 1e-5))
        gt = grad.transpose(1, 2).contiguous()
        lib = cuda_ms(lambda: torch.autograd.grad(lib_out, (xt, w16, b16), gt,
                                                  retain_graph=True), reps)
        lib_call = "autograd backward of F.group_norm + activation on [B, C, T]"
        kw = dict(C=c, G=g, act=act)
        lib_device = profiled_device_ms(lambda: torch.autograd.grad(
            lib_out, (xt, w16, b16), gt, retain_graph=True), reps)
        if gg.bwd_onepass_engages(T, c, g, x.element_size()):
            ops = elems * (STATS_OPS + NORM_OPS + ACT_GRAD_OPS[act] + BWD_SUM_OPS + BWD_DX_OPS)

            def kernel():
                return gg.gn_bwd_onepass(x, scale, bias, grad, g, act=act)

            row("gn_bwd_onepass", n, cuda_ms(kernel, reps),
                cuda_ms(lambda: gg.group_norm_act_backward_reference(
                    x, scale, bias, grad, g, act=act), reps),
                lib, 3 * xb + 8 * c + 8 * B * c, ops, lib_call, **kw)
            per_shape["gn_bwd_onepass"][-1].update(
                device_ms=graph_ms(kernel, reps), profiled_ms=profiled_device_ms(kernel, reps),
                library_device_ms=lib_device)
        else:
            stats = gg.gn_stats(x, g)
            msums = gg.gn_bwd_stats(x, scale, bias, grad, stats, g, act)[0]

            def kernel():
                return gg.gn_bwd_stats(x, scale, bias, grad, stats, g, act)

            row("gn_bwd_stats", n, cuda_ms(kernel, reps),
                cuda_ms(lambda: gg.gn_bwd_stats_reference(x, scale, bias, grad, stats, g,
                                                          act), reps),
                lib, 2 * xb + 8 * c + 8 * B * c + 16 * B * g,
                elems * (NORM_OPS + ACT_GRAD_OPS[act] + BWD_SUM_OPS),
                lib_call + " (whole backward)", **kw)
            per_shape["gn_bwd_stats"][-1].update(
                device_ms=graph_ms(kernel, reps), profiled_ms=profiled_device_ms(kernel, reps),
                library_device_ms=lib_device)
            row("gn_bwd_apply", n,
                cuda_ms(lambda: gg.gn_bwd_apply(x, scale, bias, grad, stats, msums, g,
                                                act), reps),
                cuda_ms(lambda: gg.gn_bwd_apply_reference(x, scale, bias, grad, stats,
                                                          msums, g, act), reps),
                lib, 3 * xb + 8 * c + 32 * B * g,
                elems * (NORM_OPS + ACT_GRAD_OPS[act] + BWD_DX_OPS),
                lib_call + " (whole backward)", **kw)
        print(f"timing: [{card}] train C={c} G={g} act={act} x{n}/step: " + ", ".join(
            f"{k} {v[-1]['ms']:.4f} ms (plain {v[-1]['plain_ms']:.4f}, library "
            f"{v[-1]['library_ms']:.4f}, bound {v[-1]['bound_ms']:.4f}"
            + (f"; device only {v[-1]['device_ms']:.4f}; kernels' own time in a profiler "
               f"trace {v[-1]['profiled_ms']:.4f}, library {v[-1]['library_device_ms']:.4f}"
               if "device_ms" in v[-1] else "") + ")"
            for k, v in per_shape.items() if v and v[-1].get("C") == c))
        del x, grad, xt, lib_out, gt

    rng = np.random.default_rng(1)
    lam, amp, sd = (torch.from_numpy(v).cuda() for v in ga.draw_augment_scalars(rng, B))
    idx, pidx = (torch.from_numpy(rng.integers(0, data.shape[0], B).astype(np.int32)).cuda()
                 for _ in range(2))
    row_elems = T * data.shape[2]
    noisy_rows = int((sd != 0).sum())
    ms = cuda_ms(lambda: ga.gather_augment(data, idx, pidx, 3, lam, amp, sd), reps)
    plain = cuda_ms(lambda: ga.gather_augment_reference(
        data, idx, pidx, torch.randn((B, T, data.shape[2]), generator=gen, device="cuda"),
        lam, amp, sd), reps)
    row("gather_augment", 1, ms, plain, None, 3 * B * row_elems * data.element_size() + 20 * B,
        B * row_elems * MIX_OPS + noisy_rows * row_elems * NOISE_OPS,
        "none: no single PyTorch call gathers, draws the noise and mixes",
        rows=f"[{data.shape[0]}, {T}, {data.shape[2]}] -> [{B}, {T}, {data.shape[2]}]",
        noisy_rows=noisy_rows)
    r = per_shape["gather_augment"][-1]
    print(f"timing: [{card}] train gather_augment x1/step ({noisy_rows} of {B} rows with "
          f"noise): {ms:.4f} ms (plain {plain:.4f}, bound {r['bound_ms']:.4f}, "
          f"{r['bound_by']}; no library call)")
    return per_shape


def train_config():
    """The flagship train configuration (bench.py's), 403.5M parameters."""
    from simulgen_vae_tpu_torch.config import VAEConfig

    return VAEConfig(num_param=TRAIN_SAMPLES, num_time=T, num_node=READOUT_C,
                     latent_dim_end=32, latent_dim=8, num_filter_enc=[1024, 512, 256, 128],
                     small=True, batch_size=B, lr=1e-3, alpha=1e6, loss_type="MSE",
                     dtype="bfloat16", use_spectral_norm=True)


def phase_train(args, card, blocks, gg, ga, gen):
    """Phase 5: the flagship train step. Returns (per-kernel dict, result dict,
    and the trainer, state and data for the phase after it)."""
    from simulgen_vae_tpu_torch.train.vae_trainer import VAETrainer

    cfg = train_config()
    trainer = VAETrainer(cfg, device="cuda", seed=args.seed)
    state = trainer.init_state(args.seed)
    n_params = sum(p.numel() for p in state.model.parameters())
    tgen = torch.Generator("cuda").manual_seed(args.seed + 1)
    data = (0.3 * torch.randn((TRAIN_SAMPLES, T, cfg.num_node), generator=tgen,
                              device="cuda")).to(torch.bfloat16)
    print(f"train: {n_params / 1e6:.1f}M parameters, dataset {tuple(data.shape)} "
          f"{data.dtype} ({data.numel() * 2 / 1e9:.2f} GB) on the card")

    # warm-up: two steps; the first records the GroupNorm shapes of a step
    calls = []
    with recording_calls(blocks, calls):
        state, m = trainer.train_epoch(state, data, max_steps=1)
    state, m = trainer.train_epoch(state, data, max_steps=1)
    torch.cuda.synchronize()
    shapes = {k: calls.count(k) for k in set(calls)}
    print(f"train: warm-up done (loss {float(m['loss']):.6g}); {len(calls)} GroupNorms per "
          f"step at C = {sorted({c for c, _, _ in calls})}")

    # each train kernel against its plain version
    errs = check_train_gn_kernels(gg, sorted(shapes), gen)
    traces = gn_bwd_launches(gg, gen)
    errs["gather_augment"] = {"bfloat16": check_gather_augment(ga, data, gen)}
    data32 = data[:20].float().contiguous()
    errs["gather_augment"]["float32"] = check_gather_augment(ga, data32, gen)

    # the main path: TRAIN_EPOCHS epochs through train_epoch, counters from 0
    gg.reset_launch_counts()
    ga.reset_launch_counts()
    steps, losses, norms = 0, [], []
    t0 = time.perf_counter()
    for _ in range(TRAIN_EPOCHS):
        state, m = trainer.train_epoch(state, data)
        losses.append(m["loss"])
        norms.append(m["grad_norm"])
        steps += -(-TRAIN_SAMPLES // B)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {**gg.LAUNCHES, **ga.LAUNCHES}
    losses, norms = [float(v) for v in losses], [float(v) for v in norms]
    if not all(np.isfinite(losses + norms)):
        raise AssertionError(f"non-finite train metrics: loss {losses}, grad norm {norms}")
    if not all(launches[k] > 0 for k in launches):
        raise AssertionError(f"a kernel did not run on the train path: {launches}")
    if launches["gather_augment"] != steps:
        raise AssertionError(f"gather_augment ran {launches['gather_augment']} times "
                             f"in {steps} steps")
    print(f"train: {TRAIN_EPOCHS} epochs = {steps} steps in {run_s:.3f} s; loss per epoch "
          f"{losses}, grad norm {norms}; launches {launches}")

    # step time: single steps through train_epoch, each synchronised
    lat = []
    for _ in range(STEP_TIMING):
        t0 = time.perf_counter()
        state, _ = trainer.train_epoch(state, data, max_steps=1)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    lat = np.asarray(lat)
    step_p50 = float(np.percentile(lat, 50))
    print(f"timing: [{card}] train step (batch {B}, bf16) over {STEP_TIMING} steps: p50 "
          f"{step_p50:.3f} ms, min/max {lat.min():.3f}/{lat.max():.3f} ms "
          f"({B / step_p50 * 1e3:.1f} samples/s at p50); peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB")

    # kernels vs plain versions, one step from the same state, batch and noise
    beta = 0.5
    zero, ones = torch.zeros(B, device="cuda"), torch.ones(B, device="cuda")
    rows = torch.arange(B, device="cuda", dtype=torch.int32)
    lam = torch.linspace(0.3, 1.0, B, device="cuda")
    batch = ga.gather_augment(data, rows, rows.flip(0).contiguous(), 5, lam, ones, zero)
    if not torch.equal(batch, ga.gather_augment_reference(data, rows, rows.flip(0), None,
                                                          lam, ones, zero)):
        raise AssertionError("gather_augment batch differs from its plain version")
    checks = {"bfloat16": compare_step(trainer, state, batch, blocks, gg, beta, "bf16",
                                       1e-2, None)}
    del batch
    trainer32 = VAETrainer(dataclasses.replace(cfg, dtype="float32"), device="cuda",
                           seed=args.seed)
    model32 = trainer32.build_model()
    model32.load_state_dict(state.model.state_dict())
    state32 = dataclasses.replace(state, model=model32, opt_state=None)
    batch32 = ga.gather_augment(data32, rows, rows.flip(0).contiguous(), 5, lam, ones, zero)
    checks["float32"] = compare_step(trainer32, state32, batch32, blocks, gg, beta,
                                     "f32, TF32 off", 1e-4, 1e-3)
    del trainer32, model32, state32, batch32
    torch.cuda.empty_cache()

    per_shape = train_kernel_timings(gg, ga, shapes, data, args.reps, gen, card)

    if args.profile:
        state, _ = profile_step(trainer, state, data, step_p50,
                                "chip_smoke_train_profile.txt", "train step")

    kernels = []
    for name, krows in per_shape.items():
        total = lambda key: sum(r[key] * r["per_step"] for r in krows)  # noqa: E731
        lib = None if name == "gather_augment" else total("library_ms")
        kernels.append(dict(
            name=name, route="cuda", source=f"simulgen_vae_tpu_torch/ops/csrc/{name}.cu",
            replaces=TRAIN_REPLACES[name], launches=launches[name],
            launches_per_step=launches[name] / steps,
            max_abs_err=errs[name]["bfloat16"], max_abs_err_f32=errs[name]["float32"],
            ms=total("ms"), plain_ms=total("plain_ms"), bound_ms=total("bound_ms"),
            bound_by="bytes" if all(r["bound_by"] == "bytes" for r in krows)
            else "operations",
            library_ms=lib, per_step_sum=True, card=card, shapes=krows))
        if name in EARLIER_MS:
            k = kernels[-1]
            k.update(device_ms=total("device_ms"), profiled_ms=total("profiled_ms"),
                     library_device_ms=total("library_device_ms"))
            print(f"timing: [{card}] {name} per step ({k['launches_per_step']:.0f} launches at C "
                  f"= {sorted({r['C'] for r in krows})}): {k['ms']:.4f} ms back to back (the "
                  f"constant for its earlier design: {EARLIER_MS[name]:.3f} ms, "
                  f"{EARLIER_LAUNCHES[name]} launches), device only {k['device_ms']:.4f} ms "
                  f"(CUDA graph); library {k['library_ms']:.4f} ms back to back; kernels' own "
                  f"time in a profiler trace {k['profiled_ms']:.4f} ms against the library's "
                  f"{k['library_device_ms']:.4f} ms: below the library call "
                  f"{k['profiled_ms'] < k['library_device_ms']}; bound {k['bound_ms']:.4f} ms")
    result = dict(step_p50_ms=step_p50, step_ms=lat.tolist(),
                  samples_per_s=B / step_p50 * 1e3, steps=steps, epoch_losses=losses,
                  epoch_grad_norms=norms, launches=launches, step_checks=checks,
                  gn_bwd_launches=traces,
                  params=n_params, peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    return kernels, result, dict(cfg=cfg, trainer=trainer, state=state, data=data,
                                 data32=data32)


# -- 6. the fused-readout train path ------------------------------------------

# (B, T, F, C, G, loss): two small ragged shapes (C = 300 puts bf16 rows off
# 16-byte boundaries and no 128-column tile holds a 50-wide group whole), then
# the flagship readout.
READOUT_SHAPES = [(3, T, 128, 300, 6, "Huber"), (3, T, 128, 5120, 8, "MAE"),
                  (B, T, READOUT_F, READOUT_C, READOUT_G, "MSE")]


def _readout_case(b, t, f, c, dtype, gen):
    def r(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    return dict(h=(0.5 * r(b, t, f)).to(dtype), w=(r(c, f) / f ** 0.5).to(dtype),
                bias=0.1 * r(c), scale=1.0 + 0.1 * r(c), nb=0.1 * r(c),
                x=(0.5 * r(b, t, c)).to(dtype), inv=torch.tensor(0.8, device="cuda"))


def _assert_rel(name, got, want, tol) -> float:
    rel = _grad_rel(got, want)
    if not rel <= tol:
        raise AssertionError(f"{name}: rel-L2 {rel:.3g} above {tol:g}")
    return rel


def check_matmul_stats(rc, k, g, tag):
    """#8 on one case: two calls give the same bits (y and stats), and they
    agree with the plain version (y: f32 atol 2e-5, bf16 atol/rtol 1e-2;
    stats: rel-L2 1e-4 f32, 1e-3 bf16). Returns the kernel's (y, stats), the
    plain version's, the max abs error of y and the rel-L2 of the stats."""
    dtype = k["h"].dtype
    y, stats = rc.readout_matmul_stats(k["h"], k["w"], k["bias"], k["inv"], g)
    y2, stats2 = rc.readout_matmul_stats(k["h"], k["w"], k["bias"], k["inv"], g)
    if not (torch.equal(y, y2) and torch.equal(stats, stats2)):
        raise AssertionError(f"readout_matmul_stats {tag}: two calls differ")
    del y2, stats2
    y0, stats0 = rc.matmul_stats_reference(k["h"], k["w"], k["bias"], k["inv"], g)
    _assert_close(f"readout_matmul_stats {tag} y", y, y0, dtype)
    rel = _assert_rel(f"readout_matmul_stats {tag} stats", stats, stats0,
                      1e-4 if dtype == torch.float32 else 1e-3)
    return (y, stats), (y0, stats0), _err(y, y0), rel


def check_readout_kernels(rc, gen) -> dict:
    """#8, #9, #10, #12 against their plain versions, f32 (TF32 off) and bf16.
    y: f32 atol 2e-5, bf16 atol/rtol 1e-2. Statistics, group means and the loss
    sums: rel-L2 1e-4 (f32), 1e-3 (bf16 inputs). dy: rel-L2 1e-5 / 1e-2 (its
    values are of order 1 / n_elem, so an absolute bound says nothing).
    Per-column sums over T: rel-L2 1e-4 / 1e-3. The d inv_sigma partials: 2e-3,
    a sum of 19M terms of both signs per sample that cancels to a small rest.
    Each kernel after the first takes the plain version's outputs, so each is
    held alone. Returns the max abs errors of the main outputs."""
    errs = {k: {"float32": 0.0, "bfloat16": 0.0} for k in READOUT_REPLACES}
    gvec = torch.tensor([1.7, 0.3, 0.8], device="cuda")   # (gl, gm, inv_sigma)
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        sum_tol, dy_tol = (1e-4, 1e-5) if dtype == torch.float32 else (1e-3, 1e-2)
        for b, t, f, c, g, lossfun in READOUT_SHAPES:
            k = _readout_case(b, t, f, c, dtype, gen)
            n_elem, tag = float(b * t * c), f"C={c} {dname}"
            chain = (k["x"], k["scale"], k["nb"])
            _, (y0, stats0), y_err, stats_rel = check_matmul_stats(rc, k, g, tag)
            rels = [stats_rel]
            errs["readout_matmul_stats"][dname] = max(errs["readout_matmul_stats"][dname],
                                                      y_err)
            sums = rc.readout_loss(y0, *chain, stats0, g, lossfun)
            sums0 = rc.loss_reference(y0, *chain, stats0, g, lossfun)
            rels.append(_assert_rel(f"readout_loss {tag}", sums, sums0, sum_tol))
            errs["readout_loss"][dname] = max(errs["readout_loss"][dname],
                                              _err(sums, sums0) / n_elem)
            got = rc.readout_bwd_stats(y0, *chain, stats0, gvec, n_elem, g, lossfun)
            want = rc.bwd_stats_reference(y0, *chain, stats0, gvec, n_elem, g, lossfun)
            for part, a, w0 in zip(("msums", "dscale", "dnorm_bias"), got, want):
                rels.append(_assert_rel(f"readout_bwd_stats {tag} {part}", a, w0, sum_tol))
            errs["readout_bwd_stats"][dname] = max(errs["readout_bwd_stats"][dname],
                                                   *(_err(a, w0) for a, w0 in zip(got, want)))
            msums = want[0]
            del got, want
            got = rc.readout_bwd_dy(y0, *chain, k["bias"], stats0, msums, gvec, n_elem, g,
                                    lossfun)
            want = rc.bwd_dy_reference(y0, *chain, k["bias"], stats0, msums, gvec, n_elem, g,
                                       lossfun)
            for part, a, w0, tol in zip(("dy", "dbias", "dinv_sigma"), got, want,
                                        (dy_tol, sum_tol, 2e-3)):
                rels.append(_assert_rel(f"readout_bwd_dy {tag} {part}", a, w0, tol))
            errs["readout_bwd_dy"][dname] = max(errs["readout_bwd_dy"][dname],
                                                _err(got[0], want[0]))
            torch.cuda.synchronize()
            print(f"fused kernels: {dname} B={b} F={f} C={c} G={g} {lossfun}: y max abs "
                  f"{errs['readout_matmul_stats'][dname]:.3g} (two calls the same bits); "
                  f"rel-L2 stats, loss sums, "
                  f"msums, dscale, dnorm_bias, dy, dbias, dinv = "
                  + ", ".join(f"{r:.2g}" for r in rels) + " -> ok")
            del k, y0, got, want, chain
            torch.cuda.empty_cache()
    return errs


@contextlib.contextmanager
def plain_readout(rc):
    """Route the fused readout's kernels through their plain versions, on the card."""
    real = {name: getattr(rc, name) for name in (*READOUT_REPLACES, "readout_bwd_fused")}
    rc.readout_matmul_stats = rc.matmul_stats_reference
    rc.readout_loss = rc.loss_reference
    rc.readout_bwd_stats = rc.bwd_stats_reference
    rc.readout_bwd_dy = rc.bwd_dy_reference
    rc.readout_bwd_fused = rc.bwd_fused_reference
    try:
        yield
    finally:
        for name, fn in real.items():
            setattr(rc, name, fn)


@contextlib.contextmanager
def capturing_sigma_grads(vt, sink: dict):
    """Record the inv_sigma gradients a step hands to the rank-1 update."""
    real = vt.add_sigma_rank1_grads

    def capture(grads, g_inv, factors):
        sink.update({k: v.clone() for k, v in g_inv.items() if v is not None})
        return real(grads, g_inv, factors)

    vt.add_sigma_rank1_grads = capture
    try:
        yield
    finally:
        vt.add_sigma_rank1_grads = real


def compare_routes(trainer, state, batch, beta, rc, vt, label, loss_tol, grad_tol):
    """One loss-and-grads three ways from the same state, batch and noise: the
    fused route through its kernels, through its plain versions, and the
    unfused route. The readout's inv_sigma gradient is compared too."""
    readout = "decoder.recon.kernel"
    out = {}
    for route in ("fused kernels", "fused plain", "unfused"):
        gen = torch.Generator("cuda").manual_seed(7)
        trainer.fused_readout = route != "unfused"
        sink = {}
        with contextlib.ExitStack() as stack:
            stack.enter_context(capturing_sigma_grads(vt, sink))
            if route == "fused plain":
                stack.enter_context(plain_readout(rc))
            metrics, _, grads = trainer.loss_and_grads(state, batch, beta, generator=gen)
        grads = {k: g.clone() for k, g in grads.items()}
        grads[f"inv_sigma.grad of {readout}"] = sink[readout]
        out[route] = (float(metrics["loss"]), grads)
    trainer.fused_readout = True
    lk, gk = out["fused kernels"]
    result = {"loss_fused_kernels": lk}
    for other in ("fused plain", "unfused"):
        lo, go = out[other]
        loss_rel = abs(lk - lo) / abs(lo)
        rels = {k: _grad_rel(gk[k], go[k]) for k in gk}
        worst = max(rels, key=rels.get)
        ok = loss_rel <= loss_tol and (grad_tol is None or rels[worst] <= grad_tol)
        print(f"fused: kernels vs {other} step, {label}: loss {lk:.6g} vs {lo:.6g} (rel "
              f"{loss_rel:.3g}), worst gradient rel-L2 {rels[worst]:.3g} ({worst}), "
              f"inv_sigma.grad rel {rels[f'inv_sigma.grad of {readout}']:.3g} -> "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"fused kernels and the {other} route disagree ({label})")
        result[other.replace(" ", "_")] = dict(loss=lo, loss_rel=loss_rel, worst_grad=worst,
                                               worst_grad_rel_l2=rels[worst])
    return result


def readout_kernel_timings(rc, gg, reps, gen, card) -> dict:
    """Per fused-readout kernel at the flagship bf16 shape: kernel, plain and
    library ms and the bound; then the readout segment (h to dy, without the
    dW and dh products both routes share) fused against unfused."""
    from simulgen_vae_tpu_torch.losses import make_recon_loss_pair

    b, t, f, c, g = B, T, READOUT_F, READOUT_C, READOUT_G
    k = _readout_case(b, t, f, c, torch.bfloat16, gen)
    elems, n_elem, mb = b * t * c, float(b * t * c), b * t * c * 2
    chain = (k["x"], k["scale"], k["nb"])
    gvec = torch.tensor([1.0, 0.3, 0.8], device="cuda")
    y, stats = rc.readout_matmul_stats(k["h"], k["w"], k["bias"], k["inv"], g)
    msums = rc.readout_bwd_stats(y, *chain, stats, gvec, n_elem, g)[0]
    b16 = k["bias"].to(torch.bfloat16)
    few = max(reps // 4, 2)
    rows = {}

    def row(name, ms, plain_ms, library_ms, library_call, nbytes, ops, ops_per_s):
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
        rows[name] = dict(
            shape=f"h [{b}, {t}, {f}], W [{c}, {f}], maps [{b}, {t}, {c}] bf16, G={g}",
            ms=ms, plain_ms=plain_ms, library_ms=library_ms, library_call=library_call,
            bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations")
        lib = "none" if library_ms is None else f"{library_ms:.4f}"
        print(f"timing: [{card}] fused readout {name}: {ms:.4f} ms (plain {plain_ms:.4f}, "
              f"library {lib}, bound {rows[name]['bound_ms']:.4f} by {rows[name]['bound_by']})")

    def library_matmul_stats():
        yl = F.linear(k["h"], k["w"], b16)
        return torch.var_mean(yl.view(b, t, g, c // g), dim=(1, 3))

    row("readout_matmul_stats",
        cuda_ms(lambda: rc.readout_matmul_stats(k["h"], k["w"], k["bias"], k["inv"], g), reps),
        cuda_ms(lambda: rc.matmul_stats_reference(k["h"], k["w"], k["bias"], k["inv"], g), few),
        cuda_ms(library_matmul_stats, reps), "F.linear + torch.var_mean",
        (b * t * f + c * f) * 2 + mb + 4 * c + 8 * b * g, 2 * b * t * f * c, BF16_OPS_PER_S)
    r = rows["readout_matmul_stats"]
    flops = 2 * b * t * f * c
    r.update(product_ms=product_alone_ms(
                 rc, lambda: rc.readout_matmul_stats(k["h"], k["w"], k["bias"], k["inv"], g),
                 reps),
             linear_ms=cuda_ms(lambda: F.linear(k["h"], k["w"], b16), reps))
    print(f"timing: [{card}] fused readout readout_matmul_stats (wgmma + TMA): {r['ms']:.4f} ms "
          f"({flops / r['ms'] / 1e9:.1f} TFLOP/s; the constant for the mma.sync design: "
          f"{EARLIER_MS['readout_matmul_stats']:.3f} ms); the product alone {r['product_ms']:.4f} ms "
          f"({flops / r['product_ms'] / 1e9:.1f} TFLOP/s), epilogue share "
          f"{1.0 - r['product_ms'] / r['ms']:.3f}; F.linear {r['linear_ms']:.4f} ms; below "
          f"F.linear + torch.var_mean: {r['ms'] < r['library_ms']}")
    none = "none: no single PyTorch call computes it (see the segment times)"
    row("readout_loss", cuda_ms(lambda: rc.readout_loss(y, *chain, stats, g), reps),
        cuda_ms(lambda: rc.loss_reference(y, *chain, stats, g), few), None, none,
        2 * mb + 8 * c + 8 * b * g, elems * (NORM_OPS + ACT_OPS["tanh"] + LOSS_OPS),
        F32_OPS_PER_S)
    row("readout_bwd_stats",
        cuda_ms(lambda: rc.readout_bwd_stats(y, *chain, stats, gvec, n_elem, g), reps),
        cuda_ms(lambda: rc.bwd_stats_reference(y, *chain, stats, gvec, n_elem, g), few),
        None, none, 2 * mb + 8 * c + 8 * b * c + 16 * b * g,
        elems * (NORM_OPS + ACT_OPS["tanh"] + LOSS_GRAD_OPS + 4), F32_OPS_PER_S)
    row("readout_bwd_dy",
        cuda_ms(lambda: rc.readout_bwd_dy(y, *chain, k["bias"], stats, msums, gvec, n_elem, g),
                reps),
        cuda_ms(lambda: rc.bwd_dy_reference(y, *chain, k["bias"], stats, msums, gvec, n_elem,
                                            g), few),
        None, none, 3 * mb + 12 * c + 4 * b * c + 16 * b * g,
        elems * (NORM_OPS + ACT_OPS["tanh"] + LOSS_GRAD_OPS + BWD_DX_OPS + 4), F32_OPS_PER_S)

    pair = make_recon_loss_pair("MSE")

    def unfused_segment():
        yl = F.linear(k["h"], k["w"], b16).requires_grad_()
        o = gg.group_norm_act(yl, k["scale"], k["nb"], g, act="tanh")
        loss, mse = pair(o, k["x"])
        (loss + 0.3 * mse).backward()
        return yl.grad

    def fused_segment():
        y_, st = rc.readout_matmul_stats(k["h"], k["w"], k["bias"], k["inv"], g)
        rc.readout_loss(y_, *chain, st, g)
        ms_ = rc.readout_bwd_stats(y_, *chain, st, gvec, n_elem, g)[0]
        return rc.readout_bwd_dy(y_, *chain, k["bias"], st, ms_, gvec, n_elem, g)[0]

    seg = dict(unfused_ms=cuda_ms(unfused_segment, few), fused_ms=cuda_ms(fused_segment, few),
               fused_ms_again=cuda_ms(fused_segment, few),
               unfused_ms_again=cuda_ms(unfused_segment, few))
    print(f"timing: [{card}] readout segment h -> dy (product, GroupNorm + tanh, loss pair and "
          f"their backward; dW and dh excluded): unfused (F.linear, gn_stats, gn_apply, loss "
          f"pair, gn_bwd_stats, gn_bwd_apply) {seg['unfused_ms']:.3f} / "
          f"{seg['unfused_ms_again']:.3f} ms, fused (four kernels) {seg['fused_ms']:.3f} / "
          f"{seg['fused_ms_again']:.3f} ms")
    return rows, seg


def profile_step(trainer, state, data, step_p50, name, label, steps=1, count_mm=None):
    """torch.profiler over an epoch of ``steps`` train steps: device busy time
    per step, idle share against the step's p50, and the table of device time
    by kernel. With ``count_mm`` the third value returned is the number of
    library matrix products with a dimension of that size (else None)."""
    prof, (state, _) = traced(lambda: trainer.train_epoch(state, data, max_steps=steps),
                              record_shapes=count_mm is not None)
    events = prof.key_averages()
    busy_ms = sum(e.self_device_time_total for e in kernel_rows(prof)) / 1e3 / steps
    table = events.table(sort_by="self_device_time_total", row_limit=40)
    (OUT_DIR / name).write_text(table)
    print(f"profile: {label} device busy {busy_ms:.3f} ms per step over {steps} against the "
          f"{step_p50:.3f} ms p50 (idle share {1 - busy_ms / step_p50:.3f}); device time by "
          f"kernel in chiprun_out/{name}")
    print("\n".join(table.splitlines()[:24]))
    if count_mm is None:
        return state, busy_ms
    wide = sum(e.count for e in prof.key_averages(group_by_input_shape=True)
               if e.key in ("aten::mm", "aten::addmm", "aten::bmm")
               and any(count_mm in shape for shape in e.input_shapes))
    return state, busy_ms, wide


def phase_fused(args, card, blocks, gg, ga, rc, gen, ctx):
    """Phase 6: the fused-readout train path. Returns (per-kernel dicts, result dict)."""
    from simulgen_vae_tpu_torch.train import vae_trainer as vt

    cfg, data, data32 = ctx["cfg"], ctx["data"], ctx["data32"]
    errs = check_readout_kernels(rc, gen)

    trainer = vt.VAETrainer(cfg, device="cuda", seed=args.seed, fused_readout=True)
    state = trainer.init_state(args.seed)
    for _ in range(2):  # warm-up
        state, m = trainer.train_epoch(state, data, max_steps=1)
    torch.cuda.synchronize()

    # the main path: one epoch through train_epoch, counters from 0
    for mod in (gg, ga, rc):
        mod.reset_launch_counts()
    calls = []
    t0 = time.perf_counter()
    with recording_calls(blocks, calls):
        state, m = trainer.train_epoch(state, data)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    steps = -(-TRAIN_SAMPLES // B)
    launches = {**gg.LAUNCHES, **ga.LAUNCHES, **rc.LAUNCHES}
    metrics = {key: float(m[key]) for key in ("loss", "recon", "kl", "recon_mse", "grad_norm")}
    if not all(np.isfinite(list(metrics.values()))):
        raise AssertionError(f"non-finite fused train metrics: {metrics}")
    # bwd="auto" runs the flavor bwd_flavor answers at the flagship shape: its
    # backward kernel once a step, the other's never
    flavor = rc.bwd_flavor(B, T, READOUT_F, READOUT_C)
    skipped = "readout_bwd_dy" if flavor == "fused" else "readout_bwd_fused"
    once = [n for n in (*READOUT_REPLACES, "readout_bwd_fused", "gather_augment") if n != skipped]
    if not all(launches[name] == steps for name in once):
        raise AssertionError(f"fused path: not one launch per step in {steps} steps: {launches}")
    if not all(n > 0 for name, n in launches.items() if name != skipped):
        raise AssertionError(f"a kernel did not run on the fused train path: {launches}")
    if launches[skipped]:
        raise AssertionError(f"bwd='auto' answers {flavor!r} at the flagship shape, yet "
                             f"{skipped} ran: {launches}")
    widths = sorted({c for c, _, _ in calls})
    if READOUT_C in widths:
        raise AssertionError(f"a GroupNorm kernel ran at C = {READOUT_C} on the fused path")
    print(f"fused: 1 epoch = {steps} steps in {run_s:.3f} s; {metrics}; launches {launches} "
          f"(bwd='auto': {flavor}); {len(calls) // steps} GroupNorms per step at C = {widths} "
          f"(none at {READOUT_C})")

    # fused against unfused step time, in turns on this card
    def timed(tr, st, n):
        lat = []
        for _ in range(n):
            t1 = time.perf_counter()
            st, _ = tr.train_epoch(st, data, max_steps=1)
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t1) * 1e3)
        return st, lat

    half = STEP_TIMING // 2
    ustate, u1 = timed(ctx["trainer"], ctx["state"], half)
    state, f1 = timed(trainer, state, half)
    state, f2 = timed(trainer, state, half)
    ustate, u2 = timed(ctx["trainer"], ustate, half)
    fused_lat, unfused_lat = np.asarray(f1 + f2), np.asarray(u1 + u2)
    fused_p50, unfused_p50 = (float(np.percentile(v, 50)) for v in (fused_lat, unfused_lat))
    print(f"timing: [{card}] train step (batch {B}, bf16), {half} unfused, {2 * half} fused, "
          f"{half} unfused: fused p50 {fused_p50:.3f} ms (min/max {fused_lat.min():.3f}/"
          f"{fused_lat.max():.3f}; {B / fused_p50 * 1e3:.1f} samples/s), unfused p50 "
          f"{unfused_p50:.3f} ms (min/max {unfused_lat.min():.3f}/{unfused_lat.max():.3f}; "
          f"{B / unfused_p50 * 1e3:.1f} samples/s); peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB")

    # one step three ways from one state, batch and noise
    beta = 0.5
    zero, ones = torch.zeros(B, device="cuda"), torch.ones(B, device="cuda")
    rows = torch.arange(B, device="cuda", dtype=torch.int32)
    lam = torch.linspace(0.3, 1.0, B, device="cuda")
    batch = ga.gather_augment(data, rows, rows.flip(0).contiguous(), 5, lam, ones, zero)
    checks = {"bfloat16": compare_routes(trainer, state, batch, beta, rc, vt, "bf16",
                                         1e-2, None)}
    del batch
    trainer32 = vt.VAETrainer(dataclasses.replace(cfg, dtype="float32"), device="cuda",
                              seed=args.seed, fused_readout=True)
    model32 = trainer32.build_model()
    model32.load_state_dict(state.model.state_dict())
    state32 = dataclasses.replace(state, model=model32, opt_state=None)
    batch32 = ga.gather_augment(data32, rows, rows.flip(0).contiguous(), 5, lam, ones, zero)
    checks["float32"] = compare_routes(trainer32, state32, batch32, beta, rc, vt,
                                       "f32, TF32 off", 1e-4, 1e-3)
    del trainer32, model32, state32, batch32
    torch.cuda.empty_cache()

    per_kernel, segment = readout_kernel_timings(rc, gg, args.reps, gen, card)

    busy_ms = None
    if args.profile:
        state, busy_ms = profile_step(trainer, state, data, fused_p50,
                                      "chip_smoke_train_fused_profile.txt", "fused train step")

    kernels = [dict(
        name=name, route="cuda", source=f"simulgen_vae_tpu_torch/ops/csrc/{name}.cu",
        replaces=READOUT_REPLACES[name], launches=launches[name],
        launches_per_step=launches[name] / steps, max_abs_err=errs[name]["bfloat16"],
        max_abs_err_f32=errs[name]["float32"], card=card, **per_kernel[name],
        unfused_segment_ms=segment["unfused_ms"], fused_segment_ms=segment["fused_ms"])
        for name in READOUT_REPLACES]
    result = dict(step_p50_ms=fused_p50, step_ms=fused_lat.tolist(), bwd_flavor=flavor,
                  samples_per_s=B / fused_p50 * 1e3, unfused_step_p50_ms=unfused_p50,
                  unfused_step_ms=unfused_lat.tolist(), steps=steps, metrics=metrics,
                  launches=launches, groupnorm_widths=widths, step_checks=checks,
                  segment=segment, device_busy_ms=busy_ms,
                  peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    return kernels, result


# -- 7. the benched train stack -------------------------------------------------

# (B, T, F, C, G, loss): the flagship readout, the three shapes with F = 128 that
# the JAX rule's neighbourhood covers, and two ragged ones (C = 300 and 1100 put
# bf16 rows off 16-byte boundaries; 74 and 150 rows are no multiple of a tile).
BWD_FUSED_SHAPES = [(2, 37, 64, 300, 6, "Huber"), (3, 50, 64, 1100, 4, "MAE"),
                    (4, T, 128, 5120, 8, "MSE"), (B, T, 128, 5120, 8, "MSE"),
                    (B, T, 128, READOUT_C, 8, "MSE"),
                    (B, T, READOUT_F, READOUT_C, READOUT_G, "MSE")]
# (B, T, F, C, G, loss): the bf16 kernel's other cluster sizes (2, 3 and 8
# ranks; 5 ranks in two clusters along F at F = 2304) and cp.async for ragged
# rows at F tiles of 256 (C = 300, 1100, 700), held to its plain version only.
BWD_FUSED_CLUSTER_SHAPES = [(2, 37, 192, 300, 6, "Huber"), (3, 50, 512, 1100, 4, "MAE"),
                            (2, 64, 512, 5120, 8, "MSE"), (4, 200, 768, 5120, 8, "MSE"),
                            (2, 40, 2048, 1100, 4, "Huber"), (2, 24, 2304, 700, 4, "MSE")]
ADAMW_MODES = {"float32": dict(), "bfloat16_rtn": dict(moment_dtype="bfloat16"),
               "bfloat16": dict(moment_dtype="bfloat16", stochastic_round=True)}
ADAMW_OPS = 16   # per element: two moment updates, bias corrections, root, quotient, decay


def _bwd_inputs(rc, k, g, lossfun, gvec):
    """y, stats and msums of a readout case, through the forward kernels;
    readout_matmul_stats is held against its plain version on the way."""
    b, t, c = k["x"].shape
    f = k["h"].shape[2]
    (y, stats), _, y_err, stats_rel = check_matmul_stats(
        rc, k, g, f"B={b} T={t} F={f} C={c} {str(k['h'].dtype).split('.')[1]}")
    print(f"stack kernels: readout_matmul_stats B={b} T={t} F={f} C={c} G={g}: y max abs "
          f"{y_err:.3g}, stats rel-L2 {stats_rel:.2g}; two calls the same bits")
    msums = rc.readout_bwd_stats(y, k["x"], k["scale"], k["nb"], stats, gvec, float(b * t * c),
                                 g, lossfun)[0]
    return y, stats, msums


def backward_segments(rc, k, y, stats, gvec, n_elem, g, lossfun):
    """The readout backward's two segments on one case, as calls: dy-free
    (readout_bwd_stats + readout_bwd_fused) and materializing
    (readout_bwd_stats + readout_bwd_dy + two torch.matmul)."""
    b, t, c = y.shape
    f = k["h"].shape[2]
    chain = (k["x"], k["scale"], k["nb"])

    def fused():
        ms_ = rc.readout_bwd_stats(y, *chain, stats, gvec, n_elem, g, lossfun)[0]
        return rc.readout_bwd_fused(y, *chain, k["bias"], k["h"], k["w"], stats, ms_, gvec,
                                    n_elem, g, lossfun)

    def materialize():
        ms_ = rc.readout_bwd_stats(y, *chain, stats, gvec, n_elem, g, lossfun)[0]
        dy = rc.readout_bwd_dy(y, *chain, k["bias"], stats, ms_, gvec, n_elem, g,
                               lossfun)[0].reshape(b * t, c)
        return torch.matmul(dy.t(), k["h"].reshape(b * t, f)), torch.matmul(dy, k["w"])

    return fused, materialize


# The bf16 plan of readout_bwd_fused per pass, in the order its library's
# readout_bwd_fused_plan reports it.
PLAN_KEYS = ("tiles", "steps", "slabs", "steps_a_slab", "slice_rows", "units", "clusters",
             "smem", "ring_yx", "ring_op", "ring_dy")


def bwd_fused_plan(rc, b, t, f, c) -> dict:
    """The bf16 plan of readout_bwd_fused at a shape, as its library reports
    it: F tile, ranks a cluster, clusters along F, TMA (or cp.async) for y and
    x, and per pass (dW, dh) the PLAN_KEYS. The first three must be the
    wrapper's bwd_fused_cluster."""
    import ctypes

    fn = rc._fn("readout_bwd_fused", "readout_bwd_fused_plan",
                [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)])
    buf = (ctypes.c_int * (4 + 2 * len(PLAN_KEYS)))()
    err = fn(b, t, f, c, buf)
    if err:
        raise RuntimeError(f"readout_bwd_fused_plan failed with cudaError {err}")
    v, n = list(buf), len(PLAN_KEYS)
    plan = dict(tile_n=v[0], ranks=v[1], fgroups=v[2], tma=bool(v[3]),
                dw=dict(zip(PLAN_KEYS, v[4:4 + n])), dh=dict(zip(PLAN_KEYS, v[4 + n:])))
    if (plan["tile_n"], plan["ranks"], plan["fgroups"]) != rc.bwd_fused_cluster(f):
        raise AssertionError(f"readout_bwd_fused plans {plan}, the wrapper "
                             f"{rc.bwd_fused_cluster(f)} at F = {f}")
    return plan


def bwd_fused_launch(rc, call, plan) -> dict:
    """One call of readout_bwd_fused as a profiler trace records it: its two
    passes (fused_bf16_kernel, dW then dh) launched through
    cudaLaunchKernelExC (the launch that takes a cluster dimension) with the
    plan's grid (clusters x ranks blocks) of 384 threads, then the launches
    that add slabs and partials. The trace records no cluster size; the
    kernel finds its F tile from its rank, so its agreement with its plain
    version stands for it."""
    call()
    torch.cuda.synchronize()
    prof, _ = traced(call, expect="fused_bf16_kernel")
    trace = OUT_DIR / "readout_bwd_fused_trace.json"
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text())["traceEvents"]
    launched = sorted((e for e in events
                       if e.get("cat") == "kernel" and WARM_KERNEL not in e.get("name", "")),
                      key=lambda e: float(e["ts"]))
    rows = []
    for e in launched:
        a = e.get("args", {})
        api = [r["name"] for r in events if r.get("cat") == "cuda_runtime"
               and r.get("args", {}).get("correlation") == a.get("correlation")]
        rows.append(dict(name=e["name"][:80], grid=a.get("grid"), block=a.get("block"), api=api,
                         us=float(e.get("dur", 0.0))))
    passes = [r for r in rows if "fused_bf16_kernel" in r["name"]]
    want = [plan[k]["clusters"] * plan["ranks"] for k in ("dw", "dh")]
    ok = (len(passes) == 2 and [(r["grid"] or [0])[0] for r in passes] == want
          and all((r["block"] or [0])[0] == 384 for r in passes)
          and all(any("LaunchKernelExC" in n for n in r["api"]) for r in passes))
    print(f"stack kernels: readout_bwd_fused launch (profiler trace, B={B} F={READOUT_F} "
          f"C={READOUT_C}): {len(rows)} kernels a call: "
          + "; ".join(f"{r['name'][:48]} grid {r['grid']} block {r['block']} via {r['api']} "
                      f"{r['us']:.0f} us" for r in rows)
          + f"; plan: clusters of {plan['ranks']}, {want} blocks -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"readout_bwd_fused launches {rows}: wanted two cluster launches "
                             f"of {want} blocks of 384 threads")
    return dict(kernels=rows, plan=plan)


def check_bwd_fused(rc, gen, reps, card):
    """#11 against its plain version in f32 (TF32 off) and bf16 at every shape,
    two runs bit for bit, and (bf16) the backward segment with it against the
    materializing one, device only from replayed CUDA graphs, timed in turns
    (the table behind bwd_flavor), and the kernel alone also back to back;
    at the flagship shape a profiler trace of one call (bwd_fused_launch);
    then, agreement only, BWD_FUSED_CLUSTER_SHAPES. Returns (max abs errors,
    segment rows, the trace)."""
    errs, segments, launch = {"float32": 0.0, "bfloat16": 0.0}, [], None
    gvec = torch.tensor([1.7, 0.3, 0.8], device="cuda")   # (gl, gm, inv_sigma)
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        prod_tol, sum_tol = (1e-5, 1e-4) if dtype == torch.float32 else (1e-2, 1e-3)
        for b, t, f, c, g, lossfun in BWD_FUSED_SHAPES:
            k = _readout_case(b, t, f, c, dtype, gen)
            n_elem = float(b * t * c)
            y, stats, msums = _bwd_inputs(rc, k, g, lossfun, gvec)
            args = (y, k["x"], k["scale"], k["nb"], k["bias"], k["h"], k["w"], stats, msums,
                    gvec, n_elem, g, lossfun)
            got = rc.readout_bwd_fused(*args)
            again = rc.readout_bwd_fused(*args)
            want = rc.bwd_fused_reference(*args)
            torch.cuda.synchronize()
            if not all(torch.equal(a, a2) for a, a2 in zip(got, again)):
                raise AssertionError(f"readout_bwd_fused C={c} {dname}: two runs differ")
            rels = [_assert_rel(f"readout_bwd_fused C={c} F={f} {dname} {part}", a, w0, tol)
                    for part, a, w0, tol in zip(("dW", "dh", "dbias", "dinv_sigma"), got, want,
                                                (prod_tol, prod_tol, sum_tol, 2e-3))]
            errs[dname] = max(errs[dname], _err(got[0], want[0]), _err(got[1], want[1]))
            line = (f"stack kernels: readout_bwd_fused {dname} B={b} T={t} F={f} C={c} G={g} "
                    f"{lossfun}: rel-L2 dW, dh, dbias, dinv = "
                    + ", ".join(f"{r:.2g}" for r in rels) + "; two runs equal")
            if dtype == torch.bfloat16:
                plan = bwd_fused_plan(rc, b, t, f, c)
                if (f, c) == (READOUT_F, READOUT_C):
                    launch = bwd_fused_launch(rc, lambda: rc.readout_bwd_fused(*args), plan)
                fused, materialize = backward_segments(rc, k, y, stats, gvec, n_elem, g, lossfun)
                few = max(reps // 4, 3)
                # device only, from replayed CUDA graphs, in turns
                row = dict(B=b, T=t, F=f, C=c, G=g, plan=plan, rule=rc.bwd_flavor(b, t, f, c),
                           materialize_device_ms=graph_ms(materialize, few),
                           fused_device_ms=graph_ms(fused, few),
                           kernel_device_ms=graph_ms(lambda: rc.readout_bwd_fused(*args), few),
                           fused_device_ms_again=graph_ms(fused, few),
                           materialize_device_ms_again=graph_ms(materialize, few),
                           kernel_ms=cuda_ms(lambda: rc.readout_bwd_fused(*args), few))
                row["measured"] = ("fused" if row["fused_device_ms"] + row["fused_device_ms_again"]
                                   <= row["materialize_device_ms"]
                                   + row["materialize_device_ms_again"] else "materialize")
                segments.append(row)
                line += (f"; [{card}] backward segment, device only: dy-free "
                         f"{row['fused_device_ms']:.3f} / {row['fused_device_ms_again']:.3f} ms "
                         f"(kernel alone {row['kernel_device_ms']:.3f}; back to back "
                         f"{row['kernel_ms']:.3f}) against materializing "
                         f"{row['materialize_device_ms']:.3f} / "
                         f"{row['materialize_device_ms_again']:.3f} ms -> {row['measured']} "
                         f"(bwd_flavor: {row['rule']})")
            print(line)
            del k, y, got, again, want, args
            torch.cuda.empty_cache()
    for b, t, f, c, g, lossfun in BWD_FUSED_CLUSTER_SHAPES:  # bf16, agreement only
        k = _readout_case(b, t, f, c, torch.bfloat16, gen)
        n_elem = float(b * t * c)
        y, stats, msums = _bwd_inputs(rc, k, g, lossfun, gvec)
        args = (y, k["x"], k["scale"], k["nb"], k["bias"], k["h"], k["w"], stats, msums, gvec,
                n_elem, g, lossfun)
        got, again = rc.readout_bwd_fused(*args), rc.readout_bwd_fused(*args)
        want = rc.bwd_fused_reference(*args)
        if not all(torch.equal(a, a2) for a, a2 in zip(got, again)):
            raise AssertionError(f"readout_bwd_fused F={f} C={c} bfloat16: two runs differ")
        rels = [_assert_rel(f"readout_bwd_fused C={c} F={f} bfloat16 {part}", a, w0, tol)
                for part, a, w0, tol in zip(("dW", "dh", "dbias", "dinv_sigma"), got, want,
                                            (1e-2, 1e-2, 1e-3, 2e-3))]
        errs["bfloat16"] = max(errs["bfloat16"], _err(got[0], want[0]), _err(got[1], want[1]))
        plan = bwd_fused_plan(rc, b, t, f, c)
        print(f"stack kernels: readout_bwd_fused bfloat16 B={b} T={t} F={f} C={c} G={g} "
              f"{lossfun} (clusters of {plan['ranks']} x {plan['fgroups']} along F, "
              f"{'TMA' if plan['tma'] else 'cp.async'} for y and x): rel-L2 dW, dh, dbias, dinv = "
              + ", ".join(f"{r:.2g}" for r in rels) + "; two runs equal")
        del k, y, got, again, want, args
        torch.cuda.empty_cache()
    return errs, segments, launch


def _adamw_case(opt, shapes, gen):
    params = {f"p{i}": 0.1 * torch.randn(s, generator=gen, device="cuda")
              for i, s in enumerate(shapes)}
    state = opt.init(params)
    for name in params:
        state["mu"][name].copy_(0.01 * torch.randn(params[name].shape, generator=gen,
                                                   device="cuda"))
        state["nu"][name].copy_(1e-4 * torch.randn(params[name].shape, generator=gen,
                                                   device="cuda") ** 2)
    state["count"] = 3
    grads = {name: 0.05 * torch.randn(p.shape, generator=gen, device="cuda")
             for name, p in params.items()}
    return params, state, grads


def _clone_adamw(params, state):
    return ({k: v.clone() for k, v in params.items()},
            {"count": state["count"], "mu": {k: v.clone() for k, v in state["mu"].items()},
             "nu": {k: v.clone() for k, v in state["nu"].items()}})


def check_fused_adamw(FusedAdamW, gen) -> dict:
    """The AdamW kernel against the plain sweeps from the same state, three
    moment modes: parameters rel-L2 1e-6 (a quotient by a scalar may be a
    product with its inverse in the plain sweeps), moments the same bits (the
    kernel keeps the plain version's roundings, the dither included), the
    gradient norm rtol 1e-6. Returns the max abs error of the parameters."""
    shapes = [(READOUT_C, READOUT_F), (1024, 512, 5), (1001,), (), (READOUT_C,), (7, 3)]
    errs = {}
    for mode, kw in ADAMW_MODES.items():
        opt = FusedAdamW(**kw)
        params, state, grads = _adamw_case(opt, shapes, gen)
        p2, s2 = _clone_adamw(params, state)
        norm = opt.apply(grads, state, params, 1e-3)
        norm2 = opt.apply_reference(grads, s2, p2, 1e-3)
        torch.cuda.synchronize()
        worst = 0.0
        for name in params:
            worst = max(worst, _assert_rel(f"fused_adamw {mode} {name} parameters",
                                           params[name], p2[name], 1e-6))
            for part in ("mu", "nu"):
                if not torch.equal(state[part][name], s2[part][name]):
                    raise AssertionError(f"fused_adamw {mode}: {part}[{name}] "
                                         f"{tuple(params[name].shape)} differs from the plain "
                                         f"version's bits ({_err(state[part][name], s2[part][name]):.3g})")
        rel_norm = abs(float(norm) - float(norm2)) / float(norm2)
        if rel_norm > 1e-6:
            raise AssertionError(f"fused_adamw {mode}: gradient norm {float(norm)} vs {float(norm2)}")
        errs[mode] = max(_err(params[n], p2[n]) for n in params)
        print(f"stack kernels: fused_adamw {mode}: {len(shapes)} leaves "
              f"({', '.join(str(tuple(s)) for s in shapes)}): parameters rel-L2 <= {worst:.2g}, "
              f"moments bit-equal ({state['mu']['p0'].dtype}), gradient norm rel {rel_norm:.2g}")
        del params, state, grads, p2, s2
        torch.cuda.empty_cache()
    return errs


def time_fused_adamw(FusedAdamW, fa, model, reps, card) -> dict:
    """The sweep over the model's parameters in the three moment modes beside
    the plain sweeps, torch's fused AdamW (f32 moments only) and the byte bound."""
    names = [k for k, _ in model.named_parameters()]
    shapes = [tuple(p.shape) for p in model.parameters()]
    n = sum(p.numel() for p in model.parameters())
    rows = {}
    for mode, kw in ADAMW_MODES.items():
        opt = FusedAdamW(**kw)
        params = {k: torch.zeros(s, device="cuda") for k, s in zip(names, shapes)}
        state = opt.init(params)
        grads = {k: torch.full_like(p, 1e-3) for k, p in params.items()}
        fa.reset_launch_counts()
        opt.apply(grads, state, params, 1e-3)
        launches = fa.LAUNCHES["fused_adamw"]
        ms = cuda_ms(lambda: opt.apply(grads, state, params, 1e-3), reps)
        plain = cuda_ms(lambda: opt.apply_reference(grads, state, params, 1e-3), 2, warmup=1)
        library = None
        if mode == "float32":
            leaves = [torch.nn.Parameter(p) for p in params.values()]
            for leaf, g in zip(leaves, grads.values()):
                leaf.grad = g
            lib_opt = torch.optim.AdamW(leaves, lr=1e-3, fused=True)
            library = cuda_ms(lib_opt.step, reps)
            del lib_opt, leaves
        moment_bytes = 4 if mode == "float32" else 2
        nbytes = n * (4 * 3 + moment_bytes * 4)     # p, g read, p written; m, v read and written
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, n * ADAMW_OPS / F32_OPS_PER_S * 1e3
        rows[mode] = dict(params=n, leaves=len(names), launches_per_step=launches, ms=ms,
                          plain_ms=plain, library_ms=library,
                          library_call="torch.optim.AdamW(fused=True).step() (f32 moments only)",
                          bound_ms=max(t_bytes, t_ops),
                          bound_by="bytes" if t_bytes >= t_ops else "operations")
        lib = "none" if library is None else f"{library:.3f}"
        print(f"timing: [{card}] fused_adamw {mode}: {n / 1e6:.1f}M parameters in {len(names)} "
              f"leaves, {launches} sweep launches per step: {ms:.3f} ms (plain sweeps "
              f"{plain:.3f}, torch fused AdamW {lib}, bound {rows[mode]['bound_ms']:.3f} by "
              f"{rows[mode]['bound_by']})")
        del params, state, grads
        torch.cuda.empty_cache()
    return rows


@contextlib.contextmanager
def counting_power_iterations(vt, sink: list):
    real = vt.compute_sigmas

    def counted(*a, **k):
        sink.append(k.get("update", True))
        return real(*a, **k)

    vt.compute_sigmas = counted
    try:
        yield
    finally:
        vt.compute_sigmas = real


def _states_equal(a, b) -> bool:
    pairs = list(zip(a.model.parameters(), b.model.parameters()))
    for part in ("mu", "nu"):
        pairs += [(v, b.opt_state[part][k]) for k, v in a.opt_state[part].items()]
    pairs += [(u, b.sn_u[k]) for k, u in a.sn_u.items()]
    return (a.epoch == b.epoch and a.opt_state["count"] == b.opt_state["count"]
            and all(torch.equal(x, y) for x, y in pairs))


def timed_steps(trainer, state, data, n):
    """``n`` steps of one epoch, each from its batch assembly to a
    synchronise after its optimizer update (ms). The per-epoch power iteration,
    which runs before the first step, is not in any step's time."""
    lat, mark = [], []
    real_batch, real_apply = trainer.assemble_batch, trainer._apply

    def batch(*a, **k):
        torch.cuda.synchronize()
        mark.append(time.perf_counter())
        return real_batch(*a, **k)

    def apply(*a, **k):
        out = real_apply(*a, **k)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - mark[-1]) * 1e3)
        return out

    trainer.assemble_batch, trainer._apply = batch, apply
    try:
        state, _ = trainer.train_epoch(state, data, max_steps=n)
    finally:
        trainer.assemble_batch, trainer._apply = real_batch, real_apply
    return state, lat


def compare_backwards(trainer, state, batch, beta, rc, label, loss_tol, grad_tol):
    """One loss-and-grads from the same state, batch and noise with the dy-free
    backward through its kernel, through its plain version, and with the
    materializing backward."""
    out = {}
    for route in ("dy-free kernel", "dy-free plain", "materializing"):
        gen = torch.Generator("cuda").manual_seed(7)
        trainer.readout_bwd = "materialize" if route == "materializing" else "fused"
        ctx = plain_readout(rc) if route == "dy-free plain" else contextlib.nullcontext()
        with ctx:
            metrics, _, grads = trainer.loss_and_grads(state, batch, beta, generator=gen)
        out[route] = (float(metrics["loss"]), {k: g.clone() for k, g in grads.items()})
    trainer.readout_bwd = "fused"
    lk, gk = out["dy-free kernel"]
    result = {"loss_dy_free_kernel": lk}
    for other in ("dy-free plain", "materializing"):
        lo, go = out[other]
        loss_rel = abs(lk - lo) / abs(lo)
        rels = {k: _grad_rel(gk[k], go[k]) for k in gk}
        worst = max(rels, key=rels.get)
        ok = loss_rel <= loss_tol and (grad_tol is None or rels[worst] <= grad_tol)
        print(f"stack: dy-free kernel vs {other} step, {label}: loss {lk:.6g} vs {lo:.6g} (rel "
              f"{loss_rel:.3g}), worst gradient rel-L2 {rels[worst]:.3g} ({worst}) -> "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"the dy-free kernel and the {other} route disagree ({label})")
        result[other.replace(" ", "_").replace("-", "_")] = dict(
            loss=lo, loss_rel=loss_rel, worst_grad=worst, worst_grad_rel_l2=rels[worst])
    return result, gk


def phase_stack(args, card, gg, ga, rc, gen, cfg, data, data32):
    """Phase 7: the benched train stack. Returns (per-kernel dicts, result dict)."""
    import tempfile

    from simulgen_vae_tpu_torch.ops import fused_adamw as fa
    from simulgen_vae_tpu_torch.train import vae_trainer as vt
    from simulgen_vae_tpu_torch.train.optim import FusedAdamW
    from simulgen_vae_tpu_torch.utils.checkpoint import CheckpointManager

    # kernels against their plain versions
    bwd_errs, segments, bwd_launch = check_bwd_fused(rc, gen, args.reps, card)
    adamw_errs = check_fused_adamw(FusedAdamW, gen)

    stack_cfg = dataclasses.replace(cfg, opt_state_dtype="bfloat16", sn_cadence="epoch")

    def trainer_of(config, **kw):
        return vt.VAETrainer(config, device="cuda", seed=args.seed, fused_readout=True, **kw)

    # the main path: two warm-up steps, then one epoch through train_epoch, counters from 0
    trainer = trainer_of(stack_cfg, readout_bwd="fused")
    state = trainer.init_state(args.seed)
    n_leaves = sum(1 for _ in state.model.parameters())
    for _ in range(2):
        state, _ = trainer.train_epoch(state, data, max_steps=1)
    torch.cuda.synchronize()
    for mod in (gg, ga, rc, fa):
        mod.reset_launch_counts()
    iterations = []
    t0 = time.perf_counter()
    with counting_power_iterations(vt, iterations):
        state, m = trainer.train_epoch(state, data)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    steps = -(-TRAIN_SAMPLES // B)
    launches = {**gg.LAUNCHES, **ga.LAUNCHES, **rc.LAUNCHES, **fa.LAUNCHES}
    metrics = {key: float(m[key]) for key in ("loss", "recon", "kl", "recon_mse", "grad_norm")}
    sweeps = fa.launches_per_step(n_leaves)
    once = ("readout_matmul_stats", "readout_loss", "readout_bwd_stats", "readout_bwd_fused",
            "gather_augment")
    if not all(np.isfinite(list(metrics.values()))):
        raise AssertionError(f"non-finite metrics on the stack: {metrics}")
    if not all(launches[name] == steps for name in once) or launches["readout_bwd_dy"]:
        raise AssertionError(f"stack path: not one launch per step in {steps} steps, or the "
                             f"materializing backward ran: {launches}")
    idle = [name for name, n in launches.items() if n == 0 and name != "readout_bwd_dy"]
    if idle:
        raise AssertionError(f"kernels that did not run on the stack path: {idle}")
    if launches["fused_adamw"] != sweeps * steps:
        raise AssertionError(f"fused_adamw launched {launches['fused_adamw']} times, expected "
                             f"{sweeps} x {steps}")
    if iterations != [True]:
        raise AssertionError(f"power iterations in one epoch: {iterations}")
    if not all(v.dtype == torch.bfloat16 for v in state.opt_state["mu"].values()):
        raise AssertionError("the stack's moments are not bf16")
    print(f"stack: 1 epoch = {steps} steps in {run_s:.3f} s; {metrics}; launches {launches}; "
          f"{sweeps} AdamW sweeps per step over {n_leaves} leaves; 1 power iteration in the epoch")

    # one step from one state, batch and noise: the backward three ways, AdamW two ways
    beta = 0.5
    zero, ones = torch.zeros(B, device="cuda"), torch.ones(B, device="cuda")
    rows = torch.arange(B, device="cuda", dtype=torch.int32)
    lam = torch.linspace(0.3, 1.0, B, device="cuda")
    batch = ga.gather_augment(data, rows, rows.flip(0).contiguous(), 5, lam, ones, zero)
    checks = {}
    checks["bfloat16"], grads = compare_backwards(trainer, state, batch, beta, rc, "bf16",
                                                  1e-2, None)
    del batch
    live = {k: p.data for k, p in state.model.named_parameters()}
    (p1, s1), (p2, s2) = _clone_adamw(live, state.opt_state), _clone_adamw(live, state.opt_state)
    trainer.opt.apply(grads, s1, p1, 1e-3)
    trainer.opt.apply_reference(grads, s2, p2, 1e-3)
    worst = max(_assert_rel(f"AdamW step {k}", p1[k], p2[k], 1e-6) for k in live)
    moments_equal = all(torch.equal(s1[part][k], s2[part][k])
                        for part in ("mu", "nu") for k in live)
    print(f"stack: kernel AdamW vs plain AdamW after one step from the trained state (bf16 "
          f"moments, stochastic rounding): parameters rel-L2 <= {worst:.2g}, moments "
          f"bit-equal: {moments_equal}")
    if not moments_equal:
        raise AssertionError("kernel and plain AdamW store different moments")
    checks["adamw_step"] = dict(params_rel_l2=worst, moments_bit_equal=moments_equal)
    del grads, p1, s1, p2, s2, live
    trainer32 = trainer_of(dataclasses.replace(stack_cfg, dtype="float32"), readout_bwd="fused")
    model32 = trainer32.build_model()
    model32.load_state_dict(state.model.state_dict())
    state32 = dataclasses.replace(state, model=model32, opt_state=None)
    batch32 = ga.gather_augment(data32, rows, rows.flip(0).contiguous(), 5, lam, ones, zero)
    checks["float32"], _ = compare_backwards(trainer32, state32, batch32, beta, rc,
                                             "f32, TF32 off", 1e-4, 1e-3)
    del trainer32, model32, state32, batch32
    torch.cuda.empty_cache()

    # fit with a checkpoint, a restore into a new trainer, one more epoch: bit-equal
    # to the uninterrupted run (32 samples: 2 steps an epoch, no validation split)
    few = data[:2 * B]
    fit_kw = dict(seed=args.seed, val_split=0.0, val_every=50)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as ckpt_dir:
        mgr = CheckpointManager(ckpt_dir, save_interval_epochs=50)
        first = trainer_of(stack_cfg, readout_bwd="fused")
        part, _ = first.fit(few, epochs=3, ckpt_manager=mgr, **fit_kw)
        saved_step = mgr.latest_step()
        del first, part
        second = trainer_of(stack_cfg, readout_bwd="fused")
        restored = mgr.restore(second.init_state(args.seed + 1))
        resumed, hist = second.fit(few, epochs=1, state=restored, **fit_kw)
    whole, hist_whole = trainer_of(stack_cfg, readout_bwd="fused").fit(few, epochs=4, **fit_kw)
    torch.cuda.synchronize()
    resume_ok = _states_equal(resumed, whole) and saved_step == 3
    print(f"stack: fit 3 epochs + checkpoint (epoch {saved_step}) + restore + 1 epoch against 4 "
          f"epochs uninterrupted in {time.perf_counter() - t0:.1f} s: epoch {resumed.epoch}, "
          f"step count {resumed.opt_state['count']}, last loss {hist['loss'][-1]:.6g} vs "
          f"{hist_whole['loss'][-1]:.6g}, states bit-equal: {resume_ok}")
    if not resume_ok:
        raise AssertionError("the restored run differs from the uninterrupted one")
    del resumed, whole, restored, second, mgr
    torch.cuda.empty_cache()

    # one streamed epoch from pinned host memory
    host = data.float().cpu().numpy()
    marks = []
    real_step = trainer.train_step
    trainer.train_step = lambda *a: marks.append(time.perf_counter()) or real_step(*a)
    state, sm = trainer.train_epoch_streaming(state, host, max_steps=1)   # pins the buffers
    torch.cuda.synchronize()
    marks.clear()
    state, sm = trainer.train_epoch_streaming(state, host)
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    trainer.train_step = real_step
    stream_ms = np.diff(marks) * 1e3
    stream_p50 = float(np.percentile(stream_ms, 50))
    if not np.isfinite(float(sm["loss"])) or len(stream_ms) != steps:
        raise AssertionError(f"streamed epoch: loss {float(sm['loss'])}, {len(stream_ms)} steps")
    del host
    print(f"timing: [{card}] streamed epoch ({steps} steps, f32 host rows gathered into pinned "
          f"buffers, partners from the dataset): step p50 {stream_p50:.1f} ms, min/max "
          f"{stream_ms.min():.1f}/{stream_ms.max():.1f} ms, loss {float(sm['loss']):.6g}")

    # times: AdamW over the model's parameters, then four stacks' steps in turns
    adamw_rows = time_fused_adamw(FusedAdamW, fa, state.model, args.reps, card)
    stacks = {
        "A: fused readout, kernel AdamW (f32 moments), SN per step": (cfg, {}),
        "B: A + bf16 moments, stochastic rounding":
            (dataclasses.replace(cfg, opt_state_dtype="bfloat16"), {}),
        "C: B + SN per epoch": (stack_cfg, {}),
        "D: C + dy-free readout backward": (stack_cfg, dict(readout_bwd="fused")),
    }
    runs = {}
    for name, (config, kw) in stacks.items():
        tr = trainer if name.startswith("D") else trainer_of(config, **kw)
        st = state if name.startswith("D") else tr.init_state(args.seed)
        st, _ = timed_steps(tr, st, data, 2)      # warm-up
        runs[name] = [tr, st, []]
    # in turns: A B C D with 3 steps each, then D C B A with 2
    for name, n in [(k, 3) for k in stacks] + [(k, 2) for k in reversed(stacks)]:
        tr, st, lat = runs[name]
        runs[name][1], more = timed_steps(tr, st, data, n)
        lat.extend(more)
    step_p50 = {}
    for name, (_, _, lat) in runs.items():
        step_p50[name] = float(np.percentile(lat, 50))
        print(f"timing: [{card}] stack {name}: step p50 {step_p50[name]:.3f} ms over {len(lat)} "
              f"steps (min/max {min(lat):.3f}/{max(lat):.3f}; "
              f"{B / step_p50[name] * 1e3:.1f} samples/s)")
    busy, wide_mm = {}, {}
    if args.profile:
        for key in ("C", "D"):
            name = next(n for n in runs if n.startswith(key))
            tr, st, _ = runs[name]
            runs[name][1], busy[key], wide_mm[key] = profile_step(
                tr, st, data, step_p50[name], f"chip_smoke_stack_{key.lower()}_profile.txt",
                f"stack {key}", steps=2, count_mm=READOUT_C)
        # the encoder's embedding keeps its products at this width; the readout's dW
        # and dh, two a step, are library products only with the materializing backward
        print(f"profile: library matrix products with a dimension of {READOUT_C} in 2 steps: "
              f"stack C {wide_mm['C']}, stack D {wide_mm['D']}")
        if wide_mm["C"] - wide_mm["D"] != 4:
            raise AssertionError("the dy-free backward did not remove the readout's two "
                                 f"library products per step: {wide_mm}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del runs
    torch.cuda.empty_cache()

    flagship = next(r for r in segments if r["F"] == READOUT_F and r["C"] == READOUT_C)
    few_reps = max(args.reps // 4, 3)
    k = _readout_case(B, T, READOUT_F, READOUT_C, torch.bfloat16, gen)
    gvec = torch.tensor([1.0, 0.3, 0.8], device="cuda")
    n_elem = float(B * T * READOUT_C)
    y, stats, msums = _bwd_inputs(rc, k, READOUT_G, "MSE", gvec)
    plain_ms = cuda_ms(lambda: rc.bwd_fused_reference(
        y, k["x"], k["scale"], k["nb"], k["bias"], k["h"], k["w"], stats, msums, gvec, n_elem,
        READOUT_G), few_reps, warmup=1)
    del k, y, stats, msums
    rows_, mb = B * T, B * T * READOUT_C * 2
    nbytes = (2 * mb + (rows_ + READOUT_C) * READOUT_F * 2      # y, x, h, W read
              + (rows_ + READOUT_C) * READOUT_F * 4 + 16 * READOUT_C)   # f32 dW, dh written
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * 2 * rows_ * READOUT_C * READOUT_F / BF16_OPS_PER_S * 1e3
    stack_mode = adamw_rows["bfloat16"]
    kernels = [
        dict(name="readout_bwd_fused", route="cuda",
             source="simulgen_vae_tpu_torch/ops/csrc/readout_bwd_fused.cu",
             replaces=STACK_REPLACES["readout_bwd_fused"], launches=launches["readout_bwd_fused"],
             launches_per_step=launches["readout_bwd_fused"] / steps,
             max_abs_err=bwd_errs["bfloat16"], max_abs_err_f32=bwd_errs["float32"],
             ms=flagship["kernel_ms"], device_ms=flagship["kernel_device_ms"],
             plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
             bound_by="bytes" if t_bytes >= t_ops else "operations", library_ms=None,
             library_call="none: no single PyTorch call computes it (see the segments)",
             shape=f"h [{B}, {T}, {READOUT_F}], W [{READOUT_C}, {READOUT_F}], maps "
                   f"[{B}, {T}, {READOUT_C}] bf16, G={READOUT_G}",
             card=card, segments=segments, launch=bwd_launch),
        dict(name="fused_adamw", route="cuda",
             source="simulgen_vae_tpu_torch/ops/csrc/fused_adamw.cu",
             replaces=STACK_REPLACES["fused_adamw"], launches=launches["fused_adamw"],
             launches_per_step=launches["fused_adamw"] / steps,
             max_abs_err=adamw_errs["bfloat16"], max_abs_err_f32=adamw_errs["float32"],
             ms=stack_mode["ms"], plain_ms=stack_mode["plain_ms"],
             bound_ms=stack_mode["bound_ms"], bound_by=stack_mode["bound_by"],
             library_ms=adamw_rows["float32"]["library_ms"],
             library_call=stack_mode["library_call"], card=card, modes=adamw_rows),
    ]
    result = dict(metrics=metrics, launches=launches, steps=steps, adamw_sweeps_per_step=sweeps,
                  step_checks=checks, segments=segments, adamw=adamw_rows, step_p50_ms=step_p50,
                  stream_step_p50_ms=stream_p50, stream_step_ms=stream_ms.tolist(),
                  device_busy_ms=busy, wide_matmuls_in_2_steps=wide_mm, resume_bit_equal=resume_ok, peak_gb=peak_gb)
    return kernels, result


# -- --ab: two versions of a kernel family on one card -------------------------

# (C, launches per decode) of the serving decode's one-pass GroupNorms (G = 8,
# gelu, bf16; phase 3 records them).
DECODE_ONEPASS = ((128, 1), (256, 3), (512, 4))


def onepass_times(gg, seed: int, reps: int) -> dict:
    """The device time of one decode's gn_act_onepass launches (CUDA graph
    replay) beside F.group_norm + gelu timed the same way, after a check
    against the plain version."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = []
    for c, n in DECODE_ONEPASS:
        x, scale, bias = _map(c, torch.bfloat16, gen)
        xt, s16, b16 = x.transpose(1, 2).contiguous(), scale.to(x.dtype), bias.to(x.dtype)
        _assert_close(f"gn_act_onepass C={c}", gg.gn_act_onepass(x, scale, bias, 8),
                      gg.group_norm_act_reference(x, scale, bias, 8), x.dtype)
        rows.append(dict(C=c, per_decode=n,
                         device_ms=graph_ms(lambda: gg.gn_act_onepass(x, scale, bias, 8), reps),
                         library_device_ms=graph_ms(
                             lambda: F.gelu(F.group_norm(xt, 8, s16, b16, 1e-5)), reps)))
    return dict(
        device_ms_per_decode=sum(r["device_ms"] * r["per_decode"] for r in rows),
        library_device_ms_per_decode=sum(r["library_device_ms"] * r["per_decode"] for r in rows),
        shapes=rows)


# (C, launches per step, act) of the train step's GroupNorms (G = 8, bf16;
# phase 5 records them): the backward route of each is the tree's own.
STEP_GN = ((128, 3, "gelu"), (256, 5, "gelu"), (512, 6, "gelu"), (1024, 4, "gelu"),
           (1280, 2, "gelu"), (2560, 2, "gelu"), (5120, 2, "gelu"), (95008, 1, "tanh"))


def _backward_route(gg, x, scale, bias, grad, g, act):
    """The tree's GroupNormAct.backward for a map whose forward took the
    tree's route: ``(call, {kernel: call})``, the whole backward and each of
    its kernels."""
    t, c, elem = x.shape[1], x.shape[2], x.element_size()
    stats = None if gg.onepass_fits(t, c, g, elem) else gg.gn_stats(x, g)
    ctx = types.SimpleNamespace(saved_tensors=(x, scale, bias, stats), cfg=(g, 1e-5, act))

    def whole():
        return gg.GroupNormAct.backward(ctx, grad)

    if gg.bwd_onepass_engages(t, c, g, elem):
        return whole, {"gn_bwd_onepass": lambda: gg.gn_bwd_onepass(x, scale, bias, grad, g,
                                                                    act=act)}
    st = stats if stats is not None else gg.gn_stats(x, g)
    msums = gg.gn_bwd_stats(x, scale, bias, grad, st, g, act)[0]
    parts = {"gn_bwd_stats": lambda: gg.gn_bwd_stats(x, scale, bias, grad, st, g, act),
             "gn_bwd_apply": lambda: gg.gn_bwd_apply(x, scale, bias, grad, st, msums, g, act)}
    if stats is None:  # a one-pass forward saved no statistics: recomputed
        parts = {"gn_stats": lambda: gg.gn_stats(x, g), **parts}
    return whole, parts


def gn_bwd_times(gg, seed: int, reps: int) -> dict:
    """The device time (CUDA graph replay) of one train step's GroupNorm
    backwards, each on the tree's route, whole and by kernel, after a check
    of dx against the plain version; and gn_bwd_apply's f32 error at the
    tanh readout width."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = []
    for c, n, act in STEP_GN:
        x, grad, scale, bias = _bwd_case(c, torch.bfloat16, gen)
        whole, parts = _backward_route(gg, x, scale, bias, grad, 8, act)
        _assert_close(f"backward C={c} dx", whole()[0],
                      gg.group_norm_act_backward_reference(x, scale, bias, grad, 8,
                                                           act=act)[0], x.dtype)
        rows.append(dict(C=c, per_step=n, act=act, route="+".join(parts),
                         device_ms=graph_ms(whole, reps),
                         kernels={k: graph_ms(f, reps) for k, f in parts.items()}))
        del x, grad
        torch.cuda.empty_cache()

    def per_step(keep, kernel=None):
        return sum((r["kernels"].get(kernel, 0.0) if kernel else r["device_ms"]) * r["per_step"]
                   for r in rows if keep(r["C"]))

    # gn_bwd_apply's f32 error against its plain version at the tanh readout
    # width (both from the plain statistics and group sums), with y ~ N(0, 1)
    # and with the scale 8x, where tanh saturates
    x, grad, scale, bias = _bwd_case(95008, torch.float32, gen)
    stats = gg.group_stats_reference(x, 8)
    apply_f32_err = {}
    for label, s in (("y_1x", scale), ("y_8x", 8.0 * scale)):
        msums = gg.gn_bwd_stats_reference(x, s, bias, grad, stats, 8, "tanh")[0]
        apply_f32_err[label] = _err(
            gg.gn_bwd_apply(x, s, bias, grad, stats, msums, 8, "tanh"),
            gg.gn_bwd_apply_reference(x, s, bias, grad, stats, msums, 8, "tanh"))
    del x, grad
    torch.cuda.empty_cache()

    return dict(
        gn_bwd_apply_f32_max_abs_err_c95008_tanh=apply_f32_err,
        backward_ms_per_step=per_step(lambda c: True),
        c128_256_backward_ms=per_step(lambda c: c <= 256),
        c512_backward_ms=per_step(lambda c: c == 512),
        gn_bwd_onepass_ms_per_step=per_step(lambda c: True, "gn_bwd_onepass"),
        gn_bwd_stats_ms_per_step=per_step(lambda c: True, "gn_bwd_stats"),
        gn_bwd_stats_wide_ms_per_step=per_step(lambda c: c >= 1024, "gn_bwd_stats"),
        gn_bwd_stats_below_95008_ms=per_step(lambda c: 1024 <= c < 95008, "gn_bwd_stats"),
        shapes=rows)


# (C, launches per decode, per unfused train step) of gn_stats' maps (G = 8,
# bf16): the decode's nine two-phase forwards (phase 3 records them; gelu up
# to C = 5120, tanh at the readout) and the step's eleven (phase 5; ten in
# the fused step, whose readout map goes through readout_matmul_stats).
STATS_MAPS = ((1024, 2, 4), (1280, 2, 2), (2560, 2, 2), (5120, 2, 2), (95008, 1, 1))


def gn_stats_times(gg, seed: int, reps: int) -> dict:
    """The device time of gn_stats on each map of a decode and a train step,
    from a replayed CUDA graph and as the kernels' own time in a profiler
    trace, beside torch.var_mean measured both ways, after a check against
    the plain version; and a hash of gn_bwd_stats' outputs at two widths, so
    two trees show whether that kernel gives the same bits."""
    import hashlib

    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = []
    for c, per_decode, per_step in STATS_MAPS:
        x = _map(c, torch.bfloat16, gen)[0]
        want = gg.group_stats_reference(x, 8)
        if not torch.allclose(gg.gn_stats(x, 8), want, atol=2e-5, rtol=1e-5):
            raise AssertionError(f"gn_stats C={c}: {_err(gg.gn_stats(x, 8), want):.3g}")
        xv = x.view(B, T, 8, c // 8)

        def kernel():
            return gg.gn_stats(x, 8)

        def library():
            return torch.var_mean(xv, dim=(1, 3))

        rows.append(dict(C=c, per_decode=per_decode, per_step=per_step,
                         bound_ms=(x.numel() * x.element_size() + 8 * B * 8)
                         / HBM_BYTES_PER_S * 1e3,
                         device_ms=graph_ms(kernel, reps),
                         profiled_ms=profiled_device_ms(kernel, reps),
                         library_device_ms=graph_ms(library, reps),
                         library_profiled_ms=profiled_device_ms(library, reps)))
        del x, xv
    bwd_bits = {}
    for c, act in ((1024, "gelu"), (95008, "tanh")):
        x, grad, scale, bias = _bwd_case(c, torch.bfloat16, gen)
        h = hashlib.sha256()
        for out in gg.gn_bwd_stats(x, scale, bias, grad, gg.group_stats_reference(x, 8), 8, act):
            h.update(out.cpu().numpy().tobytes())
        bwd_bits[c] = h.hexdigest()[:16]
        del x, grad
    torch.cuda.empty_cache()

    def total(key, per, keep=lambda c: True):
        return sum(r[key] * r[per] for r in rows if keep(r["C"]))

    keys = ("device_ms", "profiled_ms", "library_device_ms", "library_profiled_ms", "bound_ms")
    return dict(
        per_decode={k: total(k, "per_decode") for k in keys},
        per_decode_narrow={k: total(k, "per_decode", lambda c: c < 95008) for k in keys},
        per_step={k: total(k, "per_step") for k in keys},
        gn_bwd_stats_sha256=bwd_bits, shapes=rows)


def gn_stats_cluster_times(gg, seed: int, reps: int) -> dict:
    """gn_stats built with clusters of k = 5, 6 (the shipped size), 7 and 8
    blocks a sample (_build.VARIANTS gn_stats_k*): how many of its clusters
    the card holds at once (the occupancy API, with the build's own shared
    memory a block and with one block an SM), and its device time (CUDA
    graph) at T = 1 and on each map of a decode, after a check against the
    plain version and of the same bits on two calls."""
    import ctypes

    from simulgen_vae_tpu_torch.ops import _build

    gen = torch.Generator(device="cuda").manual_seed(seed)
    maps = {c: _map(c, torch.bfloat16, gen)[0] for c, _, _ in STATS_MAPS}
    maps["1x1024"] = torch.randn((B, 1, 1024), generator=gen, device="cuda").to(torch.bfloat16)
    builds = []
    for k in (5, 6, 7, 8):
        lib = _build.load(f"gn_stats_k{k}")
        lib.gn_stats_clusters.argtypes, lib.gn_stats_clusters.restype = [ctypes.c_int], ctypes.c_int
        fn = lib.gn_stats
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, *[ctypes.c_int] * 4, ctypes.c_float,
                       ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
        row = dict(k=k, clusters_at_once=lib.gn_stats_clusters(0),
                   clusters_at_once_one_block_an_sm=lib.gn_stats_clusters(1), device_ms={})
        for key, x in maps.items():
            b, t, c = x.shape
            stats = torch.empty((b, 2, 8), device="cuda", dtype=torch.float32)
            split = gg.stats_col_begin(c, x.element_size(), k)

            def call(x=x, stats=stats, split=split, t=t, c=c):
                err = fn(x.data_ptr(), stats.data_ptr(), b, t, c, 8, 1e-5, 1, split,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"gn_stats_k{k}: CUDA error {err}")
                return stats

            first = call().clone()
            want = gg.group_stats_reference(x, 8)
            if not torch.allclose(first, want, atol=2e-5, rtol=1e-5) or not torch.equal(first, call()):
                raise AssertionError(f"gn_stats_k{k} {tuple(x.shape)}: {_err(first, want):.3g} "
                                     "or two calls differ")
            row["device_ms"][str(key)] = graph_ms(call, reps)
        row["per_decode_ms"] = sum(row["device_ms"][str(c)] * n for c, n, _ in STATS_MAPS)
        builds.append(row)
        print(f"gn_stats_k{k}: {row['clusters_at_once']} clusters at once "
              f"({row['clusters_at_once_one_block_an_sm']} one block an SM); device only "
              + ", ".join(f"{key} {v * 1e3:.2f} us" for key, v in row["device_ms"].items())
              + f"; a decode {row['per_decode_ms']:.4f} ms")
    del maps
    torch.cuda.empty_cache()
    return dict(builds=builds)


def readout_bwd_times(gg, seed: int, reps: int) -> dict:
    """readout_bwd_fused (#11) in bf16 at every BWD_FUSED_SHAPES entry (inputs
    from the plain forward, so every tree gets the same): its rel-L2 against
    its plain version (dW, dh, d bias, d inv_sigma), then device only from replayed
    CUDA graphs, in turns (dy-free, materializing, kernel, dy-free,
    materializing): the kernel and both backward segments (dy-free:
    readout_bwd_stats + #11; materializing: readout_bwd_stats +
    readout_bwd_dy + two torch.matmul). Also a hash of readout_matmul_stats'
    outputs (#8) at two shapes, so that two trees show whether #8 gives the
    same bits."""
    import hashlib

    from simulgen_vae_tpu_torch.ops import readout_chain as rc

    gen = torch.Generator(device="cuda").manual_seed(seed)
    gvec = torch.tensor([1.7, 0.3, 0.8], device="cuda")
    rows = []
    for b, t, f, c, g, lossfun in BWD_FUSED_SHAPES:
        k = _readout_case(b, t, f, c, torch.bfloat16, gen)
        n_elem = float(b * t * c)
        y, stats = rc.matmul_stats_reference(k["h"], k["w"], k["bias"], k["inv"], g)
        chain = (k["x"], k["scale"], k["nb"])
        msums = rc.bwd_stats_reference(y, *chain, stats, gvec, n_elem, g, lossfun)[0]
        args = (y, *chain, k["bias"], k["h"], k["w"], stats, msums, gvec, n_elem, g, lossfun)
        got, want = rc.readout_bwd_fused(*args), rc.bwd_fused_reference(*args)
        # recorded, not asserted: phase 7 holds the kernel to its tolerances,
        # and a tree that misses one is still timed
        rels = [_grad_rel(a, w0) for a, w0 in zip(got, want)]
        del got, want
        fused, materialize = backward_segments(rc, k, y, stats, gvec, n_elem, g, lossfun)

        row = dict(B=b, T=t, F=f, C=c, G=g, rel_l2=rels, fused_ms=[graph_ms(fused, reps)],
                   materialize_ms=[graph_ms(materialize, reps)],
                   kernel_ms=graph_ms(lambda: rc.readout_bwd_fused(*args), reps))
        row["fused_ms"].append(graph_ms(fused, reps))
        row["materialize_ms"].append(graph_ms(materialize, reps))
        row["faster"] = ("fused" if sum(row["fused_ms"]) <= sum(row["materialize_ms"])
                         else "materialize")
        row["bwd_flavor"] = rc.bwd_flavor(b, t, f, c)
        rows.append(row)
        del k, y, stats, msums, args
        torch.cuda.empty_cache()
    hashes = {}
    for b, t, f, c, g in ((3, T, 128, 300, 6), (B, T, READOUT_F, READOUT_C, READOUT_G)):
        k = _readout_case(b, t, f, c, torch.bfloat16, gen)
        h = hashlib.sha256()
        for out in rc.readout_matmul_stats(k["h"], k["w"], k["bias"], k["inv"], g):
            h.update(out.view(torch.uint8).cpu().numpy().tobytes())
        hashes[f"{b}x{t}x{f}x{c}"] = h.hexdigest()[:16]
        del k
    torch.cuda.empty_cache()
    return dict(shapes=rows, readout_matmul_stats_sha256=hashes)


# MODE -> (what it times, the kernel sources whose hashes name the tree)
AB_MODES = {"onepass": (onepass_times, ("gn_act_onepass",)),
            "gn-bwd": (gn_bwd_times, ("gn_bwd_onepass", "gn_bwd_stats")),
            "gn-stats": (gn_stats_times, ("gn_stats", "gn_bwd_stats")),
            "gn-stats-clusters": (gn_stats_cluster_times, ("gn_stats",)),
            "readout-bwd": (readout_bwd_times, ("readout_bwd_fused", "readout_matmul_stats"))}


def ab(mode: str, trees, seed: int, reps: int) -> int:
    """Run :func:`ab_tree` for each tree in a process of its own, in the
    order given (parent, change, change, parent compares two commits)."""
    if mode not in AB_MODES:
        raise SystemExit(f"chip_smoke: --ab MODE is one of {sorted(AB_MODES)}, not {mode!r}")
    for tree in trees:
        out = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--seed", str(seed),
                              "--reps", str(reps), "--ab-tree", mode, str(Path(tree).resolve())],
                             capture_output=True, text=True, timeout=900)
        print(out.stdout, end="")
        if out.returncode:
            print(out.stderr, file=sys.stderr)
            return out.returncode
    print(f"card: {card_line()}")
    return 0


def ab_tree(mode: str, tree: str, seed: int, reps: int) -> int:
    """MODE's times with the package found in ``tree``: one JSON line."""
    import hashlib

    sys.path.insert(0, tree)
    from simulgen_vae_tpu_torch.ops import groupnorm_gelu as gg

    csrc = Path(tree) / "simulgen_vae_tpu_torch/ops/csrc"
    if Path(gg.__file__).resolve() != (csrc.parent / "groupnorm_gelu.py").resolve():
        raise AssertionError(f"imported {gg.__file__}, not the package in {tree}")
    times, sources = AB_MODES[mode]
    print(json.dumps(dict(
        mode=mode, tree=tree,
        source_sha256={k: hashlib.sha256((csrc / f"{k}.cu").read_bytes()).hexdigest()[:12]
                       for k in sources},
        **times(gg, seed, reps))))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20, help="timed calls per measurement")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--ab", nargs="+", metavar="MODE TREE",
                    help="only time one kernel family (device only) with the package of each "
                         f"TREE, in turn; MODE is one of {sorted(AB_MODES)}")
    ap.add_argument("--ab-tree", nargs=2, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if args.ab_tree:
        return ab_tree(*args.ab_tree, args.seed, args.reps)
    if args.ab:
        if len(args.ab) < 2:
            ap.error("--ab needs a MODE and at least one TREE")
        return ab(args.ab[0], args.ab[1:], args.seed, args.reps)
    from simulgen_vae_tpu_torch import convert
    from simulgen_vae_tpu_torch import generate as tgen
    from simulgen_vae_tpu_torch.config import LCConfig, VAEConfig
    from simulgen_vae_tpu_torch.data.scaler import MinMaxScaler
    from simulgen_vae_tpu_torch.models import blocks
    from simulgen_vae_tpu_torch.ops import _build
    from simulgen_vae_tpu_torch.ops import gather_augment as ga
    from simulgen_vae_tpu_torch.ops import groupnorm_gelu as gg
    from simulgen_vae_tpu_torch.ops import readout_chain as rc

    t_start = time.perf_counter()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. build
    seconds = _build.build((*_build.KERNELS, *_build.VARIANTS))
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke_build.log").write_text(
        "\n".join(f"== {k}\n{v}" for k, v in _build.BUILD_LOG.items()))
    print(f"build: {max(seconds.values()):.1f} s for {len(seconds)} libraries "
          f"({', '.join(f'{k} {v:.1f}' for k, v in seconds.items())})")
    sass = sass_check(_build)

    # 3a. the flagship pipeline (built before phase 2 to learn the shapes)
    cfg = VAEConfig(num_time=T, num_node=95008, latent_dim_end=32, latent_dim=8,
                    num_filter_enc=[1024, 512, 256, 128], small=True)
    lc_cfg = LCConfig(filters=[32, 64, 128, 256, 512, 1024])
    n_in = 484
    rng = np.random.default_rng(args.seed)
    vae_params = {"decoder": convert.random_decoder_tree(cfg, rng)}
    lc_params = convert.random_conditioner_tree(lc_cfg, cfg, n_in, rng)
    scalers = {name: MinMaxScaler(rng.uniform(0.5, 2.0, n).astype(np.float32),
                                  rng.uniform(-0.3, 0.3, n).astype(np.float32))
               for name, n in (("lv_scaler", 32), ("xs_scaler", 24),
                               ("data_scaler", cfg.num_node))}
    inputs = rng.standard_normal((40, n_in)).astype(np.float32)

    def pipeline(dtype):
        return tgen.make_pipeline(cfg, lc_cfg, vae_params, lc_params, device="cuda",
                                  dtype=dtype, **scalers)

    pipe = pipeline(torch.bfloat16)
    calls = []
    with recording_calls(blocks, calls):
        tgen.generate(pipe, inputs[:B], max_batch=B)
    expected = 1 + sum(isinstance(m, blocks.NormAct) for m in pipe["vae"].modules())
    if len(calls) != expected:
        raise AssertionError(f"{len(calls)} GroupNorm calls per decode, expected {expected}")
    widths = sorted(set(calls))
    print(f"serve: {len(calls)} GroupNorm calls per decode at C = "
          f"{sorted({c for c, _, _ in calls})}")

    # 2. each kernel against its plain version
    gen = torch.Generator("cuda").manual_seed(args.seed)
    errs = phase_kernels(gg, widths, gen)
    x, scale, bias = _map(512, torch.bfloat16, gen)
    onepass = cluster_launch("gn_act_onepass", lambda: gg.gn_act_onepass(x, scale, bias, 8),
                             "kernels")
    del x, scale, bias
    stats_launch = gn_stats_launches(gg, gen)

    # 3b. serve 40 requests through the kernels
    gg.reset_launch_counts()
    t0 = time.perf_counter()
    fields = tgen.generate(pipe, inputs, max_batch=B)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = {k: gg.LAUNCHES[k] for k in REPLACES}
    if tuple(fields.shape) != (40, T, cfg.num_node) or not bool(fields.isfinite().all()):
        raise AssertionError(f"bad output {tuple(fields.shape)} or non-finite values")
    if not all(n > 0 for n in launches.values()):
        raise AssertionError(f"a kernel did not run on the main path: {launches}")
    if launches["gn_act_onepass"] + launches["gn_stats"] != 3 * expected:
        raise AssertionError(f"launches {launches} != 3 decodes x {expected}")
    print(f"serve: 40 requests -> {tuple(fields.shape)} {fields.dtype}, finite, "
          f"{serve_s:.3f} s with first-chunk set-up; launches {launches}")
    del fields

    # 3c. kernels vs plain GroupNorm on the card, tanh outputs (no descale)
    checks = {}
    for dtype in (torch.bfloat16, torch.float32):
        p = pipe if dtype == torch.bfloat16 else pipeline(dtype)
        got = tgen.generate(p, inputs, descale_output=False, max_batch=B)
        with plain_group_norm(blocks, gg):
            want = tgen.generate(p, inputs, descale_output=False, max_batch=B)
        rel, mx = _rel_l2(got, want), _err(got, want)
        checks[str(dtype).split(".")[1]] = {"rel_l2": rel, "max_abs": mx}
        ok = rel <= 1e-2 if dtype == torch.bfloat16 else mx <= 1e-4
        print(f"serve: kernels vs plain GroupNorm, {dtype}: rel-L2 {rel:.3g}, "
              f"max abs {mx:.3g} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"serving output disagrees with the plain path ({dtype})")
        del got, want, p
    torch.cuda.empty_cache()

    # 4. timings
    fn = tgen.make_generate_fn(pipe, descale_output=True, max_batch=B)
    batch = torch.as_tensor(inputs[:B], device="cuda")

    def latencies_ms(run):
        """Host clock around each decode, synchronised: DECODE_CALLS samples."""
        for _ in range(3):
            run(batch)
        torch.cuda.synchronize()
        lat = []
        for _ in range(DECODE_CALLS):
            t0 = time.perf_counter()
            run(batch)
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
        return np.asarray(lat)

    lat = latencies_ms(fn)
    with plain_group_norm(blocks, gg):
        plain_lat = latencies_ms(fn)
    decode_p50, decode_p75 = (float(v) for v in np.percentile(lat, [50, 75]))
    plain_p50 = float(np.percentile(plain_lat, 50))
    print(f"timing: [{card}] batch-16 decode over {DECODE_CALLS} calls: p50 "
          f"{decode_p50:.3f} ms, p75 {decode_p75:.3f} ms, min/max {lat.min():.3f}/"
          f"{lat.max():.3f} ms ({B / decode_p50 * 1e3:.1f} samples/s at p50); "
          f"plain GroupNorm decode p50 {plain_p50:.3f} ms")
    # the two bf16 rounding repairs: decode before (pre_repair_layers) and
    # after, in turns: after, before, before, after
    repairs = dict(erfc=erfc_bits(blocks, gen))
    for turn, when in enumerate(("after", "before", "before", "after")):
        ctx = pre_repair_layers(blocks) if when == "before" else contextlib.nullcontext()
        with ctx:
            p50 = float(np.percentile(latencies_ms(fn), 50))
            dev = decode_device(fn, batch)
        repairs.setdefault(when, []).append(dict(p50_ms=p50, **dev))
        print(f"timing: [{card}] decode {when} the bf16 rounding repairs (turn {turn + 1}): "
              f"p50 {p50:.3f} ms, device {dev['device_ms']:.3f} ms, "
              f"{dev['kernels']:.0f} kernels a decode")
    repairs["kernels_added_per_decode"] = (repairs["after"][0]["kernels"]
                                           - repairs["before"][0]["kernels"])
    print(f"timing: [{card}] the repairs add {repairs['kernels_added_per_decode']:.0f} kernel "
          "launches a decode")
    per_shape = kernel_timings(gg, calls, args.reps, gen, card)

    if args.profile:
        prof, _ = traced(lambda: [fn(batch) for _ in range(3)])
        events = prof.key_averages()
        # Kernel rows only: CPU-op rows repeat the device time of their kernels.
        busy_ms = sum(e.self_device_time_total for e in kernel_rows(prof)) / 1e3 / 3
        host_ms = sum(e.self_cpu_time_total for e in events) / 1e3 / 3
        table = events.table(sort_by="self_device_time_total", row_limit=40)
        (OUT_DIR / "chip_smoke_profile.txt").write_text(table)
        print(f"profile: device busy {busy_ms:.3f} ms and host ops {host_ms:.3f} ms "
              f"per decode (profiled) against the {decode_p50:.3f} ms p50 (idle share "
              f"{1 - busy_ms / decode_p50:.3f}); device time by kernel in "
              "chiprun_out/chip_smoke_profile.txt")
        print("\n".join(table.splitlines()[:24]))

    kernels = []
    for name, rows in per_shape.items():
        total = lambda key: sum(r[key] * r["per_decode"] for r in rows)  # noqa: E731
        kernels.append(dict(
            name=name, route="cuda",
            source=f"simulgen_vae_tpu_torch/ops/csrc/{name}.cu",
            replaces=REPLACES[name], launches=launches[name],
            launches_per_decode=sum(r["per_decode"] for r in rows),
            max_abs_err=errs[name]["bfloat16"], max_abs_err_f32=errs[name]["float32"],
            ms=total("ms"), plain_ms=total("plain_ms"), bound_ms=total("bound_ms"),
            bound_by="bytes" if all(r["bound_by"] == "bytes" for r in rows)
            else "operations",
            library_ms=total("library_ms"), per_decode_sum=True, card=card,
            shapes=rows))
        if name in ("gn_act_onepass", "gn_stats"):
            k = kernels[-1]
            k.update(device_ms=total("device_ms"), library_device_ms=total("library_device_ms"))
            print(f"timing: [{card}] {name} per decode ({k['launches_per_decode']} "
                  f"launches): {k['ms']:.4f} ms (the constant for the earlier design: "
                  f"{EARLIER_MS[name]:.3f} ms), device only "
                  f"{k['device_ms']:.4f} ms; library {k['library_ms']:.4f} ms, device only "
                  f"{k['library_device_ms']:.4f} ms; plain {k['plain_ms']:.4f} ms; bound "
                  f"{k['bound_ms']:.4f} ms; below the library call: "
                  f"{k['ms'] < k['library_ms']} (both timings), "
                  f"{k['device_ms'] < k['library_device_ms']} (device only)")
    del pipe, fn, batch
    torch.cuda.empty_cache()

    # 5. the train step
    train_kernels, train, ctx = phase_train(args, card, blocks, gg, ga, gen)
    for k in kernels:  # the forward kernels run in the train step too
        k["launches_train"] = train["launches"][k["name"]]
    kernels += train_kernels

    # 6. the fused-readout train path
    fused_kernels, fused = phase_fused(args, card, blocks, gg, ga, rc, gen, ctx)
    for k in kernels:
        k["launches_fused_train"] = fused["launches"][k["name"]]
    kernels += fused_kernels

    # 7. the benched train stack
    cfg_train, data, data32 = ctx["cfg"], ctx["data"], ctx["data32"]
    ctx.clear()             # the unfused trainer and its state are done
    torch.cuda.empty_cache()
    stack_kernels, stack = phase_stack(args, card, gg, ga, rc, gen, cfg_train, data, data32)
    for k in kernels:
        k["launches_stack_train"] = stack["launches"][k["name"]]
    kernels += stack_kernels
    result = dict(card=card, kind=kind, seed=args.seed, decode_p50_ms=decode_p50,
                  decode_p75_ms=decode_p75, decode_calls=DECODE_CALLS,
                  samples_per_s=B / decode_p50 * 1e3, plain_decode_p50_ms=plain_p50,
                  serve_checks=checks, launches=launches, kernels=kernels, train=train,
                  readout_sass=sass, onepass_launch=onepass, gn_stats_launch=stats_launch,
                  repairs=repairs,
                  fused_train=fused, stack_train=stack, profiler_sessions=PROFILER_SESSIONS,
                  seconds=time.perf_counter() - t_start)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(result, indent=1))
    print(f"profiler: {PROFILER_SESSIONS['sessions']} sessions, "
          f"{PROFILER_SESSIONS['taken_again']} of them recorded no kernel and were taken again")
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
