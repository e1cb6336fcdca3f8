#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (simulgen_vae_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--seed 0] [--reps 20] [--profile]

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
             differing); per kernel at each main-path shape, its time beside
             its plain version, one PyTorch library call and the card's bound
             (HBM bytes at 3.35 TB/s, or operations at 67 TFLOP/s f32,
             whichever is larger); for gn_act_onepass, gn_stats and their
             library calls also the device time alone (calls replayed from a
             CUDA graph);
5. train   : the flagship VAE train step (bench.py's configuration: 64
             resident samples of 200 x 95008 made on the card from --seed,
             encoder filters 1024 512 256 128, batch 16, bf16 compute, f32
             master weights and AdamW moments, spectral norm every step,
             default augmentation) through VAETrainer.train_epoch, whose
             steps are replays of one captured CUDA graph: first two
             trainers from one state and seed, one through the eager step
             (VAETrainer.eager_step), one through the graph path, over two
             epochs (8 steps: 1 eager, the capture, 7 replays): each step's
             loss and the largest parameter, moment and power-iteration
             vector difference (must be 0), then each side's p50 ms a step
             (epochs back to back, in turns), launch calls a step in a
             profiler trace and the capture and replay counters; two
             warm-up steps (the second captured: its launch counts are one
             step's), then each train kernel (gather_augment,
             gn_bwd_onepass, gn_bwd_stats, gn_bwd_apply) against its plain
             version at every shape the step gives it, in f32 and bf16
             (gn_bwd_onepass and gn_bwd_stats: two calls the same bits;
             gn_bwd_onepass also at its engage rule's edge, f32, T = 1, G =
             16), and profiler traces of both: B x 8 blocks launched by
             cudaLaunchKernelEx, gn_bwd_stats one kernel a call; an epoch of
             4 replays in a profiler trace whose loss and gradient norm must
             be finite, every train kernel in the captured step
             (gather_augment once, the loss pair's two passes once each)
             and the replays' kernels, counted in the
             trace, the captured step's times the replays; one
             step's loss and gradients through the kernels against
             the plain versions from the same state, batch and noise (bf16:
             loss within 1e-2 relative; f32 with TF32 off: loss within 1e-4,
             every gradient within rel-L2 1e-3); the loss pair
             (recon_loss_pair) on that step's own x_hat and x (16 x 200 x
             95008, bf16 and f32) against make_recon_loss_pair for every
             loss name: the gradients bit for bit, both losses within 1e-6
             relative; then the step's p50 and each train kernel's time per
             step beside its bound, plain and library times (gn_bwd_onepass
             and gn_bwd_stats also device only from a replayed CUDA graph,
             and their kernels' own time in a profiler trace beside the
             library backward's measured the same way; the loss pair's MSE
             forward and backward, bf16, beside the plain pair's and its
             bound of 10 bytes an element: the kernels line's recon_loss
             row);
6. fused   : the fused-readout train path (VAETrainer(fused_readout=True)):
             each of its four kernels (readout_matmul_stats, readout_loss,
             readout_bwd_stats, readout_bwd_dy) against its plain version in
             f32 and bf16 at the flagship readout shape (B=16, T=200, F=1024,
             C=95008, G=8) and two small ragged ones (readout_matmul_stats:
             two calls the same bits); the same configuration,
             data and seed as phase 5 trained for one epoch (4 replays of
             the captured step, in a profiler trace) with finite losses, each
             new kernel launched once a step (counted in the trace), the
             replays launching the captured step's kernels and no GroupNorm
             kernel launched at C = 95008; one step from one state,
             batch and noise three ways (fused kernels, fused plain versions,
             unfused route; f32 with TF32 off: loss within 1e-4, every
             gradient and the readout's inv_sigma gradient within rel-L2 1e-3;
             bf16: loss within 1e-2); then per-kernel times beside their
             bounds (readout_matmul_stats also in TFLOP/s and beside F.linear
             alone), the readout segment
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
             trainer and one more epoch, bit-equal to an uninterrupted run; the
             streamed epoch's host gather (vae_trainer.gather_rows: one bf16
             batch cast row by row into pinned memory, the same bits on the
             card as index_select in f32 cast there; its ms a batch against
             index_select f32, in turns); one streamed epoch of 4 steps
             through it (finite metrics, step p50); one step from
             one state, batch and noise with the dy-free backward through its
             kernel, through its plain version and with the materializing
             backward (tolerances of phase 6), and the kernel AdamW against the
             plain one (parameters rel-L2 1e-6); then times in turns: the
             backward segment dy-free against materializing at every shape,
             device only from replayed CUDA graphs (the table behind
             ops.readout_chain.bwd_flavor), fused_adamw over
             the model's 403.5M parameters in its three modes beside the plain
             sweeps, torch's fused AdamW and the byte bounds, and the step p50
             of four stacks;
8. artifacts: serving a trained model's files. A complete model_save/ from
             the port's own writers (phase 3's geometry with the encoder:
             random VAE and conditioner trees from --seed, the four scaler
             pickles, condition.txt, preset.txt, a CSV of 40 rows) in a
             temporary directory; ``python -m simulgen_vae_tpu_torch.generate
             --quantize none`` in its own process (run through runpy, which
             then prints that process's launch counts): (40, 200, 95008),
             finite, within rel-L2 1e-6 of make_pipeline + generate on the
             same trees in f32 (both under PyTorch's default precision flags,
             the CLI's), and the GroupNorm kernels launched; ``--quantize
             int8``: within rel-L2 0.05 of the float output, int8 products
             launched; the CLI's default (``--quantize auto``) within rel-L2
             1e-6 of the mode resolve_quantize and the self-check choose;
             load_pipeline's time (f32 and bf16) and the model files' read
             and parse alone; the batch-16
             decode's p50, device time and kernels in f32, bf16 and int8 over
             each, in turns; int8_mm against its plain version (exact) and
             torch._int_mm at every shape a decode gives it, beside its bound
             (operations at 1979 TOP/s int8 or bytes at 3.35 TB/s);
9. cli-train: the training CLI at the flagship geometry. A work directory
             (its disk room checked first) with a dataset pickle of 32
             samples of 200 x 95008 f32 made from --seed on the card slice by
             slice, condition.txt (batch 16, Recon_iter 2, input_type csv,
             latent_conditioner_batch 16, n_epoch 30), preset.txt (encoder
             1024 512 256 128, conditioner 32 .. 1024) and a 484-column
             params.csv; ``python -m simulgen_vae_tpu_torch --preset=1
             --plot=2 --lc_only=0 --size=small --dtype bfloat16 --epochs 2
             --lc_epochs 30`` in its own process (CLI_RUNNER, which prints
             that process's launch counts and peak memory): exit 0, every
             kernel of the VAE stage (#1-#7) and fused_adamw launched, the
             eight model_save/ files, latent_vectors.npy (32, 32) and xs.npy
             (32, 3, 8) finite, 32 finite L2 lines; its wall time, peak
             memory and the VAE and LC epoch times and LC losses from its
             log lines; ``--lc_only=1 --lc_epochs 5`` in a second process
             exits 0; ``python -m simulgen_vae_tpu_torch.generate`` serves
             the trained model_save/ for the 32 rows (--quantize none):
             (32, 200, 95008), finite, within rel-L2 1e-6 of load_pipeline +
             generate in this process under the CLI's flags; --quantize int8
             against it (printed, no gate);
10. images : the image conditioners at the flagship widths (conditioner
             filters 32 .. 1024, 256 x 256 images) on phase 9's trained VAE,
             latents and dataset, in its work directory. The card has no
             OpenCV: IMAGE_RUNNER runs the training CLI with only
             data.images.read_latent_conditioner_dataset_img replaced by 32
             binary outline images from --seed (seeded_images; it prints a
             line saying so). First the shipped configuration (input_type
             image, use_e2e_training 1, Huber, LC_alpha 1000, reg 0.001,
             batch 64 -> min(64, n_train)), then input_type image_vit through
             LCTrainer with augmentation, each ``--lc_only=1``: exit 0, the
             eight model_save/ files with LatentConditioner rewritten, the
             latents as phase 9 left them, finite losses; the E2E process
             launches gn_act_onepass, gn_stats, gn_apply, gn_bwd_onepass,
             gn_bwd_stats, gn_bwd_apply and fused_adamw. In that process,
             after its counts are read, the E2E loss and the conditioner's
             gradients at fit's batch sizes (23 training rows forward and
             backward, 9 validation rows forward) through those GroupNorm
             kernels against the plain version (e2e_routes): bf16 as trained
             (losses 1e-2 relative, the whole gradient rel-L2 1e-2) and f32,
             TF32 off (losses 1e-4, every gradient rel-L2 1e-3). Each trained
             model_save/ served by load_pipeline + generate from 16 images in
             f32 (TF32 off) within rel-L2 1e-6 of make_pipeline on the tree
             the trainer saved, kept in its process; its conditioner on the
             card against the same one on the CPU within max-abs 1e-4.
             Printed, not gated: each run's wall time, stages, peak memory
             and epoch times; batch-16 decode p50 and device time through
             the CNN, ViT and CSV pipelines and the conditioners' own device
             time, in turns; the trained CNN's raw-kernel (served) output
             against its forward through W / sigma on one checkpoint.
11. pca    : the image_pca input type on phase 9's trained VAE, latents and
             dataset, in its work directory. PCA_RUNNER runs the training CLI
             --lc_only=1 --lc_epochs 16 with input_type image_pca and only
             data.images.read_raw_images replaced by 32 grayscale 256 x 256
             images from --seed (seeded_gray_images: smooth shapes plus noise
             over 0-255; it prints a line saying so): the PCA (256 components
             asked for, 32 kept) is fitted on the card in that process and the
             MLP trains on the scaled coefficients at the flagship widths.
             Gated: exit 0, the eight model_save/ files and pca_full_comp32.pkl,
             the input scaler 256 columns wide, finite losses, gn_act_onepass,
             gn_stats, gn_apply and fused_adamw launched; in that process
             (pca_checks) the components [32, 65536] f32 with output_shape
             (16, 16) and rows orthonormal within 1e-4, the card's fit against
             the same fit on the CPU (components and coefficients within 1e-3
             up to sign, the null-space component left out),
             utils.profiling.device_memory_mb's peak equal to
             torch.cuda.max_memory_allocated, and utils.profiling.trace of a
             decode writing a file under chiprun_out/pca_trace/ with a CUDA
             kernel event; load_pipeline + generate on 16 rows of the scaled
             coefficients (f32, TF32 off) within rel-L2 1e-6 of make_pipeline
             on the tree the trainer saved. Printed: the process's wall time,
             the PCA fit's seconds, peak memory.
12. mesh   : the multi-device layer, the main process's tensors freed first.
             (a) Two ranks on the one card (tests/torch_ranks.py; gloo
             with CUDA tensors, since NCCL takes one rank a card), meshes 1 x 2
             (the node axis split: 47504 nodes and 4 readout groups a rank)
             and 2 x 1, at the flagship geometry (mesh_rank): one step from
             one seeded state and batch, no augmentation, f32 with TF32 off,
             against the same step in one process (rank 0 before the mesh
             starts): loss within 1e-4 relative, every gradient, gathered,
             within rel-L2 1e-3; a bf16 fit of 2 epochs of 4 steps (64
             samples made on the card from --seed) with a CheckpointManager,
             the launch counts from 0: finite losses, equal on both ranks,
             #1-#7 and fused_adamw launched on every rank; the checkpoint
             restored in one process (rank 0) equal to the gathered state bit
             for bit; make_generate_fn(mesh=...) on 16 of phase 3's requests,
             f32 (TF32 off) within max-abs 1e-4 of one process, int8 within
             rel-L2 1e-3 of one process's int8 decoding the same calls (each
             rank's rows; the card's convolutions pick their algorithm by
             batch, and int8's rounding magnifies that: one process's int8 in
             calls of 8 against one call of 16 is printed). Printed, labelled as a
             one-card rehearsal: each rank's peak memory, step p50 and host
             time a step in collectives. (b) ``python -m
             torch.distributed.run --standalone --nproc_per_node 1 -m
             simulgen_vae_tpu_torch --mesh_data 1 --mesh_model 1 --epochs 1
             --lc_epochs 2`` (one NCCL rank) in phase 9's work directory:
             exit 0, ``Mesh: {'data': 1, 'model': 1}`` printed and the eight
             model_save/ files.
13. epilogue: the readout's GroupNorm apply, tanh and descale in one pass
             (gn_apply_field_epilogue, ops/csrc/field_epilogue.cu) against
             gn_apply(act="tanh") then the plain descale bit for bit, and
             within a rounding step of its whole plain version, at the
             sweep's chunk shape (64 x 200 x 95008, bf16 and f32, into rows
             64-127 of a 128-row field and the padded tail's 63 rows) and at
             ragged shapes (N or the group width not a multiple of 4, row
             bases off 16 bytes), the other rows left unwritten; one 128-row
             request through make_generate_fn(max_batch=64): two fused
             launches and no tanh GroupNorm, the same bits as the plain
             descale of the same request served raw; the kernel's time for
             one request (back to back, device only, profiled: a session
             that reads under the bound is taken again) beside its byte
             bound (4.36 ms) and its plain version (plain_ms).
14. layout : the decoder's k > 1 convolutions in cuDNN's channels-last
             layout (models.blocks.conv1d_same, weights held by
             make_generate_fn): one 64-row flagship decode (bf16, raw field)
             ticks CONV_LAYOUT's conv.direct 14, conv.input_copied 3 (the
             latent injectors' transposed maps) and conv.weight_copied 0;
             its profiler trace (shapes recorded) holds no nchwToNhwc or
             nhwcToNchw kernel and no layout copy (an aten::copy_ under
             aten::clone) of a map as large as the narrowest decoder
             activation (64 x 200 x 128); its field against the same
             decode through the plain convolution (F.conv1d on the
             [B, C, T] map) within rel-L2 1e-2, bit-equality printed.
             Printed, not gated: the decode's device time in the trace
             beside the plain convolution's and the figure from before
             the channels-last layout (PERF.md).

The line before the last is the kernels' JSON; the last line is
``{"ok": true, "device": {...}}``. --profile adds torch.profiler tables of
device time by kernel for three decodes, one train step, one fused train step
and two steps of the benched stack with either backward (written under
chiprun_out/). Without a CUDA device, or without the package beside it, the
script fails.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import pickle
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
# no Pallas kernel: XLA's fusion of the JAX package's loss pair
RECON_REPLACES = "simulgen_vae_tpu/losses.py:130"
RECON_UPSTREAM = (1000.0, 0.37)  # g_flavor, g_mse in the loss pair's check: both terms count
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
GRAPH_EPOCHS, GRAPH_TIMING = 2, 6   # graph_against_eager: epochs compared, epochs timed a side
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchKernelEx",
                "cuLaunchKernel", "cuLaunchKernelEx", "cudaGraphLaunch", "cuGraphLaunch")
# The trace names of the kernels an op's call launches and how many it
# launches (traced_launches); every other op launches one, "<op>_kernel".
OP_KERNELS = {"readout_matmul_stats": ("matmul_stats_finalize(_flat)?_kernel", 1),
              "readout_bwd_fused": ("fused_(bf16|f32)_kernel", 2)}
READOUT_F, READOUT_C, READOUT_G = 1024, 95008, 8


def seed_tensor(seed: int) -> torch.Tensor:
    """A noise seed as ``gather_augment`` reads it: one int32 word on the card."""
    from simulgen_vae_tpu_torch.ops.gather_augment import seed_word

    return torch.tensor([seed_word(seed)], dtype=torch.int32, device="cuda")


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


def traced_launches(prof, ops) -> dict:
    """The calls of each op in ``ops`` that a ``traced`` session recorded:
    its kernels (OP_KERNELS) counted in the trace, over the kernels one call
    launches. The kernels of a CUDA graph's replays are in the trace too, so
    this counts what the replays ran, where the ops' LAUNCHES counters see
    only the capture."""
    rows = kernel_rows(prof)
    out = {}
    for op in ops:
        pattern, per_call = OP_KERNELS.get(op, (f"{op}_kernel", 1))
        found = re.compile(rf"(?<![A-Za-z0-9_]){pattern}(?![A-Za-z0-9_])")
        n = sum(e.count for e in rows if found.search(e.key))
        out[op] = n // per_call if n % per_call == 0 else n / per_call
    return out


def profiled_device_ms(fn, reps: int, expect: str | None = None, floor_ms: float = 0.0) -> float:
    """Device time of one call of ``fn``: its kernels' own time in a profiler
    trace of ``reps`` calls, for calls a CUDA graph cannot capture (autograd's
    backward of a library call). ``expect`` goes to ``traced``; a session
    that reads under ``floor_ms`` (a bound no call can beat: the session lost
    kernels' records) is taken again, up to TRACE_ATTEMPTS times, and then
    fails."""
    fn()
    torch.cuda.synchronize()
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        prof, _ = traced(lambda: [fn() for _ in range(reps)], cpu=False, expect=expect)
        ms = sum(e.self_device_time_total for e in kernel_rows(prof)) / 1e3 / reps
        if ms >= floor_ms:
            return ms
        PROFILER_SESSIONS["taken_again"] += 1
        print(f"profiler: session {attempt} of {TRACE_ATTEMPTS} read {ms:.4f} ms, under the "
              f"bound of {floor_ms:.4f} ms; tracing again")
    raise AssertionError(f"every profiler session read under the bound of {floor_ms:.4f} ms")


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
    got = ga.gather_augment(data, idx, pidx, seed_tensor(7), lam, amp, zero)
    want = ga.gather_augment_reference(data, idx, pidx, None, lam, amp, zero)
    if not torch.equal(got, want):
        raise AssertionError(f"gather_augment ({dname}) differs without noise: "
                             f"{_err(got, want):.3g}")
    ones = torch.ones(B, device="cuda")
    sd = torch.tensor([0.05, 0.0] * (B // 2), device="cuda")
    noisy = ga.gather_augment(data, idx, idx, seed_tensor(11), ones, ones, sd)
    again = ga.gather_augment(data, idx, idx, seed_tensor(11), ones, ones, sd)
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
    ms = cuda_ms(lambda: ga.gather_augment(data, idx, pidx, seed_tensor(3), lam, amp, sd), reps)
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


def step_field(model, batch):
    """The step's own reconstruction and target: ``model``'s x_hat of
    ``batch`` (no autograd), and ``batch``."""
    with torch.no_grad():
        x_hat = model(batch, torch.Generator("cuda").manual_seed(7))[0]
    return x_hat, batch


def check_recon_loss(rl, fields) -> dict:
    """recon_loss_pair against make_recon_loss_pair on each ``fields`` pair
    (dtype name: (x_hat, x)), for every loss name: the gradients in x_hat and
    x (upstream RECON_UPSTREAM) bit for bit, both losses within 1e-6
    relative. Returns the largest relative loss error a dtype."""
    from simulgen_vae_tpu_torch import losses

    def pair_and_grads(fn, pred, target):
        p, t = (v.detach().clone().requires_grad_() for v in (pred, target))
        a, b = fn(p, t)
        g = [torch.tensor(v, device=pred.device) for v in RECON_UPSTREAM]
        return a.detach(), b.detach(), torch.autograd.grad((a, b), (p, t), g)

    names = sorted(losses.RECON_LOSSES)
    worst = {}
    for dname, (x_hat, x) in fields.items():
        worst[dname] = 0.0
        for name in names:
            got = pair_and_grads(lambda p, t: rl.recon_loss_pair(p, t, name), x_hat, x)
            want = pair_and_grads(losses.make_recon_loss_pair(name), x_hat, x)
            rel = max(abs(float(got[i]) - float(want[i])) / max(abs(float(want[i])), 1e-30)
                      for i in (0, 1))
            if rel > 1e-6 or not all(torch.equal(a, b) for a, b in zip(got[2], want[2])):
                raise AssertionError(f"recon_loss_pair {name} {dname}: losses "
                                     f"{[float(v) for v in got[:2]]} against the plain "
                                     f"{[float(v) for v in want[:2]]}, or gradients not "
                                     "bit-equal")
            worst[dname] = max(worst[dname], rel)
            del got, want
        print(f"train kernels: recon_loss {dname} {tuple(x.shape)} (the step's x_hat and x): "
              f"gradients bit-equal to make_recon_loss_pair for {names}, losses within "
              f"{worst[dname]:.3g} relative")
    return worst


def recon_loss_kernel(rl, x_hat, x, loss_rel, launches, steps, reps, card) -> dict:
    """The kernels line's recon_loss row: the main path's pair (MSE, x_hat and
    x bf16, x wanting no gradient) forward and backward through autograd
    against the plain pair, each pass alone, and the bound (10 bytes an
    element: both maps read twice, the gradient written once)."""
    from simulgen_vae_tpu_torch.losses import make_recon_loss_pair

    gf, gm = (torch.tensor(v, device="cuda") for v in RECON_UPSTREAM)

    def through(pair):
        def run():
            p = x_hat.detach().requires_grad_()
            torch.autograd.grad(pair(p, x), (p,), (gf, gm))
        return run

    ms = cuda_ms(through(lambda p, t: rl.recon_loss_pair(p, t, "MSE")), reps)
    plain_ms = cuda_ms(through(make_recon_loss_pair("MSE")), reps)
    fwd_ms = cuda_ms(lambda: rl.recon_loss_pair_fwd(x_hat, x, "MSE"), reps)
    bwd_ms = cuda_ms(lambda: rl.recon_loss_pair_bwd(x_hat, x, gf, gm, "MSE", True, False), reps)
    n = x.numel()
    bound_ms = 5 * n * x.element_size() / HBM_BYTES_PER_S * 1e3
    ops = {k: launches[k] for k in rl.LAUNCHES}
    print(f"timing: [{card}] train recon_loss x1/step (MSE, {tuple(x.shape)} {x.dtype}): "
          f"{ms:.4f} ms forward and backward (forward {fwd_ms:.4f}, backward {bwd_ms:.4f}; "
          f"plain pair {plain_ms:.4f}, bound {bound_ms:.4f}, bytes); launches in the "
          f"replays (trace) {ops}")
    return dict(name="recon_loss", route="cuda",
                source="simulgen_vae_tpu_torch/ops/csrc/recon_loss.cu", replaces=RECON_REPLACES,
                launches=ops, launches_per_step={k: v / steps for k, v in ops.items()},
                max_abs_err=0.0, max_abs_err_f32=0.0, loss_rel_err=loss_rel, ms=ms,
                fwd_ms=fwd_ms, bwd_ms=bwd_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="bytes", library_ms=None,
                library_call="none: no single PyTorch call gives both losses and their gradient",
                shape=f"[{', '.join(map(str, x.shape))}] {str(x.dtype).split('.')[-1]}",
                card=card)


def train_config():
    """The flagship train configuration (bench.py's), 403.5M parameters."""
    from simulgen_vae_tpu_torch.config import VAEConfig

    return VAEConfig(num_param=TRAIN_SAMPLES, num_time=T, num_node=READOUT_C,
                     latent_dim_end=32, latent_dim=8, num_filter_enc=[1024, 512, 256, 128],
                     small=True, batch_size=B, lr=1e-3, alpha=1e6, loss_type="MSE",
                     dtype="bfloat16", use_spectral_norm=True)


def eager_epoch(trainer, state, data):
    """One epoch as ``train_epoch``'s eager loop runs it (the same draws),
    through ``VAETrainer.eager_step`` whatever ``graph_engages`` answers;
    returns the per-step metrics."""
    n, bsz = data.shape[0], trainer.cfg.batch_size
    if n % bsz:
        raise ValueError(f"{n} rows do not make whole batches of {bsz}")
    beta, lr = trainer._schedules(state.epoch)
    perm = trainer.rng.permutation(n).reshape(-1, bsz)
    steps = [trainer.eager_step(state, data, idx, beta, lr) for idx in perm]
    state.epoch += 1
    return steps


def graph_against_eager(cfg, seed: int, data, card) -> dict:
    """Phase 5's graph check. Two trainers from one state and seed: one
    through the eager step (``eager_epoch``), one through ``train_epoch``'s
    graph path (``WARMUP_STEPS`` eager steps, the capture, replays), over
    GRAPH_EPOCHS epochs: each step's loss, and the largest difference of
    every parameter, moment and power-iteration vector after them (must be
    0, or the phase fails). Then, in turns, each side's ms a step over GRAPH_TIMING epochs
    (back to back inside an epoch, a synchronize after it; p50) and its
    launch calls a step in a profiler trace of one epoch, and the capture
    and replay counters."""
    from simulgen_vae_tpu_torch.train import vae_trainer as vt

    eager, graph = (vt.VAETrainer(cfg, device="cuda", seed=seed) for _ in range(2))
    if not graph.graph_engages():
        raise AssertionError("the train configuration does not engage the graph path")
    se, sg = eager.init_state(seed), graph.init_state(seed)
    before = dict(vt.COUNTERS)
    eager_losses, graph_losses = [], []
    for _ in range(GRAPH_EPOCHS):
        eager_losses += [m["loss"].clone() for m in eager_epoch(eager, se, data)]
        per_step = []
        real = graph._apply

        def keep(*a, **k):
            m = real(*a, **k)
            per_step.append(m["loss"].clone())
            return m

        graph._apply = keep
        try:
            sg, _ = graph.train_epoch(sg, data)
        finally:
            del graph._apply
        graph_losses += per_step
    torch.cuda.synchronize()
    eager_losses = [float(v) for v in eager_losses]
    graph_losses = [float(v) for v in graph_losses]
    diff = {}
    pairs = {"parameters": zip(se.model.parameters(), sg.model.parameters()),
             "first moments": ((v, sg.opt_state["mu"][k]) for k, v in se.opt_state["mu"].items()),
             "second moments": ((v, sg.opt_state["nu"][k]) for k, v in se.opt_state["nu"].items()),
             "sn vectors": ((u, sg.sn_u[k]) for k, u in se.sn_u.items())}
    for what, pp in pairs.items():
        diff[what] = max(float((a.detach().float() - b.detach().float()).abs().max())
                         for a, b in pp)
    captured = {k: vt.COUNTERS[k] - before[k] for k in vt.COUNTERS}
    steps = len(graph_losses)
    print(f"graph: {steps} steps eager against the graph path ({vt.WARMUP_STEPS} eager, "
          f"{captured['train.graph_captures']} capture, {captured['train.graph_replays']} "
          f"replays): losses equal {eager_losses == graph_losses} (eager {eager_losses}, "
          f"graph {graph_losses}); largest difference {diff}")
    if captured["train.graph_captures"] != 1 or (captured["train.graph_replays"]
                                                 != steps - vt.WARMUP_STEPS):
        raise AssertionError(f"graph path: {captured} in {steps} steps")
    if not all(math.isfinite(v) for v in graph_losses):
        raise AssertionError(f"non-finite losses on the graph path: {graph_losses}")
    # The replays run the eager step's kernels on the same inputs, so the
    # steps agree bit for bit: a host value the capture froze (the noise
    # seed, beta, lr, a dither word) shows here as a difference.
    if eager_losses != graph_losses or any(v != 0 for v in diff.values()):
        raise AssertionError(f"the graph path differs from the eager step: losses "
                             f"{graph_losses} against {eager_losses}, largest difference {diff}")

    def epoch_ms(run):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    sides = {"eager": lambda: eager_epoch(eager, se, data),
             "graph": lambda: graph.train_epoch(sg, data)}
    per_epoch = len(data) // cfg.batch_size
    ms = {"eager": [], "graph": []}
    for side in ("eager", "graph", "graph", "eager"):
        ms[side] += [epoch_ms(sides[side]) / per_epoch for _ in range(GRAPH_TIMING // 2)]
    launches = {}
    for side, run in sides.items():
        prof, _ = traced(run, cpu=False)
        launches[side] = sum(e.count for e in prof.key_averages()
                             if e.key in LAUNCH_CALLS) / per_epoch
    p50 = {side: float(np.percentile(v, 50)) for side, v in ms.items()}
    print(f"timing: [{card}] train step (batch {cfg.batch_size}, {cfg.dtype}) eager against "
          f"replayed, {GRAPH_TIMING} epochs of {per_epoch} steps a side in turns: p50 "
          f"{p50['eager']:.3f} ms against {p50['graph']:.3f} ms a step "
          f"({p50['eager'] / p50['graph']:.2f}x); launch calls a step {launches['eager']:.1f} "
          f"against {launches['graph']:.1f}; counters {dict(vt.COUNTERS)}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
    return dict(steps=steps, eager_losses=eager_losses, graph_losses=graph_losses,
                losses_equal=eager_losses == graph_losses, max_diff=diff, counters=captured,
                step_ms=ms, step_p50_ms=p50, launch_calls_per_step=launches)


def phase_train(args, card, blocks, gg, ga, gen):
    """Phase 5: the flagship train step. Returns (per-kernel dicts, the loss
    pair's kernel dict, result dict, and the trainer, state and data for the
    phase after it)."""
    from simulgen_vae_tpu_torch.ops import recon_loss as rl
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
    graph = graph_against_eager(cfg, args.seed, data, card)
    torch.cuda.empty_cache()

    # warm-up: two steps; the first (eager) records the GroupNorm shapes of a
    # step, the second is captured as the graph every later step replays: the
    # launches it counts are one step's
    calls = []
    with recording_calls(blocks, calls):
        state, m = trainer.train_epoch(state, data, max_steps=1)
    gg.reset_launch_counts()
    ga.reset_launch_counts()
    rl.reset_launch_counts()
    state, m = trainer.train_epoch(state, data, max_steps=1)
    per_step = {**gg.LAUNCHES, **ga.LAUNCHES, **rl.LAUNCHES}
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

    # the main path: TRAIN_EPOCHS epochs through train_epoch in a profiler
    # trace, every step a replay; its launches are counted in the trace
    from simulgen_vae_tpu_torch.train.vae_trainer import COUNTERS

    replays = COUNTERS["train.graph_replays"]
    losses, norms = [], []

    def main_path():
        nonlocal state
        t0 = time.perf_counter()
        for _ in range(TRAIN_EPOCHS):
            state, m = trainer.train_epoch(state, data)
            losses.append(m["loss"])
            norms.append(m["grad_norm"])
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    prof, run_s = traced(main_path, cpu=False)
    steps = TRAIN_EPOCHS * -(-TRAIN_SAMPLES // B)
    replays = COUNTERS["train.graph_replays"] - replays
    launches = traced_launches(prof, per_step)
    losses, norms = [float(v) for v in losses], [float(v) for v in norms]
    if not all(np.isfinite(losses + norms)):
        raise AssertionError(f"non-finite train metrics: loss {losses}, grad norm {norms}")
    if not all(per_step[k] > 0 for k in per_step):
        raise AssertionError(f"a kernel did not run in the captured step: {per_step}")
    if per_step["gather_augment"] != 1:
        raise AssertionError(f"gather_augment ran {per_step['gather_augment']} times in a step")
    if (per_step["recon_loss_pair_fwd"], per_step["recon_loss_pair_bwd"]) != (1, 1):
        raise AssertionError(f"the loss pair's passes in a step: {per_step}")
    if replays != steps:
        raise AssertionError(f"{replays} graph replays in {steps} steps")
    if launches != {k: n * replays for k, n in per_step.items()}:
        raise AssertionError(f"the {replays} replays launched {launches} (trace), the captured "
                             f"step {per_step}")
    print(f"train: {TRAIN_EPOCHS} epochs = {steps} steps ({replays} replays) in {run_s:.3f} s "
          f"(traced); loss per epoch {losses}, grad norm {norms}; launches in the replays "
          f"(trace) {launches}, in the captured step (counters) {per_step}")

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
    batch = ga.gather_augment(data, rows, rows.flip(0).contiguous(), seed_tensor(5), lam, ones, zero)
    if not torch.equal(batch, ga.gather_augment_reference(data, rows, rows.flip(0), None,
                                                          lam, ones, zero)):
        raise AssertionError("gather_augment batch differs from its plain version")
    checks = {"bfloat16": compare_step(trainer, state, batch, blocks, gg, beta, "bf16",
                                       1e-2, None)}
    fields = {"bfloat16": step_field(state.model, batch)}
    del batch
    trainer32 = VAETrainer(dataclasses.replace(cfg, dtype="float32"), device="cuda",
                           seed=args.seed)
    model32 = trainer32.build_model()
    model32.load_state_dict(state.model.state_dict())
    state32 = dataclasses.replace(state, model=model32, opt_state=None)
    batch32 = ga.gather_augment(data32, rows, rows.flip(0).contiguous(), seed_tensor(5), lam, ones, zero)
    checks["float32"] = compare_step(trainer32, state32, batch32, blocks, gg, beta,
                                     "f32, TF32 off", 1e-4, 1e-3)
    fields["float32"] = step_field(model32, batch32)
    del trainer32, model32, state32, batch32
    torch.cuda.empty_cache()

    # the loss pair on the step's own field and target, then its time
    loss_rel = check_recon_loss(rl, fields)
    recon_kernel = recon_loss_kernel(rl, *fields["bfloat16"], loss_rel, launches, steps,
                                     args.reps, card)
    del fields
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
        if name in ("gn_bwd_onepass", "gn_bwd_stats"):
            k = kernels[-1]
            k.update(device_ms=total("device_ms"), profiled_ms=total("profiled_ms"),
                     library_device_ms=total("library_device_ms"))
            print(f"timing: [{card}] {name} per step ({k['launches_per_step']:.0f} launches at C "
                  f"= {sorted({r['C'] for r in krows})}): {k['ms']:.4f} ms back to back, "
                  f"device only {k['device_ms']:.4f} ms (CUDA graph); library "
                  f"{k['library_ms']:.4f} ms back to back; kernels' own time in a profiler trace "
                  f"{k['profiled_ms']:.4f} ms against the library's "
                  f"{k['library_device_ms']:.4f} ms: below the library call "
                  f"{k['profiled_ms'] < k['library_device_ms']}; bound {k['bound_ms']:.4f} ms")
    result = dict(step_p50_ms=step_p50, step_ms=lat.tolist(),
                  samples_per_s=B / step_p50 * 1e3, steps=steps, epoch_losses=losses,
                  epoch_grad_norms=norms, launches=launches, step_checks=checks,
                  gn_bwd_launches=traces, graph=graph,
                  params=n_params, peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    return kernels, recon_kernel, result, dict(cfg=cfg, trainer=trainer, state=state,
                                               data=data, data32=data32)


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
    from simulgen_vae_tpu_torch.ops.recon_loss import recon_loss_pair

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
    r.update(linear_ms=cuda_ms(lambda: F.linear(k["h"], k["w"], b16), reps))
    print(f"timing: [{card}] fused readout readout_matmul_stats (wgmma + TMA): {r['ms']:.4f} ms "
          f"({flops / r['ms'] / 1e9:.1f} TFLOP/s); F.linear {r['linear_ms']:.4f} ms; below "
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

    def unfused_segment():
        yl = F.linear(k["h"], k["w"], b16).requires_grad_()
        o = gg.group_norm_act(yl, k["scale"], k["nb"], g, act="tanh")
        loss, mse = recon_loss_pair(o, k["x"], "MSE")
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
    # warm-up: an eager step, then the step captured as the graph every later
    # step replays: the launches and GroupNorm calls it counts are one step's
    state, m = trainer.train_epoch(state, data, max_steps=1)
    for mod in (gg, ga, rc):
        mod.reset_launch_counts()
    calls = []
    with recording_calls(blocks, calls):
        state, m = trainer.train_epoch(state, data, max_steps=1)
    per_step = {**gg.LAUNCHES, **ga.LAUNCHES, **rc.LAUNCHES}
    torch.cuda.synchronize()

    # the main path: one epoch through train_epoch in a profiler trace, every
    # step a replay; its launches are counted in the trace
    replays = vt.COUNTERS["train.graph_replays"]

    def main_path():
        t0 = time.perf_counter()
        out = trainer.train_epoch(state, data)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    prof, ((state, m), run_s) = traced(main_path, cpu=False)
    steps = -(-TRAIN_SAMPLES // B)
    replays = vt.COUNTERS["train.graph_replays"] - replays
    if replays != steps:
        raise AssertionError(f"fused path: {replays} graph replays in {steps} steps")
    launches = traced_launches(prof, per_step)
    if launches != {k: n * replays for k, n in per_step.items()}:
        raise AssertionError(f"fused path: the {replays} replays launched {launches} (trace), "
                             f"the captured step {per_step}")
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
    print(f"fused: 1 epoch = {steps} steps ({replays} replays) in {run_s:.3f} s (traced); "
          f"{metrics}; launches in the replays (trace) {launches} (bwd='auto': {flavor}); "
          f"{len(calls)} GroupNorms per step at C = {widths} (none at {READOUT_C})")

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
    batch = ga.gather_augment(data, rows, rows.flip(0).contiguous(), seed_tensor(5), lam, ones, zero)
    checks = {"bfloat16": compare_routes(trainer, state, batch, beta, rc, vt, "bf16",
                                         1e-2, None)}
    del batch
    trainer32 = vt.VAETrainer(dataclasses.replace(cfg, dtype="float32"), device="cuda",
                              seed=args.seed, fused_readout=True)
    model32 = trainer32.build_model()
    model32.load_state_dict(state.model.state_dict())
    state32 = dataclasses.replace(state, model=model32, opt_state=None)
    batch32 = ga.gather_augment(data32, rows, rows.flip(0).contiguous(), seed_tensor(5), lam, ones, zero)
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
    """``n`` steps of one epoch, each from its host draws (the eager path's
    ``assemble_batch``, which draws first, or the graph path's ``_draws``) to
    a synchronise after its optimizer update (ms). The per-epoch power
    iteration, which runs before the first step, is not in any step's time."""
    lat, mark = [], []
    real = {k: getattr(trainer, k) for k in ("assemble_batch", "_draws", "_apply")}

    def start(name):
        def call(*a, **k):
            if len(mark) == len(lat):  # the step's first host work
                torch.cuda.synchronize()
                mark.append(time.perf_counter())
            return real[name](*a, **k)
        return call

    def apply(*a, **k):
        out = real["_apply"](*a, **k)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - mark[-1]) * 1e3)
        return out

    trainer.assemble_batch, trainer._draws = start("assemble_batch"), start("_draws")
    trainer._apply = apply
    try:
        state, _ = trainer.train_epoch(state, data, max_steps=n)
    finally:
        for k in real:
            delattr(trainer, k)
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


GATHER_BATCHES = 3   # batches a turn when timing the host gathers


def stream_gather(host: np.ndarray, seed: int, card: str) -> dict:
    """The streamed epoch's host gather (vae_trainer.gather_rows): one batch
    cast row by row to bf16 into pinned memory, copied to the card, has the
    same bits as the same rows gathered by index_select in f32, copied and
    cast on the card; then the gather's ms a batch, the bf16 row-wise cast
    against index_select f32 (the route before it) into pinned buffers, in
    turns (cast, index_select, index_select, cast)."""
    from simulgen_vae_tpu_torch.train.vae_trainer import gather_rows

    rng = np.random.default_rng(seed)
    host_t = torch.from_numpy(host)
    shape = (B, *host.shape[1:])
    bufs = {torch.bfloat16: torch.empty(shape, dtype=torch.bfloat16, pin_memory=True),
            torch.float32: torch.empty(shape, dtype=torch.float32, pin_memory=True)}
    idx = rng.integers(0, host.shape[0], size=B)
    got = gather_rows(host_t, idx, bufs[torch.bfloat16]).to("cuda")
    want = torch.index_select(host_t, 0, torch.from_numpy(idx)).to("cuda").to(torch.bfloat16)
    same = torch.equal(got.view(torch.int16), want.view(torch.int16))
    del got, want
    print(f"stack: one batch of {B} rows cast row by row to bf16 on the host vs index_select "
          f"in f32 cast on the card: same bits {same} -> {'ok' if same else 'FAIL'}")
    if not same:
        raise AssertionError("the streamed gather's bf16 rows differ from the cast route")
    routes = {"cast_bf16": lambda i: gather_rows(host_t, i, bufs[torch.bfloat16]),
              "index_select_f32": lambda i: torch.index_select(
                  host_t, 0, torch.from_numpy(i), out=bufs[torch.float32])}
    turns = {}
    for name in ("cast_bf16", "index_select_f32", "index_select_f32", "cast_bf16"):
        batches = [rng.integers(0, host.shape[0], size=B) for _ in range(GATHER_BATCHES)]
        t0 = time.perf_counter()
        for i in batches:
            routes[name](i)
        turns.setdefault(name, []).append((time.perf_counter() - t0) * 1e3 / GATHER_BATCHES)
    print(f"timing: [{card}] host gather of a {B}-row batch ({B * host[0].nbytes / 1e9:.2f} "
          f"GB of f32 rows) into pinned memory, in turns: "
          + "; ".join(f"{k} " + " / ".join(f"{v:.1f}" for v in ms) + " ms"
                      for k, ms in turns.items())
          + f" ({torch.get_num_threads()} threads)")
    return dict(same_bits=same, gather_ms=turns, threads=torch.get_num_threads())


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
    batch = ga.gather_augment(data, rows, rows.flip(0).contiguous(), seed_tensor(5), lam, ones, zero)
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
    batch32 = ga.gather_augment(data32, rows, rows.flip(0).contiguous(), seed_tensor(5), lam, ones, zero)
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

    # one streamed epoch from pinned host memory, cast row by row to bf16 there
    host = data.float().cpu().numpy()
    gather = stream_gather(host, args.seed, card)
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
    finite = all(np.isfinite(float(v)) for v in sm.values())
    print(f"timing: [{card}] streamed epoch ({steps} steps, f32 host rows cast row by row "
          f"to bf16 into pinned buffers, partners from the dataset): "
          f"step p50 {stream_p50:.1f} ms, min/max {stream_ms.min():.1f}/{stream_ms.max():.1f} "
          f"ms, loss {float(sm['loss']):.6g}; metrics finite: {finite}")
    if not finite:
        raise AssertionError(f"streamed epoch: non-finite metrics {sm}")

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
                  stream_gather=gather,
                  device_busy_ms=busy, wide_matmuls_in_2_steps=wide_mm, resume_bit_equal=resume_ok, peak_gb=peak_gb)
    return kernels, result


# -- 8. serving from model_save/ ----------------------------------------------

INT8_OPS_PER_S = 1979e12      # H100 SXM dense int8 on the tensor cores
ARTIFACT_ROWS = 40
QUANT_REPLACES = "simulgen_vae_tpu/ops/quant.py:66"   # int8_dot (an XLA dot_general): no Pallas kernel
# Runs a module (its first argument) as ``python -m`` does, then prints the
# process's launch counts and peak device memory.
CLI_RUNNER = """\
import json, runpy, sys
import torch
module = sys.argv.pop(1)
try:
    runpy.run_module(module, run_name="__main__", alter_sys=True)
    code = 0
except SystemExit as e:
    code = e.code
from simulgen_vae_tpu_torch.ops import fused_adamw, gather_augment, groupnorm_gelu, quant
print("launches: " + json.dumps({**groupnorm_gelu.LAUNCHES, **quant.LAUNCHES,
                                 **gather_augment.LAUNCHES, **fused_adamw.LAUNCHES}))
print("peak_bytes: " + str(torch.cuda.max_memory_allocated()))
sys.exit(code)
"""
ARTIFACT_CONDITION = """\
Common params
Dim1\t{rows}
Dim2\t{t}
Dim3\t{nodes}
num_var 1
'
%LSH-VAE parameters
Training_epochs\t{epochs}
Batch_size\t16
LearningR\t0.001
Latent_dim\t{hier}
Latent_dim_end\t{z}
Loss_type\t1
Stretch\t0
alpha\t1000000
Recon_iter\t{recon_iter}
Dim2_red\t{t}
Dim3_start\t0
Dim3_end\t{nodes}
'
%LatentConditioner
num_param\t{n_in}
param_dir\tparams.csv
n_epoch\t{lc_epochs}
latent_conditioner_lr\t0.001
latent_conditioner_batch\t{lc_batch}
input_type\tcsv
param_data_type\t.csv
"""


@contextlib.contextmanager
def torch_defaults():
    """PyTorch's default precision flags (cuDNN convolutions in TF32, matmuls
    in f32), as a process that does not set them, the CLI, runs."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def write_model_save(root: Path, cfg, lc_cfg, n_in: int, seed: int):
    """A complete model_save/ from the port's own writers: random VAE and
    conditioner trees from ``seed`` (the JAX modules' layout), the four
    scalers, condition.txt, preset.txt and a CSV of ARTIFACT_ROWS rows.
    Returns (the VAE tree, the conditioner tree, the scalers)."""
    from simulgen_vae_tpu_torch import convert
    from simulgen_vae_tpu_torch.data.scaler import MinMaxScaler
    from simulgen_vae_tpu_torch.utils.checkpoint import save_flax_model

    rng = np.random.default_rng(seed)
    vae_tree = convert.random_vae_tree(cfg, rng)
    lc_tree = convert.random_conditioner_tree(lc_cfg, cfg, n_in, rng)
    scalers = {name: MinMaxScaler(rng.uniform(0.5, 2.0, n).astype(np.float32),
                                  rng.uniform(-0.3, 0.3, n).astype(np.float32))
               for name, n in (("scaler.pkl", cfg.num_node),
                               ("latent_vectors_scaler.pkl", cfg.latent_dim_end),
                               ("xs_scaler.pkl", cfg.num_hier * cfg.latent_dim),
                               ("latent_conditioner_input_scaler.pkl", n_in))}
    models = root / "model_save"
    save_flax_model(str(models / "SimulGen-VAE"), {"params": vae_tree})
    save_flax_model(str(models / "LatentConditioner"), {"params": lc_tree, "batch_stats": {}})
    for name, scaler in scalers.items():
        scaler.save(str(models / name))
    write_config(root, cfg, lc_cfg, n_in, ARTIFACT_ROWS, rng)
    return vae_tree, lc_tree, scalers


def write_config(root: Path, cfg, lc_cfg, n_in: int, rows: int, rng, epochs: int = 100,
                 recon_iter: int = 1, lc_epochs: int = 500, lc_batch: int = 64) -> None:
    """condition.txt, preset.txt and a CSV of ``rows`` rows of ``n_in``
    design parameters in ``root``."""
    (root / "condition.txt").write_text(ARTIFACT_CONDITION.format(
        rows=rows, t=cfg.num_time, nodes=cfg.num_node, hier=cfg.latent_dim,
        z=cfg.latent_dim_end, n_in=n_in, epochs=epochs, recon_iter=recon_iter,
        lc_epochs=lc_epochs, lc_batch=lc_batch))
    (root / "preset.txt").write_text(
        "data_No, init_beta_divisior, num_filter_enc, latent_conditioner_filter\n1\n0\n"
        + " ".join(map(str, cfg.num_filter_enc)) + "\n"
        + " ".join(map(str, lc_cfg.filters)) + "\n")
    np.savetxt(root / "params.csv", rng.uniform(-2.0, 3.0, (rows, n_in)), delimiter=",")


def run_module(module: str, args: list, cwd: Path, what: str, timeout: int = 600,
               runner: str = CLI_RUNNER):
    """``python -m MODULE ARGS`` through ``runner`` (CLI_RUNNER, or
    IMAGE_RUNNER, which takes its own arguments first) in its own process,
    the package found beside this script: (the completed process, its launch
    counts, its peak device bytes, its seconds). A non-zero exit raises."""
    here = Path(__file__).resolve().parent
    env = dict(os.environ)
    env["PYTHONPATH"] = str(here) + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-c", runner, module, *args], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=timeout)
    seconds = time.perf_counter() - t0
    if run.returncode != 0:
        raise AssertionError(f"{what} failed, exit {run.returncode}:\n"
                             f"{run.stdout[-2000:]}\n{run.stderr[-4000:]}")
    lines = run.stdout.splitlines()
    launches = json.loads(next(ln for ln in lines if ln.startswith("launches: "))[10:])
    peak = int(next(ln for ln in lines if ln.startswith("peak_bytes: "))[12:])
    return run, launches, peak, seconds


def run_cli(root: Path, mode: str, tag: str = "artifacts") -> tuple:
    """``python -m simulgen_vae_tpu_torch.generate --quantize MODE`` on the
    artifacts in ``root``, in its own process: (fields on the card, its launch
    counts, its seconds)."""
    out = root / f"gen_{mode}.npy"
    args = ["--inputs", str(root / "params.csv"), "--out", str(out), "--device", "cuda",
            "--condition", str(root / "condition.txt"),
            "--preset_file", str(root / "preset.txt"), "--model_dir", str(root / "model_save"),
            "--quantize", mode, "--max_batch", str(B)]
    run, launches, _, seconds = run_module("simulgen_vae_tpu_torch.generate", args,
                                           Path(__file__).resolve().parent,
                                           f"the CLI (--quantize {mode})")
    generated = next(ln for ln in run.stdout.splitlines() if "Generated" in ln)
    print(f"{tag}: CLI --quantize {mode}: {generated} in {seconds:.1f} s (its own process); "
          f"launches {launches}")
    fields = torch.from_numpy(np.load(out)).to("cuda")
    out.unlink()
    return fields, launches, seconds


@contextlib.contextmanager
def recording_int8_shapes(quant, shapes: list):
    """Record (M, K, N) of every int8 product while the context is open."""
    real = quant.int8_mm

    def record(a, w):
        shapes.append((a.shape[0], a.shape[1], w.shape[0]))
        return real(a, w)

    quant.int8_mm = record
    try:
        yield
    finally:
        quant.int8_mm = real


def int8_mm_rows(quant, shapes: list, reps: int, gen, card) -> dict:
    """int8_mm against its plain version and torch._int_mm at each shape one
    decode gives it, summed over the decode's calls."""
    rows, worst = [], 0
    for (m, k, n), count in sorted({s: shapes.count(s) for s in set(shapes)}.items()):
        a = torch.randint(-127, 128, (m, k), generator=gen, device="cuda", dtype=torch.int8)
        w = torch.randint(-127, 128, (n, k), generator=gen, device="cuda", dtype=torch.int8)
        err = int((quant.int8_mm(a, w) - quant.int8_mm_reference(a, w)).abs().max())
        worst = max(worst, err)
        # the library call on operands padded as the wrapper pads them (not timed)
        lib_a = F.pad(a, (0, -k % 8, 0, 32 - m if m <= 16 else 0))
        lib_wt = F.pad(w, (0, -k % 8, 0, -n % 8)).t()
        t_bytes = (m * k + n * k + 4 * m * n) / HBM_BYTES_PER_S * 1e3
        t_ops = 2 * m * k * n / INT8_OPS_PER_S * 1e3
        rows.append(dict(M=m, K=k, N=n, per_decode=count,
                         ms=cuda_ms(lambda: quant.int8_mm(a, w), reps),
                         plain_ms=cuda_ms(lambda: quant.int8_mm_reference(a, w),
                                          max(2, reps // 5), warmup=1),
                         library_ms=cuda_ms(lambda: torch._int_mm(lib_a, lib_wt), reps),
                         bound_ms=max(t_bytes, t_ops),
                         bound_by="bytes" if t_bytes >= t_ops else "operations"))
        del a, w, lib_a, lib_wt
    if worst != 0:
        raise AssertionError(f"int8_mm differs from its plain version by {worst}")
    total = {key: sum(r[key] * r["per_decode"] for r in rows)
             for key in ("ms", "plain_ms", "bound_ms", "library_ms")}
    by_bytes = sum(r["bound_ms"] * r["per_decode"] for r in rows if r["bound_by"] == "bytes")
    total["bound_by"] = "bytes" if 2 * by_bytes >= total["bound_ms"] else "operations"
    readout = max(rows, key=lambda r: r["M"] * r["N"] * r["K"])
    print(f"artifacts: [{card}] int8_mm over a decode's {len(shapes)} products at "
          f"{len(rows)} shapes: {total['ms']:.3f} ms (torch._int_mm {total['library_ms']:.3f}, "
          f"plain f64 {total['plain_ms']:.3f}, bound {total['bound_ms']:.3f}); the readout's "
          f"[{readout['M']}, {readout['K']}] x [{readout['K']}, {readout['N']}]: "
          f"{readout['ms']:.3f} ms, bound {readout['bound_ms']:.3f} ({readout['bound_by']}); "
          "every product equal to its plain version")
    return dict(rows=rows, max_abs_err=worst, **total)


def phase_artifacts(args, card, gg, gen):
    """Phase 8: serve the flagship from a model_save/ the port's writers made,
    through the CLI in its own process. Returns (the int8 product's kernel
    dict, the result dict, the CLI's GroupNorm launch counts)."""
    import tempfile

    from simulgen_vae_tpu_torch import generate as tgen
    from simulgen_vae_tpu_torch.config import LCConfig, VAEConfig
    from simulgen_vae_tpu_torch.data.images import read_latent_conditioner_dataset
    from simulgen_vae_tpu_torch.data.scaler import MinMaxScaler
    from simulgen_vae_tpu_torch.ops import quant
    from simulgen_vae_tpu_torch.utils.checkpoint import load_flax_model

    cfg = VAEConfig(num_time=T, num_node=95008, latent_dim_end=32, latent_dim=8,
                    num_filter_enc=[1024, 512, 256, 128], small=True)
    lc_cfg = LCConfig(filters=[32, 64, 128, 256, 512, 1024], input_type="csv")
    n_in = 484
    result = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        vae_tree, lc_tree, scalers = write_model_save(root, cfg, lc_cfg, n_in, args.seed)
        result["write_s"] = time.perf_counter() - t0
        result["model_bytes"] = (root / "model_save" / "SimulGen-VAE").stat().st_size
        print(f"artifacts: model_save/ written in {result['write_s']:.1f} s (SimulGen-VAE "
              f"{result['model_bytes'] / 1e9:.3f} GB)")
        torch.cuda.empty_cache()
        fields, launches, result["cli_s"] = run_cli(root, "none")
        if tuple(fields.shape) != (ARTIFACT_ROWS, T, cfg.num_node) \
                or not bool(fields.isfinite().all()):
            raise AssertionError(f"CLI output {tuple(fields.shape)} or non-finite values")
        if not all(launches[k] > 0 for k in REPLACES):
            raise AssertionError(f"a GroupNorm kernel did not run in the CLI: {launches}")

        # the same trees in memory, the same inputs, under the CLI's flags
        inputs = np.float32(MinMaxScaler.load(
            str(root / "model_save" / "latent_conditioner_input_scaler.pkl")).transform(
            read_latent_conditioner_dataset(str(root / "params.csv"))))
        with torch_defaults():
            pipe = tgen.make_pipeline(
                cfg, lc_cfg, vae_tree, lc_tree, scalers["latent_vectors_scaler.pkl"],
                scalers["xs_scaler.pkl"], scalers["scaler.pkl"], device="cuda",
                dtype=torch.float32)
            want = tgen.generate(pipe, inputs, max_batch=B)
        rel = _rel_l2(fields, want)
        result.update(cli_vs_memory_rel_l2=rel, cli_launches=launches)
        print(f"artifacts: CLI (--quantize none) vs make_pipeline + generate on the same trees "
              f"(f32): rel-L2 {rel:.3g} -> {'ok' if rel <= 1e-6 else 'FAIL'} (at most 1e-6)")
        if rel > 1e-6:
            raise AssertionError("the CLI's output disagrees with the in-memory pipeline")
        del want, pipe, vae_tree, lc_tree
        torch.cuda.empty_cache()

        q_fields, q_launches, result["cli_int8_s"] = run_cli(root, "int8")
        rel = _rel_l2(q_fields, fields)
        result.update(int8_vs_float_rel_l2=rel, cli_int8_launches=q_launches)
        ok = rel <= 0.05 and q_launches["int8_mm"] > 0 and bool(q_fields.isfinite().all())
        print(f"artifacts: CLI --quantize int8 vs float: rel-L2 {rel:.4f} (at most 0.05), "
              f"{q_launches['int8_mm']} int8 products -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("the int8 decode failed its gate or launched no int8 product")

        # the CLI's default: resolve_quantize's answer for an f32 pipeline on
        # the card, then (for int8) the per-model self-check
        a_fields, _, result["cli_auto_s"] = run_cli(root, "auto")
        serves = ("int8" if tgen.resolve_quantize("auto", "cuda", torch.float32) == "int8"
                  and rel <= 0.05 else "none")
        rel = _rel_l2(a_fields, q_fields if serves == "int8" else fields)
        result.update(cli_auto_serves=serves, cli_auto_rel_l2=rel)
        print(f"artifacts: CLI default (--quantize auto) against --quantize {serves}: rel-L2 "
              f"{rel:.3g} -> {'ok' if rel <= 1e-6 else 'FAIL'} (at most 1e-6)")
        if rel > 1e-6:
            raise AssertionError("the CLI's default quantize mode serves another decode")
        del fields, q_fields, a_fields
        torch.cuda.empty_cache()

        # load time, then the batch-16 decode in four modes, in turns
        pipes = {}
        with torch_defaults():
            for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                pipes[name] = tgen.load_pipeline(
                    str(root / "condition.txt"), str(root / "preset.txt"),
                    model_dir=str(root / "model_save"), device="cuda", dtype=dtype)
                torch.cuda.synchronize()
                result[f"load_{name}_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            for name in ("SimulGen-VAE", "LatentConditioner"):
                load_flax_model(str(root / "model_save" / name))
            result["read_parse_s"] = time.perf_counter() - t0
            print(f"artifacts: load_pipeline {result['load_f32_s']:.2f} s (f32), "
                  f"{result['load_bf16_s']:.2f} s (bf16), from disk to the card; reading and "
                  f"parsing the two model files alone {result['read_parse_s']:.2f} s")
            batch = torch.as_tensor(inputs[:B], device="cuda")
            fns = {"f32": tgen.make_generate_fn(pipes["f32"], max_batch=B),
                   "bf16": tgen.make_generate_fn(pipes["bf16"], max_batch=B),
                   "int8_f32": tgen.make_generate_fn(pipes["f32"], max_batch=B, quantize="int8"),
                   "int8_bf16": tgen.make_generate_fn(pipes["bf16"], max_batch=B,
                                                      quantize="int8")}
            shapes = []
            with recording_int8_shapes(quant, shapes):
                fns["int8_bf16"](batch)
            bf16_gap = _rel_l2(fns["int8_bf16"](batch), fns["bf16"](batch))
            order = list(fns) + list(fns)[::-1]
            turns = {}
            for mode in order:
                fn = fns[mode]
                for _ in range(2):
                    fn(batch)
                torch.cuda.synchronize()
                lat = []
                for _ in range(10):
                    t0 = time.perf_counter()
                    fn(batch)
                    torch.cuda.synchronize()
                    lat.append((time.perf_counter() - t0) * 1e3)
                dev = decode_device(fn, batch, calls=2)
                turns.setdefault(mode, []).append(dict(p50_ms=float(np.percentile(lat, 50)),
                                                       **dev))
            for mode, runs in turns.items():
                print(f"artifacts: [{card}] batch-16 decode {mode}: p50 " + " / ".join(
                    f"{r['p50_ms']:.3f}" for r in runs) + " ms, device " + " / ".join(
                    f"{r['device_ms']:.3f}" for r in runs) + f" ms, "
                    f"{runs[0]['kernels']:.0f} kernels a decode (turns in order {order})")
            result.update(decode=turns, int8_bf16_vs_bf16_rel_l2=bf16_gap,
                          int8_products_per_decode=len(shapes))
        mm = int8_mm_rows(quant, shapes, args.reps, gen, card)
    del pipes, fns, batch
    torch.cuda.empty_cache()
    faster = {dt: min(r["p50_ms"] for r in turns[f"int8_{dt}"])
              < min(r["p50_ms"] for r in turns[dt]) for dt in ("f32", "bf16")}
    rule = {dt: tgen.resolve_quantize("auto", "cuda", dtype) == "int8"
            for dt, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16))}
    result.update(int8_faster_than_float=faster, auto_answers_int8=rule)
    print(f"artifacts: int8 decode faster than the float decode of its dtype (best p50): "
          f"{faster}; resolve_quantize('auto') answers int8 for {rule}: agrees with this "
          f"run: {rule == faster}; int8 vs bf16 decode rel-L2 {bf16_gap:.4f}")
    kernel = dict(
        name="int8_mm", route="cuda", source="simulgen_vae_tpu_torch/ops/quant.py",
        replaces=QUANT_REPLACES, library="torch._int_mm (cuBLASLt int8)",
        launches=q_launches["int8_mm"], launches_per_decode=len(shapes),
        max_abs_err=mm["max_abs_err"], ms=mm["ms"], plain_ms=mm["plain_ms"],
        bound_ms=mm["bound_ms"], bound_by=mm["bound_by"], library_ms=mm["library_ms"], per_decode_sum=True, card=card, shapes=mm["rows"])
    return kernel, result, launches


# -- phase 9: the training CLI ---------------------------------------------------

CLI_SAMPLES, CLI_EPOCHS, CLI_LC_EPOCHS, CLI_LC_ONLY_EPOCHS = 32, 2, 30, 5
CLI_TRAIN_KERNELS = ("gather_augment", "gn_act_onepass", "gn_stats", "gn_apply",
                     "gn_bwd_onepass", "gn_bwd_stats", "gn_bwd_apply", "fused_adamw")
CLI_MODEL_SAVE = ("SimulGen-VAE", "LatentConditioner", "scaler.pkl", "latent_vectors.npy",
                  "xs.npy", "latent_vectors_scaler.pkl", "xs_scaler.pkl",
                  "latent_conditioner_input_scaler.pkl")
# Written to the work directory: the dataset (2.43 GB), two VAE checkpoints
# (parameters and both AdamW moments in f32, 4.84 GB each), the model
# (1.61 GB), the generated fields (2.43 GB a serve) and, in phase 10, the
# fields served from 16 images (1.22 GB).
CLI_DISK_BYTES = 18e9
EPOCH_LINE = re.compile(r"^(\S+ \S+) - INFO - \[Epoch (\d+)/(\d+)\] Loss: (\S+) .* "
                        r"Time: ([\d.]+)s", re.M)


def write_dataset(path: Path, p: int, t: int, n: int, seed: int) -> float:
    """``dataset1.pickle``: a [p, t, n] f32 ensemble of traveling waves (three
    modes whose wavenumber, speed, amplitude and damping follow the parameter,
    as ``data.dataset.synthetic_dataset``'s) plus noise of std 0.01, made on
    the card from ``seed`` one sample at a time into a host array (no f64
    [p, t, n] array). Returns the seconds it took."""
    t0 = time.perf_counter()
    gen = torch.Generator("cuda").manual_seed(seed)
    x = torch.linspace(0.0, 1.0, n, device="cuda")
    tt = torch.linspace(0.0, 1.0, t, device="cuda")[:, None]
    data = np.empty((p, t, n), np.float32)
    for i, pv in enumerate(np.linspace(0.0, 1.0, p)):
        field = 0.01 * torch.randn((t, n), generator=gen, device="cuda")
        for mode in (1, 2, 3):
            k = 2 * np.pi * (mode + 2.0 * pv)
            amp = np.exp(-0.5 * mode) * (0.5 + 0.5 * pv)
            damp = torch.exp(-2.0 * pv * tt)
            field += amp * damp * torch.sin(k * (x - (0.5 + pv) * tt))
        data[i] = field.cpu().numpy()
    with open(path, "wb") as f:
        pickle.dump(data, f, protocol=4)
    return time.perf_counter() - t0


def _epoch_lines(text: str, total: int) -> list:
    """(loss, seconds, when logged as a Unix time) of each logged epoch of a
    stage of ``total`` epochs."""
    import datetime

    def when(stamp: str) -> float:
        return datetime.datetime.strptime(stamp, "%Y-%m-%d %H:%M:%S,%f").timestamp()

    return [(float(m.group(4)), float(m.group(5)), when(m.group(1)))
            for m in EPOCH_LINE.finditer(text) if int(m.group(3)) == total]


def _work_dir():
    """A temporary directory with room for phases 9 and 10, under TMPDIR or, where
    that is too small, beside this script (git-ignored ``_scratch/``)."""
    import shutil
    import tempfile

    for base in (tempfile.gettempdir(), str(Path(__file__).resolve().parent / "_scratch")):
        os.makedirs(base, exist_ok=True)
        free = shutil.disk_usage(base).free
        if free >= CLI_DISK_BYTES:
            return tempfile.TemporaryDirectory(dir=base), base, free
    raise AssertionError(f"phases 9-10 need {CLI_DISK_BYTES / 1e9:.0f} GB of disk; "
                         f"{base} has {free / 1e9:.1f} GB free")


def phase_cli_train(args, card, root: Path, base: str, free: int):
    """Phase 9: train the flagship geometry through the training CLI in its
    own process in the work directory ``root``, check its artifacts, rerun
    the conditioner alone, and serve the trained model through the generate
    CLI. Returns (the training process's launch counts, the result dict)."""
    from simulgen_vae_tpu_torch import generate as tgen
    from simulgen_vae_tpu_torch.config import LCConfig, VAEConfig
    from simulgen_vae_tpu_torch.data.images import read_latent_conditioner_dataset
    from simulgen_vae_tpu_torch.data.scaler import MinMaxScaler

    cfg = VAEConfig(num_time=T, num_node=READOUT_C, latent_dim_end=32, latent_dim=8,
                    num_filter_enc=[1024, 512, 256, 128], small=True)
    lc_cfg = LCConfig(filters=[32, 64, 128, 256, 512, 1024], input_type="csv")
    n_in = 484
    result = {}
    result["dataset_s"] = write_dataset(root / "dataset1.pickle", CLI_SAMPLES, T,
                                        cfg.num_node, args.seed)
    write_config(root, cfg, lc_cfg, n_in, CLI_SAMPLES, np.random.default_rng(args.seed),
                 epochs=CLI_EPOCHS, recon_iter=2, lc_epochs=CLI_LC_EPOCHS, lc_batch=B)
    print(f"cli-train: work directory under {base} ({free / 1e9:.0f} GB free); dataset "
          f"({CLI_SAMPLES}, {T}, {cfg.num_node}) f32 written in {result['dataset_s']:.1f} s")
    torch.cuda.empty_cache()
    common = ["--preset=1", "--plot=2", "--size=small", "--dtype", "bfloat16",
              "--condition", "condition.txt", "--device", "cuda"]
    started = time.time()
    run, launches, peak, seconds = run_module(
        "simulgen_vae_tpu_torch",
        [*common, "--lc_only=0", "--epochs", str(CLI_EPOCHS),
         "--lc_epochs", str(CLI_LC_EPOCHS)], root, "the training CLI", timeout=900)
    ended = time.time()
    (OUT_DIR / "chip_smoke_cli_train.log").write_text(run.stdout + "\n" + run.stderr)
    vae, lc = _epoch_lines(run.stderr, CLI_EPOCHS), _epoch_lines(run.stderr, CLI_LC_EPOCHS)
    if len(vae) != CLI_EPOCHS or len(lc) != CLI_LC_EPOCHS:
        raise AssertionError(f"{len(vae)} VAE and {len(lc)} LC epoch lines logged")
    # the stages between the log lines' stamps (millisecond clock of this host)
    stages = {"start to the first VAE epoch logged": vae[0][2] - started,
              "the other VAE epochs, checkpoints between": vae[-1][2] - vae[0][2],
              "VAE checkpoint, model file, latent extraction, LC set-up":
                  lc[0][2] - vae[-1][2],
              "the other LC epochs": lc[-1][2] - lc[0][2],
              "LC model file, comparison, exit": ended - lc[-1][2]}
    result.update(train_s=seconds, train_peak_bytes=peak, launches=launches,
                  vae_epoch_s=[e[1] for e in vae], lc_epoch_s=[e[1] for e in lc],
                  lc_loss_first=lc[0][0], lc_loss_last=lc[-1][0], stages_s=stages)
    print(f"cli-train: [{card}] python -m simulgen_vae_tpu_torch --dtype bfloat16 --epochs "
          f"{CLI_EPOCHS} --lc_epochs {CLI_LC_EPOCHS}: exit 0 in {seconds:.1f} s (its own "
          f"process), peak device memory {peak / 2**30:.2f} GiB; VAE epochs "
          + ", ".join(f"{e[1]:.2f}" for e in vae) + f" s; LC epochs: first {lc[0][1]:.3f} "
          f"s, the rest {sum(e[1] for e in lc[1:]):.3f} s in all; LC train loss first "
          f"{lc[0][0]} -> last {lc[-1][0]}; launches "
          f"{ {k: launches[k] for k in CLI_TRAIN_KERNELS} }")
    print(f"cli-train: [{card}] stages (s, from the log's stamps): "
          + "; ".join(f"{k} {v:.1f}" for k, v in stages.items()))
    missing = [k for k in CLI_TRAIN_KERNELS if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels of the training path never launched: {missing}")

    models = root / "model_save"
    if sorted(os.listdir(models)) != sorted(CLI_MODEL_SAVE):
        raise AssertionError(f"model_save/ holds {sorted(os.listdir(models))}")
    lv, xs = np.load(models / "latent_vectors.npy"), np.load(models / "xs.npy")
    l2 = np.loadtxt(root / "SimulGen-VAE_L2_loss.txt")
    ok = (lv.shape == (CLI_SAMPLES, 32) and xs.shape == (CLI_SAMPLES, 3, 8)
          and l2.shape == (CLI_SAMPLES,) and all(np.isfinite(a).all() for a in (lv, xs, l2)))
    result.update(l2_mean=float(l2.mean()), model_bytes=(models / "SimulGen-VAE").stat().st_size)
    print(f"cli-train: model_save/ holds the eight artifacts; latent_vectors {lv.shape}, "
          f"xs {xs.shape}, {l2.shape[0]} L2 lines (mean MSE {l2.mean():.4g}) -> "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the training CLI's artifacts have wrong shapes or values")

    run, _, peak2, seconds = run_module(
        "simulgen_vae_tpu_torch",
        [*common, "--lc_only=1", "--lc_epochs", str(CLI_LC_ONLY_EPOCHS)], root,
        "the training CLI (--lc_only=1)", timeout=900)
    lc2 = _epoch_lines(run.stderr, CLI_LC_ONLY_EPOCHS)
    result.update(lc_only_s=seconds, lc_only_peak_bytes=peak2)
    print(f"cli-train: [{card}] --lc_only=1 --lc_epochs {CLI_LC_ONLY_EPOCHS}: exit 0 in "
          f"{seconds:.1f} s (its own process), {len(lc2)} LC epochs logged, peak "
          f"{peak2 / 2**30:.2f} GiB")

    torch.cuda.empty_cache()
    fields, serve_launches, result["serve_s"] = run_cli(root, "none", "cli-train")
    if tuple(fields.shape) != (CLI_SAMPLES, T, cfg.num_node) \
            or not bool(fields.isfinite().all()):
        raise AssertionError(f"served {tuple(fields.shape)} or non-finite values")
    inputs = np.float32(MinMaxScaler.load(
        str(models / "latent_conditioner_input_scaler.pkl")).transform(
        read_latent_conditioner_dataset(str(root / "params.csv"))))
    with torch_defaults():
        pipe = tgen.load_pipeline(str(root / "condition.txt"), str(root / "preset.txt"),
                                  model_dir=str(models), device="cuda", dtype=torch.float32)
        want = tgen.generate(pipe, inputs, max_batch=B)
    rel = _rel_l2(fields, want)
    result.update(serve_vs_memory_rel_l2=rel, serve_launches=serve_launches)
    print(f"cli-train: the trained model served by the generate CLI (--quantize none) vs "
          f"load_pipeline + generate here: rel-L2 {rel:.3g} -> "
          f"{'ok' if rel <= 1e-6 else 'FAIL'} (at most 1e-6)")
    if rel > 1e-6:
        raise AssertionError("the served trained model disagrees with the in-memory pipeline")
    del want, pipe
    torch.cuda.empty_cache()
    q_fields, _, result["serve_int8_s"] = run_cli(root, "int8", "cli-train")
    result["int8_vs_float_rel_l2"] = _rel_l2(q_fields, fields)
    print(f"cli-train: int8 against float on the trained weights: rel-L2 "
          f"{result['int8_vs_float_rel_l2']:.4f} (printed, not gated)")
    del fields, q_fields
    torch.cuda.empty_cache()
    return launches, result


# -- phase 10: the image conditioners ------------------------------------------

IMAGE_SIDE = 256
IMAGE_E2E_EPOCHS, IMAGE_LC_EPOCHS = 8, 16
IMAGE_KERNELS = ("gn_act_onepass", "gn_stats", "gn_apply", "gn_bwd_onepass", "gn_bwd_stats",
                 "gn_bwd_apply", "fused_adamw")
# The shipped input_data/condition.txt's conditioner and E2E settings, added
# to phase 9's condition file (its geometry, latents and dataset).
IMAGE_CONDITION_EXTRA = """\
latent_conditioner_weight_decay\t1e-5
latent_conditioner_dropout_rate\t0.2
use_spatial_attention\t1
'
%End-to-End Training Configuration
use_e2e_training\t{e2e}
e2e_loss_function\tHuber
e2e_vae_model_path\tmodel_save/SimulGen-VAE
use_latent_regularization\t1
LC_alpha\t1000
latent_reg_weight\t0.001
"""
# Runs the training CLI (argv after the module: seed, images, where to save
# the served fields, then the CLI's arguments) with the image reader replaced
# by seeded_images, keeping the conditioner tree handed to save_flax_model and
# what E2ETrainer.fit was given and returned; prints the launch counts and
# peak memory of the run, then serves the first B images through
# make_pipeline on that in-memory tree in f32 (TF32 off) and, after E2E
# training, holds its loss and gradients through the GroupNorm kernels against
# the plain version (e2e_routes).
IMAGE_RUNNER = """\
import json, os, runpy, sys
import numpy as np
import torch
import chip_smoke
from simulgen_vae_tpu_torch import cli
from simulgen_vae_tpu_torch.data import images
module = sys.argv.pop(1)
seed, count, served = int(sys.argv.pop(1)), int(sys.argv.pop(1)), sys.argv.pop(1)
pixels = chip_smoke.seeded_images(count, seed)
images.read_latent_conditioner_dataset_img = lambda *a, **k: (pixels, (256, 256))
print(f"images: data.images.read_latent_conditioner_dataset_img replaced by {count} "
      f"binary {chip_smoke.IMAGE_SIDE}x{chip_smoke.IMAGE_SIDE} images made from seed {seed} "
      "(no OpenCV on this machine)")
kept, fitted = {}, []
save = cli.save_flax_model
def keep(path, tree):
    kept[os.path.basename(path)] = tree
    save(path, tree)
cli.save_flax_model = keep
fit = cli.E2ETrainer.fit
def keep_fit(self, *a, **k):
    out = fit(self, *a, **k)
    fitted.append((self, a[:4], out[0]))
    return out
cli.E2ETrainer.fit = keep_fit
try:
    runpy.run_module(module, run_name="__main__", alter_sys=True)
    code = 0
except SystemExit as e:
    code = e.code
from simulgen_vae_tpu_torch.ops import fused_adamw, gather_augment, groupnorm_gelu, quant
print("launches: " + json.dumps({**groupnorm_gelu.LAUNCHES, **quant.LAUNCHES,
                                 **gather_augment.LAUNCHES, **fused_adamw.LAUNCHES}))
print("peak_bytes: " + str(torch.cuda.max_memory_allocated()))
if code == 0:
    from simulgen_vae_tpu_torch import generate as tgen
    from simulgen_vae_tpu_torch.config import (LCConfig, VAEConfig, parse_condition_file,
                                               parse_training_parameters, read_preset)
    from simulgen_vae_tpu_torch.data.scaler import MinMaxScaler
    from simulgen_vae_tpu_torch.utils.checkpoint import load_flax_model
    args = cli.build_parser().parse_args(sys.argv[1:])
    raw = parse_training_parameters(parse_condition_file(args.condition))
    _, _, enc, lc_filter = read_preset(args.preset_file)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    tree = kept["LatentConditioner"]
    pipe = tgen.make_pipeline(
        VAEConfig.from_condition(raw, enc), LCConfig.from_condition(raw, lc_filter),
        load_flax_model("model_save/SimulGen-VAE")["params"], tree["params"],
        *(MinMaxScaler.load(f"model_save/{n}") for n in
          ("latent_vectors_scaler.pkl", "xs_scaler.pkl", "scaler.pkl")),
        device="cuda", dtype=torch.float32, lc_batch_stats=tree["batch_stats"])
    b = chip_smoke.B
    np.save(served, tgen.generate(pipe, np.float32(pixels[:b] / 255.0), max_batch=b).cpu().numpy())
    if fitted:
        print("e2e_routes: " + json.dumps(chip_smoke.e2e_routes(*fitted[0])))
sys.exit(code)
"""
def _grads_close(have: dict, want: dict, tol: float) -> tuple:
    """(ok, worst): every gradient within rel-L2 ``tol`` of its own norm or,
    where it cancels to noise (a bias before a training-mode BatchNorm: norm
    under 1e-4 of the whole gradient's), within ``tol * 1e-2`` of the whole
    gradient's norm; ``worst`` its largest rel-L2 among the others."""
    total = math.sqrt(sum(float(g.double().square().sum()) for g in want.values()))
    ok, worst = True, 0.0
    for k, g in want.items():
        err = float(torch.linalg.vector_norm((have[k] - g).double()))
        size = float(torch.linalg.vector_norm(g.double()))
        if size <= 1e-4 * total:
            ok &= err <= tol * 1e-2 * total
        else:
            worst = max(worst, err / size)
            ok &= err <= tol * size
    return ok, worst


def e2e_routes(trainer, arrays, state) -> dict:
    """The E2E loss and the conditioner's gradients through the GroupNorm
    kernels (#2-#7) and through their plain version (plain_group_norm) on the
    card, at the batch sizes E2ETrainer.fit gives the decoder: a training
    batch of min(batch, n_train) rows (its noise, dropout masks and decode
    noise the same for both routes) forward and backward into z and xs, and a
    validation batch of min(batch, n_val) rows forward in eval mode. In the
    decoder's trained dtype (bf16: each loss within 1e-2 relative, the whole
    gradient within rel-L2 1e-2) and in f32 with TF32 off (each loss 1e-4,
    every gradient rel-L2 1e-3 as _grads_close says). Raises on a miss; leaves
    the trainer and the state as it found them. These launches are not the
    main path's: the caller reads the counts before."""
    from simulgen_vae_tpu_torch.models import blocks
    from simulgen_vae_tpu_torch.ops import groupnorm_gelu as gg
    from simulgen_vae_tpu_torch.train.lc_trainer import forward_model

    n = arrays[0].shape[0]
    n_val = int(n * 0.3)  # fit's default hold-out
    b_train, b_val = min(trainer.batch_size, n - n_val), min(trainer.batch_size, n_val)

    def rows(b):
        return [torch.from_numpy(np.float32(a[:b])).to("cuda") for a in arrays]

    found = trainer.generator.get_state()
    train = trainer._augment(*rows(b_train))
    val = rows(b_val)
    model, trained_dtype = state.model, trainer.vae_dtype
    gen_state = trainer.generator.get_state()
    buffers = {k: b.clone() for k, b in model.named_buffers()}
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    out = {"train_rows": b_train, "val_rows": b_val}
    try:
        for dtype, loss_tol, grad_tol in ((trained_dtype, 1e-2, None),
                                          (torch.float32, 1e-4, 1e-3)):
            blocks.set_compute_dtype(trainer.vae, dtype)
            trainer.vae_dtype = dtype
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
            got = {}
            for route in ("kernels", "plain"):
                with torch.no_grad():
                    for k, b in model.named_buffers():
                        b.copy_(buffers[k])
                for p in model.parameters():
                    p.grad = None
                trainer.generator.set_state(gen_state)
                ctx = plain_group_norm(blocks, gg) if route == "plain" else contextlib.nullcontext()
                with ctx:
                    with torch.no_grad():
                        val_loss, _ = trainer.loss_fn(
                            forward_model(state, trainer.sn_filter, update=False), *val)
                    loss, _ = trainer.loss_fn(forward_model(state, trainer.sn_filter, update=True),
                                              *train, torch.Generator("cuda").manual_seed(7))
                    loss.backward()
                got[route] = (float(loss), float(val_loss),
                              {k: torch.zeros_like(p) if p.grad is None else p.grad.clone()
                               for k, p in model.named_parameters()})
            (lk, vk, gk), (lp, vp, gp) = got["kernels"], got["plain"]
            loss_rel, val_rel = abs(lk - lp) / abs(lp), abs(vk - vp) / abs(vp)
            whole = math.sqrt(sum(float((gk[k] - gp[k]).double().square().sum()) for k in gk)
                              / sum(float(g.double().square().sum()) for g in gp.values()))
            grads_ok, worst = _grads_close(gk, gp, grad_tol or 1.0)
            ok = (loss_rel <= loss_tol and val_rel <= loss_tol
                  and (grads_ok if grad_tol else whole <= 1e-2))
            label = "bf16" if dtype == torch.bfloat16 else "f32"
            out[label] = dict(loss_kernels=lk, loss_plain=lp, loss_rel=loss_rel,
                              val_loss_kernels=vk, val_loss_plain=vp, val_loss_rel=val_rel,
                              grad_rel_l2=whole, worst_grad_rel_l2=worst, ok=bool(ok))
            print(f"images: E2E kernels vs plain GroupNorm, {label}, {b_train} training rows "
                  f"(loss and gradients) and {b_val} validation rows: loss {lk:.7g} vs {lp:.7g} "
                  f"(rel {loss_rel:.3g}), validation {vk:.7g} vs {vp:.7g} (rel {val_rel:.3g}), "
                  f"whole gradient rel-L2 {whole:.3g}, worst tensor {worst:.3g} -> "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                raise AssertionError(f"E2E kernel and plain routes disagree ({label})")
            del got, gk, gp
    finally:
        blocks.set_compute_dtype(trainer.vae, trained_dtype)
        trainer.vae_dtype = trained_dtype
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
        trainer.generator.set_state(found)
        with torch.no_grad():
            for k, b in model.named_buffers():
                b.copy_(buffers[k])
        for p in model.parameters():
            p.grad = None
    return out


def seeded_images(n: int, seed: int) -> np.ndarray:
    """``n`` binary ``IMAGE_SIDE``-square outlines (one to three filled
    ellipses each) from ``seed``, as the image reader returns them:
    ``[n, side^2]`` f64 of 0 / 255."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:IMAGE_SIDE, :IMAGE_SIDE]
    out = np.zeros((n, IMAGE_SIDE, IMAGE_SIDE))
    for i in range(n):
        for _ in range(rng.integers(1, 4)):
            cy, cx = rng.uniform(0.2, 0.8, 2) * IMAGE_SIDE
            ry, rx = rng.uniform(0.08, 0.3, 2) * IMAGE_SIDE
            out[i][((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1.0] = 255.0
    return out.reshape(n, -1)


def run_image_cli(root: Path, kind: str, e2e: bool, epochs: int, seed: int, common: list):
    """The training CLI with ``--lc_only=1`` on ``kind`` images (IMAGE_RUNNER)
    in its own process: (the completed process, its launch counts, its peak
    bytes, its seconds, the served fields on the card, its stages)."""
    text = (root / "condition.txt").read_text()
    for old, new in (("input_type\tcsv", f"input_type\t{kind}"),
                     ("param_dir\tparams.csv", "param_dir\t/images"),
                     ("param_data_type\t.csv", "param_data_type\t.png"),
                     (f"latent_conditioner_batch\t{B}", "latent_conditioner_batch\t64")):
        if old not in text:
            raise AssertionError(f"phase 9's condition file lacks {old!r}")
        text = text.replace(old, new)
    condition = root / f"condition_{kind}.txt"
    condition.write_text(text + IMAGE_CONDITION_EXTRA.format(e2e=int(e2e)))
    import shutil

    shutil.rmtree(root / "checkpoints" / "latent_conditioner", ignore_errors=True)
    served = root / f"served_{kind}.npy"
    args = [str(seed), str(CLI_SAMPLES), str(served),
            *common, "--condition", condition.name, "--lc_only=1", "--lc_epochs", str(epochs)]
    started = time.time()
    run, launches, peak, seconds = run_module("simulgen_vae_tpu_torch", args, root,
                                              f"the training CLI on {kind} images",
                                              timeout=900, runner=IMAGE_RUNNER)
    (OUT_DIR / f"chip_smoke_images_{kind}.log").write_text(run.stdout + "\n" + run.stderr)
    print(next(ln for ln in run.stdout.splitlines() if ln.startswith("images: ")))
    epochs_logged = _epoch_lines(run.stderr, epochs)
    if len(epochs_logged) != epochs:
        raise AssertionError(f"{len(epochs_logged)} of {epochs} {kind} epochs logged")
    stages = {"start to the first LC epoch logged": epochs_logged[0][2] - started,
              "the other LC epochs": epochs_logged[-1][2] - epochs_logged[0][2],
              "LC model file, comparison, serving the kept tree, exit":
                  time.time() - epochs_logged[-1][2]}
    fields = torch.from_numpy(np.load(served)).to("cuda")
    served.unlink()
    return run, launches, peak, seconds, fields, epochs_logged, stages


def _image_pipeline(root: Path, kind: str, tgen):
    return tgen.load_pipeline(str(root / f"condition_{kind}.txt"), str(root / "preset.txt"),
                              model_dir=str(root / "model_save"), device="cuda",
                              dtype=torch.float32)


def sn_gap(root: Path, kind: str, cfg_geometry) -> dict:
    """The trained CNN's served output (raw kernels, as the files hold them)
    against its forward through W / sigma from the stored u (the state the
    training normalised), on the same checkpoint: rel-L2 of each output."""
    from simulgen_vae_tpu_torch import convert
    from simulgen_vae_tpu_torch.config import (LCConfig, parse_condition_file,
                                               parse_training_parameters, read_preset)
    from simulgen_vae_tpu_torch.models.conditioner_cnn import sn_filter
    from simulgen_vae_tpu_torch.train.lc_trainer import LCTrainer
    from simulgen_vae_tpu_torch.utils.checkpoint import CheckpointManager

    raw = parse_training_parameters(parse_condition_file(str(root / f"condition_{kind}.txt")))
    lc_cfg = LCConfig.from_condition(raw, read_preset(str(root / "preset.txt"))[3])
    trainer = LCTrainer(convert.image_conditioner(lc_cfg, cfg_geometry, "cuda"), 1, 1e-3, B,
                        device="cuda", sn_filter=sn_filter)
    manager = CheckpointManager(str(root / "checkpoints" / "latent_conditioner"))
    state = manager.restore(trainer.init_state())
    x = torch.from_numpy(np.float32(seeded_images(B, 0) / 255.0)).to("cuda")
    with torch.no_grad():
        served = state.model(x)
    normed = trainer.predict_fn(state)(x)
    return {"epoch": int(state.epoch), "main_rel_l2": _rel_l2(served[0], normed[0]),
            "hier_rel_l2": _rel_l2(served[1], normed[1])}


def phase_images(args, card, root: Path) -> tuple:
    """Phase 10: the image conditioners at the flagship widths on phase 9's
    trained VAE, latents and dataset (its work directory ``root``): the
    shipped configuration (CNN, E2E through the frozen decoder), then the
    ViT through LCTrainer with augmentation, each by the training CLI with
    --lc_only=1; each trained model_save/ served. Returns (the E2E process's
    launch counts, the ViT process's, the result dict)."""
    from simulgen_vae_tpu_torch import convert
    from simulgen_vae_tpu_torch import generate as tgen
    from simulgen_vae_tpu_torch.config import VAEConfig
    from simulgen_vae_tpu_torch.data.images import read_latent_conditioner_dataset
    from simulgen_vae_tpu_torch.utils.checkpoint import load_flax_model

    cfg = VAEConfig(num_time=T, num_node=READOUT_C, latent_dim_end=32, latent_dim=8,
                    num_filter_enc=[1024, 512, 256, 128], small=True)
    common = ["--preset=1", "--plot=2", "--size=small", "--dtype", "bfloat16", "--device", "cuda"]
    models = root / "model_save"
    result, launches, pipes = {}, {}, {}
    t_phase = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    # phase 9's CSV pipeline, before the image runs overwrite its conditioner
    pipes["csv"] = tgen.load_pipeline(str(root / "condition.txt"), str(root / "preset.txt"),
                                      model_dir=str(models), device="cuda",
                                      dtype=torch.float32)
    csv_inputs = np.float32(pipes["csv"]["input_scaler"].transform(
        read_latent_conditioner_dataset(str(root / "params.csv"))))[:B]
    pixels = np.float32(seeded_images(CLI_SAMPLES, args.seed) / 255.0)
    lv_before = np.load(models / "latent_vectors.npy")
    for kind, e2e, epochs in (("image", True, IMAGE_E2E_EPOCHS),
                              ("image_vit", False, IMAGE_LC_EPOCHS)):
        tag = f"{kind} ({'E2E' if e2e else 'LCTrainer'})"
        written = (models / "LatentConditioner").stat().st_mtime_ns
        torch.cuda.empty_cache()
        run, counts, peak, seconds, served, logged, stages = run_image_cli(
            root, kind, e2e, epochs, args.seed, common)
        launches[kind] = counts
        losses = [e[0] for e in logged]
        r = dict(cli_s=seconds, peak_bytes=peak, epoch_s=[e[1] for e in logged],
                 loss_first=losses[0], loss_last=losses[-1], stages_s=stages,
                 launches={k: counts[k] for k in IMAGE_KERNELS})
        print(f"images: [{card}] {tag}: python -m simulgen_vae_tpu_torch --lc_only=1 "
              f"--lc_epochs {epochs}: exit 0 in {seconds:.1f} s (its own process), peak "
              f"device memory {peak / 2**30:.2f} GiB; epochs (1 step each, then the "
              "validation) " + ", ".join(f"{e:.3f}" for e in r["epoch_s"])
              + f" s; train loss {losses[0]} -> {losses[-1]}; launches {r['launches']}")
        print(f"images: [{card}] {tag} stages (s, from the log's stamps): "
              + "; ".join(f"{k} {v:.1f}" for k, v in stages.items()))
        lv, xs = np.load(models / "latent_vectors.npy"), np.load(models / "xs.npy")
        ok = (sorted(os.listdir(models)) == sorted(CLI_MODEL_SAVE)
              and (models / "LatentConditioner").stat().st_mtime_ns > written
              and lv.shape == (CLI_SAMPLES, 32) and xs.shape == (CLI_SAMPLES, 3, 8)
              and np.array_equal(lv, lv_before) and np.isfinite(losses).all())
        print(f"images: {tag}: model_save/ holds the eight artifacts, LatentConditioner "
              f"rewritten, latents {lv.shape} {xs.shape} as phase 9 left them, losses finite "
              f"-> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"the {kind} run's artifacts or losses are wrong")
        if e2e:
            missing = [k for k in IMAGE_KERNELS if counts[k] <= 0]
            if missing:
                raise AssertionError(f"kernels of the E2E path never launched: {missing}")
            r["kernels_vs_plain"] = json.loads(next(
                ln for ln in run.stdout.splitlines() if ln.startswith("e2e_routes: "))[12:])
            for ln in run.stdout.splitlines():
                if ln.startswith("images: E2E kernels vs plain"):
                    print(f"{ln} [{card}]")

        # serving the files against the tree the trainer saved, kept in its process
        pipes[kind] = _image_pipeline(root, kind, tgen)
        got = tgen.generate(pipes[kind], pixels[:B], max_batch=B)
        rel = _rel_l2(got, served)
        finite = bool(got.isfinite().all()) and tuple(got.shape) == (B, T, cfg.num_node)
        print(f"images: {tag}: load_pipeline + generate from {B} images (f32, TF32 off) vs "
              f"make_pipeline on the trainer's in-memory tree in its process: rel-L2 "
              f"{rel:.3g} -> {'ok' if rel <= 1e-6 and finite else 'FAIL'} (at most 1e-6)")
        if rel > 1e-6 or not finite:
            raise AssertionError(f"the served {kind} model disagrees with the trained tree")
        del got, served
        # the conditioner on the card against the same conditioner on the CPU
        tree = load_flax_model(str(models / "LatentConditioner"))
        cpu_lc = convert.conditioner_from_jax(tree["params"], pipes[kind]["lc_cfg"], cfg, "cpu",
                                              batch_stats=tree.get("batch_stats"))
        x4 = pixels[:4]
        with torch.no_grad():
            want = cpu_lc(torch.from_numpy(x4))
            got = pipes[kind]["lc"](torch.from_numpy(x4).to("cuda"))
        err = max(_err(g.cpu(), w) for g, w in zip(got, want))
        print(f"images: {tag}: conditioner on the card vs on the CPU (f32, TF32 off), 4 "
              f"images: max abs {err:.3g} -> {'ok' if err <= 1e-4 else 'FAIL'} (at most 1e-4)")
        if err > 1e-4:
            raise AssertionError(f"the {kind} conditioner differs between the card and the CPU")
        r.update(served_vs_memory_rel_l2=rel, card_vs_cpu_max_abs=err)
        if kind == "image":
            r["sn_gap"] = sn_gap(root, kind, cfg)
            print(f"images: the trained CNN served with raw kernels (as JAX serves it) vs its "
                  f"forward through W / sigma (the state training normalised), checkpoint "
                  f"epoch {r['sn_gap']['epoch']}, {B} images: rel-L2 main "
                  f"{r['sn_gap']['main_rel_l2']:.4g}, hierarchical "
                  f"{r['sn_gap']['hier_rel_l2']:.4g} (printed, not gated)")
        result[kind] = r

    # batch-16 decode through each pipeline, and the conditioners alone, in turns
    inputs = {"csv": torch.as_tensor(csv_inputs, device="cuda"),
              "image": torch.as_tensor(pixels[:B], device="cuda"),
              "image_vit": torch.as_tensor(pixels[:B], device="cuda")}
    fns = {k: tgen.make_generate_fn(p, max_batch=B) for k, p in pipes.items()}
    timing = {}
    for kind in list(fns) + list(fns)[::-1]:
        fn, batch = fns[kind], inputs[kind]
        for _ in range(2):
            fn(batch)
        torch.cuda.synchronize()
        lat = []
        for _ in range(10):
            t0 = time.perf_counter()
            fn(batch)
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
        dev = decode_device(fn, batch, calls=2)
        with torch.no_grad():
            lc_dev = decode_device(pipes[kind]["lc"], batch, calls=3)
        timing.setdefault(kind, []).append(dict(p50_ms=float(np.percentile(lat, 50)),
                                                conditioner_device_ms=lc_dev["device_ms"],
                                                conditioner_kernels=lc_dev["kernels"], **dev))
    for kind, runs in timing.items():
        print(f"images: [{card}] batch-16 decode through the {kind} pipeline (f32, TF32 off): "
              "p50 " + " / ".join(f"{r['p50_ms']:.3f}" for r in runs) + " ms, device "
              + " / ".join(f"{r['device_ms']:.3f}" for r in runs) + " ms; the conditioner "
              "alone " + " / ".join(f"{r['conditioner_device_ms']:.3f}" for r in runs)
              + f" ms of device time, {runs[0]['conditioner_kernels']:.0f} kernels")
    result.update(decode=timing, seconds=time.perf_counter() - t_phase)
    print(f"images: phase 10 took {result['seconds']:.1f} s")
    del pipes, fns, inputs
    torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    return launches["image"], launches["image_vit"], result


# -- phase 11: the image_pca input type ------------------------------------------

PCA_LC_EPOCHS = 16
PCA_KERNELS = ("gn_act_onepass", "gn_stats", "gn_apply", "fused_adamw")
PCA_COMPONENTS = 256            # the PCA reader's default
PCA_SIDE = 16                   # its coefficients as a 16 x 16 square: the MLP's width
# 256 components asked for; 32 samples keep 32, and the file is named by what
# was kept, as in the JAX package
PCA_FILE = f"pca_full_comp{CLI_SAMPLES}.pkl"
# Runs the training CLI (argv after the module: seed, images, where to save the
# served inputs and fields, then the CLI's arguments) with only the raw image
# read replaced by seeded_gray_images, keeping the conditioner tree handed to
# save_flax_model and timing each PCA fit; prints the launch counts and peak
# memory of the run, then pca_checks' results.
PCA_RUNNER = """\
import json, os, runpy, sys, time
import torch
import chip_smoke
from simulgen_vae_tpu_torch import cli
from simulgen_vae_tpu_torch.data import images, pca
module = sys.argv.pop(1)
seed, count, served = int(sys.argv.pop(1)), int(sys.argv.pop(1)), sys.argv.pop(1)
pixels = chip_smoke.seeded_gray_images(count, seed)
images.read_raw_images = lambda *a, **k: pixels
print(f"pca: data.images.read_raw_images replaced by {count} grayscale "
      f"{chip_smoke.IMAGE_SIDE}x{chip_smoke.IMAGE_SIDE} images made from seed {seed} (smooth "
      "shapes plus noise over 0-255, not binary; no OpenCV on this machine)")
kept, fits = {}, []
save = cli.save_flax_model
def keep(path, tree):
    kept[os.path.basename(path)] = tree
    save(path, tree)
cli.save_flax_model = keep
fit = pca.PCAPreprocessor.fit
def timed_fit(self, *a, **k):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fit(self, *a, **k)
    fits.append({"device": str(self.device), "seconds": time.perf_counter() - t0})
    return out
pca.PCAPreprocessor.fit = timed_fit
try:
    runpy.run_module(module, run_name="__main__", alter_sys=True)
    code = 0
except SystemExit as e:
    code = e.code
from simulgen_vae_tpu_torch.ops import fused_adamw, gather_augment, groupnorm_gelu, quant
print("launches: " + json.dumps({**groupnorm_gelu.LAUNCHES, **quant.LAUNCHES,
                                 **gather_augment.LAUNCHES, **fused_adamw.LAUNCHES}))
print("peak_bytes: " + str(torch.cuda.max_memory_allocated()))
if code == 0:
    print("pca_fits: " + json.dumps(fits))
    print("pca_checks: " + json.dumps(chip_smoke.pca_checks(pixels, kept["LatentConditioner"],
                                                           sys.argv[1:], served)))
sys.exit(code)
"""


def seeded_gray_images(n: int, seed: int) -> np.ndarray:
    """``n`` grayscale ``IMAGE_SIDE``-square images from ``seed``, as the raw
    reader returns them (``[n, side, side]`` uint8): a background level, one
    to three smooth Gaussian shapes and noise of std 8, rounded and clipped
    to 0-255."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:IMAGE_SIDE, :IMAGE_SIDE] / IMAGE_SIDE
    out = np.empty((n, IMAGE_SIDE, IMAGE_SIDE), np.uint8)
    for i in range(n):
        img = np.full((IMAGE_SIDE, IMAGE_SIDE), rng.uniform(10, 60))
        for _ in range(rng.integers(1, 4)):
            cy, cx = rng.uniform(0.2, 0.8, 2)
            ry, rx = rng.uniform(0.05, 0.3, 2)
            img += rng.uniform(60, 190) * np.exp(-((yy - cy) / ry) ** 2 - ((xx - cx) / rx) ** 2)
        img += rng.normal(0.0, 8.0, (IMAGE_SIDE, IMAGE_SIDE))
        out[i] = np.clip(np.round(img), 0, 255)
    return out


def _trace_kernels(path: Path) -> int:
    """CUDA kernel events in a Chrome trace file."""
    events = json.loads(path.read_text())["traceEvents"]
    return sum(1 for e in events if e.get("cat") == "kernel" and WARM_KERNEL not in e.get("name", ""))


def pca_checks(pixels: np.ndarray, tree: dict, argv: list, served: str) -> dict:
    """In the training CLI's process, after it ran with input_type image_pca
    on the card: utils.profiling's peak against torch's; the saved PCA (its
    components' shape, dtype and orthonormal rows, within 1e-4; the output
    square) and the same fit on the CPU (components and coefficients within
    1e-3 up to each component's sign, coefficients against the largest one,
    the null-space component, singular value below 1e-5 of the largest, left
    out); then, in f32 with TF32 off, make_pipeline on the conditioner tree
    the trainer saved decodes B rows of the scaled coefficients (the inputs
    and fields saved to ``served`` for the caller to serve from the files),
    traced by utils.profiling.trace into chiprun_out/pca_trace/, whose file
    must hold a CUDA kernel event. Returns the numbers with an ``ok`` for
    each gate."""
    from simulgen_vae_tpu_torch import cli
    from simulgen_vae_tpu_torch import generate as tgen
    from simulgen_vae_tpu_torch.config import (LCConfig, VAEConfig, parse_condition_file,
                                               parse_training_parameters, read_preset)
    from simulgen_vae_tpu_torch.data.pca import PCAPreprocessor
    from simulgen_vae_tpu_torch.data.scaler import MinMaxScaler
    from simulgen_vae_tpu_torch.utils import profiling
    from simulgen_vae_tpu_torch.utils.checkpoint import load_flax_model

    out = {}
    mem = profiling.device_memory_mb("cuda")
    torch_peak = torch.cuda.max_memory_allocated() / 2**20
    out["memory"] = dict(mem, torch_peak_mb=torch_peak,
                         ok=mem["peak_bytes_in_use_mb"] == torch_peak)

    card = PCAPreprocessor(CLI_SAMPLES, save_dir="model_save", device="cuda").load()
    comp = card.pca.components_
    gram = np.abs(comp.astype(np.float64) @ comp.T.astype(np.float64) - np.eye(len(comp))).max()
    out["saved"] = dict(shape=list(comp.shape), dtype=str(comp.dtype),
                        output_shape=list(card.output_shape), orthonormal_max_abs=float(gram),
                        ok=bool(comp.shape == (CLI_SAMPLES, IMAGE_SIDE ** 2)
                                and comp.dtype == np.float32
                                and card.output_shape == (PCA_SIDE, PCA_SIDE) and gram <= 1e-4))

    raw = pixels.astype(np.float64)
    t0 = time.perf_counter()
    cpu = PCAPreprocessor(PCA_COMPONENTS, save_dir="model_save", device="cpu").fit(raw, save=False)
    cpu_s = time.perf_counter() - t0
    ratio = cpu.pca.explained_variance_ratio_
    keep = np.sqrt(ratio / ratio[0]) >= 1e-5
    signs = np.where((comp * cpu.pca.components_).sum(1) < 0, -1.0, 1.0)
    comp_err = float(np.abs(comp * signs[:, None] - cpu.pca.components_)[keep].max())
    flat = raw.reshape(len(raw), -1)
    coef_card = card.pca.transform(flat) * signs
    coef_cpu = cpu.pca.transform(flat)
    coef_err = float(np.abs(coef_card - coef_cpu)[:, keep].max() / np.abs(coef_cpu).max())
    flips = int((signs < 0).sum())
    out["card_vs_cpu"] = dict(components_max_abs=comp_err, coefficients_max_abs_rel=coef_err,
                              sign_flips=flips, left_out=int((~keep).sum()), cpu_fit_s=cpu_s,
                              smallest_kept_sv_rel=float(np.sqrt(ratio[keep][-1] / ratio[0])),
                              ok=comp_err <= 1e-3 and coef_err <= 1e-3)

    args = cli.build_parser().parse_args(argv)
    raw_cfg = parse_training_parameters(parse_condition_file(args.condition))
    _, _, enc, lc_filter = read_preset(args.preset_file)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    pipe = tgen.make_pipeline(
        VAEConfig.from_condition(raw_cfg, enc), LCConfig.from_condition(raw_cfg, lc_filter),
        load_flax_model("model_save/SimulGen-VAE")["params"], tree["params"],
        *(MinMaxScaler.load(f"model_save/{n}") for n in
          ("latent_vectors_scaler.pkl", "xs_scaler.pkl", "scaler.pkl")),
        device="cuda", dtype=torch.float32)
    scaler = MinMaxScaler.load("model_save/latent_conditioner_input_scaler.pkl")
    inputs = np.float32(scaler.transform(card.transform(raw[:B]).reshape(B, -1)))
    trace_dir = OUT_DIR / "pca_trace"
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        before = set(trace_dir.glob("*.json")) if trace_dir.exists() else set()
        with profiling.trace(str(trace_dir)):
            for _ in range(WARM_KERNELS):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            fields = tgen.generate(pipe, inputs, max_batch=B)
            torch.cuda.synchronize()
        (written,) = set(trace_dir.glob("*.json")) - before
        kernels = _trace_kernels(written)
        if kernels:
            break
        written.unlink()
    out["trace"] = dict(file=str(written.relative_to(OUT_DIR.parent)), attempts=attempt,
                        kernel_events=kernels, bytes=written.stat().st_size, ok=kernels > 0)
    np.savez(served, inputs=inputs, fields=fields.cpu().numpy())
    return out


def phase_pca(args, card, root: Path) -> tuple:
    """Phase 11: the image_pca input type on phase 9's trained VAE, latents
    and dataset (its work directory ``root``): the training CLI with
    --lc_only=1 fits the PCA on the card in its own process (PCA_RUNNER) and
    trains the MLP on the scaled coefficients; its artifacts, the PCA and the
    served model are checked. Returns (the CLI process's launch counts, the
    result dict)."""
    import shutil

    from simulgen_vae_tpu_torch import generate as tgen
    from simulgen_vae_tpu_torch.data.scaler import MinMaxScaler

    t_phase = time.perf_counter()
    text = (root / "condition.txt").read_text()
    for old, new in (("input_type\tcsv", "input_type\timage_pca"),
                     ("param_dir\tparams.csv", "param_dir\t/images"),
                     ("param_data_type\t.csv", "param_data_type\t.png")):
        if old not in text:
            raise AssertionError(f"phase 9's condition file lacks {old!r}")
        text = text.replace(old, new)
    condition = root / "condition_pca.txt"
    condition.write_text(text)
    shutil.rmtree(root / "checkpoints" / "latent_conditioner", ignore_errors=True)
    models = root / "model_save"
    written = (models / "LatentConditioner").stat().st_mtime_ns
    lv_before = np.load(models / "latent_vectors.npy")
    served = root / "served_pca.npz"
    common = ["--preset=1", "--plot=2", "--size=small", "--dtype", "bfloat16", "--device", "cuda"]
    torch.cuda.empty_cache()
    started = time.time()
    run, launches, peak, seconds = run_module(
        "simulgen_vae_tpu_torch",
        [str(args.seed), str(CLI_SAMPLES), str(served), *common, "--condition", condition.name,
         "--lc_only=1", "--lc_epochs", str(PCA_LC_EPOCHS)],
        root, "the training CLI on image_pca", timeout=900, runner=PCA_RUNNER)
    (OUT_DIR / "chip_smoke_pca.log").write_text(run.stdout + "\n" + run.stderr)
    lines = run.stdout.splitlines()
    print(next(ln for ln in lines if ln.startswith("pca: ")))
    logged = _epoch_lines(run.stderr, PCA_LC_EPOCHS)
    if len(logged) != PCA_LC_EPOCHS:
        raise AssertionError(f"{len(logged)} of {PCA_LC_EPOCHS} LC epochs logged")
    fits = json.loads(next(ln for ln in lines if ln.startswith("pca_fits: "))[10:])
    checks = json.loads(next(ln for ln in lines if ln.startswith("pca_checks: "))[12:])
    losses = [e[0] for e in logged]
    stages = {"start to the first LC epoch logged": logged[0][2] - started,
              "the other LC epochs": logged[-1][2] - logged[0][2],
              "LC model file, comparison, checks, exit": time.time() - logged[-1][2]}
    counts = {k: launches[k] for k in PCA_KERNELS}
    print(f"pca: [{card}] python -m simulgen_vae_tpu_torch --lc_only=1 --lc_epochs "
          f"{PCA_LC_EPOCHS} (input_type image_pca): exit 0 in {seconds:.1f} s (its own process), "
          f"peak device memory {peak / 2**30:.2f} GiB; the PCA fit " + ", ".join(
              f"{f['seconds']:.3f} s on {f['device']}" for f in fits)
          + f"; LC epochs {', '.join(f'{e[1]:.3f}' for e in logged)} s; train loss "
          f"{losses[0]} -> {losses[-1]}; launches {counts}")
    print(f"pca: [{card}] stages (s, from the log's stamps): "
          + "; ".join(f"{k} {v:.1f}" for k, v in stages.items()))

    scaler = MinMaxScaler.load(str(models / "latent_conditioner_input_scaler.pkl"))
    lv = np.load(models / "latent_vectors.npy")
    ok = (sorted(os.listdir(models)) == sorted((*CLI_MODEL_SAVE, PCA_FILE))
          and (models / "LatentConditioner").stat().st_mtime_ns > written
          and scaler.scale_.shape == (PCA_SIDE * PCA_SIDE,) and np.array_equal(lv, lv_before)
          and np.isfinite(losses).all() and [f["device"] for f in fits] == ["cuda"])
    print(f"pca: model_save/ holds the eight artifacts and {PCA_FILE}, LatentConditioner "
          f"rewritten, the input scaler {scaler.scale_.shape[0]} columns, the latents as phase 9 "
          f"left them, losses finite, one PCA fit on the card -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the image_pca run's artifacts or losses are wrong")
    missing = [k for k in PCA_KERNELS if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels of the image_pca path never launched: {missing}")
    s, cc, m, tr = checks["saved"], checks["card_vs_cpu"], checks["memory"], checks["trace"]
    print(f"pca: {PCA_FILE}: components {s['shape']} {s['dtype']}, output_shape "
          f"{s['output_shape']}, rows orthonormal within {s['orthonormal_max_abs']:.3g} -> "
          f"{'ok' if s['ok'] else 'FAIL'} (at most 1e-4)")
    print(f"pca: [{card}] the card's fit vs the same fit on the CPU ({cc['cpu_fit_s']:.2f} s): "
          f"components max abs {cc['components_max_abs']:.3g}, coefficients max abs "
          f"{cc['coefficients_max_abs_rel']:.3g} of the largest, up to sign ({cc['sign_flips']} "
          f"flipped), {cc['left_out']} null-space component left out (the smallest kept singular "
          f"value {cc['smallest_kept_sv_rel']:.3g} of the largest) -> "
          f"{'ok' if cc['ok'] else 'FAIL'} (at most 1e-3)")
    print(f"pca: [{card}] utils.profiling.device_memory_mb in the CLI's process: peak "
          f"{m['peak_bytes_in_use_mb']:.2f} MiB, torch.cuda.max_memory_allocated "
          f"{m['torch_peak_mb']:.2f} MiB, in use {m['bytes_in_use_mb']:.2f}, limit "
          f"{m['bytes_limit_mb']:.0f} MiB -> {'ok' if m['ok'] else 'FAIL'}; utils.profiling.trace "
          f"of a decode wrote {tr['file']} ({tr['bytes'] / 1e6:.1f} MB, {tr['kernel_events']} "
          f"kernel events, attempt {tr['attempts']}) -> {'ok' if tr['ok'] else 'FAIL'}")
    if not (s["ok"] and cc["ok"] and m["ok"] and tr["ok"]):
        raise AssertionError("the image_pca run's PCA, memory telemetry or trace check failed")

    # serving the files against the tree the trainer saved, kept in its process
    saved = np.load(served)
    served.unlink()
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    pipe = tgen.load_pipeline(str(condition), str(root / "preset.txt"), model_dir=str(models),
                              device="cuda", dtype=torch.float32)
    got = tgen.generate(pipe, saved["inputs"], max_batch=B)
    rel = _rel_l2(got, torch.from_numpy(saved["fields"]).to("cuda"))
    finite = bool(got.isfinite().all()) and tuple(got.shape) == (B, T, READOUT_C)
    print(f"pca: load_pipeline + generate on {B} rows of the scaled coefficients (f32, TF32 "
          f"off) vs make_pipeline on the trainer's in-memory tree in its process: rel-L2 "
          f"{rel:.3g} -> {'ok' if rel <= 1e-6 and finite else 'FAIL'} (at most 1e-6)")
    if rel > 1e-6 or not finite:
        raise AssertionError("the served image_pca model disagrees with the trained tree")
    del got, pipe, saved
    torch.cuda.empty_cache()
    result = dict(cli_s=seconds, peak_bytes=peak, fits=fits, epoch_s=[e[1] for e in logged],
                  loss_first=losses[0], loss_last=losses[-1], stages_s=stages, launches=counts,
                  checks=checks, served_vs_memory_rel_l2=rel,
                  seconds=time.perf_counter() - t_phase)
    print(f"pca: phase 11 took {result['seconds']:.1f} s")
    return launches, result


# -- phase 12: the mesh ----------------------------------------------------------

MESH_SHAPES = ((1, 2), (2, 1))       # (data, model): two ranks rehearse on the one card
MESH_EPOCHS = 2                      # of four steps (64 samples, 80/20 split, batch 16)
MESH_REQUESTS = 16
MESH_DISK_BYTES = 6e9                # one flagship checkpoint: parameters and moments in f32
MESH_LC_EPOCHS = 2


def serving_setup(seed: int):
    """Phase 3's flagship serving geometry with random trees, scalers and 40
    requests from ``seed``."""
    from simulgen_vae_tpu_torch import convert
    from simulgen_vae_tpu_torch.config import LCConfig, VAEConfig
    from simulgen_vae_tpu_torch.data.scaler import MinMaxScaler

    cfg = VAEConfig(num_time=T, num_node=95008, latent_dim_end=32, latent_dim=8,
                    num_filter_enc=[1024, 512, 256, 128], small=True)
    lc_cfg = LCConfig(filters=[32, 64, 128, 256, 512, 1024], input_type="csv")
    n_in = 484
    rng = np.random.default_rng(seed)
    vae_params = {"decoder": convert.random_decoder_tree(cfg, rng)}
    lc_params = convert.random_conditioner_tree(lc_cfg, cfg, n_in, rng)
    scalers = {name: MinMaxScaler(rng.uniform(0.5, 2.0, n).astype(np.float32),
                                  rng.uniform(-0.3, 0.3, n).astype(np.float32))
               for name, n in (("lv_scaler", cfg.latent_dim_end),
                               ("xs_scaler", cfg.num_hier * cfg.latent_dim),
                               ("data_scaler", cfg.num_node))}
    inputs = rng.standard_normal((40, n_in)).astype(np.float32)
    return types.SimpleNamespace(cfg=cfg, lc_cfg=lc_cfg, vae_params=vae_params,
                                 lc_params=lc_params, scalers=scalers, inputs=inputs)


def _train_counts() -> dict:
    from simulgen_vae_tpu_torch.ops import fused_adamw, gather_augment, groupnorm_gelu

    counts = {**groupnorm_gelu.LAUNCHES, **gather_augment.LAUNCHES, **fused_adamw.LAUNCHES}
    return {k: counts[k] for k in CLI_TRAIN_KERNELS}


def _reset_train_counts() -> None:
    from simulgen_vae_tpu_torch.ops import fused_adamw, gather_augment, groupnorm_gelu

    for module in (fused_adamw, gather_augment, groupnorm_gelu):
        module.reset_launch_counts()


def run_group(cmd: list, cwd: Path, env: dict, timeout: int) -> subprocess.CompletedProcess:
    """``subprocess.run`` of a launcher in a session of its own: on the time
    limit its whole process group (the launcher's workers too) is killed."""
    import signal

    with subprocess.Popen(cmd, cwd=cwd, env=env, stdout=subprocess.PIPE,
                          stderr=subprocess.PIPE, text=True, start_new_session=True) as proc:
        try:
            out, err = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
            raise
    return subprocess.CompletedProcess(cmd, proc.returncode, out, err)


def mesh_rank(rank: int, world: int, init: str, data_ax: int, model_ax: int, seed: int,
              work: str) -> None:
    """One rank of phase 12, in its own process (``tests/torch_ranks.py``):
    gloo with CUDA tensors, every rank on the one card. Returns its results."""
    from simulgen_vae_tpu_torch import generate as tgen
    from simulgen_vae_tpu_torch.data.augmentation import AugmentationConfig
    from simulgen_vae_tpu_torch.parallel import (
        initialize_distributed,
        make_mesh,
        sharding,
        sync_processes,
    )
    from simulgen_vae_tpu_torch.train.vae_trainer import VAETrainer
    from simulgen_vae_tpu_torch.utils import profiling
    from simulgen_vae_tpu_torch.utils.checkpoint import CheckpointManager

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = initialize_distributed("cuda:0", backend="gloo", init_method=init,
                                    world_size=world, rank=rank)
    mesh = make_mesh(data_ax, model_ax)
    out = {"rank": rank, "coords": mesh.coords}

    # one step, f32 with TF32 off, no augmentation: one process (rank 0), then the mesh
    cfg32 = dataclasses.replace(train_config(), dtype="float32")
    batch = 0.3 * torch.randn((B, T, READOUT_C), device=device,
                              generator=torch.Generator(device).manual_seed(seed + 2))
    no_aug = AugmentationConfig(enabled=False)
    if rank == 0:
        single = VAETrainer(cfg32, aug=no_aug, device=device, seed=seed)
        state = single.init_state(seed)
        m, _, grads = single.loss_and_grads(state, batch, 0.5,
                                            generator=torch.Generator(device).manual_seed(7))
        ref_loss, ref_grads = float(m["loss"]), {k: g.cpu() for k, g in grads.items()}
        del single, state, m, grads
        torch.cuda.empty_cache()
    sync_processes("reference step")
    trainer = VAETrainer(cfg32, aug=no_aug, device=device, seed=seed)
    trainer.set_mesh(mesh)
    state = trainer.init_state(seed)
    block, rows = trainer.local_batch(batch)
    m, _, grads = trainer.loss_and_grads(state, block.contiguous(), 0.5,
                                         generator=torch.Generator(device).manual_seed(7),
                                         noise_rows=rows)
    grads = sharding.gather_tree(grads, state.layout.params, state.layout)
    if rank == 0:
        rels = {k: _grad_rel(g, ref_grads[k].to(device)) for k, g in grads.items()}
        worst = max(rels, key=rels.get)
        out["step"] = dict(loss=float(m["loss"]), loss_one_process=ref_loss,
                           loss_rel=abs(float(m["loss"]) - ref_loss) / abs(ref_loss),
                           worst_grad_rel_l2=rels[worst], worst_grad=worst)
        del ref_grads
    del trainer, state, m, grads, block, batch
    torch.cuda.empty_cache()

    # bf16 fit with a checkpoint, the launch counts from 0
    cfg = train_config()
    data = (0.3 * torch.randn((TRAIN_SAMPLES, T, READOUT_C), device=device,
                              generator=torch.Generator(device).manual_seed(seed + 1))
            ).to(torch.bfloat16)
    trainer = VAETrainer(cfg, device=device, seed=seed)
    ckpt_dir = Path(work) / f"mesh_ckpt_{data_ax}x{model_ax}"
    mgr = CheckpointManager(str(ckpt_dir), save_interval_epochs=MESH_EPOCHS)
    step_ms, real_apply = [], trainer._apply

    def timed_apply(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = real_apply(*a, **k)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        return metrics

    trainer._apply = timed_apply
    torch.cuda.reset_peak_memory_stats(device)
    _reset_train_counts()
    t0 = time.perf_counter()
    with profiling.recording() as rec:
        state, hist = trainer.fit(data, seed=seed, epochs=MESH_EPOCHS, val_every=1,
                                  ckpt_manager=mgr, mesh=mesh)
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    coll_ms = rec.seconds("collective.", within="train.step") * 1e3
    out["fit"] = dict(seconds=seconds, launches=_train_counts(), loss=hist["loss"].tolist(),
                      val_loss=hist["val_loss"].tolist(), grad_norm=hist["grad_norm"].tolist(),
                      steps=len(step_ms), step_p50_ms=float(np.median(step_ms)),
                      collective_ms_per_step=coll_ms / len(step_ms),
                      peak_bytes=torch.cuda.max_memory_allocated(device))
    del data

    # the checkpoint, restored in one process (rank 0), against the gathered state
    whole = trainer.gather_state(state)
    if rank == 0:
        one = VAETrainer(cfg, device=device, seed=seed)
        restored = CheckpointManager(str(ckpt_dir)).restore(one.init_state(seed + 1))
        out["checkpoint"] = dict(epoch=mgr.latest_step(), bits_equal=_states_equal(restored, whole),
                                 bytes=os.path.getsize(mgr._path(mgr.latest_step())))
        del one, restored
    del whole, state, trainer
    torch.cuda.empty_cache()
    sync_processes("checkpoint read")
    if rank == 0:
        import shutil

        shutil.rmtree(ckpt_dir)

    # serving: the flagship decode on the mesh against one process, f32 and int8
    setup = serving_setup(seed)
    pipe = tgen.make_pipeline(setup.cfg, setup.lc_cfg, setup.vae_params, setup.lc_params,
                              device=device, dtype=torch.float32, **setup.scalers)
    inputs = setup.inputs[:MESH_REQUESTS]
    per_call = MESH_REQUESTS // data_ax       # each rank decodes its rows in one call
    out["serve"] = {}
    for mode in (None, "int8"):
        fn = tgen.make_generate_fn(pipe, max_batch=MESH_REQUESTS, quantize=mode, mesh=mesh)
        got = fn(inputs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(inputs)
        torch.cuda.synchronize()
        row = dict(ms=(time.perf_counter() - t0) * 1e3, shape=list(got.shape),
                   finite=bool(got.isfinite().all()))
        if rank == 0:
            # one process in one call of 16, and in calls of the ranks' rows
            whole = tgen.make_generate_fn(pipe, max_batch=MESH_REQUESTS, quantize=mode)(inputs)
            rows = tgen.make_generate_fn(pipe, max_batch=per_call, quantize=mode)(inputs)
            row.update(max_abs=_err(got, whole), rel_l2=_rel_l2(got, whole),
                       rows_max_abs=_err(got, rows), rows_rel_l2=_rel_l2(got, rows),
                       one_process_calls_rel_l2=_rel_l2(rows, whole))
            del whole, rows
        out["serve"][mode or "float32"] = row
        del got, fn
        torch.cuda.empty_cache()
    out["peak_bytes"] = torch.cuda.max_memory_allocated(device)
    return out


def _mesh_gate(tag: str, ranks: list) -> None:
    first = ranks[0]
    step, ckpt, serve = first["step"], first["checkpoint"], first["serve"]
    losses = [r["fit"]["loss"] for r in ranks]
    problems = []
    if step["loss_rel"] > 1e-4 or step["worst_grad_rel_l2"] > 1e-3:
        problems.append(f"step against one process: {step}")
    if not all(np.isfinite(r["fit"]["loss"]).all() for r in ranks) \
            or any(x != losses[0] for x in losses):
        problems.append(f"fit losses not finite or not equal on every rank: {losses}")
    for r in ranks:
        missing = [k for k, n in r["fit"]["launches"].items() if n <= 0]
        if missing:
            problems.append(f"rank {r['rank']} never launched {missing}")
    if not ckpt["bits_equal"]:
        problems.append("the checkpoint restored in one process differs from the gathered state")
    if serve["float32"]["max_abs"] > 1e-4 or serve["int8"]["rows_rel_l2"] > 1e-3 \
            or not all(r["serve"][k]["finite"] for r in ranks for k in r["serve"]):
        problems.append(f"serving on the mesh against one process: {serve}")
    if problems:
        raise AssertionError(f"mesh {tag}: " + "; ".join(problems))


def phase_mesh(args, card, root: Path) -> tuple:
    """Phase 12: two ranks on the one card (gloo, CUDA tensors) in meshes
    1 x 2 and 2 x 1 at the flagship geometry (mesh_rank), then the training
    CLI under torchrun with one NCCL rank in phase 9's work directory.
    Returns (per mesh, each rank's launch counts; the result dict)."""
    import gc
    import shutil

    here = Path(__file__).resolve().parent
    sys.path.insert(0, str(here / "tests"))   # by file: a `tests` package may be installed
    from torch_ranks import spawn_ranks

    gc.collect()
    torch.cuda.empty_cache()
    env = {"PYTHONPATH": str(here) + (os.pathsep + os.environ["PYTHONPATH"]
                                      if os.environ.get("PYTHONPATH") else "")}
    room = shutil.disk_usage(root).free
    if room < MESH_DISK_BYTES:
        raise AssertionError(f"phase 12 needs {MESH_DISK_BYTES / 1e9:.0f} GB of disk for a "
                             f"checkpoint; {root} has {room / 1e9:.1f} GB free")
    result, launches = {}, {}
    for d, m in MESH_SHAPES:
        tag = f"{d}x{m}"
        t0 = time.perf_counter()
        logs = OUT_DIR / f"chip_smoke_mesh_{tag}"
        logs.mkdir(parents=True, exist_ok=True)
        ranks = spawn_ranks(mesh_rank, d * m, timeout=900, log_dir=str(logs), data_ax=d,
                            model_ax=m, seed=args.seed, work=str(root))
        seconds = time.perf_counter() - t0
        step, ckpt, serve = ranks[0]["step"], ranks[0]["checkpoint"], ranks[0]["serve"]
        print(f"mesh {tag}: one step (f32, TF32 off) against one process: loss "
              f"{step['loss']:.7g} vs {step['loss_one_process']:.7g} (rel {step['loss_rel']:.3g}), "
              f"worst gradient rel-L2 {step['worst_grad_rel_l2']:.3g} ({step['worst_grad']})")
        for r in ranks:
            f = r["fit"]
            print(f"mesh {tag}: [{card}] one-card rehearsal, not a multi-card speed: rank "
                  f"{r['rank']} {r['coords']}: bf16 fit {len(f['loss'])} epochs, {f['steps']} "
                  f"steps in {f['seconds']:.1f} s, losses {f['loss']}, step p50 "
                  f"{f['step_p50_ms']:.1f} ms, {f['collective_ms_per_step']:.1f} ms a step in "
                  f"collectives (host time), peak {f['peak_bytes'] / 2**30:.2f} GiB in the fit, "
                  f"{r['peak_bytes'] / 2**30:.2f} GiB in all; launches {f['launches']}")
        print(f"mesh {tag}: checkpoint of epoch {ckpt['epoch']} ({ckpt['bytes'] / 1e9:.2f} GB) "
              f"restored in one process equals the gathered state bit for bit: "
              f"{ckpt['bits_equal']}; serving {MESH_REQUESTS} requests against one process "
              f"in one call: f32 max-abs {serve['float32']['max_abs']:.3g}, int8 rel-L2 "
              f"{serve['int8']['rel_l2']:.3g}; against one process in calls of "
              f"{MESH_REQUESTS // d} (each rank's rows): f32 max-abs "
              f"{serve['float32']['rows_max_abs']:.3g}, int8 rel-L2 "
              f"{serve['int8']['rows_rel_l2']:.3g}; one process, calls of {MESH_REQUESTS // d} "
              f"against one call: f32 rel-L2 {serve['float32']['one_process_calls_rel_l2']:.3g}, "
              f"int8 {serve['int8']['one_process_calls_rel_l2']:.3g}; decode "
              f"{serve['float32']['ms']:.1f} ms f32, {serve['int8']['ms']:.1f} ms int8 "
              f"(rehearsal); {seconds:.1f} s for the mesh")
        _mesh_gate(tag, ranks)
        launches[tag] = [r["fit"]["launches"] for r in ranks]
        result[tag] = dict(seconds=seconds, ranks=ranks)

    # one NCCL rank under torchrun: the training CLI in phase 9's work directory
    common = ["--preset=1", "--plot=2", "--size=small", "--dtype", "bfloat16",
              "--condition", "condition.txt", "--device", "cuda"]
    t0 = time.perf_counter()
    run = run_group(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
         "1", "-m", "simulgen_vae_tpu_torch", *common, "--lc_only=0", "--mesh_data", "1",
         "--mesh_model", "1", "--epochs", "1", "--lc_epochs", str(MESH_LC_EPOCHS)],
        root, {**os.environ, **env}, timeout=600)
    seconds = time.perf_counter() - t0
    (OUT_DIR / "chip_smoke_mesh_torchrun.log").write_text(run.stdout + "\n" + run.stderr)
    files = sorted(os.listdir(root / "model_save")) if (root / "model_save").is_dir() else []
    ok = (run.returncode == 0 and "Mesh: {'data': 1, 'model': 1}" in run.stdout
          and files == sorted(CLI_MODEL_SAVE))
    print(f"mesh torchrun: python -m torch.distributed.run --standalone --nproc_per_node 1 -m "
          f"simulgen_vae_tpu_torch --mesh_data 1 --mesh_model 1 --epochs 1 --lc_epochs "
          f"{MESH_LC_EPOCHS} (NCCL): exit {run.returncode} in {seconds:.1f} s, the mesh "
          f"printed: {'Mesh: ' in run.stdout}, model_save/ {files} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"the training CLI under torchrun failed:\n{run.stdout[-2000:]}\n"
                             f"{run.stderr[-3000:]}")
    result["torchrun"] = dict(seconds=seconds, returncode=run.returncode)
    return launches, result


# -- phase 13: the readout's fused pass into the served field ------------------

# Phase 13: the sweep's request (128 fields in chunks of 64) and ragged
# shapes ([rows, T, N], groups): N or the group width not a multiple of 4,
# and row bases that are not 16-byte aligned (out rows 1.. of a
# [rows + 1, t, n] field).
SWEEP_ROWS, SWEEP_CHUNK = 128, 64
FUSED_RAGGED = (((3, 7, 1001), 7), ((2, 5, 95007), 1), ((2, 3, 95008), 8), ((2, 3, 1004), 4),
                ((3, 2, 1004), 2))


def _plain_gap(got, want, scale, dtype) -> tuple:
    """How far the fused kernel's field lies from its whole plain version, in
    the tanh'd map's units (the gap times scale_), and whether that is no
    more than the rounding of one side's tanh (torch.tanh against tanhf, a
    separate multiply and add against an FMA) explains: at most one bf16
    step of a value in (-1, 1) on at most a thousandth of the elements in
    bf16, 1e-5 in f32."""
    gap = (got - want).abs() * scale
    worst, share = float(gap.max()), int((gap > 0).sum()) / gap.numel()
    ok = worst <= 2.0 ** -8 + 1e-5 and share <= 1e-3 if dtype == torch.bfloat16 else worst <= 1e-5
    return worst, share, ok


def _fused_case(fe, gg, y, stats, vecs, groups, rows: slice, total: int) -> dict:
    """``gn_apply_field_epilogue`` of ``y``'s first rows into rows ``rows`` of
    a NaN-filled ``[total, ...]`` f32 field, against ``gn_apply(act="tanh")``
    then the plain descale bit for bit, and against its whole plain version
    within ``_plain_gap``."""
    gs, gb, mn, sc = vecs
    r = rows.stop - rows.start
    out = torch.full((total, *y.shape[1:]), float("nan"), device="cuda")
    fe.gn_apply_field_epilogue(y, stats, gs, gb, mn, sc, out[rows], groups)
    act = gg.gn_apply(y, gs, gb, stats, groups, "tanh")[:r]
    want = fe.field_epilogue_reference(act, mn, sc, torch.empty_like(out[rows]))
    del act
    plain = fe.gn_apply_field_epilogue_reference(y, stats, gs, gb, mn, sc,
                                                 torch.empty_like(out[rows]), groups)
    torch.cuda.synchronize()
    placed = out[rows]
    other = int(out.isnan().sum()) - int(placed.isnan().sum())
    gap, share, near = _plain_gap(placed, plain, sc, y.dtype)
    return dict(shape=list(y.shape), groups=groups, dtype=str(y.dtype).split(".")[1],
                rows=[rows.start, rows.stop], equal=bool(torch.equal(placed, want)),
                max_abs=_err(placed, want), plain_gap=gap, plain_share=share, near_plain=near,
                untouched=other == out.numel() - placed.numel())


def phase_epilogue(args, card, pipeline, inputs) -> tuple:
    """Phase 13: the readout's GroupNorm apply, tanh, rounding and descale in
    one pass (``gn_apply_field_epilogue`` in ops/csrc/field_epilogue.cu).
    Gated: it equals ``gn_apply(act="tanh")`` then the plain descale
    (``field_epilogue_reference``) bit for bit, and its whole plain version
    (``gn_apply_field_epilogue_reference``) within ``_plain_gap``, at the
    sweep's chunk shape (64 x 200 x 95008, bf16 and f32, into rows 64-127 of
    a 128-row field, and the padded tail's 63 rows) and at FUSED_RAGGED
    (both dtypes, aligned and shifted row bases), leaving the other rows
    unwritten; one 128-row request through make_generate_fn(max_batch=64)
    launches it twice and the tanh GroupNorm never, and equals the plain
    descale of the same request served with descale_output=False. Timed for
    one request: the fused kernel back to back, device only (a replayed CUDA
    graph) and profiled, beside its byte bound and its plain version.
    Returns (the kernels' JSON entry, the result dict)."""
    from simulgen_vae_tpu_torch import generate as tgen
    from simulgen_vae_tpu_torch.models import blocks
    from simulgen_vae_tpu_torch.ops import field_epilogue as fe
    from simulgen_vae_tpu_torch.ops import groupnorm_gelu as gg

    gen = torch.Generator("cuda").manual_seed(args.seed)
    n_node, groups = 95008, 8

    def vectors(n):
        """GroupNorm scale and bias, the data scaler's min_ and scale_."""
        return (torch.rand(n, generator=gen, device="cuda") * 2 - 0.5,
                torch.rand(n, generator=gen, device="cuda") - 0.5,
                torch.rand(n, generator=gen, device="cuda") * 1.8 - 0.9,
                torch.rand(n, generator=gen, device="cuda") * 1.8 + 0.2)

    def pre_norm(shape, dtype, g):
        y = (torch.randn(shape, generator=gen, device="cuda") * 2 + 0.3).to(dtype)
        return y, gg.gn_stats(y, g)

    fe.reset_launch_counts()
    cases = []
    vecs = vectors(n_node)
    for dtype in (torch.bfloat16, torch.float32):
        y, stats = pre_norm((SWEEP_CHUNK, T, n_node), dtype, groups)
        for rows in (slice(SWEEP_CHUNK, SWEEP_ROWS), slice(SWEEP_CHUNK, SWEEP_ROWS - 1)):
            cases.append(_fused_case(fe, gg, y, stats, vecs, groups, rows, SWEEP_ROWS))
        del y, stats
        torch.cuda.empty_cache()
    for shape, g in FUSED_RAGGED:
        v = vectors(shape[2])
        for dtype in (torch.bfloat16, torch.float32):
            y, stats = pre_norm(shape, dtype, g)
            for start in (0, 1):
                cases.append(_fused_case(fe, gg, y, stats, v, g,
                                         slice(start, start + shape[0]), shape[0] + 1))
    for c in cases:
        print(f"epilogue: fused {c['dtype']} {c['shape']} G={c['groups']} into rows "
              f"{c['rows']}: {'the same bits' if c['equal'] else 'DIFFERENT'} (max abs "
              f"{c['max_abs']:.3g}) as gn_apply + the plain descale; against the plain "
              f"version {c['plain_gap']:.3g} at most on {100 * c['plain_share']:.4f}% of the "
              f"elements ({'within' if c['near_plain'] else 'OVER'} a rounding step), other "
              f"rows {'untouched' if c['untouched'] else 'WRITTEN'}")
    if not all(c["equal"] and c["near_plain"] and c["untouched"] for c in cases):
        raise AssertionError("gn_apply_field_epilogue differs from gn_apply + the plain descale "
                             "or from its plain version")

    # one request through the serving function
    pipe = pipeline(torch.bfloat16)
    request = np.resize(inputs, (SWEEP_ROWS, inputs.shape[1]))
    fe.reset_launch_counts()
    calls = []
    with recording_calls(blocks, calls):
        got = tgen.make_generate_fn(pipe, max_batch=SWEEP_CHUNK)(request)
    torch.cuda.synchronize()
    launches = dict(fe.LAUNCHES)
    tanh_calls = sum(act == "tanh" for _, _, act in calls)
    raw = tgen.make_generate_fn(pipe, descale_output=False, max_batch=SWEEP_CHUNK)(request)
    ds = pipe["data_scaler"]
    want = ds.inverse_transform(raw.float())
    served = dict(shape=list(got.shape), dtype=str(got.dtype).split(".")[1], launches=launches,
                  tanh_group_norm_calls=tanh_calls, equal=bool(torch.equal(got, want)),
                  max_abs=_err(got, want), finite=bool(got.isfinite().all()))
    print(f"epilogue: one {SWEEP_ROWS}-row request at max_batch {SWEEP_CHUNK}: "
          f"{tuple(got.shape)} {got.dtype}, launches {launches}, tanh GroupNorm calls "
          f"{tanh_calls}; against the plain descale of the raw field: "
          f"{'the same bits' if served['equal'] else 'DIFFERENT'} (max abs "
          f"{served['max_abs']:.3g})")
    if (launches != {"gn_apply_field_epilogue": SWEEP_ROWS // SWEEP_CHUNK}
            or tanh_calls or not served["equal"] or not served["finite"]
            or served["shape"] != [SWEEP_ROWS, T, n_node] or got.dtype != torch.float32):
        raise AssertionError(f"the served request did not take the fused readout: {served}")
    del pipe, got, raw, want
    torch.cuda.empty_cache()

    # times for one request: two chunks of 64
    y, stats = pre_norm((SWEEP_CHUNK, T, n_node), torch.bfloat16, groups)
    gs, gb, mn, sc = vecs
    out = torch.empty((SWEEP_ROWS, T, n_node), device="cuda")

    def fused_request():
        for start in range(0, SWEEP_ROWS, SWEEP_CHUNK):
            fe.gn_apply_field_epilogue(y, stats, gs, gb, mn, sc, out[start: start + SWEEP_CHUNK],
                                       groups)

    def plain_request():
        for start in range(0, SWEEP_ROWS, SWEEP_CHUNK):
            fe.gn_apply_field_epilogue_reference(y, stats, gs, gb, mn, sc,
                                                 out[start: start + SWEEP_CHUNK], groups)

    reps = max(args.reps, 10)
    times = [cuda_ms(fused_request, reps) for _ in range(2)]
    plain_ms = cuda_ms(plain_request, 2, warmup=1)
    device_ms = graph_ms(fused_request, reps)
    elems = SWEEP_ROWS * T * n_node
    bound_ms = elems * (2 + 4) / HBM_BYTES_PER_S * 1e3
    profiled_ms = profiled_device_ms(fused_request, reps, expect="gn_apply_field_epilogue",
                                     floor_ms=bound_ms)
    ms = min(times)
    print(f"timing: [{card}] gn_apply_field_epilogue for one {SWEEP_ROWS}-field request (2 "
          f"launches, bf16 pre-norm map in, f32 field out): {ms:.4f} ms back to back "
          f"({times}), device only {device_ms:.4f} ms, profiled {profiled_ms:.4f} ms; "
          f"bound {bound_ms:.4f} ms ({100 * bound_ms / profiled_ms:.1f}% profiled, "
          f"{100 * bound_ms / device_ms:.1f}% device only); plain version {plain_ms:.4f} ms")
    del y, stats, out
    torch.cuda.empty_cache()
    kernel = dict(name="gn_apply_field_epilogue", route="cuda",
                  source="simulgen_vae_tpu_torch/ops/csrc/field_epilogue.cu",
                  replaces="no Pallas kernel: the readout's gn_apply "
                           "(simulgen_vae_tpu/ops/groupnorm_gelu.py:366) and XLA's fused "
                           "descale in simulgen_vae_tpu/generate.py",
                  launches=launches["gn_apply_field_epilogue"],
                  launches_per_request=SWEEP_ROWS // SWEEP_CHUNK,
                  max_abs_err=max(c["max_abs"] for c in cases), ms=ms, device_ms=device_ms,
                  profiled_ms=profiled_ms, bound_ms=bound_ms, bound_by="bytes",
                  plain_ms=plain_ms, library_ms=None, card=card, shapes=[[SWEEP_ROWS, T, n_node]])
    return kernel, dict(cases=cases, served=served, times=times, device_ms=device_ms,
                        profiled_ms=profiled_ms,
                        bound_ms=bound_ms, plain_ms=plain_ms)


# -- phase 14: the convolutions' layout -----------------------------------------

# cuDNN's layout transposes, which a channels-last call does not run
TRANSPOSE_KERNELS = ("nchwToNhwc", "nhwcToNchw")
# a 64-row chunk of the four-filter decoder: its k > 1 convolutions by how
# their operands reached cuDNN (14 direct, the 3 latent injectors' inputs
# copied, no weight copied)
CHUNK_CONVS = {"conv.direct": 14, "conv.input_copied": 3, "conv.weight_copied": 0}
# a 64-row chunk's decode on the card while the convolutions ran on NCW maps
# with cuDNN's transposes: PERF.md section 5, run z1, 51.6 ms of device time
# a 128-field request, 5.3 of it the epilogue
NCW_CHUNK_DECODE_MS = (51.6 - 5.3) / 2


@contextlib.contextmanager
def plain_convolution(blocks):
    """Route every convolution through the plain call: ``F.conv1d`` on the
    ``[B, C, T]`` map, its output made contiguous again."""
    real = blocks.conv1d_same

    def plain(x, weight, bias=None):
        if weight.shape[-1] == 1:
            return real(x, weight, bias)
        y = F.conv1d(x.transpose(1, 2), weight, bias, padding=weight.shape[-1] // 2)
        return y.transpose(1, 2).contiguous()

    blocks.conv1d_same = plain
    try:
        yield
    finally:
        blocks.conv1d_same = real


def phase_layout(args, card, pipeline, inputs) -> dict:
    """Phase 14: one 64-row flagship decode (bf16, the raw field) through
    make_generate_fn. Gated: CONV_LAYOUT's counts equal CHUNK_CONVS; its
    profiler trace holds no TRANSPOSE_KERNELS kernel and no layout copy (an
    ``aten::copy_`` under ``aten::clone``; casts copy under ``aten::_to_copy``)
    of a map as large as the narrowest decoder activation; the field is
    within rel-L2 1e-2 of the same decode through :func:`plain_convolution`.
    Printed: bit-equality with it, the decode's device time beside the plain
    convolution's and NCW_CHUNK_DECODE_MS."""
    from simulgen_vae_tpu_torch import generate as tgen
    from simulgen_vae_tpu_torch.models import blocks

    pipe = pipeline(torch.bfloat16)
    cfg = pipe["cfg"]
    fn = tgen.make_generate_fn(pipe, descale_output=False, max_batch=SWEEP_CHUNK)
    batch = torch.as_tensor(np.resize(inputs, (SWEEP_CHUNK, inputs.shape[1])), device="cuda")
    fn(batch)
    torch.cuda.synchronize()
    before = dict(blocks.CONV_LAYOUT)
    got = fn(batch)
    counts = {k: blocks.CONV_LAYOUT[k] - before[k] for k in before}
    prof, _ = traced(lambda: fn(batch), record_shapes=True)
    rows = kernel_rows(prof)
    device_ms = sum(e.self_device_time_total for e in rows) / 1e3
    transposes = {e.key: e.count for e in rows if any(t in e.key for t in TRANSPOSE_KERNELS)}
    smallest = SWEEP_CHUNK * T * min(cfg.num_filter_dec)
    copies = [list(e.input_shapes[0]) for e in prof.events()
              if e.name == "aten::copy_" and e.cpu_parent is not None
              and e.cpu_parent.name == "aten::clone" and e.input_shapes
              and math.prod(e.input_shapes[0]) >= smallest]
    with plain_convolution(blocks):
        want = fn(batch)
        plain_ms = decode_device(fn, batch, calls=1)["device_ms"]
    rel = _rel_l2(got, want)
    out = dict(counts=counts, transposes=transposes, copies=copies, rel_l2=rel,
               equal=bool(torch.equal(got, want)), device_ms=device_ms, plain_ms=plain_ms,
               ncw_ms=NCW_CHUNK_DECODE_MS)
    print(f"layout: one {SWEEP_CHUNK}-row decode: convolutions {counts} (expected "
          f"{CHUNK_CONVS}); cuDNN transposes {transposes or 'none'}; layout copies of maps "
          f"of >= {smallest} elements {copies or 'none'}; against the plain convolution "
          f"rel-L2 {rel:.3g}, {'the same bits' if out['equal'] else 'not the same bits'}")
    print(f"timing: [{card}] the {SWEEP_CHUNK}-row decode's device time (profiled) "
          f"{device_ms:.3f} ms; through the plain convolution {plain_ms:.3f} ms; on NCW "
          f"maps with cuDNN's transposes {NCW_CHUNK_DECODE_MS:.2f} ms (PERF.md, z1)")
    if counts != CHUNK_CONVS or transposes or copies or not rel <= 1e-2:
        raise AssertionError(f"the convolutions did not run in cuDNN's layout: {out}")
    del pipe, fn, got, want
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20, help="timed calls per measurement")
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from simulgen_vae_tpu_torch import generate as tgen
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
    seconds = _build.build()
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke_build.log").write_text(
        "\n".join(f"== {k}\n{v}" for k, v in _build.BUILD_LOG.items()))
    print(f"build: {max(seconds.values()):.1f} s for {len(seconds)} libraries "
          f"({', '.join(f'{k} {v:.1f}' for k, v in seconds.items())})")
    sass = sass_check(_build)

    # 3a. the flagship pipeline (built before phase 2 to learn the shapes)
    setup = serving_setup(args.seed)
    cfg, lc_cfg, vae_params, lc_params, scalers, inputs = (
        setup.cfg, setup.lc_cfg, setup.vae_params, setup.lc_params, setup.scalers,
        setup.inputs)

    def pipeline(dtype):
        return tgen.make_pipeline(cfg, lc_cfg, vae_params, lc_params, device="cuda",
                                  dtype=dtype, **scalers)

    pipe = pipeline(torch.bfloat16)
    calls = []
    with recording_calls(blocks, calls):  # the raw field: the readout's GroupNorm is a call
        tgen.generate(pipe, inputs[:B], descale_output=False, max_batch=B)
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
    erfc = erfc_bits(blocks, gen)
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
                  f"launches): {k['ms']:.4f} ms, device only "
                  f"{k['device_ms']:.4f} ms; library {k['library_ms']:.4f} ms, device only "
                  f"{k['library_device_ms']:.4f} ms; plain {k['plain_ms']:.4f} ms; bound "
                  f"{k['bound_ms']:.4f} ms; below the library call: "
                  f"{k['ms'] < k['library_ms']} (both timings), "
                  f"{k['device_ms'] < k['library_device_ms']} (device only)")
    del pipe, fn, batch
    torch.cuda.empty_cache()

    # 5. the train step
    train_kernels, recon_kernel, train, ctx = phase_train(args, card, blocks, gg, ga, gen)
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
    kernels.append(recon_kernel)  # the unfused path's alone: phases 6 and 7 never launch it
    del data, data32
    torch.cuda.empty_cache()

    # 8. serving from model_save/ through the CLI
    int8_kernel, artifacts, cli_launches = phase_artifacts(args, card, gg, gen)
    for k in kernels:
        if k["name"] in REPLACES:
            k["launches_artifacts"] = cli_launches[k["name"]]
    kernels.append(int8_kernel)

    # 9. the training CLI at the flagship geometry; 10. the image conditioners
    # on its trained VAE, in its work directory
    # 11. the image_pca input type, in the same work directory
    work, base, free = _work_dir()
    with work as tmp:
        cli_launches, cli_train = phase_cli_train(args, card, Path(tmp), base, free)
        e2e_launches, vit_launches, images = phase_images(args, card, Path(tmp))
        pca_launches, pca = phase_pca(args, card, Path(tmp))
        # 12. the mesh: two ranks on the card, then the CLI under torchrun
        mesh_launches, mesh = phase_mesh(args, card, Path(tmp))
    for k in kernels:
        for tag, per_rank in mesh_launches.items():
            if k["name"] in per_rank[0]:
                k[f"launches_mesh_{tag}"] = [counts[k["name"]] for counts in per_rank]
    # 13. the readout's fused pass into the served field
    epilogue_kernel, epilogue = phase_epilogue(args, card, pipeline, inputs)
    kernels.append(epilogue_kernel)
    # 14. the convolutions' layout
    layout = phase_layout(args, card, pipeline, inputs)
    for k in kernels:
        for key, counts in (("launches_cli_train", cli_launches),
                            ("launches_images_e2e", e2e_launches),
                            ("launches_images_vit", vit_launches),
                            ("launches_pca", pca_launches)):
            if k["name"] in counts:
                k[key] = counts[k["name"]]
    result = dict(card=card, kind=kind, seed=args.seed, decode_p50_ms=decode_p50,
                  decode_p75_ms=decode_p75, decode_calls=DECODE_CALLS,
                  samples_per_s=B / decode_p50 * 1e3, plain_decode_p50_ms=plain_p50,
                  serve_checks=checks, launches=launches, kernels=kernels, train=train,
                  readout_sass=sass, onepass_launch=onepass, gn_stats_launch=stats_launch,
                  erfc=erfc,
                  fused_train=fused, stack_train=stack, artifacts=artifacts,
                  cli_train=cli_train, images=images, pca=pca, mesh=mesh,
                  epilogue=epilogue, layout=layout, profiler_sessions=PROFILER_SESSIONS,
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
