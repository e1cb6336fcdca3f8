"""The drivers and the plain reference against the port at a tiny size on
the CPU: in f32 they agree to rounding; a broken program, and the control
in 8-bit floats, come out as not correct."""

import json

import numpy as np
import pytest
import torch

import readings
import tiny
from benchlib import compare, harness, trace
from reference import batch as ref_batch

SEEDS = (3, 2 ** 31 + 5)


@pytest.mark.parametrize("seed", SEEDS)
def test_train_loop_agrees_with_the_reference_in_f32(seed):
    out = tiny.run(tiny.TRAIN, tiny.config(), seed)
    assert out.correct, out.checks
    assert out.attempted > 0 and out.failed == 0
    assert out.e2e["train_samples_per_s"] > 0 and out.e2e["setup_s"] > 0


@pytest.mark.parametrize("cell, conditioner", [(tiny.SWEEP, None), (tiny.INTERACTIVE, tiny.CNN)])
@pytest.mark.parametrize("seed", SEEDS)
def test_serving_agrees_with_the_reference_in_f32(cell, conditioner, seed):
    cfg = tiny.config() if conditioner is None else tiny.config(conditioner=conditioner)
    out = tiny.run(cell, cfg, seed)
    assert out.correct, out.checks
    assert out.attempted > 0 and out.failed == 0
    assert out.e2e["serve_fields_per_s"] > 0
    if cell.get("wait_for_each"):
        assert out.e2e["serve_latency_p95_ms"] > 0
    else:
        assert "serve_latency_p95_ms" not in out.e2e


def test_the_reference_draws_what_the_trainer_draws(monkeypatch):
    from simulgen_vae_tpu_torch.train import vae_trainer

    seen = []
    gather = vae_trainer.gather_augment

    def spy(data, idx, pidx, seed, lam, amp, sd, generator=None):
        seen.append(dict(rows=idx.numpy().copy(), partners=pidx.numpy().copy(), seed=seed,
                         lam=lam.numpy().copy(), amp=amp.numpy().copy(),
                         noise_sd=sd.numpy().copy()))
        return gather(data, idx, pidx, seed, lam, amp, sd, generator=generator)

    monkeypatch.setattr(vae_trainer, "gather_augment", spy)
    cfg = tiny.config(augmentation=dict(tiny.AUG, noise_prob=0.5))
    out = tiny.run(tiny.TRAIN, cfg, 2 ** 33 + 1)
    assert out.attempted > 0
    want = ref_batch.first_steps(2 ** 33 + 1, cfg["num_param"], cfg["batch_size"],
                                 cfg["augmentation"], 3)
    for have, w in zip(seen[:3], want):
        assert have["seed"] == w["seed"]
        for k in ("rows", "partners", "lam", "amp", "noise_sd"):
            np.testing.assert_array_equal(have[k], w[k])


def test_the_reference_batch_is_the_ports_without_noise():
    from simulgen_vae_tpu_torch.ops.gather_augment import gather_augment_reference

    g = torch.Generator().manual_seed(0)
    data = torch.randn((6, 5, 12), generator=g)
    d = ref_batch.first_steps(7, 6, 4, tiny.AUG, 1)[0]
    t = lambda a, dt: torch.as_tensor(np.asarray(a), dtype=dt)  # noqa: E731
    port = gather_augment_reference(data, t(d["rows"], torch.int32), t(d["partners"], torch.int32),
                                    None, t(d["lam"], torch.float32), t(d["amp"], torch.float32),
                                    t(d["noise_sd"], torch.float32))
    ref = ref_batch.assemble(data[d["rows"]], data[d["partners"]], d, noise=False)
    torch.testing.assert_close(ref, port, rtol=0, atol=0)


@pytest.mark.parametrize("ctr, key, want", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_gives_the_published_answers(ctr, key, want):
    words = ref_batch.philox(*(torch.tensor([c], dtype=torch.int64) for c in ctr), *key)
    assert tuple(int(w) for w in words) == want


def test_philox_normals_are_standard_normals():
    n = ref_batch.philox_normals(12345, 3, 400_001, "cpu")
    assert n.shape == (400_001,) and torch.isfinite(n).all()
    assert abs(float(n.mean())) < 0.01 and abs(float(n.std()) - 1.0) < 0.01


@pytest.mark.parametrize("kind, cell, conditioner", [
    ("unchanged", tiny.TRAIN, None), ("half_batch", tiny.TRAIN, None),
    ("altered", tiny.SWEEP, None), ("altered", tiny.INTERACTIVE, tiny.CNN)])
def test_a_broken_program_is_not_correct(kind, cell, conditioner):
    cfg = tiny.config() if conditioner is None else tiny.config(conditioner=conditioner)
    ctx = harness.Ctx("tiny", cell, cfg, 5, 0.2, False, torch.device("cpu"))
    out = readings.faulty_run(ctx, kind)
    assert not out.correct, out.checks


def test_the_8bit_control_reads_far_above_the_bf16_program():
    cfg = tiny.config("bfloat16")
    program = [dict((k, v) for k, (v, _) in tiny.run(tiny.TRAIN, cfg, s).checks.items())
               for s in (1, 2)]
    control = [readings.control_train(cfg, s, torch.device("cpu")) for s in (1, 2)]
    for key in ("loss_gap", "grad_gap"):
        assert min(c[key] for c in control) > 2 * max(p[key] for p in program), key
    serve = [readings.control_serve(cfg, tiny.SWEEP, s, torch.device("cpu"), 4) for s in (1, 2)]
    served = [tiny.run(tiny.SWEEP, cfg, s).checks["field_gap"][0] for s in (1, 2)]
    assert min(c["field_gap"] for c in serve) > 3 * max(served)


@pytest.mark.chip
@pytest.mark.parametrize("cell", [w["name"] for w in harness.manifest()["workloads"]])
def test_the_8bit_control_fails_each_cell_at_its_own_size(card, cell):
    wl, cfg = harness.cell_files(cell)
    if wl["driver"] == "train_loop":
        got = readings.control_train(cfg, 7, card)
    else:
        got = readings.control_serve(cfg, wl, 7, card)
    assert any(got[k] > lim for k, lim in wl["limits"].items()), got


def test_trace_reduction_on_a_made_up_trace():
    ev = [
        {"name": "cudaDeviceSynchronize", "cat": "cuda_runtime", "ts": 40.0, "dur": 10.0},
        {"name": "cudaMemsetAsync", "cat": "cuda_runtime", "ts": 100.0, "dur": 0.5},
        {"name": "cudaDeviceSynchronize", "cat": "cuda_runtime", "ts": 195.0, "dur": 5.0},
        {"name": "k1", "cat": "kernel", "ts": 90.0, "dur": 20.0},
        {"name": "k2", "cat": "kernel", "ts": 120.0, "dur": 30.0},
        {"name": "k2", "cat": "kernel", "ts": 140.0, "dur": 20.0},
        {"name": "Memcpy", "cat": "gpu_memcpy", "ts": 190.0, "dur": 30.0},
        {"name": "cudaLaunchKernel", "cat": "cuda_runtime", "ts": 101.0, "dur": 2.0},
        {"name": "cudaLaunchKernelExC", "cat": "cuda_runtime", "ts": 119.0, "dur": 2.0},
        {"name": "cudaGraphLaunch", "cat": "cuda_runtime", "ts": 250.0, "dur": 2.0},
        {"name": "cudaStreamSynchronize", "cat": "cuda_runtime", "ts": 105.0, "dur": 20.0},
        {"name": "cudaMemcpyAsync", "cat": "cuda_runtime", "ts": 106.0, "dur": 5.0},
    ]
    t = trace.summarize(ev)
    assert t.window_s == pytest.approx(100e-6) and t.busy_s == pytest.approx(60e-6)
    assert t.launches == 2
    assert trace.window_bounds(ev) == (100.0, 200.0)
    assert t.kernel_s["k2"] == pytest.approx(50e-6) and t.kernel_s["k1"] == pytest.approx(10e-6)
    assert t.gaps == pytest.approx({"cudaStreamSynchronize": 10e-6, "python": 30e-6})
    assert json.loads(json.dumps(t.breakdown()))["device_ops"][0][0] == "k2"


@pytest.mark.parametrize("name, counted", [
    ("sm90_xmma_wgrad_indexed_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize128x128x64", True),
    ("void cudnn::engines_precompiled::nchwToNhwcKernel<__nv_bfloat16, __nv_bfloat16, float>", True),
    ("void cutlass__5x_cudnn::Kernel<cutlass_tensorop_bf16_s16816dgrad_analytic_bf16>", True),
    ("nvjet_tst_320x128_64x3_2x1_v_bz_coopB_TNT", True),
    ("void cublasLt::splitKreduce_kernel<32, 16, int, float, __nv_bfloat16>", True),
    ("void (anonymous namespace)::gn_bwd_stats_kernel<__nv_bfloat16, 2, 8, 1024>", False),
    ("void (anonymous namespace)::fused_adamw_kernel<0, 0>", False),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>>", False),
    ("void at::native::elementwise_kernel<128, 2, addr_kernel_cuda>", False),
])
def test_conv_patterns_take_the_library_products_and_nothing_else(name, counted):
    from benchlib.readers import CONV_KERNELS

    t = trace.Trace(window_s=1.0, busy_s=1.0, kernel_s={name: 0.5})
    assert t.kernel_seconds(CONV_KERNELS) == (0.5 if counted else 0.0)


def test_a_reader_that_finds_nothing_reports_nothing():
    out = harness.Outcome(e2e={}, attempted=1, failed=0, checks={}, memory_peak_bytes=0,
                          config=tiny.config(), workload=tiny.TRAIN)
    for name in ("device_idle.train", "conv_ms.train", "gn_roofline.train",
                 "fused_adamw_roofline.train", "launch_calls.train", "mfu.train"):
        assert harness.reader(name).read(out) is None, name


def test_leaf_gap_takes_the_median_leaf_as_the_floor():
    want = {"a": 1.0, "b": 2.0, "c": 1e-9}
    gap, leaf = compare.leaf_gap({"a": 1.0, "b": 2.0, "c": 0.5}, want)
    assert leaf == "c" and gap == pytest.approx(0.5 / 1.0)
