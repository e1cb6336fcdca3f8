"""The E2E cell's driver and reference at a tiny size on the CPU: in f32 the
program is correct; the 8-bit control, a detached descale and half the
batch are not. The frozen FLOP and byte counts against a hand count of one
small shape, and the span readers on a run without spans."""

import pytest
import torch

import e2e_readings
import tiny
from benchlib import e2e_work, harness, work

SEEDS = (3, 2 ** 31 + 5)
CELL = dict(driver="e2e_loop", limits=dict(loss_gap=1e-4, grad_gap=1e-3, change_gap=1e-3))
E2E = dict(batch_size=4, lr=1e-3, weight_decay=1e-5, epochs=500, loss_function="Huber",
           lc_alpha=1000.0, latent_regularization=True, latent_reg_weight=1e-3, val_split=0.3)
CNN = dict(type="cnn", filters=[4, 8, 8, 16, 16, 16], image_side=16, spatial_attention=True,
           dropout_rate=0.2)


def config(dtype="float32"):
    return tiny.config(dtype, num_param=20, conditioner=dict(CNN), e2e=dict(E2E))


@pytest.mark.parametrize("seed", SEEDS)
def test_e2e_loop_agrees_with_the_reference_in_f32(seed):
    out = tiny.run(CELL, config(), seed)
    assert out.correct, out.checks
    assert out.attempted > 0 and out.attempted % 3 == 0 and out.failed == 0
    assert out.e2e["train_samples_per_s"] > 0 and out.e2e["setup_s"] > 0
    assert out.window["flops_per_unit"] == e2e_work.step_flops(config())


@pytest.mark.parametrize("kind", e2e_readings.FAULTS)
def test_a_broken_program_is_not_correct(kind):
    ctx = harness.Ctx("tiny", CELL, config(), 5, 0.2, False, torch.device("cpu"))
    out = e2e_readings.faulty_run(ctx, kind)
    assert not out.correct, out.checks


def test_the_8bit_control_is_not_correct():
    got = e2e_readings.control(config(), 5, torch.device("cpu"))
    assert any(got[k] > lim for k, lim in CELL["limits"].items()), got


def test_flop_and_byte_counts_match_a_hand_count():
    # a 16 x 16 image through filters 4, 8, 8, 16, 16, 16 (spatial side after
    # the pool 8; blocks 1 and 3 halve it): stem, then each block's 1x1, 3x3,
    # skip, squeeze-excitation and spatial attention, then the linear layers
    stem = 2 * 1 * 4 * 49 * 16 ** 2
    blocks = ((2 * 4 * 4 * 64 + 2 * 4 * 8 * 9 * 64 + 2 * 4 * 8 * 64)
              + (2 * 8 * 4 * 64 + 2 * 4 * 8 * 9 * 16 + 2 * 8 * 8 * 16)
              + (2 * 8 * 8 * 16 + 2 * 8 * 16 * 9 * 16 + 2 * 8 * 16 * 16 + 64 + 2 * 2 * 49 * 16)
              + (2 * 16 * 8 * 16 + 2 * 8 * 16 * 9 * 4 + 2 * 16 * 16 * 4 + 64 + 2 * 2 * 49 * 4)
              + (2 * 16 * 8 * 4 + 2 * 8 * 16 * 9 * 4 + 64 + 2 * 2 * 49 * 4))
    dense = 2 * 16 * 32 + 2 * 32 * 32 + 2 * 2 * (32 * 16 + 16 * 8 + 32 * 8 + 8 * 4)
    cnn = stem + blocks + dense
    assert cnn == 239008
    assert e2e_work.cnn_forward_flops(CNN["filters"], 16, (4, 4)) == cnn
    cfg = config()
    assert e2e_work.split(cfg) == (3, 1)  # 14 training designs, 6 held out, batch 4
    dec = work.field_flops(cfg)
    assert e2e_work.step_flops(cfg) == pytest.approx(4 * (3 * cnn + 2 * dec)
                                                     + 1 * 4 / 3 * (cnn + dec))
    # decoder maps [4, 8, C] of the decoder 8, 8, 16 with 64 nodes: C = 8;
    # 40, 40, 8, then 8, 8, 16; 80, 80, 16; the readout's 64
    elems = 4 * 8 * (8 + 40 + 40 + 8 + 8 + 8 + 16 + 80 + 80 + 16 + 64)
    assert e2e_work.gn_bytes(cfg) == pytest.approx(elems * 4 * (5 + 2 / 3))


def test_the_span_readers_read_nothing_without_spans():
    out = harness.Outcome(e2e={}, attempted=1, failed=0, checks={}, memory_peak_bytes=0,
                          config=config(), workload=CELL, traced_units=3)
    for name in ("conditioner_ms.e2e", "decode_ms.e2e", "backward_ms.e2e", "gn_roofline.e2e"):
        assert harness.reader(name).read(out) is None, name


# One E2E step and one held-out batch; the launch calls and kernels of
# _window (test_bench_port_spans) at hand-set times, microseconds.
E2E_TREE = [
    ("lc.epoch", 100, 1000, -1, None),
    ("lc.step", 110, 990, 0, 0),
    ("lc.augment", 120, 200, 1, 0), ("lc.conditioner", 200, 400, 1, 0),
    ("lc.decode", 400, 600, 1, 0), ("decoder.readout", 500, 600, 4, 0),
    ("lc.loss", 600, 650, 1, 0), ("lc.backward", 650, 900, 1, 0),
    ("lc.optimizer", 900, 980, 1, 0),
    ("lc.eval", 1100, 1800, -1, 0),
    ("lc.conditioner", 1110, 1400, 9, 0), ("lc.decode", 1400, 1790, 9, 0),
]
E2E_KERNELS = [(130, 140, 190, "randn"), (210, 220, 390, "sm90_xmma_fprop"),
               (410, 420, 500, "gn_act_onepass"), (510, 520, 590, "nvjet_tst"),
               (660, 670, 890, "sm90_xmma_dgrad"), (910, 920, 970, "fused_adamw_kernel"),
               (1120, 1130, 1390, "sm90_xmma_fprop"), (1410, 1420, 1780, "gn_stats")]


def _e2e_outcome(counts):
    from benchlib import recorded, trace
    from simulgen_vae_tpu_torch.utils.profiling import chrome_events
    from test_bench_port_spans import BASE_NS, _spans, _window

    ev = _window(E2E_KERNELS) + chrome_events(_spans(E2E_TREE), BASE_NS, pid=1)
    t = recorded.attach(trace.summarize(ev), ev, counts)
    return t, harness.Outcome(e2e={}, attempted=1, failed=0, checks={}, memory_peak_bytes=0,
                              config=config(), workload=CELL, trace=t, traced_units=1)


def test_the_span_readers_on_a_made_up_window():
    t, out = _e2e_outcome({"lc.steps": 1, "lc.eval_batches": 1})
    step = "lc.epoch/lc.step"
    assert t.span_device_s == pytest.approx({
        f"{step}/lc.augment": 50e-6, f"{step}/lc.conditioner": 170e-6,
        f"{step}/lc.decode": 80e-6, f"{step}/lc.decode/decoder.readout": 70e-6,
        f"{step}/lc.backward": 220e-6, f"{step}/lc.optimizer": 50e-6,
        "lc.eval/lc.conditioner": 260e-6, "lc.eval/lc.decode": 360e-6})
    assert t.span_launch_share == 1.0
    assert sum(t.span_idle_s.values()) == pytest.approx(t.window_s - t.busy_s)
    assert harness.reader("conditioner_ms.e2e").read(out) == pytest.approx(0.170)
    assert harness.reader("decode_ms.e2e").read(out) == pytest.approx(0.150)
    assert harness.reader("backward_ms.e2e").read(out) == pytest.approx(0.220)
    _, other = _e2e_outcome({"lc.steps": 2})
    assert harness.reader("decode_ms.e2e").read(other) is None
