"""``benchlib.spans`` on made-up windows whose gaps, correlation ids and
spans are known: the idle and device splits and their sums, the alignment
check and the span readers, and the existing ``Trace`` fields unchanged by
the spans."""

import copy

import pytest

from benchlib import harness, spans, trace
from simulgen_vae_tpu_torch.utils.profiling import chrome_events

BASE_NS = 1_790_000_000_000_000_000
TRAIN_READERS = ("step_host_ms.train", "assemble_idle_ms.train", "sn_idle_ms.train",
                 "forward_idle_ms.train", "backward_idle_ms.train", "optimizer_idle_ms.train",
                 "unspanned_idle.train")
SWEEP_READERS = ("readout_ms.sweep", "descale_ms.sweep", "concat_ms.sweep")
OLD_READERS = ("device_idle.train", "launch_calls.train", "conv_ms.train")


def _spans(tree, tid=1):
    """``(name, start_us, end_us, parent, key)`` -> the recorder's tuples."""
    return [(n, BASE_NS + int(s * 1e3), BASE_NS + int(e * 1e3), p, k, tid)
            for n, s, e, p, k in tree]


def _window(kernels, end=1950.0):
    """The warm-up sync, one launch call and one kernel per ``(launch_us,
    start_us, end_us, name)``, correlated, and the closing sync at ``end``."""
    ev = [{"name": "cudaDeviceSynchronize", "cat": "cuda_runtime", "ts": 40.0, "dur": 10.0},
          {"name": "cudaDeviceSynchronize", "cat": "cuda_runtime", "ts": end - 60.0,
           "dur": 60.0}]
    for corr, (launch, s, e, name) in enumerate(kernels, start=1):
        ev.append({"name": "cudaLaunchKernel", "cat": "cuda_runtime", "ts": launch, "dur": 5.0,
                   "args": {"correlation": corr}})
        ev.append({"name": name, "cat": "kernel", "ts": s, "dur": e - s,
                   "args": {"correlation": corr}})
    return ev


# Two steps of an epoch; a readout nested in the first forward.
TRAIN_TREE = [
    ("train.epoch", 100, 1900, -1, None),
    ("train.step", 110, 1000, 0, 0),
    ("train.assemble", 120, 300, 1, 0), ("train.forward", 300, 600, 1, 0),
    ("decoder.readout", 400, 560, 3, 0),
    ("train.backward", 600, 800, 1, 0), ("train.optimizer", 800, 950, 1, 0),
    ("train.step", 1000, 1890, 0, 1),
    ("train.assemble", 1020, 1200, 7, 1), ("train.forward", 1200, 1500, 7, 1),
    ("train.backward", 1500, 1700, 7, 1), ("train.optimizer", 1700, 1850, 7, 1),
]
TRAIN_KERNELS = [(130, 150, 250, "gather_augment_kernel"), (310, 320, 550, "sm90_xmma_fprop"),
                 (610, 620, 790, "sm90_xmma_dgrad"), (810, 850, 1000, "fused_adamw_kernel"),
                 (1030, 1100, 1150, "gather_augment_kernel"), (1210, 1250, 1490, "nvjet_tst"),
                 (1510, 1510, 1690, "sm90_xmma_wgrad"), (1710, 1750, 1880, "grad_norm_kernel")]
# Idle microseconds by innermost span, worked out by hand from the above.
TRAIN_IDLE_US = {"unspanned": 50, "train.epoch": 10, "train.epoch/train.step": 30,
                 "train.epoch/train.step/train.assemble": 200,
                 "train.epoch/train.step/train.forward": 120,
                 "train.epoch/train.step/train.forward/decoder.readout": 10,
                 "train.epoch/train.step/train.backward": 50,
                 "train.epoch/train.step/train.optimizer": 100}


def _train_events(shift_us=0.0):
    ev = _window(TRAIN_KERNELS)
    tree = [(n, s + shift_us, e + shift_us, p, k) for n, s, e, p, k in TRAIN_TREE]
    return ev + chrome_events(_spans(tree), BASE_NS, pid=1)


def _outcome(events, units, batch=16, counts=None):
    t = trace.summarize(events)
    spans.attach(t, events, counts or {"train.steps": units})
    return harness.Outcome(e2e={}, attempted=1, failed=0, checks={}, memory_peak_bytes=0,
                           config={}, workload={}, trace=t, traced_units=units,
                           facts=dict(batch=batch))


def test_idle_split_by_innermost_span_sums_to_the_windows_idle():
    ev = _train_events()
    got = spans.attribute(ev)
    assert got["span_idle_s"] == pytest.approx({k: v * 1e-6 for k, v in TRAIN_IDLE_US.items()})
    t = trace.summarize(ev)
    assert sum(got["span_idle_s"].values()) == pytest.approx(t.window_s - t.busy_s)
    assert got["spans_aligned"] and got["span_launch_share"] == 1.0


def test_device_time_goes_to_the_span_of_its_launch_call():
    got = spans.attribute(_train_events(), kernels=("fused_adamw", "grad_norm", "gather_augment"))
    dev = got["span_device_s"]
    assert dev["train.epoch/train.step/train.optimizer"] == pytest.approx(280e-6)
    assert dev["train.epoch/train.step/train.assemble"] == pytest.approx(150e-6)
    assert "train.epoch" not in dev  # every call was made inside a phase
    assert sum(dev.values()) == pytest.approx(trace.summarize(_train_events()).busy_s)
    kern = got["span_kernel_s"]
    assert set(kern["fused_adamw"]) == set(kern["grad_norm"]) == {
        "train.epoch/train.step/train.optimizer"}
    assert set(kern["gather_augment"]) == {"train.epoch/train.step/train.assemble"}


def test_a_kernel_without_its_call_is_unmatched_and_host_means_per_name():
    ev = _train_events()
    for e in ev:
        if e.get("cat") == "kernel" and e["name"] == "sm90_xmma_dgrad":
            e["args"]["correlation"] = 999
    got = spans.attribute(ev)
    assert got["span_device_s"]["unmatched"] == pytest.approx(170e-6)
    assert got["span_host_s"]["train.step"] == pytest.approx((890 + 890) / 2 * 1e-6)
    assert got["span_host_s"]["decoder.readout"] == pytest.approx(160e-6)


def test_train_readers_read_the_split():
    run = _outcome(_train_events(), units=2)
    read = {n: harness.reader(n).read(run) for n in TRAIN_READERS}
    assert read["assemble_idle_ms.train"] == pytest.approx(0.100)
    assert read["forward_idle_ms.train"] == pytest.approx(0.065)  # the readout's 10 us in it
    assert read["backward_idle_ms.train"] == pytest.approx(0.025)
    assert read["optimizer_idle_ms.train"] == pytest.approx(0.050)
    assert read["sn_idle_ms.train"] is None  # no such span in this window
    assert read["unspanned_idle.train"] == pytest.approx(100 * 90 / 570)
    assert read["step_host_ms.train"] == pytest.approx(0.890)
    phases = sum(read[n] for n in TRAIN_READERS[1:6] if read[n] is not None)
    idle_ms = (run.trace.window_s - run.trace.busy_s) * 1e3 / 2
    assert phases + read["unspanned_idle.train"] / 100 * idle_ms == pytest.approx(idle_ms)


def test_spans_shifted_by_a_millisecond_are_not_aligned_and_nothing_is_read():
    run = _outcome(_train_events(shift_us=1000.0), units=2)
    assert run.trace.spans_aligned is False
    for name in TRAIN_READERS:
        assert harness.reader(name).read(run) is None, name


def test_readers_need_the_runs_own_count_of_steps():
    run = _outcome(_train_events(), units=2, counts={"train.steps": 3})
    for name in TRAIN_READERS:
        assert harness.reader(name).read(run) is None, name


def test_existing_fields_and_breakdown_are_the_same_with_and_without_spans():
    bare = _window(TRAIN_KERNELS)
    spanned = _train_events()
    a, b = trace.summarize(copy.deepcopy(bare)), trace.summarize(spanned)
    assert (a.window_s, a.busy_s, a.kernel_s, a.launches, a.gaps) == (
        b.window_s, b.busy_s, b.kernel_s, b.launches, b.gaps)
    run_a = _outcome(bare, units=2)
    run_b = _outcome(spanned, units=2)
    assert run_a.trace.breakdown() == run_b.trace.breakdown()
    for name in OLD_READERS:
        assert harness.reader(name).read(run_a) == harness.reader(name).read(run_b), name
    assert harness.reader("unspanned_idle.train").read(run_a) is None  # no spans at all


# Two requests of two chunks each: conditioner, decode (a readout in it), descale; concat.
def _request(at, parent0):
    r = parent0
    return [("serve.request", at, at + 400, -1, r),
            ("serve.chunk", at + 10, at + 180, r, None),
            ("serve.decode", at + 20, at + 150, r + 1, None),
            ("decoder.readout", at + 100, at + 150, r + 2, None),
            ("serve.descale", at + 150, at + 180, r + 1, None),
            ("serve.chunk", at + 190, at + 360, r, None),
            ("serve.decode", at + 200, at + 330, r + 5, None),
            ("decoder.readout", at + 280, at + 330, r + 6, None),
            ("serve.descale", at + 330, at + 360, r + 5, None),
            ("serve.concat", at + 360, at + 400, r, None)]


def _request_kernels(at):
    return [(at + 25, at + 30, at + 110, "conv"), (at + 105, at + 110, at + 160, "readout"),
            (at + 155, at + 160, at + 200, "descale"), (at + 205, at + 210, at + 290, "conv"),
            (at + 285, at + 290, at + 340, "readout"), (at + 335, at + 340, at + 380, "descale"),
            (at + 365, at + 380, at + 420, "cat")]


def _sweep_events(shift_us=0.0):
    tree = _request(100, 0) + _request(600, 10)
    tree = [(n, s + shift_us, e + shift_us, p, k) for n, s, e, p, k in tree]
    for i, (n, s, e, p, k) in enumerate(tree):  # keys handed down, as the recorder does
        if k is None:
            tree[i] = (n, s, e, p, tree[p][4])
    ev = _window(_request_kernels(100) + _request_kernels(600), end=1200.0)
    return ev + chrome_events(_spans(tree), BASE_NS, pid=1)


def test_sweep_readers_give_device_ms_a_request():
    run = _outcome(_sweep_events(), units=2 * 16, counts={"serve.requests": 2})
    assert run.trace.spans_aligned
    read = {n: harness.reader(n).read(run) for n in SWEEP_READERS}
    assert read["readout_ms.sweep"] == pytest.approx(2 * 50e-3)
    assert read["descale_ms.sweep"] == pytest.approx(2 * 40e-3)
    assert read["concat_ms.sweep"] == pytest.approx(40e-3)
    dev = run.trace.span_device_s
    serving = sum(v for k, v in dev.items() if k != "unspanned" and k != "unmatched")
    assert serving == pytest.approx(run.trace.busy_s)
    wrong = _outcome(_sweep_events(), units=2 * 16, counts={"serve.requests": 3})
    assert all(harness.reader(n).read(wrong) is None for n in SWEEP_READERS)
    shifted = _outcome(_sweep_events(shift_us=1000.0), units=32, counts={"serve.requests": 2})
    assert all(harness.reader(n).read(shifted) is None for n in SWEEP_READERS)
