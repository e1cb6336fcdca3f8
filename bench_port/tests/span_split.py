"""The program's spans over a cell's profiled window on the card: the split
of idle and device time by phase, the span readers' values, and what
recording the spans costs.

    python3 bench_port/tests/span_split.py --workload train_t200 --seed 7 --seconds 5 --turns 8 --untraced 8

Runs the cell as ``run.py --trace 1`` does, except that the profiled
window is taken ``--turns`` times, in turns with
``simulgen_vae_tpu_torch.utils.profiling.recording()`` off and on (off,
on, on, off, ...), in this one process, after ``--untraced`` runs of the
same steps or requests without the profiler, timed on the host clock to a
synchronize, in the same turns. A window with recording on gets the spans laid
over it (``benchlib.spans``). ``benchlib.trace.profiled`` opens no recording
itself, so this script swaps its own window in for it. The last window with
spans is the run's trace: the span readers (``SPAN_READERS``) and the
cell's own per-layer readers read it. Prints one JSON line and writes it to
``chiprun_out/span_split_<cell>_<seed>.json``: per turn the window, busy
and launch counts; ms a unit and what recording costs, traced and not; for the turns with spans the alignment, the idle and
device split by span path, where the ``KERNELS`` ran, the spans' mean host
ms and the counters; then ``metrics``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import sys
import tempfile
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
sys.path[:0] = [str(BENCH_DIR), str(ROOT)]
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / ".cache" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / ".cache" / "triton"))

from benchlib import harness, spans, trace  # noqa: E402

SPAN_READERS = ("step_host_ms.train", "assemble_idle_ms.train", "sn_idle_ms.train",
                "forward_idle_ms.train", "backward_idle_ms.train", "optimizer_idle_ms.train",
                "unspanned_idle.train", "readout_ms.sweep", "descale_ms.sweep",
                "concat_ms.sweep")
KERNELS = ("fused_adamw", "grad_norm", "gather_augment", "readout_", "gn_")


def capture(fn, record: bool):
    """``(events, out, counters)`` of one window as ``trace.profiled`` takes
    it, the spans among the events where ``record``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from simulgen_vae_tpu_torch.utils import profiling

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(trace.WARM_KERNELS):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(0.05)
        with profiling.recording() if record else contextlib.nullcontext() as rec:
            out = fn()
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
    finally:
        os.unlink(path)
    events = doc["traceEvents"]
    if rec is None:
        return events, out, {}
    events += profiling.chrome_events(rec.spans, int(doc["baseTimeNanoseconds"]))
    return events, out, rec.counters


def _top(split: dict, n: int = 14) -> dict:
    return dict(sorted(split.items(), key=lambda kv: -kv[1])[:n])


def _records(turn: int) -> bool:
    """Off, on, on, off, ...: each pair of turns in both orders."""
    return turn % 4 in (1, 2)


def _cuda_sync():
    import torch

    torch.cuda.synchronize()


def turns_of(turns: int, log: list, capture_fn=capture, untraced: int = 0, sync=_cuda_sync):
    """A stand-in for ``trace.profiled``: ``fn`` run ``untraced`` times
    without the profiler and then taken ``turns`` times in its window,
    recording on every other pair (``_records``), each turn logged into
    ``log``."""
    from simulgen_vae_tpu_torch.utils import profiling

    def profiled(fn):
        for turn in range(untraced):
            record = _records(turn)
            sync()
            t0 = time.perf_counter()
            with profiling.recording() if record else contextlib.nullcontext():
                fn()
                sync()
            log.append(dict(turn=turn, traced=False, record=record,
                            window_s=time.perf_counter() - t0))
        kept = None
        for turn in range(turns):
            record = _records(turn)
            t0 = time.perf_counter()
            events, out, counts = capture_fn(fn, record)
            host_s = time.perf_counter() - t0
            t = trace.summarize(events)
            row = dict(turn=turn, traced=True, record=record, window_s=t.window_s,
                       busy_s=t.busy_s, launches=t.launches, host_s=host_s)
            if record:
                got = spans.attribute(events, KERNELS)
                spans.attach(t, events, counts)
                row.update(aligned=got["spans_aligned"], launch_share=got["span_launch_share"],
                           idle_s=_top(got["span_idle_s"]), device_s=_top(got["span_device_s"]),
                           kernel_s=got["span_kernel_s"], host_mean_s=got["span_host_s"],
                           counters={k: v for k, v in counts.items() if v})
                kept = t
            del events  # the next turn runs without this one's events alive
            log.append(row)
        return (kept or t), out

    return profiled


def measure(ctx, turns: int, names, capture_fn=capture, untraced: int = 0,
            sync=_cuda_sync) -> dict:
    """Runs the cell of ``ctx`` with ``fn`` run ``untraced`` times and its
    window taken ``turns`` times, and reads the readers ``names`` off the
    last window with spans."""
    log: list = []
    real = trace.profiled
    trace.profiled = turns_of(turns, log, capture_fn, untraced, sync)
    try:
        outcome = harness.driver(ctx.workload["driver"]).run(ctx)
    finally:
        trace.profiled = real
    units = outcome.traced_units
    per_unit = {(tr, r): [1e3 * x["window_s"] / units for x in log
                          if x["traced"] == tr and x["record"] == r]
                for tr in (False, True) for r in (False, True)}
    cost = {}
    for tr, label in ((True, "traced"), (False, "untraced")):
        off, on = per_unit[tr, False], per_unit[tr, True]
        if off and on:
            cost[label] = statistics.median(on) / statistics.median(off) - 1.0
    return dict(workload=ctx.cell, seed=ctx.seed, traced_units=units,
                correct=outcome.correct, checks=outcome.checks, e2e=outcome.e2e, turns=log,
                metrics={n: harness.reader(n).read(outcome) for n in names},
                ms_per_unit={f"{'traced' if tr else 'untraced'}_{'on' if r else 'off'}": v
                             for (tr, r), v in per_unit.items()},
                on_cost=cost)


def run(workload: str, seed: int, seconds: float, turns: int, untraced: int) -> dict:
    import torch

    man = harness.manifest()
    wl, cfg = harness.cell_files(workload)
    ctx = harness.Ctx(cell=workload, workload=wl, config=cfg, seed=seed, seconds=seconds,
                      trace=True, device=torch.device("cuda", 0))
    _, layer = harness.cell_metrics(man, workload)
    kind = ".sweep" if wl["driver"] == "serve_closed_loop" else ".train"
    names = [m["name"] for m in layer] + [n for n in SPAN_READERS if n.endswith(kind)]
    return measure(ctx, turns, names, untraced=untraced)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--turns", type=int, default=6)
    p.add_argument("--untraced", type=int, default=0)
    args = p.parse_args(argv)
    out = run(args.workload, args.seed, args.seconds, args.turns, args.untraced)
    line = json.dumps(out, default=str)
    os.makedirs(ROOT / "chiprun_out", exist_ok=True)
    (ROOT / "chiprun_out" / f"span_split_{args.workload}_{args.seed}.json").write_text(line)
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
