"""A profiler window with the program's spans recorded over it, and what the
E2E cell's span readers read from it.

``profiled`` runs ``fn`` inside ``trace.profiled``'s window (the card's
activity and the CUDA runtime's calls, spin kernels and a synchronize
first) and inside the program's ``profiling.recording()``, adds
the recorded spans to the exported events (``profiling.chrome_events``) and
lays them over the window (``attach``): each kernel's, copy's and memset's
device time goes to the innermost main-thread span holding its launch call
(autograd's thread launches inside the main thread's ``lc.backward``), each
idle gap to the spans covering it, under the paths ``spans.segments`` gives
(``lc.epoch/lc.step/lc.conditioner``). The roots are the conditioner
trainer's: ``lc.epoch`` and each held-out ``lc.eval`` batch. A program
whose trainer has no such spans leaves the fields empty, and the readers
return None.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time

from benchlib import spans
from benchlib.trace import DEVICE_CATS, HOST_CATS, LAUNCH_CALLS, WARM_KERNELS, _merge
from benchlib.trace import summarize, window_bounds

ROOTS = ("lc.epoch", "lc.eval")
STEP = "lc.step"


def profiled(fn):
    """``(Trace, fn())`` with ``fn`` run inside the profiler's window and the
    program's recording; the trace carries the span fields (``attach``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from simulgen_vae_tpu_torch.utils import profiling

    with profiling.recording() as rec, profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(WARM_KERNELS):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(0.05)
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
    events = doc["traceEvents"] + profiling.chrome_events(rec.spans,
                                                          int(doc["baseTimeNanoseconds"]))
    return attach(summarize(events), events, rec.counters), out


def attach(trace, events: list, counts: dict):
    """``trace`` with ``span_device_s`` and ``span_idle_s`` (seconds by span
    path, ``spans.UNSPANNED`` under none, ``spans.UNMATCHED`` for a record
    with no launch call), ``span_launch_share`` (the window's launch calls
    inside a root span) and ``span_counts`` (the recording's counters)."""
    recorded = spans.program_spans(events)
    t0, t1 = window_bounds(events)
    tid = next((s[4] for s in recorded if s[3] in ROOTS), None)
    segs = spans.segments([s for s in recorded if s[4] == tid]) if tid is not None else []
    starts = [s[0] for s in segs]
    roots = sorted((s[0], s[1]) for s in recorded if s[3] in ROOTS and s[4] == tid)
    root_starts = [r[0] for r in roots]
    device, calls, inside, launches = [], {}, 0, 0
    for e in events:
        cat, ts = e.get("cat"), e.get("ts")
        if ts is None:
            continue
        ts, dur = float(ts), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            s, t = max(ts, t0), min(ts + dur, t1)
            if t > s:
                device.append((s, t, e.get("args", {}).get("correlation")))
        elif cat in HOST_CATS:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                calls[corr] = ts
            if e.get("name") in LAUNCH_CALLS and t0 <= ts <= t1:
                launches += 1
                i = bisect.bisect_right(root_starts, ts) - 1
                inside += i >= 0 and roots[i][1] >= ts
    dev_s, idle, last = {}, {}, t0
    for s, t, corr in device:
        path = spans._at(calls[corr], segs, starts) if corr in calls else spans.UNMATCHED
        dev_s[path] = dev_s.get(path, 0.0) + (t - s) * 1e-6
    for s, e in _merge([(d[0], d[1]) for d in device]) + [[t1, t1]]:
        if s > last:
            spans._split(last, s, segs, starts, idle)
        last = max(last, e)
    trace.span_device_s, trace.span_idle_s = dev_s, idle
    trace.span_launch_share = inside / launches if launches else 0.0
    trace.span_counts = dict(counts)
    return trace


def steps(run):
    """``(trace, steps)`` where the recording counted the run's traced
    training steps and nearly every launch call lay inside a root span."""
    t = run.trace
    if (t is None or run.traced_units <= 0
            or getattr(t, "span_launch_share", 0.0) < spans.ALIGNED
            or t.span_counts.get("lc.steps") != run.traced_units):
        return None
    return t, run.traced_units


def step_phase_ms(run, phase: str):
    """Device ms a training step launched under ``phase`` inside ``lc.step``
    (the held-out pass's spans are not counted)."""
    got = steps(run)
    if got is None:
        return None
    hits = [v for path, v in got[0].span_device_s.items()
            if STEP in path.split("/") and phase in path.split("/")]
    return 1e3 * sum(hits) / got[1] if hits else None
