"""The program's spans laid over a profiler window: which phase of the
program the card's idle time and its kernels belong to.

The port records its spans (``simulgen_vae_tpu_torch.utils.profiling``)
on the Unix clock, which is the Chrome trace's (``ts`` + the file's
``baseTimeNanoseconds``); ``profiling.chrome_events`` writes them into the
trace's event list as ``program`` events. From such a list:

- ``span_idle_s``: every idle gap of the window (no kernel, copy or memset;
  the gaps of ``trace.summarize``) split over the innermost main-thread
  span covering each part of it, keyed by that span's path from its root
  (``train.epoch/train.step/train.forward``); parts under no span are
  ``unspanned``;
- ``span_device_s``: each kernel's, copy's and memset's device time, given
  to the innermost main-thread span holding its launch call in time (the
  call matched through the ``correlation`` id Kineto writes on both
  records; autograd's thread launches inside the main thread's
  ``train.backward``); a record with no call is ``unmatched``;
- ``span_host_s``: the mean duration of each span name;
- ``spans_aligned``: at least ``ALIGNED`` of the window's launch calls
  fall inside a root span (``ROOTS``), so the two clocks agree.

``attach`` puts these on a ``trace.Trace`` with the recording's counter
changes (``span_counts``); the readers below read them and return None
where the spans are missing, misaligned or count other units than the run.
Ten ``metrics/`` files call them: ``step_host_ms.train``,
``{assemble,sn,forward,backward,optimizer}_idle_ms.train``,
``unspanned_idle.train`` and ``{readout,descale,concat}_ms.sweep``.

They have no entry in ``BENCHMARK.json`` yet: ``trace.profiled`` opens no
recording, so a run's trace holds no spans and they read None. Wiring them
in is a benchmark change to ``trace.py``: in ``profiled``, open
``profiling.recording()`` around ``fn`` where the program has it, keep the
whole exported document, add ``profiling.chrome_events(rec.spans,
doc["baseTimeNanoseconds"])`` to its events, and after ``summarize`` call
``attach(trace, events, rec.counters)``; then the ten ``per_layer``
entries. Until then ``tests/span_split.py`` reads them on the card.
"""

from __future__ import annotations

import bisect

from benchlib.trace import DEVICE_CATS, HOST_CATS, LAUNCH_CALLS, _merge, window_bounds

ROOTS = ("train.epoch", "serve.request")
TRAIN_CONTAINERS = ("train.epoch", "train.step")
UNSPANNED, UNMATCHED = "unspanned", "unmatched"
ALIGNED = 0.99


def program_spans(events: list) -> list:
    """The ``program`` events as ``(start, end, path, name, tid)`` in the
    trace's microseconds, in recording order (their ``parent`` indices)."""
    out = []
    for e in events:
        if e.get("cat") != "program":
            continue
        start = float(e["ts"])
        parent = e.get("args", {}).get("parent", -1)
        path = e["name"] if parent < 0 else f"{out[parent][2]}/{e['name']}"
        out.append((start, start + float(e.get("dur", 0.0)), path, e["name"], e.get("tid")))
    return out


def main_thread(spans: list):
    """The thread of the first root span, or None."""
    return next((s[4] for s in spans if s[3] in ROOTS), None)


def segments(spans: list) -> list:
    """Non-overlapping ``[start, end, path]`` of properly nested spans (one
    thread's), each part labelled with the innermost span covering it."""
    out, stack, cursor = [], [], float("-inf")

    def emit(a, b, path):
        if b > a:
            out.append((a, b, path))

    for start, end, path in sorted(((s[0], s[1], s[2]) for s in spans),
                                   key=lambda s: (s[0], -s[1])):
        while stack and stack[-1][0] <= start:
            e, p = stack.pop()
            emit(cursor, e, p)
            cursor = max(cursor, e)
        if stack:
            emit(cursor, start, stack[-1][1])
        cursor = start
        stack.append((end, path))
    while stack:
        e, p = stack.pop()
        emit(cursor, e, p)
        cursor = max(cursor, e)
    return out


def _split(a: float, b: float, segs: list, starts: list, into: dict) -> None:
    """Add ``[a, b]`` (microseconds) to ``into`` in seconds by segment path,
    the parts no segment covers under ``UNSPANNED``."""
    i = max(bisect.bisect_right(starts, a) - 1, 0)
    at = a
    while at < b and i < len(segs):
        s, e, path = segs[i]
        if e <= at:
            i += 1
            continue
        if s >= b:
            break
        if s > at:
            into[UNSPANNED] = into.get(UNSPANNED, 0.0) + (s - at) * 1e-6
            at = s
        end = min(e, b)
        into[path] = into.get(path, 0.0) + (end - at) * 1e-6
        at = end
        i += 1
    if b > at:
        into[UNSPANNED] = into.get(UNSPANNED, 0.0) + (b - at) * 1e-6


def _at(ts: float, segs: list, starts: list) -> str:
    i = bisect.bisect_right(starts, ts) - 1
    if i >= 0 and segs[i][1] >= ts:
        return segs[i][2]
    return UNSPANNED


def attribute(events: list, kernels=()) -> dict:
    """The span fields of a window's ``events`` (module docstring); with
    ``kernels`` (name patterns) also ``span_kernel_s``: each pattern's
    device seconds by span path."""
    spans = program_spans(events)
    t0, t1 = window_bounds(events)
    tid = main_thread(spans)
    segs = segments([s for s in spans if s[4] == tid]) if tid is not None else []
    starts = [s[0] for s in segs]
    roots = sorted((s[0], s[1]) for s in spans if s[3] in ROOTS and s[4] == tid)
    root_starts = [r[0] for r in roots]

    device, calls, launches = [], {}, []
    for e in events:
        cat, ts = e.get("cat"), e.get("ts")
        if ts is None:
            continue
        ts, dur = float(ts), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            s, t = max(ts, t0), min(ts + dur, t1)
            if t > s:
                device.append((s, t, e.get("name", "?"), e.get("args", {}).get("correlation")))
        elif cat in HOST_CATS:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                calls[corr] = ts
            if e.get("name") in LAUNCH_CALLS and t0 <= ts <= t1:
                launches.append(ts)

    idle, last = {}, t0
    for s, e in _merge([(d[0], d[1]) for d in device]) + [[t1, t1]]:
        if s > last:
            _split(last, s, segs, starts, idle)
        last = max(last, e)

    pats = [p.lower() for p in kernels]
    dev_s, by_kernel = {}, {p: {} for p in kernels}
    for s, t, name, corr in device:
        path = _at(calls[corr], segs, starts) if corr in calls else UNMATCHED
        dev_s[path] = dev_s.get(path, 0.0) + (t - s) * 1e-6
        for p, low in zip(kernels, pats):
            if low in name.lower():
                by_kernel[p][path] = by_kernel[p].get(path, 0.0) + (t - s) * 1e-6

    inside = 0
    for ts in launches:
        i = bisect.bisect_right(root_starts, ts) - 1
        inside += i >= 0 and roots[i][1] >= ts
    host = {}
    for s in spans:
        n, total = host.get(s[3], (0, 0.0))
        host[s[3]] = (n + 1, total + (s[1] - s[0]) * 1e-6)
    out = dict(span_idle_s=idle, span_device_s=dev_s,
               span_host_s={k: total / n for k, (n, total) in host.items()},
               spans_aligned=bool(roots) and bool(launches)
               and inside >= ALIGNED * len(launches),
               span_launch_share=inside / len(launches) if launches else 0.0)
    if kernels:
        out["span_kernel_s"] = by_kernel
    return out


def attach(trace, events: list, counts: dict):
    """``trace`` (a ``trace.Trace``) with the span fields of ``events`` and
    the recording's counter changes as ``span_counts``."""
    for k, v in attribute(events).items():
        setattr(trace, k, v)
    trace.span_counts = dict(counts)
    return trace


# -- what the per-layer readers share ------------------------------------------------


def _aligned(run):
    t = run.trace
    if t is None or not getattr(t, "spans_aligned", False):
        return None
    return t


def steps(run):
    """``(trace, steps)`` where the recording counted the run's traced steps."""
    t = _aligned(run)
    if t is None or run.traced_units <= 0:
        return None
    if t.span_counts.get("train.steps") != run.traced_units:
        return None
    return t, run.traced_units


def requests(run):
    """``(trace, requests)`` where the recording counted the run's traced
    requests (``traced_units`` fields over ``batch`` fields a request)."""
    t = _aligned(run)
    batch = run.facts.get("batch") if run.facts else None
    if t is None or run.traced_units <= 0 or not batch:
        return None
    n = t.span_counts.get("serve.requests")
    if n is None or n * batch != run.traced_units:
        return None
    return t, n


def _under(split: dict, name: str):
    """Seconds of ``split`` whose path holds ``name``; None where none does."""
    hits = [v for path, v in split.items() if name in path.split("/")]
    return sum(hits) if hits else None


def phase_idle_ms(run, phase: str):
    """Idle device ms a step under ``phase`` (its nested spans included)."""
    got = steps(run)
    if got is None:
        return None
    s = _under(got[0].span_idle_s, phase)
    return None if s is None else 1e3 * s / got[1]


def unspanned_idle(run):
    """Share (%) of the window's idle time under no phase of a step: under
    no span, or in the self time of ``train.epoch`` or ``train.step``."""
    got = steps(run)
    if got is None:
        return None
    split = got[0].span_idle_s
    total = sum(split.values())
    if total <= 0:
        return None
    loose = sum(v for path, v in split.items()
                if path == UNSPANNED or path.split("/")[-1] in TRAIN_CONTAINERS)
    return 100.0 * loose / total


def step_host_ms(run):
    """Mean host ms of a ``train.step`` span."""
    got = steps(run)
    if got is None or "train.step" not in got[0].span_host_s:
        return None
    return 1e3 * got[0].span_host_s["train.step"]


def request_device_ms(run, name: str):
    """Device ms a request launched under spans named ``name``."""
    got = requests(run)
    if got is None:
        return None
    s = _under(got[0].span_device_s, name)
    return None if s is None else 1e3 * s / got[1]
