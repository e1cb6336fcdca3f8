"""A profiler window over part of a run, reduced to what the per-layer
metrics read: the window's length, the device's busy time, device time by
kernel name, the host's kernel- and graph-launch calls, and the idle gaps
labelled by the CUDA call the host was in ("python" between calls).

The session records the card's activity and the CUDA runtime's calls, not
the host's operators: recording every operator made a traced train step
35% longer than an untraced one, the card's activity alone 9% (PERF.md). It
opens with spin kernels and a synchronize (a session on the card now and
then loses its first kernels' records); the window runs from the first call
after that to the synchronize that ends it. The trace is written to
``TMPDIR``, read back and deleted.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CALLS = frozenset((
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchKernelEx", "cuLaunchKernel",
    "cuLaunchKernelEx", "cudaLaunchCooperativeKernel", "cudaGraphLaunch", "cuGraphLaunch"))
HOST_CATS = ("cuda_runtime", "cuda_driver")
WARM_KERNELS = 16
NAME_CHARS = 120


@dataclass
class Trace:
    window_s: float
    busy_s: float
    kernel_s: dict = field(default_factory=dict)   # device seconds by kernel name
    launches: int = 0
    gaps: dict = field(default_factory=dict)       # idle seconds by host operation

    def kernel_seconds(self, patterns) -> float:
        """Device seconds of the kernels whose name holds one of ``patterns``
        (case-insensitive)."""
        pats = [p.lower() for p in patterns]
        return sum(s for name, s in self.kernel_s.items()
                   if any(p in name.lower() for p in pats))

    def breakdown(self) -> dict:
        def top(d):
            return [[k[:NAME_CHARS], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
        return {"device_ops": top(self.kernel_s), "idle_gaps": top(self.gaps)}


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _outermost(hosts):
    """The host calls that no other one encloses, sorted by start."""
    out, end = [], float("-inf")
    for ts, dur, name in sorted(hosts, key=lambda h: (h[0], -h[1])):
        if ts >= end:
            out.append((ts, dur, name))
            end = ts + dur
    return out


def _label(starts, tops, mid: float) -> str:
    """The outermost host call running at ``mid``, else "python"."""
    i = bisect.bisect_right(starts, mid) - 1
    if i >= 0 and tops[i][0] + tops[i][1] >= mid:
        return tops[i][2]
    return "python"


def window_bounds(events: list) -> tuple:
    """The window's ``(start, end)`` in the trace's microseconds: from the
    first host call after the warm-up's synchronize to the end of the last
    synchronize, the one that closes the window."""
    syncs = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
                   for e in events
                   if e.get("cat") == "cuda_runtime" and e.get("name") == "cudaDeviceSynchronize")
    if len(syncs) < 2:
        raise RuntimeError("the trace holds no synchronize around the window")
    warm = syncs[0][1]
    start = min(float(e["ts"]) for e in events
                if e.get("cat") in HOST_CATS and float(e.get("ts", 0.0)) > warm)
    return start, syncs[-1][1]


def summarize(events: list) -> Trace:
    t0, t1 = window_bounds(events)
    spans, kernel_s, launches, hosts = [], {}, 0, []
    for e in events:
        cat, ts = e.get("cat"), e.get("ts")
        if ts is None:
            continue
        ts, dur = float(ts), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            s, t = max(ts, t0), min(ts + dur, t1)
            if t > s:
                spans.append((s, t))
                kernel_s[e["name"]] = kernel_s.get(e["name"], 0.0) + (t - s) * 1e-6
        elif cat in HOST_CATS and t0 <= ts <= t1:
            if e.get("name") in LAUNCH_CALLS:
                launches += 1
            hosts.append((ts, dur, e.get("name", "?")))
    merged = _merge(spans)
    busy = sum(e - s for s, e in merged)
    tops = _outermost(hosts)
    starts = [h[0] for h in tops]
    gaps, last = {}, t0
    for s, e in merged + [[t1, t1]]:
        if s > last:
            label = _label(starts, tops, (s + last) / 2)
            gaps[label] = gaps.get(label, 0.0) + (s - last) * 1e-6
        last = max(last, e)
    return Trace(window_s=(t1 - t0) * 1e-6, busy_s=busy * 1e-6, kernel_s=kernel_s,
                 launches=launches, gaps=gaps)


def profiled(fn):
    """``(Trace, fn())`` with ``fn`` run inside the profiler's window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return summarize(events), out
