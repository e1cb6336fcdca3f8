"""Profiler traces, the program's spans and counters, and device memory
telemetry (``simulgen_vae_tpu/utils/profiling.py``).

:func:`trace` records a ``torch.profiler`` session (CPU and, where there is
a card, CUDA activities) and writes it as a Chrome trace file, with the
program's spans in it; :func:`device_memory_mb` reads the caching
allocator's counters under the JAX function's three keys (zeros on the CPU,
as JAX's CPU device reports no memory statistics).

Spans. ``with span(name):`` marks a phase of the program. Outside
:func:`recording` (the default) it tests one module-level flag and hands
back a shared no-op. Inside it appends ``(name, start_ns, end_ns, parent,
key, thread)`` to the recording: the times on the Unix clock in
nanoseconds, which is the clock of the profiler's Chrome trace (``ts`` in
microseconds plus the file's ``baseTimeNanoseconds``), so the spans line up
with the trace's runtime calls and kernels; ``parent`` the index of the
enclosing span of the same thread (-1 for none); ``key`` the step or request
the span belongs to, handed down to the spans nested in it; ``thread`` the
thread's ident. The spans of the port:

- ``train.epoch``: ``VAETrainer.train_epoch`` and ``train_epoch_streaming``;
- ``train.step``: one step, keyed by ``train.steps``; in it
  ``train.assemble`` (host draws, pinned copies, ``gather_augment``),
  ``train.sn`` (the power iteration; sigma's rank-1 gradient terms),
  ``train.forward`` (``loss_fn``), ``train.backward`` (``loss.backward()``
  and the gradients read out), ``train.optimizer`` (``FusedAdamW.apply``:
  pointer tables, gradient norm, sweeps); the streamed epoch's host gather
  and copy is ``train.fetch``; the per-epoch power iteration a
  ``train.sn`` under ``train.epoch``. On the graph path
  (``VAETrainer.graph_engages``) a step holds ``train.capture`` (the one
  capture of the step, its phases inside) or ``train.replay`` (one graph
  launch) instead: the phases are spans of eager steps only;
- ``serve.request``: one call of ``make_generate_fn``'s function, keyed by
  ``serve.requests``; in it ``serve.chunk`` (one decode call of at most
  ``max_batch`` rows) holding ``serve.conditioner`` (the conditioner and
  the latent descales), ``serve.decode`` (``VAE.generate``) and
  ``serve.descale``; ``serve.concat``, the tail chunk's padding and the
  chunks' concatenation;
- ``lc.epoch``: ``LCTrainer.train_epoch`` (the CSV, image and E2E
  conditioners); ``lc.step``: one step, keyed by ``lc.steps``; in it
  ``lc.augment`` (the batch's rows and its augmentation or noise),
  ``lc.conditioner`` (the model call in ``loss_fn``: the power iteration
  and the conditioner's forward), ``lc.decode`` (``E2ETrainer``: the
  latents' descale and the frozen decoder, its ``decoder.readout``
  inside), ``lc.loss`` (the loss terms), ``lc.backward``
  (``loss.backward()`` and the gradients read out), ``lc.optimizer`` (the
  clip and AdamW); ``lc.eval``: one held-out batch of
  ``LCTrainer.eval_epoch``, keyed by ``lc.eval_batches``, holding its
  ``lc.conditioner``, ``lc.decode`` and ``lc.loss``;
- ``decoder.readout``: ``Decoder.recon``, in training and serving;
- ``collective.all_reduce``, ``collective.all_gather``,
  ``collective.broadcast``: ``parallel.collectives``' calls.

Autograd launches the backward's kernels from a thread of its own while the
main thread waits inside ``train.backward``, so that span covers them in
time.

Counters. :func:`register` adds a dict of counts to the module's merged
view (:func:`counters`): the ops modules' ``LAUNCHES`` (hand-written kernel
launches from Python, counted always: a replayed graph's launches are
counted once, at its capture), ``train.vae_trainer``'s
``train.graph_captures`` and ``train.graph_replays`` (counted always), and
the module's own ``train.steps``, ``serve.requests``, ``lc.steps`` and
``lc.eval_batches``, which :func:`tick` advances only while recording. A
recording hands back each counter's change over its block.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
import threading
import time
from typing import Iterator, List, Optional

import torch

_on = False          # the one flag a span tests
_spans: list = []    # [name, start_ns, end_ns, parent, key, thread] of the recording
_offset_ns = 0       # Unix clock minus perf_counter, taken when a recording starts
_local = threading.local()
_OWN = {"train.steps": 0, "serve.requests": 0, "lc.steps": 0, "lc.eval_batches": 0}
_REGISTERED: List[dict] = [_OWN]


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "key", "entry")

    def __init__(self, name: str, key):
        self.name, self.key, self.entry = name, key, None

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        parent = stack[-1] if stack else None
        key = self.key
        if key is None and parent is not None:
            key = parent[4]
        self.entry = [self.name, time.perf_counter_ns() + _offset_ns, 0,
                      -1 if parent is None else parent[6], key, threading.get_ident(),
                      len(_spans)]
        _spans.append(self.entry)
        stack.append(self.entry)
        return None

    def __exit__(self, *exc):
        self.entry[2] = time.perf_counter_ns() + _offset_ns
        stack = _local.stack
        if stack and stack[-1] is self.entry:
            stack.pop()
        return False


def span(name: str, key=None):
    """A context manager around one phase of the program, recorded only
    inside :func:`recording`; ``key`` the step or request (None: the
    enclosing span's)."""
    if not _on:
        return _NO_SPAN
    return _Span(name, key)


def register(counts: dict) -> dict:
    """Adds ``counts`` (name -> count, kept by its module) to the merged
    view; returns it."""
    _REGISTERED.append(counts)
    return counts


def counters() -> dict:
    """Every registered count, merged into one dict."""
    merged = {}
    for counts in _REGISTERED:
        merged.update(counts)
    return merged


def tick(name: str) -> Optional[int]:
    """Advances the module's counter ``name`` while recording and returns
    its value before (the key of the step or request); None otherwise."""
    if not _on:
        return None
    n = _OWN[name]
    _OWN[name] = n + 1
    return n


class Recording:
    """What :func:`recording` hands back once its block has ended: the spans,
    as ``(name, start_ns, end_ns, parent, key, thread)`` in the order they
    opened, and each counter's change over the block."""

    def __init__(self):
        self.spans: list = []
        self.counters: dict = {}

    def seconds(self, prefix: str, within: Optional[str] = None) -> float:
        """Seconds in the spans whose name starts with ``prefix``; where
        ``within`` is given, only those that lie inside a span of that name
        in time, on any thread (autograd's thread runs the backward's)."""
        outer = sorted((s[1], s[2]) for s in self.spans if s[0] == within)
        starts = [o[0] for o in outer]
        total = 0
        for name, start, end, *_ in self.spans:
            if not name.startswith(prefix):
                continue
            i = bisect.bisect_right(starts, start) - 1
            if within is None or (i >= 0 and end <= outer[i][1]):
                total += end - start
        return total * 1e-9


@contextlib.contextmanager
def recording() -> Iterator[Recording]:
    """Record the program's spans and counters over the block. Yields a
    :class:`Recording`, filled when the block ends."""
    global _on, _spans, _offset_ns
    if _on:
        raise RuntimeError("already recording")
    rec = Recording()
    before = counters()
    _spans = []
    _offset_ns = time.time_ns() - time.perf_counter_ns()
    _on = True
    try:
        yield rec
    finally:
        _on = False
        end = time.perf_counter_ns() + _offset_ns
        rec.spans = [(s[0], s[1], s[2] or end, s[3], s[4], s[5]) for s in _spans]
        after = counters()
        rec.counters = {k: v - before.get(k, 0) for k, v in after.items()}
        _spans = []


def chrome_events(spans, base_ns: int, pid: Optional[int] = None) -> list:
    """``spans`` as Chrome trace complete events (``"ph": "X"``, ``cat``
    ``program``) on the clock of a trace whose ``baseTimeNanoseconds`` is
    ``base_ns``; ``args`` hold the key and the parent's index."""
    pid = os.getpid() if pid is None else pid
    return [{"ph": "X", "cat": "program", "name": name, "pid": pid, "tid": thread,
             "ts": (start - base_ns) / 1e3, "dur": (end - start) / 1e3,
             "args": {"key": key, "parent": parent}}
            for name, start, end, parent, key, thread in spans]


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator[torch.profiler.profile]:
    """Profile the block; on exit write ``log_dir/trace-<pid>-<ns>.json`` (a
    Chrome trace, for Perfetto or chrome://tracing) with the program's spans
    recorded over the block as ``program`` events above the device rows.
    ``log_dir`` defaults to ``torch-trace`` under the temporary directory.
    Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "torch-trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    rec = None
    try:
        # an enclosing recording keeps the spans to itself
        with recording() if not _on else contextlib.nullcontext() as rec:
            prof.start()
            try:
                yield prof
            finally:
                prof.stop()
    finally:
        path = os.path.join(log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json")
        prof.export_chrome_trace(path)
        if rec is not None and rec.spans:
            with open(path, encoding="utf-8") as f:
                doc = json.load(f)
            doc["traceEvents"] += chrome_events(rec.spans, int(doc["baseTimeNanoseconds"]))
            with open(path, "w", encoding="utf-8") as f:
                json.dump(doc, f)


def device_memory_mb(device=None) -> dict:
    """Memory of ``device`` (the card by default) in MiB: in use, peak and
    the card's total, from the caching allocator."""
    from simulgen_vae_tpu_torch.generate import resolve_device

    device = resolve_device(device)
    if device.type != "cuda":
        in_use = peak = limit = 0
    else:
        stats = torch.cuda.memory_stats(device)
        in_use = stats.get("allocated_bytes.all.current", 0)
        peak = stats.get("allocated_bytes.all.peak", 0)
        limit = torch.cuda.mem_get_info(device)[1]
    scale = 1024 ** 2
    return {"bytes_in_use_mb": in_use / scale, "peak_bytes_in_use_mb": peak / scale,
            "bytes_limit_mb": limit / scale}
