"""Profiler traces and device memory telemetry (``simulgen_vae_tpu/utils/profiling.py``).

:func:`trace` records a ``torch.profiler`` session (CPU and, where there is
a card, CUDA activities) and writes it as a Chrome trace file;
:func:`device_memory_mb` reads the caching allocator's counters under the
JAX function's three keys (zeros on the CPU, as JAX's CPU device reports no
memory statistics).
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Iterator, Optional

import torch

from simulgen_vae_tpu_torch.generate import resolve_device


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator[torch.profiler.profile]:
    """Profile the block; on exit write ``log_dir/trace-<pid>-<ns>.json`` (a
    Chrome trace, for Perfetto or chrome://tracing). ``log_dir`` defaults to
    ``torch-trace`` under the temporary directory. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "torch-trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))


def device_memory_mb(device=None) -> dict:
    """Memory of ``device`` (the card by default) in MiB: in use, peak and
    the card's total, from the caching allocator."""
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

