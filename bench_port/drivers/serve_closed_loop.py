"""Closed-loop serving, one client: each request is ``rows_per_request``
designs through the program's ``make_generate_fn`` (``max_batch`` rows a
chunk), issued as soon as the previous one is done. The window runs
requests until ``--seconds`` have passed and closes with a synchronize:
``serve_fields_per_s`` is every field of every request over the whole
window.

With ``wait_for_each`` the client waits for each field before it asks for
the next, as one engineer does, and every request of the window is timed
from its call to its field being ready on the card, between two CUDA events
(the card's clock: a call lasts milliseconds, below what the host clock
resolves); ``serve_latency_p95_ms`` is the 95th percentile of all of them.
Without it the call returns as soon as its work is queued and the fields
stay on the card, as a sweep keeps them. With ``--trace 1`` a profiled run
of ``trace_requests`` requests, issued the same way, follows the window.

Correctness: a sample of the fields (``benchlib.serving.Cell``) against the
plain reference once the window has closed.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchlib import harness, program, serving, trace, work


def _timed_ms(call, dev) -> float:
    """Milliseconds from ``call`` to its work being done on the card, between
    two CUDA events (on the CPU, where the tests run, the host clock)."""
    if dev.type != "cuda":
        t = time.perf_counter()
        call()
        return (time.perf_counter() - t) * 1e3
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    call()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def run(ctx: harness.Ctx) -> harness.Outcome:
    cell = serving.Cell(ctx)
    dev, cfg, wl = ctx.device, ctx.config, ctx.workload
    wait = bool(wl.get("wait_for_each", False))
    setup_s = harness.process_seconds()
    done, latencies, t0 = 0, [], time.perf_counter()
    while time.perf_counter() - t0 < ctx.seconds:
        if wait:
            latencies.append(_timed_ms(lambda: cell.request(done), dev))
        else:
            cell.request(done)
        done += 1
    program.sync(dev)
    window_s = time.perf_counter() - t0
    traced, units = None, 0
    if ctx.trace:
        units = int(wl["trace_requests"])

        def requests():
            for k in range(units):
                cell.request(done + k)
                if wait:
                    program.sync(dev)

        traced, _ = trace.profiled(requests)
    peak = program.peak_bytes(dev)
    rows = cell.rows
    c = cfg["conditioner"]
    per_field = work.field_flops(cfg) + (work.mlp_flops(
        c["filters"], c["inputs"], cfg["latent_dim_end"],
        (cfg["latent_dim_end"], cfg["latent_dim"] * (len(cfg["num_filter_enc"]) - 1)))
        if c["type"] == "mlp" else 0.0)
    e2e = {"serve_fields_per_s": done * rows / window_s, "setup_s": setup_s}
    if wait:
        e2e["serve_latency_p95_ms"] = float(np.percentile(latencies, 95))
    return harness.Outcome(
        e2e=e2e, attempted=done, failed=cell.failed, checks=cell.checks(),
        memory_peak_bytes=peak, config=cfg, workload=wl,
        window=dict(seconds=window_s, units=done * rows, flops_per_unit=per_field),
        trace=traced, traced_units=units * rows, facts=dict(batch=rows))
