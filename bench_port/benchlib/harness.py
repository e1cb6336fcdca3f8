"""The run of one cell: find its files by name, run its driver, read its
metrics, decide ``correct`` and print the result line.

A cell is ``workloads/<cell>.json`` (its configuration, traffic mix and
limits), its traffic mix ``traffic/<traffic>.json`` (the parameters its
driver reads, and the driver's name), its configuration
``configs/<config>.json``, its driver ``drivers/<driver>.py`` (``run(ctx)
-> Outcome``) and, for each
per-layer metric ``BENCHMARK.json`` gives the cell, a reader
``metrics/<metric>.py`` (``read(outcome) -> float | None``). Adding a
cell, a configuration or a metric adds files and entries only.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
FORBIDDEN = frozenset(("jax", "jaxlib", "flax", "simulgen_vae_tpu"))


def process_seconds() -> float:
    """Seconds since this process started (the kernel's start time)."""
    with open("/proc/self/stat", encoding="ascii") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start


@dataclass
class Ctx:
    """What a driver gets: the cell's files, the run's arguments, its device."""
    cell: str
    workload: dict
    config: dict
    seed: int
    seconds: float
    trace: bool
    device: object


@dataclass
class Outcome:
    """What a driver returns."""
    e2e: dict                       # end-to-end metric -> value (setup_s too)
    attempted: int
    failed: int
    checks: dict                    # number compared -> (value, limit)
    memory_peak_bytes: int
    config: dict
    workload: dict
    window: dict = field(default_factory=dict)   # seconds, units, flops_per_unit
    trace: Optional[object] = None               # benchlib.trace.Trace
    traced_units: int = 0
    facts: dict = field(default_factory=dict)    # counts the readers use

    @property
    def correct(self) -> bool:
        return self.failed == 0 and all(v <= lim for v, lim in self.checks.values())


def load_json(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell_files(cell: str) -> tuple:
    """``(workload, config)`` of ``cell``: its file merged over its traffic
    mix's parameters, and its configuration."""
    own = load_json(BENCH_DIR / "workloads" / f"{cell}.json")
    workload = {**load_json(BENCH_DIR / "traffic" / f"{own['traffic']}.json"), **own}
    config = load_json(BENCH_DIR / "configs" / f"{workload['config']}.json")
    return workload, config


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no module at {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def driver(kind: str):
    return load_module(BENCH_DIR / "drivers" / f"{kind}.py", f"bench_driver_{kind}")


def reader(metric: str):
    safe = metric.replace(".", "_").replace("-", "_")
    return load_module(BENCH_DIR / "metrics" / f"{metric}.py", f"bench_metric_{safe}")


def cell_metrics(man: dict, cell: str) -> tuple:
    """``(end-to-end, per-layer)`` entries of ``BENCHMARK.json`` that the
    cell reports."""
    e2e = [m for m in man["end_to_end"] if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    layer = [m for m in man["per_layer"]
             if cell in m.get("workloads", [cell] if m["moves"] in names else [])]
    return e2e, layer


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & FORBIDDEN)


def device_info(outcome: Outcome, chips: int) -> dict:
    import torch

    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": int(outcome.memory_peak_bytes)}
    if outcome.trace is not None:
        info["busy_s"] = outcome.trace.busy_s
        info["window_s"] = outcome.trace.window_s
    return info


def result_line(outcome: Outcome, metrics: dict, device: dict) -> dict:
    line = {"correct": outcome.correct, "attempted": outcome.attempted,
            "failed": outcome.failed, "metrics": metrics, "device": device}
    if outcome.trace is not None:
        line["breakdown"] = outcome.trace.breakdown()
    line["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in outcome.checks.items()}
    return line


def report_metrics(outcome: Outcome, e2e: list, layer: list, trace: bool) -> dict:
    """The result's metrics: the cell's end-to-end ones, or with ``trace``
    the per-layer ones whose reader found something to read."""
    out = {}
    if not trace:
        for m in e2e:
            if m["name"] not in outcome.e2e:
                raise RuntimeError(f"the driver measured no {m['name']}")
            out[m["name"]] = {"value": outcome.e2e[m["name"]], "unit": m["unit"]}
        return out
    for m in layer:
        value = reader(m["name"]).read(outcome)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
