"""Run one cell of the port's benchmark on the card this process runs on.

    python3 bench_port/run.py --workload train_t200 --seed 7 --seconds 30 --trace 0

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with the reference
beside its limit, which also end standard error. A run that finds no card,
fewer cards than the cell asks for, or JAX loaded after its window exits
with a code other than 0 and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
sys.path[:0] = [str(BENCH_DIR), str(ROOT)]
# Build and kernel caches stay inside the checkout, at fixed paths.
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / ".cache" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / ".cache" / "triton"))

from benchlib import harness  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    man = harness.manifest()
    cells = {w["name"]: w for w in man["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    chips = int(cells[args.workload]["chips"])
    workload, config = harness.cell_files(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    ctx = harness.Ctx(cell=args.workload, workload=workload, config=config, seed=args.seed,
                      seconds=args.seconds, trace=bool(args.trace),
                      device=torch.device("cuda", 0))
    outcome = harness.driver(workload["driver"]).run(ctx)
    found = harness.forbidden_modules()
    if found:
        print(f"loaded after the window: {', '.join(found)}", file=sys.stderr)
        return 4
    e2e, layer = harness.cell_metrics(man, args.workload)
    metrics = harness.report_metrics(outcome, e2e, layer, ctx.trace)
    device = harness.device_info(outcome, chips)
    print(f"memory_peak_bytes {device['memory_peak_bytes']} on {device['kind']}")
    print(f"measured {json.dumps(outcome.e2e)} window {json.dumps(outcome.window)}")
    for name, (value, limit) in outcome.checks.items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(harness.result_line(outcome, metrics, device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
