"""Readings that the limits of the ViT E2E cell's ``correct`` are set from, at
the cell's own size on the card, or at a tiny size in the tests:

* ``program``: sound runs of the program through the driver, whose largest
  reading over the seeds is a limit's lower end;
* ``control``: the plain reference computed in 8-bit floats
  (``reference.lowp``) against the f32 one, on the draws of the program's
  first steps; the program's own numbers against the f32 reference on the
  same draws come with it;
* ``bf16_vit``: the program with its ViT's forward under bf16 autocast
  (bf16 products, the configuration states f32), through the driver;
* ``tf32_vit``: the program with its f32 products in TF32, through the
  driver.

    python3 bench_port/tests/e2e_vit_readings.py --workload train_e2e_vit_b16_t50 --what control --seeds 1 2 3

prints one JSON line a seed with the numbers the cell compares.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(BENCH_DIR), str(BENCH_DIR.parent)]

import torch  # noqa: E402

from benchlib import compare, harness  # noqa: E402
from reference import lowp as ref_lowp  # noqa: E402

KEYS = ("loss_gap", "grad_gap", "change_gap", "latent_gap", "grad_leaf", "change_leaf")
FAULTS = ("bf16_vit", "tf32_vit")


def _free(dev) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def control(cfg: dict, seed: int, dev) -> dict:
    """``{"program": ..., "control": ...}``: the program's first steps and the
    8-bit reference's, each against the f32 reference on what the program
    drew."""
    drv = harness.driver("e2e_vit_loop")
    trainer, state, train, held_out = drv.build(cfg, seed, dev)
    del held_out
    first = drv.FirstSteps(trainer, drv.CHECK_STEPS)
    trainer.train_epoch(state, *train)
    first.close()
    seen, drawn = first.seen(), first.drawn()
    del trainer, state, train, first
    _free(dev)
    f32 = drv.reference_steps(cfg, seed, dev, drawn)
    low = drv.reference_steps(cfg, seed, dev, drawn, lowp=ref_lowp.LowPrecision())
    low_seen = dict(losses=low["losses"],
                    mu1={k: (g * (1.0 - compare.B1)).cpu() for k, g in low["grads"].items()},
                    params={k: v.cpu() for k, v in low["params"].items()},
                    latents=tuple(t.cpu() for t in low["latents"]))
    out = {}
    for name, have in (("program", seen), ("control", low_seen)):
        r = drv.readings(cfg, seed, dev, have, f32)
        out[name] = {k: r[k] for k in KEYS}
    return out


@contextlib.contextmanager
def fault(kind: str):
    """The program changed underneath the timed path, for the block: the
    ViT's forward under bf16 autocast (``bf16_vit``), or its f32 products in
    TF32 (``tf32_vit``; the reference turns TF32 off for its own)."""
    from simulgen_vae_tpu_torch.models.conditioner_vit import LatentConditionerViT

    if kind == "tf32_vit":
        target, name, broken = torch.backends.cuda.matmul, "allow_tf32", True
    elif kind == "bf16_vit":
        target, name = LatentConditionerViT, "forward"
        right = LatentConditionerViT.forward

        def broken(self, x, generator=None, train=None):
            with torch.autocast(x.device.type, dtype=torch.bfloat16):
                out = right(self, x, generator, train)
            return tuple(t.float() for t in out)
    else:
        raise ValueError(f"unknown fault {kind!r}")
    saved = getattr(target, name)
    setattr(target, name, broken)
    try:
        yield
    finally:
        setattr(target, name, saved)


def faulty_run(ctx: harness.Ctx, kind: str) -> harness.Outcome:
    with fault(kind):
        return harness.driver(ctx.workload["driver"]).run(ctx)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--what", choices=("control", "program") + FAULTS, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    wl, cfg = harness.cell_files(args.workload)
    dev = torch.device("cuda", 0)
    torch.zeros(1, device=dev)  # the allocator's statistics exist from its first allocation
    for seed in args.seeds:
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats(dev)
        if args.what == "control":
            out = control(cfg, seed, dev)
        else:
            ctx = harness.Ctx(args.workload, wl, cfg, seed, args.seconds, False, dev)
            o = (harness.driver(wl["driver"]).run(ctx) if args.what == "program"
                 else faulty_run(ctx, args.what))
            out = {k: v for k, (v, _) in o.checks.items()}
            out.update(correct=o.correct, failed=o.failed, e2e=o.e2e,
                       memory_peak_bytes=o.memory_peak_bytes)
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(dict(workload=args.workload, what=args.what, seed=seed, **out)),
              flush=True)
        _free(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
