"""Readings that the limits of the E2E cell's ``correct`` are set from, at
the cell's own size on the card, or at a tiny size in the tests:

* ``program``: sound runs of the program, whose largest reading over the
  seeds is a limit's lower end;
* ``control``: the plain reference computed in 8-bit floats
  (``reference.lowp``) against the f32 one, on the draws of the program's
  first steps;
* ``detached``: the program with its latents' descale detached from the
  graph, as the original trainer has it (its reconstruction term trains
  nothing);
* ``half_batch``: the program's reconstruction term over the first half of
  each batch's designs.

    python3 bench_port/tests/e2e_readings.py --workload train_e2e_t50 --what control --seeds 1 2 3

prints one JSON line a seed with the numbers the cell compares.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(BENCH_DIR), str(BENCH_DIR.parent)]

import torch  # noqa: E402

from benchlib import compare, harness  # noqa: E402
from reference import lowp as ref_lowp  # noqa: E402

FAULTS = ("detached", "half_batch")
KEYS = ("loss_gap", "grad_gap", "change_gap", "grad_leaf", "change_leaf")


def _free(dev) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def control(cfg: dict, seed: int, dev) -> dict:
    """The training numbers of the 8-bit reference against the f32 one, both
    on what the program drew in its first steps."""
    drv = harness.driver("e2e_loop")
    trainer, state, train, held_out = drv.build(cfg, seed, dev)
    del held_out
    first = drv.FirstSteps(trainer, drv.CHECK_STEPS)
    trainer.train_epoch(state, *train)
    first.close()
    drawn = first.drawn()
    del trainer, state, train, first
    _free(dev)
    f32 = drv.reference_steps(cfg, seed, dev, drawn)
    low = drv.reference_steps(cfg, seed, dev, drawn, lowp=ref_lowp.LowPrecision())
    seen = dict(losses=low["losses"],
                mu1={k: (g * (1.0 - compare.B1)).cpu() for k, g in low["grads"].items()},
                params={k: v.cpu() for k, v in low["params"].items()})
    params0, _ = drv.conditioner_inputs(cfg, seed, dev)
    r = compare.train_readings(seen, f32, params0)
    return {k: r[k] for k in KEYS}


@contextlib.contextmanager
def fault(kind: str):
    """The program broken underneath the timed path, for the block."""
    from simulgen_vae_tpu_torch.train import lc_e2e_trainer

    if kind == "detached":
        target, name = lc_e2e_trainer.E2ETrainer, "_descale"
        right = target._descale

        def broken(self, y_pred1, y_pred2):
            return tuple(t.detach() for t in right(self, y_pred1, y_pred2))
    elif kind == "half_batch":
        target, name = lc_e2e_trainer, "get_recon_loss"
        right = target.get_recon_loss

        def broken(loss_name):
            whole = right(loss_name)
            return lambda pred, want: whole(pred[: pred.shape[0] // 2],
                                            want[: want.shape[0] // 2])
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
    for seed in args.seeds:
        if args.what == "control":
            out = control(cfg, seed, dev)
        else:
            ctx = harness.Ctx(args.workload, wl, cfg, seed, args.seconds, False, dev)
            o = (harness.driver(wl["driver"]).run(ctx) if args.what == "program"
                 else faulty_run(ctx, args.what))
            out = {k: v for k, (v, _) in o.checks.items()}
            out.update(correct=o.correct, failed=o.failed, e2e=o.e2e,
                       memory_peak_bytes=o.memory_peak_bytes)
        print(json.dumps(dict(workload=args.workload, what=args.what, seed=seed, **out)),
              flush=True)
        _free(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
