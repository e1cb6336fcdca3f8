"""Readings that the limits of ``correct`` are set from, at a cell's own size
on the card, or at a tiny size in the tests:

* ``control``: the plain reference put in the program's place and computed
  in 8-bit floats (``reference.lowp``), against the f32 reference;
* ``unchanged``: the program with a step that leaves its state as it was
  (AdamW applies nothing);
* ``half_batch``: the program training on the first half of each batch,
  the loss the mean over it;
* ``altered``: the program's served field altered where it is made (a
  tenth added to the first half of the nodes of every decoded map);
* ``program``: sound runs of the program, whose largest reading over a
  dozen seeds or more is a limit's lower end;
* ``int8``: the program's own int8 serving path (``quantize="int8"``), the
  precision below bfloat16 it offers, against the f32 reference.

    python3 bench_port/tests/readings.py --workload train_t200 --what control --seeds 1 2 3

prints one JSON line a seed with the numbers the cell compares.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(BENCH_DIR), str(BENCH_DIR.parent)]

import torch  # noqa: E402

from benchlib import compare, harness, inputs, program, serving  # noqa: E402
from reference import batch as ref_batch  # noqa: E402
from reference import conditioner as ref_cond  # noqa: E402
from reference import lowp as ref_lowp  # noqa: E402
from reference import vae as ref_vae  # noqa: E402

FAULTS = ("unchanged", "half_batch", "altered")


def control_train(cfg: dict, seed: int, dev) -> dict:
    """The training numbers of the 8-bit reference against the f32 one."""
    drv = harness.driver("train_loop")
    draws = ref_batch.first_steps(seed, cfg["num_param"], cfg["batch_size"],
                                  cfg["augmentation"], drv.CHECK_STEPS)
    data = inputs.ensemble(cfg["num_param"], cfg["num_time"], cfg["num_node"], seed, dev,
                           serving.DTYPES[cfg["dtype"]])
    wanted = sorted({int(i) for d in draws for i in (*d["rows"], *d["partners"])})
    kept = data[torch.as_tensor(wanted, device=dev)].clone()
    del data
    at = {r: j for j, r in enumerate(wanted)}
    f32 = drv.reference_steps(cfg, seed, dev, kept, at, draws)
    low = drv.reference_steps(cfg, seed, dev, kept, at, draws, lowp=ref_lowp.LowPrecision())
    seen = dict(losses=low["losses"],
                mu1={k: (g * (1.0 - compare.B1)).cpu() for k, g in low["grads"].items()},
                params={k: v.cpu() for k, v in low["params"].items()})
    shapes = ref_vae.param_shapes(cfg)
    r = compare.train_readings(seen, f32, inputs.weights(shapes, seed, "vae", dev))
    return {k: r[k] for k in ("loss_gap", "grad_gap", "change_gap", "grad_leaf",
                              "change_leaf")}


def control_serve(cfg: dict, wl: dict, seed: int, dev, count: int = 16) -> dict:
    """``field_gap`` of the 8-bit reference against the f32 one on
    ``count`` requests' first rows of the cell's pool."""
    pool = serving.request_pool(cfg, wl, seed, dev)
    x = pool[:count, 0]
    dec, cond = serving.weights(cfg, seed, dev)
    s = serving.scalers(cfg, seed, dev)
    worst = 0.0
    with compare.exact_f32(), torch.no_grad():
        for at in range(0, x.shape[0], 8):
            want = ref_cond.serve(cfg, dec, cond, s, x[at: at + 8])
            have = ref_cond.serve(cfg, dec, cond, s, x[at: at + 8], ref_lowp.LowPrecision())
            worst = max(worst, compare.field_gap(have, want))
    return {"field_gap": worst}


def int8_serve(cfg: dict, wl: dict, seed: int, dev, count: int = 16) -> dict:
    """``field_gap`` of the program's int8 decode against the f32 reference on
    the same rows as :func:`control_serve`."""
    from simulgen_vae_tpu_torch.convert import vae_tree
    from simulgen_vae_tpu_torch.generate import make_generate_fn
    from simulgen_vae_tpu_torch.models.vae import VAE

    vcfg = program.vae_config(cfg)
    pipe = serving.pipeline(cfg, seed, dev)
    dec, cond = serving.weights(cfg, seed, dev)
    full = VAE(vcfg.latent_dim_end, vcfg.latent_dim, vcfg.num_filter_dec, vcfg.num_node,
               vcfg.num_time, vcfg.small, dev, torch.float32,
               num_filter_enc=vcfg.num_filter_enc)
    with torch.no_grad():
        for k, p in full.named_parameters():
            p.copy_(dec[k]) if k in dec else p.zero_()
    pipe["decoder_tree"] = vae_tree(full, vcfg)["decoder"]
    del full
    fn = make_generate_fn(pipe, descale_output=True, max_batch=int(wl["max_batch"]),
                          quantize="int8")
    x = serving.request_pool(cfg, wl, seed, dev)[:count, 0]
    have = torch.cat([fn(x[at: at + 8]) for at in range(0, x.shape[0], 8)])
    del pipe, fn
    s = serving.scalers(cfg, seed, dev)
    worst = 0.0
    with compare.exact_f32(), torch.no_grad():
        for at in range(0, x.shape[0], 8):
            want = ref_cond.serve(cfg, dec, cond, s, x[at: at + 8])
            worst = max(worst, compare.field_gap(have[at: at + 8], want))
    return {"field_gap": worst}


@contextlib.contextmanager
def fault(kind: str):
    """The program broken underneath the timed path, for the block."""
    from simulgen_vae_tpu_torch.models.vae import VAE
    from simulgen_vae_tpu_torch.train.optim import FusedAdamW
    from simulgen_vae_tpu_torch.train.vae_trainer import VAETrainer

    if kind == "unchanged":
        target, name = FusedAdamW, "apply"

        def broken(self, grads, state, params, lr):
            return torch.linalg.vector_norm(torch.stack([g.float().norm() for g in grads.values()]))
    elif kind == "half_batch":
        target, name = VAETrainer, "assemble_batch"
        whole = VAETrainer.assemble_batch

        def broken(self, data, idx):
            batch = whole(self, data, idx)
            return batch[: batch.shape[0] // 2].contiguous()
    elif kind == "altered":
        target, name = VAE, "generate"
        right = VAE.generate

        def broken(self, *args, **kwargs):
            out = right(self, *args, **kwargs).clone()
            out[..., : out.shape[-1] // 2] += 0.1
            return out
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
    p.add_argument("--what", choices=("control", "int8", "program") + FAULTS,
                   required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    wl, cfg = harness.cell_files(args.workload)
    dev = torch.device("cuda", 0)
    for seed in args.seeds:
        if args.what == "control":
            if wl["driver"] == "train_loop":
                out = control_train(cfg, seed, dev)
            else:
                out = control_serve(cfg, wl, seed, dev)
        elif args.what == "int8":
            out = int8_serve(cfg, wl, seed, dev)
        else:
            ctx = harness.Ctx(args.workload, wl, cfg, seed, args.seconds, False, dev)
            if args.what == "program":
                o = harness.driver(wl["driver"]).run(ctx)
            else:
                o = faulty_run(ctx, args.what)
            out = {k: v for k, (v, _) in o.checks.items()}
            out.update(correct=o.correct, failed=o.failed, e2e=o.e2e)
        print(json.dumps(dict(workload=args.workload, what=args.what, seed=seed, **out)),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
