"""Closed-loop VAE training: epochs back to back through
``VAETrainer.train_epoch`` over an ensemble resident on the card.

Set-up makes the ensemble, the weights and the power-iteration vectors from
the seed, builds the trainer and its state, loads them, and trains the
first epoch; its first three steps are recorded (each step's loss, the
first moments after step 1, the parameters after step 3). The window then
runs whole epochs until ``--seconds`` have passed, closed by a synchronize:
``train_samples_per_s`` is every sample of every step over the whole window.
With ``--trace 1`` a profiled partial epoch of ``trace_steps`` steps follows
the window.

Correctness: once the window has closed and the program's state is freed,
the plain reference (``reference/``) runs the same three steps from the same
weights, vectors, rows, host draws and noise, in f32, and three numbers are
compared with it (``compare``): the worst step's loss, the worst leaf's
first gradient (the optimizer's first moment over 1 - b1) and the worst
leaf's change after three steps.
"""

from __future__ import annotations

import gc
import math
import time

import torch

from benchlib import compare, harness, inputs, program, trace, work
from reference import batch as ref_batch
from reference import train as ref_train
from reference import vae as ref_vae

CHECK_STEPS = 3
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class FirstSteps:
    """Records the first steps of ``trainer``: each step's loss, the first
    moments after step 1 and the parameters after the last, on the host."""

    def __init__(self, trainer, steps: int):
        self.losses, self.mu1, self.params = [], None, None
        self.trainer, self.steps = trainer, steps
        apply = trainer._apply

        def recording(state, *args, **kwargs):
            metrics = apply(state, *args, **kwargs)
            if len(self.losses) < steps:
                self.losses.append(metrics["loss"].detach().float().clone())
                if len(self.losses) == 1:
                    self.mu1 = {k: v.detach().to("cpu", torch.float32, copy=True)
                                for k, v in state.opt_state["mu"].items()}
                if len(self.losses) == steps:
                    self.params = {k: p.detach().to("cpu", torch.float32, copy=True)
                                   for k, p in state.model.named_parameters()}
            return metrics

        trainer._apply = recording

    def close(self) -> None:
        del self.trainer._apply


def run(ctx: harness.Ctx) -> harness.Outcome:
    from simulgen_vae_tpu_torch.data.augmentation import AugmentationConfig
    from simulgen_vae_tpu_torch.train.vae_trainer import VAETrainer

    cfg, wl, dev, seed = ctx.config, ctx.workload, ctx.device, ctx.seed
    batch_size = cfg["batch_size"]
    program.build_kernels(dev)
    shapes = ref_vae.param_shapes(cfg)
    sn = ref_vae.sn_names(shapes)
    data = inputs.ensemble(cfg["num_param"], cfg["num_time"], cfg["num_node"], seed, dev,
                           _DTYPES[cfg["dtype"]])
    aug = dict(cfg["augmentation"], scaling_range=tuple(cfg["augmentation"]["scaling_range"]))
    trainer = VAETrainer(program.vae_config(cfg), aug=AugmentationConfig(**aug), device=dev, seed=seed,
                         fused_readout=cfg["fused_readout"])
    state = trainer.init_state(seed)
    program.load_state(state.model, inputs.weights(shapes, seed, "vae", dev), params_only=True)
    us = inputs.unit_vectors(shapes, sn, seed, dev)
    if set(state.sn_u) != set(us):
        raise RuntimeError("the program normalises other kernels than the reference")
    state.sn_u = {k: us[k].clone() for k in state.sn_u}
    del us
    first = FirstSteps(trainer, CHECK_STEPS)
    epochs = [trainer.train_epoch(state, data)]
    first.close()
    steps_per_epoch = -(-cfg["num_param"] // batch_size)
    program.sync(dev)
    setup_s = harness.process_seconds()

    steps, t0 = 0, time.perf_counter()
    while time.perf_counter() - t0 < ctx.seconds:
        epochs.append(trainer.train_epoch(state, data))
        steps += steps_per_epoch
    program.sync(dev)
    window_s = time.perf_counter() - t0
    losses = [float(m["loss"]) for _, m in epochs]
    failed = steps_per_epoch * sum(not math.isfinite(v) for v in losses[1:])

    traced, traced_units = None, 0
    if ctx.trace:
        k = int(wl["trace_steps"])
        traced, _ = trace.profiled(lambda: trainer.train_epoch(state, data, max_steps=k))
        traced_units = k
    peak = program.peak_bytes(dev)

    draws = ref_batch.first_steps(seed, cfg["num_param"], batch_size, cfg["augmentation"],
                                  CHECK_STEPS)
    wanted = sorted({int(i) for d in draws for i in (*d["rows"], *d["partners"])})
    kept = data[torch.as_tensor(wanted, device=dev)].clone()
    at = {r: j for j, r in enumerate(wanted)}
    seen = dict(losses=[float(v) for v in first.losses], mu1=first.mu1, params=first.params)
    del trainer, state, data, epochs, first
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = compare.train_checks(seen, reference_steps(cfg, seed, dev, kept, at, draws),
                                  inputs.weights(shapes, seed, "vae", dev), wl["limits"])
    param_count = sum(math.prod(s) for s in shapes.values())
    return harness.Outcome(
        e2e={"train_samples_per_s": steps * batch_size / window_s, "setup_s": setup_s},
        attempted=steps, failed=failed, checks=checks, memory_peak_bytes=peak, config=cfg,
        workload=wl, window=dict(seconds=window_s, units=steps,
                                 flops_per_unit=work.train_step_flops(cfg, batch_size)),
        trace=traced, traced_units=traced_units,
        facts=dict(batch=batch_size, param_count=param_count,
                   moment_bytes=2 if cfg["opt_state_dtype"] == "bfloat16" else 4))


def reference_steps(cfg: dict, seed: int, dev, kept, at: dict, draws, lowp=None) -> dict:
    """The reference's first steps from the run's inputs."""
    noise = cfg["augmentation"]["noise_prob"] > 0
    batches = [ref_batch.assemble(kept[[at[int(r)] for r in d["rows"]]],
                                  kept[[at[int(r)] for r in d["partners"]]], d, noise)
               for d in draws]
    gen = torch.Generator(dev).manual_seed(seed)
    shapes = ref_vae.noise_shapes(cfg, cfg["batch_size"])
    noises = [[torch.randn(s, generator=gen, device=dev, dtype=_DTYPES[cfg["dtype"]]).float()
               for s in shapes] for _ in draws]
    pshapes = ref_vae.param_shapes(cfg)
    with compare.exact_f32():
        return ref_train.train_steps(
            cfg, inputs.weights(pshapes, seed, "vae", dev),
            inputs.unit_vectors(pshapes, ref_vae.sn_names(pshapes), seed, dev),
            batches, noises, epoch=0, lowp=lowp)
