"""Closed-loop end-to-end (E2E) conditioner training: whole epochs back to
back through ``E2ETrainer.train_epoch`` and ``E2ETrainer.eval_epoch``, the
image CNN trained through the frozen VAE decoder.

Set-up builds the frozen VAE as the training CLI hands it over
(``VAETrainer.eval_params`` of the seed's weights and power-iteration
vectors: spectral norm divided in, the configuration's compute dtype), the
conditioner (``convert.image_conditioner``, spectral norm on its ``sn_*``
layers) with the seed's weights and vectors, the latent scalers, and the
training and held-out splits on the card as ``fit`` puts them there, f32
(each split made from a seed stream of its own): seeded outline images,
latent targets and fields. It then runs the first
epoch, recording its first three steps (``FirstSteps``). Each epoch is one
epoch of ``E2ETrainer.fit`` on the card (``fit_epoch``): ``train_epoch``
over the training split, the train metrics read back, ``eval_epoch`` over
the held-out split and its metrics read back, and the best state's
snapshot when the held-out loss improves; no checkpoint file is written.
The window runs epochs until ``--seconds`` have passed, closed by a
synchronize: ``train_samples_per_s`` is every design of every training step
over the whole window. With ``--trace 1`` one whole epoch follows the
window inside a profiler window with the program's spans recorded
(``benchlib.recorded``).

Correctness: once the window has closed and the program's state is freed,
the plain reference (``reference/e2e.py``) runs the same three steps from the
same weights and vectors on the very batches, dropout masks and decoder
noise the program drew, in f32, and the three numbers of the train cells are
compared with it (``compare.train_checks``).
"""

from __future__ import annotations

import gc
import math
import time

import torch

from benchlib import compare, e2e_work, harness, inputs, program, recorded, serving
from reference import conditioner as ref_cond
from reference import e2e as ref_e2e
from reference import vae as ref_vae

CHECK_STEPS = 3


class FirstSteps:
    """Records the first ``steps`` steps of an ``E2ETrainer``: the noisy batch
    each step trained on, the dropout masks and the decoder's noise it drew
    (each drawn again from the generator's state before the program's draw,
    through the program's own function), its loss, the first moments after
    step 1, and the parameters and power-iteration vectors after the last;
    everything on the host."""

    def __init__(self, trainer, steps: int):
        from simulgen_vae_tpu_torch.models import conditioner_cnn, decoder

        self.batches, self.masks, self.eps, self.losses = [], [], [], []
        self.mu1 = self.params = self.us = self.before = None
        self.trainer, self.steps, self.live = trainer, steps, False
        self.patched = [(conditioner_cnn, "dropout", conditioner_cnn.dropout),
                        (decoder, "reparameterize", decoder.reparameterize)]
        augment, step = trainer._augment, trainer._step
        drop, sample = conditioner_cnn.dropout, decoder.reparameterize

        def again(fn, generator, *args):
            """``fn(*args)`` drawn from ``generator``'s state before the last
            draw, the state after it kept."""
            after = generator.get_state()
            generator.set_state(self.before)
            out = fn(*args, generator)
            generator.set_state(after)
            return out.detach().float().to("cpu", copy=True)

        def dropping(x, rate, generator):
            if not self.live or generator is None or rate == 0.0:
                return drop(x, rate, generator)
            self.before = generator.get_state()
            out = drop(x, rate, generator)
            self.masks[-1].append(again(drop, generator, torch.ones_like(x), rate))
            return out

        def sampling(mu, std, generator=None, rows=None):
            if not self.live:
                return sample(mu, std, generator, rows)
            self.before = generator.get_state()
            out = sample(mu, std, generator, rows)
            self.eps[-1].append(again(lambda m, s, g: sample(m, s, g, rows), generator,
                                      torch.zeros_like(mu), torch.ones_like(std)))
            return out

        def augmenting(*tensors):
            out = augment(*tensors)
            if len(self.losses) < steps:
                self.batches.append(tuple(t.detach().to("cpu", copy=True) for t in out))
            return out

        def stepping(state, batch, lr):
            self.live = len(self.losses) < steps
            if not self.live:
                return step(state, batch, lr)
            self.masks.append([])
            self.eps.append([])
            metrics = step(state, batch, lr)
            self.live = False
            self.losses.append(float(metrics["loss"]))
            if len(self.losses) == 1:
                self.mu1 = {k: v.detach().to("cpu", torch.float32, copy=True)
                            for k, v in state.opt_state["mu"].items()}
            if len(self.losses) == steps:
                self.params = {k: p.detach().to("cpu", torch.float32, copy=True)
                               for k, p in state.model.named_parameters()}
                self.us = {k: u.detach().to("cpu", copy=True) for k, u in state.sn_u.items()}
            return metrics

        trainer._augment, trainer._step = augmenting, stepping
        conditioner_cnn.dropout, decoder.reparameterize = dropping, sampling

    def close(self) -> None:
        del self.trainer._augment, self.trainer._step
        for module, name, fn in self.patched:
            setattr(module, name, fn)

    def drawn(self) -> dict:
        """What the reference is handed: each step's noisy batch, masks and
        decoder noise."""
        return dict(batches=self.batches, masks=self.masks, eps=self.eps)


def frozen_vae(cfg: dict, seed: int, dev):
    """The trained VAE as the training CLI hands it to the conditioner stage:
    ``VAETrainer.eval_params`` of the seed's weights and vectors."""
    from simulgen_vae_tpu_torch.train.vae_trainer import VAETrainer

    trainer = VAETrainer(program.vae_config(cfg), device=dev, seed=seed)
    state = trainer.init_state(seed)
    shapes = ref_vae.param_shapes(cfg)
    program.load_state(state.model, inputs.weights(shapes, seed, "vae", dev), params_only=True)
    us = inputs.unit_vectors(shapes, ref_vae.sn_names(shapes), seed, dev)
    state.sn_u = {k: us[k].clone() for k in state.sn_u}
    return trainer.eval_params(state)


def split_data(cfg: dict, rows: int, seed: int, dev) -> list:
    """``[images, main latents, hierarchical latents, fields]`` of ``rows``
    seeded designs, f32 on the card: outline images, latents uniform in the
    scalers' range (-0.7, 0.7), and fields of the seeded ensemble."""
    levels = len(cfg["num_filter_enc"]) - 1
    z, h = cfg["latent_dim_end"], cfg["latent_dim"]
    x = serving.outlines(rows, cfg["conditioner"]["image_side"], seed, dev)
    lat = inputs.designs(1, rows, z + levels * h, seed, dev)[0]
    fields = inputs.ensemble(rows, cfg["num_time"], cfg["num_node"], seed, dev, torch.float32)
    return [x, lat[:, :z].contiguous(), lat[:, z:].reshape(rows, levels, h).contiguous(), fields]


def conditioner_inputs(cfg: dict, seed: int, dev) -> tuple:
    """``(weights, vectors)``: the conditioner's f32 parameters and BatchNorm
    statistics, and one unit vector per ``sn_*`` kernel, from the seed."""
    shapes = ref_cond.conditioner_shapes(cfg)
    return (inputs.weights(shapes, seed, "conditioner", dev),
            inputs.unit_vectors(shapes, ref_e2e.sn_names(shapes), seed, dev))


def build(cfg: dict, seed: int, dev):
    """``(trainer, state, train split, held-out split)`` of the program."""
    from simulgen_vae_tpu_torch import convert
    from simulgen_vae_tpu_torch.config import LCConfig
    from simulgen_vae_tpu_torch.data.scaler import MinMaxScaler
    from simulgen_vae_tpu_torch.models.conditioner_cnn import sn_filter
    from simulgen_vae_tpu_torch.train.lc_e2e_trainer import E2ETrainer

    c, e = cfg["conditioner"], cfg["e2e"]
    vae = frozen_vae(cfg, seed, dev)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    lc_cfg = LCConfig(filters=list(c["filters"]), epochs=e["epochs"], lr=e["lr"],
                      batch_size=e["batch_size"], weight_decay=e["weight_decay"],
                      dropout_rate=c["dropout_rate"],
                      use_spatial_attention=c["spatial_attention"], input_type="image",
                      use_e2e_training=True, e2e_loss_function=e["loss_function"],
                      use_latent_regularization=e["latent_regularization"],
                      lc_alpha=e["lc_alpha"], latent_reg_weight=e["latent_reg_weight"])
    s = serving.scalers(cfg, seed, dev)
    trainer = E2ETrainer(
        convert.image_conditioner(lc_cfg, program.vae_config(cfg), dev,
                                  image_side=c["image_side"]),
        vae, MinMaxScaler(s["lv_scale"], s["lv_min"]), MinMaxScaler(s["xs_scale"], s["xs_min"]),
        epochs=lc_cfg.epochs, lr=lc_cfg.lr, batch_size=lc_cfg.batch_size,
        weight_decay=lc_cfg.weight_decay, loss_function=lc_cfg.e2e_loss_function,
        lc_alpha=lc_cfg.lc_alpha, use_latent_regularization=lc_cfg.use_latent_regularization,
        latent_reg_weight=lc_cfg.latent_reg_weight, sn_filter=sn_filter, device=dev, seed=seed)
    state = trainer.init_state(seed)
    weights, us = conditioner_inputs(cfg, seed, dev)
    program.load_state(state.model, weights)
    if set(state.sn_u) != set(us):
        raise RuntimeError("the program normalises other kernels than the reference")
    state.sn_u = {k: us[k].clone() for k in state.sn_u}
    n = cfg["num_param"]
    n_val = int(n * e["val_split"])
    train = split_data(cfg, n - n_val, seed, dev)
    held_out = split_data(cfg, n_val, inputs.subseed(seed, "held_out"), dev)
    return trainer, state, train, held_out


def fit_epoch(trainer, state, train, held_out, best: dict) -> float:
    """One epoch of ``E2ETrainer.fit`` on the card; returns its train loss."""
    state, metrics = trainer.train_epoch(state, *train)
    loss = trainer._read_back(metrics)["loss"]
    val = trainer._read_back(trainer.eval_epoch(state, *held_out))["loss"]
    if val < best["loss"]:
        best.update(loss=val, state=trainer._snapshot(state))
    return loss


def run(ctx: harness.Ctx) -> harness.Outcome:
    cfg, wl, dev, seed = ctx.config, ctx.workload, ctx.device, ctx.seed
    program.build_kernels(dev)
    trainer, state, train, held_out = build(cfg, seed, dev)
    steps_per_epoch, _ = e2e_work.split(cfg)
    batch = cfg["e2e"]["batch_size"]
    best = {"loss": math.inf}
    first = FirstSteps(trainer, CHECK_STEPS)
    losses = [fit_epoch(trainer, state, train, held_out, best)]
    first.close()
    program.sync(dev)
    setup_s = harness.process_seconds()

    steps, t0 = 0, time.perf_counter()
    while time.perf_counter() - t0 < ctx.seconds:
        losses.append(fit_epoch(trainer, state, train, held_out, best))
        steps += steps_per_epoch
    program.sync(dev)
    window_s = time.perf_counter() - t0
    failed = steps_per_epoch * sum(not math.isfinite(v) for v in losses[1:])

    traced, traced_units = None, 0
    if ctx.trace:
        traced, _ = recorded.profiled(lambda: fit_epoch(trainer, state, train, held_out, best))
        traced_units = steps_per_epoch
    peak = program.peak_bytes(dev)

    seen = dict(losses=first.losses, mu1=first.mu1, params=first.params)
    drawn = first.drawn()
    del trainer, state, train, held_out, best, first
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    params0, _ = conditioner_inputs(cfg, seed, dev)
    checks = compare.train_checks(seen, reference_steps(cfg, seed, dev, drawn), params0,
                                  wl["limits"])
    return harness.Outcome(
        e2e={"train_samples_per_s": steps * batch / window_s, "setup_s": setup_s},
        attempted=steps, failed=failed, checks=checks, memory_peak_bytes=peak, config=cfg,
        workload=wl, window=dict(seconds=window_s, units=steps,
                                 flops_per_unit=e2e_work.step_flops(cfg)),
        trace=traced, traced_units=traced_units, facts=dict(batch=batch))


def reference_steps(cfg: dict, seed: int, dev, drawn: dict, lowp=None) -> dict:
    """The reference's first steps on what the program drew."""
    shapes = ref_vae.param_shapes(cfg)
    weights = inputs.weights(shapes, seed, "vae", dev)
    vectors = inputs.unit_vectors(shapes, ref_vae.sn_names(shapes), seed, dev)
    dec_names = ref_vae.decoder_shapes(cfg)
    dec = {k: weights[k] for k in dec_names}
    dec_us = {k: vectors[k] for k in dec_names if k in vectors}
    del weights, vectors
    cond, us = conditioner_inputs(cfg, seed, dev)
    s = serving.scalers(cfg, seed, dev)
    batches = [tuple(t.to(dev) for t in b) for b in drawn["batches"]]
    masks = [[m.to(dev) for m in step] for step in drawn["masks"]]
    eps = [[e.to(dev) for e in step] for step in drawn["eps"]]
    return ref_e2e.train_steps(cfg, cond, us, dec, dec_us, s, batches, masks, eps, lowp=lowp)
