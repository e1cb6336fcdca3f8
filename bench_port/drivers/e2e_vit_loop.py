"""Closed-loop end-to-end (E2E) conditioner training with a ViT conditioner:
whole epochs back to back through ``E2ETrainer.train_epoch`` and
``E2ETrainer.eval_epoch``, the ViT (ViT-B/16 at the configuration's widths)
trained through the frozen VAE decoder.

The loop is ``e2e_loop``'s, whose helpers it loads by path (``frozen_vae``,
``split_data``, ``fit_epoch``): the frozen VAE as the training CLI hands it
over, the training and held-out splits on the card, f32, and one epoch of
``fit`` at a time. The conditioner is the program's own
(``convert.image_conditioner`` of an ``image_vit`` ``LCConfig`` with the
configuration's ``vit_*`` widths), its parameters the seed's; it has no
spectral norm and no BatchNorm. Set-up runs the first epoch, recording its
first three steps (``FirstSteps``); the window runs epochs until
``--seconds`` have passed, closed by a synchronize: ``train_samples_per_s``
is every design of every training step over the whole window. With
``--trace 1`` one whole epoch follows the window inside a profiler window
with the program's spans recorded (``benchlib.recorded``).

Correctness: once the window has closed and the program's state is freed,
the plain reference (``reference/vit.py``) runs the same three steps from
the same weights on the very batches, dropout masks and decoder noise the
program drew, in f32 with TF32 off. Compared: ``compare.train_checks``'
three numbers, and ``latent_gap``, the larger rel-L2 of step 1's main and
hierarchical latents against the reference's, before the decoder (it
holds the ViT to the f32 the configuration states where the decoder's bf16
sets the other three).
"""

from __future__ import annotations

import gc
import math
import time

import torch

from benchlib import compare, e2e_work, harness, inputs, program, recorded, serving, vit_work
from reference import vae as ref_vae
from reference import vit as ref_vit

CHECK_STEPS = 3
_shared = harness.driver("e2e_loop")
frozen_vae, split_data, fit_epoch = _shared.frozen_vae, _shared.split_data, _shared.fit_epoch


def _host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().float().to("cpu", copy=True)


class FirstSteps:
    """Records the first ``steps`` steps of an ``E2ETrainer`` with a ViT: the
    noisy batch each step trained on, the dropout masks in call order (the
    tokens', each block's attention mask ``[1, 1, q, k]`` and MLP mask) and
    the decoder's noise it drew (each drawn again from the generator's state
    before the program's draw, through the program's own function), its
    loss, the latents of step 1, the first moments after step 1, and the
    parameters after the last; everything on the host."""

    def __init__(self, trainer, steps: int):
        from simulgen_vae_tpu_torch.models import conditioner_vit, decoder

        self.batches, self.masks, self.eps, self.losses = [], [], [], []
        self.mu1 = self.params = self.latents = self.before = None
        self.trainer, self.steps, self.live = trainer, steps, False
        self.patched = [(conditioner_vit, "dropout", conditioner_vit.dropout),
                        (conditioner_vit, "attention_dropout", conditioner_vit.attention_dropout),
                        (decoder, "reparameterize", decoder.reparameterize)]
        augment, step = trainer._augment, trainer._step
        drop, attend = conditioner_vit.dropout, conditioner_vit.attention_dropout
        sample = decoder.reparameterize

        def again(fn, generator, *args):
            """``fn(*args)`` drawn from ``generator``'s state before the last
            draw, the state after it kept."""
            after = generator.get_state()
            generator.set_state(self.before)
            out = fn(*args, generator)
            generator.set_state(after)
            return _host(out)

        def masking(fn, ones):
            def patched(x, rate, generator):
                if not self.live or generator is None or rate == 0.0:
                    return fn(x, rate, generator)
                self.before = generator.get_state()
                out = fn(x, rate, generator)
                self.masks[-1].append(again(fn, generator, ones(x), rate))
                return out
            return patched

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

        def keep_latents(module, args, out):
            self.latents = tuple(_host(t) for t in out)

        def stepping(state, batch, lr):
            self.live = len(self.losses) < steps
            if not self.live:
                return step(state, batch, lr)
            self.masks.append([])
            self.eps.append([])
            hook = state.model.register_forward_hook(keep_latents) if not self.losses else None
            try:
                metrics = step(state, batch, lr)
            finally:
                if hook is not None:
                    hook.remove()
            self.live = False
            self.losses.append(float(metrics["loss"]))
            if len(self.losses) == 1:
                self.mu1 = {k: v.detach().to("cpu", torch.float32, copy=True)
                            for k, v in state.opt_state["mu"].items()}
            if len(self.losses) == steps:
                self.params = {k: p.detach().to("cpu", torch.float32, copy=True)
                               for k, p in state.model.named_parameters()}
            return metrics

        trainer._augment, trainer._step = augmenting, stepping
        conditioner_vit.dropout = masking(drop, torch.ones_like)
        conditioner_vit.attention_dropout = masking(
            attend, lambda w: torch.ones((1, 1, *w.shape[-2:]), dtype=w.dtype, device=w.device))
        decoder.reparameterize = sampling

    def close(self) -> None:
        del self.trainer._augment, self.trainer._step
        for module, name, fn in self.patched:
            setattr(module, name, fn)

    def drawn(self) -> dict:
        """What the reference is handed: each step's noisy batch, masks and
        decoder noise."""
        return dict(batches=self.batches, masks=self.masks, eps=self.eps)

    def seen(self) -> dict:
        """What the program gave: losses, step 1's first moments and latents,
        the parameters after the last step."""
        return dict(losses=self.losses, mu1=self.mu1, params=self.params, latents=self.latents)


def vit_weights(cfg: dict, seed: int, dev) -> dict:
    """The ViT's f32 parameters from the seed."""
    return inputs.weights(ref_vit.vit_shapes(cfg), seed, "conditioner", dev)


def lc_config(cfg: dict):
    """The program's ``LCConfig`` of the configuration: ``image_vit`` at its
    widths, E2E training with its keys."""
    from simulgen_vae_tpu_torch.config import LCConfig

    c, e = cfg["conditioner"], cfg["e2e"]
    if (c["patch_size"], c["mlp_ratio"]) != (16, 4):
        raise ValueError("the program's ViT has 16-pixel patches and an MLP ratio of 4")
    return LCConfig(epochs=e["epochs"], lr=e["lr"], batch_size=e["batch_size"],
                    weight_decay=e["weight_decay"], dropout_rate=c["dropout_rate"],
                    input_type="image_vit", use_e2e_training=True,
                    e2e_loss_function=e["loss_function"],
                    use_latent_regularization=e["latent_regularization"],
                    lc_alpha=e["lc_alpha"], latent_reg_weight=e["latent_reg_weight"],
                    vit_embed_dim=c["embed_dim"], vit_depth=c["depth"],
                    vit_num_heads=c["num_heads"])


def build(cfg: dict, seed: int, dev):
    """``(trainer, state, train split, held-out split)`` of the program."""
    from simulgen_vae_tpu_torch import convert
    from simulgen_vae_tpu_torch.data.scaler import MinMaxScaler
    from simulgen_vae_tpu_torch.train.lc_e2e_trainer import E2ETrainer

    vae = frozen_vae(cfg, seed, dev)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    lc_cfg = lc_config(cfg)
    s = serving.scalers(cfg, seed, dev)
    trainer = E2ETrainer(
        convert.image_conditioner(lc_cfg, program.vae_config(cfg), dev,
                                  image_side=cfg["conditioner"]["image_side"]),
        vae, MinMaxScaler(s["lv_scale"], s["lv_min"]), MinMaxScaler(s["xs_scale"], s["xs_min"]),
        epochs=lc_cfg.epochs, lr=lc_cfg.lr, batch_size=lc_cfg.batch_size,
        weight_decay=lc_cfg.weight_decay, loss_function=lc_cfg.e2e_loss_function,
        lc_alpha=lc_cfg.lc_alpha, use_latent_regularization=lc_cfg.use_latent_regularization,
        latent_reg_weight=lc_cfg.latent_reg_weight, device=dev, seed=seed)
    state = trainer.init_state(seed)
    program.load_state(state.model, vit_weights(cfg, seed, dev))
    n = cfg["num_param"]
    n_val = int(n * cfg["e2e"]["val_split"])
    train = split_data(cfg, n - n_val, seed, dev)
    held_out = split_data(cfg, n_val, inputs.subseed(seed, "held_out"), dev)
    return trainer, state, train, held_out


def run(ctx: harness.Ctx) -> harness.Outcome:
    cfg, wl, dev, seed = ctx.config, ctx.workload, ctx.device, ctx.seed
    lc_config(cfg)  # a program without the ViT's widths fails here, before any build
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

    seen, drawn = first.seen(), first.drawn()
    del trainer, state, train, held_out, best, first
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = check(cfg, seed, dev, seen, reference_steps(cfg, seed, dev, drawn), wl["limits"])
    return harness.Outcome(
        e2e={"train_samples_per_s": steps * batch / window_s, "setup_s": setup_s},
        attempted=steps, failed=failed, checks=checks, memory_peak_bytes=peak, config=cfg,
        workload=wl, window=dict(seconds=window_s, units=steps,
                                 flops_per_unit=vit_work.step_flops(cfg)),
        trace=traced, traced_units=traced_units, facts=dict(batch=batch))


def latent_gap(have, want) -> float:
    """The larger rel-L2 of the main and the hierarchical latents."""
    return max(float(torch.linalg.vector_norm(h.float() - w.float().cpu())
                     / torch.linalg.vector_norm(w.float())) for h, w in zip(have, want))


def readings(cfg: dict, seed: int, dev, seen: dict, ref: dict) -> dict:
    """The three training numbers with the leaves that set them, and
    ``latent_gap``."""
    r = compare.train_readings(seen, ref, vit_weights(cfg, seed, dev))
    r["latent_gap"] = latent_gap(seen["latents"], ref["latents"])
    return r


def check(cfg: dict, seed: int, dev, seen: dict, ref: dict, limits: dict) -> dict:
    r = readings(cfg, seed, dev, seen, ref)
    return {k: (r[k], float(limits[k]))
            for k in ("loss_gap", "grad_gap", "change_gap", "latent_gap")}


def reference_steps(cfg: dict, seed: int, dev, drawn: dict, lowp=None) -> dict:
    """The reference's first steps on what the program drew (the masks stay
    on the host until the reference uses each)."""
    shapes = ref_vae.param_shapes(cfg)
    weights = inputs.weights(shapes, seed, "vae", dev)
    vectors = inputs.unit_vectors(shapes, ref_vae.sn_names(shapes), seed, dev)
    dec_names = ref_vae.decoder_shapes(cfg)
    dec = {k: weights[k] for k in dec_names}
    dec_us = {k: vectors[k] for k in dec_names if k in vectors}
    del weights, vectors
    s = serving.scalers(cfg, seed, dev)
    batches = [tuple(t.to(dev) for t in b) for b in drawn["batches"]]
    eps = [[e.to(dev) for e in step] for step in drawn["eps"]]
    return ref_vit.train_steps(cfg, vit_weights(cfg, seed, dev), dec, dec_us, s, batches,
                               drawn["masks"], eps, lowp=lowp)
