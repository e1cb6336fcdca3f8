"""Latent-conditioner trainer on one card (``simulgen_vae_tpu/train/lc_trainer.py``
``LCTrainer``), for the CSV (MLP) and the image (CNN, ViT) conditioners.

An epoch takes ``n // batch`` batches of a fresh permutation (the last
partial batch is dropped; ``batch = min(batch_size, n)``). Each batch:

* images (``is_image_data``): ``data.image_augmentation.augment_images``
  (``prob=.8, apply_prob=.5``), drawn from the trainer's ``torch.Generator``;
* mixup with probability .02: ``lam ~ Beta(0.2, 0.2)`` against a permutation
  of the batch, on the inputs and both targets;
* input noise with probability .05, ``sigma = .01``;
* the conditioner's forward in training mode (dropout masks from the
  trainer's ``torch.Generator``, BatchNorms on the batch's statistics and
  updating their running ones), through ``W / sigma`` on the layers
  ``sn_filter`` selects (one power iteration a step, the ``u`` vectors in
  the state and its checkpoints; ``models.spectral_norm``), loss ``10 * MSE(main) + MSE(hier)`` or, in
  ``"enhanced"`` mode, the MSE / MAE / smooth-L1 blend plus the cosine term;
* the global gradient norm, a clip at 10 (``g / norm * 10`` above it, as
  optax's ``clip_by_global_norm``), then AdamW (b1 .9, b2 .999, eps 1e-8,
  weight decay on every parameter, f32 moments: ``train.optim.FusedAdamW``,
  whose kernel runs on CUDA tensors) at the epoch's ``lc_warmup_cosine`` rate
  with ``warmup = min(100, max(epochs // 2, 1))``.

The enhanced mode takes the JAX trainer's default weights (an empty
``enhanced_config``).

Host randomness (permutations, the mixup and noise draws) comes from a numpy
``Generator``, device randomness (noise, dropout) from a ``torch.Generator``,
both seeded by the trainer's seed and saved in a checkpoint, so a restored
``fit`` continues as the uninterrupted one. Step metrics stay on the device;
``fit`` reads an epoch's back once.

:meth:`LCTrainer.fit` splits 0.7 / 0.3, scrubs NaN inputs to 0, validates
every ``val_every`` epochs and after the last, stops when val / train loss
exceeds ``overfit_threshold``, rolls back to the last checkpoint on a
non-finite train loss (``train.nan_guard``), saves through
``utils.checkpoint.CheckpointManager`` and stops early on a preemption
request (``utils.preemption``). The state has the fields that manager saves.

Evaluation and :meth:`LCTrainer.predict_fn` run in eval mode (running
statistics, no dropout) through ``W / sigma`` from the stored ``u``.

An epoch, its steps and their phases, and each held-out batch are spans
(``lc.epoch``, ``lc.step``, ``lc.eval`` and the phases ``utils.profiling``
lists), recorded only inside ``profiling.recording()``.
"""

from __future__ import annotations

import copy
import dataclasses
import math
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from simulgen_vae_tpu_torch.data.image_augmentation import augment_images
from simulgen_vae_tpu_torch.generate import resolve_device
from simulgen_vae_tpu_torch.losses import (
    compute_enhanced_loss,
    compute_perceptual_loss,
    mse_loss,
)
from simulgen_vae_tpu_torch.models.spectral_norm import init_sn_state, spectral_normalize
from simulgen_vae_tpu_torch.train.nan_guard import rollback
from simulgen_vae_tpu_torch.train.optim import FusedAdamW
from simulgen_vae_tpu_torch.train.schedules import lc_warmup_cosine
from simulgen_vae_tpu_torch.utils import preemption
from simulgen_vae_tpu_torch.utils.profiling import span, tick

STEP_METRICS = ("loss", "loss_y1", "loss_y2", "grad_norm")
EVAL_METRICS = STEP_METRICS[:-1]
CLIP_NORM = 10.0
MIXUP_PROB, MIXUP_ALPHA = 0.02, 0.2
NOISE_PROB, NOISE_STD = 0.05, 0.01
WARMUP_EPOCHS = 100


@dataclasses.dataclass
class LCTrainState:
    model: nn.Module  # f32 parameters (and the BatchNorms' running statistics)
    opt_state: dict   # FusedAdamW: count, mu, nu (f32, keyed by parameter name)
    sn_u: dict        # spectral-norm u per normalised kernel (empty without sn_filter)
    epoch: int = 0
    rng: Optional[dict] = None  # the trainer's generator states at the last save


class SpectrallyNormalised:
    """A conditioner called through ``W / sigma`` on the layers ``filter_fn``
    selects: ``u`` from ``sn_u``, one power iteration when ``update``; the
    moved vectors are left in :attr:`new_u`. Called as the model is."""

    def __init__(self, model: nn.Module, sn_u: dict, filter_fn, update: bool):
        self.model, self.sn_u, self.filter_fn, self.update = model, sn_u, filter_fn, update
        self.new_u = sn_u

    def __call__(self, x, generator=None, **kwargs):
        normed, self.new_u = spectral_normalize(self.model, self.sn_u, update=self.update,
                                                filter_fn=self.filter_fn)
        return torch.func.functional_call(self.model, normed, (x, generator), kwargs)


def forward_model(state: LCTrainState, sn_filter, update: bool):
    """The state's model as a loss calls it: through ``W / sigma`` where
    ``sn_filter`` selects layers (``update``: one power iteration)."""
    if sn_filter is None:
        return state.model
    return SpectrallyNormalised(state.model, state.sn_u, sn_filter, update)


@torch.no_grad()
def init_conditioner(model: nn.Module, seed: int) -> nn.Module:
    """The JAX module's init, drawn on the CPU from ``seed``: an image
    conditioner's own (``init_weights``), else the MLP's He-uniform dense
    kernels (bound sqrt(6 / fan_in)), zero biases, unit LayerNorms."""
    gen = torch.Generator().manual_seed(seed)
    if hasattr(model, "init_weights"):
        return model.init_weights(gen)
    for m in model.modules():
        if isinstance(m, nn.Linear):
            bound = math.sqrt(6.0 / m.in_features)
            m.weight.copy_(torch.empty(m.weight.shape).uniform_(-bound, bound, generator=gen))
            m.bias.zero_()
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
    return model


class LCTrainer:
    """The latent-conditioner trainer; ``E2ETrainer`` (``train.lc_e2e_trainer``)
    subclasses it, overriding the loss, the batch augmentation, the rate and
    the clip, and keeping the best validation state (:attr:`track_best`)."""

    STEP_METRICS, EVAL_METRICS = STEP_METRICS, EVAL_METRICS
    stage = "lc"        # nan_guard's name for the run
    track_best = False  # fit returns the last state, not the best validated one

    def __init__(self, model: nn.Module, epochs: int, lr: float, batch_size: int,
                 weight_decay: float = 1e-4, loss_mode: str = "standard",
                 device=None, seed: int = 0, is_image_data: bool = False,
                 sn_filter: Optional[Callable[[str], bool]] = None):
        """``model`` is the architecture (a conditioner of ``models``);
        :meth:`init_state` trains a copy of it. ``is_image_data`` augments
        the inputs as images; ``sn_filter`` (a predicate on parameter names)
        turns spectral norm on for the layers it accepts."""
        if loss_mode not in ("standard", "enhanced"):
            raise ValueError(f"loss_mode must be 'standard' or 'enhanced', got {loss_mode!r}")
        self.model = model
        self.epochs, self.lr, self.batch_size = epochs, lr, batch_size
        self.loss_mode = loss_mode
        self.is_image_data, self.sn_filter = is_image_data, sn_filter
        self.warmup_epochs = min(WARMUP_EPOCHS, max(epochs // 2, 1))
        self.device = resolve_device(device)
        self.opt = FusedAdamW(b1=0.9, b2=0.999, eps=1e-8, weight_decay=weight_decay)
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.generator = torch.Generator(self.device).manual_seed(seed)

    # -- state ---------------------------------------------------------------

    def _init_model(self, seed: int) -> nn.Module:
        return init_conditioner(copy.deepcopy(self.model).to(self.device), seed)

    def init_state(self, seed: int = 0) -> LCTrainState:
        model = self._init_model(seed)
        sn_u = {}
        if self.sn_filter is not None:
            sn_u = init_sn_state(model, torch.Generator(self.device).manual_seed(seed),
                                 self.sn_filter)
        return LCTrainState(model, self.opt.init(dict(model.named_parameters())), sn_u)

    def rng_state(self) -> dict:
        return {"numpy": self.rng.bit_generator.state,
                "torch": self.generator.get_state().clone()}

    def load_rng_state(self, rng: dict) -> None:
        self.rng.bit_generator.state = rng["numpy"]
        self.generator.set_state(rng["torch"].cpu())

    # -- loss and update ---------------------------------------------------

    def loss_fn(self, model: nn.Module, x: torch.Tensor, y1: torch.Tensor,
                y2: torch.Tensor, generator: Optional[torch.Generator] = None):
        """``(loss, metrics)``; ``generator`` turns training mode on (dropout,
        and the BatchNorms on the batch's statistics)."""
        with span("lc.conditioner"):
            y_pred1, y_pred2 = model(x, generator)
        with span("lc.loss"):
            a, b = mse_loss(y_pred1, y1), mse_loss(y_pred2, y2)
            if self.loss_mode == "enhanced":
                loss = (compute_enhanced_loss(y_pred1, y_pred2, y1, y2, {})
                        + compute_perceptual_loss(y_pred1, y_pred2, y1, y2, {}))
            else:
                loss = a * 10.0 + b
        return loss, {"loss": loss.detach(), "loss_y1": a.detach(), "loss_y2": b.detach()}

    def lr_at(self, epoch: int) -> float:
        return lc_warmup_cosine(epoch, self.lr, self.epochs, self.warmup_epochs)

    def clip(self, grads: Dict[str, torch.Tensor]):
        """``(clipped, norm)``: ``grads`` scaled to global norm 10 above it,
        as one factor on the device; ``norm`` the global norm before."""
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(grads.values()))))
        keep = norm < CLIP_NORM
        return {k: torch.where(keep, g, g / norm * CLIP_NORM) for k, g in grads.items()}, norm

    def apply_grads(self, state: LCTrainState, grads: Dict[str, torch.Tensor],
                    lr: float) -> torch.Tensor:
        """:meth:`clip` ``grads`` and apply AdamW in place; returns the norm
        before clipping (a 0-d device tensor)."""
        with span("lc.optimizer"):
            clipped, norm = self.clip(grads)
            self.opt.apply(clipped, state.opt_state, dict(state.model.named_parameters()), lr)
        return norm

    def _step(self, state: LCTrainState, batch, lr: float) -> Dict[str, torch.Tensor]:
        model = state.model
        for p in model.parameters():
            p.grad = None
        forward = forward_model(state, self.sn_filter, update=True)
        loss, metrics = self.loss_fn(forward, *batch, self.generator)
        with span("lc.backward"):
            loss.backward()
            if self.sn_filter is not None:
                state.sn_u = forward.new_u
            grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                     for k, p in model.named_parameters()}
        metrics["grad_norm"] = self.apply_grads(state, grads, lr)
        return metrics

    def _augment(self, x, y1, y2):
        """Image augmentation (on the device), then mixup (p .02) and input
        noise (p .05), decided on the host."""
        if self.is_image_data:
            x = augment_images(x, self.generator, prob=0.8, apply_prob=0.5)
        do_mix = self.rng.random() < MIXUP_PROB
        lam = float(self.rng.beta(MIXUP_ALPHA, MIXUP_ALPHA))
        partner = self.rng.permutation(x.shape[0])
        if do_mix:
            idx = torch.as_tensor(partner, device=x.device)
            x, y1, y2 = (lam * t + (1.0 - lam) * t.index_select(0, idx) for t in (x, y1, y2))
        if self.rng.random() < NOISE_PROB:
            x = x + torch.randn(x.shape, generator=self.generator, device=x.device) * NOISE_STD
        return x, y1, y2

    # -- epochs --------------------------------------------------------------

    def train_epoch(self, state: LCTrainState, *data: torch.Tensor):
        """One epoch over device tensors (``x`` [n, features], ``y1`` [n, z],
        ``y2`` [n, size2, latent], and what else the loss takes), each batch
        through :meth:`_augment`. Returns ``(state, metrics)``: step means as
        0-d device tensors, plus ``lr``."""
        n = data[0].shape[0]
        bsz = min(self.batch_size, n)
        num_batches = max(n // bsz, 1)
        lr = self.lr_at(state.epoch)
        perm = self.rng.permutation(n)[: num_batches * bsz].reshape(num_batches, bsz)
        steps = []
        with span("lc.epoch"):
            for idx in torch.as_tensor(perm, device=data[0].device):
                with span("lc.step", tick("lc.steps")):
                    with span("lc.augment"):
                        batch = self._augment(*(t.index_select(0, idx) for t in data))
                    steps.append(self._step(state, batch, lr))
        state.epoch += 1
        mean = torch.stack([torch.stack([m[k] for k in self.STEP_METRICS])
                            for m in steps]).mean(0)
        metrics = {k: mean[i] for i, k in enumerate(self.STEP_METRICS)}
        metrics["lr"] = lr
        return state, metrics

    @torch.no_grad()
    def eval_epoch(self, state: LCTrainState, *data: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Mean loss metrics over ``n // batch`` batches in order, eval mode,
        no augmentation."""
        n = data[0].shape[0]
        bsz = min(self.batch_size, n)
        num_batches = max(n // bsz, 1)
        total = None
        model = forward_model(state, self.sn_filter, update=False)
        for i in range(num_batches):
            with span("lc.eval", tick("lc.eval_batches")):
                rows = slice(i * bsz, (i + 1) * bsz)
                _, m = self.loss_fn(model, *(t[rows] for t in data))
                vals = torch.stack([m[k] for k in self.EVAL_METRICS])
                total = vals if total is None else total + vals
        mean = total / num_batches
        return {k: mean[i] for i, k in enumerate(self.EVAL_METRICS)}

    @staticmethod
    def _snapshot(state: LCTrainState) -> LCTrainState:
        """A copy of ``state`` that later steps do not change."""
        opt = {"count": state.opt_state["count"],
               **{k: {n: t.clone() for n, t in state.opt_state[k].items()}
                  for k in ("mu", "nu")}}
        return LCTrainState(copy.deepcopy(state.model), opt,
                            {k: u.clone() for k, u in state.sn_u.items()}, state.epoch,
                            state.rng)

    @staticmethod
    def _read_back(metrics: Dict) -> Dict[str, float]:
        """An epoch's metrics on the host: one read of the device values."""
        on_device = [k for k, v in metrics.items() if torch.is_tensor(v)]
        vals = torch.stack([metrics[k].float() for k in on_device]).cpu().tolist()
        out = {k: float(v) for k, v in metrics.items() if k not in on_device}
        out.update(zip(on_device, vals))
        return out

    # -- fit -----------------------------------------------------------------

    def fit(self, x: np.ndarray, y1: np.ndarray, y2: np.ndarray, seed: int = 0,
            state: Optional[LCTrainState] = None, val_split: float = 0.3,
            val_every: int = 10, overfit_threshold: float = 1000.0,
            log_fn: Optional[Callable[[int, Dict], None]] = None,
            epochs: Optional[int] = None, ckpt_manager=None,
            nan_guard: bool = True, nan_guard_max_retries: int = 2):
        """Train on ``x`` [n, features], ``y1`` [n, z], ``y2`` [n, size2,
        latent] (numpy) with a ``val_split`` hold-out drawn from ``seed``.
        Returns ``(state, history)``, history holding per-epoch numpy arrays.
        ``fit(state=...)`` on a restored state continues from its epoch with
        the generators' saved states."""
        return self._fit((x, y1, y2), seed=seed, state=state, val_split=val_split,
                         val_every=val_every, overfit_threshold=overfit_threshold,
                         log_fn=log_fn, epochs=epochs, ckpt_manager=ckpt_manager,
                         nan_guard=nan_guard, nan_guard_max_retries=nan_guard_max_retries)

    def _fit(self, arrays, *, seed, state, val_split, val_every, overfit_threshold, log_fn,
             epochs, ckpt_manager, nan_guard, nan_guard_max_retries):
        """The epoch loop of both trainers on the numpy ``arrays`` :meth:`loss_fn`
        takes. With :attr:`track_best` it returns the state of the best
        validation loss (the current one on a preemption request, so
        ``--resume`` continues it) and rolls back to that state when no
        checkpoint exists."""
        epochs = self.epochs if epochs is None else epochs
        arrays = [np.nan_to_num(np.asarray(a, np.float32), nan=0.0) for a in arrays]
        n = arrays[0].shape[0]
        n_val = int(n * val_split)
        perm = np.random.default_rng(seed).permutation(n)
        tr, va = perm[: n - n_val], perm[n - n_val:]
        if n_val == 0:
            va = tr

        def on_device(rows):
            return [torch.from_numpy(np.ascontiguousarray(a[rows])).to(self.device)
                    for a in arrays]

        train, val_data = on_device(tr), on_device(va)
        state = self.init_state(seed) if state is None else state
        if state.rng is not None:
            self.load_rng_state(state.rng)

        def save(s: LCTrainState, force: bool = False) -> None:
            if ckpt_manager is not None:
                s.rng = self.rng_state()
                ckpt_manager.maybe_save(s, int(state.epoch), force=force)

        history: Dict[str, list] = {}
        val = dict.fromkeys(self.EVAL_METRICS, 0.0)
        val["loss"] = float("inf")
        best_val, best_state, preempted = float("inf"), state, False
        base_epoch = int(state.epoch)
        epoch, nan_retries, nan_fail_epoch = 0, 0, -1
        while epoch < epochs:
            t0 = time.perf_counter()
            state, metrics = self.train_epoch(state, *train)
            metrics = self._read_back(metrics)

            if nan_guard and not np.isfinite(metrics["loss"]):
                # the best state is finite (a NaN validation loss never wins)
                nan_fail_epoch = max(nan_fail_epoch, epoch)
                state, epoch, history = rollback(
                    state, epoch, base_epoch, history, ckpt_manager, nan_retries,
                    nan_guard_max_retries, stage=self.stage,
                    fallback_state=self._snapshot(best_state) if self.track_best else None)
                nan_retries += 1
                continue
            if nan_retries and epoch > nan_fail_epoch:
                nan_retries = 0  # past the epoch that diverged: a new budget

            if epoch % val_every == 0 or epoch == epochs - 1:
                val = self._read_back(self.eval_epoch(state, *val_data))
                ratio = val["loss"] / max(metrics["loss"], 1e-8)
                if ratio > overfit_threshold:
                    print(f"Severe overfitting detected! Val/Train ratio: "
                          f"{ratio:.1f}; stopping at epoch {epoch}")
                    break

            metrics.update({f"val_{k}": v for k, v in val.items()})
            metrics["epoch_time"] = time.perf_counter() - t0
            if self.track_best and metrics["val_loss"] < best_val:
                best_val, best_state = metrics["val_loss"], self._snapshot(state)
            for k, v in metrics.items():
                history.setdefault(k, []).append(v)
            if log_fn is not None:
                log_fn(epoch, metrics)
            save(state)
            if preemption.requested():
                preempted = True
                break  # cooperative stop: the forced save below, then return
            epoch += 1

        final = best_state if self.track_best and not preempted else state
        save(final, force=True)
        if ckpt_manager is not None:
            ckpt_manager.wait()
        final.rng = self.rng_state()
        return final, {k: np.asarray(v) for k, v in history.items()}

    # -- inference -----------------------------------------------------------

    def predict_fn(self, state: LCTrainState):
        """Deterministic forward (eval mode, ``W / sigma`` from the stored
        ``u``): inputs ``[n, features]`` -> ``(y1, y2)`` tensors on the
        trainer's device."""
        model = forward_model(state, self.sn_filter, update=False)

        @torch.no_grad()
        def fn(x):
            return model(torch.as_tensor(x, dtype=torch.float32, device=self.device))

        return fn
