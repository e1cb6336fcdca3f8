"""VAE trainer on one card (``simulgen_vae_tpu/train/vae_trainer.py``).

One step: draw the mixup partners and the per-sample augmentation scalars on
the host, assemble the batch on the card (``ops.gather_augment``: gather,
noise, amplitude, mixup in one pass), run one spectral-norm power iteration,
the forward and the ELBO, the backward (GroupNorm through its kernels), add
sigma's rank-1 gradient terms, and apply AdamW. Epochs take
``ceil(n / batch)`` batches of a fresh permutation, the last one wrap-padded,
so every sample trains once per epoch. KL warm-up beta and the cosine
warm-restart learning rate are functions of the epoch.

Host randomness (permutation, partners, augmentation scalars, kernel seeds)
comes from a numpy ``Generator`` and reaches the card through pinned memory
without a sync; device randomness (reparameterisation, the plain
augmentation) from a ``torch.Generator`` on the card. Metrics stay on the
device as 0-d tensors: a step never waits for the card, and an epoch's
metrics are read once, by the caller.

State is updated in place: the model's f32 master parameters, the AdamW
moments and the power-iteration vectors are overwritten by each step
(PyTorch has no donation; overwriting saves a copy of each).

``fused_readout=True`` (opt-in, as in the JAX trainer) takes the
reconstruction losses from the fused readout kernels
(``ops.readout_chain``): the readout map is written once and read once in the
forward and ``x_hat`` is never written; the readout's ``inv_sigma`` gradient
comes back from the op and feeds the rank-1 term as every other layer's does.

Not ported yet: checkpointing, preemption, the NaN-rollback guard, streaming
from the host, the device mesh, multi-epoch dispatch, the bf16 optimizer
moments with stochastic rounding and the per-epoch spectral-norm cadence.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from simulgen_vae_tpu_torch.config import VAEConfig, resolve_perf_stack
from simulgen_vae_tpu_torch.data.augmentation import AugmentationConfig, augment_batch
from simulgen_vae_tpu_torch.generate import resolve_device
from simulgen_vae_tpu_torch.losses import beta_schedule
from simulgen_vae_tpu_torch.models.blocks import set_compute_dtype
from simulgen_vae_tpu_torch.models.spectral_norm import (
    add_sigma_rank1_grads,
    attach_inv_sigmas,
    compute_sigmas,
    init_sn_state,
)
from simulgen_vae_tpu_torch.models.vae import VAE
from simulgen_vae_tpu_torch.ops.gather_augment import draw_augment_scalars, gather_augment
from simulgen_vae_tpu_torch.train.optim import FusedAdamW
from simulgen_vae_tpu_torch.train.schedules import cosine_warm_restarts

STEP_METRICS = ("loss", "recon", "kl", "recon_mse", "grad_norm")
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class VAETrainState:
    model: VAE        # f32 master parameters
    opt_state: dict   # FusedAdamW: count, mu, nu (keyed by parameter name)
    sn_u: dict        # power-iteration vectors (keyed by kernel name)
    epoch: int = 0


class VAETrainer:
    def __init__(self, cfg: VAEConfig, aug: AugmentationConfig = AugmentationConfig(),
                 device=None, seed: int = 0, fused_readout: Optional[bool] = None):
        if cfg.remat:
            raise NotImplementedError("remat (gradient checkpointing) is not ported")
        resolve_perf_stack(cfg)  # raises for the TPU-only stack
        self.cfg, self.aug = cfg, aug
        self.device = resolve_device(device)
        self.dtype = _DTYPES[cfg.dtype]
        self.use_sn = cfg.use_spectral_norm
        self.fused_readout = bool(fused_readout)  # None: off
        self.opt = FusedAdamW(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01)
        self.rng = np.random.default_rng(seed)
        self.generator = torch.Generator(self.device).manual_seed(seed)

    # -- state ---------------------------------------------------------------

    def build_model(self) -> VAE:
        """The VAE with f32 parameters computing in the configured dtype."""
        cfg = self.cfg
        model = VAE(cfg.latent_dim_end, cfg.latent_dim, cfg.num_filter_dec, cfg.num_node,
                    cfg.num_time, cfg.small, self.device, torch.float32,
                    num_filter_enc=cfg.num_filter_enc, lossfun=cfg.loss_type)
        return set_compute_dtype(model, self.dtype)

    def init_state(self, seed: int = 0) -> VAETrainState:
        """He-uniform kernels, zero biases, unit norm scales (the JAX init's
        distributions), unit ``u`` vectors, zero moments; all from ``seed``."""
        devices = [self.device.index or 0] if self.device.type == "cuda" else []
        with torch.random.fork_rng(devices=devices):
            torch.manual_seed(seed)
            model = self.build_model()
        gen = torch.Generator(self.device).manual_seed(seed)
        sn_u = init_sn_state(model, gen) if self.use_sn else {}
        return VAETrainState(model, self.opt.init(dict(model.named_parameters())), sn_u)

    # -- loss ----------------------------------------------------------------

    def _sn_dtype(self):
        """bf16 runs power-iterate in bf16, as the JAX trainer does."""
        return torch.bfloat16 if self.dtype == torch.bfloat16 else None

    def loss_fn(self, model: VAE, batch: torch.Tensor, beta: float,
                generator: Optional[torch.Generator] = None):
        """``(loss, metrics)``: loss = alpha * recon + beta * sum(KL terms)."""
        _, recon, kls, recon_mse = model(batch, generator or self.generator,
                                         fused_readout_loss=self.fused_readout)
        kl_sum = sum(kls)
        alpha = self.cfg.alpha
        loss = alpha * recon + beta * kl_sum
        metrics = {"loss": loss.detach(), "recon": alpha * recon.detach(),
                   "kl": kl_sum.detach(), "recon_mse": alpha * recon_mse.detach()}
        return loss, metrics

    def loss_and_grads(self, state: VAETrainState, batch: torch.Tensor, beta: float,
                       generator: Optional[torch.Generator] = None):
        """``(metrics, new_u, grads)`` for one batch: grads keyed by parameter
        name, with sigma's rank-1 terms added; parameters the loss does not
        reach get zeros, as under JAX's autodiff."""
        model = state.model
        for p in model.parameters():
            p.grad = None
        new_u, leaves, factors = state.sn_u, {}, {}
        if self.use_sn:
            inv, new_u, factors = compute_sigmas(model, state.sn_u, update=True,
                                                 compute_dtype=self._sn_dtype(),
                                                 with_grad_factors=True)
            leaves = {k: v.detach().requires_grad_() for k, v in inv.items()}
        with attach_inv_sigmas(model, leaves):
            loss, metrics = self.loss_fn(model, batch, beta, generator)
            loss.backward()
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in model.named_parameters()}
        if self.use_sn:
            add_sigma_rank1_grads(grads, {k: v.grad for k, v in leaves.items()}, factors)
        return metrics, new_u, grads

    def _apply(self, state: VAETrainState, batch: torch.Tensor, beta: float,
               lr: float) -> Dict[str, torch.Tensor]:
        metrics, state.sn_u, grads = self.loss_and_grads(state, batch, beta)
        params = dict(state.model.named_parameters())
        metrics["grad_norm"] = self.opt.apply(grads, state.opt_state, params, lr)
        return metrics

    # -- batches -------------------------------------------------------------

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def assemble_batch(self, data: torch.Tensor, idx: np.ndarray) -> torch.Tensor:
        """Rows ``idx`` of ``data``, augmented against random partner rows."""
        n, bsz = data.shape[0], len(idx)
        pidx = self.rng.integers(0, n, bsz)
        if self.aug.fusable:
            a = self.aug
            scalars = draw_augment_scalars(
                self.rng, bsz, noise_prob=a.noise_prob, noise_level=a.noise_level,
                scaling_prob=a.scaling_prob, scaling_range=a.scaling_range,
                mixup_prob=a.mixup_prob, mixup_alpha=a.mixup_alpha)
            seed = int(self.rng.integers(0, 2 ** 31 - 1))
            return gather_augment(
                data, self._to_device(idx.astype(np.int32)),
                self._to_device(pidx.astype(np.int32)), seed,
                *(self._to_device(v) for v in scalars), generator=self.generator)
        batch = data.index_select(0, self._to_device(idx.astype(np.int64)))
        partner = data.index_select(0, self._to_device(pidx.astype(np.int64)))
        return augment_batch(batch, partner, self.aug, self.generator)

    def _schedules(self, epoch: int):
        cfg = self.cfg
        beta = beta_schedule(epoch, cfg.n_epochs)
        lr = cosine_warm_restarts(epoch, cfg.lr, t_0=max(cfg.n_epochs // 4, 1),
                                  t_mult=2, eta_min=cfg.lr * 1e-4)
        return beta, lr

    def _check_data(self, data: torch.Tensor) -> None:
        if data.device.type != self.device.type:
            raise ValueError(f"data is on {data.device}, the trainer on {self.device}")
        if data.dim() != 3 or not data.is_contiguous():
            raise ValueError(f"data must be a contiguous [n, T, N] tensor, got "
                             f"{tuple(data.shape)}")

    # -- epochs --------------------------------------------------------------

    def train_epoch(self, state: VAETrainState, data: torch.Tensor,
                    max_steps: Optional[int] = None):
        """One epoch over ``data`` [n, T, N] (on the trainer's device, in the
        compute dtype); ``max_steps`` cuts it short. Returns ``(state,
        metrics)``: step means as 0-d device tensors, plus ``beta`` and ``lr``."""
        self._check_data(data)
        n = data.shape[0]
        bsz = min(self.cfg.batch_size, n)
        num_batches = max(-(-n // bsz), 1)
        pad = num_batches * bsz - n
        beta, lr = self._schedules(state.epoch)
        perm = self.rng.permutation(n)
        if pad:
            perm = np.concatenate([perm, perm[:pad]])
        perm = perm.reshape(num_batches, bsz)
        if max_steps is not None:
            perm = perm[:max_steps]
        total = None
        for idx in perm:
            m = self._apply(state, self.assemble_batch(data, idx), beta, lr)
            vals = torch.stack([m[k].float() for k in STEP_METRICS])
            total = vals if total is None else total + vals
        mean = total / len(perm)
        metrics = {k: mean[i] for i, k in enumerate(STEP_METRICS)}
        metrics.update(beta=beta, lr=lr)
        state.epoch += 1
        return state, metrics

    def train_step(self, state: VAETrainState, batch: torch.Tensor,
                   partner: torch.Tensor):
        """One step on a given batch and mixup partner (the plain
        augmentation), as the JAX streaming step; the epoch does not advance."""
        beta, lr = self._schedules(state.epoch)
        batch = augment_batch(batch, partner, self.aug, self.generator)
        metrics = self._apply(state, batch, beta, lr)
        metrics.update(beta=beta, lr=lr)
        return state, metrics

    @torch.no_grad()
    def eval_epoch(self, state: VAETrainState, data: torch.Tensor):
        """Mean loss metrics over ``data`` in wrap-padded batches, with the
        stored ``u`` (no power-iteration update) and no augmentation."""
        self._check_data(data)
        n = data.shape[0]
        bsz = min(self.cfg.batch_size, n)
        num_batches = max(-(-n // bsz), 1)
        beta, _ = self._schedules(state.epoch)
        idx = torch.arange(num_batches * bsz, device=data.device) % n
        inv = {}
        if self.use_sn:
            inv, _ = compute_sigmas(state.model, state.sn_u, update=False,
                                    compute_dtype=self._sn_dtype())
        total = None
        with attach_inv_sigmas(state.model, inv):
            for rows in idx.reshape(num_batches, bsz):
                _, m = self.loss_fn(state.model, data.index_select(0, rows), beta)
                vals = torch.stack([m[k].float() for k in STEP_METRICS[:-1]])
                total = vals if total is None else total + vals
        mean = total / num_batches
        return {k: mean[i] for i, k in enumerate(STEP_METRICS[:-1])}

    def fit(self, data, seed: int = 0, state: Optional[VAETrainState] = None,
            val_split: float = 0.2, val_every: int = 20,
            log_fn: Optional[Callable[[int, Dict], None]] = None,
            epochs: Optional[int] = None):
        """Train on ``data`` [P, T, N] (numpy or tensor) with an 80/20 split,
        validating every ``val_every`` epochs and after the last. Returns
        ``(state, history)``, history holding per-epoch numpy arrays."""
        epochs = self.cfg.n_epochs if epochs is None else epochs
        n = data.shape[0]
        n_val = int(n * val_split)
        perm = np.random.default_rng(seed).permutation(n)
        data = torch.as_tensor(data).to(self.device, self.dtype)
        train_idx = torch.as_tensor(perm[: n - n_val], device=self.device)
        val_idx = torch.as_tensor(perm[n - n_val:], device=self.device)
        data_train = data.index_select(0, train_idx)
        data_val = data.index_select(0, val_idx) if n_val else data_train
        state = self.init_state(seed) if state is None else state

        history: Dict[str, list] = {}
        val = {"loss": 0.0, "recon": 0.0}
        for epoch in range(epochs):
            t0 = time.perf_counter()
            state, metrics = self.train_epoch(state, data_train)
            m = {k: float(v) for k, v in metrics.items()}  # the epoch's one sync
            if epoch % val_every == 0 or epoch == epochs - 1:
                val = {k: float(v) for k, v in self.eval_epoch(state, data_val).items()}
            m.update(val_loss=val["loss"], val_recon=val["recon"],
                     epoch_time=time.perf_counter() - t0)
            for k, v in m.items():
                history.setdefault(k, []).append(v)
            if log_fn is not None:
                log_fn(epoch, m)
        return state, {k: np.asarray(v) for k, v in history.items()}
