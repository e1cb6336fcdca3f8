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
``readout_bwd`` picks that op's backward (``"auto"``, ``"fused"``: dy never
written, ``"materialize"``).

The optimizer stack follows the config (``config.resolve_perf_stack``):
``opt_state_dtype="bfloat16"`` keeps the AdamW moments in bf16 with stochastic
rounding, ``sn_cadence="epoch"`` runs the power iteration once at the epoch
boundary and reuses its sigmas in every step (``train_step``, the streaming
step, keeps the per-step iteration). ``remat=True`` checkpoints the residual
blocks.

:meth:`VAETrainer.fit` runs spans of epochs between host-visible boundaries
(validation epochs, checkpoint epochs, the last) without reading a metric
back: per-epoch metrics stay on the device and are read once per span. At
each boundary it checks the loss (a non-finite one rolls back to the last
checkpoint, ``train.nan_guard``), saves through ``utils.checkpoint`` and polls
``utils.preemption``. ``stream=True`` keeps the dataset on the host and
streams batches through pinned memory (:meth:`train_epoch_streaming`).

Not ported yet: the device mesh, and CUDA graphs over an epoch's steps.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

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
    spectral_normalize,
)
from simulgen_vae_tpu_torch.models.vae import VAE
from simulgen_vae_tpu_torch.ops.gather_augment import draw_augment_scalars, gather_augment
from simulgen_vae_tpu_torch.ops.readout_chain import BWD_FLAVORS
from simulgen_vae_tpu_torch.train.nan_guard import rollback
from simulgen_vae_tpu_torch.train.optim import FusedAdamW
from simulgen_vae_tpu_torch.train.schedules import cosine_warm_restarts
from simulgen_vae_tpu_torch.utils import preemption

STEP_METRICS = ("loss", "recon", "kl", "recon_mse", "grad_norm")
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class VAETrainState:
    model: VAE        # f32 master parameters
    opt_state: dict   # FusedAdamW: count, mu, nu (keyed by parameter name)
    sn_u: dict        # power-iteration vectors (keyed by kernel name)
    epoch: int = 0
    rng: Optional[dict] = None  # the trainer's generator states at the last save


class VAETrainer:
    def __init__(self, cfg: VAEConfig, aug: AugmentationConfig = AugmentationConfig(),
                 device=None, seed: int = 0, fused_readout: Optional[bool] = None,
                 readout_bwd: str = "auto"):
        stack = resolve_perf_stack(cfg)
        if readout_bwd != "auto" and readout_bwd not in BWD_FLAVORS:
            raise ValueError(f"readout_bwd must be 'auto', 'fused' or 'materialize', "
                             f"got {readout_bwd!r}")
        self.cfg, self.aug = cfg, aug
        self.device = resolve_device(device)
        self.dtype = _DTYPES[cfg.dtype]
        self.use_sn = cfg.use_spectral_norm
        self.sn_per_epoch = stack["sn_per_epoch"]
        self.fused_readout = bool(fused_readout)  # None: off
        self.readout_bwd = readout_bwd
        self.opt = FusedAdamW(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01,
                              moment_dtype=stack["moment_dtype"] or None,
                              nu_dtype=stack["nu_dtype"] or "same",
                              stochastic_round=stack["stochastic_round"])
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.generator = torch.Generator(self.device).manual_seed(seed)
        self._pinned: Dict[tuple, list] = {}  # streaming's host staging buffers

    # -- state ---------------------------------------------------------------

    def build_model(self) -> VAE:
        """The VAE with f32 parameters computing in the configured dtype."""
        cfg = self.cfg
        model = VAE(cfg.latent_dim_end, cfg.latent_dim, cfg.num_filter_dec, cfg.num_node,
                    cfg.num_time, cfg.small, self.device, torch.float32,
                    num_filter_enc=cfg.num_filter_enc, lossfun=cfg.loss_type,
                    remat=cfg.remat)
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

    def rng_state(self) -> dict:
        """The host and device generators' states (what a checkpoint keeps so
        that a resumed run draws what the uninterrupted one would)."""
        return {"numpy": self.rng.bit_generator.state,
                "torch": self.generator.get_state().clone()}

    def load_rng_state(self, rng: dict) -> None:
        self.rng.bit_generator.state = rng["numpy"]
        self.generator.set_state(rng["torch"].cpu())

    # -- loss ----------------------------------------------------------------

    def _sn_dtype(self):
        """bf16 runs power-iterate in bf16, as the JAX trainer does."""
        return torch.bfloat16 if self.dtype == torch.bfloat16 else None

    def loss_fn(self, model: VAE, batch: torch.Tensor, beta: float,
                generator: Optional[torch.Generator] = None):
        """``(loss, metrics)``: loss = alpha * recon + beta * sum(KL terms)."""
        _, recon, kls, recon_mse = model(batch, generator or self.generator,
                                         fused_readout_loss=self.fused_readout,
                                         readout_bwd=self.readout_bwd)
        kl_sum = sum(kls)
        alpha = self.cfg.alpha
        loss = alpha * recon + beta * kl_sum
        metrics = {"loss": loss.detach(), "recon": alpha * recon.detach(),
                   "kl": kl_sum.detach(), "recon_mse": alpha * recon_mse.detach()}
        return loss, metrics

    def loss_and_grads(self, state: VAETrainState, batch: torch.Tensor, beta: float,
                       generator: Optional[torch.Generator] = None, precomputed=None):
        """``(metrics, new_u, grads)`` for one batch: grads keyed by parameter
        name, with sigma's rank-1 terms added; parameters the loss does not
        reach get zeros, as under JAX's autodiff. ``precomputed=(inv_sigmas,
        factors)`` skips the power iteration and reuses the caller's sigmas
        (the per-epoch cadence); ``new_u`` is then ``state.sn_u`` unchanged."""
        model = state.model
        for p in model.parameters():
            p.grad = None
        new_u, leaves, factors = state.sn_u, {}, {}
        if self.use_sn:
            if precomputed is not None:
                inv, factors = precomputed
            else:
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
               lr: float, precomputed=None) -> Dict[str, torch.Tensor]:
        metrics, state.sn_u, grads = self.loss_and_grads(state, batch, beta,
                                                         precomputed=precomputed)
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
        # Per-epoch cadence: one power iteration at the epoch boundary, its
        # sigmas and rank-1 factors reused by every step.
        sn_pre = None
        if self.use_sn and self.sn_per_epoch:
            inv, state.sn_u, factors = compute_sigmas(state.model, state.sn_u, update=True,
                                                      compute_dtype=self._sn_dtype(),
                                                      with_grad_factors=True)
            sn_pre = (inv, factors)
        steps = [self._apply(state, self.assemble_batch(data, idx), beta, lr, sn_pre)
                 for idx in perm]
        state.epoch += 1
        return state, self._epoch_metrics(steps, beta, lr)

    @staticmethod
    def _epoch_metrics(steps: List[Dict[str, torch.Tensor]], beta: float, lr: float):
        """Step means as 0-d device tensors (no host sync), plus beta and lr."""
        mean = torch.stack([torch.stack([m[k].float() for k in STEP_METRICS])
                            for m in steps]).mean(dim=0)
        metrics = {k: mean[i] for i, k in enumerate(STEP_METRICS)}
        metrics.update(beta=beta, lr=lr)
        return metrics

    def train_step(self, state: VAETrainState, batch: torch.Tensor,
                   partner: torch.Tensor):
        """One step on a given batch and mixup partner (the plain
        augmentation), as the JAX streaming step: the power iteration runs in
        every step whatever the cadence; the epoch does not advance."""
        beta, lr = self._schedules(state.epoch)
        batch = augment_batch(batch, partner, self.aug, self.generator)
        metrics = self._apply(state, batch, beta, lr)
        metrics.update(beta=beta, lr=lr)
        return state, metrics

    # -- streaming -----------------------------------------------------------

    def _staging(self, shape, dtype, slots: int) -> list:
        """Reusable host buffers for streamed batches: pinned when the trainer
        is on a card."""
        key = (tuple(shape), dtype, slots)
        if key not in self._pinned:
            self._pinned = {key: [torch.empty(shape, dtype=dtype,
                                              pin_memory=self.device.type == "cuda")
                                  for _ in range(slots)]}
        return self._pinned[key]

    def train_epoch_streaming(self, state: VAETrainState, data,
                              partner_mode: str = "dataset",
                              max_steps: Optional[int] = None):
        """One epoch over host-resident ``data`` [N, T, nodes] (a numpy array,
        or a CPU tensor where the dtype is one numpy lacks), streaming batches.

        ``n // batch`` batches of a fresh permutation (no wrap-pad, as the JAX
        method). Each batch is gathered on the host into a pinned buffer and
        copied to the card on a side stream, so the gather and copy of batch
        i + 1 overlap step i; the host waits for step i - 1 before it stages
        batch i + 1, so at most one batch is in flight beyond the current one.
        ``partner_mode``: ``"dataset"`` draws the mixup partners from the whole
        host dataset (a second batch copied per step), ``"batch"`` takes the
        current batch rolled by one sample. ``max_steps`` truncates the epoch.
        The host gather stands in for the JAX package's native loader. Returns
        ``(state, metrics)`` as :meth:`train_epoch`."""
        if partner_mode not in ("dataset", "batch"):
            raise ValueError(f"partner_mode must be 'dataset' or 'batch', got {partner_mode!r}")
        host = torch.from_numpy(data) if isinstance(data, np.ndarray) else data
        if host.device.type != "cpu" or host.dim() != 3:
            raise ValueError("streaming takes a host-resident [N, T, nodes] array")
        n = host.shape[0]
        bsz = min(self.cfg.batch_size, n)
        num_batches = max(n // bsz, 1)
        perm = self.rng.permutation(n)[: num_batches * bsz].reshape(num_batches, bsz)
        steps = num_batches if max_steps is None else min(max_steps, num_batches)
        on_card = self.device.type == "cuda"
        per_step = 2 if partner_mode == "dataset" else 1
        staging = self._staging((bsz, *host.shape[1:]), host.dtype, 2 * per_step)
        side = torch.cuda.Stream(self.device) if on_card else None

        def to_device(idx: np.ndarray, buf: torch.Tensor) -> torch.Tensor:
            torch.index_select(host, 0, torch.from_numpy(idx.astype(np.int64)), out=buf)
            if not on_card:
                return buf.to(self.dtype, copy=True)
            with torch.cuda.stream(side):
                return buf.to(self.device, non_blocking=True).to(self.dtype)

        def fetch(i: int):
            """Stage batch i (and its partners): host gather, then the copy."""
            bufs = staging[(i % 2) * per_step:(i % 2 + 1) * per_step]
            batch = to_device(perm[i], bufs[0])
            partner = (to_device(self.rng.integers(0, n, size=bsz), bufs[1])
                       if partner_mode == "dataset" else None)
            ready = side.record_event() if on_card else None
            return batch, partner, ready

        metrics, done = [], []
        nxt = fetch(0)
        for i in range(steps):
            batch, partner, ready = nxt
            if on_card:
                main = torch.cuda.current_stream(self.device)
                main.wait_event(ready)
                for t in (batch, partner):
                    if t is not None:
                        t.record_stream(main)
            if partner is None:
                partner = batch.roll(1, dims=0)
            state, m = self.train_step(state, batch, partner)
            metrics.append(m)
            if on_card:
                done.append(torch.cuda.current_stream(self.device).record_event())
                if i >= 1:
                    done[i - 1].synchronize()  # step i - 1 is over: its buffers are free
            if i + 1 < steps:
                nxt = fetch(i + 1)
        if on_card:
            side.synchronize()  # every copy out of the staging buffers is over
        state.epoch += 1
        return state, self._epoch_metrics(metrics, metrics[0]["beta"], metrics[0]["lr"])

    # -- evaluation ----------------------------------------------------------

    @torch.no_grad()
    def eval_epoch(self, state: VAETrainState, data: torch.Tensor):
        """Mean loss metrics over ``data`` in wrap-padded batches, with the
        stored ``u`` (no power-iteration update) and no augmentation. The
        reparameterisation noise comes from a generator of its own, seeded by
        the trainer's seed and the epoch: validating draws nothing from the
        training streams."""
        self._check_data(data)
        n = data.shape[0]
        bsz = min(self.cfg.batch_size, n)
        num_batches = max(-(-n // bsz), 1)
        beta, _ = self._schedules(state.epoch)
        idx = torch.arange(num_batches * bsz, device=data.device) % n
        gen = torch.Generator(self.device).manual_seed(self.seed * 1000003 + state.epoch)
        inv = {}
        if self.use_sn:
            inv, _ = compute_sigmas(state.model, state.sn_u, update=False,
                                    compute_dtype=self._sn_dtype())
        total = None
        with attach_inv_sigmas(state.model, inv):
            for rows in idx.reshape(num_batches, bsz):
                _, m = self.loss_fn(state.model, data.index_select(0, rows), beta, gen)
                vals = torch.stack([m[k].float() for k in STEP_METRICS[:-1]])
                total = vals if total is None else total + vals
        mean = total / num_batches
        return {k: mean[i] for i, k in enumerate(STEP_METRICS[:-1])}

    @torch.no_grad()
    def eval_params(self, state: VAETrainState) -> VAE:
        """A copy of the model whose spectrally normalised kernels are divided
        by their sigma (stored ``u``, no update): the parameters to serve
        with, as the JAX ``eval_params``."""
        model = self.build_model()
        model.load_state_dict(state.model.state_dict())
        if self.use_sn:
            normed, _ = spectral_normalize(state.model, state.sn_u, update=False,
                                           compute_dtype=self._sn_dtype())
            params = dict(model.named_parameters())
            for name, w in normed.items():
                params[name].copy_(w)
        return model

    # -- fit -----------------------------------------------------------------

    @staticmethod
    def _read_back(per_epoch: List[Dict]) -> Dict[str, np.ndarray]:
        """A span's per-epoch metrics from the device, as ``{name: [span]}``:
        the span's one host sync."""
        on_device = [k for k, v in per_epoch[0].items() if torch.is_tensor(v)]
        vals = torch.stack([torch.stack([m[k].float() for k in on_device])
                            for m in per_epoch]).cpu().numpy().astype(np.float64)
        out = {k: vals[:, i] for i, k in enumerate(on_device)}
        for k in per_epoch[0]:
            if k not in out:
                out[k] = np.asarray([m[k] for m in per_epoch], dtype=np.float64)
        return out

    def fit(self, data, seed: int = 0, state: Optional[VAETrainState] = None,
            val_split: float = 0.2, val_every: int = 20,
            log_fn: Optional[Callable[[int, Dict], None]] = None,
            epochs: Optional[int] = None, stream: bool = False, ckpt_manager=None,
            nan_guard: bool = True, nan_guard_max_retries: int = 2):
        """Train on ``data`` [P, T, N] (numpy or tensor) with an 80/20 split,
        validating every ``val_every`` epochs and after the last. Returns
        ``(state, history)``, history holding per-epoch numpy arrays.

        Epochs between host-visible boundaries (validation epochs, the epochs
        ``ckpt_manager`` saves at, the last) run as one span whose metrics are
        read back once. ``nan_guard`` checks the span's train losses there: a
        non-finite one rolls the run back to the last checkpoint and retries
        the span with the randomness that follows, at most
        ``nan_guard_max_retries`` times in one place; without a checkpoint it
        raises; a poisoned state is never saved. ``stream=True`` keeps the
        dataset on the host (:meth:`train_epoch_streaming`) and validates on a
        device-sized subset. A preemption request (``utils.preemption``) stops
        the run after the current span with a forced save; ``fit(state=...)``
        on the restored state continues from that epoch with the generators'
        saved states."""
        cfg = self.cfg
        epochs = cfg.n_epochs if epochs is None else epochs
        n = data.shape[0]
        n_val = int(n * val_split)
        perm = np.random.default_rng(seed).permutation(n)
        train_idx, val_idx = perm[: n - n_val], perm[n - n_val:]
        if stream:
            host = torch.from_numpy(data) if isinstance(data, np.ndarray) else data.cpu()
            data_train = host.index_select(0, torch.from_numpy(train_idx))
            val_cap = max(cfg.batch_size, min(n_val, 4 * cfg.batch_size))
            val_rows = (host.index_select(0, torch.from_numpy(val_idx)) if n_val
                        else data_train)[:val_cap]
            data_val = val_rows.to(self.device, self.dtype)
        else:
            data = torch.as_tensor(data).to(self.device, self.dtype)
            data_train = data.index_select(0, torch.as_tensor(train_idx, device=self.device))
            data_val = (data.index_select(0, torch.as_tensor(val_idx, device=self.device))
                        if n_val else data_train)
        state = self.init_state(seed) if state is None else state
        if state.rng is not None:
            self.load_rng_state(state.rng)

        history: Dict[str, list] = {}
        val = {"loss": 0.0, "recon": 0.0}
        base_epoch = int(state.epoch)

        def need_host_state(e: int) -> bool:
            if e % val_every == 0 or e == epochs - 1:
                return True
            return (ckpt_manager is not None
                    and (base_epoch + e + 1) % ckpt_manager.save_interval == 0)

        def save(force: bool = False) -> None:
            if ckpt_manager is not None:
                state.rng = self.rng_state()
                ckpt_manager.maybe_save(state, int(state.epoch), force=force)

        epoch, nan_retries, nan_fail_epoch = 0, 0, -1
        while epoch < epochs:
            t0 = time.perf_counter()
            end = epoch
            while end < epochs - 1 and not need_host_state(end):
                end += 1
            span = end - epoch + 1
            per_epoch = []
            for _ in range(span):
                if stream:
                    state, metrics = self.train_epoch_streaming(state, data_train)
                else:
                    state, metrics = self.train_epoch(state, data_train)
                per_epoch.append(metrics)
            stacked = self._read_back(per_epoch)

            if nan_guard and not np.isfinite(stacked["loss"]).all():
                nan_fail_epoch = max(nan_fail_epoch, epoch + span - 1)
                state, epoch, history = rollback(
                    state, epoch, base_epoch, history, ckpt_manager, nan_retries,
                    nan_guard_max_retries, stage="vae")
                nan_retries += 1
                continue
            if nan_retries and epoch + span - 1 > nan_fail_epoch:
                nan_retries = 0  # past the epoch that diverged: a new budget

            last = epoch + span - 1
            if last % val_every == 0 or last == epochs - 1:
                val = {k: float(v) for k, v in self.eval_epoch(state, data_val).items()}
            per_epoch_time = (time.perf_counter() - t0) / span
            for j in range(span):
                m = {k: float(v[j]) for k, v in stacked.items()}
                m.update(val_loss=val["loss"], val_recon=val["recon"],
                         epoch_time=per_epoch_time)
                for k, v in m.items():
                    history.setdefault(k, []).append(v)
                if log_fn is not None:
                    log_fn(epoch + j, m)
            save()
            epoch += span
            if preemption.requested():
                break  # cooperative stop: the forced save below, then return

        save(force=True)
        if ckpt_manager is not None:
            ckpt_manager.wait()
        state.rng = self.rng_state()
        return state, {k: np.asarray(v) for k, v in history.items()}
