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

On a ``('data', 'model')`` mesh (:meth:`VAETrainer.set_mesh`,
``fit(mesh=...)``; ``parallel/``) each rank holds its block of the state
(``parallel.sharding``: the node-sized leaves split over ``model``) and
assembles its block of each batch: its rows over ``data``, its nodes over
``model``, from a resident dataset whose rows are replicated
(``ops.gather_augment.gather_augment_sharded``). Host randomness is drawn
alike on every rank and each keeps its block, and the reparameterisation
noise of the whole batch is drawn and sliced, so every rank's generators
stay in step and, without the kernel's noise, a mesh step equals a
one-device step. The collectives sit at the embedding, the readout input,
the reconstruction loss and the spectral-norm matvecs
(``parallel.collectives``); the gradients and metrics are then averaged over
``data`` and the gradient norm taken over every block. The fused readout is
off on a mesh of more than one rank and streaming is refused there, as in
the JAX trainer's multi-process runs. Checkpoints hold the whole state in
the one-device format (``utils.checkpoint``).

One CUDA graph a step. On one card (no mesh), with the augmentation
``ops.gather_augment`` covers, the power iteration in every step and no
remat (:meth:`VAETrainer.graph_engages`), :meth:`VAETrainer.train_epoch`
runs the whole step (batch assembly, power iteration, forward with its
reparameterisation noise, backward, sigma's rank-1 terms, AdamW and the
gradient norm: :meth:`VAETrainer._step_body`) eagerly once
(``WARMUP_STEPS``), on a side stream, then captures it as a
``torch.cuda.CUDAGraph`` and replays it for every later step. A step then
costs the host its numpy draws, one pinned-to-device copy of its host
values (:class:`StepStage`: the rows, partners, augmentation scalars, noise
seed, beta and AdamW's four step words, read on the card by the kernels and
the loss), one graph launch and the copy of its metrics into the epoch's
``[steps, 5]`` buffer. The trainer's torch generator is registered with the
graph, so the reparameterisation noise advances through the same Philox
offsets as eager draws. The graph is keyed on what the step reads (the
dataset, the batch size, the readout route, the addresses of the
parameters, moments and power-iteration vectors) and captured again when
any of it changes or the generators' states are loaded. Everything else
(the CPU, a mesh, shift or cutout augmentation, the per-epoch cadence,
remat, :meth:`VAETrainer.train_epoch_streaming`, :meth:`VAETrainer.train_step`)
runs the eager step: :meth:`VAETrainer.assemble_batch`, whose five host
vectors and seed also go over in one copy, then :meth:`VAETrainer._apply`.

Each epoch, step and phase of a step is a span of ``utils.profiling``
(``train.epoch``, ``train.step``, ``train.assemble``, ``train.fetch``,
``train.sn``, ``train.forward``, ``train.backward``, ``train.optimizer``),
recorded only inside ``profiling.recording()``; ``train.steps`` counts the
steps recorded. On the graph path a step holds ``train.capture`` or
``train.replay`` instead of the phases, which the eager steps (the warm-up
among them) keep; ``COUNTERS`` counts captures and replays, always.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from simulgen_vae_tpu_torch.config import VAEConfig, resolve_perf_stack
from simulgen_vae_tpu_torch.data.augmentation import AugmentationConfig, augment_batch
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
from simulgen_vae_tpu_torch.ops.gather_augment import (
    dataset_replicated_rows,
    draw_augment_scalars,
    gather_augment,
    gather_augment_sharded,
    rank_seed,
    seed_word,
)
from simulgen_vae_tpu_torch.ops.readout_chain import BWD_FLAVORS
from simulgen_vae_tpu_torch.parallel import collectives, sharding
from simulgen_vae_tpu_torch.train.nan_guard import rollback
from simulgen_vae_tpu_torch.train.optim import FusedAdamW
from simulgen_vae_tpu_torch.train.schedules import cosine_warm_restarts
from simulgen_vae_tpu_torch.utils import preemption, profiling, resolve_device
from simulgen_vae_tpu_torch.utils.profiling import span, tick
from simulgen_vae_tpu_torch.utils.staging import Staging

STEP_METRICS = ("loss", "recon", "kl", "recon_mse", "grad_norm")
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
COUNTERS = profiling.register({"train.graph_captures": 0, "train.graph_replays": 0})
WARMUP_STEPS = 1  # eager steps of a new graph key before its capture


@dataclasses.dataclass
class VAETrainState:
    model: VAE        # f32 master parameters
    opt_state: dict   # FusedAdamW: count, mu, nu (keyed by parameter name)
    sn_u: dict        # power-iteration vectors (keyed by kernel name)
    epoch: int = 0
    rng: Optional[dict] = None  # the trainer's generator states at the last save
    layout: Optional[sharding.Layout] = None  # this rank's block of a mesh's state


class StepStage:
    """One train step's host values on the card: one row of 4-byte words,
    sent with one copy (``utils.staging``) into a static buffer, and the
    views of that buffer the step reads::

        idx, pidx [B] int32 | lam_eff, amp, noise_sd [B] f32 | seed (its bits)
        | beta f32 | lr, c1, c2 f32, dither word (``ops.fused_adamw.step_words``)
    """

    def __init__(self, batch: int, device):
        b = self.batch = batch
        self.staging = Staging(5 * b + 6, device)
        words = self.staging.buffer
        floats = words.view(torch.float32)
        self.idx, self.pidx = words[:b], words[b:2 * b]
        self.lam_eff, self.amp, self.noise_sd = (floats[k * b:(k + 1) * b] for k in (2, 3, 4))
        self.seed = words[5 * b:5 * b + 1]
        self.beta = floats[5 * b + 1]
        self.step = words[5 * b + 2:]

    def send(self, idx, pidx, scalars, seed: int, beta: float = 0.0, step=None) -> None:
        """Packs ``idx``, ``pidx``, ``scalars = (lam_eff, amp, noise_sd)``,
        the noise seed, beta and AdamW's step words (zeros where None) into a
        free pinned row and copies it into the buffer."""
        b = self.batch
        row = self.staging.row()
        floats = row.view(np.float32)
        row[:b], row[b:2 * b] = idx, pidx
        for k, v in enumerate(scalars, start=2):
            floats[k * b:(k + 1) * b] = v
        row[5 * b] = seed_word(seed)
        floats[5 * b + 1] = beta
        row[5 * b + 2:] = 0 if step is None else step
        self.staging.send()


@dataclasses.dataclass
class HostStep:
    """One step of the graph path as :meth:`VAETrainer._apply` takes it: the
    dataset, the step's rows and its host draws (partners, augmentation
    scalars, noise seed), and ``out``, the row of the epoch's ``[steps, 5]``
    metrics the step writes."""

    data: torch.Tensor
    idx: np.ndarray
    pidx: np.ndarray
    scalars: tuple
    seed: int
    out: Optional[torch.Tensor] = None


class StepGraph:
    """The captured train step of one key: its graph (None until captured),
    the static ``[5]`` metrics its replays overwrite, the side stream its
    warm-up and capture run on, and the warm-up steps taken."""

    def __init__(self, key: tuple, device):
        self.key, self.warm = key, 0
        self.graph, self.metrics = None, None
        self.stream = torch.cuda.Stream(device)

    def capture(self, body: Callable[[], torch.Tensor], generator: torch.Generator) -> None:
        """Captures ``body`` on the side stream; the trainer's generator is
        registered so the replays advance it as eager draws would."""
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(generator)
        with torch.cuda.graph(graph, stream=self.stream):
            self.metrics = body()
        self.graph = graph


def gather_rows(host: torch.Tensor, indices: np.ndarray, out: torch.Tensor) -> torch.Tensor:
    """``out[j] = host[indices[j]]`` cast to ``out``'s dtype, row by row into
    the caller's host buffer: each row is read once and written once, on
    torch's threads, with no batch of the source dtype in between (bf16 rounds
    to nearest even, as ``Tensor.to``). Returns ``out``."""
    for j, i in enumerate(np.asarray(indices).tolist()):
        out[j].copy_(host[i])
    return out


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
        self._fused_readout = bool(fused_readout)  # None: off
        self.mesh, self.parts, self.node_group = None, 1, None
        self.readout_bwd = readout_bwd
        self.opt = FusedAdamW(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01,
                              moment_dtype=stack["moment_dtype"] or None,
                              nu_dtype=stack["nu_dtype"] or "same",
                              stochastic_round=stack["stochastic_round"])
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.generator = torch.Generator(self.device).manual_seed(seed)
        self._pinned: Dict[tuple, list] = {}  # streaming's host staging buffers
        self._stages: Dict[int, StepStage] = {}  # a step's host values, by batch size
        self._graph: Optional[StepGraph] = None

    @property
    def fused_readout(self) -> bool:
        """The fused readout route: as asked, and never on a mesh."""
        return self._fused_readout and self.mesh is None

    @fused_readout.setter
    def fused_readout(self, on: bool) -> None:
        self._fused_readout = bool(on)

    # -- mesh ----------------------------------------------------------------

    def set_mesh(self, mesh) -> None:
        """Train on ``mesh`` (``parallel.make_mesh``) from now on; a mesh of
        one rank is one device. Announces, once, a node axis that cannot be
        split into whole GroupNorm groups (``parallel.sharding.node_parts``)."""
        if mesh is not None and mesh.size == 1:
            mesh = None
        if mesh is not None and self.aug.enabled and not self.aug.fusable:
            raise NotImplementedError(
                "shift and cutout augmentation run on one device only: a mesh "
                "assembles its batches in ops.gather_augment")
        self.mesh = mesh
        self.parts = sharding.node_parts(mesh, self.cfg.num_node, announce=True)
        self.node_group = mesh.group("model") if self.parts > 1 else None

    def _layout(self, model: VAE) -> Optional[sharding.Layout]:
        if self.mesh is None:
            return None
        split = self.parts > 1
        return sharding.Layout(self.mesh, self.parts,
                               sharding.node_leaves(model) if split else {},
                               sharding.sn_u_leaves(model) if split and self.use_sn else {})

    def _rows(self, bsz: int):
        """``(start, bsz)``: this rank's rows of a batch of ``bsz`` split over
        the data axis; None on one device or where the batch is replicated."""
        if self.mesh is None:
            return None
        d = sharding.batch_parts(self.mesh, bsz)
        return None if d == 1 else (self.mesh.coords["data"] * (bsz // d), bsz)

    def local_batch(self, batch: torch.Tensor):
        """``(block, noise_rows)``: this rank's block of a whole ``[B, T, N]``
        batch and the rows argument of :meth:`loss_and_grads`."""
        return sharding.shard_batch(batch, self.mesh, self.parts), self._rows(batch.shape[0])

    # -- state ---------------------------------------------------------------

    def build_model(self, full: bool = False) -> VAE:
        """The VAE with f32 parameters computing in the configured dtype: this
        rank's block of it on a mesh, the whole model with ``full``."""
        cfg = self.cfg
        parts = 1 if full else self.parts
        model = VAE(cfg.latent_dim_end, cfg.latent_dim, cfg.num_filter_dec,
                    cfg.num_node // parts, cfg.num_time, cfg.small, self.device,
                    torch.float32, num_filter_enc=cfg.num_filter_enc, lossfun=cfg.loss_type,
                    remat=cfg.remat, node_parts=parts,
                    node_group=None if full else self.node_group)
        return set_compute_dtype(model, self.dtype)

    def init_state(self, seed: int = 0) -> VAETrainState:
        """He-uniform kernels, zero biases, unit norm scales (the JAX init's
        distributions), unit ``u`` vectors, zero moments; all from ``seed``.
        On a mesh the whole state is drawn as on one device and this rank
        keeps its block."""
        devices = [self.device.index or 0] if self.device.type == "cuda" else []
        with torch.random.fork_rng(devices=devices):
            torch.manual_seed(seed)
            model = self.build_model(full=True)
        gen = torch.Generator(self.device).manual_seed(seed)
        sn_u = init_sn_state(model, gen) if self.use_sn else {}
        if self.mesh is None:
            return VAETrainState(model, self.opt.init(dict(model.named_parameters())), sn_u)
        state = self.shard_state(VAETrainState(model, {"count": 0, "mu": {}, "nu": {}}, sn_u))
        state.opt_state = self.opt.init(dict(state.model.named_parameters()))
        return state

    def shard_state(self, state: VAETrainState) -> VAETrainState:
        """A whole state as this rank's block of it (a state already split,
        or any state on one device, comes back as it is)."""
        if self.mesh is None or state.layout is not None:
            return state
        local = self.build_model()
        return sharding.shard_state(state, self._layout(local), local)

    def gather_state(self, state: VAETrainState) -> VAETrainState:
        """The whole state from this rank's block (a collective over the
        model axis; every rank gets it), on one device the state itself."""
        if state.layout is None:
            return state
        params, mu, nu, sn_u = sharding.gather_payload(state)
        model = self.build_model(full=True)
        with torch.no_grad():
            for k, p in model.named_parameters():
                p.copy_(params[k])
        opt = dict(state.opt_state, mu=mu, nu=nu)
        return VAETrainState(model, opt, sn_u, state.epoch, state.rng)

    def rng_state(self) -> dict:
        """The host and device generators' states (what a checkpoint keeps so
        that a resumed run draws what the uninterrupted one would)."""
        return {"numpy": self.rng.bit_generator.state,
                "torch": self.generator.get_state().clone()}

    def load_rng_state(self, rng: dict) -> None:
        self.rng.bit_generator.state = rng["numpy"]
        self.generator.set_state(rng["torch"].cpu())
        self._graph = None  # captured against the generator's old state

    # -- loss ----------------------------------------------------------------

    def _sn_dtype(self):
        """bf16 runs power-iterate in bf16, as the JAX trainer does."""
        return torch.bfloat16 if self.dtype == torch.bfloat16 else None

    def loss_fn(self, model: VAE, batch: torch.Tensor, beta: float,
                generator: Optional[torch.Generator] = None, noise_rows=None):
        """``(loss, metrics)``: loss = alpha * recon + beta * sum(KL terms)."""
        _, recon, kls, recon_mse = model(batch, generator or self.generator,
                                         fused_readout_loss=self.fused_readout,
                                         readout_bwd=self.readout_bwd,
                                         noise_rows=noise_rows)
        kl_sum = sum(kls)
        alpha = self.cfg.alpha
        loss = alpha * recon + beta * kl_sum
        metrics = {"loss": loss.detach(), "recon": alpha * recon.detach(),
                   "kl": kl_sum.detach(), "recon_mse": alpha * recon_mse.detach()}
        return loss, metrics

    def loss_and_grads(self, state: VAETrainState, batch: torch.Tensor, beta: float,
                       generator: Optional[torch.Generator] = None, precomputed=None,
                       noise_rows=None):
        """``(metrics, new_u, grads)`` for one batch: grads keyed by parameter
        name, with sigma's rank-1 terms added; parameters the loss does not
        reach get zeros, as under JAX's autodiff. ``precomputed=(inv_sigmas,
        factors)`` skips the power iteration and reuses the caller's sigmas
        (the per-epoch cadence); ``new_u`` is then ``state.sn_u`` unchanged.

        On a mesh ``batch`` is this rank's block and ``noise_rows=(start, B)``
        its rows of the batch where the data axis splits it
        (:meth:`local_batch`); the gradients and metrics that come back are
        then averaged over ``data`` (each rank's loss is its rows' estimate
        of the whole batch's)."""
        model = state.model
        for p in model.parameters():
            p.grad = None
        new_u, leaves, factors = state.sn_u, {}, {}
        if self.use_sn:
            if precomputed is not None:
                inv, factors = precomputed
            else:
                with span("train.sn"):
                    inv, new_u, factors = compute_sigmas(model, state.sn_u, update=True,
                                                         compute_dtype=self._sn_dtype(),
                                                         with_grad_factors=True)
            leaves = {k: v.detach().requires_grad_() for k, v in inv.items()}
        with attach_inv_sigmas(model, leaves):
            with span("train.forward"):
                loss, metrics = self.loss_fn(model, batch, beta, generator, noise_rows)
            with span("train.backward"):
                loss.backward()
                grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                         for k, p in model.named_parameters()}
        if self.use_sn:
            with span("train.sn"):
                add_sigma_rank1_grads(grads, {k: v.grad for k, v in leaves.items()}, factors)
        if noise_rows is not None:
            group, d = self.mesh.group("data"), self.mesh.shape["data"]
            collectives.all_reduce_grads(grads, group, d)
            vals = collectives.mean_over_(torch.stack([metrics[k] for k in STEP_METRICS[:-1]]),
                                          group, d)
            metrics = {k: vals[i] for i, k in enumerate(STEP_METRICS[:-1])}
        return metrics, new_u, grads

    def _apply(self, state: VAETrainState, batch, beta: float,
               lr: float, precomputed=None, noise_rows=None) -> Dict[str, torch.Tensor]:
        """One step's update and its metrics. ``batch`` is the assembled
        batch (the eager step), or on the graph path a :class:`HostStep`,
        whose batch is assembled inside the captured step
        (:meth:`_graph_step`)."""
        if isinstance(batch, HostStep):
            return self._graph_step(state, batch, beta, lr)
        metrics, state.sn_u, grads = self.loss_and_grads(state, batch, beta,
                                                         precomputed=precomputed,
                                                         noise_rows=noise_rows)
        with span("train.optimizer"):
            params = dict(state.model.named_parameters())
            norm = None
            if state.layout is not None:  # over every block, each leaf once
                norm = collectives.global_grad_norm(grads, state.layout.params,
                                                    state.layout.group)
            metrics["grad_norm"] = self.opt.apply(grads, state.opt_state, params, lr)
        if norm is not None:
            metrics["grad_norm"] = norm
        return metrics

    # -- the graph path ------------------------------------------------------

    def graph_engages(self) -> bool:
        """Whether :meth:`train_epoch` captures its step as a CUDA graph: on
        one CUDA device (no mesh), with augmentation ``ops.gather_augment``
        covers (``aug.fusable``), the power iteration in every step (the
        "step" cadence "auto" resolves to, or no spectral norm) and no remat
        (``torch.utils.checkpoint`` saves and sets the generators' states
        around each block, which a capture cannot). Otherwise the eager loop."""
        return (self.device.type == "cuda" and self.mesh is None and self.aug.fusable
                and not (self.use_sn and self.sn_per_epoch) and not self.cfg.remat)

    def _stage(self, bsz: int) -> StepStage:
        stage = self._stages.get(bsz)
        if stage is None:
            stage = self._stages[bsz] = StepStage(bsz, self.device)
        return stage

    def _draws(self, n: int, bsz: int):
        """One step's host draws, in the trainer's order: the mixup
        partners, the augmentation scalars ``(lam_eff, amp, noise_sd)``, the
        kernel's noise seed."""
        a = self.aug
        pidx = self.rng.integers(0, n, bsz)
        scalars = draw_augment_scalars(
            self.rng, bsz, noise_prob=a.noise_prob, noise_level=a.noise_level,
            scaling_prob=a.scaling_prob, scaling_range=a.scaling_range,
            mixup_prob=a.mixup_prob, mixup_alpha=a.mixup_alpha)
        return pidx, scalars, int(self.rng.integers(0, 2 ** 31 - 1))

    def _step_graph(self, state: VAETrainState, data: torch.Tensor,
                    bsz: int) -> Optional[StepGraph]:
        """The epoch's captured step (None: the eager loop runs), kept
        while its key holds: what the step reads that a capture freezes."""
        if not self.graph_engages():
            return None
        def ptrs(tensors):
            return tuple(t.data_ptr() for t in tensors)
        opt = state.opt_state
        key = (tuple(data.shape), data.dtype, data.data_ptr(), bsz, self.fused_readout,
               self.readout_bwd, ptrs(state.model.parameters()), ptrs(opt["mu"].values()),
               ptrs(opt["nu"].values()), ptrs(state.sn_u.values()))
        if self._graph is None or self._graph.key != key:
            self._graph = None  # the old graph's memory goes back first
            self._graph = StepGraph(key, self.device)
        return self._graph

    def _stage_step(self, state: VAETrainState, step: HostStep, beta: float,
                    lr: float) -> StepStage:
        """Advances AdamW's count and sends the step's host values (rows,
        draws, beta and the optimizer's step words) to the card in one copy."""
        count = state.opt_state["count"] = state.opt_state["count"] + 1
        stage = self._stage(len(step.idx))
        stage.send(step.idx, step.pidx, step.scalars, step.seed, beta,
                   self.opt.step_words(count, lr))
        return stage

    def _step_body(self, state: VAETrainState, data: torch.Tensor,
                   stage: StepStage) -> torch.Tensor:
        """The whole step, reading every host value from ``stage``'s buffer:
        the batch (``gather_augment``), one power iteration, the forward and
        its noise, the backward, sigma's rank-1 terms, AdamW and the gradient
        norm. Parameters, moments and ``state.sn_u`` are updated in place.
        Returns the metrics as one f32 ``[5]`` tensor in ``STEP_METRICS``
        order. The graph captures this call; run without capture it is the
        same step."""
        with span("train.assemble"):
            batch = gather_augment(data, stage.idx, stage.pidx, stage.seed, stage.lam_eff,
                                   stage.amp, stage.noise_sd, generator=self.generator)
        metrics, new_u, grads = self.loss_and_grads(state, batch, stage.beta)
        with span("train.optimizer"):
            with torch.no_grad():
                for k, u in new_u.items():
                    state.sn_u[k].copy_(u)
            norm = self.opt.apply_staged(grads, state.opt_state,
                                         dict(state.model.named_parameters()), stage.step)
        return torch.stack([metrics[k].float() for k in STEP_METRICS[:-1]] + [norm])

    def _graph_step(self, state: VAETrainState, step: HostStep, beta: float,
                    lr: float) -> Dict[str, torch.Tensor]:
        """One step of the graph path: staged, then run eagerly on the side
        stream while the key is warming up, else captured (once) and
        replayed. Its metrics are copied into ``step.out``; the dict returned
        holds views of that row."""
        stage = self._stage_step(state, step, beta, lr)
        g = self._graph
        if g.graph is None and g.warm < WARMUP_STEPS:
            main = torch.cuda.current_stream(self.device)
            g.stream.wait_stream(main)
            with torch.cuda.stream(g.stream):
                vec = self._step_body(state, step.data, stage)
            main.wait_stream(g.stream)
            g.warm += 1
        else:
            if g.graph is None:
                with span("train.capture"):
                    g.capture(lambda: self._step_body(state, step.data, stage), self.generator)
                COUNTERS["train.graph_captures"] += 1
            with span("train.replay"):
                g.graph.replay()
            COUNTERS["train.graph_replays"] += 1
            vec = g.metrics
        step.out.copy_(vec)
        return dict(zip(STEP_METRICS, step.out.unbind(0)))

    def eager_step(self, state: VAETrainState, data: torch.Tensor, idx: np.ndarray,
                   beta: float, lr: float) -> Dict[str, torch.Tensor]:
        """One step on rows ``idx`` of ``data`` through the eager path
        (:meth:`assemble_batch`, then :meth:`_apply`), whatever
        :meth:`graph_engages` answers: the step of :meth:`train_epoch`'s eager
        loop, drawing what it draws."""
        return self._apply(state, self.assemble_batch(data, idx), beta, lr,
                           noise_rows=self._rows(len(idx)))

    # -- batches -------------------------------------------------------------

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def assemble_batch(self, data: torch.Tensor, idx: np.ndarray) -> torch.Tensor:
        """Rows ``idx`` of ``data``, augmented against random partner rows
        (the eager step's assembly). ``gather_augment``'s host values go to
        the card in one copy (:class:`StepStage`). On a mesh ``data`` is the
        resident layout of ``ops.gather_augment.dataset_replicated_rows`` and
        the batch comes back as this rank's block (:meth:`_rows`); everything
        is drawn for the whole batch on every rank, and the rank's seed is
        folded in on the host (``ops.gather_augment.rank_seed``)."""
        n, bsz = data.shape[0], len(idx)
        rows = self._rows(bsz)
        block = None if rows is None else slice(rows[0], rows[0] + bsz // self.mesh.shape["data"])
        if self.aug.fusable:
            pidx, scalars, seed = self._draws(n, bsz)
            if self.mesh is not None:
                seed = rank_seed(self.mesh, seed, block, self.parts)
            stage = self._stage(bsz)
            stage.send(idx, pidx, scalars, seed)
            vecs = (stage.idx, stage.pidx, stage.seed, stage.lam_eff, stage.amp, stage.noise_sd)
            if self.mesh is not None:
                return gather_augment_sharded(data, *vecs, rows=block)
            return gather_augment(data, *vecs, generator=self.generator)
        pidx = self.rng.integers(0, n, bsz)
        if block is not None:
            idx, pidx = idx[block], pidx[block]
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
        with span("train.epoch"):
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
            graph = self._step_graph(state, data, bsz)
            # Per-epoch cadence: one power iteration at the epoch boundary, its
            # sigmas and rank-1 factors reused by every step.
            sn_pre = None
            if self.use_sn and self.sn_per_epoch:
                with span("train.sn"):
                    inv, state.sn_u, factors = compute_sigmas(
                        state.model, state.sn_u, update=True,
                        compute_dtype=self._sn_dtype(), with_grad_factors=True)
                sn_pre = (inv, factors)
            rows = self._rows(bsz)
            if graph is not None:  # each step's metrics, copied out of the graph's
                out = torch.empty((len(perm), len(STEP_METRICS)), device=self.device)
                for i, idx in enumerate(perm):
                    with span("train.step", tick("train.steps")):
                        pidx, scalars, seed = self._draws(n, bsz)
                        self._apply(state, HostStep(data, idx, pidx, scalars, seed, out[i]),
                                    beta, lr)
            else:
                steps = []
                for idx in perm:
                    with span("train.step", tick("train.steps")):
                        with span("train.assemble"):
                            batch = self.assemble_batch(data, idx)
                        steps.append(self._apply(state, batch, beta, lr, sn_pre,
                                                 noise_rows=rows))
                out = self._metric_rows(steps)
            state.epoch += 1
            return state, self._epoch_metrics(out, beta, lr)

    @staticmethod
    def _metric_rows(steps: List[Dict[str, torch.Tensor]]) -> torch.Tensor:
        """Eager steps' metrics as one f32 ``[steps, 5]`` tensor."""
        return torch.stack([torch.stack([m[k].float() for k in STEP_METRICS]) for m in steps])

    @staticmethod
    def _epoch_metrics(rows: torch.Tensor, beta: float, lr: float):
        """Step means of the ``[steps, 5]`` metrics as 0-d device tensors (no
        host sync), plus beta and lr."""
        mean = rows.mean(dim=0)
        metrics = {k: mean[i] for i, k in enumerate(STEP_METRICS)}
        metrics.update(beta=beta, lr=lr)
        return metrics

    def train_step(self, state: VAETrainState, batch: torch.Tensor,
                   partner: torch.Tensor):
        """One step on a given batch and mixup partner (the plain
        augmentation), as the JAX streaming step: the power iteration runs in
        every step whatever the cadence; the epoch does not advance. One device only."""
        if self.mesh is not None:
            raise NotImplementedError("the streaming step runs on one device, not on a mesh")
        beta, lr = self._schedules(state.epoch)
        with span("train.assemble"):
            batch = augment_batch(batch, partner, self.aug, self.generator)
        metrics = self._apply(state, batch, beta, lr)
        metrics.update(beta=beta, lr=lr)
        return state, metrics

    # -- streaming -----------------------------------------------------------

    def _staging(self, shape, dtype, slots: int) -> list:
        """Reusable host buffers for streamed batches, of the trainer's
        compute dtype: pinned when the trainer is on a card."""
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
        The buffers are of the trainer's compute dtype and :func:`gather_rows`
        casts each row into them as it copies it, so a bf16 trainer sends half
        the bytes across to the card (as the JAX method does). ``partner_mode``: ``"dataset"`` draws the
        mixup partners from the whole host dataset (a second batch copied per
        step), ``"batch"`` takes the current batch rolled by one sample.
        ``max_steps`` truncates the epoch. Returns ``(state, metrics)`` as
        :meth:`train_epoch`."""
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
        staging = self._staging((bsz, *host.shape[1:]), self.dtype, 2 * per_step)
        side = torch.cuda.Stream(self.device) if on_card else None

        def to_device(idx: np.ndarray, buf: torch.Tensor) -> torch.Tensor:
            gather_rows(host, idx, buf)
            if not on_card:
                return buf.clone()
            with torch.cuda.stream(side):
                return buf.to(self.device, non_blocking=True)

        def fetch(i: int):
            """Stage batch i (and its partners): host gather, then the copy."""
            bufs = staging[(i % 2) * per_step:(i % 2 + 1) * per_step]
            batch = to_device(perm[i], bufs[0])
            partner = (to_device(self.rng.integers(0, n, size=bsz), bufs[1])
                       if partner_mode == "dataset" else None)
            ready = side.record_event() if on_card else None
            return batch, partner, ready

        with span("train.epoch"):
            metrics, done = [], []
            with span("train.fetch"):
                nxt = fetch(0)
            for i in range(steps):
                with span("train.step", tick("train.steps")):
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
                        with span("train.fetch"):
                            nxt = fetch(i + 1)
            if on_card:
                side.synchronize()  # every copy out of the staging buffers is over
            state.epoch += 1
            return state, self._epoch_metrics(self._metric_rows(metrics), metrics[0]["beta"],
                                              metrics[0]["lr"])

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
        rows = self._rows(bsz)  # on a mesh: this rank's rows, the metrics averaged
        gen = torch.Generator(self.device).manual_seed(self.seed * 1000003 + state.epoch)
        inv = {}
        if self.use_sn:
            inv, _ = compute_sigmas(state.model, state.sn_u, update=False,
                                    compute_dtype=self._sn_dtype())
        total = None
        with attach_inv_sigmas(state.model, inv):
            for take in idx.reshape(num_batches, bsz):
                if rows is not None:
                    take = take[rows[0]: rows[0] + bsz // self.mesh.shape["data"]]
                _, m = self.loss_fn(state.model, data.index_select(0, take), beta, gen, rows)
                vals = torch.stack([m[k].float() for k in STEP_METRICS[:-1]])
                total = vals if total is None else total + vals
        mean = total / num_batches
        if rows is not None:
            collectives.mean_over_(mean, self.mesh.group("data"), self.mesh.shape["data"])
        return {k: mean[i] for i, k in enumerate(STEP_METRICS[:-1])}

    @torch.no_grad()
    def eval_params(self, state: VAETrainState) -> VAE:
        """A copy of the model whose spectrally normalised kernels are divided
        by their sigma (stored ``u``, no update): the parameters to serve
        with, as the JAX ``eval_params``. On a mesh the whole model, on every
        rank (:meth:`gather_state`)."""
        state = self.gather_state(state)
        model = self.build_model(full=True)
        model.load_state_dict(state.model.state_dict())
        if self.use_sn:
            normed, _ = spectral_normalize(state.model, state.sn_u, update=False,
                                           compute_dtype=self._sn_dtype())
            params = dict(model.named_parameters())
            for name, w in normed.items():
                params[name].copy_(w)
        return model

    # -- fit -----------------------------------------------------------------

    def _preempted(self) -> bool:
        """``preemption.requested()``, agreed over a mesh: true on every rank
        when any asked (and then set on each, for the caller's exit code)."""
        stop = preemption.requested()
        if self.mesh is not None:
            stop = collectives.agree_any(stop, self.mesh.everyone(), self.device)
            if stop and not preemption.requested():
                preemption.request()
        return stop

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
            nan_guard: bool = True, nan_guard_max_retries: int = 2, mesh=None):
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
        saved states.

        ``mesh`` (or an earlier :meth:`set_mesh`) trains on a mesh: every rank
        calls ``fit`` with the same arguments and the whole ``data``; the
        state (a whole one is split) and the resident rows are laid out for
        the mesh, the NaN decision reads the averaged losses, a preemption
        requested on any rank stops every rank after the same span, and a
        checkpoint holds the whole state. ``stream=True`` is refused there."""
        cfg = self.cfg
        epochs = cfg.n_epochs if epochs is None else epochs
        if mesh is not None:
            self.set_mesh(mesh)
        if self.mesh is not None and stream:
            raise NotImplementedError(
                "stream=True runs on one device; on a mesh of several ranks every rank "
                "keeps the dataset resident (load_all=1)")
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
            data = torch.as_tensor(data)
            if self.mesh is not None:  # every row, this rank's nodes
                data = dataset_replicated_rows(data, self.mesh, self.parts)
            data = data.to(self.device, self.dtype)
            data_train = data.index_select(0, torch.as_tensor(train_idx, device=self.device))
            data_val = (data.index_select(0, torch.as_tensor(val_idx, device=self.device))
                        if n_val else data_train)
        state = self.init_state(seed) if state is None else self.shard_state(state)
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
            if self._preempted():
                break  # cooperative stop: the forced save below, then return

        save(force=True)
        if ckpt_manager is not None:
            ckpt_manager.wait()
        state.rng = self.rng_state()
        return state, {k: np.asarray(v) for k, v in history.items()}
