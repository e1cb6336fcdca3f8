"""End-to-end latent-conditioner training through the frozen VAE decoder
(``simulgen_vae_tpu/train/lc_e2e_trainer.py``).

The conditioner's latents are descaled by the latent scalers' affine
inverses (on the device, in the autograd graph) and decoded by the trained
decoder, so the reconstruction loss trains the conditioner through it. The
decoder is frozen: its parameters do not require grad, and gradients reach
only the latents ``z`` and ``xs``. It runs the weights it was built with (the
training CLI hands it ``VAETrainer.eval_params``: spectral norm baked in, no
``inv_sigma``) in the deterministic ``"fix"`` decode the evaluator uses (the
JAX trainer's default; the original reference decodes with ``"random"``).

Each batch (``n // batch`` of a fresh permutation, ``batch = min(batch_size,
n)``):

* noise on every input: x ``sigma = .1``, the target field, the main and the
  hierarchical latents ``sigma = .05``, drawn from the trainer's
  ``torch.Generator``;
* loss ``LC_alpha * recon(decode(descale(pred)), target) + reg_weight *
  (0.9 MSE(main) + 0.1 MSE(hier))`` with latent regularization, ``recon``
  alone without; ``recon`` from :data:`E2E_LOSS_MAP` (Huber and SmoothL1
  with delta / beta .1);
* :func:`hybrid_clip` to a global gradient norm in [1e-5, 10], then AdamW
  (``train.optim.FusedAdamW``: its kernel on CUDA tensors) at the epoch's
  ``cosine_annealing`` rate.

``E2ETrainer`` is an ``LCTrainer`` (``train.lc_trainer``) with this loss,
noise, rate and clip: spectral norm on the layers ``sn_filter`` selects, the
generators, checkpoints and the epoch loop are that trainer's.
:meth:`E2ETrainer.fit` validates every epoch, keeps the state of the best
validation loss and returns it, rolls back on a non-finite train loss (to
the last checkpoint, else to the best state) and stops on a preemption
request after saving the current state. Before training the conditioner is
re-initialised by :func:`reference_e2e_reinit`, the reference E2E trainer's
own scheme.

The training CLI compares an E2E-trained conditioner through its raw
weights in eval mode, as JAX's does (the JAX trainer has no ``predict_fn``),
not through the inherited ``predict_fn`` (``W / sigma``).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
from torch import nn

from simulgen_vae_tpu_torch.convert import flax_ndim, image_conditioner_paths
from simulgen_vae_tpu_torch.evaluation.reconstruction import compute_dtype
from simulgen_vae_tpu_torch.losses import get_recon_loss, mse_loss
from simulgen_vae_tpu_torch.models.vae import VAE
from simulgen_vae_tpu_torch.train.lc_trainer import LCTrainer, LCTrainState
from simulgen_vae_tpu_torch.train.schedules import cosine_annealing
from simulgen_vae_tpu_torch.utils.profiling import span

E2E_LOSS_MAP = {"MSE": "MSE", "MAE": "MAE", "Huber": "Huber0.1", "SmoothL1": "SmoothL1"}
STEP_METRICS = ("loss", "recon", "reg", "grad_norm")
EVAL_METRICS = STEP_METRICS[:-1]
NOISE_X, NOISE_TARGET, NOISE_LATENT = 0.1, 0.05, 0.05
CLIP_MIN, CLIP_MAX = 1e-5, 10.0


@torch.no_grad()
def reference_e2e_reinit(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-initialise an image conditioner's parameters in place by the
    reference E2E trainer's scheme, judged on each leaf's flax layout
    (``convert.image_conditioner_paths``), as JAX's is:

    * a module whose kernel is 3-D in flax (a ``DenseGeneral`` of the
      attention: query, key, value, out) is left as it is, bias included;
    * a bias becomes 0, a norm scale 1;
    * a 2-D kernel with at most 64 outputs (flax ``shape[1]``, the port's
      ``shape[0]``) is drawn from ``normal(0, 0.1)``;
    * any other kernel He-uniform: bound ``sqrt(6 / fan_in)``, ``fan_in`` the
      product of every flax axis but the last;
    * the rest (``pos_embed``, BatchNorm statistics) is untouched.

    Draws come from ``generator`` (on the CPU): JAX's distributions, not
    its bits."""
    paths = image_conditioner_paths(model)
    skipped = {path[:-1] for layout, path in paths.values()
               if path[-1] == "kernel" and flax_ndim(layout) == 3}
    params = dict(model.named_parameters())
    for name, (layout, path) in paths.items():
        if path[0] != "params" or path[:-1] in skipped or name not in params:
            continue
        p, leaf = params[name], path[-1]
        if leaf == "bias":
            p.zero_()
        elif leaf == "scale":
            p.fill_(1.0)
        elif leaf == "kernel":
            t = torch.empty(p.shape)
            if flax_ndim(layout) == 2 and p.shape[0] <= 64:
                t.normal_(0.0, 0.1, generator=generator)
            else:
                bound = math.sqrt(6.0 / (p.numel() // p.shape[0]))
                t.uniform_(-bound, bound, generator=generator)
            p.copy_(t)
    return model


def hybrid_clip(grads: Dict[str, torch.Tensor], min_norm: float = CLIP_MIN,
                max_norm: float = CLIP_MAX):
    """``(clipped, norm)``: gradients scaled down to a global norm of
    ``max_norm`` above it, up to ``min_norm`` below it (a zero norm stays),
    as one factor on the device; ``norm`` the global norm before."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(grads.values()))))
    one = torch.ones_like(norm)
    scale = torch.where(norm > max_norm, max_norm / (norm + 1e-12),
                        torch.where((norm > 0) & (norm < min_norm),
                                    min_norm / (norm + 1e-12), one))
    return {k: g * scale for k, g in grads.items()}, norm


class E2ETrainer(LCTrainer):
    STEP_METRICS, EVAL_METRICS = STEP_METRICS, EVAL_METRICS
    stage = "e2e"
    track_best = True

    def __init__(self, lc_model: nn.Module, vae_model: VAE, latent_scaler, xs_scaler,
                 epochs: int, lr: float, batch_size: int, weight_decay: float = 1e-5,
                 loss_function: str = "MSE", lc_alpha: float = 1.0,
                 use_latent_regularization: bool = True, latent_reg_weight: float = 1e-3,
                 sn_filter: Optional[Callable[[str], bool]] = None, device=None,
                 seed: int = 0):
        """``lc_model`` is the architecture (:meth:`init_state` trains a copy);
        ``vae_model`` the trained VAE whose decoder is frozen here (its
        parameters stop requiring grad); the scalers are the latents'
        ``MinMaxScaler``s."""
        super().__init__(lc_model, epochs, lr, batch_size, weight_decay=weight_decay,
                         device=device, seed=seed, sn_filter=sn_filter)
        self.vae = vae_model
        for p in self.vae.parameters():
            p.requires_grad_(False)
        self.vae_dtype = compute_dtype(vae_model)
        self.latent_scaler = latent_scaler.to(self.device)
        self.xs_scaler = xs_scaler.to(self.device)
        self.recon_loss = get_recon_loss(E2E_LOSS_MAP.get(loss_function, "MSE"))
        self.lc_alpha = lc_alpha
        self.use_reg, self.reg_weight = use_latent_regularization, latent_reg_weight

    def _init_model(self, seed: int) -> nn.Module:
        model = super()._init_model(seed)
        return reference_e2e_reinit(model, torch.Generator().manual_seed(seed + 1))

    # -- loss ----------------------------------------------------------------

    def _descale(self, y_pred1, y_pred2):
        z = self.latent_scaler.inverse_transform(y_pred1)
        b, nh, hd = y_pred2.shape
        xs = self.xs_scaler.inverse_transform(y_pred2.reshape(b, nh * hd))
        return z, xs.reshape(b, nh, hd)

    def decode(self, z: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
        """The frozen decoder on descaled latents: ``[B, T, nodes]`` (its
        1e-8 sampling noise from the trainer's generator)."""
        dt = self.vae_dtype
        return self.vae.generate(z.to(dt), [xs[:, i].to(dt) for i in range(xs.shape[1])],
                                 generator=self.generator)

    def loss_fn(self, model, x, y1, y2, target, generator=None):
        """``(loss, metrics)`` on a batch the noise was added to;
        ``generator`` turns the conditioner's training mode on."""
        with span("lc.conditioner"):
            y_pred1, y_pred2 = model(x, generator)
        with span("lc.decode"):
            field = self.decode(*self._descale(y_pred1, y_pred2))
        with span("lc.loss"):
            recon = self.recon_loss(field.float(), target.float())
            if self.use_reg:
                reg = (0.9 * mse_loss(y_pred1, y1)
                       + 0.1 * mse_loss(y_pred2.reshape(-1), y2.reshape(-1)))
                loss = self.lc_alpha * recon + self.reg_weight * reg
            else:
                reg = torch.zeros((), device=recon.device)
                loss = recon
        return loss, {"loss": loss.detach(), "recon": recon.detach(),
                      "reg": (self.reg_weight * reg).detach()}

    def _augment(self, x, y1, y2, target):
        """Noise on every input, from the trainer's ``torch.Generator``."""
        def noisy(t, std):
            return t + torch.randn(t.shape, generator=self.generator, device=t.device) * std

        return (noisy(x, NOISE_X), noisy(y1, NOISE_LATENT), noisy(y2, NOISE_LATENT),
                noisy(target, NOISE_TARGET))

    def lr_at(self, epoch: int) -> float:
        return cosine_annealing(epoch, self.lr, self.epochs)

    def clip(self, grads: Dict[str, torch.Tensor]):
        return hybrid_clip(grads)

    # -- fit -----------------------------------------------------------------

    def fit(self, x, y1, y2, target, seed: int = 0, state: Optional[LCTrainState] = None,
            val_split: float = 0.3, log_fn: Optional[Callable[[int, Dict], None]] = None,
            epochs: Optional[int] = None, ckpt_manager=None, nan_guard: bool = True,
            nan_guard_max_retries: int = 2):
        """Train on ``x`` [n, features], ``y1`` [n, z], ``y2`` [n, size2,
        latent] and ``target`` [n, T, nodes] (numpy) with a ``val_split``
        hold-out drawn from ``seed``, validating every epoch. Returns
        ``(state, history)``: the best validation state."""
        return self._fit((x, y1, y2, target), seed=seed, state=state, val_split=val_split,
                         val_every=1, overfit_threshold=math.inf, log_fn=log_fn,
                         epochs=epochs, ckpt_manager=ckpt_manager, nan_guard=nan_guard,
                         nan_guard_max_retries=nan_guard_max_retries)
