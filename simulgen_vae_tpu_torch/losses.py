"""Losses of the VAE (``simulgen_vae_tpu/losses.py``): the KL terms, the
reconstruction flavors, the low-residual reconstruction pair and the KL
warm-up schedule."""

from __future__ import annotations

import torch

LOG_VAR_CLAMP = 30.0


def kl(mu: torch.Tensor, log_var: torch.Tensor) -> torch.Tensor:
    """KL(q(z|x) || N(0, I)) summed over the latent, mean over the batch."""
    log_var = log_var.clamp(-LOG_VAR_CLAMP, LOG_VAR_CLAMP)
    loss = 0.5 * torch.sum(mu ** 2 + torch.exp(log_var) - log_var - 1.0, dim=1)
    return loss.mean(dim=0)


def kl_2(delta_mu: torch.Tensor, delta_log_var: torch.Tensor,
         mu: torch.Tensor, log_var: torch.Tensor) -> torch.Tensor:
    """KL of the delta-posterior against the conv prior, summed over every
    non-batch axis, mean over the batch."""
    log_var = log_var.clamp(-LOG_VAR_CLAMP, LOG_VAR_CLAMP)
    delta_log_var = delta_log_var.clamp(-LOG_VAR_CLAMP, LOG_VAR_CLAMP)
    var = torch.exp(log_var) + 1e-8
    delta_var = torch.exp(delta_log_var)
    loss = 0.5 * torch.sum(
        delta_var / var + (mu - delta_mu) ** 2 / var - delta_log_var + log_var - 1.0,
        dim=tuple(range(1, mu.dim())),
    )
    return loss.mean(dim=0)


# -- reconstruction losses (torch-default semantics) --------------------------

def mse_loss(pred, target):
    return torch.mean((pred - target) ** 2)


def mae_loss(pred, target):
    return torch.mean(torch.abs(pred - target))


def smooth_l1_loss(pred, target, beta: float = 1.0):
    d = torch.abs(pred - target)
    return torch.mean(torch.where(d < beta, 0.5 * d ** 2 / beta, d - 0.5 * beta))


def huber_loss(pred, target, delta: float = 1.0):
    d = torch.abs(pred - target)
    return torch.mean(torch.where(d < delta, 0.5 * d ** 2, delta * (d - 0.5 * delta)))


RECON_LOSSES = {
    "MSE": mse_loss,
    "MAE": mae_loss,
    "smoothL1": smooth_l1_loss,
    "Huber": huber_loss,
    "Huber0.1": lambda p, t: huber_loss(p, t, delta=0.1),
    "SmoothL1": lambda p, t: smooth_l1_loss(p, t, beta=0.1),
}


def get_recon_loss(name: str):
    if name not in RECON_LOSSES:
        raise KeyError(f"Unknown loss '{name}'; options: {sorted(RECON_LOSSES)}")
    return RECON_LOSSES[name]


def _sign(d):
    # +1 at d == 0, the JAX package's convention for |d|'s derivative.
    return torch.where(d >= 0, 1.0, -1.0)


def _recon_grad_fn(name: str):
    """Elementwise dLoss/dpred (f32, before the 1/n of the mean)."""
    if name == "MSE":
        return lambda d: 2.0 * d
    if name == "MAE":
        return _sign
    if name in ("smoothL1", "SmoothL1"):
        beta = 1.0 if name == "smoothL1" else 0.1
        return lambda d: torch.where(d.abs() < beta, d / beta, _sign(d))
    if name in ("Huber", "Huber0.1"):
        delta = 1.0 if name == "Huber" else 0.1
        return lambda d: torch.where(d.abs() < delta, d, delta * _sign(d))
    raise KeyError(f"Unknown loss '{name}'; options: {sorted(RECON_LOSSES)}")


def make_recon_loss_pair(name: str):
    """``f(pred, target) -> (recon_loss, recon_loss_mse)``: f32 math whose
    backward saves only the low-precision ``pred`` and ``target`` (no f32 copy
    of the ``[B, T, nodes]`` map is kept for the backward)."""
    flavor, dflavor = get_recon_loss(name), _recon_grad_fn(name)

    class _Pair(torch.autograd.Function):
        @staticmethod
        def forward(ctx, pred, target):
            ctx.save_for_backward(pred, target)
            p32, t32 = pred.float(), target.float()
            return flavor(p32, t32), mse_loss(p32, t32)

        @staticmethod
        def backward(ctx, g_flavor, g_mse):
            pred, target = ctx.saved_tensors
            d = pred.float() - target.float()
            gp32 = (g_flavor * dflavor(d) + g_mse * (2.0 * d)) / d.numel()
            gp = gp32.to(pred.dtype) if ctx.needs_input_grad[0] else None
            gt = (-gp32).to(target.dtype) if ctx.needs_input_grad[1] else None
            return gp, gt

    return _Pair.apply


def beta_schedule(epoch: int, n_epochs: int, init_beta: float = 1e-4,
                  beta_target: float = 1.0, start_frac: float = 0.3,
                  end_frac: float = 0.8) -> float:
    """KL warm-up: ``init_beta`` until ``start_frac`` of the epochs, linear to
    ``beta_target`` at ``end_frac``, flat after."""
    start, end = int(n_epochs * start_frac), int(n_epochs * end_frac)
    slope = (beta_target - init_beta) / max(end - start, 1)
    return min(max((epoch - start) * slope + init_beta, init_beta), beta_target)
