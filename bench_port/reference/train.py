"""Plain reference of the VAE train step: spectral norm (one power iteration
a step), the loss and its gradient by autograd, and AdamW (decoupled decay,
eps outside the root), in f32 unless ``lowp`` rounds the products' operands.

    m <- b1 m + (1 - b1) g       v <- b2 v + (1 - b2) g^2
    p <- p - lr ((m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps) + wd p)

The KL warm-up beta and the cosine warm-restart learning rate follow the
reference trainer's schedules, as functions of the epoch.
"""

from __future__ import annotations

import math

import torch

from reference import vae

B1, B2, ADAM_EPS, WEIGHT_DECAY = 0.9, 0.999, 1e-8, 0.01


def beta_schedule(epoch: int, n_epochs: int, init_beta: float = 1e-4,
                  target: float = 1.0, start_frac: float = 0.3, end_frac: float = 0.8) -> float:
    start, end = int(n_epochs * start_frac), int(n_epochs * end_frac)
    slope = (target - init_beta) / max(end - start, 1)
    return min(max((epoch - start) * slope + init_beta, init_beta), target)


def learning_rate(epoch: int, base_lr: float, n_epochs: int) -> float:
    """torch's CosineAnnealingWarmRestarts(T_0 = n_epochs // 4, T_mult = 2,
    eta_min = lr / 1e4) stepped once an epoch."""
    eta_min, t_i, t_cur = base_lr * 1e-4, max(n_epochs // 4, 1), epoch
    while t_cur >= t_i:
        t_cur -= t_i
        t_i *= 2
    return eta_min + (base_lr - eta_min) * (1 + math.cos(math.pi * t_cur / t_i)) / 2


def train_steps(cfg: dict, params: dict, us: dict, batches, noises, epoch: int = 0,
                lowp=None) -> dict:
    """Run ``len(batches)`` steps from ``params`` (f32, not modified) and the
    power-iteration vectors ``us``. Returns ``{"losses": [...], "grads":
    first step's gradient, "params": the parameters after the last step}``."""
    beta = beta_schedule(epoch, cfg["n_epochs"])
    lr = learning_rate(epoch, cfg["lr"], cfg["n_epochs"])
    p = {k: v.detach().clone() for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    names = vae.sn_names({k: tuple(t.shape) for k, t in p.items()})
    us = dict(us)
    losses, first = [], None
    for t, (x, eps) in enumerate(zip(batches, noises), start=1):
        leaves = {k: t_.requires_grad_() for k, t_ in p.items()}
        normed, us = vae.normalized(leaves, us, names)
        loss = vae.forward_loss(vae.Layers(normed, lowp), cfg, x, eps, beta)
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        # a leaf the loss does not reach (the deepest encoder level's head) gets zeros
        grads = [torch.zeros_like(w) if g is None else g for w, g in zip(leaves.values(), grads)]
        losses.append(float(loss.detach()))
        with torch.no_grad():
            p = {k: t_.detach() for k, t_ in leaves.items()}
            if first is None:
                first = {k: g.clone() for k, g in zip(p, grads)}
            c1, c2 = 1.0 - B1 ** t, 1.0 - B2 ** t
            for (k, w), g in zip(p.items(), grads):
                m[k].mul_(B1).add_(g, alpha=1.0 - B1)
                v2[k].mul_(B2).add_(g * g, alpha=1.0 - B2)
                upd = (m[k] / c1) / (torch.sqrt(v2[k] / c2) + ADAM_EPS) + WEIGHT_DECAY * w
                w.sub_(lr * upd)
        del grads, loss, normed, leaves
    return {"losses": losses, "grads": first, "params": p}
