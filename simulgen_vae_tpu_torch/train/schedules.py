"""Learning-rate schedule of the VAE trainer (``simulgen_vae_tpu/train/schedules.py``)."""

from __future__ import annotations

import math


def cosine_warm_restarts(epoch: int, base_lr: float, t_0: int, t_mult: int = 2,
                         eta_min: float = 0.0) -> float:
    """lr(epoch) of torch's ``CosineAnnealingWarmRestarts`` stepped once per
    epoch: cycle i lasts ``t_0 * t_mult**i`` epochs. The cycle is found with
    integer arithmetic, so restarts fall exactly on their epochs."""
    t_0 = max(int(t_0), 1)
    t_cur, t_i = epoch, t_0
    if t_mult == 1:
        t_cur = epoch % t_0
    else:
        while t_cur >= t_i:
            t_cur -= t_i
            t_i *= t_mult
    return eta_min + (base_lr - eta_min) * (1 + math.cos(math.pi * t_cur / t_i)) / 2
