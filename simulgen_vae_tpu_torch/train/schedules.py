"""Learning-rate schedules (``simulgen_vae_tpu/train/schedules.py``).

* :func:`cosine_warm_restarts`, the VAE trainer's, in Python floats;
* :func:`lc_warmup_cosine`, the latent conditioner's: a linear warm-up of
  the factor from ``start_factor`` to 1, then a cosine to ``eta_min``;
* :func:`cosine_annealing`: the cosine alone.

The last two run in f32, operation for operation as the JAX functions do in
``jnp`` (the learning rate reaches AdamW as an f32): near the end of the
cosine, where ``1 + cos`` is small, a double-precision version would differ
from JAX's by up to 1e-4 relative.
"""

from __future__ import annotations

import math

import numpy as np

_F32 = np.float32


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


def _cosine(t, base_lr: float, t_max, eta_min: float):
    return _F32(eta_min) + _F32(base_lr - eta_min) * (
        _F32(1.0) + np.cos(_F32(np.pi) * t / _F32(t_max))) / _F32(2.0)


def lc_warmup_cosine(epoch: int, base_lr: float, total_epochs: int,
                     warmup_epochs: int = 100, start_factor: float = 0.01,
                     eta_min: float = 1e-8) -> float:
    """The applied lr at ``epoch`` of torch's ``LinearLR(start_factor,
    total_iters=warmup)`` stepped over epochs [0, warmup), then
    ``CosineAnnealingLR(T_max=total - warmup, eta_min)``."""
    e = _F32(epoch)
    warm = np.minimum(e, _F32(warmup_epochs))
    factor = _F32(start_factor) + _F32(1.0 - start_factor) * warm / _F32(warmup_epochs)
    if e < warmup_epochs:
        return float(_F32(base_lr) * factor)
    t_max = max(total_epochs - warmup_epochs, 1)
    t = np.clip(e - _F32(warmup_epochs), _F32(0), _F32(t_max))
    return float(_cosine(t, base_lr, t_max, eta_min))


def cosine_annealing(epoch: int, base_lr: float, total_epochs: int,
                     eta_min: float = 1e-8) -> float:
    """torch's ``CosineAnnealingLR(T_max=total_epochs, eta_min)`` at ``epoch``,
    flat after ``total_epochs``."""
    t = np.clip(_F32(epoch), _F32(0), _F32(total_epochs))
    return float(_cosine(t, base_lr, total_epochs, eta_min))
