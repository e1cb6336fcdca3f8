"""Per-sample stochastic augmentation of ``[B, T, N]`` batches
(``simulgen_vae_tpu/data/augmentation.py``).

Gaussian noise (p .5, sigma .05), amplitude scaling (p .5, U[.9, 1.1]),
mixup against a partner batch (p .5, Beta(.2, .2) clamped to [.1, .9]), and
time shift and cutout, off by default. :func:`augment_batch` is the plain
composition in that order; the trainer uses it on the CPU and wherever shift
or cutout is on. With the default set the trainer assembles batches with
``ops.gather_augment`` instead, whose per-sample scalars have the same
distributions. Random numbers come from an explicit ``torch.Generator`` on
the batch's device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class AugmentationConfig:
    noise_prob: float = 0.5
    noise_level: float = 0.05
    scaling_prob: float = 0.5
    scaling_range: tuple = (0.9, 1.1)
    shift_prob: float = 0.0
    shift_max: float = 0.0
    mixup_prob: float = 0.5
    mixup_alpha: float = 0.2
    cutout_prob: float = 0.0
    cutout_max: float = 0.0
    enabled: bool = True

    @property
    def fusable(self) -> bool:
        """Whether ``ops.gather_augment`` covers this set (no shift, no cutout)."""
        return self.enabled and self.shift_prob == 0 and self.cutout_prob == 0


def sample_beta(alpha: float, shape, generator: Optional[torch.Generator],
                device) -> torch.Tensor:
    """Beta(alpha, alpha) from two Gamma(alpha) draws, each by Marsaglia and
    Tsang on Gamma(alpha + 1) times U^(1/alpha), with uniforms and normals from
    ``generator`` (``torch.distributions.Beta`` takes none)."""
    def gamma(n):
        d = alpha + 1.0 - 1.0 / 3.0
        c = 1.0 / (9.0 * d) ** 0.5
        out = torch.empty(n, device=device)
        todo = torch.ones(n, dtype=torch.bool, device=device)
        while bool(todo.any()):  # expected rejection rate below 5%
            z = torch.randn(n, generator=generator, device=device)
            u = torch.rand(n, generator=generator, device=device)
            v = (1.0 + c * z) ** 3
            ok = todo & (v > 0) & (torch.log(u) < 0.5 * z * z + d - d * v
                                   + d * torch.log(v.clamp_min(1e-30)))
            out = torch.where(ok, d * v, out)
            todo &= ~ok
        u = torch.rand(n, generator=generator, device=device)
        return out * u ** (1.0 / alpha)

    n = int(torch.Size(shape).numel())
    a, b = gamma(n), gamma(n)
    return (a / (a + b).clamp_min(1e-30)).reshape(shape)


def augment_batch(batch: torch.Tensor, partner: torch.Tensor,
                  config: AugmentationConfig = AugmentationConfig(),
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Augmented ``[B, T, N]`` batch, same shape and dtype; ``partner`` holds
    independently drawn samples for mixup."""
    if not config.enabled:
        return batch
    b, t = batch.shape[0], batch.shape[1]
    dev, dtype = batch.device, batch.dtype

    def rand(*shape):
        return torch.rand(shape, generator=generator, device=dev)

    if config.noise_prob > 0:
        noise = torch.randn(batch.shape, generator=generator, device=dev).to(dtype)
        apply = rand(b, 1, 1) < config.noise_prob
        batch = torch.where(apply, batch + noise * config.noise_level, batch)
    if config.scaling_prob > 0:
        lo, hi = config.scaling_range
        scale = (lo + (hi - lo) * rand(b, 1, 1)).to(dtype)
        apply = rand(b, 1, 1) < config.scaling_prob
        batch = torch.where(apply, batch * scale, batch)
    if config.shift_prob > 0 and config.shift_max > 0:
        max_shift = int(t * config.shift_max)
        shift = torch.randint(-max_shift, max_shift + 1, (b, 1, 1),
                              generator=generator, device=dev)
        src = torch.arange(t, device=dev)[None, :, None] - shift
        valid = (src >= 0) & (src < t)
        shifted = torch.gather(batch, 1, src.clamp(0, t - 1).expand_as(batch))
        shifted = torch.where(valid, shifted, torch.zeros_like(shifted))
        apply = rand(b, 1, 1) < config.shift_prob
        batch = torch.where(apply, shifted, batch)
    if config.mixup_prob > 0:
        lam = sample_beta(config.mixup_alpha, (b, 1, 1), generator, dev)
        lam = lam.to(dtype).clamp(0.1, 0.9)
        apply = rand(b, 1, 1) < config.mixup_prob
        batch = torch.where(apply, lam * batch + (1.0 - lam) * partner, batch)
    if config.cutout_prob > 0 and config.cutout_max > 0:
        max_len = int(t * config.cutout_max)
        length = torch.randint(1, max_len + 1, (b, 1, 1), generator=generator, device=dev)
        start = torch.randint(0, t, (b, 1, 1), generator=generator, device=dev)
        idx = torch.arange(t, device=dev)[None, :, None]
        mask = (idx >= start) & (idx < start + length)
        apply = rand(b, 1, 1) < config.cutout_prob
        batch = torch.where(apply & mask, torch.zeros_like(batch), batch)
    return batch
