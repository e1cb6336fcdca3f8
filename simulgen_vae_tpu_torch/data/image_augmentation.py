"""Outline-preserving image augmentation for latent-conditioner training
(``simulgen_vae_tpu/data/image_augmentation.py``), on the device.

Per call, on a batch ``[B, H, W]``: with probability ``prob`` the batch is
augmented at all; then a horizontal flip (batch gate p .3, each sample p .5),
a +-1 pixel roll in x and y (batch gate p .5), and one bilinear resample per
sample for a rotation of +-5 degrees (batch gate p .3, only where |angle| >
.5 degrees) and a scale in [0.95, 1.05] (batch gate p .3, only where |s - 1|
> .01), with border padding. :func:`augment_images` runs it on flat images
with probability ``apply_prob``.

The resample is JAX's formula, not ``F.grid_sample``: its grid is
``linspace(-1, 1)`` (``align_corners=True``) but it unnormalises with
``(s + 1) * w / 2 - 0.5`` (``align_corners=False``), a mix no
``grid_sample`` mode computes. Draws come from a ``torch.Generator`` on the
batch's device: JAX's distributions, not its bits.
"""

from __future__ import annotations

import math

import torch


def _grid(n: int, device) -> torch.Tensor:
    """``n`` points from -1 to 1 as ``jnp.linspace`` computes them in f32:
    ``-1 * (1 - t) + 1 * t`` with ``t = i / (n - 1)``, the last exactly 1."""
    t = torch.arange(n - 1, dtype=torch.float32, device=device) / (n - 1)
    return torch.cat([-(1.0 - t) + t, torch.ones(1, device=device)])


def _affine_resample(img: torch.Tensor, cos_a: torch.Tensor, sin_a: torch.Tensor,
                     scale: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of ``img [B, H, W]`` under a rotation and scale about
    the centre (per sample ``cos_a``, ``sin_a``, ``scale`` [B]), clamped to
    the border."""
    b, h, w = img.shape
    gy, gx = torch.meshgrid(_grid(h, img.device), _grid(w, img.device), indexing="ij")
    c, s, k = (t.reshape(b, 1, 1) for t in (cos_a, sin_a, scale))
    src_x = k * (gx * c - gy * s)
    src_y = k * (gx * s + gy * c)
    px = ((src_x + 1.0) * w / 2.0 - 0.5).clamp(0.0, w - 1.0)
    py = ((src_y + 1.0) * h / 2.0 - 0.5).clamp(0.0, h - 1.0)
    x0, y0 = px.floor().long(), py.floor().long()
    x1, y1 = (x0 + 1).clamp(0, w - 1), (y0 + 1).clamp(0, h - 1)
    fx, fy = px - x0, py - y0
    flat = img.reshape(b, h * w)

    def at(yi, xi):
        return flat.gather(1, (yi * w + xi).reshape(b, -1)).reshape(b, h, w)

    return ((1 - fy) * ((1 - fx) * at(y0, x0) + fx * at(y0, x1))
            + fy * ((1 - fx) * at(y1, x0) + fx * at(y1, x1)))


def _roll(x: torch.Tensor, shift_x: torch.Tensor, shift_y: torch.Tensor) -> torch.Tensor:
    """``jnp.roll`` of each image ``[H, W]`` by its own shifts along W, then H."""
    b, h, w = x.shape
    cols = (torch.arange(w, device=x.device) - shift_x[:, None]) % w     # [B, W]
    rows = (torch.arange(h, device=x.device) - shift_y[:, None]) % h     # [B, H]
    x = x.gather(2, cols[:, None, :].expand(b, h, w))
    return x.gather(1, rows[:, :, None].expand(b, h, w))


def apply_outline_preserving_augmentations(x: torch.Tensor, generator: torch.Generator,
                                           prob: float = 0.5) -> torch.Tensor:
    """Augment square images ``[B, H, W]`` (see the module docstring)."""
    b = x.shape[0]
    dev = x.device

    def uniform(*shape):
        return torch.rand(shape, generator=generator, device=dev)

    original = x
    flip_gate = uniform() < 0.3
    flip = (uniform(b, 1, 1) < 0.5) & flip_gate
    x = torch.where(flip, x.flip(2), x)

    shift_gate = uniform() < 0.5
    shifts = torch.randint(-1, 2, (2, b), generator=generator, device=dev)
    shifts = torch.where(shift_gate, shifts, torch.zeros_like(shifts))
    x = _roll(x, shifts[0], shifts[1])

    rot_gate = uniform() < 0.3
    angles = (uniform(b) - 0.5) * 10.0
    angles = torch.where(rot_gate & (angles.abs() > 0.5), angles, torch.zeros_like(angles))
    rad = angles * math.pi / 180.0
    scale_gate = uniform() < 0.3
    scales = 0.95 + uniform(b) * 0.1
    scales = torch.where(scale_gate & ((scales - 1.0).abs() > 0.01), scales,
                         torch.ones_like(scales))
    resample = (rad.abs() > 0) | (scales != 1.0)
    resampled = _affine_resample(x, torch.cos(rad), torch.sin(rad), scales)
    x = torch.where(resample[:, None, None], resampled, x)

    return torch.where(uniform() < prob, x, original)


def augment_images(x_flat: torch.Tensor, generator: torch.Generator, prob: float = 0.8,
                   apply_prob: float = 0.5) -> torch.Tensor:
    """With probability ``apply_prob``, flat square images ``[B, H*W]`` through
    :func:`apply_outline_preserving_augmentations` (its own ``prob`` gate);
    otherwise as they are."""
    b = x_flat.shape[0]
    side = int(math.sqrt(x_flat.shape[-1]))
    imgs = x_flat.reshape(b, side, side)
    gate = torch.rand((), generator=generator, device=x_flat.device) < apply_prob
    augmented = apply_outline_preserving_augmentations(imgs, generator, prob=prob)
    return torch.where(gate, augmented, imgs).reshape(b, -1)
