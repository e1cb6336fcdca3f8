"""flax's BatchNorm and ``variance_scaling`` initializers on the port's
tensors, for the image conditioners.

:class:`BatchNorm` is ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` as flax
computes it: the batch's *biased* variance (``E[x^2] - E[x]^2``, clipped at
0) in training, and running statistics updated as ``0.9 * running + 0.1 *
batch`` (``torch.nn.BatchNorm*`` keeps the unbiased variance instead).

Fans are PyTorch's (``[out, in, ...]``: fan_in = in x receptive field,
fan_out = out x receptive field), which equal flax's on the same layer: a
conv kernel ``[kh, kw, in, out]`` and a dense or ``DenseGeneral`` kernel
(initialised flat, ``[in, out]``) count the same axes. Values are drawn on
the CPU from a ``torch.Generator`` and copied to the tensor's device: the
same distributions as JAX's, not the same bits.
"""

from __future__ import annotations

import math

import torch
from torch import nn

BN_MOMENTUM, BN_EPS = 0.9, 1e-5
# std of a unit normal truncated to [-2, 2] (jax.nn.initializers)
_TRUNC_STD = 0.87962566103423978


class BatchNorm(nn.Module):
    """Over axis 1 of an ``[B, C, ...]`` input; the batch's statistics and an
    in-place update of the running ones when ``train``, the running ones
    otherwise."""

    def __init__(self, features: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("mean", torch.zeros(features, device=device))
        self.register_buffer("var", torch.ones(features, device=device))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if train:
            axes = [0, *range(2, x.dim())]
            mean = x.mean(axes)
            var = ((x * x).mean(axes) - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                self.mean.mul_(BN_MOMENTUM).add_((1.0 - BN_MOMENTUM) * mean)
                self.var.mul_(BN_MOMENTUM).add_((1.0 - BN_MOMENTUM) * var)
        else:
            mean, var = self.mean, self.var
        shape = (1, -1) + (1,) * (x.dim() - 2)
        mul = self.weight * torch.rsqrt(var + BN_EPS)
        return (x - mean.reshape(shape)) * mul.reshape(shape) + self.bias.reshape(shape)


@torch.no_grad()
def variance_scaling_(w: torch.Tensor, scale: float, mode: str, distribution: str,
                      generator: torch.Generator) -> torch.Tensor:
    """``jax.nn.initializers.variance_scaling(scale, mode, distribution)``
    into ``w`` in place."""
    fan_in, fan_out = nn.init._calculate_fan_in_and_fan_out(w)
    n = {"fan_in": fan_in, "fan_out": fan_out, "fan_avg": (fan_in + fan_out) / 2}[mode]
    var = scale / max(1.0, n)
    t = torch.empty(w.shape)
    if distribution == "truncated_normal":
        std = math.sqrt(var) / _TRUNC_STD
        nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
    elif distribution == "normal":
        t.normal_(0.0, math.sqrt(var), generator=generator)
    elif distribution == "uniform":
        limit = math.sqrt(3.0 * var)
        t.uniform_(-limit, limit, generator=generator)
    else:
        raise ValueError(f"unknown distribution {distribution!r}")
    return w.copy_(t)


def kaiming_normal_(w, generator):
    """The CNN conditioner's ``variance_scaling(2.0, "fan_out", "normal")``."""
    return variance_scaling_(w, 2.0, "fan_out", "normal", generator)


def lecun_normal_(w, generator):
    """flax's default kernel init."""
    return variance_scaling_(w, 1.0, "fan_in", "truncated_normal", generator)


def xavier_normal_(w, generator):
    return variance_scaling_(w, 1.0, "fan_avg", "truncated_normal", generator)


def xavier_uniform_(w, generator):
    return variance_scaling_(w, 1.0, "fan_avg", "uniform", generator)


@torch.no_grad()
def reset_norms_(model: nn.Module) -> None:
    """Norm scales to 1, their biases and every bias to 0, BatchNorm running
    statistics to mean 0, var 1."""
    for mod in model.modules():
        if isinstance(mod, (nn.GroupNorm, nn.LayerNorm, BatchNorm)):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        if isinstance(mod, BatchNorm):
            mod.mean.zero_()
            mod.var.fill_(1.0)
        if isinstance(mod, (nn.Linear, nn.Conv2d)) and mod.bias is not None:
            mod.bias.zero_()
