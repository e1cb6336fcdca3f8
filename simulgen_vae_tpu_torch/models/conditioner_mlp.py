"""MLP latent conditioner for CSV parameters (``simulgen_vae_tpu/models/conditioner_mlp.py``).

LayerNorm input -> backbone over ``filters`` (first layer Linear + LN + GELU,
then pre-activation residual MLP blocks) -> feature LayerNorm -> two heads
(Linear-LN-GELU x2 -> Linear -> Tanh) for the main latent
``[B, latent_dim_end]`` and the hierarchical latents ``[B, size2, latent_dim]``.

Dropout follows the JAX module's rates: ``dropout_rate x [0.5, 0.7, 1.0,
1.2]`` over the backbone (the stem, then each residual block, whose rate
drops its hidden layer), ``0.8 x`` on the features, ``0.6 x`` and ``0.4 x``
after each head's two hidden layers. As flax's ``Dropout``, a kept unit is
scaled by ``1 / keep``. The masks come from the ``torch.Generator`` passed to
``forward``; without one the forward is deterministic (serving, evaluation).
Dropout has no parameters, so the state dict is the serving one.
LayerNorm uses flax's eps of 1e-6 (PyTorch's default is 1e-5).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from simulgen_vae_tpu_torch.models.blocks import gelu

LN_EPS = 1e-6
DROPOUT_SCHEDULE = (0.5, 0.7, 1.0, 1.2)


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax's ``Dropout``: identity without a generator or at rate 0, zeros at
    rate 1, else each unit kept with probability ``1 - rate`` (a uniform draw
    below it) and scaled by ``1 / (1 - rate)``."""
    if generator is None or rate == 0.0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def _layer_norm(features: int, device) -> nn.LayerNorm:
    return nn.LayerNorm(features, eps=LN_EPS, device=device)


class _MLPResidualBlock(nn.Module):
    def __init__(self, in_features: int, features: int, dropout_rate: float = 0.1,
                 device=None):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.dense0 = nn.Linear(in_features, features, device=device)
        self.norm0 = _layer_norm(features, device)
        self.dense1 = nn.Linear(features, features, device=device)
        self.norm1 = _layer_norm(features, device)
        self.project = None
        if in_features != features:
            self.project = nn.Sequential(
                nn.Linear(in_features, features, device=device),
                _layer_norm(features, device))

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        h = gelu(self.norm0(self.dense0(x)))
        h = dropout(h, self.dropout_rate, generator)
        h = self.norm1(self.dense1(h))
        identity = x if self.project is None else self.project(x)
        return gelu(h + identity)


class _Head(nn.Module):
    def __init__(self, in_features: int, hidden: int, out_dim: int,
                 dropout_rate: float = 0.0, device=None):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.dense0 = nn.Linear(in_features, hidden, device=device)
        self.norm0 = _layer_norm(hidden, device)
        self.dense1 = nn.Linear(hidden, hidden // 2, device=device)
        self.norm1 = _layer_norm(hidden // 2, device)
        self.dense2 = nn.Linear(hidden // 2, out_dim, device=device)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        h = gelu(self.norm0(self.dense0(x)))
        h = dropout(h, self.dropout_rate * 0.6, generator)
        h = gelu(self.norm1(self.dense1(h)))
        h = dropout(h, self.dropout_rate * 0.4, generator)
        return torch.tanh(self.dense2(h))


class LatentConditioner(nn.Module):
    def __init__(self, latent_conditioner_filter: Sequence[int],
                 latent_dim_end: int, input_shape: int, latent_dim: int,
                 size2: int, device=None, dropout_rate: float = 0.3):
        super().__init__()
        filters = list(latent_conditioner_filter)
        self.size2, self.latent_dim = size2, latent_dim
        self.dropout_rate = dropout_rate
        rates = [dropout_rate * DROPOUT_SCHEDULE[min(i, len(DROPOUT_SCHEDULE) - 1)]
                 for i in range(len(filters))]
        self.stem_rate = rates[0]
        self.input_norm = _layer_norm(input_shape, device)
        self.stem = nn.Linear(input_shape, filters[0], device=device)
        self.stem_norm = _layer_norm(filters[0], device)
        self.blocks = nn.ModuleList(
            _MLPResidualBlock(filters[i - 1], filters[i], rates[i], device)
            for i in range(1, len(filters)))
        complexity_ratio = min(8, max(2, input_shape // 64))
        hidden = max(latent_dim_end * 2, filters[-1] // complexity_ratio)
        self.feature_norm = _layer_norm(filters[-1], device)
        self.latent_out = _Head(filters[-1], hidden, latent_dim_end, dropout_rate, device)
        self.xs_out = _Head(filters[-1], hidden, latent_dim * size2, dropout_rate, device)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        """``(latent [B, latent_dim_end], xs [B, size2, latent_dim])``; with a
        ``generator``, in training mode (dropout masks drawn from it)."""
        x = gelu(self.stem_norm(self.stem(self.input_norm(x))))
        x = dropout(x, self.stem_rate, generator)
        for block in self.blocks:
            x = block(x, generator)
        features = dropout(self.feature_norm(x), self.dropout_rate * 0.8, generator)
        latent = self.latent_out(features, generator)
        xs = self.xs_out(features, generator)
        return latent, xs.reshape(-1, self.size2, self.latent_dim)
