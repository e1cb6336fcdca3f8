"""MLP latent conditioner for CSV parameters (``simulgen_vae_tpu/models/conditioner_mlp.py``).

LayerNorm input -> backbone over ``filters`` (first layer Linear + LN + GELU,
then pre-activation residual MLP blocks) -> feature LayerNorm -> two heads
(Linear-LN-GELU x2 -> Linear -> Tanh) for the main latent
``[B, latent_dim_end]`` and the hierarchical latents ``[B, size2, latent_dim]``.

Serving runs deterministically, so the dropout layers of the JAX module are
identities and carry no module here. LayerNorm uses flax's eps of 1e-6
(PyTorch's default is 1e-5).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from simulgen_vae_tpu_torch.models.blocks import gelu

LN_EPS = 1e-6


def _layer_norm(features: int, device) -> nn.LayerNorm:
    return nn.LayerNorm(features, eps=LN_EPS, device=device)


class _MLPResidualBlock(nn.Module):
    def __init__(self, in_features: int, features: int, device=None):
        super().__init__()
        self.dense0 = nn.Linear(in_features, features, device=device)
        self.norm0 = _layer_norm(features, device)
        self.dense1 = nn.Linear(features, features, device=device)
        self.norm1 = _layer_norm(features, device)
        self.project = None
        if in_features != features:
            self.project = nn.Sequential(
                nn.Linear(in_features, features, device=device),
                _layer_norm(features, device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = gelu(self.norm0(self.dense0(x)))
        h = self.norm1(self.dense1(h))
        identity = x if self.project is None else self.project(x)
        return gelu(h + identity)


class _Head(nn.Module):
    def __init__(self, in_features: int, hidden: int, out_dim: int, device=None):
        super().__init__()
        self.dense0 = nn.Linear(in_features, hidden, device=device)
        self.norm0 = _layer_norm(hidden, device)
        self.dense1 = nn.Linear(hidden, hidden // 2, device=device)
        self.norm1 = _layer_norm(hidden // 2, device)
        self.dense2 = nn.Linear(hidden // 2, out_dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = gelu(self.norm0(self.dense0(x)))
        h = gelu(self.norm1(self.dense1(h)))
        return torch.tanh(self.dense2(h))


class LatentConditioner(nn.Module):
    def __init__(self, latent_conditioner_filter: Sequence[int],
                 latent_dim_end: int, input_shape: int, latent_dim: int,
                 size2: int, device=None):
        super().__init__()
        filters = list(latent_conditioner_filter)
        self.size2, self.latent_dim = size2, latent_dim
        self.input_norm = _layer_norm(input_shape, device)
        self.stem = nn.Linear(input_shape, filters[0], device=device)
        self.stem_norm = _layer_norm(filters[0], device)
        self.blocks = nn.ModuleList(
            _MLPResidualBlock(filters[i - 1], filters[i], device)
            for i in range(1, len(filters)))
        complexity_ratio = min(8, max(2, input_shape // 64))
        hidden = max(latent_dim_end * 2, filters[-1] // complexity_ratio)
        self.feature_norm = _layer_norm(filters[-1], device)
        self.latent_out = _Head(filters[-1], hidden, latent_dim_end, device)
        self.xs_out = _Head(filters[-1], hidden, latent_dim * size2, device)

    def forward(self, x: torch.Tensor):
        """``(latent [B, latent_dim_end], xs [B, size2, latent_dim])``."""
        x = gelu(self.stem_norm(self.stem(self.input_norm(x))))
        for block in self.blocks:
            x = block(x)
        features = self.feature_norm(x)
        xs = self.xs_out(features)
        return self.latent_out(features), xs.reshape(-1, self.size2, self.latent_dim)
