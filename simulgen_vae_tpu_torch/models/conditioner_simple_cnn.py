"""Small CNN latent conditioner for image inputs
(``simulgen_vae_tpu/models/conditioner_simple_cnn.py``).

Three stages of Conv (k = 7, 5, 3 to 16, 32, 64 channels, no bias, "same"
padding) -> BatchNorm -> exact GELU -> channel dropout 0.3 -> 2x2 max-pool
(VALID), a global average pool, a 64 -> 128 -> 64 GELU MLP with dropout, and
two linear heads. Xavier-uniform kernels. NCHW with conv weights ``[out, in,
kh, kw]`` (``convert.py`` carries flax's HWIO across); the BatchNorms are
flax's (``models.flax_layers.BatchNorm``). The channel dropout is flax's
``Dropout(broadcast_dims=(1, 2))``: one mask ``[B, C, 1, 1]`` a stage.
``latent_conditioner_filter`` is accepted for the JAX signature and unused.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from simulgen_vae_tpu_torch.models.blocks import gelu
from simulgen_vae_tpu_torch.models.conditioner_cnn import image_batch
from simulgen_vae_tpu_torch.models.conditioner_mlp import dropout
from simulgen_vae_tpu_torch.models.flax_layers import BatchNorm, reset_norms_, xavier_uniform_

STAGES = ((16, 7), (32, 5), (64, 3))
CHANNEL_DROPOUT = 0.3


def channel_dropout(x: torch.Tensor, rate: float,
                    generator: Optional[torch.Generator]) -> torch.Tensor:
    """Dropout of whole channels: one kept-or-dropped draw per (sample,
    channel), applied to every pixel, kept ones scaled by ``1 / (1 - rate)``."""
    if generator is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape[:2] + (1, 1), generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


class SimpleLatentConditionerImg(nn.Module):
    def __init__(self, latent_conditioner_filter: Sequence[int], latent_dim_end: int,
                 latent_dim: int, size2: int, dropout_rate: float = 0.5, device=None):
        super().__init__()
        self.latent_dim, self.size2 = latent_dim, size2
        self.dropout_rate = dropout_rate
        cin = 1
        convs, norms = [], []
        for ch, k in STAGES:
            convs.append(nn.Conv2d(cin, ch, k, padding=k // 2, bias=False, device=device))
            norms.append(BatchNorm(ch, device))
            cin = ch
        self.convs, self.norms = nn.ModuleList(convs), nn.ModuleList(norms)
        self.dense0 = nn.Linear(64, 128, device=device)
        self.dense1 = nn.Linear(128, 64, device=device)
        self.latent_main = nn.Linear(64, latent_dim_end, device=device)
        self.xs = nn.Linear(64, latent_dim * size2, device=device)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                train: Optional[bool] = None):
        """``(latent [B, latent_dim_end], xs [B, size2, latent_dim])``; ``train``
        (default: whether a generator was passed) uses the batch's statistics."""
        train = generator is not None if train is None else train
        x = image_batch(x)
        for conv, norm in zip(self.convs, self.norms):
            x = channel_dropout(gelu(norm(conv(x), train)), CHANNEL_DROPOUT, generator)
            x = F.max_pool2d(x, 2, 2)
        x = dropout(x.mean((2, 3)), self.dropout_rate, generator)
        x = dropout(gelu(self.dense0(x)), self.dropout_rate, generator)
        features = dropout(gelu(self.dense1(x)), self.dropout_rate * 0.8, generator)
        xs = self.xs(features)
        return self.latent_main(features), xs.reshape(-1, self.size2, self.latent_dim)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "SimpleLatentConditionerImg":
        """Xavier-uniform kernels, zero biases, unit norms (the JAX module's)."""
        for mod in self.modules():
            if isinstance(mod, (nn.Linear, nn.Conv2d)):
                xavier_uniform_(mod.weight, generator)
        reset_norms_(self)
        return self
