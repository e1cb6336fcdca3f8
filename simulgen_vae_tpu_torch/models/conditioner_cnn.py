"""CNN latent conditioner for image inputs (``simulgen_vae_tpu/models/conditioner_cnn.py``).

A ResNet bottleneck backbone with GroupNorm, squeeze-and-excitation and
spatial attention on blocks 2-4, global average pooling, two fully connected
layers with LayerNorm, then two prediction heads (SN Linear -> BatchNorm ->
ReLU -> Dropout, twice, plus a skip projection) for the main latent
``[B, latent_dim_end]`` and the hierarchical latents ``[B, size2,
latent_dim]``.

The port computes in NCHW with conv weights ``[out, in, kh, kw]``;
``convert.py`` carries flax's HWIO kernels across. A flat input ``[B, H*W]``
has the same memory order in both layouts (one channel).

Layers whose name has a part starting with ``sn_`` are the spectrally
normalised ones (:func:`sn_filter`, JAX's filter on parameter paths). The
norms follow flax, not PyTorch: the heads' BatchNorms are
``models.flax_layers.BatchNorm``, LayerNorm's epsilon is 1e-6 and
GroupNorm's 1e-5. Dropout masks come from the ``torch.Generator`` passed to
``forward``; ``train`` (default: whether a generator was passed) puts the
BatchNorms in training mode.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from simulgen_vae_tpu_torch.models.conditioner_mlp import dropout
from simulgen_vae_tpu_torch.models.flax_layers import (
    BatchNorm,
    kaiming_normal_,
    lecun_normal_,
    reset_norms_,
    xavier_normal_,
)

GN_EPS, LN_EPS = 1e-5, 1e-6


def sn_filter(name: str) -> bool:
    """True for a parameter of a spectrally normalised layer: a part of its
    dotted name starts with ``sn_``."""
    return any(part.startswith("sn_") for part in name.split("."))


def cnn_groups(channels: int) -> int:
    """The largest of 32, 16, 8, 4, 2, 1 dividing ``channels``."""
    for g in (32, 16, 8, 4, 2, 1):
        if channels % g == 0:
            return g
    return 1


def _group_norm(channels: int, device) -> nn.GroupNorm:
    return nn.GroupNorm(cnn_groups(channels), channels, eps=GN_EPS, device=device)


def image_batch(x: torch.Tensor) -> torch.Tensor:
    """``[B, H*W]`` (square) or ``[B, H, W]`` -> ``[B, 1, H, W]``; 4-D
    inputs pass as they are."""
    if x.dim() == 2:
        side = int(math.sqrt(x.shape[-1]))
        return x.reshape(x.shape[0], 1, side, side)
    if x.dim() == 3:
        return x[:, None]
    return x


class SqueezeExcitation(nn.Module):
    """Channel attention: mean over H, W -> Dense -> ReLU -> Dense -> sigmoid."""

    def __init__(self, channels: int, reduction: int = 16, device=None):
        super().__init__()
        hidden = max(channels // reduction, 1)
        self.fc1 = nn.Linear(channels, hidden, device=device)
        self.fc2 = nn.Linear(hidden, channels, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.sigmoid(self.fc2(F.relu(self.fc1(x.mean((2, 3))))))
        return x * y[:, :, None, None]


class SpatialAttention(nn.Module):
    """Spatial attention: a 7x7 conv over the channel mean and max, sigmoid."""

    def __init__(self, kernel_size: int = 7, device=None):
        super().__init__()
        self.conv = nn.Conv2d(2, 1, kernel_size, padding=kernel_size // 2, bias=False,
                              device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        attn = torch.cat([x.mean(1, keepdim=True), x.amax(1, keepdim=True)], dim=1)
        return x * torch.sigmoid(self.conv(attn))


class ResNetBlock(nn.Module):
    """Bottleneck block: 1x1 conv to ``out // 2``, GroupNorm, ReLU, 3x3 conv
    (stride here), GroupNorm, optional SE (+ spatial) attention; a 1x1 conv
    + GroupNorm skip where the shape changes; ReLU of the sum."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 use_attention: bool = True, use_spatial: bool = False, device=None):
        super().__init__()
        mid = out_channels // 2
        self.sn_conv1 = nn.Conv2d(in_channels, mid, 1, bias=False, device=device)
        self.norm1 = _group_norm(mid, device)
        self.sn_conv2 = nn.Conv2d(mid, out_channels, 3, stride, padding=1, bias=False,
                                  device=device)
        self.norm2 = _group_norm(out_channels, device)
        self.se = SqueezeExcitation(out_channels, device=device) if use_attention else None
        self.spatial = SpatialAttention(device=device) if use_attention and use_spatial else None
        self.sn_skip = self.skip_norm = None
        if stride != 1 or in_channels != out_channels:
            self.sn_skip = nn.Conv2d(in_channels, out_channels, 1, stride, bias=False,
                                     device=device)
            self.skip_norm = _group_norm(out_channels, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.norm1(self.sn_conv1(x)))
        h = self.norm2(self.sn_conv2(h))
        if self.se is not None:
            h = self.se(h)
        if self.spatial is not None:
            h = self.spatial(h)
        skip = x if self.sn_skip is None else self.skip_norm(self.sn_skip(x))
        return F.relu(h + skip)


class BNHead(nn.Module):
    """A head stage: SN Linear -> BatchNorm -> ReLU -> Dropout."""

    def __init__(self, in_features: int, features: int, dropout_rate: float, device=None):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.sn_linear = nn.Linear(in_features, features, device=device)
        self.norm = BatchNorm(features, device)

    def forward(self, x, generator=None, train: bool = False):
        return dropout(F.relu(self.norm(self.sn_linear(x), train)), self.dropout_rate,
                       generator)


class _Head(nn.Module):
    def __init__(self, hidden: int, out_dim: int, dropout_rate: float, device=None):
        super().__init__()
        self.layer1 = BNHead(hidden, hidden // 2, dropout_rate * 0.3, device)
        self.layer2 = BNHead(hidden // 2, hidden // 4, 0.2, device)
        self.skip_proj = nn.Linear(hidden, hidden // 4, device=device)
        self.output = nn.Linear(hidden // 4, out_dim, device=device)

    def forward(self, features, generator=None, train: bool = False):
        a = self.layer2(self.layer1(features, generator, train), generator, train)
        return self.output(a + self.skip_proj(features))


class LatentConditionerImg(nn.Module):
    def __init__(self, latent_conditioner_filter: Sequence[int], latent_dim_end: int,
                 latent_dim: int, size2: int, dropout_rate: float = 0.3,
                 use_attention: bool = True, device=None):
        super().__init__()
        f = list(latent_conditioner_filter)
        self.filters, self.use_attention = f, use_attention
        self.latent_dim_end, self.latent_dim, self.size2 = latent_dim_end, latent_dim, size2
        self.dropout_rate = dropout_rate
        self.sn_initial_conv = nn.Conv2d(1, f[0], 7, padding=3, bias=False, device=device)
        self.norm0 = _group_norm(f[0], device)
        blocks = []
        for i, (cin, cout) in enumerate(zip(f[:-1], f[1:])):
            use_se = use_attention and 2 <= i <= 4
            blocks.append(ResNetBlock(cin, cout, 2 if i in (1, 3) else 1, use_se,
                                      use_spatial=use_se, device=device))
        self.layers = nn.ModuleList(blocks)
        hidden = f[-1] * 2
        self.sn_fp1 = nn.Linear(f[-1], hidden, device=device)
        self.ln1 = nn.LayerNorm(hidden, eps=LN_EPS, device=device)
        self.sn_fp2 = nn.Linear(hidden, hidden, device=device)
        self.ln2 = nn.LayerNorm(hidden, eps=LN_EPS, device=device)
        self.latent_main = _Head(hidden, latent_dim_end, dropout_rate, device)
        self.xs = _Head(hidden, latent_dim * size2, dropout_rate, device)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                train: Optional[bool] = None):
        """``(latent [B, latent_dim_end], xs [B, size2, latent_dim])``."""
        train = generator is not None if train is None else train
        x = image_batch(x)
        # [-1, 1] -> [0, 1] when the batch looks signed: one minimum over the
        # whole batch, as JAX's
        x = torch.where(x.min() < -0.1, (x + 1.0) / 2.0, x)
        h = F.relu(self.norm0(self.sn_initial_conv(x)))
        h = F.max_pool2d(h, 3, 2, 1)
        for block in self.layers:
            h = block(h)
        h = dropout(h.mean((2, 3)), self.dropout_rate * 0.3, generator)
        h = dropout(F.relu(self.ln1(self.sn_fp1(h))), self.dropout_rate * 0.4, generator)
        features = dropout(F.relu(self.ln2(self.sn_fp2(h))), self.dropout_rate * 0.4,
                           generator)
        latent = self.latent_main(features, generator, train)
        xs = self.xs(features, generator, train)
        return latent, xs.reshape(-1, self.size2, self.latent_dim)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "LatentConditionerImg":
        """The JAX module's init: ``sn_*`` and skip-projection kernels
        ``variance_scaling(2, fan_out, normal)``, the outputs Xavier normal,
        the attention layers flax's default (LeCun normal); zero biases, unit
        norms."""
        for name, mod in self.named_modules():
            if not isinstance(mod, (nn.Linear, nn.Conv2d)):
                continue
            last = name.rsplit(".", 1)[-1]
            if last.startswith("sn_") or last == "skip_proj":
                kaiming_normal_(mod.weight, generator)
            elif last == "output":
                xavier_normal_(mod.weight, generator)
            else:
                lecun_normal_(mod.weight, generator)
        reset_norms_(self)
        return self
