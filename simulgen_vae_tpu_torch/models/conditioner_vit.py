"""Vision-Transformer latent conditioner for image inputs
(``simulgen_vae_tpu/models/conditioner_vit.py``).

Patchify (16 x 16) -> linear embedding + learned positions
(``pos_embed [1, gh * gw, 256]``) -> ``depth`` pre-LN transformer blocks
(multi-head self-attention, then a GELU MLP of ratio 4) -> LayerNorm -> mean
over the tokens -> two linear heads.

The attention is written out, as flax's ``MultiHeadDotProductAttention``
computes it: q scaled by ``1 / sqrt(head_dim)``, a softmax over the keys and
attention dropout **broadcast** over the batch and the heads (one mask
``[1, 1, q, k]``, flax's ``broadcast_dropout=True``). q, k, v and the output
projection are ``nn.Linear`` over ``heads * head_dim``: ``convert.py`` maps
flax's ``[in, heads, head_dim]`` and ``[heads, head_dim, out]`` kernels onto
them. LayerNorm epsilon 1e-6 (flax's). Dropout masks come from the
``torch.Generator`` passed to ``forward``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from simulgen_vae_tpu_torch.models.blocks import gelu
from simulgen_vae_tpu_torch.models.conditioner_cnn import image_batch
from simulgen_vae_tpu_torch.models.conditioner_mlp import dropout
from simulgen_vae_tpu_torch.models.flax_layers import lecun_normal_, reset_norms_

LN_EPS = 1e-6


class SelfAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, dropout_rate: float = 0.0, device=None):
        super().__init__()
        self.num_heads, self.head_dim = num_heads, dim // num_heads
        self.dropout_rate = dropout_rate
        self.query = nn.Linear(dim, dim, device=device)
        self.key = nn.Linear(dim, dim, device=device)
        self.value = nn.Linear(dim, dim, device=device)
        self.out = nn.Linear(dim, dim, device=device)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        b, n, _ = x.shape

        def heads(layer):  # [B, N, dim] -> [B, heads, N, head_dim]
            return layer(x).reshape(b, n, self.num_heads, self.head_dim).transpose(1, 2)

        q = heads(self.query) / math.sqrt(self.head_dim)
        weights = torch.softmax(q @ heads(self.key).transpose(-1, -2), dim=-1)
        if generator is not None and self.dropout_rate > 0.0:
            keep = 1.0 - self.dropout_rate
            mask = torch.rand((1, 1, n, n), generator=generator, device=x.device) < keep
            weights = weights * (mask.to(weights.dtype) / keep)
        h = (weights @ heads(self.value)).transpose(1, 2).reshape(b, n, -1)
        return self.out(h)


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: int = 4,
                 dropout_rate: float = 0.0, device=None):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.ln1 = nn.LayerNorm(dim, eps=LN_EPS, device=device)
        self.attn = SelfAttention(dim, num_heads, dropout_rate, device)
        self.ln2 = nn.LayerNorm(dim, eps=LN_EPS, device=device)
        self.fc1 = nn.Linear(dim, dim * mlp_ratio, device=device)
        self.fc2 = nn.Linear(dim * mlp_ratio, dim, device=device)

    def forward(self, x, generator=None):
        x = x + self.attn(self.ln1(x), generator)
        h = dropout(gelu(self.fc1(self.ln2(x))), self.dropout_rate, generator)
        return x + self.fc2(h)


class LatentConditionerViT(nn.Module):
    def __init__(self, latent_dim_end: int, latent_dim: int, size2: int,
                 patch_size: int = 16, embed_dim: int = 256, depth: int = 6,
                 num_heads: int = 8, dropout_rate: float = 0.1, image_side: int = 256,
                 device=None):
        super().__init__()
        self.latent_dim, self.size2 = latent_dim, size2
        self.patch_size, self.num_heads = patch_size, num_heads
        self.dropout_rate = dropout_rate
        tokens = (image_side // patch_size) ** 2
        self.patch_embed = nn.Linear(patch_size * patch_size, embed_dim, device=device)
        self.pos_embed = nn.Parameter(torch.zeros(1, tokens, embed_dim, device=device))
        self.blocks = nn.ModuleList(
            TransformerBlock(embed_dim, num_heads, dropout_rate=dropout_rate, device=device)
            for _ in range(depth))
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS, device=device)
        self.latent_main_head = nn.Linear(embed_dim, latent_dim_end, device=device)
        self.xs_head = nn.Linear(embed_dim, latent_dim * size2, device=device)

    def patchify(self, x: torch.Tensor) -> torch.Tensor:
        """``[B, 1, H, W]`` -> ``[B, gh * gw, p * p]``, patches in row-major
        order, each patch's pixels row-major (JAX's ``(0, 1, 3, 2, 4, 5)``)."""
        b, c, hgt, wid = x.shape
        p = self.patch_size
        gh, gw = hgt // p, wid // p
        x = x[:, :, : gh * p, : gw * p].permute(0, 2, 3, 1)          # NHWC
        x = x.reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(b, gh * gw, p * p * c)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                train: Optional[bool] = None):
        """``(latent [B, latent_dim_end], xs [B, size2, latent_dim])``; with a
        ``generator``, dropout on (``train`` is accepted for the other image
        conditioners' signature: the ViT has no BatchNorm)."""
        tokens = self.patch_embed(self.patchify(image_batch(x))) + self.pos_embed
        tokens = dropout(tokens, self.dropout_rate, generator)
        for block in self.blocks:
            tokens = block(tokens, generator)
        feats = self.norm(tokens).mean(1)
        xs = self.xs_head(feats)
        return self.latent_main_head(feats), xs.reshape(-1, self.size2, self.latent_dim)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "LatentConditionerViT":
        """flax's defaults (LeCun-normal kernels, zero biases, unit norms) and
        ``pos_embed`` from ``normal(0, 0.02)``."""
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                lecun_normal_(mod.weight, generator)
        reset_norms_(self)
        self.pos_embed.copy_(torch.empty(self.pos_embed.shape).normal_(
            0.0, 0.02, generator=generator))
        return self
