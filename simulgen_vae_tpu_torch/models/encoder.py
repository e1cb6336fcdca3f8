"""Hierarchical encoder over ``[B, T, nodes]`` (``simulgen_vae_tpu/models/encoder.py``).

Per level i: ``ConvBlock`` (its first k=1 conv is the ``nodes -> f0``
embedding at level 0) then ``EncoderResidualBlock``; a per-level Dense
``f_i * T -> hierarchical_dim`` on the channel-major flattened map gives the
hierarchical latent. A final Dense ``f_last * T -> 2 z`` gives (mu, log_var).
Returns ``xs[:-1][::-1]``: the deepest level's latent is dropped and the order
reversed to match the decoder.

On a mesh (``node_group``) ``num_node`` is this rank's block of the node
axis: the embedding's partial products are summed over the model axis and
every later layer is replicated.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from simulgen_vae_tpu_torch.models.blocks import (
    ConvBlock,
    Dense,
    EncoderResidualBlock,
    flatten_channels_first,
)


class Encoder(nn.Module):
    def __init__(self, z_dim: int, hierarchical_dim: int, num_filter_enc: Sequence[int],
                 num_node: int, num_time: int, small: bool = True, device=None,
                 dtype=torch.float32, remat: bool = False, node_group=None):
        super().__init__()
        f = list(num_filter_enc)
        self.z_dim = z_dim
        self.remat = remat  # recompute each conv and residual block in the backward
        self.enc_block = nn.ModuleList(
            ConvBlock(c_in, c, small, device, dtype)
            for c_in, c in zip([num_node] + f[:-1], f))
        self.enc_block[0].convs[0].node_group = node_group  # the node embedding
        self.enc_res = nn.ModuleList(
            EncoderResidualBlock(c, small, device, dtype) for c in f)
        self.xs_linear = nn.ModuleList(
            Dense(c * num_time, hierarchical_dim, device, dtype) for c in f)
        self.last_x_linear = Dense(f[-1] * num_time, 2 * z_dim, device, dtype)

    def forward(self, x: torch.Tensor):
        """``(mu, log_var, xs)`` for ``x`` [B, T, nodes]."""
        xs = []
        for block, res, head in zip(self.enc_block, self.enc_res, self.xs_linear):
            if self.remat and torch.is_grad_enabled():
                x = checkpoint(block, x, use_reentrant=False)
                x = checkpoint(res, x, use_reentrant=False)
            else:
                x = res(block(x))
            xs.append(head(flatten_channels_first(x)))
        last = self.last_x_linear(flatten_channels_first(x))
        return last[:, :self.z_dim], last[:, self.z_dim:], xs[:-1][::-1]
