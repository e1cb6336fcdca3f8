"""Hierarchical decoder over ``[B, T, C]`` maps (``simulgen_vae_tpu/models/decoder.py``).

Per level i (of ``L - 1`` levels, L = len(num_filter_dec)):

* i == 0: ``z_sample = sequence_start(z)``; i > 0: ``z_sample = decoder_out + z``.
* ``DecoderBlock`` (3-tap conv + GELU), then ``DecoderResidualBlock``.
* Between levels (not after the last): the prior head ``condition_z`` gives
  (mu, log_var); with hierarchical latents ``xs``, the injection head
  ``xs_sequence`` + ``condition_xz`` gives (delta_mu, delta_log_var), a
  ``kl_2`` term, and the posterior (mu + delta_mu, log_var + delta_log_var);
  then z is sampled.
* Readout: k=1 conv to the nodes, GroupNorm + Tanh.

``mode='fix'`` multiplies std by 1e-10 before the [1e-8, 10] clamp: the decode
still draws noise, at std 1e-8 while log_var < 2 ln 100. ``frozen_zs`` reuses
the ``zs`` of an earlier call. Noise comes from an explicit ``torch.Generator``.
Spectral norm reaches each conv, dense and readout layer through its
``inv_sigma`` attribute (``models.spectral_norm.attach_inv_sigmas``); the
decoder itself passes nothing.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from simulgen_vae_tpu_torch.losses import kl_2
from simulgen_vae_tpu_torch.models.blocks import (
    Conv1d,
    DecoderBlock,
    DecoderResidualBlock,
    Dense,
    FusedPointwiseNormTanh,
    NormAct,
    ResidualBlock,
    gelu,
)


def reparameterize(mu: torch.Tensor, std: torch.Tensor,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """z = mu + eps * std with std clamped to [1e-8, 10]."""
    std = std.clamp(1e-8, 10.0)
    eps = torch.randn(std.shape, generator=generator, device=mu.device,
                      dtype=mu.dtype)
    return mu + eps * std


class _LatentInjector(nn.Module):
    """Dense(h -> h*T) -> [B, T, h] -> Conv k=5 -> GN -> GELU.

    The dense output unflattens channel-major (``[B, h, T]``, as the torch
    reference's ``Unflatten``) and is transposed to ``[B, T, h]``.
    """

    def __init__(self, latent_dim: int, features: int, num_time: int,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.latent_dim, self.num_time = latent_dim, num_time
        self.dense = Dense(latent_dim, latent_dim * num_time, device, dtype)
        self.conv = Conv1d(latent_dim, features, 5, device, dtype)
        self.norm = NormAct(features, "gelu", device)

    def forward(self, v: torch.Tensor) -> torch.Tensor:
        h = self.dense(v).reshape(v.shape[0], self.latent_dim, self.num_time)
        return self.norm(self.conv(h.transpose(1, 2)))


class _ConditionHead(nn.Module):
    """ResidualBlock -> GELU -> Conv k=3 producing 2 * features channels."""

    def __init__(self, in_features: int, features: int, small: bool = True,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.res = ResidualBlock(in_features, small, device, dtype)
        self.conv = Conv1d(in_features, 2 * features, 3, device, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(gelu(self.res(x)))


class Decoder(nn.Module):
    def __init__(self, z_dim: int, hierarchical_dim: int,
                 num_filter_dec: Sequence[int], num_node: int, num_time: int,
                 small: bool = True, device=None, dtype=torch.float32,
                 remat: bool = False):
        super().__init__()
        f = list(num_filter_dec)
        n = len(f) - 1
        self.n_levels = n
        self.remat = remat  # recompute each residual block in the backward
        self.sequence_start = _LatentInjector(z_dim, f[0], num_time, device, dtype)
        self.dec_block = nn.ModuleList(
            DecoderBlock(f[i], f[i + 1], device, dtype) for i in range(n))
        self.dec_res = nn.ModuleList(
            DecoderResidualBlock(f[i + 1], small, device, dtype) for i in range(n))
        # Heads between levels only: the last level conditions nothing.
        self.condition_z = nn.ModuleList(
            _ConditionHead(f[i + 1], f[i + 1], small, device, dtype)
            for i in range(n - 1))
        self.xs_sequence = nn.ModuleList(
            _LatentInjector(hierarchical_dim, f[i + 1], num_time, device, dtype)
            for i in range(n - 1))
        self.condition_xz = nn.ModuleList(
            _ConditionHead(2 * f[i + 1], f[i + 1], small, device, dtype)
            for i in range(n - 1))
        self.recon = FusedPointwiseNormTanh(f[-1], num_node, device=device,
                                            dtype=dtype)

    def forward(self, z: torch.Tensor,
                xs: Optional[Sequence[torch.Tensor]] = None,
                mode: str = "random",
                frozen_zs: Optional[Sequence[torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None,
                x_target: Optional[torch.Tensor] = None, lossfun: str = "MSE",
                readout_bwd: str = "auto"):
        """Returns ``(x_hat [B, T, nodes], kl_losses, zs)``; with ``x_target``
        the fused train-path readout returns ``(recon_loss, recon_mse)`` in
        place of ``x_hat``, with the backward ``readout_bwd`` names."""
        kl_losses, zs = [], []
        decoder_out = None
        for i in range(self.n_levels):
            z_sample = self.sequence_start(z) if i == 0 else decoder_out + z
            decoder_out = self.dec_block[i](z_sample)
            if self.remat and torch.is_grad_enabled():
                # no noise is drawn inside a residual block: both passes agree
                decoder_out = checkpoint(self.dec_res[i], decoder_out, use_reentrant=False)
            else:
                decoder_out = self.dec_res[i](decoder_out)
            if i == self.n_levels - 1:
                break

            mu, log_var = self.condition_z[i](decoder_out).chunk(2, dim=-1)
            if xs is not None:
                xs_sample = self.xs_sequence[i](xs[i])
                cond_xz = self.condition_xz[i](
                    torch.cat([xs_sample, decoder_out], dim=-1))
                delta_mu, delta_log_var = cond_xz.chunk(2, dim=-1)
                kl_losses.append(kl_2(delta_mu, delta_log_var, mu, log_var))
                mu = mu + delta_mu
                log_var = log_var + delta_log_var

            std = torch.exp(0.5 * log_var.clamp(-30.0, 30.0))
            if mode == "fix":
                std = std * 1e-10  # clamps to exactly 1e-8 in reparameterize
            if frozen_zs is not None and i < len(frozen_zs):
                z = frozen_zs[i]
            else:
                z = reparameterize(mu, std, generator)
            zs.append(z)

        out = self.recon(decoder_out, x_target=x_target, lossfun=lossfun,
                         readout_bwd=readout_bwd)
        return out, kl_losses, zs
