"""Top-level hierarchical VAE (``simulgen_vae_tpu/models/vae.py``).

Serving builds it without an encoder (``decode`` and ``generate`` only);
training passes ``num_filter_enc`` and calls :meth:`VAE.forward`: encode,
clamp log_var to +-30, reparameterize (std clamped to [1e-8, 10]), decode
with the hierarchical latents, then the reconstruction loss in the
configured flavor and the always-on MSE monitor (``ops.recon_loss``: on the
card one kernel pass forward, one backward) and the KL terms. Noise comes
from an explicit ``torch.Generator``. ``remat=True`` recomputes the encoder's
and decoder's residual blocks in the backward (``torch.utils.checkpoint``);
none of them draws noise, so both passes see the same values.

On a mesh (``node_group``, ``node_parts`` blocks of the node axis) the VAE
holds this rank's block: ``num_node`` is the block's width, the readout has
``group_count(num_node * node_parts) / node_parts`` whole groups, and the
reconstruction losses are summed over the model axis (each block's mean over
its elements, weighted by its share). ``noise_rows=(start, total)`` marks a
batch that is rows ``start:`` of ``total`` (a block of the data axis).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from simulgen_vae_tpu_torch.losses import kl
from simulgen_vae_tpu_torch.models.blocks import group_count
from simulgen_vae_tpu_torch.models.decoder import Decoder, reparameterize
from simulgen_vae_tpu_torch.models.encoder import Encoder
from simulgen_vae_tpu_torch.ops.recon_loss import recon_loss_pair
from simulgen_vae_tpu_torch.parallel.collectives import sum_over


class VAE(nn.Module):
    def __init__(self, latent_dim: int, hierarchical_dim: int,
                 num_filter_dec: Sequence[int], num_node: int, num_time: int,
                 small: bool = True, device=None, dtype=torch.float32,
                 num_filter_enc: Optional[Sequence[int]] = None,
                 lossfun: str = "MSE", remat: bool = False, node_parts: int = 1,
                 node_group=None):
        super().__init__()
        self.num_node, self.num_time = num_node, num_time
        self.lossfun = lossfun
        self.node_parts, self.node_group = node_parts, node_group
        total = num_node * node_parts
        self.encoder = None
        if num_filter_enc is not None:
            self.encoder = Encoder(latent_dim, hierarchical_dim, num_filter_enc,
                                   num_node, num_time, small, device, dtype, remat,
                                   node_group=node_group)
        self.decoder = Decoder(latent_dim, hierarchical_dim, num_filter_dec,
                               num_node, num_time, small, device, dtype, remat,
                               readout_groups=group_count(total) // node_parts,
                               total_nodes=total, node_group=node_group)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                fused_readout_loss: bool = False, readout_bwd: str = "auto",
                noise_rows: Optional[Tuple[int, int]] = None):
        """``(x_hat, recon_loss, [kl_main, kl_hier...], recon_loss_mse)`` for
        ``x`` [B, T, nodes]; losses are f32 scalars. ``fused_readout_loss``
        (train path) takes the losses from the fused readout kernels: ``x_hat``
        is never written and comes back as None; ``readout_bwd`` picks their
        backward (``ops.readout_chain.readout_chain_loss``)."""
        mu, log_var, xs = self.encode(x)
        log_var = log_var.clamp(-30.0, 30.0)
        std = torch.exp(0.5 * log_var)
        z = reparameterize(mu, std, generator, rows=noise_rows)
        if fused_readout_loss:
            (recon_loss, recon_loss_mse), kl_losses, _ = self.decoder(
                z, xs, generator=generator, x_target=x, lossfun=self.lossfun,
                readout_bwd=readout_bwd)
            x_hat = None
        else:
            x_hat, kl_losses, _ = self.decoder(z, xs, generator=generator,
                                               noise_rows=noise_rows)
            recon_loss, recon_loss_mse = recon_loss_pair(x_hat, x, self.lossfun)
            if self.node_group is not None:  # each block's mean, by its share
                recon_loss = sum_over(recon_loss / self.node_parts, self.node_group)
                recon_loss_mse = sum_over(recon_loss_mse / self.node_parts, self.node_group)
        kl_loss = kl(mu.float(), log_var.float())
        return x_hat, recon_loss, [kl_loss] + list(kl_losses), recon_loss_mse

    def encode(self, x: torch.Tensor):
        """``(mu, log_var, xs)``: the hierarchical posterior parameters."""
        if self.encoder is None:
            raise ValueError("this VAE was built without an encoder (num_filter_enc)")
        return self.encoder(x)

    def decode(self, z: torch.Tensor,
               xs: Optional[Sequence[torch.Tensor]] = None, mode: str = "random",
               frozen_zs: Optional[Sequence[torch.Tensor]] = None,
               generator: Optional[torch.Generator] = None):
        """``(x_hat, kl_losses, zs)``; ``mode='fix'`` is the generation decode."""
        return self.decoder(z, xs, mode=mode, frozen_zs=frozen_zs,
                            generator=generator)

    def generate(self, z: torch.Tensor,
                 xs: Optional[Sequence[torch.Tensor]] = None,
                 generator: Optional[torch.Generator] = None,
                 noise_rows: Optional[Tuple[int, int]] = None,
                 field_out: Optional[tuple] = None) -> torch.Tensor:
        """Conditioner latents -> field ``[B, time, nodes]`` (``mode='fix'``);
        with ``field_out=(min_, scale, out)`` the field descaled into ``out``
        (``Decoder.forward``)."""
        x_hat, _, _ = self.decoder(z, xs, mode="fix", generator=generator,
                                   noise_rows=noise_rows, field_out=field_out)
        return x_hat
