"""Top-level hierarchical VAE (``simulgen_vae_tpu/models/vae.py``).

Serving builds it without an encoder (``decode`` and ``generate`` only);
training passes ``num_filter_enc`` and calls :meth:`VAE.forward`: encode,
clamp log_var to +-30, reparameterize (std clamped to [1e-8, 10]), decode
with the hierarchical latents, then the reconstruction loss in the
configured flavor, the always-on MSE monitor and the KL terms. Noise comes
from an explicit ``torch.Generator``. ``remat=True`` recomputes the encoder's
and decoder's residual blocks in the backward (``torch.utils.checkpoint``);
none of them draws noise, so both passes see the same values.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from simulgen_vae_tpu_torch.losses import kl, make_recon_loss_pair
from simulgen_vae_tpu_torch.models.decoder import Decoder, reparameterize
from simulgen_vae_tpu_torch.models.encoder import Encoder


class VAE(nn.Module):
    def __init__(self, latent_dim: int, hierarchical_dim: int,
                 num_filter_dec: Sequence[int], num_node: int, num_time: int,
                 small: bool = True, device=None, dtype=torch.float32,
                 num_filter_enc: Optional[Sequence[int]] = None,
                 lossfun: str = "MSE", remat: bool = False):
        super().__init__()
        self.num_node, self.num_time = num_node, num_time
        self.lossfun = lossfun
        self.encoder = None
        if num_filter_enc is not None:
            self.encoder = Encoder(latent_dim, hierarchical_dim, num_filter_enc,
                                   num_node, num_time, small, device, dtype, remat)
        self.decoder = Decoder(latent_dim, hierarchical_dim, num_filter_dec,
                               num_node, num_time, small, device, dtype, remat)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                fused_readout_loss: bool = False, readout_bwd: str = "auto"):
        """``(x_hat, recon_loss, [kl_main, kl_hier...], recon_loss_mse)`` for
        ``x`` [B, T, nodes]; losses are f32 scalars. ``fused_readout_loss``
        (train path) takes the losses from the fused readout kernels: ``x_hat``
        is never written and comes back as None; ``readout_bwd`` picks their
        backward (``ops.readout_chain.readout_chain_loss``)."""
        mu, log_var, xs = self.encode(x)
        log_var = log_var.clamp(-30.0, 30.0)
        z = reparameterize(mu, torch.exp(0.5 * log_var), generator)
        if fused_readout_loss:
            (recon_loss, recon_loss_mse), kl_losses, _ = self.decoder(
                z, xs, generator=generator, x_target=x, lossfun=self.lossfun,
                readout_bwd=readout_bwd)
            x_hat = None
        else:
            x_hat, kl_losses, _ = self.decoder(z, xs, generator=generator)
            recon_loss, recon_loss_mse = make_recon_loss_pair(self.lossfun)(x_hat, x)
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
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Conditioner latents -> field ``[B, time, nodes]`` (``mode='fix'``)."""
        x_hat, _, _ = self.decoder(z, xs, mode="fix", generator=generator)
        return x_hat
