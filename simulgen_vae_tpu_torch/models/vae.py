"""Top-level VAE for serving (``simulgen_vae_tpu/models/vae.py``).

This slice carries the decoder only: ``decode`` and ``generate``. The encoder
and the training forward come with the training slice.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from simulgen_vae_tpu_torch.models.decoder import Decoder


class VAE(nn.Module):
    def __init__(self, latent_dim: int, hierarchical_dim: int,
                 num_filter_dec: Sequence[int], num_node: int, num_time: int,
                 small: bool = True, device=None, dtype=torch.float32):
        super().__init__()
        self.num_node, self.num_time = num_node, num_time
        self.decoder = Decoder(latent_dim, hierarchical_dim, num_filter_dec,
                               num_node, num_time, small, device, dtype)

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
