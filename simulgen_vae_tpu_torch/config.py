"""Model configuration the serving slice reads (``simulgen_vae_tpu/config.py``).

Only the geometry fields. Parsing ``condition.txt`` and ``preset.txt`` comes
with the CLI slice.
"""

from __future__ import annotations

import dataclasses
from typing import List


@dataclasses.dataclass
class VAEConfig:
    num_time: int = 50
    num_node: int = 2048
    latent_dim_end: int = 32          # main latent (z)
    latent_dim: int = 8               # hierarchical latent
    num_filter_enc: List[int] = dataclasses.field(
        default_factory=lambda: [1024, 512, 256, 128])
    small: bool = True

    @property
    def num_filter_dec(self) -> List[int]:
        """Decoder filters are the encoder filters reversed."""
        return self.num_filter_enc[::-1]

    @property
    def num_hier(self) -> int:
        """Number of hierarchical latents (= size2)."""
        return len(self.num_filter_enc) - 1


@dataclasses.dataclass
class LCConfig:
    """Latent-conditioner configuration; this slice serves the CSV (MLP) one."""

    filters: List[int] = dataclasses.field(
        default_factory=lambda: [32, 64, 128, 256, 512, 1024])
    input_type: str = "csv"
