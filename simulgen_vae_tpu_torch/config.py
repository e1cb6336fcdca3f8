"""Model and training configuration (``simulgen_vae_tpu/config.py``).

The geometry and training fields of ``VAEConfig`` and the card's counterpart
of ``resolve_perf_stack``. Parsing ``condition.txt`` and ``preset.txt`` comes
with the CLI slice.
"""

from __future__ import annotations

import dataclasses
from typing import List

import torch


@dataclasses.dataclass
class VAEConfig:
    num_param: int = 16
    num_time: int = 50
    num_node: int = 2048
    latent_dim_end: int = 32          # main latent (z)
    latent_dim: int = 8               # hierarchical latent
    num_filter_enc: List[int] = dataclasses.field(
        default_factory=lambda: [1024, 512, 256, 128])
    small: bool = True

    # Training
    n_epochs: int = 100
    batch_size: int = 16
    lr: float = 1e-3
    alpha: float = 1e6
    loss_type: str = "MSE"            # MSE | MAE | smoothL1 | Huber
    recon_iter: int = 1

    # Numerics
    dtype: str = "float32"            # compute dtype: float32 | bfloat16
    use_spectral_norm: bool = True
    remat: bool = False               # gradient checkpointing (not ported)
    # AdamW moment storage: "auto" | "float32" ("bfloat16" is TPU-only so far)
    opt_state_dtype: str = "auto"
    # Spectral-norm power-iteration refresh: "auto" | "step" ("epoch" not ported)
    sn_cadence: str = "auto"

    @property
    def num_filter_dec(self) -> List[int]:
        """Decoder filters are the encoder filters reversed."""
        return self.num_filter_enc[::-1]

    @property
    def num_hier(self) -> int:
        """Number of hierarchical latents (= size2)."""
        return len(self.num_filter_enc) - 1


def resolve_perf_stack(cfg: VAEConfig) -> dict:
    """The card's optimizer stack: ``{"moment_dtype", "sn_per_epoch"}``.

    "auto" resolves to what the JAX package runs off a TPU: f32 AdamW moments
    and one power iteration every step (torch parity). The TPU stack (bf16
    moments with stochastic rounding, per-epoch spectral norm) is not ported
    yet and raises.
    """
    osd = "float32" if cfg.opt_state_dtype == "auto" else cfg.opt_state_dtype
    if osd != "float32":
        raise NotImplementedError(f"opt_state_dtype {cfg.opt_state_dtype!r}: only "
                                  "float32 moments are ported")
    cadence = "step" if cfg.sn_cadence == "auto" else cfg.sn_cadence
    if cadence != "step":
        raise NotImplementedError(f"sn_cadence {cfg.sn_cadence!r}: only the per-step "
                                  "power iteration is ported")
    return {"moment_dtype": torch.float32, "sn_per_epoch": False}


@dataclasses.dataclass
class LCConfig:
    """Latent-conditioner configuration; this slice serves the CSV (MLP) one."""

    filters: List[int] = dataclasses.field(
        default_factory=lambda: [32, 64, 128, 256, 512, 1024])
    input_type: str = "csv"
