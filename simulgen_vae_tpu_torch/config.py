"""Model and training configuration (``simulgen_vae_tpu/config.py``).

The geometry and training fields of ``VAEConfig`` and the card's counterpart
of ``resolve_perf_stack``. Parsing ``condition.txt`` and ``preset.txt`` comes
with the CLI slice.
"""

from __future__ import annotations

import dataclasses
from typing import List


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
    remat: bool = False               # checkpoint each decoder residual block
    # AdamW moment storage: "auto" | "float32" | "bfloat16" (stochastic
    # rounding) | "bfloat16_rtn" (round to nearest)
    opt_state_dtype: str = "auto"
    # Spectral-norm power-iteration refresh: "auto" | "step" | "epoch"
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
    """The trainer's optimizer stack from the config's knobs:
    ``{"moment_dtype", "nu_dtype", "stochastic_round", "sn_per_epoch"}``
    (dtypes as names, "" for f32, as the JAX function returns them).

    "auto" resolves to what the JAX package runs off a TPU: f32 AdamW moments
    and one power iteration every step (torch parity). The benched stack is
    asked for by name: ``opt_state_dtype="bfloat16"`` (bf16 moments with
    stochastic rounding; ``"bfloat16_rtn"`` rounds to nearest) and
    ``sn_cadence="epoch"`` (one power iteration per epoch).
    """
    osd = "float32" if cfg.opt_state_dtype == "auto" else cfg.opt_state_dtype
    if osd == "float32":
        opt = {"moment_dtype": "", "nu_dtype": "", "stochastic_round": False}
    elif osd in ("bfloat16", "bfloat16_rtn"):
        opt = {"moment_dtype": "bfloat16", "nu_dtype": "bfloat16",
               "stochastic_round": osd == "bfloat16"}
    else:
        raise ValueError(f"opt_state_dtype: {osd!r}")
    cadence = "step" if cfg.sn_cadence == "auto" else cfg.sn_cadence
    if cadence not in ("step", "epoch"):
        raise ValueError(f"sn_cadence: {cfg.sn_cadence!r}")
    return {**opt, "sn_per_epoch": cadence == "epoch"}


@dataclasses.dataclass
class LCConfig:
    """Latent-conditioner configuration; this slice serves the CSV (MLP) one."""

    filters: List[int] = dataclasses.field(
        default_factory=lambda: [32, 64, 128, 256, 512, 1024])
    input_type: str = "csv"
