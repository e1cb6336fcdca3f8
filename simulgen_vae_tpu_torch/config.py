"""Model and training configuration (``simulgen_vae_tpu/config.py``).

The geometry and training fields of ``VAEConfig``, the latent conditioner's
``LCConfig``, the card's counterpart of ``resolve_perf_stack``, and the
readers of the reference's two config files:

* ``parse_condition_file``: whitespace key-value lines, ``#`` starts a
  comment anywhere on a line, lines starting with ``%`` or ``'`` are section
  markers and skipped;
* ``parse_training_parameters``: the typed key set with its defaults;
* ``read_preset``: a 5-line file (header, data_No, init_beta_divisor, encoder
  filters, latent-conditioner filters), or ``input_user_variables``, the
  same four values from stdin.
"""

from __future__ import annotations

import dataclasses
from typing import List


def parse_condition_file(filepath: str) -> dict:
    """``condition.txt`` -> a raw ``{key: str value}`` dict: the first two
    tokens of each line that is not blank, a comment or a section marker."""
    params = {}
    with open(filepath, encoding="utf-8") as f:
        for line in f:
            line = line.split("#")[0].strip()
            if not line or line.startswith("%") or line.startswith("'"):
                continue
            parts = line.split()
            if len(parts) >= 2:
                params[parts[0]] = parts[1]
    return params


def parse_training_parameters(params: dict) -> dict:
    """The raw condition dict -> the typed config dict (the reference's key
    set, types and defaults)."""
    get = params.get
    return {
        "num_param": int(params["Dim1"]),
        "num_time": int(params["Dim2"]),
        "num_time_to": int(params["Dim2_red"]),
        "num_node": int(params["Dim3"]),
        "num_node_start": int(params["Dim3_start"]),
        "num_node_end": int(params["Dim3_end"]),
        "num_var": int(params["num_var"]),
        "n_epochs": int(params["Training_epochs"]),
        "batch_size": int(params["Batch_size"]),
        "LR": float(params["LearningR"]),
        "latent_dim": int(params["Latent_dim"]),
        "latent_dim_end": int(params["Latent_dim_end"]),
        "loss_type": int(params["Loss_type"]),
        "stretch": int(params["Stretch"]),
        "alpha": int(params["alpha"]),
        "num_samples_f": int(get("num_aug_f", 0)),
        "num_samples_a": int(get("num_aug_a", 0)),
        "recon_iter": int(get("Recon_iter", 1)),
        "num_physical_param": int(params["num_param"]),
        "param_dir": params["param_dir"],
        "latent_conditioner_epoch": int(params["n_epoch"]),
        "latent_conditioner_lr": float(params["latent_conditioner_lr"]),
        "latent_conditioner_batch_size": int(params["latent_conditioner_batch"]),
        "latent_conditioner_data_type": params["input_type"],
        "param_data_type": params["param_data_type"],
        "latent_conditioner_weight_decay": float(
            get("latent_conditioner_weight_decay", 1e-4)),
        "latent_conditioner_dropout_rate": float(
            get("latent_conditioner_dropout_rate", 0.3)),
        "use_spatial_attention": int(get("use_spatial_attention", 1)),
        "use_e2e_training": int(get("use_e2e_training", 0)),
        "use_improved_e2e": int(get("use_improved_e2e", 0)),
        "e2e_loss_function": get("e2e_loss_function", "MSE"),
        "e2e_vae_model_path": get("e2e_vae_model_path", "model_save/SimulGen-VAE"),
        "use_latent_regularization": int(get("use_latent_regularization", 0)),
        "LC_alpha": float(get("LC_alpha", 1.0)),
        "latent_reg_weight": float(get("latent_reg_weight", 0.001)),
    }


def read_preset(filepath: str = "preset.txt"):
    """``preset.txt`` -> ``(data_No, init_beta_divisor, num_filter_enc,
    latent_conditioner_filter)``."""
    with open(filepath) as f:
        lines = [line.rstrip("\n") for line in f]
    return (int(lines[1]), int(lines[2]), list(map(int, lines[3].split())),
            list(map(int, lines[4].split())))


def input_user_variables():
    """The stdin fallback when ``--preset != 1``: the dataset number, the
    initial beta power, the encoder filters and the conditioner filters, one
    prompt each, as :func:`read_preset` returns them."""
    print()
    print("Input dataset number of pickle file, dataset%d.pickle")
    dataset_no = int(input())
    print("Input initial beta power")
    init_beta_divisor = int(input())
    print("Input SimulGen-VAE filters")
    num_filter_enc = list(map(int, input().split()))
    print("Input LatentConditioner filters")
    latent_conditioner_filter = list(map(int, input().split()))
    return dataset_no, init_beta_divisor, num_filter_enc, latent_conditioner_filter


LOSS_NAMES = {1: "MSE", 2: "MAE", 3: "smoothL1", 4: "Huber"}


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

    @classmethod
    def from_condition(cls, config: dict, num_filter_enc: List[int],
                       small: bool = True, dtype: str = "float32") -> "VAEConfig":
        """From a :func:`parse_training_parameters` dict and the preset's
        encoder filters; the node range is cut to ``Dim3_start:Dim3_end``."""
        return cls(
            num_param=config["num_param"],
            num_time=config["num_time_to"],
            num_node=config["num_node_end"] - config["num_node_start"],
            latent_dim_end=config["latent_dim_end"],
            latent_dim=config["latent_dim"],
            num_filter_enc=list(num_filter_enc),
            small=small,
            n_epochs=config["n_epochs"],
            batch_size=config["batch_size"],
            lr=config["LR"],
            alpha=float(config["alpha"]),
            loss_type=LOSS_NAMES[config["loss_type"]],
            recon_iter=config["recon_iter"],
            dtype=dtype,
        )


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
    """Latent-conditioner configuration (condition.txt's %LatentConditioner
    block). The port trains and serves the CSV (MLP) conditioner only."""

    filters: List[int] = dataclasses.field(
        default_factory=lambda: [32, 64, 128, 256, 512, 1024])
    epochs: int = 500
    lr: float = 1e-3
    batch_size: int = 64
    weight_decay: float = 1e-5
    dropout_rate: float = 0.2
    use_spatial_attention: bool = True
    input_type: str = "image"         # image | csv | image_vit
    param_dir: str = "/images"
    param_data_type: str = ".png"

    # end-to-end training
    use_e2e_training: bool = False
    e2e_loss_function: str = "Huber"
    e2e_vae_model_path: str = "model_save/SimulGen-VAE"
    use_latent_regularization: bool = True
    lc_alpha: float = 1000.0
    latent_reg_weight: float = 1e-3

    @classmethod
    def from_condition(cls, config: dict, filters: List[int]) -> "LCConfig":
        return cls(
            filters=list(filters),
            epochs=config["latent_conditioner_epoch"],
            lr=config["latent_conditioner_lr"],
            batch_size=config["latent_conditioner_batch_size"],
            weight_decay=config["latent_conditioner_weight_decay"],
            dropout_rate=config["latent_conditioner_dropout_rate"],
            use_spatial_attention=bool(config["use_spatial_attention"]),
            input_type=config["latent_conditioner_data_type"],
            param_dir=config["param_dir"],
            param_data_type=config["param_data_type"],
            use_e2e_training=bool(config["use_e2e_training"]),
            e2e_loss_function=config["e2e_loss_function"],
            e2e_vae_model_path=config["e2e_vae_model_path"],
            use_latent_regularization=bool(config["use_latent_regularization"]),
            lc_alpha=config["LC_alpha"],
            latent_reg_weight=config["latent_reg_weight"],
        )
