"""The few calls the harness makes into the program besides what it times:
its configuration object, its kernel build, and loading the seed's weights."""

from __future__ import annotations

import torch


def vae_config(cfg: dict):
    from simulgen_vae_tpu_torch.config import VAEConfig

    return VAEConfig(num_param=cfg["num_param"], num_time=cfg["num_time"],
                     num_node=cfg["num_node"], latent_dim_end=cfg["latent_dim_end"],
                     latent_dim=cfg["latent_dim"], num_filter_enc=list(cfg["num_filter_enc"]),
                     small=cfg["small"], n_epochs=cfg["n_epochs"],
                     batch_size=cfg["batch_size"], lr=cfg["lr"], alpha=cfg["alpha"],
                     loss_type=cfg["loss_type"], dtype=cfg["dtype"],
                     use_spectral_norm=cfg["use_spectral_norm"],
                     opt_state_dtype=cfg["opt_state_dtype"], sn_cadence=cfg["sn_cadence"])


def build_kernels(device) -> None:
    """Every hand-written kernel, built at once where not built yet (in the
    package's build directory inside the checkout)."""
    if device.type == "cuda":
        from simulgen_vae_tpu_torch.ops import _build

        _build.build()


@torch.no_grad()
def load_state(module, values: dict, params_only: bool = False) -> None:
    """Copy ``values`` into ``module``'s parameters (and buffers); the names
    and shapes must be the reference's."""
    state = dict(module.named_parameters()) if params_only else module.state_dict()
    want = {k: tuple(v.shape) for k, v in values.items()}
    have = {k: tuple(v.shape) for k, v in state.items() if v is not None}
    if want != have:
        diff = sorted(set(want.items()) ^ set(have.items()))[:6]
        raise RuntimeError(f"the program's state differs from the reference's: {diff}")
    for k, v in state.items():
        v.copy_(values[k])


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0
