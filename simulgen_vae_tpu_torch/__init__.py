"""PyTorch/CUDA port of SimulGen-VAE for one NVIDIA H100.

The serving decode (the MLP latent conditioner and the hierarchical decoder)
and the VAE train step (``train.vae_trainer.VAETrainer``), with hand-written
CUDA kernels for GroupNorm + activation forward and backward and for batch
assembly (``ops/csrc/``, built with ``nvcc`` at first use).
``simulgen_vae_tpu`` (JAX) stays the reference; this package imports none of
it.
"""

from simulgen_vae_tpu_torch.config import LCConfig, VAEConfig
from simulgen_vae_tpu_torch.data.scaler import MinMaxScaler
# ``generate`` the function stays in its module, so that the name
# ``simulgen_vae_tpu_torch.generate`` keeps meaning the module.
from simulgen_vae_tpu_torch.generate import (
    auto_max_batch,
    make_generate_fn,
    make_pipeline,
)
from simulgen_vae_tpu_torch.models.conditioner_mlp import LatentConditioner
from simulgen_vae_tpu_torch.models.vae import VAE

__all__ = [
    "LCConfig", "VAEConfig", "MinMaxScaler", "LatentConditioner", "VAE",
    "auto_max_batch", "make_generate_fn", "make_pipeline",
]
