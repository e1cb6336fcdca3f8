"""PyTorch/CUDA port of SimulGen-VAE for one NVIDIA H100.

The training pipeline (``python -m simulgen_vae_tpu_torch``: the VAE, latent
extraction, the CSV latent conditioner, evaluation and the ``model_save/``
artifacts), the VAE train step (``train.vae_trainer.VAETrainer``), and the
serving decode (the MLP latent conditioner and the hierarchical decoder,
from memory or from a trained ``model_save/``, in float or int8), with
hand-written CUDA kernels for GroupNorm + activation forward and backward,
batch assembly, the fused readout and AdamW (``ops/csrc/``, built with
``nvcc`` at first use). Training and serving also run on a ``('data',
'model')`` mesh of ranks, one process a device (``parallel/``: NCCL, or gloo
on the CPU; ``make_mesh``, ``VAETrainer.fit(mesh=...)``,
``make_generate_fn(mesh=...)``, the CLI under ``torchrun``).
``simulgen_vae_tpu`` (JAX) stays the reference; this package imports none of
it.
"""

from simulgen_vae_tpu_torch.config import LCConfig, VAEConfig
from simulgen_vae_tpu_torch.data.scaler import MinMaxScaler
# ``generate`` the function stays in its module, so that the name
# ``simulgen_vae_tpu_torch.generate`` keeps meaning the module.
from simulgen_vae_tpu_torch.generate import (
    auto_max_batch,
    load_pipeline,
    make_generate_fn,
    make_pipeline,
)
from simulgen_vae_tpu_torch.models.conditioner_mlp import LatentConditioner
from simulgen_vae_tpu_torch.models.vae import VAE
from simulgen_vae_tpu_torch.parallel import initialize_distributed, make_mesh

__all__ = [
    "LCConfig", "VAEConfig", "MinMaxScaler", "LatentConditioner", "VAE",
    "auto_max_batch", "initialize_distributed", "load_pipeline", "make_generate_fn",
    "make_mesh", "make_pipeline",
]
