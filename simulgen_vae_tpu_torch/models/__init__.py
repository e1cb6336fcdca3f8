from simulgen_vae_tpu_torch.models.conditioner_mlp import LatentConditioner
from simulgen_vae_tpu_torch.models.decoder import Decoder
from simulgen_vae_tpu_torch.models.vae import VAE

__all__ = ["Decoder", "LatentConditioner", "VAE"]
