from simulgen_vae_tpu_torch.models.conditioner_mlp import LatentConditioner
from simulgen_vae_tpu_torch.models.decoder import Decoder
from simulgen_vae_tpu_torch.models.encoder import Encoder
from simulgen_vae_tpu_torch.models.vae import VAE

__all__ = ["Decoder", "Encoder", "LatentConditioner", "VAE"]
