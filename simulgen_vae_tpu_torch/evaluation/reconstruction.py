"""VAE reconstruction evaluation and latent extraction
(``simulgen_vae_tpu/evaluation/reconstruction.py``).

The data goes through the VAE in chunks of ``batch_size`` rows on the model's
device (the last chunk padded by repeating its last row, the padding
dropped after): encode once, clamp ``log_var`` to +-30, then ``recon_iter``
attempts of reparameterize + ``decode(mode="fix")``, keeping per sample the
attempt of least MSE. The outputs are the training CLI's artifacts:
``latent_vectors [P, latent_dim_end]``, ``hierarchical [P, n_hier,
latent_dim]`` (``model_save/latent_vectors.npy``, ``xs.npy``) and the
per-sample MSEs (``SimulGen-VAE_L2_loss.txt``).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from simulgen_vae_tpu_torch.evaluation.plotter import pyplot
from simulgen_vae_tpu_torch.models.decoder import reparameterize
from simulgen_vae_tpu_torch.models.vae import VAE


def compute_dtype(model: torch.nn.Module) -> torch.dtype:
    """The dtype the model's layers compute in (``blocks.set_compute_dtype``)."""
    return next((m.compute_dtype for m in model.modules() if hasattr(m, "compute_dtype")),
                torch.float32)


def _evaluate_chunk(model: VAE, chunk: torch.Tensor, generator: torch.Generator,
                    recon_iter: int):
    """Best-of-``recon_iter`` evaluation of one ``[B, T, N]`` f32 chunk:
    ``(z, hier, mse, x_hat)``."""
    mu, log_var, xs = model.encode(chunk)
    std = torch.exp(0.5 * log_var.clamp(-30.0, 30.0))
    best = None
    for _ in range(recon_iter):
        z = reparameterize(mu, std, generator)
        gen, _, _ = model.decode(z, xs, mode="fix", generator=generator)
        # per-sample MSE, each attempt against its own sample
        mse = torch.mean((gen.float() - chunk.float()) ** 2, dim=(1, 2))
        if best is None:
            best = (z, gen, mse)
            continue
        better = mse < best[2]
        best = (torch.where(better[:, None], z, best[0]),
                torch.where(better[:, None, None], gen, best[1]),
                torch.where(better, mse, best[2]))
    hier = (torch.stack(xs, dim=1) if xs
            else chunk.new_zeros((chunk.shape[0], 0, 0)))
    return best[0], hier, best[2], best[1]


def _slug(dataset_name: str) -> str:
    return (dataset_name.replace(" ", "_").replace("(", "").replace(")", "").lower())


def _save_comparison_pngs(data: np.ndarray, reconstructed: np.ndarray,
                          recon_loss: np.ndarray, dataset_name: str,
                          save_dir: Optional[str] = None,
                          max_images: int = 10) -> None:
    """The first ``max_images`` original-vs-reconstruction PNGs,
    ``checkpoints/<dataset slug>/reconstruction_sample_NNN.png``: up to 3
    rows of each sample, original solid and reconstruction dashed, the MSE in
    each title. Without matplotlib, one line says which PNGs were skipped."""
    if save_dir is None:
        save_dir = os.path.join("checkpoints", _slug(dataset_name))
    n = min(max_images, data.shape[0])
    try:
        plt = pyplot()
    except ImportError:
        print(f"Skipped {n} reconstruction PNGs ({save_dir}/reconstruction_sample_001.png "
              f"..): matplotlib is not installed")
        return
    os.makedirs(save_dir, exist_ok=True)
    for j in range(n):
        try:
            original = np.asarray(data[j])
            recon = reconstructed[j]
            num_ch = min(3, original.shape[0])
            plt.figure(figsize=(12, 6))
            for ch in range(num_ch):
                plt.subplot(num_ch, 1, ch + 1)
                plt.plot(original[ch], label="Original", alpha=0.7)
                plt.plot(recon[ch], label="Reconstructed", alpha=0.7,
                         linestyle="--")
                plt.title(f"Channel {ch + 1} - Sample {j + 1} - "
                          f"MSE: {recon_loss[j]:.4E}")
                plt.legend()
                plt.grid(True, alpha=0.3)
            plt.tight_layout()
            plt.savefig(f"{save_dir}/reconstruction_sample_{j + 1:03d}.png",
                        dpi=120, bbox_inches="tight")
            plt.close()
        except (OSError, ValueError) as e:  # a figure that fails is reported, not fatal
            print(f"Warning: Could not save reconstruction image for "
                  f"sample {j + 1}: {e}")
    print(f"Saved {n} reconstruction images to: {save_dir}/")


@torch.no_grad()
def evaluate_vae_reconstruction(model: VAE, data, seed: int = 0,
                                recon_iter: int = 1, batch_size: int = 16,
                                dataset_name: str = "Dataset",
                                verbose: bool = True,
                                save_images: bool = False,
                                save_dir: Optional[str] = None
                                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                           np.ndarray, float]:
    """Evaluate ``model`` (a VAE with its encoder, on its device) over
    ``data`` [P, T, N]. Noise comes from a generator seeded with ``seed``.

    Returns ``(latent_vectors, hierarchical, reconstruction_loss,
    reconstructed, total_loss)`` as f32 numpy arrays and a float. With
    ``verbose`` prints one line per sample and the mean; ``save_images``
    writes the first 10 samples' comparison PNGs.
    """
    data = np.asarray(data)
    device = next(model.parameters()).device
    generator = torch.Generator(device).manual_seed(seed)
    n = data.shape[0]
    zs, hiers, mses, gens = [], [], [], []
    for start in range(0, n, batch_size):
        chunk = torch.as_tensor(data[start: start + batch_size], dtype=torch.float32,
                                device=device)
        got = chunk.shape[0]
        if got < batch_size:
            chunk = torch.cat([chunk, chunk[-1:].expand(batch_size - got, -1, -1)])
        z, hier, mse, gen = _evaluate_chunk(model, chunk, generator, recon_iter)
        for out, t in ((zs, z), (hiers, hier), (mses, mse), (gens, gen)):
            out.append(t[:got].float().cpu().numpy())

    latent_vectors = np.concatenate(zs, axis=0)
    hierarchical = np.concatenate(hiers, axis=0)
    recon_loss = np.concatenate(mses, axis=0)
    reconstructed = np.concatenate(gens, axis=0)
    total = float(recon_loss.sum())

    if verbose:
        for j in range(n):
            print(f"Parameter {j + 1} finished - MSE: {recon_loss[j]:.4E}")
        print(f"Total {dataset_name} MSE loss: {recon_loss.mean():.3e}")

    if save_images:
        _save_comparison_pngs(data, reconstructed, recon_loss, dataset_name,
                              save_dir=save_dir)

    return latent_vectors, hierarchical, recon_loss, reconstructed, total


def evaluate_vae_simple(model: VAE, data, seed: int = 0, batch_size: int = 16,
                        dataset_name: str = "Dataset") -> float:
    """The summed per-sample MSE of one attempt, printing nothing."""
    *_, total = evaluate_vae_reconstruction(
        model, data, seed, recon_iter=1, batch_size=batch_size,
        dataset_name=dataset_name, verbose=False)
    return total
