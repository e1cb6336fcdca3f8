"""Reconstruction comparison: conditioner + decoder against the true-latent
decoder (``simulgen_vae_tpu/evaluation/evaluator.py``).

For each sample the latent conditioner's latents are inverse-scaled on the
device and decoded with ``mode="fix"``, as are the VAE's own (true) latents;
both fields are compared with the original by per-sample MSE, and the first
samples get a 2x2 dual-view PNG (nodal and temporal views, values x1e6).
Decoding runs in chunks of ``batch_size`` rows.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch

from simulgen_vae_tpu_torch.data.scaler import MinMaxScaler
from simulgen_vae_tpu_torch.evaluation.plotter import pyplot
from simulgen_vae_tpu_torch.evaluation.reconstruction import compute_dtype
from simulgen_vae_tpu_torch.models.vae import VAE


class ReconstructionEvaluator:
    def __init__(self, model: VAE, batch_size: int = 16, seed: int = 0):
        self.model = model
        self.batch_size = batch_size
        self.seed = seed
        self.device = next(model.parameters()).device
        self.dtype = compute_dtype(model)

    @torch.no_grad()
    def reconstruct_from_latents(self, y_pred, y2_pred, latent_scaler: MinMaxScaler,
                                 xs_scaler: MinMaxScaler,
                                 generator: Optional[torch.Generator] = None) -> np.ndarray:
        """Inverse-scale predicted latents (``y_pred [B, z_end]``, ``y2_pred
        [B, n_hier, hier_dim]``, arrays or tensors) and decode: ``[B, time,
        node]`` f32 fields."""
        generator = generator or torch.Generator(self.device).manual_seed(self.seed)
        y1 = torch.as_tensor(y_pred, dtype=torch.float32, device=self.device)
        y2 = torch.as_tensor(y2_pred, dtype=torch.float32, device=self.device)
        b, nh, hd = y2.shape
        z = latent_scaler.to(self.device).inverse_transform(y1)
        xs = xs_scaler.to(self.device).inverse_transform(y2.reshape(b, nh * hd)).reshape(b, nh, hd)
        out = []
        for start in range(0, b, self.batch_size):
            rows = slice(start, start + self.batch_size)
            x_hat, _, _ = self.model.decode(
                z[rows].to(self.dtype), [xs[rows, i].to(self.dtype) for i in range(nh)],
                mode="fix", generator=generator)
            out.append(x_hat.float().cpu().numpy())
        return np.concatenate(out, axis=0)

    def evaluate_reconstruction_comparison(
            self, conditioner_fn: Callable, conditioner_inputs,
            y1_true, y2_true, original_data, latent_vectors_scaler, xs_scaler,
            save_dir: str = "checkpoints", max_plots: int = 10,
            save_plots: bool = True):
        """Compare VAE + conditioner with the VAE alone.

        ``conditioner_fn``: ``x -> (y1_pred, y2_pred)``, deterministic, called
        on the (scaled) inputs as an f32 tensor on the device; ``y1_true`` /
        ``y2_true``: the scaled true latents; ``original_data``: the scaled
        ``[P, time, node]`` fields. Returns the per-sample MSEs of both
        branches (``pred_mse``, ``true_mse``) and both reconstructions.
        """
        x = torch.as_tensor(np.asarray(conditioner_inputs, np.float32), device=self.device)
        y1_pred, y2_pred = conditioner_fn(x)
        predicted = self.reconstruct_from_latents(y1_pred, y2_pred,
                                                  latent_vectors_scaler, xs_scaler)
        true_recon = self.reconstruct_from_latents(y1_true, y2_true,
                                                   latent_vectors_scaler, xs_scaler)

        orig = np.asarray(original_data)
        pred_mse = np.mean((orig - predicted) ** 2, axis=(1, 2))
        true_mse = np.mean((orig - true_recon) ** 2, axis=(1, 2))

        if save_plots:
            self._plot_comparisons(orig, predicted, true_recon, save_dir,
                                   min(max_plots, orig.shape[0]))

        return {"pred_mse": pred_mse, "true_mse": true_mse,
                "predicted": predicted, "true_recon": true_recon}

    def evaluate_reconstruction_comparison_e2e(
            self, conditioner_fn, e2e_arrays, latent_vectors_scaler,
            xs_scaler, save_dir: str = "checkpoints", max_plots: int = 10,
            save_plots: bool = True):
        """The same comparison from ``(x, y1, y2, target)`` arrays."""
        x, y1, y2, target = e2e_arrays
        return self.evaluate_reconstruction_comparison(
            conditioner_fn, x, y1, y2, target, latent_vectors_scaler,
            xs_scaler, save_dir=save_dir, max_plots=max_plots,
            save_plots=save_plots,
        )

    def _plot_comparisons(self, orig, predicted, true_recon, save_dir: str, n: int) -> None:
        """The first ``n`` samples' PNGs, or one line naming those skipped."""
        try:
            plt = pyplot()
        except ImportError:
            print(f"Skipped {n} comparison PNGs ({save_dir}/reconstruction_dual_view_0.png "
                  f"..): matplotlib is not installed")
            return
        os.makedirs(save_dir, exist_ok=True)
        for i in range(n):
            self._plot_comparison(plt, i, orig[i], predicted[i], true_recon[i], save_dir)

    @staticmethod
    def _plot_comparison(plt, idx, original, predicted, true_recon, save_dir):
        """2x2 dual-view comparison of one sample, arrays ``[time, node]``,
        values x1e6: ``{save_dir}/reconstruction_dual_view_{idx}.png``."""
        nt, nn = original.shape
        time_indices = [int(nt * 0.25), int(nt * 0.5), int(nt * 0.75)]
        node_indices = [int(nn * 0.25), int(nn * 0.5), int(nn * 0.75)]
        colors = ["blue", "green", "red"]

        fig, axes = plt.subplots(2, 2, figsize=(16, 12))
        fig.suptitle(f"Sample {idx} - Dual-View Reconstruction Comparison",
                     fontsize=16)

        t_mid = nt // 2
        for arr, label, style in ((original, "Original", "."),
                                  (predicted, "VAE+LC", "."),
                                  (true_recon, "VAE-only", ".")):
            v = arr[t_mid, :] * 1e6
            axes[0, 0].plot(v, style, label=f"{label} [{v.min():.1f}, {v.max():.1f}]",
                            alpha=0.8, markersize=1)
        axes[0, 0].set_title(f"Nodal View - Spatial Distribution (t={t_mid})")
        axes[0, 0].set_xlabel("Node Index")
        axes[0, 0].set_ylabel("Value (x1e6)")
        axes[0, 0].legend()
        axes[0, 0].grid(True, alpha=0.3)

        axes[0, 1].set_title("Nodal View - Multiple Time Snapshots")
        for i, t_idx in enumerate(time_indices):
            axes[0, 1].plot(original[t_idx, :] * 1e6, "--", color=colors[i],
                            alpha=0.7, linewidth=1, label=f"Original t={t_idx}")
            axes[0, 1].plot(predicted[t_idx, :] * 1e6, "-", color=colors[i],
                            alpha=0.8, linewidth=1, label=f"VAE+LC t={t_idx}")
        axes[0, 1].set_xlabel("Node Index")
        axes[0, 1].legend(bbox_to_anchor=(1.05, 1), loc="upper left")
        axes[0, 1].grid(True, alpha=0.3)

        n_mid = nn // 2
        for arr, label in ((original, "Original"), (predicted, "VAE+LC"),
                           (true_recon, "VAE-only")):
            v = arr[:, n_mid] * 1e6
            axes[1, 0].plot(v, "-", label=f"{label} [{v.min():.1f}, {v.max():.1f}]",
                            alpha=0.8)
        axes[1, 0].set_title(f"Temporal View - Time Evolution (node={n_mid})")
        axes[1, 0].set_xlabel("Time Index")
        axes[1, 0].legend()
        axes[1, 0].grid(True, alpha=0.3)

        axes[1, 1].set_title("Temporal View - Multiple Node Traces")
        for i, n_idx in enumerate(node_indices):
            axes[1, 1].plot(original[:, n_idx] * 1e6, "--", color=colors[i],
                            alpha=0.7, linewidth=1, label=f"Original n={n_idx}")
            axes[1, 1].plot(predicted[:, n_idx] * 1e6, "-", color=colors[i],
                            alpha=0.8, linewidth=1, label=f"VAE+LC n={n_idx}")
        axes[1, 1].set_xlabel("Time Index")
        axes[1, 1].legend(bbox_to_anchor=(1.05, 1), loc="upper left")
        axes[1, 1].grid(True, alpha=0.3)

        plt.tight_layout()
        plt.savefig(f"{save_dir}/reconstruction_dual_view_{idx}.png", dpi=150,
                    bbox_inches="tight")
        plt.close(fig)
