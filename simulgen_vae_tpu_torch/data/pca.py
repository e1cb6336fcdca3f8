"""PCA of image inputs (``simulgen_vae_tpu/data/pca.py``).

Full-image or patch PCA with square-arranged, channel-first outputs, saved
under ``model_save/`` with the JAX package's file names and pickled dict. The
decomposition is an economy SVD of the centred data (sklearn's PCA math) by
``torch.linalg.svd`` on ``device``; arrays in and out are f32 numpy, as the
JAX functions take and give them.

:meth:`PCAPreprocessor.load` reads the pickle through the restricted
unpickler of ``data/scaler.py`` (numpy arrays and plain Python values), so
the card's machine reads a JAX-written file without running its code.
"""

from __future__ import annotations

import math
import os
import pickle
from typing import Optional, Tuple

import numpy as np
import torch

from simulgen_vae_tpu_torch.data.scaler import restricted_load
from simulgen_vae_tpu_torch.utils import resolve_device


class _LinearPCA:
    """Components from the SVD of the centred data (sklearn's math)."""

    def __init__(self, n_components: int, device=None):
        self.n_components = n_components
        self.device = resolve_device(device)
        self.mean_: Optional[np.ndarray] = None
        self.components_: Optional[np.ndarray] = None   # [k, d]
        self.explained_variance_ratio_: Optional[np.ndarray] = None

    def fit(self, x: np.ndarray) -> "_LinearPCA":
        x = torch.as_tensor(np.asarray(x, np.float32), device=self.device)
        mean = x.mean(dim=0)
        xc = x - mean
        k = min(self.n_components, min(xc.shape))
        # economy SVD; the right singular vectors are the components
        _, s, vt = torch.linalg.svd(xc, full_matrices=False)
        self.mean_ = mean.cpu().numpy()
        self.components_ = vt[:k].cpu().numpy()
        var = s.cpu().numpy() ** 2
        self.explained_variance_ratio_ = var[:k] / (var.sum() + 1e-12)
        self.n_components = k
        return self

    def _on_device(self, x: np.ndarray):
        return (torch.as_tensor(np.asarray(a, np.float32), device=self.device)
                for a in (x, self.mean_, self.components_))

    def transform(self, x: np.ndarray) -> np.ndarray:
        x, mean, comp = self._on_device(x)
        return ((x - mean) @ comp.T).cpu().numpy()

    def inverse_transform(self, coeffs: np.ndarray) -> np.ndarray:
        c, mean, comp = self._on_device(coeffs)
        return (c @ comp + mean).cpu().numpy()


class PCAPreprocessor:
    """Full-image or patch PCA with the JAX package's I/O conventions."""

    def __init__(self, n_components: int = 1024, patch_size: Optional[int] = None,
                 save_dir: str = "model_save", device=None):
        self.n_components = n_components
        self.patch_size = patch_size
        self.save_dir = save_dir
        self.device = resolve_device(device)
        self.pca: Optional[_LinearPCA] = None
        self.is_fitted = False
        self.original_shape: Optional[Tuple[int, int]] = None
        self.output_shape: Optional[Tuple[int, ...]] = None
        os.makedirs(save_dir, exist_ok=True)

    def _get_pca_filename(self) -> str:
        if self.patch_size:
            return f"pca_patch{self.patch_size}_comp{self.n_components}.pkl"
        return f"pca_full_comp{self.n_components}.pkl"

    # -- fitting -----------------------------------------------------------

    def fit(self, images: np.ndarray, save: bool = True) -> "PCAPreprocessor":
        """``images`` [N, H, W], or [N, side^2] flattened square images."""
        if images.ndim == 3:
            n, h, w = images.shape
            self.original_shape = (h, w)
            flat = images.reshape(n, -1)
        else:
            flat = images
            side = int(math.sqrt(flat.shape[1]))
            self.original_shape = (side, side)
        if self.patch_size:
            self._fit_patch(flat)
        else:
            self._fit_full(flat)
        if save:
            self.save()
        return self

    def _fit_full(self, flat: np.ndarray) -> None:
        # the component count rounds up to a square, the output's side squared
        out_side = int(math.sqrt(self.n_components))
        if out_side * out_side != self.n_components:
            out_side = int(math.ceil(math.sqrt(self.n_components)))
            self.n_components = out_side * out_side
        self.pca = _LinearPCA(self.n_components, self.device).fit(flat)
        self.n_components = self.pca.n_components
        self.output_shape = (out_side, out_side)
        self.is_fitted = True

    def _extract_patches(self, flat: np.ndarray) -> np.ndarray:
        h, w = self.original_shape
        p = self.patch_size
        if h % p != 0 or w % p != 0:
            raise ValueError(f"Image size {self.original_shape} not divisible by patch "
                             f"size {p}")
        imgs = flat.reshape(flat.shape[0], h // p, p, w // p, p)
        # [n, gh, gw, p, p] -> [n * gh * gw, p * p]
        return imgs.transpose(0, 1, 3, 2, 4).reshape(-1, p * p)

    def _fit_patch(self, flat: np.ndarray) -> None:
        per_dim = self.original_shape[0] // self.patch_size
        n_patches = per_dim * per_dim
        per_patch = max(self.n_components // n_patches, 1)
        if self.n_components // n_patches < 1:
            self.n_components = n_patches
        self.pca = _LinearPCA(per_patch, self.device).fit(self._extract_patches(flat))
        self.output_shape = (per_dim, per_dim, self.pca.n_components)
        self.is_fitted = True

    # -- transform ---------------------------------------------------------

    def transform(self, images: np.ndarray) -> np.ndarray:
        """``[N, 1, s, s]`` (full, zero-padded past the fitted components) or
        ``[N, c, gh, gw]`` (patch) f32, channel first."""
        if not self.is_fitted:
            raise ValueError("PCA not fitted. Call fit() first or load().")
        flat = images.reshape(images.shape[0], -1) if images.ndim == 3 else images
        n = flat.shape[0]
        if self.patch_size:
            per_dim, _, cpp = self.output_shape
            coeffs = self.pca.transform(self._extract_patches(flat))
            coeffs = coeffs.reshape(n, per_dim, per_dim, cpp)
            return coeffs.transpose(0, 3, 1, 2).astype(np.float32)
        coeffs = self.pca.transform(flat)
        s0, s1 = self.output_shape
        out = np.zeros((n, s0 * s1), np.float32)
        out[:, : coeffs.shape[1]] = coeffs
        return out.reshape(n, 1, s0, s1)

    # -- persistence -------------------------------------------------------

    def save(self) -> None:
        if not self.is_fitted:
            raise ValueError("Cannot save unfitted PCA model")
        with open(os.path.join(self.save_dir, self._get_pca_filename()), "wb") as f:
            pickle.dump({
                "pca_mean": self.pca.mean_,
                "pca_components": self.pca.components_,
                "explained_variance_ratio": self.pca.explained_variance_ratio_,
                "n_components": self.n_components,
                "patch_size": self.patch_size,
                "original_shape": self.original_shape,
                "output_shape": self.output_shape,
                "is_fitted": self.is_fitted,
            }, f)

    def load(self) -> "PCAPreprocessor":
        path = os.path.join(self.save_dir, self._get_pca_filename())
        if not os.path.exists(path):
            raise FileNotFoundError(f"PCA model not found at {path}")
        with open(path, "rb") as f:
            d = restricted_load(f)
        core = _LinearPCA(d["n_components"], self.device)
        core.mean_ = d["pca_mean"]
        core.components_ = d["pca_components"]
        core.explained_variance_ratio_ = d["explained_variance_ratio"]
        core.n_components = core.components_.shape[0]
        self.pca = core
        self.n_components = d["n_components"]
        self.patch_size = d["patch_size"]
        self.original_shape = d["original_shape"]
        self.output_shape = d["output_shape"]
        self.is_fitted = d["is_fitted"]
        return self

    def get_output_shape(self):
        if not self.is_fitted:
            raise ValueError("PCA not fitted")
        return self.output_shape

    def get_output_channels(self) -> int:
        if not self.is_fitted:
            raise ValueError("PCA not fitted")
        return self.output_shape[2] if self.patch_size else 1
