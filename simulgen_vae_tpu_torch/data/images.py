"""Latent-conditioner inputs (``simulgen_vae_tpu/data/images.py``): the CSV
reader and the two image readers.

Both image readers start from :func:`read_raw_images`: OpenCV's grayscale
read and an INTER_CUBIC resize to 256 x 256, in natural filename order. The
image reader (``image``, ``image_vit``) then thresholds at 150 (to 0 / 255)
and flattens. The PCA reader (``image_pca``) fits a
:class:`~simulgen_vae_tpu_torch.data.pca.PCAPreprocessor` on the raw pixels
on ``device``, saves it under ``save_dir`` and returns its flattened
coefficients. ``cv2`` is imported where it is used: a machine without OpenCV
(the card's) imports this module and reads CSVs.
"""

from __future__ import annotations

import os
import re
from typing import List, Optional, Tuple

import numpy as np

DEFAULT_IMAGE_SIZE = 256


def natsorted(names: List[str]) -> List[str]:
    """Natural sort (``file2 < file10``), case-insensitive."""

    def key(s):
        return [int(t) if t.isdigit() else t.lower() for t in re.split(r"(\d+)", s)]

    return sorted(names, key=key)


def clear_images(image: np.ndarray, threshold: int = 150) -> np.ndarray:
    """A binary threshold at ``threshold`` -> {0, 255} (colour images are
    made grayscale first)."""
    import cv2

    if image.ndim == 3:
        image = cv2.cvtColor(image, cv2.COLOR_BGR2GRAY)
    _, binary = cv2.threshold(image, threshold, 255, cv2.THRESH_BINARY)
    return binary


def read_raw_images(param_dir: str, param_data_type: str,
                    im_size: int = DEFAULT_IMAGE_SIZE,
                    base_dir: Optional[str] = None) -> np.ndarray:
    """The ``param_data_type`` images of a directory, read as grayscale and
    resized (INTER_CUBIC) to ``im_size`` square: ``[N, im_size, im_size]``
    uint8. ``param_dir`` is appended to the working directory (or to
    ``base_dir``), as the reference does."""
    import cv2

    file_dir = (base_dir or os.getcwd()) + param_dir
    files = natsorted([f for f in os.listdir(file_dir) if f.endswith(param_data_type)])
    raw = np.zeros((len(files), im_size, im_size), np.uint8)
    for i, fname in enumerate(files):
        raw[i] = cv2.resize(cv2.imread(os.path.join(file_dir, fname), 0), (im_size, im_size),
                            interpolation=cv2.INTER_CUBIC)
    return raw


def read_latent_conditioner_dataset_img(
        param_dir: str, param_data_type: str, im_size: int = DEFAULT_IMAGE_SIZE,
        base_dir: Optional[str] = None) -> Tuple[np.ndarray, Tuple[int, int]]:
    """The ``param_data_type`` (.png or .jpg) images of a directory ->
    ``([N, im_size^2] f64 of 0 / 255, (im_size, im_size))``."""
    if param_data_type not in (".jpg", ".png"):
        raise NotImplementedError("Data type not supported")
    raw = read_raw_images(param_dir, param_data_type, im_size, base_dir)
    binary = np.zeros(raw.shape)
    for i, im in enumerate(raw):
        binary[i] = clear_images(im)
    return binary.reshape(len(raw), -1), (im_size, im_size)


def read_latent_conditioner_dataset_img_pca(
        param_dir: str, param_data_type: str, pca_components: int = 256,
        pca_patch_size: int = 0, im_size: int = DEFAULT_IMAGE_SIZE,
        base_dir: Optional[str] = None, save_dir: str = "model_save",
        device=None, save: bool = True) -> Tuple[np.ndarray, Tuple[int, ...]]:
    """The PCA -> MLP input: a PCA (``pca_components``, full-image or
    ``pca_patch_size`` patches) fitted on ``device`` to the raw resized
    pixels (0-255, no threshold) and saved under ``save_dir`` (unless
    ``save`` is False), then its coefficients flattened: ``([N, width] f32,
    (width,))``."""
    from simulgen_vae_tpu_torch.data.pca import PCAPreprocessor

    if param_data_type not in (".jpg", ".png"):
        raise NotImplementedError("PCA_MLP mode only supports .jpg/.png files")
    raw = read_raw_images(param_dir, param_data_type, im_size, base_dir).astype(np.float64)
    pre = PCAPreprocessor(n_components=pca_components,
                          patch_size=pca_patch_size if pca_patch_size > 0 else None,
                          save_dir=save_dir, device=device)
    pre.fit(raw, save=save)
    coeffs = pre.transform(raw)
    flat = coeffs.reshape(coeffs.shape[0], -1)
    return flat, (flat.shape[1],)


def read_latent_conditioner_dataset(param_dir: str,
                                    param_data_type: str = ".csv") -> np.ndarray:
    """A CSV of design parameters without a header -> ``[rows, columns]``
    f64 (one row gives one row)."""
    return np.loadtxt(param_dir, delimiter=",", ndmin=2, dtype=np.float64)
