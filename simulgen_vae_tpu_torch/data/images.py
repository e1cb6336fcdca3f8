"""Latent-conditioner inputs (``simulgen_vae_tpu/data/images.py``): the CSV
reader and the image reader.

Images: OpenCV's grayscale read, an INTER_CUBIC resize to 256 x 256, a binary
threshold at 150 (to 0 / 255), flattened, in natural filename order.
``cv2`` is imported where it is used: a machine without OpenCV (the card's)
imports this module and reads CSVs. The PCA reader (``image_pca``) is not
ported (ROADMAP Queue 1 item 5).
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


def read_latent_conditioner_dataset_img(
        param_dir: str, param_data_type: str, im_size: int = DEFAULT_IMAGE_SIZE,
        base_dir: Optional[str] = None) -> Tuple[np.ndarray, Tuple[int, int]]:
    """The ``param_data_type`` (.png or .jpg) images of a directory ->
    ``([N, im_size^2] f64 of 0 / 255, (im_size, im_size))``. ``param_dir`` is
    appended to the working directory (or to ``base_dir``), as the reference
    does."""
    import cv2

    if param_data_type not in (".jpg", ".png"):
        raise NotImplementedError("Data type not supported")
    file_dir = (base_dir or os.getcwd()) + param_dir
    files = natsorted([f for f in os.listdir(file_dir) if f.endswith(param_data_type)])
    raw = np.zeros((len(files), im_size, im_size))
    for i, fname in enumerate(files):
        im = cv2.imread(os.path.join(file_dir, fname), 0)
        raw[i] = clear_images(cv2.resize(im, (im_size, im_size),
                                         interpolation=cv2.INTER_CUBIC))
    return raw.reshape(len(files), -1), (im_size, im_size)


def read_latent_conditioner_dataset(param_dir: str,
                                    param_data_type: str = ".csv") -> np.ndarray:
    """A CSV of design parameters without a header -> ``[rows, columns]``
    f64 (one row gives one row)."""
    return np.loadtxt(param_dir, delimiter=",", ndmin=2, dtype=np.float64)
