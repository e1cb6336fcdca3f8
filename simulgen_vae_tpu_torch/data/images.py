"""Latent-conditioner inputs (``simulgen_vae_tpu/data/images.py``): the CSV
reader only; the image readers belong to the image conditioners, which the
port does not serve yet."""

from __future__ import annotations

import numpy as np


def read_latent_conditioner_dataset(param_dir: str,
                                    param_data_type: str = ".csv") -> np.ndarray:
    """A CSV of design parameters without a header -> ``[rows, columns]``
    f64 (one row gives one row)."""
    return np.loadtxt(param_dir, delimiter=",", ndmin=2, dtype=np.float64)
