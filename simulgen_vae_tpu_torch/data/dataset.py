"""Dataset loading and reduction (``simulgen_vae_tpu/data/dataset.py``), in numpy.

Simulation arrays are ``[num_param, num_time, num_node]`` float arrays, the
layout the port's modules take as it is.

* :func:`input_dataset` loads ``dataset{data_no}.pickle``;
* :func:`reduce_dataset` slices time to ``num_time_to`` and nodes to
  ``[start, end)`` in one copy;
* :func:`synthetic_dataset` makes test data: superposed traveling waves over
  a 1-D node coordinate whose speed, wavenumber and damping follow the
  parameter index, so a small latent space explains the ensemble.

The outputs are the JAX package's bit for bit.
"""

from __future__ import annotations

import pickle
import time
from typing import Tuple

import numpy as np


def input_dataset(num_param: int, num_time: int, num_node: int, data_no: int,
                  base_dir: str = ".") -> np.ndarray:
    """Load ``dataset{data_no}.pickle`` -> array [num_param, num_time, num_node].

    The pickle is the user's own dataset file, read as the JAX package reads
    it."""
    start = time.time()
    path = f"{base_dir}/dataset{data_no}.pickle"
    print(f"Opening dataset file: dataset{data_no}.pickle")
    with open(path, "rb") as fr:
        data_save = pickle.load(fr)
    print(f"Time taken to load dataset: {time.time() - start:f} seconds")
    print("Dataset size: ", np.shape(data_save))
    return np.asarray(data_save)


def reduce_dataset(data: np.ndarray, num_time_to: int, num_node_red: int,
                   num_param: int, num_time: int,
                   num_node_red_start: int, num_node_red_end: int
                   ) -> Tuple[int, np.ndarray, int]:
    """Slice time to ``num_time_to`` and nodes to ``[start, end)``.

    Returns ``(num_time, reduced_data, num_node)``; the data itself when
    nothing is cut, else one contiguous copy.
    """
    num_node = data.shape[-1]
    if num_time_to == num_time and num_node_red == num_node:
        fom_data = data
    else:
        fom_data = np.ascontiguousarray(
            data[:, 0:num_time_to, num_node_red_start:num_node_red_end]
        )
        num_node = num_node_red
    return num_time_to, fom_data, num_node


def synthetic_dataset(num_param: int = 16, num_time: int = 50,
                      num_node: int = 2048, seed: int = 0) -> np.ndarray:
    """A synthetic simulation ensemble [num_param, num_time, num_node] f32.

    It builds f64 ``[P, T, N]`` arrays on the way: use it at test sizes."""
    rng = np.random.default_rng(seed)
    x = np.linspace(0.0, 1.0, num_node, dtype=np.float64)[None, None, :]
    t = np.linspace(0.0, 1.0, num_time, dtype=np.float64)[None, :, None]
    p = np.linspace(0.0, 1.0, num_param, dtype=np.float64)[:, None, None]

    data = np.zeros((num_param, num_time, num_node), dtype=np.float64)
    for mode in range(1, 4):
        k = 2 * np.pi * (mode + 2.0 * p)              # wavenumber ~ parameter
        c = 0.5 + p                                   # wave speed ~ parameter
        amp = np.exp(-0.5 * mode) * (0.5 + 0.5 * p)   # amplitude decay
        damp = np.exp(-2.0 * p * t)                   # temporal damping
        data += amp * damp * np.sin(k * (x - c * t))
    data += 0.01 * rng.standard_normal(data.shape)
    return data.astype(np.float32)
