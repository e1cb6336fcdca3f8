"""Min-max scaler as an affine ``x * scale_ + min_`` (``simulgen_vae_tpu/data/scaler.py``).

Holds sklearn's ``scale_`` and ``min_`` as numpy arrays or tensors;
``transform`` and ``inverse_transform`` work on either, so serving applies
them on the card. Loading sklearn pickles comes with the artifact loader.
"""

from __future__ import annotations

import torch


class MinMaxScaler:
    def __init__(self, scale_, min_):
        self.scale_ = scale_
        self.min_ = min_

    def to(self, device) -> "MinMaxScaler":
        """A copy whose arrays are f32 tensors on ``device``."""
        return MinMaxScaler(
            torch.as_tensor(self.scale_, dtype=torch.float32, device=device),
            torch.as_tensor(self.min_, dtype=torch.float32, device=device))

    def transform(self, x):
        return x * self.scale_ + self.min_

    def inverse_transform(self, x):
        return (x - self.min_) / self.scale_
