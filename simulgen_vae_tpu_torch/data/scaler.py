"""Min-max scaler as an affine ``x * scale_ + min_`` (``simulgen_vae_tpu/data/scaler.py``).

Holds sklearn's ``scale_`` and ``min_`` as numpy arrays or tensors;
``transform`` and ``inverse_transform`` work on either, so serving applies
them on the card. Loaded statistics stay f64 numpy arrays on the host until
:meth:`MinMaxScaler.to` makes f32 tensors of them on a device.

``model_save/*.pkl`` are pickles of sklearn's ``MinMaxScaler``, and the
card's machine has no sklearn. :meth:`MinMaxScaler.load` reads them through
an unpickler that resolves only the globals such a pickle names (the sklearn
class, mapped to a plain stub, and numpy's array and dtype reconstructors)
and the one its own :meth:`MinMaxScaler.save` writes
(``types.SimpleNamespace``); any other global is refused, so a pickle cannot
run code. ``save`` writes the five attributes the JAX package's
``MinMaxScaler.from_sklearn`` reads, so the JAX package loads it too.
"""

from __future__ import annotations

import pickle
import types
from typing import Tuple

import numpy as np
import torch

try:
    from numpy._core.multiarray import _reconstruct
except ImportError:  # numpy 1.x
    from numpy.core.multiarray import _reconstruct


class _SklearnMinMaxScaler:
    """Stands for ``sklearn.preprocessing._data.MinMaxScaler`` while
    unpickling: the pickle's state dict becomes its attributes."""


_ALLOWED = {
    ("sklearn.preprocessing._data", "MinMaxScaler"): _SklearnMinMaxScaler,
    ("numpy._core.multiarray", "_reconstruct"): _reconstruct,
    ("numpy.core.multiarray", "_reconstruct"): _reconstruct,  # as numpy 1.x names it
    ("numpy", "ndarray"): np.ndarray,
    ("numpy", "dtype"): np.dtype,
    ("types", "SimpleNamespace"): types.SimpleNamespace,
}


class _Unpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        try:
            return _ALLOWED[(module, name)]
        except KeyError:
            raise pickle.UnpicklingError(
                f"a scaler pickle may not name {module}.{name}") from None


class MinMaxScaler:
    def __init__(self, scale_, min_, feature_range: Tuple[float, float] = (-0.7, 0.7),
                 data_min_=None, data_max_=None):
        self.scale_ = scale_
        self.min_ = min_
        self.feature_range = tuple(feature_range)
        self.data_min_ = data_min_
        self.data_max_ = data_max_

    def to(self, device) -> "MinMaxScaler":
        """A copy whose arrays are f32 tensors on ``device``."""
        return MinMaxScaler(
            torch.as_tensor(self.scale_, dtype=torch.float32, device=device),
            torch.as_tensor(self.min_, dtype=torch.float32, device=device),
            self.feature_range)

    def transform(self, x):
        return x * self.scale_ + self.min_

    def inverse_transform(self, x):
        return (x - self.min_) / self.scale_

    @classmethod
    def load(cls, path: str) -> "MinMaxScaler":
        """Read a scaler pickle written by sklearn (the JAX package) or by
        :meth:`save`; the statistics come back as they were stored (f64)."""
        with open(path, "rb") as f:
            obj = _Unpickler(f).load()
        return cls(np.asarray(obj.scale_), np.asarray(obj.min_),
                   tuple(obj.feature_range), np.asarray(obj.data_min_),
                   np.asarray(obj.data_max_))

    def save(self, path: str) -> None:
        """Pickle the statistics as a ``types.SimpleNamespace`` with sklearn's
        attribute names. Where the data range is unknown (a scaler made from
        ``scale_`` and ``min_`` alone) it is derived from them:
        ``data_min_ = (fmin - min_) / scale_``, ``data_max_ = data_min_ +
        (fmax - fmin) / scale_``."""
        scale = np.asarray(self.scale_, np.float64)
        min_ = np.asarray(self.min_, np.float64)
        fmin, fmax = self.feature_range
        data_min = (np.asarray(self.data_min_, np.float64) if self.data_min_ is not None
                    else (fmin - min_) / scale)
        data_max = (np.asarray(self.data_max_, np.float64) if self.data_max_ is not None
                    else data_min + (fmax - fmin) / scale)
        obj = types.SimpleNamespace(feature_range=self.feature_range, data_min_=data_min,
                                    data_max_=data_max, scale_=scale, min_=min_)
        with open(path, "wb") as f:
            pickle.dump(obj, f)
