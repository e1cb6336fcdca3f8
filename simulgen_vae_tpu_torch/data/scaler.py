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
run code. ``data/pca.py`` reads its PCA pickles through the same unpickler
(:func:`restricted_load`). ``save`` writes the five attributes the JAX package's
``MinMaxScaler.from_sklearn`` reads, so the JAX package loads it too.

Fitting follows the JAX package bit for bit: :meth:`MinMaxScaler.fit` takes
sklearn's statistics (a constant feature scales by 1), :func:`data_scaler`
fits the field scaler on at most 50k sampled ``(param, time)`` rows drawn
with ``np.random.seed(42)`` and the same flat-index arithmetic, and
:func:`latent_conditioner_scaler` fits one scaler per array (a 3-D array
flattened to ``[rows, -1]``).
"""

from __future__ import annotations

import pickle
import types
from typing import Optional, Tuple

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
                f"a scaler or PCA pickle may not name {module}.{name}") from None


def restricted_load(f):
    """Unpickle from the open binary file ``f``, resolving only the globals
    of ``_ALLOWED``: a scaler pickle's, or a PCA pickle's (``data/pca.py``:
    a dict of numpy arrays and plain Python values)."""
    return _Unpickler(f).load()


class MinMaxScaler:
    def __init__(self, scale_=None, min_=None,
                 feature_range: Tuple[float, float] = (-0.7, 0.7),
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

    def fit(self, x: np.ndarray) -> "MinMaxScaler":
        """sklearn's statistics over axis 0: ``scale_ = (fmax - fmin) /
        (data_max - data_min)`` (a zero range scales by 1), ``min_ = fmin -
        data_min * scale_``, in x's dtype."""
        x = np.asarray(x)
        fmin, fmax = self.feature_range
        self.data_min_ = np.min(x, axis=0)
        self.data_max_ = np.max(x, axis=0)
        data_range = self.data_max_ - self.data_min_
        safe_range = np.where(data_range == 0.0, 1.0, data_range)
        self.scale_ = (fmax - fmin) / safe_range
        self.min_ = fmin - self.data_min_ * self.scale_
        return self

    def fit_transform(self, x: np.ndarray):
        return self.fit(x).transform(x)

    def transform(self, x):
        return x * self.scale_ + self.min_

    def inverse_transform(self, x):
        return (x - self.min_) / self.scale_

    @classmethod
    def load(cls, path: str) -> "MinMaxScaler":
        """Read a scaler pickle written by sklearn (the JAX package) or by
        :meth:`save`; the statistics come back as they were stored (f64)."""
        with open(path, "rb") as f:
            obj = restricted_load(f)
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


def data_scaler(fom_data: np.ndarray, num_time: int, num_node: int,
                save_path: Optional[str] = "model_save/scaler.pkl",
                max_fit_samples: int = 50000, seed: int = 42
                ) -> Tuple[np.ndarray, Tuple[int, ...], MinMaxScaler]:
    """Fit and apply the (-0.7, 0.7) field scaler on ``[P, T, N]`` data.

    The fit sees ``min(max_fit_samples, P * T // 10)`` rows (at least 1000,
    or all of them) drawn without replacement after ``np.random.seed(seed)``.
    Returns ``(scaled f32 data, data shape without P, scaler)`` and pickles
    the scaler to ``save_path`` unless it is None.
    """
    total_samples = fom_data.shape[0] * fom_data.shape[1]

    max_samples = min(max_fit_samples, total_samples // 10)
    if max_samples < 1000:
        max_samples = min(1000, total_samples)

    np.random.seed(seed)
    if total_samples > max_samples:
        sample_indices = np.random.choice(total_samples, max_samples, replace=False)
    else:
        sample_indices = np.arange(total_samples)

    param_indices = sample_indices // num_time
    time_indices = sample_indices % num_time
    representative = fom_data[param_indices, time_indices, :]

    scaler = MinMaxScaler(feature_range=(-0.7, 0.7))
    scaler.fit(representative)

    flat = fom_data.reshape(-1, num_node)
    scaled = scaler.transform(flat).astype(np.float32).reshape(fom_data.shape)

    if save_path is not None:
        scaler.save(save_path)

    return scaled, scaled.shape[1:], scaler


def latent_conditioner_scaler(data: np.ndarray, name: Optional[str] = None
                              ) -> Tuple[np.ndarray, MinMaxScaler]:
    """Fit and apply a (-0.7, 0.7) scaler on one array (``[rows, ...]``, a
    3-D array over its flattened trailing axes); pickled to ``name`` unless
    it is None. An empty array raises."""
    original_shape = data.shape
    if original_shape[0] == 0:
        raise ValueError(
            f"Empty data array detected with shape {original_shape}. "
            "Please check your data loading configuration."
        )

    if len(original_shape) == 3:
        reshaped = data.reshape(original_shape[0], -1)
    else:
        reshaped = data

    scaler = MinMaxScaler(feature_range=(-0.7, 0.7))
    scaled = scaler.fit_transform(reshaped)

    if len(original_shape) == 3:
        scaled = scaled.reshape(original_shape)

    if name is not None:
        scaler.save(name)

    return scaled, scaler
