"""Batch assembly for the VAE train step: row gather + noise + amplitude + mixup.

Counterpart of ``simulgen_vae_tpu/ops/gather_augment.py``. For batch row i:

    x   = data[idx[i]] + n * noise_sd[i]          (n ~ N(0, 1), elementwise)
    out = lam[i] * (x * amp[i]) + (1 - lam[i]) * data[pidx[i]]

with ``noise_sd[i] in {0, level}``, ``amp[i] in {1, U[lo, hi]}`` and
``lam[i] in {1, clip(Beta(a, a), .1, .9)}`` from :func:`draw_augment_scalars`:
the distributions of the sequential composition in
``data.augmentation.augment_batch``.

On the card :func:`gather_augment` launches the hand-written kernel
``ops/csrc/gather_augment.cu`` (one pass: two rows read, one written; the
noise is drawn in the kernel from Philox keyed by ``seed``). On the CPU it
takes :func:`gather_augment_reference` with noise from ``torch.randn``. The
two give different noise for the same seed; without noise they give the same
bits. The launch count is in ``LAUNCHES``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from simulgen_vae_tpu_torch.ops import _build

LAUNCHES = {"gather_augment": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _LL, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint


def reset_launch_counts() -> None:
    LAUNCHES["gather_augment"] = 0


def draw_augment_scalars(rng: np.random.Generator, b: int,
                         noise_prob: float = 0.5, noise_level: float = 0.05,
                         scaling_prob: float = 0.5,
                         scaling_range: Tuple[float, float] = (0.9, 1.1),
                         mixup_prob: float = 0.5, mixup_alpha: float = 0.2,
                         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-sample ``(lam_eff, amp, noise_sd)``, each ``[b]`` f32, drawn on the
    host from ``rng`` (three ``[b]`` vectors a step, no device sync)."""
    noise_sd = np.where(rng.random(b) < noise_prob, noise_level, 0.0)
    lo, hi = scaling_range
    scale = rng.uniform(lo, hi, b)
    amp = np.where(rng.random(b) < scaling_prob, scale, 1.0)
    lam = np.clip(rng.beta(mixup_alpha, mixup_alpha, b), 0.1, 0.9)
    lam_eff = np.where(rng.random(b) < mixup_prob, lam, 1.0)
    return (lam_eff.astype(np.float32), amp.astype(np.float32),
            noise_sd.astype(np.float32))


def gather_augment_reference(data: torch.Tensor, idx: torch.Tensor,
                             pidx: torch.Tensor, normal_noise: Optional[torch.Tensor],
                             lam_eff: torch.Tensor, amp: torch.Tensor,
                             noise_sd: torch.Tensor) -> torch.Tensor:
    """Plain version (the JAX ``gather_augment_reference``): the same math in
    f32 with noise supplied from outside (None: no noise)."""
    x = data.index_select(0, idx.long()).float()
    p = data.index_select(0, pidx.long()).float()
    sd, a, lam = (v.float()[:, None, None] for v in (noise_sd, amp, lam_eff))
    if normal_noise is not None:
        x = x + normal_noise * sd
    return (lam * (x * a) + (1.0 - lam) * p).to(data.dtype)


def _check(data, vecs) -> None:
    if data.device.type != "cuda":
        raise ValueError(f"expected a CUDA tensor, got one on {data.device}")
    if data.dim() != 3 or not data.is_contiguous():
        raise ValueError(f"data must be a contiguous [n, T, N] tensor, got "
                         f"{tuple(data.shape)}")
    if data.dtype not in _DTYPE_CODES:
        raise TypeError(f"unsupported dtype {data.dtype} (float32 or bfloat16)")
    b = vecs[0].shape[0]
    if not 0 < b <= 65535:
        raise ValueError(f"batch of {b} rows")
    for name, v, dtype in zip(("idx", "pidx", "lam_eff", "amp", "noise_sd"), vecs,
                              (torch.int32, torch.int32) + (torch.float32,) * 3):
        if (v.device != data.device or v.dtype != dtype or tuple(v.shape) != (b,)
                or not v.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {dtype} [{b}] tensor on "
                             f"{data.device}")


def gather_augment(data: torch.Tensor, idx: torch.Tensor, pidx: torch.Tensor,
                   seed: int, lam_eff: torch.Tensor, amp: torch.Tensor,
                   noise_sd: torch.Tensor,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """``[b, T, N]`` augmented batch from the ``[n, T, N]`` dataset.

    ``idx``/``pidx`` are int32 row indices in ``[0, n)`` (not checked on the
    card: checking would cost a device sync), ``seed`` a non-negative int
    below 2**32 keying the kernel's noise; ``generator`` draws the plain
    version's noise on the CPU."""
    if data.device.type == "cpu":
        noise = None
        if bool((noise_sd != 0).any()):
            noise = torch.randn((idx.shape[0], *data.shape[1:]), generator=generator)
        return gather_augment_reference(data, idx, pidx, noise, lam_eff, amp, noise_sd)
    vecs = (idx, pidx, lam_eff, amp, noise_sd)
    _check(data, vecs)
    if not 0 <= seed < 2 ** 32:
        raise ValueError(f"seed {seed} outside [0, 2**32)")
    fn = _build.load("gather_augment").gather_augment
    if fn.argtypes is None:
        fn.argtypes = [_P] * 7 + [_I, _LL, _U, _I, _P]
        fn.restype = ctypes.c_int
    b = idx.shape[0]
    out = torch.empty((b, *data.shape[1:]), device=data.device, dtype=data.dtype)
    with torch.cuda.device(data.device):
        err = fn(*(ctypes.c_void_p(t.data_ptr()) for t in (data, *vecs, out)), b,
                 data.shape[1] * data.shape[2], seed, _DTYPE_CODES[data.dtype],
                 ctypes.c_void_p(torch.cuda.current_stream(data.device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"gather_augment launch failed with cudaError {err}")
    LAUNCHES["gather_augment"] += 1
    return out
