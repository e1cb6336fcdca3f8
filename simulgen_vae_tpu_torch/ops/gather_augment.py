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
noise is drawn in the kernel from Philox keyed by ``seed``). Every argument
is a tensor on the data's device, the seed too (one ``int32`` word holding
its 32 bits): the kernel reads each step's values from device memory, so a
CUDA graph that captured the call replays it with the values copied in
before each replay. The trainer stages them all with one copy
(``utils.staging``). On the CPU it takes :func:`gather_augment_reference`
with noise from ``torch.randn``. The two give different noise for the same
seed; without noise they give the same bits. The launch count is in
``LAUNCHES``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from simulgen_vae_tpu_torch.ops import _build
from simulgen_vae_tpu_torch.utils import profiling

LAUNCHES = profiling.register({"gather_augment": 0})

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


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


def seed_word(seed: int) -> int:
    """``seed`` (in ``[0, 2**32)``) as the ``int32`` word that stages it."""
    if not 0 <= seed < 2 ** 32:
        raise ValueError(f"seed {seed} outside [0, 2**32)")
    return seed - 2 ** 32 if seed >= 2 ** 31 else seed


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
    for name, v, dtype, n in zip(("idx", "pidx", "seed", "lam_eff", "amp", "noise_sd"), vecs,
                                 (torch.int32,) * 3 + (torch.float32,) * 3,
                                 (b, b, 1, b, b, b)):
        if (v.device != data.device or v.dtype != dtype or tuple(v.shape) != (n,)
                or not v.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {dtype} [{n}] tensor on "
                             f"{data.device}")


def gather_augment(data: torch.Tensor, idx: torch.Tensor, pidx: torch.Tensor,
                   seed: torch.Tensor, lam_eff: torch.Tensor, amp: torch.Tensor,
                   noise_sd: torch.Tensor,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """``[b, T, N]`` augmented batch from the ``[n, T, N]`` dataset.

    ``idx``/``pidx`` are int32 row indices in ``[0, n)`` (not checked on the
    card: checking would cost a device sync), ``seed`` an int32 ``[1]``
    tensor holding the 32 bits that key the kernel's noise
    (:func:`seed_word`); ``generator`` draws the plain version's noise on the
    CPU, where the seed is not read."""
    if data.device.type == "cpu":
        noise = None
        if bool((noise_sd != 0).any()):
            noise = torch.randn((idx.shape[0], *data.shape[1:]), generator=generator)
        return gather_augment_reference(data, idx, pidx, noise, lam_eff, amp, noise_sd)
    _check(data, (idx, pidx, seed, lam_eff, amp, noise_sd))
    fn = _build.load("gather_augment").gather_augment
    if fn.argtypes is None:
        fn.argtypes = [_P] * 7 + [_I, _LL, _P, _I, _P]
        fn.restype = ctypes.c_int
    b = idx.shape[0]
    out = torch.empty((b, *data.shape[1:]), device=data.device, dtype=data.dtype)
    with torch.cuda.device(data.device):
        err = fn(*(ctypes.c_void_p(t.data_ptr())
                   for t in (data, idx, pidx, lam_eff, amp, noise_sd, out)), b,
                 data.shape[1] * data.shape[2], ctypes.c_void_p(seed.data_ptr()),
                 _DTYPE_CODES[data.dtype],
                 ctypes.c_void_p(torch.cuda.current_stream(data.device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"gather_augment launch failed with cudaError {err}")
    LAUNCHES["gather_augment"] += 1
    return out


def rank_seed(mesh, seed: int, rows: Optional[slice], node_parts: int) -> int:
    """The noise seed of this rank of a ``('data', 'model')`` mesh: the
    rank's mesh coordinates folded into ``seed`` on the host, as JAX folds
    the device index; the data coordinate only where the batch is split
    (``rows`` not None), so that ranks holding the same rows draw the same
    noise."""
    d = 0 if rows is None else mesh.coords["data"]
    m = mesh.coords["model"] if node_parts > 1 else 0
    return (seed + (d * mesh.shape["model"] + m) * 0x9E3779B) % 2 ** 32


def gather_augment_sharded(data: torch.Tensor, idx: torch.Tensor, pidx: torch.Tensor,
                           seed: torch.Tensor, lam_eff: torch.Tensor, amp: torch.Tensor,
                           noise_sd: torch.Tensor, rows: Optional[slice]) -> torch.Tensor:
    """:func:`gather_augment` on one rank of a ``('data', 'model')`` mesh
    (the JAX ``gather_augment_sharded``).

    ``data`` is this rank's ``[n, T, N / node_parts]`` block of the resident
    dataset (:func:`dataset_replicated_rows`: every row, this rank's nodes);
    ``idx``, ``pidx`` and the scalars are the whole batch's, drawn alike on
    every rank; ``seed`` is this rank's (:func:`rank_seed`, staged as
    :func:`gather_augment` takes it); ``rows`` is this rank's block of the
    batch (None: all of it, where the data axis does not divide the batch).
    The kernel assembles those rows at this rank's nodes. On the CPU the
    plain version draws its noise from a generator seeded with the rank's
    seed."""
    rows = rows or slice(None)
    generator = (torch.Generator().manual_seed(int(seed[0]) % 2 ** 32)
                 if data.device.type == "cpu" else None)
    return gather_augment(data, idx[rows], pidx[rows], seed, lam_eff[rows], amp[rows],
                          noise_sd[rows], generator=generator)


def dataset_replicated_rows(data: torch.Tensor, mesh, node_parts: int) -> torch.Tensor:
    """The resident dataset laid out for :func:`gather_augment_sharded`
    (JAX's ``dataset_replicated_rows_sharding``): every row, replicated over
    ``data``; this rank's block of the nodes when ``node_parts`` split them.
    A contiguous copy."""
    if node_parts == 1:
        return data.contiguous()
    n = data.shape[-1] // node_parts
    return data.narrow(-1, mesh.coords["model"] * n, n).contiguous()
