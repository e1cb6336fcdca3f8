"""Plain reference of the train step's batch assembly: the host's draws and
the augmented batch, from the trainer's seed.

The trainer draws on the host from ``numpy.random.default_rng(seed)``: at
an epoch's start a permutation of the ``n`` rows (wrap-padded to whole
batches); for each step the mixup partners, then the augmentation scalars
(noise sd, amplitude, mixup lambda), then a 31-bit seed that keys the noise.
The noise is Philox-4x32-10 keyed by ``(seed, 0x5EED5EED)`` with the counter
``(element // 4, sample)``; its four words give four normals by Box-Muller
(both cos and sin), those of elements ``4q .. 4q+3``. Each row is

    x   = data[idx] + noise * sd
    out = lam * (x * amp) + (1 - lam) * data[partner]

computed here in f32, without the program's rounding to its data type.
"""

from __future__ import annotations

import math

import numpy as np
import torch

M32 = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_KEY1 = 0x5EED5EED


def epoch_batches(rng: np.random.Generator, n: int, batch: int) -> np.ndarray:
    """An epoch's ``[steps, batch]`` row indices."""
    steps = max(-(-n // batch), 1)
    perm = rng.permutation(n)
    pad = steps * batch - n
    if pad:
        perm = np.concatenate([perm, perm[:pad]])
    return perm.reshape(steps, batch)


def step_draws(rng: np.random.Generator, n: int, batch: int, aug: dict) -> dict:
    """One step's partners, scalars and noise seed, in the trainer's order."""
    partners = rng.integers(0, n, batch)
    noise_sd = np.where(rng.random(batch) < aug["noise_prob"], aug["noise_level"], 0.0)
    lo, hi = aug["scaling_range"]
    scale = rng.uniform(lo, hi, batch)
    amp = np.where(rng.random(batch) < aug["scaling_prob"], scale, 1.0)
    lam = np.clip(rng.beta(aug["mixup_alpha"], aug["mixup_alpha"], batch), 0.1, 0.9)
    lam = np.where(rng.random(batch) < aug["mixup_prob"], lam, 1.0)
    seed = int(rng.integers(0, 2 ** 31 - 1))
    return dict(partners=partners, noise_sd=noise_sd.astype(np.float32),
                amp=amp.astype(np.float32), lam=lam.astype(np.float32), seed=seed)


def first_steps(seed: int, n: int, batch: int, aug: dict, steps: int) -> list:
    """The draws of the first ``steps`` steps of the first epoch:
    ``[{"rows", "partners", "noise_sd", "amp", "lam", "seed"}, ...]``."""
    rng = np.random.default_rng(seed)
    rows = epoch_batches(rng, n, batch)[:steps]
    return [dict(rows=r, **step_draws(rng, n, batch, aug)) for r in rows]


def _mulhilo(a: int, b: torch.Tensor):
    """``(hi, lo)`` 32-bit words of ``a * b`` for ``b`` an int64 tensor of
    uint32 values, in pieces that never leave int64."""
    a_lo, a_hi = a & 0xFFFF, a >> 16
    p1, p2 = b * a_lo, b * a_hi  # each below 2**48
    lo = (((p2 & 0xFFFF) << 16) + p1) & M32
    hi = ((p2 + (p1 >> 16)) >> 16) & M32
    return hi, lo


def philox(c0, c1, c2, c3, k0: int, k1: int) -> tuple:
    """Philox-4x32-10 of the counters (int64 tensors of uint32 values) under
    the key ``(k0, k1)``: four words, each a tensor like the counters."""
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & M32, (k1 + _W1) & M32
    return c0, c1, c2, c3


def philox_normals(seed: int, sample: int, count: int, device) -> torch.Tensor:
    """The ``count`` standard normals of one sample's row."""
    q = torch.arange(-(-count // 4), device=device, dtype=torch.int64)
    c0, c1, c2, c3 = philox(q & M32, q >> 32, torch.full_like(q, sample & M32),
                            torch.zeros_like(q), seed & M32, _KEY1)
    out = []
    for a, b in ((c0, c1), (c2, c3)):
        u1 = ((a >> 8) + 1).to(torch.float32) * (1.0 / 16777216.0)
        u2 = (b >> 8).to(torch.float32) * (1.0 / 16777216.0)
        rad = torch.sqrt(-2.0 * torch.log(u1))
        out += [rad * torch.cos(2.0 * math.pi * u2), rad * torch.sin(2.0 * math.pi * u2)]
    return torch.stack(out, dim=1).reshape(-1)[:count]


def assemble(rows: torch.Tensor, partners: torch.Tensor, draws: dict,
             noise: bool = True) -> torch.Tensor:
    """The f32 batch from its rows and partner rows (``[B, T, N]`` each, any
    float type) and the step's draws."""
    b = rows.shape[0]
    x = rows.float()
    if noise:
        x = x.clone()
        for i in range(b):
            sd = float(draws["noise_sd"][i])
            if sd != 0.0:
                n = philox_normals(draws["seed"], i, x[i].numel(), x.device)
                x[i] += (n * sd).reshape(x[i].shape)
    dev = x.device
    lam = torch.as_tensor(draws["lam"], device=dev)[:, None, None]
    amp = torch.as_tensor(draws["amp"], device=dev)[:, None, None]
    return lam * (x * amp) + (1.0 - lam) * partners.float()
