"""Port batch assembly (simulgen_vae_tpu_torch.ops.gather_augment) vs the JAX
kernel, which runs here in Pallas interpret mode without its in-kernel noise
(``with_noise=False``: the TPU PRNG has no CPU lowering).

* Deterministic part (gather, amplitude, mixup): f32 atol 1e-6, bf16 atol
  1e-2 (one bf16 rounding of values of order 1; the JAX test's own bounds).
* With noise supplied from outside, the plain version against the JAX
  ``gather_augment_reference``: the same f32 composition, atol 1e-6.
* The per-sample scalars drawn on the host have ``augment_batch``'s
  distributions (as tests/test_gather_augment.py checks the JAX draws).

On the card ``chip_smoke.py`` holds the CUDA kernel against the plain version
(no-noise bits equal; noise by its mean and spread).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simulgen_vae_tpu.ops import gather_augment as jga
from simulgen_vae_tpu_torch.data.augmentation import AugmentationConfig, augment_batch
from simulgen_vae_tpu_torch.ops import gather_augment as tga

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-6),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 1e-2)}


def _mk(n=8, t=24, nodes=600, seed=0):
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((n, t, nodes)).astype(np.float32)
    idx = rng.integers(0, n, 5).astype(np.int32)
    pidx = rng.integers(0, n, 5).astype(np.int32)
    lam = np.asarray([1.0, 0.3, 0.9, 1.0, 0.5], np.float32)
    amp = np.asarray([1.0, 1.1, 0.95, 1.05, 1.0], np.float32)
    return data, idx, pidx, lam, amp


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_deterministic_path_matches_jax_kernel(dtype):
    jdt, tdt, atol = DTYPES[dtype]
    data, idx, pidx, lam, amp = _mk()
    sd = np.zeros(5, np.float32)
    want = jga.gather_augment(jnp.asarray(data, jdt), jnp.asarray(idx), jnp.asarray(pidx),
                              7, jnp.asarray(lam), jnp.asarray(amp), jnp.asarray(sd),
                              tile_n=256, interpret=True, with_noise=False)
    tga.reset_launch_counts()
    got = tga.gather_augment(torch.from_numpy(data).to(tdt), *map(torch.from_numpy, (
        idx, pidx)), torch.tensor([7], dtype=torch.int32), *map(torch.from_numpy, (lam, amp, sd)))
    assert got.dtype == tdt and tga.LAUNCHES["gather_augment"] == 0
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=1e-5, atol=atol)


def test_supplied_noise_matches_jax_reference():
    data, idx, pidx, lam, amp = _mk(seed=1)
    sd = np.asarray([0.05, 0.0, 0.05, 0.05, 0.0], np.float32)
    noise = np.random.default_rng(2).standard_normal((5, 24, 600)).astype(np.float32)
    want = jga.gather_augment_reference(*map(jnp.asarray, (data, idx, pidx, noise, lam,
                                                           amp, sd)))
    got = tga.gather_augment_reference(*map(torch.from_numpy, (data, idx, pidx, noise,
                                                               lam, amp, sd)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_cpu_noise_is_standard_normal_and_follows_the_generator():
    data, idx, _, _, _ = _mk(n=4, t=64, nodes=1024, seed=3)
    idx = torch.tensor([0, 1, 2], dtype=torch.int32)
    ones = torch.ones(3)
    sd = torch.tensor([0.05, 0.0, 0.05])
    d = torch.from_numpy(data)
    seed = torch.tensor([tga.seed_word(11)], dtype=torch.int32)
    out = tga.gather_augment(d, idx, idx, seed, ones, ones, sd,
                             generator=torch.Generator().manual_seed(4))
    again = tga.gather_augment(d, idx, idx, seed, ones, ones, sd,
                               generator=torch.Generator().manual_seed(4))
    assert torch.equal(out, again)
    x = d.index_select(0, idx.long())
    assert torch.equal(out[1], x[1])  # sd == 0: unchanged
    z = ((out - x)[[0, 2]] / 0.05).numpy()
    assert abs(z.mean()) < 0.02 and abs(z.std() - 1.0) < 0.02


def test_draw_augment_scalars_distributions():
    """Host draws reproduce augment_batch's per-sample distributions."""
    b = 20000
    lam, amp, sd = tga.draw_augment_scalars(np.random.default_rng(0), b)
    assert lam.dtype == amp.dtype == sd.dtype == np.float32
    assert abs((sd > 0).mean() - 0.5) < 0.02
    assert abs((amp != 1.0).mean() - 0.5) < 0.02
    assert abs((lam != 1.0).mean() - 0.5) < 0.02
    assert np.all(sd[sd > 0] == np.float32(0.05))
    a = amp[amp != 1.0]
    assert a.min() >= 0.9 and a.max() <= 1.1 and abs(a.mean() - 1.0) < 0.005
    lm = lam[lam != 1.0]
    assert lm.min() >= 0.1 and lm.max() <= 0.9
    # Beta(.2, .2) clamped is bimodal at the clamp points
    assert (lm == np.float32(0.1)).mean() > 0.2 and (lm == np.float32(0.9)).mean() > 0.2


def test_wrapper_rejects_other_devices():
    data = torch.empty((2, 3, 8), device="meta")
    v = torch.empty(2, device="meta")
    with pytest.raises(ValueError):
        tga.gather_augment(data, v.int(), v.int(), v[:1].int(), v, v, v)


def test_augment_batch_disabled_and_deterministic_parts():
    rng = np.random.default_rng(5)
    batch = torch.from_numpy(rng.standard_normal((6, 10, 32)).astype(np.float32))
    partner = torch.from_numpy(rng.standard_normal((6, 10, 32)).astype(np.float32))
    assert augment_batch(batch, partner, AugmentationConfig(enabled=False)) is batch
    only_scale = AugmentationConfig(noise_prob=0, scaling_prob=1.0,
                                    scaling_range=(1.25, 1.25), mixup_prob=0)
    got = augment_batch(batch, partner, only_scale, torch.Generator().manual_seed(0))
    np.testing.assert_allclose(got.numpy(), 1.25 * batch.numpy(), rtol=1e-6)
    only_mix = AugmentationConfig(noise_prob=0, scaling_prob=0, mixup_prob=1.0)
    got = augment_batch(batch, partner, only_mix, torch.Generator().manual_seed(1))
    lam = ((got - partner) / (batch - partner)).numpy()  # one lam per sample
    assert np.allclose(lam, lam[:, :1, :1], atol=1e-4)
    assert lam.min() >= 0.1 - 1e-3 and lam.max() <= 0.9 + 1e-3  # recovered by division


def test_augment_batch_shift_and_cutout():
    batch = torch.arange(1.0, 1.0 + 4 * 10 * 3).reshape(4, 10, 3)
    shift = AugmentationConfig(noise_prob=0, scaling_prob=0, mixup_prob=0,
                               shift_prob=1.0, shift_max=0.3)
    got = augment_batch(batch, batch, shift, torch.Generator().manual_seed(2))
    for i in range(4):
        s = next(s for s in range(-3, 4)
                 if torch.equal(got[i, max(s, 0):10 + min(s, 0)],
                                batch[i, max(-s, 0):10 - max(s, 0)]))
        assert (got[i, :max(s, 0)] == 0).all() and (got[i, 10 + min(s, 0):] == 0).all()
    cut = AugmentationConfig(noise_prob=0, scaling_prob=0, mixup_prob=0,
                             cutout_prob=1.0, cutout_max=0.3)
    got = augment_batch(batch, batch, cut, torch.Generator().manual_seed(3))
    zeroed = (got == 0).all(dim=2)
    assert zeroed.any(dim=1).all() and (zeroed.sum(dim=1) <= 3).all()
    assert torch.equal(got[~zeroed], batch[~zeroed])


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1])
def test_seed_word_stages_the_seeds_bits(seed):
    """The kernel reads its seed from an int32 word on the card: the word
    holds the seed's 32 bits."""
    word = tga.seed_word(seed)
    assert -2 ** 31 <= word < 2 ** 31
    assert int(np.array([word], np.int32).view(np.uint32)[0]) == seed


@pytest.mark.parametrize("seed", [-1, 2 ** 32])
def test_seed_word_refuses_seeds_outside_32_bits(seed):
    with pytest.raises(ValueError):
        tga.seed_word(seed)


@pytest.mark.parametrize("rows,parts,fold", [(None, 1, 0), (None, 2, 1), (slice(2, 4), 1, 2),
                                             (slice(2, 4), 2, 3)])
def test_sharded_noise_follows_the_staged_rank_seed(rows, parts, fold):
    """A rank's seed is folded in on the host (the data coordinate where the
    batch is split, the model coordinate where the nodes are) and staged as
    the one-device seed is; on the CPU the plain version's noise comes from a
    generator seeded with it."""
    import types

    mesh = types.SimpleNamespace(shape={"data": 2, "model": 2}, coords={"data": 1, "model": 1})
    seed = tga.rank_seed(mesh, 2 ** 31 + 5, rows, parts)
    assert seed == (2 ** 31 + 5 + fold * 0x9E3779B) % 2 ** 32
    data, idx, pidx, lam, amp = _mk(n=6, t=8, nodes=64, seed=4)
    d, idx, pidx = torch.from_numpy(data), torch.from_numpy(idx), torch.from_numpy(pidx)
    lam, amp = torch.from_numpy(lam), torch.from_numpy(amp)
    sd = torch.full((idx.shape[0],), 0.05)
    staged = torch.tensor([tga.seed_word(seed)], dtype=torch.int32)
    got = tga.gather_augment_sharded(d, idx, pidx, staged, lam, amp, sd, rows=rows)
    r = rows or slice(None)
    want = tga.gather_augment(d, idx[r], pidx[r], staged, lam[r], amp[r], sd[r],
                              generator=torch.Generator().manual_seed(seed))
    assert got.shape[0] == (2 if rows else idx.shape[0]) and torch.equal(got, want)
