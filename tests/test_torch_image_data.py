"""The port's image reader and outline-preserving augmentation against the
JAX package's:

* ``_affine_resample`` at given angles and scales on JAX's grid, the flip
  and the roll at given shifts: atol 1e-6 (the resample is JAX's formula,
  not ``F.grid_sample``); the port's own grid within one f32 ulp of
  ``jnp.linspace`` (XLA rounds its expression differently), and the
  resample on it within 8e-6 (four f32 ulps of a coordinate below 32);
* the gates by frequency over 4000 calls: the whole call .5 (``prob``), the
  flip's batch gate .3 and its per-sample .5, the roll's .5, rotation and
  scale .3, ``augment_images``' ``apply_prob``; each within 0.03;
* ``read_latent_conditioner_dataset_img`` on PNGs and JPEGs written to a
  temporary directory with OpenCV, in natural filename order: the same bits
  as JAX's reader; ``natsorted`` as JAX's.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simulgen_vae_tpu.data import image_augmentation as jaug
from simulgen_vae_tpu.data import images as jimages
from simulgen_vae_tpu_torch.data import image_augmentation as taug
from simulgen_vae_tpu_torch.data import images as timages


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    return (rng.random((5, 24, 24)) > 0.6).astype(np.float32)


@pytest.mark.parametrize("angles, scales", [
    ([0.0, 3.0, -4.5, 5.0, -0.8], [1.0, 1.0, 0.96, 1.04, 1.02]),
    ([2.0, -2.0, 1.0, 0.0, -5.0], [0.95, 1.05, 1.0, 0.98, 1.0]),
])
def test_affine_resample_matches_jax(batch, angles, scales, monkeypatch):
    rad = np.float32(np.asarray(angles) * math.pi / 180.0)
    cos, sin, s = np.cos(rad), np.sin(rad), np.float32(scales)
    want = np.stack([np.asarray(jaug._affine_resample(jnp.asarray(img), c, si, k))
                     for img, c, si, k in zip(batch, cos, sin, s)])
    args = (torch.from_numpy(batch), *map(torch.from_numpy, (cos, sin, s)))
    own = taug._affine_resample(*args)
    np.testing.assert_allclose(own.numpy(), want, atol=8e-6, rtol=0)
    monkeypatch.setattr(taug, "_grid", lambda n, device: torch.from_numpy(
        np.array(jnp.linspace(-1.0, 1.0, n))))
    got = taug._affine_resample(*args)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("n", [24, 37, 256])
def test_grid_is_within_an_ulp_of_jnp_linspace(n):
    got = taug._grid(n, "cpu").numpy()
    want = np.asarray(jnp.linspace(-1.0, 1.0, n))
    assert got[0] == -1.0 and got[-1] == 1.0
    np.testing.assert_allclose(got, want, atol=np.finfo(np.float32).eps, rtol=0)


def test_flip_and_roll_match_jax(batch):
    shifts_x, shifts_y = np.array([-1, 0, 1, 1, -1]), np.array([1, -1, 0, 1, -1])
    want = np.stack([np.asarray(jnp.roll(jnp.roll(jnp.asarray(img), sx, axis=1), sy, axis=0))
                     for img, sx, sy in zip(batch, shifts_x, shifts_y)])
    got = taug._roll(torch.from_numpy(batch), torch.from_numpy(shifts_x),
                     torch.from_numpy(shifts_y))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(torch.from_numpy(batch).flip(2).numpy(),
                                  np.asarray(jnp.flip(jnp.asarray(batch), axis=2)))


def _recording_uniform(calls: list):
    """torch.rand recording each draw's shape and values."""
    real = torch.rand

    def rand(*shape, **kw):
        out = real(*shape, **kw)
        calls.append(out)
        return out

    return rand


def test_gates_by_frequency(batch, monkeypatch):
    x = torch.from_numpy(batch)
    gen = torch.Generator().manual_seed(0)
    calls = []
    monkeypatch.setattr(taug.torch, "rand", _recording_uniform(calls))
    n = 4000
    counts = dict(applied=0, flip_gate=0, flipped=0, flip_draws=0, roll_gate=0, rot_gate=0,
                  scale_gate=0, aug_applied=0)
    for _ in range(n):
        calls.clear()
        out = taug.apply_outline_preserving_augmentations(x, gen, prob=0.5)
        # draws in order: flip gate, flip mask [B,1,1], roll gate, angles'
        # gate, angles [B], scale gate, scales [B], the whole-call gate
        flip_gate, flip_mask, roll_gate, rot_gate, _, scale_gate, _, whole = calls
        counts["applied"] += int(whole < 0.5)
        counts["flip_gate"] += int(flip_gate < 0.3)
        counts["flipped"] += int((flip_mask < 0.5).sum())
        counts["flip_draws"] += flip_mask.numel()
        counts["roll_gate"] += int(roll_gate < 0.5)
        counts["rot_gate"] += int(rot_gate < 0.3)
        counts["scale_gate"] += int(scale_gate < 0.3)
        if whole >= 0.5:
            assert torch.equal(out, x)
    for _ in range(n // 4):
        calls.clear()
        taug.augment_images(x.reshape(5, -1), gen, prob=0.8, apply_prob=0.5)
        counts["aug_applied"] += int(calls[0] < 0.5)
    assert abs(counts["applied"] / n - 0.5) < 0.03
    assert abs(counts["flip_gate"] / n - 0.3) < 0.03
    assert abs(counts["flipped"] / counts["flip_draws"] - 0.5) < 0.03
    assert abs(counts["roll_gate"] / n - 0.5) < 0.03
    assert abs(counts["rot_gate"] / n - 0.3) < 0.03
    assert abs(counts["scale_gate"] / n - 0.3) < 0.03
    assert abs(counts["aug_applied"] / (n // 4) - 0.5) < 0.05


def test_small_angles_and_scales_leave_the_image_unresampled(batch, monkeypatch):
    """Rotation only where |angle| > .5 degrees, scale only where |s - 1| >
    .01: with every gate open and such draws the output is the rolled,
    flipped input, bit for bit."""
    x = torch.from_numpy(batch)
    draws = iter([torch.tensor(0.0), torch.ones(5, 1, 1),        # flip gate open, no flips
                  torch.tensor(0.9),                              # roll gate shut
                  torch.tensor(0.0), torch.full((5,), 0.52),      # angles 0.2 degrees
                  torch.tensor(0.0), torch.full((5,), 0.55),      # scales 1.005
                  torch.tensor(0.0)])                             # the call applies
    monkeypatch.setattr(taug.torch, "rand", lambda *a, **k: next(draws))
    out = taug.apply_outline_preserving_augmentations(x, torch.Generator(), prob=0.5)
    assert torch.equal(out, x)


def _write_images(root, cv2, ext, n=11):
    rng = np.random.default_rng(1)
    names = [f"design{i}{ext}" for i in range(n)]
    for i, name in enumerate(names):
        img = (rng.random((40 + i, 37)) * 255).astype(np.uint8)
        cv2.imwrite(str(root / name), img)
    (root / "notes.txt").write_text("not an image")
    return names


@pytest.mark.parametrize("ext", [".png", ".jpg"])
def test_image_reader_gives_jax_bits(tmp_path, ext):
    cv2 = pytest.importorskip("cv2")
    (tmp_path / "images").mkdir()
    _write_images(tmp_path / "images", cv2, ext)
    want, wshape = jimages.read_latent_conditioner_dataset_img(
        "/images", ext, im_size=64, base_dir=str(tmp_path))
    got, gshape = timages.read_latent_conditioner_dataset_img(
        "/images", ext, im_size=64, base_dir=str(tmp_path))
    assert gshape == wshape == (64, 64) and got.shape == (11, 64 * 64)
    assert got.dtype == want.dtype and set(np.unique(got)) <= {0.0, 255.0}
    np.testing.assert_array_equal(got, want)
    with pytest.raises(NotImplementedError, match="not supported"):
        timages.read_latent_conditioner_dataset_img("/images", ".bmp", base_dir=str(tmp_path))


def test_natsorted_as_jax():
    names = ["img10.png", "img2.png", "Img1.png", "img1b.png", "a.png", "img20x3.png"]
    assert timages.natsorted(names) == jimages.natsorted(names)
    assert timages.natsorted(names)[:3] == ["a.png", "Img1.png", "img1b.png"]
