"""The port's PCA (``simulgen_vae_tpu_torch/data/pca.py``) and PCA image reader
against the JAX package's, on the CPU.

Inputs are seeded grayscale images at pixel scale (0-255: smooth blobs plus
noise, rounded), N > k unless a test says otherwise. An SVD's component
signs are arbitrary, so each component is compared up to its sign, taken
from its dot product with JAX's. With N samples the centred data has rank
at most N - 1: a component whose singular value is below 1e-5 of the
largest spans an arbitrary null-space direction, and comparisons leave it
out, and those whose singular values nearly meet (``_kept``). Tolerances:

* components atol 1e-4 (unit vectors; f32 SVDs of the same data);
* coefficients (``transform``) atol 1e-4 of the largest coefficient
  magnitude (about 1e3 here): a component off by up to 1e-4 moves a
  coefficient by up to 1e-4 of its row's norm;
* explained-variance ratios atol 1e-5;
* pickles read across: the transform within 1e-5 of the writer's (the same
  arrays, another framework's product).
"""

import os
import pickle

import numpy as np
import pytest
import torch

from simulgen_vae_tpu.data import images as jimages
from simulgen_vae_tpu.data import pca as jpca
from simulgen_vae_tpu_torch.data import images as timages
from simulgen_vae_tpu_torch.data import pca as tpca

SIDE = 16


def pixel_images(n: int, side: int = SIDE, seed: int = 0) -> np.ndarray:
    """``n`` seeded grayscale ``side``-square images, 0-255 f64 integers."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:side, :side]
    out = np.zeros((n, side, side))
    for i in range(n):
        for _ in range(rng.integers(1, 4)):
            cy, cx = rng.uniform(0.2, 0.8, 2) * side
            ry, rx = rng.uniform(0.1, 0.4, 2) * side
            out[i] += rng.uniform(50, 200) * np.exp(-((yy - cy) / ry) ** 2 - ((xx - cx) / rx) ** 2)
        out[i] += rng.normal(0.0, 5.0, (side, side))
    return np.clip(np.round(out), 0, 255)


def _signs(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    return np.where((got * want).sum(1) < 0, -1.0, 1.0).astype(np.float32)


def _kept(ratio: np.ndarray) -> np.ndarray:
    """Components whose singular value is at least 1e-5 of the largest and
    at least 1e-3 of it away from its neighbours': where two singular values
    nearly meet, f32 rounding turns their components within the plane they
    span (by about 1e-7 over the gap), so each is an arbitrary basis vector
    of it. That leaves out the noise tail of a fit with k = d components."""
    s = np.sqrt(ratio / ratio[0])
    gap = np.minimum(np.abs(np.diff(s, prepend=np.inf)), np.abs(np.diff(s, append=-np.inf)))
    return (s >= 1e-5) & (gap >= 1e-3)


def _assert_components(got: np.ndarray, want: np.ndarray, ratio: np.ndarray) -> np.ndarray:
    keep = _kept(ratio)
    signs = _signs(got, want)
    np.testing.assert_allclose((got * signs[:, None])[keep], want[keep], atol=1e-4)
    return signs


def _assert_coeffs(got: np.ndarray, want: np.ndarray) -> None:
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("k", [8, 32])
def test_linear_pca_matches_jax(k):
    x = pixel_images(40).reshape(40, -1)
    want = jpca._LinearPCA(k).fit(x)
    got = tpca._LinearPCA(k, "cpu").fit(x)
    assert got.n_components == want.n_components == k
    assert got.components_.dtype == got.mean_.dtype == np.float32
    assert got.components_.shape == (k, SIDE * SIDE)
    np.testing.assert_allclose(got.mean_, want.mean_, atol=1e-4)
    signs = _assert_components(got.components_, want.components_,
                               want.explained_variance_ratio_)
    np.testing.assert_allclose(got.explained_variance_ratio_, want.explained_variance_ratio_,
                               atol=1e-5)
    coeffs = got.transform(x) * signs
    _assert_coeffs(coeffs, want.transform(x))
    np.testing.assert_allclose(got.inverse_transform(coeffs * signs),
                               want.inverse_transform(want.transform(x)), atol=1e-3)


@pytest.mark.parametrize("n_components, n, shape", [
    (9, 40, (3, 3)),       # a square: 9 components kept
    (10, 40, (4, 4)),      # rounds up to 16
    (300, 40, (18, 18)),   # rounds up to 324, N = 40 keeps 40, the last a null-space one
    (256, 300, (16, 16)),  # N >= 256: pca_full_comp256.pkl
])
def test_full_mode_matches_jax(tmp_path, n_components, n, shape):
    imgs = pixel_images(n)
    want = jpca.PCAPreprocessor(n_components, save_dir=str(tmp_path / "jax")).fit(imgs)
    got = tpca.PCAPreprocessor(n_components, save_dir=str(tmp_path / "port"),
                               device="cpu").fit(imgs)
    assert got.output_shape == want.output_shape == shape
    assert got.n_components == want.n_components
    assert got.get_output_channels() == want.get_output_channels() == 1
    assert os.listdir(tmp_path / "port") == os.listdir(tmp_path / "jax") \
        == [f"pca_full_comp{want.n_components}.pkl"]
    signs = _assert_components(got.pca.components_, want.pca.components_,
                               want.pca.explained_variance_ratio_)
    out, ref = got.transform(imgs), want.transform(imgs)
    assert out.shape == ref.shape == (n, 1, *shape) and out.dtype == np.float32
    k = want.n_components
    keep = _kept(want.pca.explained_variance_ratio_)
    flat, flat_ref = out.reshape(n, -1), ref.reshape(n, -1)
    assert not flat[:, k:].any()  # zero-padded past the fitted components
    _assert_coeffs((flat[:, :k] * signs)[:, keep], flat_ref[:, :k][:, keep])


@pytest.mark.parametrize("n_components, per_patch", [(16, 4), (2, 1)])
def test_patch_mode_matches_jax(tmp_path, n_components, per_patch):
    """16 x 16 images in 8 x 8 patches: a 2 x 2 grid, n_components // 4
    components a patch; fewer than one a patch keeps one and sets
    n_components to the patch count."""
    imgs = pixel_images(20)
    want = jpca.PCAPreprocessor(n_components, 8, save_dir=str(tmp_path / "jax")).fit(imgs)
    got = tpca.PCAPreprocessor(n_components, 8, save_dir=str(tmp_path / "port"),
                               device="cpu").fit(imgs)
    assert got.output_shape == want.output_shape == (2, 2, per_patch)
    assert got.n_components == want.n_components == max(n_components, 4)
    assert got.get_output_channels() == want.get_output_channels() == per_patch
    assert os.listdir(tmp_path / "port") == os.listdir(tmp_path / "jax") \
        == [f"pca_patch8_comp{want.n_components}.pkl"]
    signs = _assert_components(got.pca.components_, want.pca.components_,
                               want.pca.explained_variance_ratio_)
    out, ref = got.transform(imgs), want.transform(imgs)
    assert out.shape == ref.shape == (20, per_patch, 2, 2) and out.dtype == np.float32
    _assert_coeffs(out * signs[None, :, None, None], ref)


def test_patch_size_must_divide_as_in_jax(tmp_path):
    imgs = pixel_images(20)
    with pytest.raises(ValueError) as want:
        jpca.PCAPreprocessor(16, 7, save_dir=str(tmp_path)).fit(imgs)
    with pytest.raises(ValueError) as got:
        tpca.PCAPreprocessor(16, 7, save_dir=str(tmp_path), device="cpu").fit(imgs)
    assert str(got.value) == str(want.value) == "Image size (16, 16) not divisible by patch size 7"


@pytest.mark.parametrize("patch", [None, 8])
def test_jax_pickle_read_by_the_port(tmp_path, patch):
    imgs = pixel_images(30)
    want = jpca.PCAPreprocessor(16, patch, save_dir=str(tmp_path)).fit(imgs)
    got = tpca.PCAPreprocessor(16, patch, save_dir=str(tmp_path), device="cpu").load()
    for key in ("n_components", "patch_size", "original_shape", "output_shape", "is_fitted"):
        assert getattr(got, key) == getattr(want, key), key
    np.testing.assert_array_equal(got.pca.components_, want.pca.components_)
    np.testing.assert_allclose(got.transform(imgs), want.transform(imgs),
                               atol=1e-5 * np.abs(want.transform(imgs)).max())


@pytest.mark.parametrize("patch", [None, 8])
def test_port_pickle_read_by_jax(tmp_path, patch):
    imgs = pixel_images(30)
    got = tpca.PCAPreprocessor(16, patch, save_dir=str(tmp_path), device="cpu").fit(imgs)
    with open(tmp_path / got._get_pca_filename(), "rb") as f:
        raw = pickle.load(f)
    assert isinstance(raw["n_components"], int) and raw["pca_components"].dtype == np.float32
    want = jpca.PCAPreprocessor(got.n_components, patch, save_dir=str(tmp_path)).load()
    assert want.output_shape == got.output_shape
    np.testing.assert_allclose(np.asarray(want.transform(imgs)), got.transform(imgs),
                               atol=1e-5 * np.abs(got.transform(imgs)).max())


class _Foreign:
    pass


def test_restricted_unpickler_refuses_a_foreign_global(tmp_path):
    with open(tmp_path / "pca_full_comp9.pkl", "wb") as f:
        pickle.dump({"pca_mean": _Foreign()}, f)
    with pytest.raises(pickle.UnpicklingError, match="may not name .*_Foreign"):
        tpca.PCAPreprocessor(9, save_dir=str(tmp_path), device="cpu").load()
    with pytest.raises(FileNotFoundError):
        tpca.PCAPreprocessor(999, save_dir=str(tmp_path), device="cpu").load()


def test_pca_reader_matches_jax_under_opencv(tmp_path, monkeypatch):
    """Both PCA readers on the same PNGs (natural order, resized to 32 x 32):
    the raw pixels the PCA fits on are the same bits, the saved file has the
    same name, the coefficients agree up to sign."""
    import cv2

    rng = np.random.default_rng(5)
    (tmp_path / "images").mkdir()
    for i in (10, 2, 1, 3, 0, 11, 4, 5):  # natural order differs from lexicographic
        cv2.imwrite(str(tmp_path / "images" / f"design{i}.png"),
                    pixel_images(1, 40, seed=i)[0].astype(np.uint8))
    assert cv2.imwrite(str(tmp_path / "images" / "skip.jpg"), np.zeros((4, 4), np.uint8))
    fitted = []

    class Capture(jpca.PCAPreprocessor):
        def fit(self, images, save=True):
            fitted.append(images.copy())
            return super().fit(images, save)

    monkeypatch.setattr(jpca, "PCAPreprocessor", Capture)
    want, want_shape = jimages.read_latent_conditioner_dataset_img_pca(
        "/images", ".png", pca_components=9, im_size=32, base_dir=str(tmp_path),
        save_dir=str(tmp_path / "jax"))
    raw = timages.read_raw_images("/images", ".png", 32, base_dir=str(tmp_path))
    assert raw.dtype == np.uint8 and raw.shape == (8, 32, 32)
    assert fitted[0].dtype == np.float64
    np.testing.assert_array_equal(raw.astype(np.float64), fitted[0])
    got, got_shape = timages.read_latent_conditioner_dataset_img_pca(
        "/images", ".png", pca_components=9, im_size=32, base_dir=str(tmp_path),
        save_dir=str(tmp_path / "port"), device="cpu")
    assert got_shape == want_shape == (9,) and got.shape == want.shape == (8, 9)
    assert os.listdir(tmp_path / "port") == os.listdir(tmp_path / "jax") \
        == ["pca_full_comp8.pkl"]
    comp = jpca.PCAPreprocessor(8, save_dir=str(tmp_path / "jax")).load().pca
    keep = np.concatenate([_kept(comp.explained_variance_ratio_), [False]])
    signs = np.concatenate([_signs(got[:, :8].T, want[:, :8].T), [1.0]])
    _assert_coeffs((got * signs)[:, keep], want[:, keep])
    with pytest.raises(NotImplementedError):
        timages.read_latent_conditioner_dataset_img_pca("/images", ".csv", device="cpu")


def test_pca_fit_runs_on_the_given_device(monkeypatch):
    """The SVD runs on the device the caller names; the default is the card,
    which raises where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpca._LinearPCA(4)
    seen = []
    real = torch.linalg.svd
    monkeypatch.setattr(torch.linalg, "svd",
                        lambda a, **k: seen.append(a.device.type) or real(a, **k))
    tpca._LinearPCA(4, "cpu").fit(pixel_images(10).reshape(10, -1))
    assert seen == ["cpu"]
