"""The port's training CLI with ``input_type image_pca`` on the CPU, with the
recipe of the JAX package's ``tests/test_cli_image_e2e.py`` (its condition
and preset: 8 samples of 10 x 32, encoder [16, 8], MLP conditioner
[8, 8, 16], 8 PNGs of seeded noise read at 32 x 32 by both packages' PCA
readers; 4 + 4 epochs, 1 + 1 for JAX's CLI, whose PCA is what is compared):

* with and without ``use_e2e_training`` (``image_pca`` trains through
  ``LCTrainer`` either way, as in JAX's CLI): exit 0 and the nine
  ``model_save/`` files, the eight of a CSV run and ``pca_full_comp8.pkl``
  (256 components asked for, 8 samples keep 8); the input scaler and the
  MLP 256 inputs wide (the 16 x 16 square of coefficients, zero-padded);
* JAX's ``PCAPreprocessor.load`` reads the port's PCA pickle;
* JAX's CLI on the same inputs fits the same components up to sign (atol
  1e-4), leaving out the null-space component (8 samples have rank 7) and
  any whose singular values nearly meet (``tests/test_torch_pca.py``);
* JAX's and the port's ``load_pipeline`` + ``generate`` on the port-trained
  ``model_save/`` agree within 1e-4, on the scaled coefficients of the
  images and through both generate CLIs on a CSV of coefficients
  (``--input_type csv``);
* both generate CLIs fail on an ``image_pca`` image directory: JAX's feeds
  thresholded pixels to the MLP and fails on the width, the port refuses
  before it reads a model file.
"""

import os
import pickle
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest

from simulgen_vae_tpu import cli as jcli
from simulgen_vae_tpu import generate as jgen
from simulgen_vae_tpu.data import images as jimages
from simulgen_vae_tpu.data import pca as jpca
from simulgen_vae_tpu.data.dataset import synthetic_dataset
from simulgen_vae_tpu_torch import cli as tcli
from simulgen_vae_tpu_torch import generate as tgen
from simulgen_vae_tpu_torch.data import images as timages
from simulgen_vae_tpu_torch.data import pca as tpca
from simulgen_vae_tpu_torch.data.scaler import MinMaxScaler
from simulgen_vae_tpu_torch.utils.checkpoint import load_flax_model
from tests.test_cli_image_e2e import CONDITION, PRESET
from tests.test_torch_pca import _kept

SIDE, P = 32, 8
RUN = ["--preset=1", "--plot=2", "--size=small", "--lc_only=0"]
PCA_FILE = "pca_full_comp8.pkl"
MODEL_SAVE = ("SimulGen-VAE", "LatentConditioner", "scaler.pkl", "latent_vectors.npy",
              "xs.npy", "latent_vectors_scaler.pkl", "xs_scaler.pkl",
              "latent_conditioner_input_scaler.pkl", PCA_FILE)


@pytest.fixture(autouse=True)
def small_images(monkeypatch):
    """Both packages' PCA readers at 32 x 32 (256 x 256 is slow on a CPU)."""
    for mod in (jimages, timages):
        real = mod.read_latent_conditioner_dataset_img_pca
        monkeypatch.setattr(mod, "read_latent_conditioner_dataset_img_pca",
                            lambda d, t, real=real, **k: real(d, t, **{**k, "im_size": SIDE}))


def _condition(e2e: int) -> str:
    return CONDITION.replace("input_type\timage", "input_type\timage_pca").replace(
        "use_e2e_training\t1", f"use_e2e_training\t{e2e}")


def _write_inputs(root: Path, condition: str) -> Path:
    import cv2

    root.mkdir(parents=True, exist_ok=True)
    with open(root / "dataset1.pickle", "wb") as f:
        pickle.dump(synthetic_dataset(P, 10, 32, seed=0), f)
    (root / "input_data").mkdir(exist_ok=True)
    (root / "input_data" / "condition.txt").write_text(condition)
    (root / "preset.txt").write_text(PRESET)
    (root / "images").mkdir(exist_ok=True)
    rng = np.random.default_rng(0)
    for i in range(P):
        cv2.imwrite(str(root / "images" / f"design{i}.png"),
                    (rng.random((SIDE, SIDE)) * 255).astype(np.uint8))
    return root


def _in(root: Path, fn, *args):
    cwd = os.getcwd()
    os.chdir(root)
    try:
        return fn(*args)
    finally:
        os.chdir(cwd)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The port's CLI run once for each value of use_e2e_training, made on
    first use (matplotlib blocked: the PNGs are skipped)."""
    runs = {}

    def run(e2e: int):
        if e2e not in runs:
            root = _write_inputs(tmp_path_factory.mktemp(f"port{e2e}"), _condition(e2e))
            with pytest.MonkeyPatch.context() as mp:
                mp.setitem(sys.modules, "matplotlib", None)
                runs[e2e] = (root, _in(root, tcli.main, RUN + ["--device", "cpu",
                                                               "--no_preempt_guard"]))
        return runs[e2e]

    return run


def _scaled_coefficients(root: Path) -> np.ndarray:
    """The images' PCA coefficients through the port-trained model_save/'s
    PCA and input scaler, as the training CLI fed them to the MLP."""
    models = root / "model_save"
    pre = tpca.PCAPreprocessor(8, save_dir=str(models), device="cpu").load()
    raw = timages.read_raw_images("/images", ".png", SIDE, base_dir=str(root))
    coeffs = pre.transform(raw.astype(np.float64)).reshape(P, -1)
    scaler = MinMaxScaler.load(str(models / "latent_conditioner_input_scaler.pkl"))
    return np.float32(scaler.transform(coeffs))


@pytest.mark.parametrize("e2e", [0, 1], ids=["lc", "e2e_flag"])
def test_cli_trains_image_pca(trained, e2e, capsys):
    root, rc = trained(e2e)
    assert rc == 0
    out = capsys.readouterr().out
    assert "Loading image data with PCA preprocessing for MLP..." in out and "Done." in out
    assert "Using end-to-end latent conditioner training" not in out
    models = root / "model_save"
    assert sorted(os.listdir(models)) == sorted(MODEL_SAVE)
    scaler = MinMaxScaler.load(str(models / "latent_conditioner_input_scaler.pkl"))
    assert scaler.scale_.shape == (256,)
    lc = load_flax_model(str(models / "LatentConditioner"))
    assert np.shape(lc["params"]["input_norm"]["scale"]) == (256,)
    pre = tpca.PCAPreprocessor(8, save_dir=str(models), device="cpu").load()
    comp = pre.pca.components_
    assert comp.shape == (P, SIDE * SIDE) and comp.dtype == np.float32
    assert pre.output_shape == (16, 16) and pre.n_components == P
    np.testing.assert_allclose(comp @ comp.T, np.eye(P), atol=1e-5)


def test_jax_loads_the_port_pca_pickle(trained):
    root, _ = trained(0)
    models = str(root / "model_save")
    want = tpca.PCAPreprocessor(8, save_dir=models, device="cpu").load()
    got = jpca.PCAPreprocessor(8, save_dir=models).load()
    assert got.output_shape == want.output_shape and got.n_components == want.n_components
    np.testing.assert_array_equal(got.pca.components_, want.pca.components_)
    raw = timages.read_raw_images("/images", ".png", SIDE, base_dir=str(root)).astype(np.float64)
    np.testing.assert_allclose(np.asarray(got.transform(raw)), want.transform(raw),
                               atol=1e-4 * np.abs(want.transform(raw)).max())


def test_jax_cli_fits_the_same_components(trained, tmp_path):
    root, _ = trained(0)
    jroot = _write_inputs(tmp_path / "jax", _condition(0))
    assert _in(jroot, jcli.main, RUN + ["--epochs", "1", "--lc_epochs", "1"]) == 0
    assert sorted(os.listdir(jroot / "model_save")) == sorted(MODEL_SAVE)
    want = jpca.PCAPreprocessor(8, save_dir=str(jroot / "model_save")).load().pca
    got = tpca.PCAPreprocessor(8, save_dir=str(root / "model_save"), device="cpu").load().pca
    keep = _kept(want.explained_variance_ratio_)
    assert keep.sum() >= P - 1 - 2 and not keep[-1]  # the null-space component is left out
    signs = np.where((got.components_ * want.components_).sum(1) < 0, -1.0, 1.0)
    np.testing.assert_allclose((got.components_ * signs[:, None])[keep],
                               want.components_[keep], atol=1e-4)
    np.testing.assert_allclose(got.explained_variance_ratio_, want.explained_variance_ratio_,
                               atol=1e-5)


def test_both_pipelines_serve_the_port_model(trained):
    root, _ = trained(0)
    inputs = _scaled_coefficients(root)
    args = dict(condition=str(root / "input_data" / "condition.txt"),
                preset_file=str(root / "preset.txt"), model_dir=str(root / "model_save"))
    want = np.asarray(jgen.generate(jgen.load_pipeline(**args), inputs))
    got = tgen.generate(tgen.load_pipeline(**args, device="cpu"), inputs).numpy()
    assert got.shape == want.shape == (P, 10, 32) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_both_generate_clis_serve_a_csv_of_coefficients(trained, tmp_path):
    root = Path(shutil.copytree(trained(0)[0], tmp_path / "copy"))
    models = root / "model_save"
    pre = tpca.PCAPreprocessor(8, save_dir=str(models), device="cpu").load()
    raw = timages.read_raw_images("/images", ".png", SIDE, base_dir=str(root))
    np.savetxt(root / "coeffs.csv", pre.transform(raw.astype(np.float64)).reshape(P, -1),
               delimiter=",")
    args = ["--inputs", "coeffs.csv", "--input_type", "csv", "--quantize", "none",
            "--condition", "input_data/condition.txt", "--preset_file", "preset.txt",
            "--model_dir", "model_save"]
    assert _in(root, jgen.main, args + ["--out", str(tmp_path / "jax.npy")]) == 0
    assert _in(root, tgen.main, args + ["--out", str(tmp_path / "port.npy"),
                                        "--device", "cpu"]) == 0
    want, got = np.load(tmp_path / "jax.npy"), np.load(tmp_path / "port.npy")
    assert got.shape == (P, 10, 32)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("package", ["jax", "port"])
def test_generate_clis_fail_on_an_image_pca_image_directory(trained, tmp_path, package,
                                                            monkeypatch):
    root = Path(shutil.copytree(trained(0)[0], tmp_path / "copy"))
    args = ["--inputs", "images", "--quantize", "none", "--condition",
            "input_data/condition.txt", "--preset_file", "preset.txt",
            "--model_dir", "model_save", "--out", str(tmp_path / "out.npy")]
    if package == "jax":
        from flax.errors import ScopeParamShapeError

        # 256 x 256 thresholded pixels into the MLP's 256-wide input norm
        with pytest.raises(ScopeParamShapeError, match=r"shape \(65536,\).*shape \(256,\)"):
            _in(root, jgen.main, args)
    else:
        opened = []
        monkeypatch.setattr(tgen, "load_pipeline", lambda *a, **k: opened.append(a))
        with pytest.raises(NotImplementedError, match="Queue 3 item 6"):
            _in(root, tgen.main, args + ["--device", "cpu"])
        assert not opened
    assert not (tmp_path / "out.npy").exists()
