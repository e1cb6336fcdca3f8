"""The port's training CLI on image inputs, on the CPU, with the recipe of the
JAX package's ``tests/test_cli_image_e2e.py`` (its condition and preset: 8
samples of 10 x 32, encoder [16, 8], conditioner filters [8, 8, 16], 8 PNGs
read at 32 x 32 by both packages' readers, 4 + 4 epochs):

* ``input_type image`` with ``use_e2e_training 1`` (the shipped
  configuration: the CNN with spectral norm, trained through the frozen
  decoder), ``image`` through ``LCTrainer``, and ``image_vit`` with and
  without E2E: exit 0, the JAX CLI's ``model_save/`` files of an image run
  (no input scaler), the conditioner file with the BatchNorm statistics the
  CNN has;
* JAX's ``generate.main`` serving the port-trained ``model_save/`` equals
  the port's ``generate.main`` to 1e-4;
* the reverse: a conditioner written by the JAX package's ``save_flax_model``
  from JAX-initialized weights, served by both, to 1e-4.
"""

import os
import pickle
import shutil
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from simulgen_vae_tpu import generate as jgen
from simulgen_vae_tpu.data import images as jimages
from simulgen_vae_tpu.data.dataset import synthetic_dataset
from simulgen_vae_tpu.models import LatentConditionerImg as JaxImg
from simulgen_vae_tpu.models import LatentConditionerViT as JaxViT
from simulgen_vae_tpu.utils.checkpoint import save_flax_model as jax_save
from simulgen_vae_tpu_torch import cli as tcli
from simulgen_vae_tpu_torch import generate as tgen
from simulgen_vae_tpu_torch.data import images as timages
from simulgen_vae_tpu_torch.utils.checkpoint import load_flax_model
from tests.test_cli_image_e2e import CONDITION, PRESET

SIDE, P = 32, 8
RUN = ["--preset=1", "--plot=2", "--size=small", "--device", "cpu", "--no_preempt_guard",
       "--lc_only=0"]
IMAGE_MODEL_SAVE = ("SimulGen-VAE", "LatentConditioner", "scaler.pkl", "latent_vectors.npy",
                    "xs.npy", "latent_vectors_scaler.pkl", "xs_scaler.pkl")
CONFIGS = {"image_e2e": ("image", 1), "image": ("image", 0), "image_vit": ("image_vit", 0),
           "image_vit_e2e": ("image_vit", 1)}


@pytest.fixture(autouse=True)
def small_images(monkeypatch):
    """Both packages' readers at 32 x 32 (256 x 256 is slow on a CPU)."""
    for mod in (jimages, timages):
        real = mod.read_latent_conditioner_dataset_img
        monkeypatch.setattr(
            mod, "read_latent_conditioner_dataset_img",
            lambda d, t, im_size=SIDE, base_dir=None, real=real: real(d, t, SIDE, base_dir))
    monkeypatch.setitem(sys.modules, "matplotlib", None)


def _condition(kind: str, e2e: int) -> str:
    text = CONDITION.replace("input_type\timage", f"input_type\t{kind}")
    return text.replace("use_e2e_training\t1", f"use_e2e_training\t{e2e}")


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
    """One CLI run a configuration, made on first use."""
    runs = {}

    def run(name):
        if name not in runs:
            kind, e2e = CONFIGS[name]
            root = _write_inputs(tmp_path_factory.mktemp(name), _condition(kind, e2e))
            runs[name] = (root, _in(root, tcli.main, RUN))
        return runs[name]

    return run


def _serve_both(root: Path, tmp: Path):
    args = ["--inputs", "images", "--quantize", "none", "--condition",
            "input_data/condition.txt", "--preset_file", "preset.txt", "--model_dir", "model_save"]
    assert _in(root, jgen.main, args + ["--out", str(tmp / "jax.npy")]) == 0
    assert _in(root, tgen.main, args + ["--out", str(tmp / "port.npy"), "--device", "cpu"]) == 0
    return np.load(tmp / "jax.npy"), np.load(tmp / "port.npy")


@pytest.mark.parametrize("name", list(CONFIGS))
def test_cli_trains_images_and_jax_serves_the_model(trained, name, tmp_path, capsys):
    root, rc = trained(name)
    assert rc == 0
    out = capsys.readouterr().out
    assert "Loading image data..." in out and "Done." in out
    assert ("Using end-to-end latent conditioner training" in out) == bool(CONFIGS[name][1])
    assert sorted(os.listdir(root / "model_save")) == sorted(IMAGE_MODEL_SAVE)
    saved = load_flax_model(str(root / "model_save" / "LatentConditioner"))
    assert bool(saved["batch_stats"]) == (CONFIGS[name][0] == "image")
    want, got = _serve_both(root, tmp_path)
    assert got.shape == want.shape == (P, 10, 32) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("kind", ["image", "image_vit"])
def test_port_serves_a_conditioner_the_jax_package_wrote(trained, kind, tmp_path):
    root = Path(shutil.copytree(trained("image_e2e" if kind == "image" else "image_vit")[0],
                                tmp_path / "copy"))
    (root / "input_data" / "condition.txt").write_text(_condition(kind, 0))
    x = jnp.zeros((1, SIDE * SIDE))
    if kind == "image":
        module = JaxImg([8, 8, 16], 8, 4, 1, dropout_rate=0.1)
    else:
        module = JaxViT(8, 4, 1, dropout_rate=0.1)
    variables = jax.jit(lambda k: module.init({"params": k, "dropout": k}, x,
                                              deterministic=True))(jax.random.PRNGKey(3))
    rng = np.random.default_rng(4)
    variables = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + np.float32(0.05) * rng.standard_normal(a.shape).astype(
            np.float32), dict(variables))
    if "batch_stats" in variables:
        variables["batch_stats"] = jax.tree_util.tree_map(lambda a: np.abs(a) + 0.5,
                                                          variables["batch_stats"])
    jax_save(str(root / "model_save" / "LatentConditioner"),
             {"params": variables["params"], "batch_stats": variables.get("batch_stats", {})})
    want, got = _serve_both(root, tmp_path)
    assert got.shape == (P, 10, 32) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
