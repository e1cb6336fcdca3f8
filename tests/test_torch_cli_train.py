"""The port's training CLI end to end on the CPU, at the tiny geometry of the
JAX package's ``tests/test_cli_pipeline.py`` (its condition and preset: 12
samples of 10 x 32, encoder [16, 8], MLP conditioner [16, 16] on 4 CSV
columns, 6 + 6 epochs), with ``--device cpu``:

* exit 0 and the JAX CLI's ``model_save/`` file names, latents of its shapes,
  one L2 line a sample, the port's checkpoints;
* ``scaler.pkl`` holds what JAX's ``data_scaler`` fits on the same data;
* JAX's ``generate.main`` serving the port-trained ``model_save/`` equals the
  port's ``generate.main`` to 1e-4;
* ``python -m simulgen_vae_tpu_torch --lc_only=1`` reruns the conditioner;
* with matplotlib blocked through ``sys.modules`` each PNG set is skipped
  with one line, and ``--plot 1`` refuses before training;
* a requested preemption exits 75 and ``--auto_resume`` finishes the run;
* no CUDA fallback, and a mesh larger than the ranks started refuses before
  any file is written, as JAX's ``make_mesh`` does (meshes under torchrun:
  ``tests/test_torch_mesh_cli.py``).
"""

import inspect
import os
import pickle
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from simulgen_vae_tpu import cli as jcli
from simulgen_vae_tpu import generate as jgen
from simulgen_vae_tpu.data import scaler as jscaler
from simulgen_vae_tpu.data.dataset import synthetic_dataset
from simulgen_vae_tpu_torch import cli as tcli
from simulgen_vae_tpu_torch import generate as tgen
from simulgen_vae_tpu_torch.data.scaler import MinMaxScaler
from simulgen_vae_tpu_torch.utils import preemption
from tests.test_cli_pipeline import CONDITION, PRESET

REPO = Path(__file__).resolve().parent.parent
P, T, NODE, Z, HIER = 12, 10, 32, 8, 4
# What the JAX CLI writes to model_save/ (simulgen_vae_tpu/cli.py and
# utils/checkpoint.save_latents).
MODEL_SAVE = ("SimulGen-VAE", "LatentConditioner", "scaler.pkl", "latent_vectors.npy",
              "xs.npy", "latent_vectors_scaler.pkl", "xs_scaler.pkl",
              "latent_conditioner_input_scaler.pkl")
RUN = ["--preset=1", "--plot=2", "--size=small", "--device", "cpu", "--no_preempt_guard"]


def _write_inputs(root: Path, condition: str = CONDITION) -> Path:
    root.mkdir(parents=True, exist_ok=True)
    with open(root / "dataset1.pickle", "wb") as f:
        pickle.dump(synthetic_dataset(P, T, NODE, seed=0), f)
    (root / "input_data").mkdir(exist_ok=True)
    (root / "input_data" / "condition.txt").write_text(condition)
    (root / "preset.txt").write_text(PRESET)
    np.savetxt(root / "params.csv", np.random.default_rng(0).standard_normal((P, 4)),
               delimiter=",")
    return root


def _main(root: Path, *args) -> int:
    cwd = os.getcwd()
    os.chdir(root)
    try:
        return tcli.main([*RUN, *args])
    finally:
        os.chdir(cwd)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One whole CLI run with matplotlib blocked; its printed output."""
    root = _write_inputs(tmp_path_factory.mktemp("cli"))
    saved = sys.modules.get("matplotlib")
    sys.modules["matplotlib"] = None
    capture = root / "stdout.txt"
    real = sys.stdout
    try:
        with open(capture, "w") as out:
            sys.stdout = out
            rc = _main(root, "--lc_only=0")
    finally:
        sys.stdout = real
        if saved is None:
            sys.modules.pop("matplotlib")
        else:
            sys.modules["matplotlib"] = saved
    assert rc == 0
    return root, capture.read_text()


def test_cli_writes_the_jax_artifact_set(trained):
    root, out = trained
    jax_source = inspect.getsource(jcli)
    for name in MODEL_SAVE:
        assert name in jax_source or name[:-4] in jax_source
    assert sorted(os.listdir(root / "model_save")) == sorted(MODEL_SAVE)
    lv, xs = np.load(root / "model_save/latent_vectors.npy"), np.load(root / "model_save/xs.npy")
    assert lv.shape == (P, Z) and xs.shape == (P, 1, HIER)   # one hierarchical level
    assert np.isfinite(lv).all() and np.isfinite(xs).all()
    l2 = np.loadtxt(root / "SimulGen-VAE_L2_loss.txt")
    assert l2.shape == (P,) and np.isfinite(l2).all()
    assert os.listdir(root / "checkpoints/vae") and os.listdir(
        root / "checkpoints/latent_conditioner")
    for line in ("Skipped 9 reconstruction PNGs (checkpoints/training_reconstruction/",
                 "Skipped 3 reconstruction PNGs (checkpoints/validation/",
                 "Skipped 10 comparison PNGs (checkpoints/reconstruction_dual_view_0.png ..): "
                 "matplotlib is not installed", "Done."):
        assert line in out, line
    assert not list((root / "checkpoints").glob("*.png"))


def test_scaler_pkl_is_what_jax_data_scaler_fits(trained):
    root, _ = trained
    _, _, ref = jscaler.data_scaler(synthetic_dataset(P, T, NODE, seed=0), T, NODE,
                                    save_path=None)
    got = MinMaxScaler.load(str(root / "model_save/scaler.pkl"))
    for k in ("data_min_", "data_max_", "scale_", "min_"):
        # JAX pickles its f32 statistics as f64, as the port does
        np.testing.assert_array_equal(getattr(got, k), np.float64(getattr(ref, k)))


def _gen_args(root: Path, out: Path) -> list:
    return ["--inputs", str(root / "new.csv"), "--out", str(out), "--quantize", "none",
            "--condition", str(root / "input_data/condition.txt"),
            "--preset_file", str(root / "preset.txt"), "--model_dir", str(root / "model_save")]


def test_jax_generate_serves_the_port_trained_model(trained, tmp_path):
    root, _ = trained
    np.savetxt(root / "new.csv", np.random.default_rng(7).standard_normal((5, 4)),
               delimiter=",")
    assert jgen.main(_gen_args(root, tmp_path / "jax.npy")) == 0
    assert tgen.main(_gen_args(root, tmp_path / "port.npy") + ["--device", "cpu"]) == 0
    want, got = np.load(tmp_path / "jax.npy"), np.load(tmp_path / "port.npy")
    assert got.shape == want.shape == (5, T, NODE) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_lc_only_reruns_the_conditioner_as_a_module(trained, tmp_path):
    root = Path(shutil.copytree(trained[0], tmp_path / "copy"))
    before = (root / "model_save/LatentConditioner").read_bytes()
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    # ``python -m`` with matplotlib blocked, as on the card (its PNGs take most
    # of a run at this size)
    code = ("import runpy, sys; sys.modules['matplotlib'] = None; "
            "runpy.run_module('simulgen_vae_tpu_torch', run_name='__main__', alter_sys=True)")
    run = subprocess.run([sys.executable, "-c", code, *RUN, "--lc_only=1", "--lc_epochs", "3"],
                         cwd=root, env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    assert "Training LatentConditioner only..." in run.stdout and "Done." in run.stdout
    assert (root / "model_save/LatentConditioner").read_bytes() != before
    np.testing.assert_array_equal(np.load(root / "model_save/latent_vectors.npy"),
                                  np.load(trained[0] / "model_save/latent_vectors.npy"))


def test_plot_without_matplotlib_refuses_before_training(tmp_path, monkeypatch):
    root = _write_inputs(tmp_path)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(RuntimeError, match="--plot 1 draws the dataset with matplotlib"):
        _main(root, "--lc_only=0", "--plot=1")
    assert not (root / "checkpoints").exists()


def test_preemption_exits_75_and_auto_resume_finishes(tmp_path, monkeypatch, capsys):
    root = _write_inputs(tmp_path)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    preemption.request()
    try:
        assert _main(root, "--lc_only=0", "--epochs", "3") == preemption.EX_TEMPFAIL
    finally:
        preemption.clear()
    assert "Preempted at epoch 1" in capsys.readouterr().out
    assert not (root / "model_save/SimulGen-VAE").exists()
    assert _main(root, "--lc_only=0", "--epochs", "3", "--lc_epochs", "2",
                 "--auto_resume") == 0
    out = capsys.readouterr().out
    assert "Resuming from epoch 1 (2 epochs remaining)" in out and "Done." in out
    assert sorted(os.listdir(root / "model_save")) == sorted(MODEL_SAVE)


def test_default_device_raises_without_cuda(tmp_path, monkeypatch):
    root = _write_inputs(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _main(root, "--lc_only=0", "--device", "cuda")
    assert not (root / "model_save").exists()


@pytest.mark.parametrize("changes, args, match", [
    # image and image_pca inputs train (tests/test_torch_cli_images.py,
    # test_torch_cli_pca.py), and meshes under torchrun (test_torch_mesh_cli.py);
    # without it there is one rank, which a 2 x 1 mesh exceeds
    ((("input_type\tcsv", "input_type\timage"),), ("--mesh_data", "2"),
     "mesh 2x1 exceeds 1 ranks"),
    ((), ("--mesh_data", "2"), "mesh 2x1 exceeds 1 ranks"),
], ids=["image", "mesh"])
def test_unported_options_refuse(tmp_path, changes, args, match):
    condition = CONDITION
    for change in changes:
        assert change[0] in condition
        condition = condition.replace(*change)
    root = _write_inputs(tmp_path, condition)
    with pytest.raises(ValueError, match=match):
        _main(root, "--lc_only=0", *args)
    assert not (root / "model_save").exists()
