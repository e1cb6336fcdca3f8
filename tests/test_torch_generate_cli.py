"""Serving from ``model_save/``: the port's CLI against the JAX package's.

The artifacts are written by the JAX package's own writers (``save_flax_model``,
the scaler pickles of ``data_scaler`` / ``latent_conditioner_scaler``) from
JAX-initialized parameters, at T = 8, 300 nodes, encoder filters
[32, 16, 8, 4], MLP conditioner [8, 16, 16] on 12 CSV columns. JAX
``generate.main`` and the port's ``main([..., "--device", "cpu"])`` write
``.npy`` files that agree to atol/rtol 1e-4 in float, with ``--raw_scale``
and chunked (``--max_batch 2`` on 5 rows), and in int8 (the tolerance
``tests/test_torch_quant.py`` states). Artifacts written by the port's own
writers give JAX's ``main`` the same output. The module entry point runs once
as a subprocess; ``load_pipeline`` names a missing weight, also of an image
conditioner asked for over an MLP conditioner's file.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simulgen_vae_tpu import generate as jgen
from simulgen_vae_tpu.data.scaler import data_scaler, latent_conditioner_scaler
from simulgen_vae_tpu.models import LatentConditioner as JaxLC
from simulgen_vae_tpu.models.vae import VAE as JaxVAE
from simulgen_vae_tpu.utils.checkpoint import save_flax_model as jax_save
from simulgen_vae_tpu_torch import convert
from simulgen_vae_tpu_torch import generate as tgen
from simulgen_vae_tpu_torch.data.scaler import MinMaxScaler
from simulgen_vae_tpu_torch.utils.checkpoint import load_flax_model, save_flax_model

REPO = Path(__file__).resolve().parent.parent
T, NODE, Z, HIER, N_IN, ROWS = 8, 300, 8, 4, 12, 5
ENC, LC_FILTERS = [32, 16, 8, 4], [8, 16, 16]

CONDITION = f"""\
Common params
Dim1		{ROWS} # number of parameters
Dim2		{T} # number of timesteps
Dim3		{NODE} # num nodes
num_var 1
'
%LSH-VAE parameters
Training_epochs	6
Batch_size	4
LearningR	0.001
Latent_dim	{HIER}
Latent_dim_end	{Z}
Loss_type	1
Stretch	0
alpha		1000
Recon_iter	1
% reduction
Dim2_red		{T}
Dim3_start      0
Dim3_end		{NODE}
'
%LatentConditioner
num_param	{N_IN}
param_dir	params.csv
n_epoch	6
latent_conditioner_lr	0.001
latent_conditioner_batch	4
latent_conditioner_weight_decay	1e-5
latent_conditioner_dropout_rate	0.1
use_spatial_attention	1
input_type	csv
param_data_type .csv
"""
PRESET = "data_No, init_beta_divisior, num_filter_enc, latent_conditioner_filter\n1\n0\n" \
         + " ".join(map(str, ENC)) + "\n" + " ".join(map(str, LC_FILTERS)) + "\n"
SCALERS = ("scaler.pkl", "latent_vectors_scaler.pkl", "xs_scaler.pkl",
           "latent_conditioner_input_scaler.pkl")


def _write_config(root: Path, rows: np.ndarray) -> None:
    (root / "condition.txt").write_text(CONDITION)
    (root / "preset.txt").write_text(PRESET)
    np.savetxt(root / "params.csv", rows, delimiter=",")


@pytest.fixture(scope="module")
def jax_artifacts(tmp_path_factory):
    """A model_save/ written by the JAX package from JAX-initialized weights."""
    root = tmp_path_factory.mktemp("jax_artifacts")
    models = root / "model_save"
    models.mkdir()
    rng = np.random.default_rng(0)
    rows = rng.uniform(-2.0, 3.0, (ROWS, N_IN))
    _write_config(root, rows)
    vae = JaxVAE(latent_dim=Z, hierarchical_dim=HIER, num_filter_enc=ENC,
                 num_filter_dec=ENC[::-1], num_node=NODE, num_time=T, small=True)
    key = jax.random.PRNGKey(0)
    params = jax.jit(lambda k: vae.init({"params": k, "sample": k},
                                        jnp.zeros((1, T, NODE))))(key)["params"]
    lc = JaxLC(LC_FILTERS, Z, N_IN, HIER, len(ENC) - 1, dropout_rate=0.1)
    lc_params = jax.jit(lambda k: lc.init({"params": k, "dropout": k}, jnp.zeros((1, N_IN)),
                                          deterministic=True))(jax.random.PRNGKey(1))["params"]
    jax_save(str(models / "SimulGen-VAE"), {"params": params})
    jax_save(str(models / "LatentConditioner"), {"params": lc_params, "batch_stats": {}})
    data_scaler(rng.standard_normal((6, T, NODE)) * 3.0 + 1.0, T, NODE,
                save_path=str(models / "scaler.pkl"))
    latent_conditioner_scaler(rng.standard_normal((ROWS, Z)),
                              str(models / "latent_vectors_scaler.pkl"))
    latent_conditioner_scaler(rng.standard_normal((ROWS, len(ENC) - 1, HIER)),
                              str(models / "xs_scaler.pkl"))
    latent_conditioner_scaler(rows, str(models / "latent_conditioner_input_scaler.pkl"))
    return root


def _args(root: Path, out: Path, *extra) -> list:
    return ["--inputs", str(root / "params.csv"), "--out", str(out),
            "--condition", str(root / "condition.txt"),
            "--preset_file", str(root / "preset.txt"),
            "--model_dir", str(root / "model_save"), *extra]


def _jax_main(root: Path, out: Path, *extra) -> np.ndarray:
    assert jgen.main(_args(root, out, *extra)) == 0
    return np.load(out)


def _port_main(root: Path, out: Path, *extra) -> np.ndarray:
    assert tgen.main(_args(root, out, *extra, "--device", "cpu")) == 0
    return np.load(out)


@pytest.mark.parametrize("extra, tol", [
    (("--quantize", "none"), 1e-4),
    (("--quantize", "none", "--raw_scale"), 1e-4),
    (("--quantize", "none", "--max_batch", "2"), 1e-4),
    (("--quantize", "int8"), 1e-4),
], ids=["float", "raw_scale", "chunked", "int8"])
def test_port_cli_matches_jax_cli(jax_artifacts, tmp_path, extra, tol, capsys):
    want = _jax_main(jax_artifacts, tmp_path / "jax.npy", *extra)
    got = _port_main(jax_artifacts, tmp_path / "port.npy", *extra)
    assert got.shape == want.shape == (ROWS, T, NODE) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
    assert f"Generated {ROWS} fields [{T} timesteps x {NODE} nodes]" in capsys.readouterr().out


def test_port_written_artifacts_serve_jax_cli(jax_artifacts, tmp_path):
    """The port's writers re-write the JAX artifacts; JAX's CLI reads them and
    gives the output it gives on its own files."""
    root = tmp_path
    (root / "model_save").mkdir()
    _write_config(root, np.loadtxt(jax_artifacts / "params.csv", delimiter=","))
    for name in ("SimulGen-VAE", "LatentConditioner"):
        save_flax_model(str(root / "model_save" / name),
                        load_flax_model(str(jax_artifacts / "model_save" / name)))
    for name in SCALERS:
        MinMaxScaler.load(str(jax_artifacts / "model_save" / name)).save(
            str(root / "model_save" / name))
    want = _jax_main(jax_artifacts, tmp_path / "a.npy", "--quantize", "none")
    got = _jax_main(root, tmp_path / "b.npy", "--quantize", "none")
    np.testing.assert_array_equal(got, want)


def test_held_conv_weights_survive_a_save(jax_artifacts, tmp_path):
    """A served pipeline, its conv weights held in cuDNN's order by
    make_generate_fn, written back through the port's writers and loaded
    again serves the same field."""
    cond, preset = str(jax_artifacts / "condition.txt"), str(jax_artifacts / "preset.txt")
    x = np.random.default_rng(6).standard_normal((3, N_IN)).astype(np.float32)
    pipe = tgen.load_pipeline(cond, preset, model_dir=str(jax_artifacts / "model_save"),
                              device="cpu")
    want = tgen.make_generate_fn(pipe)(x)
    decoder = pipe["vae"].decoder
    assert not all(p.is_contiguous() for p in decoder.parameters())
    root = _copy(jax_artifacts, tmp_path / "copy")
    tree = convert._to_tree(convert.decoder_state, convert.random_decoder_tree(pipe["cfg"], None),
                            decoder)
    save_flax_model(str(root / "model_save" / "SimulGen-VAE"), {"params": {"decoder": tree}})
    again = tgen.load_pipeline(cond, preset, model_dir=str(root / "model_save"), device="cpu")
    assert all(p.is_contiguous() for p in again["vae"].parameters())
    np.testing.assert_array_equal(tgen.make_generate_fn(again)(x).numpy(), want.numpy())


def test_module_entry_point_runs_as_a_script(jax_artifacts, tmp_path):
    """``python -m simulgen_vae_tpu_torch.generate`` on the JAX artifacts."""
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = tmp_path / "gen.npy"
    run = subprocess.run([sys.executable, "-m", "simulgen_vae_tpu_torch.generate",
                          *_args(jax_artifacts, out, "--quantize", "none", "--device", "cpu")],
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    assert f"-> {out}" in run.stdout
    want = _port_main(jax_artifacts, tmp_path / "in_process.npy", "--quantize", "none")
    np.testing.assert_array_equal(np.load(out), want)


def test_default_device_raises_without_cuda(jax_artifacts, tmp_path, monkeypatch):
    """No CPU fallback: the CLI's default --device cuda raises with no card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgen.main(_args(jax_artifacts, tmp_path / "x.npy"))
    assert not (tmp_path / "x.npy").exists()


def _copy(src: Path, dst: Path) -> Path:
    shutil.copytree(src, dst, dirs_exist_ok=True)
    return dst


def test_load_pipeline_names_a_missing_weight(jax_artifacts, tmp_path):
    root = _copy(jax_artifacts, tmp_path / "copy")
    path = root / "model_save" / "SimulGen-VAE"
    tree = load_flax_model(str(path))
    del tree["params"]["decoder"]["recon"]["bias"]
    save_flax_model(str(path), tree)
    with pytest.raises(KeyError, match="SimulGen-VAE/params/decoder/recon/bias is missing"):
        tgen.load_pipeline(str(root / "condition.txt"), str(root / "preset.txt"),
                           model_dir=str(root / "model_save"), device="cpu")


@pytest.mark.parametrize("input_type, leaf", [("image", "sn_initial_conv"),
                                              ("image_vit", "pos_embed")])
def test_load_pipeline_refuses_unported_conditioners(jax_artifacts, tmp_path, input_type,
                                                     leaf):
    """An image condition over an MLP conditioner's file: the image
    conditioners are served now (tests/test_torch_cli_images.py), so the
    refusal is the first missing weight, named with its file."""
    root = _copy(jax_artifacts, tmp_path / "copy")
    (root / "condition.txt").write_text(
        CONDITION.replace("input_type\tcsv", f"input_type\t{input_type}"))
    with pytest.raises(KeyError, match=f"LatentConditioner/params/{leaf} is missing"):
        tgen.load_pipeline(str(root / "condition.txt"), str(root / "preset.txt"),
                           model_dir=str(root / "model_save"), device="cpu")


def test_load_pipeline_reads_the_artifacts(jax_artifacts):
    """f32 by default, the trees as loaded, the input scaler kept for main."""
    pipe = tgen.load_pipeline(str(jax_artifacts / "condition.txt"),
                              str(jax_artifacts / "preset.txt"),
                              model_dir=str(jax_artifacts / "model_save"), device="cpu")
    assert pipe["dtype"] == torch.float32 and pipe["device"].type == "cpu"
    assert pipe["cfg"].num_node == NODE and pipe["cfg"].num_filter_enc == ENC
    assert pipe["lc_cfg"].input_type == "csv" and pipe["lc_cfg"].filters == LC_FILTERS
    assert pipe["input_scaler"].scale_.dtype == np.float64
    assert all(p.dtype == torch.float32 for p in pipe["vae"].parameters())
