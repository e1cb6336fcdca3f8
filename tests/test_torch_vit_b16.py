"""The port's ViT conditioner at ViT-B/16's widths (embedding 768, 12 heads
of 64, MLP 3072) against the JAX module, on the CPU, at one block and 64 x
64 images (16 tokens), weights carried by ``convert.py`` (JAX-initialized,
moved off their inits by 0.05 normal):

* the forward in eval mode, and in train mode with dropout off (flax's
  ``Dropout`` the identity, no generator on the port's): rtol / atol 1e-4
  in f32, as ``test_torch_conditioner_img.py`` holds the small ViT;
* the ``convert`` round trip, port -> flax tree -> port: every leaf's bits;
* ``convert.image_conditioner`` given the tree infers 768 / 12 heads / the
  depth (one block, and two), and the 64-pixel side, whatever ``LCConfig``
  says; without a tree it builds ``LCConfig``'s ``vit_*`` widths;
* the training CLI with the condition file's ``vit_*`` keys at ViT-B's
  widths (two blocks, 32 x 32 images) trains an ``image_vit`` conditioner
  end to end, writes its ``model_save/``, and ``load_pipeline`` serves it
  at those widths: the generate CLI's fields equal the in-memory pipeline's.
"""

import os
import pickle
import sys
from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simulgen_vae_tpu.data.dataset import synthetic_dataset
from simulgen_vae_tpu.models import LatentConditionerViT as JaxViT
from simulgen_vae_tpu_torch import cli as tcli
from simulgen_vae_tpu_torch import convert
from simulgen_vae_tpu_torch import generate as tgen
from simulgen_vae_tpu_torch.config import LCConfig, VAEConfig
from simulgen_vae_tpu_torch.data import images as timages
from simulgen_vae_tpu_torch.models import LatentConditionerViT
from tests.test_cli_image_e2e import CONDITION, PRESET

SIDE, N, Z, HIER, SIZE2 = 64, 4, 32, 8, 3
DIM, HEADS = 768, 12


def _images(n=N, side=SIDE) -> np.ndarray:
    rng = np.random.default_rng(0)
    return (rng.random((n, side * side)) < 0.3).astype(np.float32)


def _variables(module, x, seed=0) -> dict:
    v = jax.jit(lambda k: module.init({"params": k, "dropout": k}, jnp.asarray(x),
                                      deterministic=True))(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 1)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)).astype(np.float32),
        dict(v))


def _pair(depth=1):
    jm = JaxViT(Z, HIER, SIZE2, patch_size=16, embed_dim=DIM, depth=depth, num_heads=HEADS,
                dropout_rate=0.0)
    v = _variables(jm, _images())
    tm = LatentConditionerViT(Z, HIER, SIZE2, 16, DIM, depth, HEADS, 0.0, image_side=SIDE)
    return jm, v, convert.load_image_conditioner(tm, v)


def _close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train-no-dropout"])
def test_vit_b_forward_matches_jax(monkeypatch, train):
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, deterministic=None, rng=None: x)
    jm, v, tm = _pair()
    x = _images()
    want = jm.apply(v, jnp.asarray(x), deterministic=not train,
                    rngs={"dropout": jax.random.PRNGKey(3)})
    with torch.set_grad_enabled(train):
        got = tm(torch.from_numpy(x), train=train)
    assert got[0].shape == (N, Z) and got[1].shape == (N, SIZE2, HIER)
    _close(got, want)


def test_vit_b_convert_round_trip_keeps_every_bit():
    _, v, tm = _pair()
    back = convert.image_conditioner_variables(tm)
    want = dict(jax.tree_util.tree_leaves_with_path(v["params"]))
    got = dict(jax.tree_util.tree_leaves_with_path(back["params"]))
    assert set(got) == set(want) and not back["batch_stats"]
    for path, w in want.items():
        np.testing.assert_array_equal(got[path], w, err_msg=jax.tree_util.keystr(path))
    again = convert.load_image_conditioner(
        LatentConditionerViT(Z, HIER, SIZE2, 16, DIM, 1, HEADS, 0.0, image_side=SIDE), back)
    for k, t in tm.state_dict().items():
        assert torch.equal(again.state_dict()[k], t), k


@pytest.mark.parametrize("depth", [1, 2])
def test_image_conditioner_infers_the_widths_from_the_tree(depth):
    _, v, _ = _pair(depth)
    cfg = VAEConfig(latent_dim_end=Z, latent_dim=HIER, num_filter_enc=[16, 8, 8, 8])
    lc_cfg = LCConfig(input_type="image_vit", dropout_rate=0.0)   # 256 / 6 / 8 by default
    assert convert.vit_widths(v) == {"embed_dim": DIM, "depth": depth, "num_heads": HEADS,
                                     "image_side": SIDE}
    lc = convert.conditioner_from_jax(v["params"], lc_cfg, cfg, "cpu")
    assert len(lc.blocks) == depth and lc.num_heads == HEADS
    assert lc.pos_embed.shape == (1, (SIDE // 16) ** 2, DIM)
    assert lc.blocks[0].fc1.out_features == 4 * DIM
    built = convert.image_conditioner(
        LCConfig(input_type="image_vit", vit_embed_dim=DIM, vit_depth=12, vit_num_heads=HEADS),
        cfg, "cpu", image_side=SIDE)
    assert (len(built.blocks), built.num_heads, built.pos_embed.shape[-1]) == (12, HEADS, DIM)


def _in(root: Path, fn, *args):
    cwd = os.getcwd()
    os.chdir(root)
    try:
        return fn(*args)
    finally:
        os.chdir(cwd)


def test_the_training_cli_trains_a_vit_b_and_load_pipeline_serves_it(monkeypatch, tmp_path,
                                                                       capsys):
    import cv2

    side = 32
    real = timages.read_latent_conditioner_dataset_img
    monkeypatch.setattr(timages, "read_latent_conditioner_dataset_img",
                        lambda d, t, im_size=side, base_dir=None: real(d, t, side, base_dir))
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    condition = CONDITION.replace("input_type\timage", "input_type\timage_vit") + (
        f"vit_embed_dim\t{DIM}\nvit_depth\t2\nvit_num_heads\t{HEADS}\n")
    with open(tmp_path / "dataset1.pickle", "wb") as f:
        pickle.dump(synthetic_dataset(8, 10, 32, seed=0), f)
    (tmp_path / "input_data").mkdir()
    (tmp_path / "input_data" / "condition.txt").write_text(condition)
    (tmp_path / "preset.txt").write_text(PRESET)
    (tmp_path / "images").mkdir()
    rng = np.random.default_rng(0)
    for i in range(8):
        cv2.imwrite(str(tmp_path / "images" / f"design{i}.png"),
                    (rng.random((side, side)) * 255).astype(np.uint8))
    rc = _in(tmp_path, tcli.main, ["--preset=1", "--plot=2", "--size=small", "--device", "cpu",
                                   "--no_preempt_guard", "--lc_only=0"])
    assert rc == 0
    out = capsys.readouterr().out
    assert f"ViT conditioner: embedding {DIM}, depth 2, {HEADS} heads" in out
    assert "Using end-to-end latent conditioner training" in out
    pipe = _in(tmp_path, tgen.load_pipeline, "input_data/condition.txt", "preset.txt", "small",
               "model_save", "cpu")
    lc = pipe["lc"]
    assert isinstance(lc, LatentConditionerViT)
    assert (len(lc.blocks), lc.num_heads, lc.pos_embed.shape) == (2, HEADS, (1, 4, DIM))
    args = ["--inputs", "images", "--quantize", "none", "--condition", "input_data/condition.txt",
            "--preset_file", "preset.txt", "--model_dir", "model_save", "--device", "cpu"]
    assert _in(tmp_path, tgen.main, args + ["--out", str(tmp_path / "port.npy")]) == 0
    got = np.load(tmp_path / "port.npy")
    raw, _ = _in(tmp_path, timages.read_latent_conditioner_dataset_img, "/images", ".png")
    want = tgen.generate(pipe, np.float32(raw / 255.0)).cpu().numpy()
    assert got.shape == (8, 10, 32) and np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)
