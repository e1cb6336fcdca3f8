"""The port's image conditioners against the JAX modules, with weights carried
by ``convert.py`` (JAX-initialized, moved off their inits by 0.05 normal,
BatchNorm statistics made positive) on the same numpy images (binary outlines
of 32 x 32, a batch of 8):

* each conditioner's forward in eval mode, and in train mode with dropout
  off (flax's ``Dropout`` monkeypatched to the identity on the JAX side, no
  generator on the port's): rtol / atol 1e-4 in f32; the CNN with squeeze-
  excitation and spatial attention on blocks 2-4 and on a signed input; the
  ViT's attention at 4 heads;
* the BatchNorm statistics after one train-mode forward: atol 1e-4;
* ``convert`` round trips: the same leaves and values back, and a missing or
  extra leaf raises, named;
* the spectral-norm filter on the CNN: the layers, sigmas and ``u`` of
  JAX's ``spectral_normalize`` (rtol 1e-5);
* the ViT's attention dropout is one mask ``[1, 1, q, k]``, and the simple
  CNN's channel dropout one ``[B, C, 1, 1]``.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simulgen_vae_tpu.models import LatentConditionerImg as JaxImg
from simulgen_vae_tpu.models import LatentConditionerViT as JaxViT
from simulgen_vae_tpu.models import conditioner_cnn as jcnn
from simulgen_vae_tpu.models.conditioner_simple_cnn import (
    SimpleLatentConditionerImg as JaxSimple,
)
from simulgen_vae_tpu.models.spectral_norm import init_sn_state as jax_init_sn
from simulgen_vae_tpu.models.spectral_norm import spectral_normalize as jax_sn
from simulgen_vae_tpu_torch import convert
from simulgen_vae_tpu_torch.models import (
    LatentConditionerImg,
    LatentConditionerViT,
    SimpleLatentConditionerImg,
)
from simulgen_vae_tpu_torch.models import spectral_norm as tsn
from simulgen_vae_tpu_torch.models.conditioner_cnn import sn_filter
from simulgen_vae_tpu_torch.models.conditioner_simple_cnn import channel_dropout

SIDE, N, Z, HIER, SIZE2 = 32, 8, 8, 4, 3
FILTERS = [8, 16, 32, 64, 128, 128]   # six blocks: SE + spatial attention on 2-4


def outline_images(rng, n, side=SIDE) -> np.ndarray:
    """``n`` binary images of one to three filled discs, ``[n, side^2]`` f32."""
    yy, xx = np.mgrid[:side, :side]
    out = np.zeros((n, side, side), np.float32)
    for i in range(n):
        for _ in range(rng.integers(1, 4)):
            cy, cx = rng.uniform(0, side, 2)
            r = rng.uniform(2, side / 3)
            out[i][(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = 1.0
    return out.reshape(n, -1)


MODELS = {
    "cnn": (lambda: JaxImg(FILTERS, Z, HIER, SIZE2, dropout_rate=0.0),
            lambda: LatentConditionerImg(FILTERS, Z, HIER, SIZE2, 0.0, True)),
    "cnn_no_attention": (lambda: JaxImg(FILTERS, Z, HIER, SIZE2, dropout_rate=0.0,
                                        use_attention=False),
                         lambda: LatentConditionerImg(FILTERS, Z, HIER, SIZE2, 0.0, False)),
    "simple_cnn": (lambda: JaxSimple([4], Z, HIER, SIZE2, dropout_rate=0.0),
                   lambda: SimpleLatentConditionerImg([4], Z, HIER, SIZE2, 0.0)),
    "vit": (lambda: JaxViT(Z, HIER, SIZE2, patch_size=16, embed_dim=32, depth=2, num_heads=4,
                           dropout_rate=0.0),
            lambda: LatentConditionerViT(Z, HIER, SIZE2, 16, 32, 2, 4, 0.0, image_side=SIDE)),
}


@pytest.fixture(scope="module")
def images():
    return outline_images(np.random.default_rng(0), N)


def jax_variables(module, x, seed=0) -> dict:
    """JAX-initialized variables moved off their inits, as numpy."""
    v = jax.jit(lambda k: module.init({"params": k, "dropout": k}, jnp.asarray(x),
                                      deterministic=True))(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 1)
    v = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)).astype(np.float32),
        dict(v))
    if "batch_stats" in v:
        v["batch_stats"] = jax.tree_util.tree_map(lambda a: np.abs(a) + 0.5, v["batch_stats"])
    return v


@pytest.fixture
def no_flax_dropout(monkeypatch):
    monkeypatch.setattr(fnn.Dropout, "__call__",
                        lambda self, x, deterministic=None, rng=None: x)


def _close(got, want, tol=1e-4):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=tol, atol=tol)


@pytest.mark.parametrize("name", list(MODELS))
@pytest.mark.parametrize("signed", [False, True], ids=["unsigned", "signed"])
def test_eval_forward_matches_jax(images, name, signed):
    x = images * 2.0 - 1.0 if signed else images
    jm, tm = MODELS[name][0](), MODELS[name][1]()
    v = jax_variables(jm, x)
    convert.load_image_conditioner(tm, v)
    want = jm.apply(v, jnp.asarray(x), deterministic=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got[0].shape == (N, Z) and got[1].shape == (N, SIZE2, HIER)
    _close(got, want)


@pytest.mark.parametrize("name", ["cnn", "simple_cnn", "vit"])
def test_train_forward_and_batch_stats_match_jax(images, name, no_flax_dropout):
    jm, tm = MODELS[name][0](), MODELS[name][1]()
    v = jax_variables(jm, images)
    convert.load_image_conditioner(tm, v)
    mutable = ["batch_stats"] if "batch_stats" in v else []
    want, updates = jm.apply(v, jnp.asarray(images), deterministic=False, mutable=mutable,
                             rngs={"dropout": jax.random.PRNGKey(3)})
    got = tm(torch.from_numpy(images), train=True)
    _close(got, want)
    if mutable:
        stats = convert.image_conditioner_variables(tm)["batch_stats"]
        flat_want = jax.tree_util.tree_leaves_with_path(updates["batch_stats"])
        flat_got = dict(jax.tree_util.tree_leaves_with_path(stats))
        assert len(flat_want) == len(flat_got) > 0
        for path, w in flat_want:
            np.testing.assert_allclose(flat_got[path], np.asarray(w), rtol=1e-4, atol=1e-4,
                                       err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("name", list(MODELS))
def test_convert_round_trip_keeps_every_leaf(images, name):
    jm, tm = MODELS[name][0](), MODELS[name][1]()
    v = jax_variables(jm, images)
    back = convert.image_conditioner_variables(convert.load_image_conditioner(tm, v))
    want = dict(jax.tree_util.tree_leaves_with_path({k: v[k] for k in ("params", "batch_stats")
                                                     if k in v}))
    got = dict(jax.tree_util.tree_leaves_with_path({k: x for k, x in back.items() if x}))
    assert set(got) == set(want)
    for path, w in want.items():
        np.testing.assert_array_equal(got[path], w, err_msg=jax.tree_util.keystr(path))
    assert len(convert.image_conditioner_paths(tm)) == len(want) == len(
        tm.state_dict())


def test_a_missing_or_extra_leaf_raises_named(images):
    jm, tm = MODELS["cnn"][0](), MODELS["cnn"][1]()
    v = jax_variables(jm, images)
    del v["params"]["layer_3"]["SpatialAttention_0"]
    with pytest.raises(KeyError, match="params/layer_3/SpatialAttention_0 is missing"):
        convert.load_image_conditioner(tm, v)
    v = jax_variables(jm, images)
    v["batch_stats"]["xs_layer2"]["BatchNorm_0"]["extra"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="batch_stats/xs_layer2/BatchNorm_0/extra"):
        convert.load_image_conditioner(tm, v)


def test_sn_filter_sigmas_and_u_match_jax(images):
    jm, tm = MODELS["cnn"][0](), MODELS["cnn"][1]()
    v = jax_variables(jm, images)
    convert.load_image_conditioner(tm, v)
    ju = jax_init_sn(v["params"], jax.random.PRNGKey(5), filter_fn=jcnn.sn_filter)
    paths = convert.image_conditioner_paths(tm)
    by_path = {path[1:]: name for name, (_, path) in paths.items()}
    flat_u = dict(jax.tree_util.tree_leaves_with_path(ju))
    names = {by_path[tuple(k.key for k in p)]: np.asarray(u) for p, u in flat_u.items()}
    # the same layers: the sn_* convs and dense layers, not SE, skip_proj or outputs
    assert set(names) == set(tsn.sn_layers(tm, sn_filter))
    # the 7x7 stem, two convs in each of 5 blocks, 4 skips, sn_fp1 and 2, 4 head layers
    assert all(sn_filter(n) for n in names) and len(names) == 21
    u = {n: torch.from_numpy(a) for n, a in names.items()}
    for update in (False, True):
        want_p, want_u = jax_sn(v["params"], ju, update=update)
        normed, new_u = tsn.spectral_normalize(tm, u, update=update, filter_fn=sn_filter)
        flat_p = dict(jax.tree_util.tree_leaves_with_path(want_p))
        flat_nu = dict(jax.tree_util.tree_leaves_with_path(want_u))
        for path, a in flat_nu.items():
            key = tuple(k.key for k in path)
            name = by_path[key]
            layout = paths[name][0]
            np.testing.assert_allclose(new_u[name].numpy(), np.asarray(a), rtol=1e-5,
                                       atol=1e-6, err_msg=name)
            np.testing.assert_allclose(
                normed[name].detach().numpy(),
                convert._from_flax(layout, np.asarray(flat_p[path])), rtol=1e-5, atol=1e-6,
                err_msg=name)


def test_vit_attention_dropout_is_one_mask_for_every_sample_and_head():
    tm = LatentConditionerViT(Z, HIER, SIZE2, 16, 32, 1, 4, 0.5, image_side=SIDE)
    attn = tm.blocks[0].attn
    weights = []
    real = torch.softmax

    def record(t, dim):
        out = real(t, dim=dim)
        weights.append(out)
        return out

    x = torch.randn(3, 4, 32)
    torch.softmax = record
    try:
        out = attn(x, torch.Generator().manual_seed(0))
    finally:
        torch.softmax = real
    assert out.shape == x.shape and weights[0].shape == (3, 4, 4, 4)
    # recompute with the same draws: the mask is [1, 1, q, k]
    mask = torch.rand((1, 1, 4, 4), generator=torch.Generator().manual_seed(0)) < 0.5
    v = attn.value(x).reshape(3, 4, 4, 8).transpose(1, 2)
    h = ((weights[0] * mask / 0.5) @ v).transpose(1, 2).reshape(3, 4, 32)
    torch.testing.assert_close(out, attn.out(h))


def test_channel_dropout_drops_whole_channels():
    x = torch.ones(16, 64, 5, 5)
    out = channel_dropout(x, 0.3, torch.Generator().manual_seed(0))
    per_channel = out.reshape(16, 64, 25)
    assert torch.all((per_channel == per_channel[..., :1]).all(-1))
    kept = (per_channel[..., 0] > 0).float().mean()
    assert abs(float(kept) - 0.7) < 0.05
    torch.testing.assert_close(per_channel[..., 0].unique(), torch.tensor([0.0, 1 / 0.7]))
    assert channel_dropout(x, 0.3, None) is x


@pytest.mark.parametrize("kind", ["image", "image_vit"])
def test_random_trees_have_the_jax_modules_paths_and_shapes(kind):
    """An image conditioner with random weights (its ``init_weights``) at the
    flagship's conditioner widths, as ``convert.image_conditioner_variables``
    gives it: the JAX module's tree, leaf for leaf, shape for shape, and it
    loads back."""
    from simulgen_vae_tpu_torch.config import LCConfig, VAEConfig

    cfg = VAEConfig(latent_dim_end=32, latent_dim=8, num_filter_enc=[1024, 512, 256, 128])
    lc_cfg = LCConfig(filters=[32, 64, 128, 256, 512, 1024], input_type=kind)
    model = convert.image_conditioner(lc_cfg, cfg, "cpu")
    got = convert.image_conditioner_variables(model.init_weights(torch.Generator().manual_seed(0)))
    if kind == "image":
        module = JaxImg(lc_cfg.filters, 32, 8, cfg.num_hier, use_attention=True)
    else:
        module = JaxViT(32, 8, cfg.num_hier)
    want = jax.eval_shape(lambda k: module.init({"params": k, "dropout": k},
                                                jnp.zeros((1, 256 * 256)),
                                                deterministic=True), jax.random.PRNGKey(0))
    shapes = lambda tree: {p: tuple(v.shape) for p, v in   # noqa: E731
                           jax.tree_util.tree_leaves_with_path(tree)}
    assert shapes({k: got[k] for k in want}) == shapes(dict(want))
    assert bool(got["batch_stats"]) == (kind == "image")
    lc = convert.conditioner_from_jax(got["params"], lc_cfg, cfg, "cpu",
                                      batch_stats=got["batch_stats"])
    assert all(bool(torch.isfinite(t).all()) for t in lc.state_dict().values())
