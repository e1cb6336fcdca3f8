"""The port's end-to-end trainer and the image ``LCTrainer`` against the JAX
package's (``train/lc_e2e_trainer.py``, ``train/lc_trainer.py``), on the same
numpy inputs and JAX-initialized weights:

* ``reference_e2e_reinit`` on the CNN and the ViT: per leaf, the rule that
  fires is JAX's (untouched leaves, including the ViT attention's 3-D
  kernels and their biases, keep their bits; biases 0; scales 1); the random
  leaves' mean and std against JAX's draws (of at least 1024 values), within
  four standard errors and 15%;
* ``hybrid_clip`` at global norms below, inside and above [1e-5, 10]:
  rtol 1e-6 against JAX's;
* one ``E2ETrainer`` loss and its gradients on a tiny VAE (T = 8, 300 nodes,
  the decoder frozen) and a CNN conditioner with spectral norm, in training
  mode with dropout off (flax's ``Dropout`` monkeypatched to the identity),
  the noise drawn with numpy and added on both sides: loss within 1e-4
  relative, every gradient within rel-L2 1e-3 (one that cancels to noise,
  a bias before a training-mode BatchNorm, within 1e-5 of the whole
  gradient's norm), the decoder given none;
* one image ``LCTrainer`` step with spectral norm on: loss, gradients, the
  moved ``u`` vectors and BatchNorm statistics, then the clipped AdamW
  update against the optax chain (parameters rel-L2 1e-5; those whose
  gradient cancels to noise move by at most the learning rate on both
  sides);
* ``E2ETrainer.fit`` (the port's ``LCTrainer`` loop): it returns the state
  of the best validation loss, the current one on a preemption request, and
  rolls back to the best state on a non-finite train loss with no
  checkpoint;
* a CNN trained with spectral norm by JAX's ``LCTrainer.fit``: the served
  route (raw kernels, eval mode, what ``generate`` applies) and the
  normalised one (``predict_fn``) equal JAX's (1e-4), and the printed gap
  between them (the reference's behaviour, ROADMAP Queue 3).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from simulgen_vae_tpu.data.scaler import MinMaxScaler as JaxScaler
from simulgen_vae_tpu.models import LatentConditionerImg as JaxImg
from simulgen_vae_tpu.models import LatentConditionerViT as JaxViT
from simulgen_vae_tpu.models import conditioner_cnn as jcnn
from simulgen_vae_tpu.models.spectral_norm import init_sn_state as jax_init_sn
from simulgen_vae_tpu.models.vae import VAE as JaxVAE
from simulgen_vae_tpu.train import lc_e2e_trainer as je2e
from simulgen_vae_tpu.train.lc_trainer import LCTrainer as JaxLCTrainer
from simulgen_vae_tpu.train.schedules import lc_warmup_cosine as jax_lc_lr
from simulgen_vae_tpu_torch import convert
from simulgen_vae_tpu_torch.config import VAEConfig
from simulgen_vae_tpu_torch.data.scaler import MinMaxScaler
from simulgen_vae_tpu_torch.models import LatentConditionerImg, LatentConditionerViT
from simulgen_vae_tpu_torch.models.conditioner_cnn import sn_filter
from simulgen_vae_tpu_torch.train import lc_e2e_trainer as te2e
from simulgen_vae_tpu_torch.train.lc_trainer import LCTrainer, LCTrainState, forward_model
from simulgen_vae_tpu_torch.train.vae_trainer import VAETrainer
from simulgen_vae_tpu_torch.utils import preemption
from simulgen_vae_tpu_torch.utils.checkpoint import CheckpointManager
from tests.test_torch_conditioner_img import jax_variables, outline_images

SIDE, Z, HIER = 32, 8, 4
T, NODE, ENC = 8, 300, [16, 8, 4]          # two hierarchical levels
SIZE2 = len(ENC) - 1
FILTERS = [8, 16, 32, 64]              # three blocks: SE + spatial attention on the third
CFG = VAEConfig(num_time=T, num_node=NODE, latent_dim_end=Z, latent_dim=HIER,
                num_filter_enc=ENC, small=True)


def _rel_l2(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture
def no_flax_dropout(monkeypatch):
    monkeypatch.setattr(fnn.Dropout, "__call__",
                        lambda self, x, deterministic=None, rng=None: x)


def _no_port_dropout(model):
    for m in model.modules():
        if hasattr(m, "dropout_rate"):
            m.dropout_rate = 0.0
    return model


def _flat(tree) -> dict:
    return {tuple(k.key for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _port_grads_as_flax(model) -> dict:
    paths = convert.image_conditioner_paths(model)
    return {paths[n][1][1:]: convert._to_flax(paths[n][0], p.grad).numpy()
            for n, p in model.named_parameters()}


def _assert_grads_close(have: dict, want: dict, tol: float) -> None:
    """Each gradient within rel-L2 ``tol``; one that cancels to noise (a
    bias before a training-mode BatchNorm: norm under 1e-4 of the whole
    gradient's) within ``tol * 1e-2`` of the whole gradient's norm."""
    total = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in want.values()))
    assert set(have) == set(want)
    for k, g in want.items():
        err, size = float(np.linalg.norm(have[k] - g)), float(np.linalg.norm(g))
        if size <= 1e-4 * total:
            assert err <= tol * 1e-2 * total, (k, err, total)
        else:
            assert err <= tol * size, (k, err / size)


def _sn_u_port(model, jax_u) -> dict:
    by_path = {path[1:]: name for name, (_, path) in convert.image_conditioner_paths(model).items()}
    return {by_path[k]: torch.from_numpy(v.copy()) for k, v in _flat(jax_u).items()}


# -- reference_e2e_reinit -----------------------------------------------------------

def _rule(path, before, after) -> str:
    if np.array_equal(before, after):
        return "same"
    if not after.any():
        return "zeros"
    if np.all(after == 1.0):
        return "ones"
    return "random"


@pytest.mark.parametrize("name", ["cnn", "vit"])
def test_reinit_fires_jax_rules_per_leaf(name):
    x = outline_images(np.random.default_rng(0), 4)
    if name == "cnn":
        jm, tm = JaxImg(FILTERS, Z, HIER, SIZE2), LatentConditionerImg(FILTERS, Z, HIER, SIZE2)
    else:
        jm = JaxViT(Z, HIER, SIZE2, patch_size=16, embed_dim=64, depth=2, num_heads=4)
        tm = LatentConditionerViT(Z, HIER, SIZE2, 16, 64, 2, 4, image_side=SIDE)
    v = jax_variables(jm, x)
    want = _flat(je2e.reference_e2e_reinit(v["params"], jax.random.PRNGKey(7)))
    convert.load_image_conditioner(tm, v)
    te2e.reference_e2e_reinit(tm, torch.Generator().manual_seed(7))
    got = _flat(convert.image_conditioner_variables(tm)["params"])
    before = _flat(v["params"])
    assert set(got) == set(want) == set(before)
    rules = {}
    for k in want:
        rule = _rule(k, before[k], want[k])
        rules[k] = rule
        assert _rule(k, before[k], got[k]) == rule, k
        if rule != "random":
            np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))
        elif want[k].size >= 1024:
            # means within 4 standard errors of their difference, stds 15%
            sem = want[k].std() * np.sqrt(2.0 / want[k].size)
            assert abs(got[k].mean() - want[k].mean()) < 4 * sem, k
            assert abs(got[k].std() / want[k].std() - 1.0) < 0.15, k
            if want[k].ndim == 2 and want[k].shape[1] <= 64:
                assert abs(got[k].std() - 0.1) < 0.015, k
            else:
                bound = np.sqrt(6.0 / np.prod(want[k].shape[:-1]))
                assert np.abs(got[k]).max() <= bound + 1e-6, k
    kinds = {"zeros", "ones", "random"} | ({"same"} if name == "vit" else set())
    assert set(rules.values()) == kinds
    if name == "vit":
        attn = [k for k in rules if "MultiHeadDotProductAttention_0" in k]
        assert len(attn) == 16 and all(rules[k] == "same" for k in attn)
        assert rules[("pos_embed",)] == "same"
        assert rules[("latent_main_head", "kernel")] == "random"
    else:
        assert rules[("sn_initial_conv", "kernel")] == "random"
        assert rules[("xs_layer1", "BatchNorm_0", "scale")] == "ones"


@pytest.mark.parametrize("norm", [3e-6, 1.0, 50.0], ids=["below", "inside", "above"])
def test_hybrid_clip_matches_jax(norm):
    rng = np.random.default_rng(0)
    grads = {"a": rng.standard_normal((6, 5)).astype(np.float32),
             "b": rng.standard_normal(7).astype(np.float32)}
    total = np.sqrt(sum(float((g ** 2).sum()) for g in grads.values()))
    grads = {k: np.float32(g * norm / total) for k, g in grads.items()}
    want, _ = je2e.hybrid_clip(1e-5, 10.0).update(grads, optax.EmptyState())
    got, got_norm = te2e.hybrid_clip({k: torch.from_numpy(g) for k, g in grads.items()})
    np.testing.assert_allclose(float(got_norm), norm, rtol=1e-5)
    for k in grads:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6)
    new_norm = np.sqrt(sum(float((g ** 2).sum()) for g in got.values()))
    np.testing.assert_allclose(new_norm, min(max(norm, 1e-5), 10.0), rtol=1e-5)


# -- one E2E loss and its gradients -------------------------------------------------

@pytest.fixture(scope="module")
def vae_params():
    vae = JaxVAE(latent_dim=Z, hierarchical_dim=HIER, num_filter_enc=ENC,
                 num_filter_dec=ENC[::-1], num_node=NODE, num_time=T, small=True)
    params = jax.jit(lambda k: vae.init({"params": k, "sample": k},
                                        jnp.zeros((1, T, NODE))))(jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, params["params"])


def _jax_vae():
    return JaxVAE(latent_dim=Z, hierarchical_dim=HIER, num_filter_enc=ENC,
                  num_filter_dec=ENC[::-1], num_node=NODE, num_time=T, small=True)


@pytest.fixture(scope="module")
def e2e_data():
    rng = np.random.default_rng(3)
    n = 8
    x = outline_images(rng, n)
    y1 = rng.uniform(-0.7, 0.7, (n, Z)).astype(np.float32)
    y2 = rng.uniform(-0.7, 0.7, (n, SIZE2, HIER)).astype(np.float32)
    target = rng.uniform(-0.5, 0.5, (n, T, NODE)).astype(np.float32)
    noise = [rng.standard_normal(a.shape).astype(np.float32) * s
             for a, s in ((x, 0.1), (y1, 0.05), (y2, 0.05), (target, 0.05))]
    lv = JaxScaler().fit(rng.standard_normal((20, Z)) * 2.0)
    xs = JaxScaler().fit(rng.standard_normal((20, SIZE2 * HIER)))
    return [a + e for a, e in zip((x, y1, y2, target), noise)], lv, xs


def _port_scaler(j):
    return MinMaxScaler(np.float32(j.scale_), np.float32(j.min_))


def test_e2e_loss_and_gradients_match_jax(vae_params, e2e_data, no_flax_dropout):
    (x, y1, y2, target), lv, xs = e2e_data
    jm = JaxImg(FILTERS, Z, HIER, SIZE2, dropout_rate=0.0)
    v = jax_variables(jm, x)
    sn_u = jax_init_sn(v["params"], jax.random.PRNGKey(2), filter_fn=jcnn.sn_filter)
    jt = je2e.E2ETrainer(jm, _jax_vae(), vae_params, lv, xs, epochs=4, lr=1e-3, batch_size=8,
                         loss_function="Huber", lc_alpha=10.0, latent_reg_weight=1e-3,
                         sn_filter=jcnn.sn_filter)
    (loss, (_, new_u, metrics)), grads = jax.jit(jax.value_and_grad(jt._loss_fn, has_aux=True), static_argnums=-1)(
        v["params"], v["batch_stats"], sn_u, *map(jnp.asarray, (x, y1, y2, target)),
        jax.random.PRNGKey(4), True)

    vae = convert.load_state(VAETrainer(CFG, device="cpu").build_model(),
                             convert.vae_state(vae_params)).eval()
    model = _no_port_dropout(convert.load_image_conditioner(
        LatentConditionerImg(FILTERS, Z, HIER, SIZE2, 0.0), v))
    trainer = te2e.E2ETrainer(model, vae, _port_scaler(lv), _port_scaler(xs), epochs=4,
                              lr=1e-3, batch_size=8, loss_function="Huber", lc_alpha=10.0,
                              latent_reg_weight=1e-3, sn_filter=sn_filter, device="cpu")
    assert not any(p.requires_grad for p in vae.parameters())
    state = LCTrainState(model, trainer.opt.init(dict(model.named_parameters())),
                         _sn_u_port(model, sn_u))
    forward = forward_model(state, sn_filter, update=True)
    got, got_metrics = trainer.loss_fn(forward, *map(torch.from_numpy, (x, y1, y2, target)),
                                       torch.Generator().manual_seed(0))
    got.backward()
    np.testing.assert_allclose(float(got), float(loss), rtol=1e-4)
    for k in ("recon", "reg"):
        np.testing.assert_allclose(float(got_metrics[k]), float(metrics[k]), rtol=1e-4)
    _assert_grads_close(_port_grads_as_flax(model), _flat(grads), 1e-3)
    for k, u in _flat(new_u).items():
        np.testing.assert_allclose(forward.new_u[_sn_u_key(model, k)].numpy(), u, rtol=1e-5,
                                   atol=1e-6)
    assert all(p.grad is None for p in vae.parameters())


def _sn_u_key(model, jax_path):
    by_path = {path[1:]: name for name, (_, path) in convert.image_conditioner_paths(model).items()}
    return by_path[jax_path]


# -- one image LCTrainer step with spectral norm -------------------------------------

def test_image_lc_step_with_sn_matches_jax(no_flax_dropout):
    rng = np.random.default_rng(3)
    n = 8
    x = outline_images(rng, n)
    y1 = rng.uniform(-0.7, 0.7, (n, Z)).astype(np.float32)
    y2 = rng.uniform(-0.7, 0.7, (n, SIZE2, HIER)).astype(np.float32)
    jm = JaxImg(FILTERS, Z, HIER, SIZE2, dropout_rate=0.0)
    v = jax_variables(jm, x, seed=5)
    sn_u = jax_init_sn(v["params"], jax.random.PRNGKey(6), filter_fn=jcnn.sn_filter)
    jt = JaxLCTrainer(jm, epochs=4, lr=1e-3, batch_size=8, weight_decay=1e-4,
                      is_image_data=True, sn_filter=jcnn.sn_filter)
    (loss, (new_bs, new_u, metrics)), grads = jax.jit(jax.value_and_grad(jt._loss_fn, has_aux=True), static_argnums=-1)(
        v["params"], v["batch_stats"], sn_u, *map(jnp.asarray, (x, y1, y2)),
        jax.random.PRNGKey(4), True)

    model = _no_port_dropout(convert.load_image_conditioner(
        LatentConditionerImg(FILTERS, Z, HIER, SIZE2, 0.0), v))
    trainer = LCTrainer(model, epochs=4, lr=1e-3, batch_size=8, weight_decay=1e-4,
                        device="cpu", is_image_data=True, sn_filter=sn_filter)
    state = LCTrainState(model, trainer.opt.init(dict(model.named_parameters())),
                         _sn_u_port(model, sn_u))
    forward = forward_model(state, sn_filter, update=True)
    got, got_metrics = trainer.loss_fn(forward, *map(torch.from_numpy, (x, y1, y2)),
                                       torch.Generator().manual_seed(0))
    got.backward()
    np.testing.assert_allclose(float(got), float(loss), rtol=1e-4)
    _assert_grads_close(_port_grads_as_flax(model), _flat(grads), 1e-3)
    for k, u in _flat(new_u).items():
        np.testing.assert_allclose(forward.new_u[_sn_u_key(model, k)].numpy(), u, rtol=1e-5,
                                   atol=1e-6)
    stats = _flat(convert.image_conditioner_variables(model)["batch_stats"])
    for k, s in _flat(new_bs).items():
        np.testing.assert_allclose(stats[k], s, rtol=1e-4, atol=1e-4, err_msg=str(k))

    # the update: clip at global norm 10, then AdamW at the first warm-up rate
    opt_state = jt.tx.init(v["params"])
    opt_state[1].hyperparams["learning_rate"] = jax_lc_lr(0, 1e-3, 4, jt.warmup_epochs)
    updates, _ = jt.tx.update(grads, opt_state, v["params"])
    want_params = _flat(optax.apply_updates(v["params"], updates))
    port_grads = {n: p.grad for n, p in model.named_parameters()}
    lr = float(jax_lc_lr(0, 1e-3, 4, trainer.warmup_epochs))
    norm = trainer.apply_grads(state, port_grads, lr)
    np.testing.assert_allclose(float(norm), float(optax.global_norm(grads)), rtol=1e-3)
    params_after = _flat(convert.image_conditioner_variables(model)["params"])
    flat_grads, total = _flat(grads), float(optax.global_norm(grads))
    for k, w in want_params.items():
        if np.linalg.norm(flat_grads[k]) <= 1e-4 * total:
            # AdamW's first step moves a parameter by about lr whatever the
            # size of its gradient: where that cancels to noise, by lr
            assert np.abs(params_after[k] - w).max() <= 2.1 * lr, k
        else:
            assert _rel_l2(params_after[k], w) <= 1e-5, k


# -- E2ETrainer.fit: the LCTrainer loop with the best state kept -------------------

def _e2e_trainer(vae_params, lv, xs):
    vae = convert.load_state(VAETrainer(CFG, device="cpu").build_model(),
                             convert.vae_state(vae_params)).eval()
    return te2e.E2ETrainer(LatentConditionerImg(FILTERS, Z, HIER, SIZE2, 0.1), vae,
                           _port_scaler(lv), _port_scaler(xs), epochs=4, lr=3e-3,
                           batch_size=8, loss_function="Huber", lc_alpha=10.0,
                           sn_filter=sn_filter, device="cpu")


def test_e2e_fit_returns_the_best_state_or_the_current_one_when_preempted(
        vae_params, e2e_data, tmp_path):
    arrays, lv, xs = e2e_data
    state, history = _e2e_trainer(vae_params, lv, xs).fit(*arrays)
    assert len(history["val_loss"]) == 4 and np.isfinite(history["loss"]).all()
    assert state.epoch == int(np.argmin(history["val_loss"])) + 1

    manager = CheckpointManager(str(tmp_path), save_interval_epochs=100)
    preemption.request()
    try:
        state, history = _e2e_trainer(vae_params, lv, xs).fit(*arrays, ckpt_manager=manager)
    finally:
        preemption.clear()
    assert state.epoch == 1 and len(history["loss"]) == 1
    assert manager.latest_step() == 1


def test_e2e_fit_rolls_back_to_the_best_state_without_a_checkpoint(vae_params, e2e_data,
                                                                   capsys):
    arrays, lv, xs = e2e_data
    trainer = _e2e_trainer(vae_params, lv, xs)
    real, calls = trainer.loss_fn, []

    def poisoned(model, x, y1, y2, target, generator=None):
        loss, metrics = real(model, x, y1, y2, target, generator)
        if generator is not None:
            calls.append(1)
            if len(calls) == 3:   # the one step of the third epoch, once
                loss = loss * float("nan")
                metrics["loss"] = loss.detach()
        return loss, metrics

    trainer.loss_fn = poisoned
    state, history = trainer.fit(*arrays)
    assert "[nan_guard:e2e] non-finite train loss at epoch 2; rolled back to in-memory " \
           "best state" in capsys.readouterr().out
    assert len(history["loss"]) == 4 and np.isfinite(history["loss"]).all()


# -- the served route against the normalised one -------------------------------------

def test_served_and_normalised_routes_of_a_cnn_trained_with_sn(capsys):
    filters = [8, 16, 32, 32]
    rng = np.random.default_rng(9)
    n = 12
    x = outline_images(rng, n)
    y1 = rng.uniform(-0.7, 0.7, (n, Z)).astype(np.float32)
    y2 = rng.uniform(-0.7, 0.7, (n, SIZE2, HIER)).astype(np.float32)
    jm = JaxImg(filters, Z, HIER, SIZE2, dropout_rate=0.1)
    jt = JaxLCTrainer(jm, epochs=6, lr=3e-3, batch_size=4, is_image_data=True,
                      sn_filter=jcnn.sn_filter)
    state, _ = jt.fit(x, y1, y2, jax.random.PRNGKey(0), val_every=100)
    variables = {"params": jax.tree_util.tree_map(np.asarray, state.params),
                 "batch_stats": jax.tree_util.tree_map(np.asarray, state.batch_stats)}
    served_jax = jm.apply(variables, jnp.asarray(x), deterministic=True)   # generate's route
    normed_jax = jt.predict_fn(state)(jnp.asarray(x))

    model = convert.load_image_conditioner(LatentConditionerImg(filters, Z, HIER, SIZE2, 0.1),
                                           variables)
    trainer = LCTrainer(model, epochs=6, lr=3e-3, batch_size=4, device="cpu",
                        is_image_data=True, sn_filter=sn_filter)
    port_state = LCTrainState(model, trainer.opt.init(dict(model.named_parameters())),
                              _sn_u_port(model, jax.tree_util.tree_map(np.asarray, state.sn_u)))
    with torch.no_grad():
        served = model(torch.from_numpy(x))
    normed = trainer.predict_fn(port_state)(x)
    for got, want in ((served, served_jax), (normed, normed_jax)):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)
    gaps = [_rel_l2(s.numpy(), m.numpy()) for s, m in zip(served, normed)]
    with capsys.disabled():
        print(f"\nserved (raw kernels) vs W / sigma forward of a CNN trained with SN: rel-L2 "
              f"main {gaps[0]:.4f}, hierarchical {gaps[1]:.4f}")
    assert min(gaps) > 1e-3   # the heads' BatchNorms do not cancel sigma
