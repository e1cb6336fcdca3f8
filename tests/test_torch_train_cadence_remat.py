"""The per-epoch spectral-norm cadence, ``remat`` and ``eval_params`` of the
port's trainer against the JAX trainer's, on the CPU in f32.

Geometry as ``test_torch_train_step.py``: T = 12, 300 nodes, encoder filters
[16, 8, 8], batch 4, augmentation off; one random tree in the JAX layout, the
same ``u`` vectors and the same reparameterisation noise on both sides.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simulgen_vae_tpu.config import VAEConfig as JaxCfg
from simulgen_vae_tpu.data.augmentation import AugmentationConfig as JaxAug
from simulgen_vae_tpu.models import decoder as jdec
from simulgen_vae_tpu.models import vae as jvae
from simulgen_vae_tpu.models.spectral_norm import compute_sigmas as jax_compute_sigmas
from simulgen_vae_tpu.models.spectral_norm import init_sn_state
from simulgen_vae_tpu.train.vae_trainer import VAETrainer as JaxTrainer
from simulgen_vae_tpu_torch import convert
from simulgen_vae_tpu_torch.config import VAEConfig
from simulgen_vae_tpu_torch.data.augmentation import AugmentationConfig
from simulgen_vae_tpu_torch.models import decoder as tdec
from simulgen_vae_tpu_torch.models import vae as tvae
from simulgen_vae_tpu_torch.models.spectral_norm import compute_sigmas
from simulgen_vae_tpu_torch.train import vae_trainer as vt
from simulgen_vae_tpu_torch.train.vae_trainer import VAETrainer

T, NODE, Z, HIER, B = 12, 300, 8, 4, 4
ENC = [16, 8, 8]
GEOM = dict(num_param=16, num_time=T, num_node=NODE, latent_dim_end=Z, latent_dim=HIER,
            num_filter_enc=ENC, small=True, n_epochs=10, batch_size=B, lr=1e-3,
            alpha=100.0, dtype="float32")
BETA = 0.5


def _noises(rng):
    return [rng.standard_normal((B, Z)).astype(np.float32),
            rng.standard_normal((B, T, ENC[::-1][1])).astype(np.float32)]


@pytest.fixture(scope="module")
def jax_run():
    """JAX ``_loss_and_grads(precomputed=(sigmas, factors))`` and
    ``eval_params`` from one state."""
    rng = np.random.default_rng(0)
    params = convert.random_vae_tree(VAEConfig(**GEOM), rng)
    batch = (0.5 * rng.standard_normal((B, T, NODE))).astype(np.float32)
    noises = _noises(rng)
    trainer = JaxTrainer(JaxCfg(**GEOM), aug=JaxAug(enabled=False), donate=False)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    sn_u = init_sn_state(jparams, jax.random.PRNGKey(1))
    sigmas, u_after, factors = jax_compute_sigmas(jparams, sn_u, update=True,
                                                  with_grad_factors=True)
    it = iter(noises)

    def fixed(key, mu, std):
        return mu + jnp.asarray(next(it)) * jnp.clip(std, 1e-8, 10.0)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jvae, "reparameterize", fixed)
        mp.setattr(jdec, "reparameterize", fixed)
        metrics, new_u, grads = trainer._loss_and_grads(
            jparams, u_after, jnp.asarray(batch), jax.random.PRNGKey(2), BETA,
            precomputed=(sigmas, factors))
    assert new_u is u_after
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    normed = trainer.eval_params(SimpleNamespace(params=jparams, sn_u=sn_u))
    state = SimpleNamespace(params=params, opt_state=to_np(trainer.opt.init(params)),
                            sn_u=to_np(sn_u), epoch=0)
    return SimpleNamespace(state=state, batch=batch, noises=noises,
                           metrics={k: float(v) for k, v in metrics.items()},
                           grads=to_np(grads), eval_params=to_np(normed))


def _fixed_noise(monkeypatch, noises):
    it = iter(noises)

    def fixed(mu, std, generator=None):
        return mu + torch.from_numpy(next(it)) * std.clamp(1e-8, 10.0)

    monkeypatch.setattr(tvae, "reparameterize", fixed)
    monkeypatch.setattr(tdec, "reparameterize", fixed)


def _trainer(**kw):
    return VAETrainer(VAEConfig(**dict(GEOM, **kw)), aug=AugmentationConfig(enabled=False),
                      device="cpu")


def test_precomputed_sigmas_match_jax(jax_run, monkeypatch):
    """Loss rtol 1e-5, gradients atol 1e-5 + rtol 1e-4 (the bounds of
    ``test_torch_train_step.py``); ``new_u`` is the state's, unchanged."""
    _fixed_noise(monkeypatch, jax_run.noises)
    trainer = _trainer(sn_cadence="epoch")
    state = convert.train_state_from_jax(trainer, jax_run.state)
    inv, state.sn_u, factors = compute_sigmas(state.model, state.sn_u, update=True,
                                              with_grad_factors=True)
    calls = []
    monkeypatch.setattr(vt, "compute_sigmas", lambda *a, **k: calls.append(k) or 1 / 0)
    metrics, new_u, grads = trainer.loss_and_grads(state, torch.from_numpy(jax_run.batch), BETA,
                                                   precomputed=(inv, factors))
    assert not calls and new_u is state.sn_u
    for k in ("loss", "recon", "kl", "recon_mse"):
        np.testing.assert_allclose(float(metrics[k]), jax_run.metrics[k], rtol=1e-5, err_msg=k)
    want = convert.vae_state(jax_run.grads)
    assert set(grads) == set(want)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[k], atol=1e-5, rtol=1e-4, err_msg=k)


def test_eval_params_match_jax(jax_run):
    trainer = _trainer()
    state = convert.train_state_from_jax(trainer, jax_run.state)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    got = trainer.eval_params(state).state_dict()
    want = convert.vae_state(jax_run.eval_params)
    assert set(got) == set(want)
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), want[k], rtol=1e-5, atol=1e-7, err_msg=k)
    assert float((got["decoder.recon.kernel"] - before["decoder.recon.kernel"]).abs().max()) > 0
    for k, v in state.model.state_dict().items():      # the train state is untouched
        assert torch.equal(v, before[k])


def _data(n, seed=0):
    return torch.from_numpy((0.4 * np.random.default_rng(seed).standard_normal((n, T, NODE)))
                            .astype(np.float32))


def _epochs(cadence, data, epochs, counter=None, monkeypatch=None):
    trainer = VAETrainer(VAEConfig(**dict(GEOM, sn_cadence=cadence)), device="cpu", seed=3)
    state = trainer.init_state(3)
    if counter is not None:
        real = vt.compute_sigmas
        monkeypatch.setattr(vt, "compute_sigmas", lambda *a, **k: counter.append(
            k.get("update", True)) or real(*a, **k))
    us = [{k: v.clone() for k, v in state.sn_u.items()}]
    for _ in range(epochs):
        state, _ = trainer.train_epoch(state, data)
        us.append({k: v.clone() for k, v in state.sn_u.items()})
    return state, us


def test_one_batch_per_epoch_makes_the_cadences_identical():
    """With one batch per epoch the power iteration runs once per step either
    way: the parameters agree bit for bit (default augmentation on)."""
    data = _data(B)
    (a, _), (b, _) = _epochs("epoch", data, 3), _epochs("step", data, 3)
    for (k, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), k
    for k in a.sn_u:
        assert torch.equal(a.sn_u[k], b.sn_u[k])


@pytest.mark.parametrize("cadence, per_epoch", [("epoch", 1), ("step", 3)])
def test_u_vectors_move_once_per_epoch(monkeypatch, cadence, per_epoch):
    updates = []
    state, us = _epochs(cadence, _data(3 * B), 2, updates, monkeypatch)
    assert updates == [True] * (2 * per_epoch)
    assert state.opt_state["count"] == 6
    k = "decoder.recon.kernel"
    assert not torch.equal(us[0][k], us[1][k]) and not torch.equal(us[1][k], us[2][k])


def test_streaming_step_iterates_every_step_under_the_epoch_cadence(monkeypatch):
    updates = []
    real = vt.compute_sigmas
    monkeypatch.setattr(vt, "compute_sigmas",
                        lambda *a, **k: updates.append(k.get("update", True)) or real(*a, **k))
    trainer = _trainer(sn_cadence="epoch")
    state = trainer.init_state(0)
    batch = _data(B)
    for _ in range(2):
        state, _ = trainer.train_step(state, batch, batch.flip(0))
    assert updates == [True, True]


def test_remat_gives_the_same_loss_and_gradients(jax_run, monkeypatch):
    """Exact: checkpointing reruns the same CPU operations on the same values
    in the same order, and no residual block draws noise."""
    out = {}
    for remat in (False, True):
        _fixed_noise(monkeypatch, jax_run.noises)
        trainer = _trainer(remat=remat)
        state = convert.train_state_from_jax(trainer, jax_run.state)
        assert state.model.decoder.remat is remat
        metrics, _, grads = trainer.loss_and_grads(state, torch.from_numpy(jax_run.batch), BETA)
        out[remat] = (metrics, grads)
    assert float(out[True][0]["loss"]) == float(out[False][0]["loss"])
    for k, g in out[True][1].items():
        assert torch.equal(g, out[False][1][k]), k


def test_remat_with_the_fused_readout_trains(monkeypatch):
    trainer = VAETrainer(VAEConfig(**dict(GEOM, remat=True, sn_cadence="epoch",
                                          opt_state_dtype="bfloat16")),
                         device="cpu", fused_readout=True, readout_bwd="fused")
    state = trainer.init_state(0)
    state, m = trainer.train_epoch(state, _data(2 * B))
    assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0
