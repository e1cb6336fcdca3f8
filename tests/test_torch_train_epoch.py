"""The port's trainer on the CPU at a narrow width: epochs, fitting, state
layout, and the JAX trees' layout of the whole VAE.

Data are superposed travelling waves over 300 nodes (the JAX package's
``synthetic_dataset``), scaled into [-0.7, 0.7]. Augmentation stays at its
defaults, so batches are assembled by ``ops.gather_augment`` (its plain
version here). The loss must fall over a few epochs; a CPU run launches no
kernel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simulgen_vae_tpu.data.dataset import synthetic_dataset
from simulgen_vae_tpu.models.spectral_norm import init_sn_state
from simulgen_vae_tpu.models.vae import VAE as JaxVAE
from simulgen_vae_tpu.train.optim import FusedAdamW as JaxAdamW
from simulgen_vae_tpu_torch import convert
from simulgen_vae_tpu_torch.config import VAEConfig, resolve_perf_stack
from simulgen_vae_tpu_torch.models.spectral_norm import sn_layers
from simulgen_vae_tpu_torch.ops import gather_augment as tga
from simulgen_vae_tpu_torch.ops import groupnorm_gelu as tgg
from simulgen_vae_tpu_torch.train.vae_trainer import VAETrainer

T, NODE = 12, 300


def _cfg(**kw):
    base = dict(num_param=16, num_time=T, num_node=NODE, latent_dim_end=8, latent_dim=4,
                num_filter_enc=[16, 8, 8], small=True, n_epochs=30, batch_size=4,
                lr=1e-3, alpha=100.0)
    base.update(kw)
    return VAEConfig(**base)


@pytest.fixture(scope="module")
def data():
    d = synthetic_dataset(16, T, NODE, seed=0)
    d = d - d.min(axis=(0, 1), keepdims=True)
    d = d / d.max(axis=(0, 1), keepdims=True)
    return (1.4 * d - 0.7).astype(np.float32)


def test_fit_lowers_the_loss(data):
    tgg.reset_launch_counts()
    tga.reset_launch_counts()
    trainer = VAETrainer(_cfg(lr=3e-3), device="cpu", seed=1)
    state, hist = trainer.fit(data, seed=0, epochs=12, val_every=4)
    assert state.epoch == 12
    assert np.isfinite(hist["loss"]).all() and (hist["grad_norm"] > 0).all()
    assert np.mean(hist["recon"][-2:]) < 0.8 * np.mean(hist["recon"][:2])
    assert np.isfinite(hist["val_loss"]).all()
    assert np.all(hist["lr"] <= 3e-3) and hist["beta"][0] == pytest.approx(1e-4)
    assert all(n == 0 for n in (*tgg.LAUNCHES.values(), *tga.LAUNCHES.values()))
    for u in state.sn_u.values():
        assert float(torch.linalg.vector_norm(u)) == pytest.approx(1.0, rel=1e-4)
    assert all(p.dtype == torch.float32 for p in state.model.parameters())


def test_train_epoch_covers_the_data_and_keeps_metrics_on_device(data):
    """13 samples in batches of 4: 4 steps, the last wrap-padded; metrics are
    0-d tensors (no host sync inside the epoch); max_steps cuts it short."""
    trainer = VAETrainer(_cfg(), device="cpu")
    state = trainer.init_state(3)
    x = torch.from_numpy(data[:13])
    calls = []
    real = trainer.assemble_batch
    trainer.assemble_batch = lambda d, idx: calls.append(list(idx)) or real(d, idx)
    state, metrics = trainer.train_epoch(state, x)
    assert len(calls) == 4 and set(sum(calls, [])) == set(range(13))
    assert all(torch.is_tensor(metrics[k]) and metrics[k].dim() == 0
               for k in ("loss", "recon", "kl", "recon_mse", "grad_norm"))
    assert state.epoch == 1 and state.opt_state["count"] == 4
    state, _ = trainer.train_epoch(state, x, max_steps=2)
    assert len(calls) == 6 and state.opt_state["count"] == 6


def test_train_step_eval_and_bf16(data):
    trainer = VAETrainer(_cfg(dtype="bfloat16"), device="cpu")
    state = trainer.init_state(4)
    x = torch.from_numpy(data[:4]).to(torch.bfloat16)
    state, m = trainer.train_step(state, x, x.flip(0))
    assert np.isfinite(float(m["loss"])) and state.epoch == 0
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
    ev = trainer.eval_epoch(state, torch.from_numpy(data[:6]).to(torch.bfloat16))
    assert set(ev) == {"loss", "recon", "kl", "recon_mse"}
    assert np.isfinite(float(ev["loss"]))


def test_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VAETrainer(_cfg())


def test_tpu_only_stack_is_refused():
    """Nothing of the benched stack is refused any more: "auto" still resolves
    to f32 moments and the per-step cadence, every named option builds a
    trainer, and only an unknown value raises (ValueError, as in the JAX
    package)."""
    assert resolve_perf_stack(_cfg()) == {"moment_dtype": "", "nu_dtype": "",
                                          "stochastic_round": False, "sn_per_epoch": False}
    for kw in (dict(opt_state_dtype="bfloat16"), dict(opt_state_dtype="bfloat16_rtn"),
               dict(sn_cadence="epoch"), dict(remat=True)):
        VAETrainer(_cfg(**kw), device="cpu")
    for kw in (dict(opt_state_dtype="float64"), dict(sn_cadence="always")):
        with pytest.raises(ValueError):
            VAETrainer(_cfg(**kw), device="cpu")


def _paths(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_paths(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = tuple(np.shape(v))
    return out


@pytest.mark.parametrize("small", [True, False])
def test_random_vae_tree_has_jax_layout(small):
    """convert.random_vae_tree makes the exact paths and shapes of the JAX
    VAE's parameter tree, and the port model takes it, its AdamW moments and
    its spectral-norm vectors."""
    cfg = _cfg(small=small)
    vae = JaxVAE(latent_dim=8, hierarchical_dim=4, num_filter_enc=cfg.num_filter_enc,
                 num_filter_dec=cfg.num_filter_dec, num_node=NODE, num_time=T, small=small)
    key = jax.random.PRNGKey(0)
    want = jax.eval_shape(lambda: vae.init({"params": key, "sample": key},
                                           jnp.zeros((2, T, NODE))))["params"]
    tree = convert.random_vae_tree(cfg, np.random.default_rng(0))
    assert _paths(tree) == _paths(want)

    trainer = VAETrainer(cfg, device="cpu")
    model = convert.load_state(trainer.build_model(), convert.vae_state(tree))
    opt = JaxAdamW().init(tree)
    mapped = convert.adamw_state(opt._replace(count=np.int32(7)))
    assert mapped["count"] == 7
    assert set(mapped["mu"]) == set(mapped["nu"]) == set(dict(model.named_parameters()))
    u = convert.sn_u_state(jax.tree_util.tree_map(np.asarray, init_sn_state(tree, key)))
    assert set(u) == set(sn_layers(model))
