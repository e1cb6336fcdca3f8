"""The port's train step as a whole vs the JAX trainer's, at a narrow width.

T = 12, 300 nodes (``group_count`` gives 6 groups of 50), encoder filters
[16, 8, 8], batch 4, f32, augmentation off. Both start from one random tree
in the JAX layout (``convert.random_vae_tree``), the same spectral-norm ``u``
and the same reparameterisation noise, fed to both by monkeypatching
``reparameterize`` in the JAX package's modules and in the port's. The
port's loss and every gradient (spectral norm's rank-1 terms included) agree
with ``VAETrainer._loss_and_grads``: loss rtol 1e-5, gradients atol 1e-5 +
rtol 1e-4 (float reassociation through the depth of the model: the port's
GroupNorm backward is analytic, JAX's is autodiff of its reference). The
GroupNorm routes are forced in turn: one-pass forward and backward, one-pass
forward with the two-phase backward, two-phase both ways.
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
from simulgen_vae_tpu.models.spectral_norm import init_sn_state
from simulgen_vae_tpu.train.vae_trainer import VAETrainer as JaxTrainer
from simulgen_vae_tpu_torch import convert
from simulgen_vae_tpu_torch.config import VAEConfig
from simulgen_vae_tpu_torch.data.augmentation import AugmentationConfig
from simulgen_vae_tpu_torch.models import decoder as tdec
from simulgen_vae_tpu_torch.models import vae as tvae
from simulgen_vae_tpu_torch.ops import groupnorm_gelu as tgg
from simulgen_vae_tpu_torch.train.vae_trainer import VAETrainer

T, NODE, Z, HIER, B = 12, 300, 8, 4, 4
ENC = [16, 8, 8]
GEOM = dict(num_param=16, num_time=T, num_node=NODE, latent_dim_end=Z, latent_dim=HIER,
            num_filter_enc=ENC, small=True, n_epochs=10, batch_size=B, lr=1e-3,
            alpha=100.0, dtype="float32")
BETA = 0.5


def _noises(rng):
    """The reparameterisation noise in call order: top-level z, then one
    decoder level (decoder filters [8, 8, 16])."""
    return [rng.standard_normal((B, Z)).astype(np.float32),
            rng.standard_normal((B, T, ENC[::-1][1])).astype(np.float32)]


@pytest.fixture(scope="module")
def jax_run():
    rng = np.random.default_rng(0)
    params = convert.random_vae_tree(VAEConfig(**GEOM), rng)
    batch = (0.5 * rng.standard_normal((B, T, NODE))).astype(np.float32)
    noises = _noises(rng)
    trainer = JaxTrainer(JaxCfg(**GEOM), aug=JaxAug(enabled=False), donate=False)
    sn_u = init_sn_state(jax.tree_util.tree_map(jnp.asarray, params),
                         jax.random.PRNGKey(1))
    it = iter(noises)

    def fixed(key, mu, std):
        return mu + jnp.asarray(next(it)) * jnp.clip(std, 1e-8, 10.0)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jvae, "reparameterize", fixed)
        mp.setattr(jdec, "reparameterize", fixed)
        metrics, new_u, grads = jax.jit(trainer._loss_and_grads)(
            jax.tree_util.tree_map(jnp.asarray, params), sn_u, jnp.asarray(batch),
            jax.random.PRNGKey(2), BETA)
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    state = SimpleNamespace(params=params, opt_state=to_np(trainer.opt.init(params)),
                            sn_u=to_np(sn_u), epoch=0)
    return SimpleNamespace(state=state, batch=batch, noises=noises,
                           metrics={k: float(v) for k, v in metrics.items()},
                           new_u=to_np(new_u), grads=to_np(grads))


ROUTES = {
    "onepass": dict(),
    "onepass_fwd_tiled_bwd": dict(onepass_bwd_fits=lambda *a: False),
    "tiled": dict(onepass_fits=lambda *a: False, onepass_bwd_fits=lambda *a: False),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_loss_and_grads_match_jax(jax_run, monkeypatch, route):
    for name, fn in ROUTES[route].items():
        monkeypatch.setattr(tgg, name, fn)
    it = iter(jax_run.noises)

    def fixed(mu, std, generator=None):
        return mu + torch.from_numpy(next(it)) * std.clamp(1e-8, 10.0)

    monkeypatch.setattr(tvae, "reparameterize", fixed)
    monkeypatch.setattr(tdec, "reparameterize", fixed)
    trainer = VAETrainer(VAEConfig(**GEOM), aug=AugmentationConfig(enabled=False),
                         device="cpu")
    state = convert.train_state_from_jax(trainer, jax_run.state)
    tgg.reset_launch_counts()
    metrics, new_u, grads = trainer.loss_and_grads(
        state, torch.from_numpy(jax_run.batch), BETA)
    assert all(n == 0 for n in tgg.LAUNCHES.values())  # plain versions on the CPU

    for k in ("loss", "recon", "kl", "recon_mse"):
        np.testing.assert_allclose(float(metrics[k]), jax_run.metrics[k], rtol=1e-5,
                                   err_msg=k)
    want = convert.vae_state(jax_run.grads)
    assert set(grads) == set(want)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[k], atol=1e-5, rtol=1e-4, err_msg=k)
    want_u = convert.sn_u_state(jax_run.new_u)
    assert set(new_u) == set(want_u)
    for k, u in new_u.items():
        np.testing.assert_allclose(u.numpy(), want_u[k], atol=1e-6, err_msg=k)
