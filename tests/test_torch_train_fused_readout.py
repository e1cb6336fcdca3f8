"""The fused-readout train path as a whole: the port's trainer against the JAX
trainer's, and against the port's own unfused route, on the CPU in f32.

Geometry as ``test_torch_train_step.py``: T = 12, 300 nodes (6 groups of 50),
encoder filters [16, 8, 8], batch 4, augmentation off. Both trainers run with
``fused_readout=True`` from one random tree in the JAX layout, the same
spectral-norm ``u`` and the same reparameterisation noise. The JAX side runs
its Pallas readout kernels in interpret mode; the port's wrappers take their
plain versions for CPU tensors. Loss rtol 1e-5; gradients atol 1e-5 + rtol
5e-4 (the op's own gradient bound in the JAX package's tests: its backward
sums T x C terms in another order).
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
from simulgen_vae_tpu_torch.ops import readout_chain as trc
from simulgen_vae_tpu_torch.train.vae_trainer import VAETrainer

T, NODE, Z, HIER, B = 12, 300, 8, 4, 4
ENC = [16, 8, 8]
GEOM = dict(num_param=16, num_time=T, num_node=NODE, latent_dim_end=Z, latent_dim=HIER,
            num_filter_enc=ENC, small=True, n_epochs=10, batch_size=B, lr=1e-3,
            alpha=100.0, dtype="float32")
BETA = 0.5
READOUT = "decoder.recon.kernel"


def _noises(rng):
    return [rng.standard_normal((B, Z)).astype(np.float32),
            rng.standard_normal((B, T, ENC[::-1][1])).astype(np.float32)]


def _jax_run(use_sn: bool, loss_type: str):
    geom = dict(GEOM, use_spectral_norm=use_sn, loss_type=loss_type)
    rng = np.random.default_rng(0)
    params = convert.random_vae_tree(VAEConfig(**geom), rng)
    batch = (0.5 * rng.standard_normal((B, T, NODE))).astype(np.float32)
    noises = _noises(rng)
    trainer = JaxTrainer(JaxCfg(**geom), aug=JaxAug(enabled=False), donate=False,
                         fused_readout=True)
    assert trainer._use_fused_readout()
    as_jnp = lambda tree: jax.tree_util.tree_map(jnp.asarray, tree)  # noqa: E731
    sn_u = init_sn_state(as_jnp(params), jax.random.PRNGKey(1)) if use_sn else {}
    it = iter(noises)

    def fixed(key, mu, std):
        return mu + jnp.asarray(next(it)) * jnp.clip(std, 1e-8, 10.0)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jvae, "reparameterize", fixed)
        mp.setattr(jdec, "reparameterize", fixed)
        metrics, new_u, grads = jax.jit(trainer._loss_and_grads)(
            as_jnp(params), sn_u, jnp.asarray(batch), jax.random.PRNGKey(2), BETA)
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    state = SimpleNamespace(params=params, opt_state=to_np(trainer.opt.init(params)),
                            sn_u=to_np(sn_u), epoch=0)
    return SimpleNamespace(geom=geom, state=state, batch=batch, noises=noises,
                           metrics={k: float(v) for k, v in metrics.items()},
                           new_u=to_np(new_u), grads=to_np(grads))


@pytest.fixture(scope="module", params=["sn_mse", "no_sn_huber"])
def jax_run(request):
    return _jax_run(*{"sn_mse": (True, "MSE"), "no_sn_huber": (False, "Huber")}[request.param])


def _port_grads(run, fused: bool, monkeypatch):
    it = iter(run.noises)

    def fixed(mu, std, generator=None):
        return mu + torch.from_numpy(next(it)) * std.clamp(1e-8, 10.0)

    monkeypatch.setattr(tvae, "reparameterize", fixed)
    monkeypatch.setattr(tdec, "reparameterize", fixed)
    trainer = VAETrainer(VAEConfig(**run.geom), aug=AugmentationConfig(enabled=False),
                         device="cpu", fused_readout=fused)
    state = convert.train_state_from_jax(trainer, run.state)
    return trainer, state, trainer.loss_and_grads(state, torch.from_numpy(run.batch), BETA)


def test_fused_loss_and_grads_match_jax(jax_run, monkeypatch):
    trc.reset_launch_counts()
    _, _, (metrics, new_u, grads) = _port_grads(jax_run, True, monkeypatch)
    assert all(n == 0 for n in (*trc.LAUNCHES.values(), *tgg.LAUNCHES.values()))
    for k in ("loss", "recon", "kl", "recon_mse"):
        np.testing.assert_allclose(float(metrics[k]), jax_run.metrics[k], rtol=1e-5,
                                   err_msg=k)
    want = convert.vae_state(jax_run.grads)
    assert set(grads) == set(want)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[k], atol=1e-5, rtol=5e-4, err_msg=k)
    want_u = convert.sn_u_state(jax_run.new_u) if jax_run.new_u else {}
    assert set(new_u) == set(want_u)
    for k, u in new_u.items():
        np.testing.assert_allclose(u.numpy(), want_u[k], atol=1e-6, err_msg=k)


def test_fused_matches_unfused_inside_the_port(jax_run, monkeypatch):
    """The two routes of the port from one state, batch and noise: the same
    loss, the same gradients (the readout's sigma term included)."""
    _, _, (m_f, _, g_f) = _port_grads(jax_run, True, monkeypatch)
    _, _, (m_u, _, g_u) = _port_grads(jax_run, False, monkeypatch)
    for k in ("loss", "recon", "kl", "recon_mse"):
        np.testing.assert_allclose(float(m_f[k]), float(m_u[k]), rtol=1e-5, err_msg=k)
    assert float(torch.linalg.vector_norm(g_f[READOUT])) > 0
    for k in g_f:
        np.testing.assert_allclose(g_f[k].numpy(), g_u[k].numpy(), atol=1e-5, rtol=5e-4,
                                   err_msg=k)


def test_converted_state_is_the_same_on_both_routes(jax_run):
    """``convert.train_state_from_jax`` needs nothing new for the fused route:
    parameters, moments and ``u`` are equal to the unfused trainer's, and the
    readout's four parameters and its ``u`` are there."""
    states = []
    for fused in (True, False):
        trainer = VAETrainer(VAEConfig(**jax_run.geom), device="cpu", fused_readout=fused)
        states.append(convert.train_state_from_jax(trainer, jax_run.state))
    a, b = states
    pa, pb = dict(a.model.named_parameters()), dict(b.model.named_parameters())
    assert set(pa) == set(pb)
    assert all(torch.equal(pa[k], pb[k]) for k in pa)
    assert all(torch.equal(a.opt_state["mu"][k], b.opt_state["mu"][k]) for k in pa)
    assert set(a.sn_u) == set(b.sn_u)
    assert all(torch.equal(a.sn_u[k], b.sn_u[k]) for k in a.sn_u)
    for leaf in ("kernel", "bias", "scale", "norm_bias"):
        assert f"decoder.recon.{leaf}" in pa
    assert tuple(pa[READOUT].shape) == (NODE, ENC[0])
    if jax_run.geom["use_spectral_norm"]:
        assert READOUT in a.sn_u


def test_x_hat_is_none_on_the_fused_route():
    trainer = VAETrainer(VAEConfig(**GEOM), device="cpu", fused_readout=True)
    model = trainer.init_state(0).model
    x = 0.3 * torch.randn(B, T, NODE, generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    x_hat, recon, kls, mse = model(x, gen, fused_readout_loss=True)
    assert x_hat is None and recon.dim() == 0 and mse.dim() == 0 and len(kls) == 2
    gen = torch.Generator().manual_seed(1)
    x_hat_u, recon_u, _, mse_u = model(x, gen)
    assert tuple(x_hat_u.shape) == (B, T, NODE)
    np.testing.assert_allclose(float(recon.detach()), float(recon_u.detach()), rtol=1e-5)
    np.testing.assert_allclose(float(mse.detach()), float(mse_u.detach()), rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_epoch_and_eval_on_the_cpu(dtype):
    """One epoch and one evaluation through the fused route: finite metrics,
    the readout's parameters and the encoder's moved, no kernel launched on the CPU; ``fused_readout``
    defaults to off."""
    assert VAETrainer(VAEConfig(**GEOM), device="cpu").fused_readout is False
    cfg = VAEConfig(**dict(GEOM, dtype=dtype))
    trainer = VAETrainer(cfg, device="cpu", seed=2, fused_readout=True)
    state = trainer.init_state(2)
    before = {k: p.detach().clone() for k, p in state.model.named_parameters()}
    gen = torch.Generator().manual_seed(3)
    data = (0.4 * torch.randn(10, T, NODE, generator=gen)).to(trainer.dtype)
    trc.reset_launch_counts()
    state, metrics = trainer.train_epoch(state, data)
    assert state.epoch == 1 and state.opt_state["count"] == 3
    assert all(np.isfinite(float(metrics[k])) for k in
               ("loss", "recon", "kl", "recon_mse", "grad_norm"))
    assert float(metrics["grad_norm"]) > 0
    moved = {k for k, p in state.model.named_parameters() if not torch.equal(p, before[k])}
    assert {f"decoder.recon.{leaf}" for leaf in ("kernel", "bias", "scale", "norm_bias")} <= moved
    assert "encoder.enc_block.0.convs.0.weight" in moved
    ev = trainer.eval_epoch(state, data)
    assert set(ev) == {"loss", "recon", "kl", "recon_mse"}
    assert all(np.isfinite(float(v)) for v in ev.values())
    assert all(n == 0 for n in trc.LAUNCHES.values())


def test_eval_is_the_same_on_both_routes():
    data = 0.4 * torch.randn(6, T, NODE, generator=torch.Generator().manual_seed(5))
    out = []
    for fused in (True, False):
        trainer = VAETrainer(VAEConfig(**GEOM), device="cpu", seed=4, fused_readout=fused)
        out.append(trainer.eval_epoch(trainer.init_state(4), data))
    for k in out[0]:
        np.testing.assert_allclose(float(out[0][k]), float(out[1][k]), rtol=1e-5, err_msg=k)
