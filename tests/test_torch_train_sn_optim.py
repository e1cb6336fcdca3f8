"""Port spectral norm, AdamW, schedules and losses vs the JAX package, f32.

* ``compute_sigmas``: inv_sigma and the updated ``u`` of every kernel of a
  narrow VAE (T = 12, 300 nodes, filters [16, 8, 8]) against JAX's, atol
  1e-6; the rank-1 sigma terms through ``add_sigma_rank1_grads`` on the same
  random gradients and sigma cotangents, atol 1e-6 + rtol 1e-5. JAX orders a
  k > 1 conv's rows (tap, channel), the port (channel, tap): comparing the
  gradients in the weight layout covers the mapping.
* ``FusedAdamW`` fed the same gradients as JAX's (f32 state) for three
  steps: parameters, moments and gradient norm within rtol 1e-6.
* ``beta_schedule`` and ``cosine_warm_restarts`` epoch by epoch (and the
  latter against torch's own ``CosineAnnealingWarmRestarts``), rtol 1e-5.
* ``kl``, ``kl_2`` and every reconstruction flavor's pair, values and
  gradients, rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simulgen_vae_tpu import losses as jl
from simulgen_vae_tpu.models import spectral_norm as jsn
from simulgen_vae_tpu.train.optim import FusedAdamW as JaxAdamW
from simulgen_vae_tpu.train.schedules import cosine_warm_restarts as jax_cwr
from simulgen_vae_tpu_torch import convert
from simulgen_vae_tpu_torch import losses as tl
from simulgen_vae_tpu_torch.config import VAEConfig
from simulgen_vae_tpu_torch.models import spectral_norm as tsn
from simulgen_vae_tpu_torch.train.optim import FusedAdamW
from simulgen_vae_tpu_torch.train.schedules import cosine_warm_restarts
from simulgen_vae_tpu_torch.train.vae_trainer import VAETrainer

CFG = VAEConfig(num_time=12, num_node=300, latent_dim_end=8, latent_dim=4,
                num_filter_enc=[16, 8, 8], small=False)


_jax_sigmas = jax.jit(jsn.compute_sigmas, static_argnames=("update", "compute_dtype",
                                                         "with_grad_factors"))


def _kernel_named(tree):
    """A tree with ``inv_sigma`` leaves renamed ``kernel`` (JAX's sigma
    collection sits where the kernels sit)."""
    if not isinstance(tree, dict):
        return np.asarray(tree)
    return {("kernel" if k == "inv_sigma" else k): _kernel_named(v) for k, v in tree.items()}


@pytest.fixture(scope="module")
def sn_case():
    rng = np.random.default_rng(0)
    params = convert.random_vae_tree(CFG, rng)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    u = jsn.init_sn_state(jparams, jax.random.PRNGKey(3))
    model = convert.load_state(VAETrainer(CFG, device="cpu").build_model(),
                               convert.vae_state(params))
    tu = {k: torch.from_numpy(np.array(v)) for k, v in
          convert.sn_u_state(jax.tree_util.tree_map(np.asarray, u)).items()}
    return params, jparams, u, model, tu


@pytest.mark.parametrize("update", [True, False])
def test_sigmas_and_u_match_jax(sn_case, update):
    _, jparams, u, model, tu = sn_case
    jsig, jnew_u = _jax_sigmas(jparams, u, update=update)
    inv, new_u = tsn.compute_sigmas(model, tu, update=update)
    want_inv = convert.sn_u_state(_kernel_named(jsig))
    want_u = convert.sn_u_state(jax.tree_util.tree_map(np.asarray, jnew_u))
    assert set(inv) == set(want_inv) == set(tsn.sn_layers(model))
    assert len(inv) == len(jax.tree_util.tree_leaves(u))
    for k in inv:
        np.testing.assert_allclose(float(inv[k]), float(want_inv[k]), rtol=1e-6, err_msg=k)
        np.testing.assert_allclose(new_u[k].numpy(), want_u[k], atol=1e-6, err_msg=k)


def test_rank1_grads_match_jax(sn_case):
    params, jparams, u, model, tu = sn_case
    rng = np.random.default_rng(1)
    grads = jax.tree_util.tree_map(
        lambda a: rng.standard_normal(np.shape(a)).astype(np.float32), params)
    jsig, _, factors = _jax_sigmas(jparams, u, update=True, with_grad_factors=True)
    g_sig = jax.tree_util.tree_map(lambda a: np.float32(rng.standard_normal()), jsig)
    want = jax.jit(jsn.add_sigma_rank1_grads)(
        jax.tree_util.tree_map(jnp.asarray, grads),
        jax.tree_util.tree_map(jnp.asarray, g_sig), factors)
    _, _, tfactors = tsn.compute_sigmas(model, tu, update=True, with_grad_factors=True)
    tgrads = {k: torch.from_numpy(v.copy()) for k, v in convert.vae_state(grads).items()}
    g_inv = {k: torch.tensor(v) for k, v in convert.sn_u_state(_kernel_named(g_sig)).items()}
    tsn.add_sigma_rank1_grads(tgrads, g_inv, tfactors)
    want = convert.vae_state(jax.tree_util.tree_map(np.asarray, want))
    changed = 0
    for k, g in tgrads.items():
        np.testing.assert_allclose(g.numpy(), want[k], atol=1e-6, rtol=1e-5, err_msg=k)
        changed += k in g_inv and not np.array_equal(want[k], convert.vae_state(grads)[k])
    assert changed == len(g_inv)


def test_adamw_matches_jax_on_the_same_grads():
    rng = np.random.default_rng(2)
    shapes = {"a": (5, 7), "b": (7,), "c": (3, 4, 2)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    jopt, topt = JaxAdamW(), FusedAdamW()
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = jopt.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = topt.init(tp)
    for step, lr in enumerate((1e-3, 5e-4, 2e-3)):
        g = {k: (rng.standard_normal(s) * 10.0 ** (step - 2)).astype(np.float32)
             for k, s in shapes.items()}
        jp, js, jnorm = jopt.apply(jax.tree_util.tree_map(jnp.asarray, g), js, jp, lr)
        tnorm = topt.apply({k: torch.from_numpy(v) for k, v in g.items()}, ts, tp, lr)
        np.testing.assert_allclose(float(tnorm), float(jnorm), rtol=1e-6)
        for k in shapes:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(ts["mu"][k].numpy(), np.asarray(js.mu[k]),
                                       rtol=1e-6, atol=1e-12)
            np.testing.assert_allclose(ts["nu"][k].numpy(), np.asarray(js.nu[k]),
                                       rtol=1e-6, atol=1e-16)
    assert ts["count"] == int(js.count) == 3


@pytest.mark.parametrize("n_epochs", [100, 37])
def test_beta_schedule_matches_jax(n_epochs):
    for e in range(n_epochs + 3):
        np.testing.assert_allclose(tl.beta_schedule(e, n_epochs),
                                   float(jl.beta_schedule(e, n_epochs)), rtol=1e-5)


@pytest.mark.parametrize("t_0", [5, 25])
def test_cosine_warm_restarts_matches_jax_and_torch(t_0):
    lr, eta_min = 1e-3, 1e-7
    opt = torch.optim.SGD([torch.nn.Parameter(torch.zeros(1))], lr=lr)
    sched = torch.optim.lr_scheduler.CosineAnnealingWarmRestarts(opt, T_0=t_0, T_mult=2,
                                                                 eta_min=eta_min)
    for e in range(8 * t_0):
        got = cosine_warm_restarts(e, lr, t_0, 2, eta_min)
        np.testing.assert_allclose(got, opt.param_groups[0]["lr"], rtol=1e-9, atol=1e-15)
        np.testing.assert_allclose(got, float(jax_cwr(e, lr, t_0, 2, eta_min)),
                                   rtol=1e-5, atol=1e-9)
        sched.step()


def test_kl_terms_match_jax():
    rng = np.random.default_rng(4)
    mu, lv = (rng.standard_normal((4, 8)).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(float(tl.kl(torch.from_numpy(mu), torch.from_numpy(lv))),
                               float(jl.kl(mu, lv)), rtol=1e-5)
    maps = [rng.standard_normal((4, 6, 5)).astype(np.float32) for _ in range(4)]
    np.testing.assert_allclose(float(tl.kl_2(*map(torch.from_numpy, maps))),
                               float(jl.kl_2(*maps)), rtol=1e-5)


@pytest.mark.parametrize("name", sorted(jl.RECON_LOSSES))
def test_recon_pair_matches_jax(name):
    rng = np.random.default_rng(5)
    pred = rng.standard_normal((3, 4, 50)).astype(np.float32)
    target = (pred + rng.standard_normal(pred.shape)).astype(np.float32)

    def jloss(p, t):
        a, b = jl.make_recon_loss_pair(name)(p, t)
        return a + 0.5 * b, (a, b)

    (_, (ja, jb)), (jgp, jgt) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(pred), jnp.asarray(target))
    p, t = (torch.from_numpy(v).requires_grad_() for v in (pred, target))
    a, b = tl.make_recon_loss_pair(name)(p, t)
    (a + 0.5 * b).backward()
    for got, want in ((a, ja), (b, jb), (p.grad, jgp), (t.grad, jgt)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-8)
