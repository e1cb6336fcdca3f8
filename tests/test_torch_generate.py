"""The port's serving slice vs the JAX serving path at a narrow width.

T = 8, 300 nodes (group_count drops to 6), decoder filters [4, 8, 16, 32],
MLP conditioner on 12 inputs. The JAX pipeline runs with its Pallas
GroupNorm kernels on (interpret mode here); the port runs on the CPU in f32.
Outputs agree to atol 1e-4, rtol 1e-4 through the depth of the decoder.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simulgen_vae_tpu import generate as jgen
from simulgen_vae_tpu.models import LatentConditioner as JaxLC
from simulgen_vae_tpu.models.vae import VAE as JaxVAE
from simulgen_vae_tpu.ops.groupnorm_gelu import set_pallas
from simulgen_vae_tpu_torch import convert
from simulgen_vae_tpu_torch import generate as tgen
from simulgen_vae_tpu_torch.config import LCConfig, VAEConfig
from simulgen_vae_tpu_torch.data.scaler import MinMaxScaler
from simulgen_vae_tpu_torch.models import blocks

T, NODE, Z, HIER = 8, 300, 8, 4
ENC = [32, 16, 8, 4]
LC_FILTERS, N_IN = [8, 16, 16], 12
CFG = VAEConfig(num_time=T, num_node=NODE, latent_dim_end=Z, latent_dim=HIER,
                num_filter_enc=ENC)
LC_CFG = LCConfig(filters=LC_FILTERS, input_type="csv")


@pytest.fixture(scope="module")
def setup():
    """Weights from convert.random_*_tree, whose layout
    test_random_trees_have_jax_layout pins to the JAX modules' own trees."""
    size2 = CFG.num_hier
    vae = JaxVAE(latent_dim=Z, hierarchical_dim=HIER, num_filter_enc=ENC,
                 num_filter_dec=ENC[::-1], num_node=NODE, num_time=T, small=True)
    lc = JaxLC(LC_FILTERS, Z, N_IN, HIER, size2, dropout_rate=0.0)
    rng = np.random.default_rng(1)
    vae_params = {"decoder": convert.random_decoder_tree(CFG, rng)}
    # Quiet prior/posterior heads keep log_var < 2 ln 100, as trained ones do,
    # so mode='fix' noise stays at std 1e-8 (test_fix_mode_noise_is_negligible).
    for name, sub in vae_params["decoder"].items():
        if name.startswith("condition_"):
            sub["Conv1d_0"]["Conv_0"]["kernel"] *= 0.1
    lc_params = convert.random_conditioner_tree(LC_CFG, CFG, N_IN, rng)
    rng = np.random.default_rng(3)
    scalers = {
        name: MinMaxScaler(rng.uniform(0.5, 2.0, n).astype(np.float32),
                           rng.uniform(-0.3, 0.3, n).astype(np.float32))
        for name, n in (("lv_scaler", Z), ("xs_scaler", size2 * HIER),
                        ("data_scaler", NODE))}
    jax_pipe = dict(
        cfg=SimpleNamespace(num_node=NODE), vae_model=vae,
        vae_vars={"params": vae_params}, lc_model=lc,
        lc_vars={"params": lc_params},
        **{k: SimpleNamespace(scale_=s.scale_, min_=s.min_) for k, s in scalers.items()})
    port_pipe = tgen.make_pipeline(CFG, LC_CFG, vae_params, lc_params,
                                   device="cpu", dtype=torch.float32, **scalers)
    inputs = np.random.default_rng(4).standard_normal((7, N_IN)).astype(np.float32)
    return SimpleNamespace(vae=vae, vae_params=vae_params, jax_pipe=jax_pipe,
                           port_pipe=port_pipe, inputs=inputs)


def _jax_generate(s, descale):
    set_pallas(True)
    try:
        return jgen.generate(s.jax_pipe, s.inputs, descale_output=descale)
    finally:
        set_pallas(None)


@pytest.mark.parametrize("descale", [False, True])
def test_generate_matches_jax(setup, descale):
    want = _jax_generate(setup, descale)
    got = tgen.generate(setup.port_pipe, setup.inputs, descale_output=descale)
    assert got.shape == (7, T, NODE) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("max_batch", [3, 7])
def test_chunked_generate_matches_unchunked(setup, max_batch):
    """7 requests at max_batch 3 run as 3 + 3 + (1 padded to 3)."""
    whole = tgen.generate(setup.port_pipe, setup.inputs, descale_output=False)
    parts = tgen.generate(setup.port_pipe, setup.inputs, descale_output=False,
                          max_batch=max_batch)
    np.testing.assert_allclose(parts.numpy(), whole.numpy(), atol=1e-6)


def test_fix_mode_noise_is_negligible(setup):
    """mode='fix' still samples, at std 1e-8 while log_var < 2 ln 100: two
    generators give the same zs to 1e-6 for this model and input."""
    vae = setup.port_pipe["vae"]
    z = torch.from_numpy(np.tanh(setup.inputs[:, :Z]))
    xs = [torch.from_numpy(np.tanh(setup.inputs[:, i:i + HIER])) for i in range(3)]
    with torch.inference_mode():
        _, _, zs_a = vae.decode(z, xs, mode="fix", generator=torch.Generator().manual_seed(1))
        _, _, zs_b = vae.decode(z, xs, mode="fix", generator=torch.Generator().manual_seed(2))
    for a, b in zip(zs_a, zs_b):
        assert float((a - b).abs().max()) < 1e-6


def test_decode_random_mode_with_frozen_zs_matches_jax(setup):
    """Random-mode decode fed JAX's own samples as frozen_zs; KL terms too."""
    rng = np.random.default_rng(5)
    z = rng.standard_normal((3, Z)).astype(np.float32)
    xs = [rng.standard_normal((3, HIER)).astype(np.float32) for _ in range(3)]
    decode = jax.jit(lambda p, z_, xs_: setup.vae.apply(
        {"params": p}, z_, xs_, method=JaxVAE.decode,
        rngs={"sample": jax.random.PRNGKey(9)}))
    out, kls, zs = decode(setup.vae_params, z, xs)
    with torch.inference_mode():
        got, got_kls, got_zs = setup.port_pipe["vae"].decode(
            torch.from_numpy(z), [torch.from_numpy(a) for a in xs], mode="random",
            frozen_zs=[torch.from_numpy(np.array(a)) for a in zs])
    np.testing.assert_allclose(got.numpy(), np.asarray(out), atol=1e-4, rtol=1e-4)
    assert len(got_kls) == len(kls) == 2
    for a, b in zip(got_kls, kls):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4)


def test_served_convolutions_reach_cudnn_in_its_layout(setup):
    """make_generate_fn holds the decoder's k > 1 conv weights in cuDNN's
    order: a chunk of the four-filter decoder runs 14 of its 17 such
    convolutions direct, copies the 3 latent injectors' transposed inputs
    and no weight (models.blocks.CONV_LAYOUT)."""
    fn = tgen.make_generate_fn(setup.port_pipe, descale_output=False, max_batch=7)
    convs = [m for m in setup.port_pipe["vae"].modules()
             if isinstance(m, blocks.Conv1d) and m.weight.shape[-1] > 1]
    assert len(convs) == 17
    assert all(m.weight.unsqueeze(2).is_contiguous(memory_format=torch.channels_last)
               for m in convs)
    before = dict(blocks.CONV_LAYOUT)
    fn(setup.inputs)
    assert {k: blocks.CONV_LAYOUT[k] - before[k] for k in before} == {
        "conv.direct": 14, "conv.input_copied": 3, "conv.weight_copied": 0}


def _paths(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_paths(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = tuple(np.shape(v))
    return out


@pytest.mark.parametrize("small", [True, False])
def test_random_trees_have_jax_layout(setup, small):
    """convert.random_*_tree (used where no trained weights exist) make the
    exact paths and shapes of the JAX modules' trees."""
    cfg = VAEConfig(num_time=T, num_node=NODE, latent_dim_end=Z, latent_dim=HIER,
                    num_filter_enc=ENC, small=small)
    vae = JaxVAE(latent_dim=Z, hierarchical_dim=HIER, num_filter_enc=ENC,
                 num_filter_dec=ENC[::-1], num_node=NODE, num_time=T, small=small)
    key = jax.random.PRNGKey(0)
    want = jax.eval_shape(lambda: vae.init({"params": key, "sample": key},
                                           jnp.zeros((2, T, NODE))))["params"]["decoder"]
    rng = np.random.default_rng(0)
    assert _paths(convert.random_decoder_tree(cfg, rng)) == _paths(want)
    lc = setup.jax_pipe["lc_model"]
    lc_want = jax.eval_shape(lambda: lc.init({"params": key, "dropout": key},
                                             jnp.zeros((1, N_IN)), deterministic=True))
    got = convert.random_conditioner_tree(LC_CFG, CFG, N_IN, rng)
    assert _paths(got) == _paths(lc_want["params"])
