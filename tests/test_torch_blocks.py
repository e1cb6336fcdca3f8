"""Port encoder and decoder blocks vs the JAX blocks, weights carried over by convert.py.

Each JAX block is initialised from a key, its parameters are perturbed with
seeded numpy noise (so biases and norm affines are not at their 0/1 inits),
and the same tree goes through ``simulgen_vae_tpu_torch.convert``. f32,
atol 1e-5.
"""

import jax
import numpy as np
import pytest
import torch

from simulgen_vae_tpu.models import blocks as jb
from simulgen_vae_tpu.models import decoder as jd
from simulgen_vae_tpu_torch import convert
from simulgen_vae_tpu_torch.models import blocks as tb
from simulgen_vae_tpu_torch.models import decoder as td


def _perturbed_params(module, x, seed):
    params = module.init(jax.random.PRNGKey(seed), x)["params"]
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.1 * rng.standard_normal(a.shape)).astype(np.float32),
        params)


CASES = {
    # name: (JAX module, port module, state fn, input shape)
    "residual_small": (lambda: jb.ResidualBlock(16, True),
                       lambda: tb.ResidualBlock(16, True),
                       convert.stages_state, (2, 10, 16)),
    "residual_large": (lambda: jb.ResidualBlock(16, False),
                       lambda: tb.ResidualBlock(16, False),
                       convert.stages_state, (2, 10, 16)),
    "decoder_residual_small": (lambda: jb.DecoderResidualBlock(8, True),
                               lambda: tb.DecoderResidualBlock(8, True),
                               convert.stages_state, (2, 10, 8)),
    "decoder_residual_large": (lambda: jb.DecoderResidualBlock(8, False),
                               lambda: tb.DecoderResidualBlock(8, False),
                               convert.stages_state, (2, 10, 8)),
    "decoder_block": (lambda: jb.DecoderBlock(12),
                      lambda: tb.DecoderBlock(6, 12),
                      convert.decoder_block_state, (2, 10, 6)),
    "latent_injector": (lambda: jd._LatentInjector(4, 8, 10),
                        lambda: td._LatentInjector(4, 8, 10),
                        convert.latent_injector_state, (3, 4)),
    "condition_head": (lambda: jd._ConditionHead(8),
                       lambda: td._ConditionHead(16, 8),
                       convert.condition_head_state, (2, 10, 16)),
    "conv_block_small": (lambda: jb.ConvBlock(12, True),
                         lambda: tb.ConvBlock(20, 12, True),
                         convert.stages_state, (2, 10, 20)),
    "conv_block_large": (lambda: jb.ConvBlock(12, False),
                         lambda: tb.ConvBlock(20, 12, False),
                         convert.stages_state, (2, 10, 20)),
    "encoder_residual_small": (lambda: jb.EncoderResidualBlock(16, True),
                               lambda: tb.EncoderResidualBlock(16, True),
                               convert.stages_state, (2, 10, 16)),
    "encoder_residual_large": (lambda: jb.EncoderResidualBlock(16, False),
                               lambda: tb.EncoderResidualBlock(16, False),
                               convert.stages_state, (2, 10, 16)),
    "readout": (lambda: jb.FusedPointwiseNormTanh(300),
                lambda: tb.FusedPointwiseNormTanh(16, 300),
                convert.readout_state, (2, 6, 16)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_block_matches_jax(name):
    make_jax, make_port, state_fn, shape = CASES[name]
    x = np.random.default_rng(7).standard_normal(shape).astype(np.float32)
    jmod = make_jax()
    params = _perturbed_params(jmod, x, seed=len(name))
    want = np.asarray(jmod.apply({"params": params}, x))

    port = convert.load_state(make_port(), state_fn(params))
    got = port(torch.from_numpy(x)).detach().numpy()  # parameters are trainable
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)


SN_CASES = {
    # name: (JAX module, port module, state fn, sigma collection, input shape)
    "conv": (lambda: jb.Conv1d(6, 3), lambda: tb.Conv1d(5, 6, 3), convert.conv_state,
             lambda v: {"Conv_0": {"inv_sigma": v}}, (2, 7, 5)),
    "dense": (lambda: jb.Dense(6), lambda: tb.Dense(5, 6),
              lambda p: convert.linear_state(p["Dense_0"]),
              lambda v: {"Dense_0": {"inv_sigma": v}}, (3, 5)),
    # F <= nodes: the readout scales its input by inv_sigma
    "readout": (lambda: jb.FusedPointwiseNormTanh(300),
                lambda: tb.FusedPointwiseNormTanh(16, 300), convert.readout_state,
                lambda v: {"inv_sigma": v}, (2, 6, 16)),
}


@pytest.mark.parametrize("name", sorted(SN_CASES))
def test_spectral_norm_scaled_layer_matches_jax(name):
    """A layer given ``inv_sigma`` matches the JAX layer given the same value
    in its ``sn_sigma`` collection (output scaled before the bias)."""
    make_jax, make_port, state_fn, collection, shape = SN_CASES[name]
    x = np.random.default_rng(8).standard_normal(shape).astype(np.float32)
    jmod = make_jax()
    params = _perturbed_params(jmod, x, seed=len(name) + 1)
    inv = np.float32(0.37)
    want = np.asarray(jmod.apply({"params": params, "sn_sigma": collection(inv)}, x))
    port = convert.load_state(make_port(), state_fn(params))
    port.inv_sigma = torch.tensor(inv)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("k", [1, 3, 5])
def test_conv1d_same_matches_jax(k):
    rng = np.random.default_rng(k)
    x = rng.standard_normal((2, 9, 6)).astype(np.float32)
    w = rng.standard_normal((k, 6, 4)).astype(np.float32)  # HIO
    want = np.asarray(jb.conv1d_same(x, w))
    got = tb.conv1d_same(torch.from_numpy(x),
                         torch.from_numpy(np.ascontiguousarray(w.transpose(2, 1, 0))))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("c", [4, 20, 300, 95008])
def test_group_count_matches_jax(c):
    assert tb.group_count(c) == jb.group_count(c)
