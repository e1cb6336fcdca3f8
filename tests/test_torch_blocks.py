"""Port encoder and decoder blocks vs the JAX blocks, weights carried over by convert.py.

Each JAX block is initialised from a key, its parameters are perturbed with
seeded numpy noise (so biases and norm affines are not at their 0/1 inits),
and the same tree goes through ``simulgen_vae_tpu_torch.convert``. f32,
atol 1e-5.
"""

import jax
import jax.numpy as jnp
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


# (k, dtype, input, weight): the input a contiguous [B, T, C] map or the
# latent injector's transposed view of a [B, C, T] one; the weight
# contiguous [F, C, k] or held in cuDNN's order (blocks.cudnn_order)
CONV_CASES = [
    pytest.param(1, "float32", "contiguous", "contiguous", id="1"),
    pytest.param(3, "float32", "contiguous", "contiguous", id="3"),
    pytest.param(5, "float32", "contiguous", "contiguous", id="5"),
    pytest.param(3, "bfloat16", "contiguous", "contiguous", id="3-bf16"),
    pytest.param(5, "bfloat16", "contiguous", "contiguous", id="5-bf16"),
    pytest.param(3, "float32", "transposed", "contiguous", id="3-transposed"),
    pytest.param(5, "bfloat16", "transposed", "contiguous", id="5-bf16-transposed"),
    pytest.param(3, "float32", "contiguous", "held", id="3-held"),
    pytest.param(5, "float32", "contiguous", "held", id="5-held"),
    pytest.param(3, "bfloat16", "contiguous", "held", id="3-bf16-held"),
    pytest.param(5, "bfloat16", "transposed", "held", id="5-bf16-transposed-held"),
]


def _bf16_close(got, want) -> None:
    """At most 1% of bf16 values differing in their bits (the rule of
    tests/test_torch_bf16_rounding.py)."""
    assert got.shape == want.shape
    assert float((got != want).mean()) <= 0.01


@pytest.mark.parametrize("k, dtype, layout, weight", CONV_CASES)
def test_conv1d_same_matches_jax(k, dtype, layout, weight):
    """Output and the input's and weight's gradients against JAX's
    ``conv1d_same`` and its vjp: f32 within atol 1e-5, bf16 as the rounding
    tests hold it. The output is a contiguous [B, T, F] map whatever the
    input's strides, and for k > 1 ``CONV_LAYOUT`` counts which operand had
    to be copied into cuDNN's order."""
    rng = np.random.default_rng(k)
    x = rng.standard_normal((2, 9, 6)).astype(np.float32)
    w = rng.standard_normal((k, 6, 4)).astype(np.float32)  # HIO
    ct = rng.standard_normal((2, 9, 4)).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want, vjp = jax.vjp(jb.conv1d_same, jnp.asarray(x, jdt), jnp.asarray(w, jdt))
    want_gx, want_gw = vjp(jnp.asarray(ct, jdt))

    if layout == "transposed":
        leaf = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1))).to(tdt)
        leaf.requires_grad_()
        xt = leaf.transpose(1, 2)
    else:
        leaf = xt = torch.from_numpy(x).to(tdt).requires_grad_()
    wt = torch.from_numpy(np.ascontiguousarray(w.transpose(2, 1, 0))).to(tdt)
    if weight == "held":
        wt = tb.cudnn_order(wt)
        assert wt.stride() == (k * 6, 1, 6)
    wt.requires_grad_()
    before = dict(tb.CONV_LAYOUT)
    got = tb.conv1d_same(xt, wt)
    counts = {name: tb.CONV_LAYOUT[name] - before[name] for name in before}
    got.backward(torch.from_numpy(ct).to(tdt))
    gx = leaf.grad.transpose(1, 2) if layout == "transposed" else leaf.grad

    assert got.dtype == tdt and got.shape == (2, 9, 4)
    assert got.is_contiguous() and got.stride() == (9 * 4, 4, 1)
    copies = {"conv.input_copied": int(layout == "transposed"),
              "conv.weight_copied": int(weight == "contiguous")}
    copies["conv.direct"] = int(not any(copies.values()))
    assert counts == (copies if k > 1 else {name: 0 for name in before})
    pairs = [(got, want), (gx, want_gx), (wt.grad, jnp.transpose(want_gw, (2, 1, 0)))]
    for have, ref in pairs:
        have = have.detach().float().numpy()
        ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
        if dtype == "float32":
            np.testing.assert_allclose(have, ref, atol=1e-5)
        else:
            _bf16_close(have, ref)


# how a Conv1d's weight reaches conv1d_same: held in cuDNN's order (served,
# frozen), f32 masters cast to bf16 on each call (trained), or f32 masters
# used as they are (f32 training); the expected CONV_LAYOUT counts of one
# forward of a four-filter decoder (17 k > 1 convolutions, 3 of them the
# latent injectors', whose input maps are transposed views)
DECODER_WEIGHTS = {
    "held": (torch.float32, True, {"conv.direct": 14, "conv.input_copied": 3,
                                   "conv.weight_copied": 0}),
    "cast_bf16": (torch.bfloat16, False, {"conv.direct": 14, "conv.input_copied": 3,
                                          "conv.weight_copied": 0}),
    "f32_masters": (torch.float32, False, {"conv.direct": 0, "conv.input_copied": 3,
                                           "conv.weight_copied": 17}),
}


@pytest.mark.parametrize("name", sorted(DECODER_WEIGHTS))
def test_decoder_convolutions_reach_cudnn_in_its_layout(name):
    compute, hold, expected = DECODER_WEIGHTS[name]
    torch.manual_seed(0)
    dec = td.Decoder(4, 2, [4, 8, 16, 32], 30, 6)
    tb.set_compute_dtype(dec, compute)
    if hold:
        tb.hold_conv_weights(dec)
        for m in dec.modules():
            if isinstance(m, tb.Conv1d):
                k, c = m.weight.shape[2], m.weight.shape[1]
                assert m.weight.stride() == ((k * c, 1, c) if k > 1 else (c, 1, 1))
    z = torch.randn(3, 4).to(compute)
    xs = [torch.randn(3, 2).to(compute) for _ in range(2)]
    before = dict(tb.CONV_LAYOUT)
    with torch.no_grad():
        out, _, _ = dec(z, xs, mode="fix", generator=torch.Generator().manual_seed(1))
    assert out.shape == (3, 6, 30)
    assert {k: tb.CONV_LAYOUT[k] - before[k] for k in before} == expected


@pytest.mark.parametrize("c", [4, 20, 300, 95008])
def test_group_count_matches_jax(c):
    assert tb.group_count(c) == jb.group_count(c)
