"""Where the port's bf16 layers round, against the JAX layers.

JAX adds a layer's bias after rounding the product to the compute dtype
(``y + bias`` rounds a second time) and computes ``gelu`` as
``0.5 * x * erfc(-x * sqrt(0.5))`` rounded after each operation. The port's
bf16 ``Dense``, ``Conv1d`` (spectral norm off), ``gelu`` and ``DecoderBlock``
are held to at most 1% of outputs differing from JAX's (a fused bias or a
fused ``F.gelu`` puts 27-41% of them one bf16 ulp off), and so are the bf16
gradients of ``gelu`` and of a ``DecoderBlock``'s input against JAX's vjp.
Inputs from numpy seed 0; CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simulgen_vae_tpu.models import blocks as jb
from simulgen_vae_tpu_torch import convert
from simulgen_vae_tpu_torch.models import blocks as tb

MOST_DIFFERING = 0.01


def _share_differing(got: torch.Tensor, want) -> float:
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    return float((got != want).mean())


def _layer_case(k, bias_scale):
    """x [4, 12, 64] ~ N(0, 1); kernel ~ 0.1 N(0, 1) in the JAX layout
    (``[64, 300]`` dense when k is None, else ``[k, 64, 300]``); bias ~
    N(0, bias_scale)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 12, 64)).astype(np.float32)
    shape = (64, 300) if k is None else (k, 64, 300)
    kernel = (0.1 * rng.standard_normal(shape)).astype(np.float32)
    bias = (bias_scale * rng.standard_normal(300)).astype(np.float32)
    return x, kernel, bias


@pytest.mark.parametrize("bias_scale", [0.1, 1.0])
@pytest.mark.parametrize("k", [None, 1, 3, 5], ids=["dense", "k1", "k3", "k5"])
def test_bf16_layer_adds_its_bias_after_the_product_as_jax(k, bias_scale):
    x, kernel, bias = _layer_case(k, bias_scale)
    if k is None:
        tree = {"Dense_0": {"kernel": kernel, "bias": bias}}
        want = jb.Dense(300, dtype=jnp.bfloat16).apply({"params": tree}, x)
        port = convert.load_state(tb.Dense(64, 300), convert.linear_state(tree["Dense_0"]))
    else:
        tree = {"Conv_0": {"kernel": kernel, "bias": bias}}
        want = jb.Conv1d(300, k, dtype=jnp.bfloat16).apply({"params": tree}, x)
        port = convert.load_state(tb.Conv1d(64, 300, k), convert.conv_state(tree))
    tb.set_compute_dtype(port, torch.bfloat16)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    assert _share_differing(got, want) <= MOST_DIFFERING


def test_bf16_gelu_rounds_each_operation_as_jax():
    x = (3.0 * np.random.default_rng(0).standard_normal(100_000)).astype(np.float32)
    want = jax.nn.gelu(jnp.asarray(x, jnp.bfloat16), approximate=False)
    got = tb.gelu(torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    assert _share_differing(got, want) <= MOST_DIFFERING


def test_bf16_decoder_block_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 12, 64)).astype(np.float32)
    tree = {"Conv1d_0": {"Conv_0": {
        "kernel": (0.1 * rng.standard_normal((3, 64, 300))).astype(np.float32),
        "bias": (0.1 * rng.standard_normal(300)).astype(np.float32)}}}
    want = jb.DecoderBlock(300, dtype=jnp.bfloat16).apply({"params": tree}, x)
    port = convert.load_state(tb.DecoderBlock(64, 300), convert.decoder_block_state(tree))
    tb.set_compute_dtype(port, torch.bfloat16)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert _share_differing(got, want) <= MOST_DIFFERING


def test_f32_gelu_keeps_the_fused_form_and_its_gradient_matches_jax():
    x = np.linspace(-6.0, 6.0, 2001, dtype=np.float32)
    want = np.asarray(jax.vmap(jax.grad(lambda v: jax.nn.gelu(v, approximate=False)))(
        jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    out = tb.gelu(xt)
    out.sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(out.detach().numpy(),
                                  torch.nn.functional.gelu(xt.detach()).numpy())


@pytest.mark.parametrize("cotangent", ["ones", "normal"])
def test_bf16_gelu_gradient_rounds_as_jax(cotangent):
    """The bf16 gelu's gradient against JAX's vjp in bf16 (with a cotangent
    of ones that is ``jax.vmap(jax.grad(gelu))``); autograd through the
    forward's three operations puts ~23% of them off."""
    rng = np.random.default_rng(0)
    x = (3.0 * rng.standard_normal(100_000)).astype(np.float32)
    ct = (np.ones_like(x) if cotangent == "ones"
          else rng.standard_normal(x.shape).astype(np.float32))
    xj = jnp.asarray(x, jnp.bfloat16)
    _, vjp = jax.vjp(lambda v: jax.nn.gelu(v, approximate=False), xj)
    want = vjp(jnp.asarray(ct, jnp.bfloat16))[0]
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    tb.gelu(xt).backward(torch.from_numpy(ct).to(torch.bfloat16))
    assert xt.grad.dtype == torch.bfloat16
    assert _share_differing(xt.grad, want) <= MOST_DIFFERING


def test_bf16_decoder_block_input_gradient_matches_jax():
    """A bf16 DecoderBlock's input gradient against JAX's vjp (44% differ
    when autograd differentiates the rounded gelu)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 12, 64)).astype(np.float32)
    tree = {"Conv1d_0": {"Conv_0": {
        "kernel": (0.1 * rng.standard_normal((3, 64, 300))).astype(np.float32),
        "bias": (0.1 * rng.standard_normal(300)).astype(np.float32)}}}
    ct = rng.standard_normal((4, 12, 300)).astype(np.float32)
    block = jb.DecoderBlock(300, dtype=jnp.bfloat16)
    _, vjp = jax.vjp(lambda v: block.apply({"params": tree}, v),
                     jnp.asarray(x, jnp.bfloat16))
    want = vjp(jnp.asarray(ct, jnp.bfloat16))[0]
    port = convert.load_state(tb.DecoderBlock(64, 300), convert.decoder_block_state(tree))
    tb.set_compute_dtype(port, torch.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    port(xt).backward(torch.from_numpy(ct).to(torch.bfloat16))
    assert _share_differing(xt.grad, want) <= MOST_DIFFERING
