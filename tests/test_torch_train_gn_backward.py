"""Port GroupNorm + activation backward (simulgen_vae_tpu_torch.ops.groupnorm_gelu)
vs the JAX kernels' gradients, which run here in Pallas interpret mode.

The plain versions of ``gn_bwd_onepass``, ``gn_bwd_stats`` and ``gn_bwd_apply``
and the ``GroupNormAct`` autograd function are held against ``jax.vjp`` of
``fused_group_norm_gelu`` (the one-pass ``custom_vjp``) and of
``tiled_group_norm_gelu`` (its tiles forced to 128 columns by monkeypatching
``VMEM_BLOCK_BYTES``, as tests/test_ops.py does), for gelu, tanh and none:
f32, atol and rtol 2e-4 (the two sum the group means in other orders). The
CUDA kernels run only on the card, where ``chip_smoke.py`` holds them against
these plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simulgen_vae_tpu.ops import groupnorm_gelu as jgg
from simulgen_vae_tpu_torch.ops import groupnorm_gelu as tgg

ACTS = ("gelu", "tanh", "none")
TOL = dict(atol=2e-4, rtol=2e-4)


def _case(b, t, c, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    scale = (1.0 + 0.3 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.3 * rng.standard_normal(c)).astype(np.float32)
    g = rng.standard_normal((b, t, c)).astype(np.float32)
    return x, scale, bias, g


def _jax_vjp(fn, x, scale, bias, g, groups, act):
    _, vjp = jax.vjp(lambda a, s, b_: fn(a, s, b_, groups, 1e-5, act),
                     jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    return [np.asarray(v) for v in vjp(jnp.asarray(g))]


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _assert_all(got, want):
    for name, a, b in zip(("dx", "dscale", "dbias"), got, want):
        np.testing.assert_allclose(a.numpy() if torch.is_tensor(a) else a, b,
                                   err_msg=name, **TOL)


@pytest.mark.parametrize("act", ACTS)
def test_onepass_backward_matches_jax_kernel(act):
    x, scale, bias, g = _case(2, 8, 24, seed=1)
    want = _jax_vjp(jgg.fused_group_norm_gelu, x, scale, bias, g, 3, act)
    tgg.reset_launch_counts()
    _assert_all(tgg.gn_bwd_onepass(*_t(x, scale, bias, g), 3, 1e-5, act), want)
    _assert_all(tgg.group_norm_act_backward_reference(*_t(x, scale, bias, g), 3,
                                                      1e-5, act), want)
    assert all(n == 0 for n in tgg.LAUNCHES.values())


@pytest.mark.parametrize("act", ACTS)
def test_two_phase_backward_matches_jax_tiled_kernel(monkeypatch, act):
    """C = 300 in 4 groups of 75: the JAX kernel's 128-wide tiles cross groups
    and its last tile is ragged."""
    monkeypatch.setattr(jgg, "VMEM_BLOCK_BYTES", 6 * 128 * 4)  # ct = 128
    x, scale, bias, g = _case(2, 6, 300, seed=2)
    want = _jax_vjp(jgg.tiled_group_norm_gelu, x, scale, bias, g, 4, act)
    xt, st, bt, gt = _t(x, scale, bias, g)
    stats = tgg.gn_stats(xt, 4)
    msums, dscale_p, dbias_p = tgg.gn_bwd_stats(xt, st, bt, gt, stats, 4, act)
    assert msums.shape == (2, 2, 4) and dscale_p.shape == dbias_p.shape == (2, 300)
    dx = tgg.gn_bwd_apply(xt, st, bt, gt, stats, msums, 4, act)
    _assert_all((dx, dscale_p.sum(0), dbias_p.sum(0)), want)


ROUTES = {
    "onepass": dict(),
    "onepass_fwd_tiled_bwd": dict(onepass_bwd_fits=lambda *a: False),
    "tiled": dict(onepass_fits=lambda *a: False),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("act", ACTS)
def test_autograd_function_matches_jax(monkeypatch, route, act):
    """Gradients through ``group_norm_act`` (the model's entry) on each route
    against the JAX one-pass kernel's custom_vjp."""
    for name, fn in ROUTES[route].items():
        monkeypatch.setattr(tgg, name, fn)
    x, scale, bias, g = _case(2, 6, 300, seed=3)
    want = _jax_vjp(jgg.fused_group_norm_gelu, x, scale, bias, g, 6, act)
    xt, st, bt = (v.requires_grad_() for v in _t(x, scale, bias))
    out = tgg.group_norm_act(xt, st, bt, 6, 1e-5, act)
    out.backward(torch.from_numpy(g))
    _assert_all((xt.grad, st.grad, bt.grad), want)


def test_flagship_group_width_backward():
    """2969-wide groups (the flagship's 11876 = 4 x 2969), C not a multiple of
    128: the two-phase plain backward against the plain one-pass one."""
    x, scale, bias, g = _case(1, 4, 2969 * 4, seed=4)
    xt, st, bt, gt = _t(x, scale, bias, g)
    stats = tgg.group_stats_reference(xt, 4)
    msums, dscale_p, dbias_p = tgg.gn_bwd_stats_reference(xt, st, bt, gt, stats, 4,
                                                          "tanh")
    dx = tgg.gn_bwd_apply_reference(xt, st, bt, gt, stats, msums, 4, "tanh")
    want = tgg.group_norm_act_backward_reference(xt, st, bt, gt, 4, 1e-5, "tanh")
    _assert_all((dx, dscale_p.sum(0), dbias_p.sum(0)), [w.numpy() for w in want])


def test_no_graph_without_grad():
    """Serving (no tensor requires grad, or inference mode) skips the autograd
    function and gives the same values."""
    x, scale, bias, _ = _case(2, 5, 40, seed=5)
    xt, st, bt = _t(x, scale, bias)
    plain = tgg.group_norm_act(xt, st, bt, 8)
    assert plain.grad_fn is None
    with torch.inference_mode():
        inf = tgg.group_norm_act(xt, st.clone().requires_grad_(), bt, 8)
    assert inf.grad_fn is None
    graph = tgg.group_norm_act(xt, st.clone().requires_grad_(), bt, 8)
    assert graph.grad_fn is not None
    np.testing.assert_array_equal(graph.detach().numpy(), plain.numpy())
    np.testing.assert_array_equal(inf.numpy(), plain.numpy())


@pytest.mark.parametrize("t,c,elem,fits", [
    (200, 128, 2, True), (200, 256, 2, True), (200, 284, 2, True),
    (200, 285, 2, False), (200, 512, 2, False),      # bf16: C <= 284 at T = 200
    (200, 128, 4, True), (200, 143, 4, True), (200, 144, 4, False),  # f32: C <= 143
])
def test_onepass_backward_engage_rule(t, c, elem, fits):
    assert tgg.onepass_bwd_fits(t, c, 1, elem) is fits
