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


@pytest.mark.parametrize("act", ACTS)
def test_autograd_function_matches_jax_bf16_c512_onepass(act):
    """The train step's bf16 C = 512 maps: both routes one-pass at T = 200.
    bf16 x and g; dx in bf16 within one ulp (rtol 2^-7) of JAX's, the f32
    dscale and dbias (sums over B x T) within 1e-3 (PERF.md's bf16 tolerance
    for such sums)."""
    b, t, c, groups = 2, 200, 512, 8
    assert tgg.bwd_onepass_engages(t, c, groups, 2)
    x, scale, bias, g = _case(b, t, c, seed=6)
    x16, g16 = (jnp.asarray(v, jnp.bfloat16) for v in (x, g))
    _, vjp = jax.vjp(lambda a, s, b_: jgg.fused_group_norm_gelu(a, s, b_, groups, 1e-5, act),
                     x16, jnp.asarray(scale), jnp.asarray(bias))
    want = [np.asarray(jnp.asarray(v, jnp.float32)) for v in vjp(g16)]
    xt = torch.from_numpy(np.array(x16.astype(jnp.float32))).to(torch.bfloat16)
    xt.requires_grad_()
    st, bt = (v.requires_grad_() for v in _t(scale, bias))
    tgg.reset_launch_counts()
    out = tgg.group_norm_act(xt, st, bt, groups, 1e-5, act)
    out.backward(torch.from_numpy(np.array(g16.astype(jnp.float32))).to(torch.bfloat16))
    assert xt.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(xt.grad.float().numpy(), want[0], rtol=2 ** -7, atol=1e-6)
    np.testing.assert_allclose(st.grad.numpy(), want[1], rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(bt.grad.numpy(), want[2], rtol=1e-3, atol=1e-3)


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
    (200, 285, 2, True), (200, 512, 2, True),        # bf16: C <= 1840 at T = 200
    (200, 1840, 2, True), (200, 1841, 2, False),
    (200, 128, 4, True), (200, 143, 4, True), (200, 144, 4, True),  # f32: C <= 1018
    (200, 1018, 4, True), (200, 1019, 4, False),
    (1, 7129, 4, True), (1, 7130, 4, False),          # T = 1: one row in rank 0
    (1, 8149, 2, True), (1, 8150, 2, False),
])
def test_onepass_backward_engage_rule(t, c, elem, fits):
    """A cluster rank stages ceil(T / 8) rows of x and of g: 25 at T = 200."""
    assert tgg.onepass_bwd_fits(t, c, 1, elem) is fits


@pytest.mark.parametrize("t,c,groups,elem", [(200, 1824, 16, 2), (200, 1008, 16, 4),
                                             (1, 7056, 16, 4), (1, 8064, 16, 2)])
def test_onepass_backward_rule_counts_what_a_rank_allocates(t, c, groups, elem):
    """At the rule's edge a rank's head (four column vectors, the 8 ranks'
    two sets of group partials and their sums over the rank's ceil(C / 8)
    columns, two group vectors, two floats for each of 512 threads) and its
    rows of x and g fill the block's shared memory; 16 columns more do not
    fit."""
    k = tgg.ONEPASS_CLUSTER
    rows = -(-t // k)
    head = (4 * c + 4 * k * groups + 2 * k * -(-c // k) + 2 * groups + 2 * 512) * 4
    need = (-(-head // 16) * 16
            + -(-rows * c * elem // 16) * 16 + rows * c * elem)
    assert tgg.onepass_bwd_smem_bytes(t, c, groups, elem) == need
    assert tgg.onepass_bwd_fits(t, c, groups, elem)
    assert not tgg.onepass_bwd_fits(t, c + groups, groups, elem)


@pytest.mark.parametrize("elem, widths", [(2, (128, 256, 512)), (4, (128, 256))])
def test_every_onepass_forward_width_takes_the_onepass_backward(elem, widths):
    """At T = 200 every map the one-pass forward takes (the train step's
    C = 128, 256 and, in bf16, 512) has a one-pass backward: no map
    recomputes its statistics with gn_stats."""
    for c in widths:
        assert tgg.onepass_fits(200, c, 8, elem)
        assert tgg.bwd_onepass_engages(200, c, 8, elem)
    c = 8
    while tgg.onepass_fits(200, c, 8, elem):
        assert tgg.bwd_onepass_engages(200, c, 8, elem)
        c += 8
    assert c > widths[-1]
