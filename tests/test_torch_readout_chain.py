"""The port's fused readout chain against the JAX package's, on the CPU in f32.

The same inputs, made from a numpy seed, go through
``simulgen_vae_tpu.ops.readout_chain`` (its Pallas kernels in interpret mode,
which it selects off a TPU) and through ``simulgen_vae_tpu_torch.ops.readout_chain``
(the plain versions, which the wrappers take for CPU tensors). The port keeps
the readout kernel as ``[C, F]``; JAX's is ``[F, C]``. Tolerances are the JAX
package's own for this op: the loss pair rtol 1e-5, gradients rtol 5e-4 with
atol 1e-6 (sums over T x C in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simulgen_vae_tpu.ops import readout_chain as jrc
from simulgen_vae_tpu_torch.ops import _build
from simulgen_vae_tpu_torch.ops import readout_chain as trc

LOSSES = ["MSE", "MAE", "Huber", "smoothL1"]
# (b, t, f, c, groups): 75-wide groups; ragged 50-wide groups that no
# 128-column tile holds whole; a width above 128 that is no multiple of 128.
SHAPES = {"c300_g4": (2, 6, 16, 300, 4), "c300_g6": (3, 5, 8, 300, 6),
          "c200_g8": (2, 7, 16, 200, 8)}


def _case(shape, seed=0):
    b, t, f, c, g = SHAPES[shape]
    rng = np.random.default_rng(seed)
    f32 = lambda a: a.astype(np.float32)  # noqa: E731
    return dict(
        h=f32(rng.standard_normal((b, t, f)) * 0.3),
        kernel=f32(rng.standard_normal((f, c)) * 0.1),      # JAX layout [F, C]
        bias=f32(rng.standard_normal(c) * 0.1),
        scale=f32(1.0 + 0.1 * rng.standard_normal(c)),
        norm_bias=f32(rng.standard_normal(c) * 0.1),
        x=f32(rng.standard_normal((b, t, c)) * 0.5),
        inv=np.float32(0.8), groups=g)


def _torch_args(case, requires_grad=False):
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in case.items()
         if k not in ("groups", "inv", "kernel")}
    t["kernel"] = torch.from_numpy(np.ascontiguousarray(case["kernel"].T))  # [C, F]
    t["inv"] = torch.tensor(float(case["inv"]))
    if requires_grad:
        for k in ("h", "kernel", "bias", "scale", "norm_bias", "inv"):
            t[k].requires_grad_()
    return t


def _jax_args(case):
    return tuple(jnp.asarray(case[k]) for k in
                 ("h", "kernel", "bias", "scale", "norm_bias", "x", "inv"))


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("lossfun", LOSSES)
def test_forward_matches_jax(lossfun, shape):
    case = _case(shape)
    want = jrc.readout_chain_loss(*_jax_args(case), case["groups"], 1e-5, lossfun)
    t = _torch_args(case)
    trc.reset_launch_counts()
    got = trc.readout_chain_loss(t["h"], t["kernel"], t["bias"], t["scale"],
                                 t["norm_bias"], t["x"], t["inv"], case["groups"],
                                 1e-5, lossfun)
    assert all(n == 0 for n in trc.LAUNCHES.values())  # plain versions on the CPU
    for a, b_ in zip(got, want):
        assert a.dtype == torch.float32 and a.dim() == 0
        np.testing.assert_allclose(float(a), float(b_), rtol=1e-5)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_y_and_stats_match_forward_parts(shape):
    case = _case(shape, seed=2)
    g = case["groups"]
    _, _, y, stats = jrc._forward_parts(*_jax_args(case), g, 1e-5, "MSE")
    t = _torch_args(case)
    got_y, got_stats = trc.readout_matmul_stats(t["h"], t["kernel"], t["bias"], t["inv"], g)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(y), atol=1e-6, rtol=1e-5)
    assert tuple(got_stats.shape) == (case["h"].shape[0], 2, g)
    np.testing.assert_allclose(got_stats.numpy(), np.asarray(stats)[:, :, :g],
                               atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("lossfun", ["MSE", "MAE", "Huber"])
def test_gradients_match_jax(lossfun, shape):
    case = _case(shape, seed=1)
    case["inv"] = np.float32(1.3)
    g = case["groups"]
    h, kernel, bias, scale, nb, x, inv = _jax_args(case)

    def loss(h_, k_, b_, s_, nb_, inv_):
        l, m = jrc.readout_chain_loss(h_, k_, b_, s_, nb_, x, inv_, g, 1e-5, lossfun)
        return l + 0.3 * m

    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4, 5))(h, kernel, bias, scale, nb, inv)
    t = _torch_args(case, requires_grad=True)
    l, m = trc.readout_chain_loss(t["h"], t["kernel"], t["bias"], t["scale"],
                                  t["norm_bias"], t["x"], t["inv"], g, 1e-5, lossfun)
    (l + 0.3 * m).backward()
    got = [t["h"].grad, t["kernel"].grad.t(), t["bias"].grad, t["scale"].grad,
           t["norm_bias"].grad, t["inv"].grad]
    assert t["x"].grad is None
    for name, a, b_ in zip(["dh", "dW", "dbias", "dscale", "dnorm_bias", "dinv_sigma"],
                           got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b_), rtol=5e-4, atol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("lossfun", LOSSES)
def test_op_matches_unfused_composition_under_autograd(lossfun):
    """Values and gradients of the op (analytic backward, four plain
    per-kernel functions) against autograd through the plain composition."""
    case = _case("c300_g6", seed=3)
    g = case["groups"]
    names = ("h", "kernel", "bias", "scale", "norm_bias", "inv")
    out = {}
    for which, fn in (("op", trc.readout_chain_loss),
                      ("ref", trc.readout_chain_loss_reference)):
        t = _torch_args(case, requires_grad=True)
        l, m = fn(t["h"], t["kernel"], t["bias"], t["scale"], t["norm_bias"], t["x"],
                  t["inv"], g, 1e-5, lossfun)
        (2.0 * l + 0.3 * m).backward()
        out[which] = (float(l.detach()), float(m.detach()), [t[k].grad for k in names])
    np.testing.assert_allclose(out["op"][:2], out["ref"][:2], rtol=1e-5)
    for name, a, b_ in zip(names, out["op"][2], out["ref"][2]):
        np.testing.assert_allclose(a.numpy(), b_.numpy(), rtol=5e-4, atol=1e-6,
                                   err_msg=name)


def test_plain_kernel_functions_compose_to_the_op():
    """Each plain per-kernel function has the wrapper's inputs and outputs:
    chained by hand they give the op's loss pair and gradients."""
    case = _case("c200_g8", seed=4)
    g = case["groups"]
    t = _torch_args(case)
    b, tt, f = t["h"].shape
    c = t["kernel"].shape[0]
    n_elem = float(b * tt * c)
    y, stats = trc.matmul_stats_reference(t["h"], t["kernel"], t["bias"], t["inv"], g)
    sums = trc.loss_reference(y, t["x"], t["scale"], t["norm_bias"], stats, g, "Huber")
    gvec = torch.tensor([2.0, 0.3, float(t["inv"])])
    msums, dscale_p, dnb_p = trc.bwd_stats_reference(
        y, t["x"], t["scale"], t["norm_bias"], stats, gvec, n_elem, g, "Huber")
    dy, dbias_p, dinv_p = trc.bwd_dy_reference(
        y, t["x"], t["scale"], t["norm_bias"], t["bias"], stats, msums, gvec, n_elem, g,
        "Huber")
    assert tuple(msums.shape) == (b, 2, g) and tuple(dscale_p.shape) == (b, c)
    assert tuple(dy.shape) == (b, tt, c) and tuple(dinv_p.shape) == (b,)

    r = _torch_args(case, requires_grad=True)
    l, m = trc.readout_chain_loss(r["h"], r["kernel"], r["bias"], r["scale"],
                                  r["norm_bias"], r["x"], r["inv"], g, 1e-5, "Huber")
    (2.0 * l + 0.3 * m).backward()
    np.testing.assert_allclose((sums / n_elem).numpy(), [float(l.detach()), float(m.detach())], rtol=1e-6)
    np.testing.assert_allclose(dscale_p.sum(0).numpy(), r["scale"].grad.numpy(), rtol=1e-6)
    np.testing.assert_allclose(dnb_p.sum(0).numpy(), r["norm_bias"].grad.numpy(), rtol=1e-6)
    np.testing.assert_allclose(dbias_p.sum(0).numpy(), r["bias"].grad.numpy(), rtol=1e-6,
                               atol=1e-12)
    np.testing.assert_allclose(float(dinv_p.sum()), float(r["inv"].grad), rtol=1e-6)
    dw = (dy.reshape(-1, c).t() @ t["h"].reshape(-1, f)) * t["inv"]
    np.testing.assert_allclose(dw.numpy(), r["kernel"].grad.numpy(), rtol=1e-6, atol=1e-12)


def test_statistics_are_those_of_the_rounded_y():
    """In bf16 the statistics come from the stored (rounded) y, so they equal
    a separate GroupNorm statistics pass over the stored map."""
    from simulgen_vae_tpu_torch.ops.groupnorm_gelu import group_stats_reference

    case = _case("c300_g6", seed=5)
    t = _torch_args(case)
    y, stats = trc.matmul_stats_reference(t["h"].bfloat16(), t["kernel"].bfloat16(),
                                          t["bias"], t["inv"], 6)
    assert y.dtype == torch.bfloat16
    want = group_stats_reference(y, 6)
    np.testing.assert_allclose(stats.numpy(), want.numpy(), rtol=2e-4, atol=1e-6)


def test_elem_loss_grad_is_the_derivative():
    o = torch.linspace(-2.0, 2.0, 41, dtype=torch.float64).requires_grad_()
    x = torch.full_like(o, 0.13).detach()
    for lossfun in LOSSES:
        (g,) = torch.autograd.grad(trc.elem_loss(o, x, lossfun).sum(), o)
        np.testing.assert_allclose(trc.elem_loss_grad(o, x, lossfun).detach().numpy(),
                                   g.numpy(), atol=1e-12, err_msg=lossfun)
    with pytest.raises(ValueError, match="unsupported fused lossfun"):
        trc.elem_loss(o, x, "L3")


def test_only_the_materializing_backward_is_offered():
    """``bwd_flavor`` answers with one of the two backward flavors. At the
    flagship geometry the rule written from the card's measurements offers
    only the materializing backward (the dy-free kernel's two passes, each
    recomputing dy and reading y and x, lose there); where the measurement
    put the dy-free backward ahead it answers "fused"."""
    assert trc.bwd_flavor(16, 200, 1024, 95008) == "materialize"
    answers = {trc.bwd_flavor(*geom) for geom in (
        (16, 200, 1024, 95008), (16, 200, 128, 95008), (4, 200, 128, 5120),
        (16, 200, 128, 5120), (2, 37, 64, 300), (3, 50, 64, 1100), (3, 5, 16, 1100))}
    assert answers <= set(trc.BWD_FLAVORS) and "fused" in answers


def test_other_devices_raise_and_nothing_falls_back(monkeypatch):
    """A tensor that is neither on the CPU nor on a card raises; a kernel
    that cannot be built raises out of the op (no plain version stands in)."""
    t = _torch_args(_case("c300_g4"))
    meta = {k: v.to("meta") for k, v in t.items()}
    with pytest.raises(ValueError, match="no readout kernel"):
        trc.readout_chain_loss(meta["h"], meta["kernel"], meta["bias"], meta["scale"],
                               meta["norm_bias"], meta["x"], meta["inv"], 4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        trc.readout_matmul_stats(meta["h"], meta["kernel"], meta["bias"], meta["inv"], 4)
    stats = torch.empty((2, 2, 4), device="meta")
    for call in (
        lambda: trc.readout_loss(meta["x"], meta["x"], meta["scale"], meta["norm_bias"],
                                 stats, 4),
        lambda: trc.readout_bwd_stats(meta["x"], meta["x"], meta["scale"],
                                      meta["norm_bias"], stats, meta["bias"], 1.0, 4),
        lambda: trc.readout_bwd_dy(meta["x"], meta["x"], meta["scale"], meta["norm_bias"],
                                   meta["bias"], stats, stats, meta["bias"], 1.0, 4),
    ):
        with pytest.raises(ValueError, match="CUDA tensor"):
            call()
    assert all(n == 0 for n in trc.LAUNCHES.values())


def test_cuda_request_without_a_compiler_raises(tmp_path, monkeypatch):
    """On a CUDA tensor the wrapper goes to its kernel's build; with no nvcc
    that raises instead of falling back."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("readout_loss")


def test_build_list_holds_the_four_kernels():
    for name in ("readout_matmul_stats", "readout_loss", "readout_bwd_stats",
                 "readout_bwd_dy"):
        assert name in _build.KERNELS
        assert (_build.CSRC / f"{name}.cu").exists()
        assert name in trc.LAUNCHES
    assert len(_build.KERNELS) == 13
    src = (_build.CSRC / "readout_common.cuh").read_bytes()
    assert src and _build.library_path("readout_loss").name.startswith("readout_loss-")


@pytest.mark.parametrize("bias_scale", [0.1, 1.0])
def test_bf16_direct_readout_bias_rounding_against_jax(bias_scale):
    """The DIRECT (unfused) readout in bf16 adds the f32 bias before the one
    rounding, as the JAX module does: the port carries the bias inside the
    product's f32 accumulation as two bf16 columns (16 of its 24 mantissa
    bits). Same inputs through both: at most 1% of the tanh outputs differ
    from JAX's, none by more than one bf16 ulp of tanh's range (2^-8).
    Rounding the bias to bf16 first, as the port did before, leaves 10.9%
    (bias ~ 0.1) and 23.2% (bias ~ 1) of the outputs one ulp off; f32 is
    exact either way."""
    from simulgen_vae_tpu.models.blocks import FusedPointwiseNormTanh as JaxReadout
    from simulgen_vae_tpu_torch.models.blocks import FusedPointwiseNormTanh
    from simulgen_vae_tpu_torch.ops.groupnorm_gelu import group_norm_act_reference

    b, t, f, c = 4, 12, 16, 300
    rng = np.random.default_rng(0)
    f32 = lambda a: a.astype(np.float32)  # noqa: E731
    h = f32(rng.standard_normal((b, t, f)) * 0.5)
    params = dict(kernel=f32(rng.standard_normal((f, c)) / 4),
                  bias=f32(rng.standard_normal(c) * bias_scale),
                  scale=f32(1 + 0.1 * rng.standard_normal(c)),
                  norm_bias=f32(0.1 * rng.standard_normal(c)))
    jparams = {"params": {k: jnp.asarray(v) for k, v in params.items()}}
    want = np.asarray(JaxReadout(c, dtype=jnp.bfloat16).apply(
        jparams, jnp.asarray(h).astype(jnp.bfloat16)).astype(jnp.float32))
    want32 = np.asarray(JaxReadout(c).apply(jparams, jnp.asarray(h)))

    mod, mod32 = FusedPointwiseNormTanh(f, c, dtype=torch.bfloat16), FusedPointwiseNormTanh(f, c)
    with torch.no_grad():
        for m in (mod, mod32):
            m.kernel.copy_(torch.from_numpy(params["kernel"].T.copy()))
            for k in ("bias", "scale", "norm_bias"):
                getattr(m, k).copy_(torch.from_numpy(params[k]))
        hb = torch.from_numpy(h).bfloat16()
        got = mod(hb).float().numpy()
        y = torch.nn.functional.linear(hb, mod.kernel.bfloat16(), mod.bias.bfloat16())
        rounded_first = group_norm_act_reference(y, mod.scale, mod.norm_bias, mod.num_groups,
                                                 1e-5, "tanh").float().numpy()
        got32 = mod32(torch.from_numpy(h)).numpy()
    port_frac, old_frac = (got != want).mean(), (rounded_first != want).mean()
    print(f"bias ~ {bias_scale}: differing {port_frac:.5f}, max abs "
          f"{np.abs(got - want).max():.3g}; with the bias rounded first {old_frac:.4f}")
    assert np.abs(got - want).max() <= 2.0 ** -8
    assert port_frac <= 0.01 < old_frac
    np.testing.assert_allclose(got32, want32, atol=1e-6)


def test_bf16_direct_readout_output_side_sigma_rounds_once_against_jax():
    """With spectral norm and F > nodes the DIRECT readout scales its output
    by inv_sigma: the JAX module takes the product in f32, multiplies by
    inv_sigma, adds the f32 bias and rounds once. The port does the same
    (an f32 product of the rounded operands). Same inputs through both, bf16:
    at most 1% of the tanh outputs differ from JAX's, none by more than one
    bf16 ulp of tanh's range (2^-8). Rounding the product to bf16 before the
    scale, as the port did before, leaves more of them off; f32 agrees."""
    from simulgen_vae_tpu.models.blocks import FusedPointwiseNormTanh as JaxReadout
    from simulgen_vae_tpu_torch.models.blocks import FusedPointwiseNormTanh
    from simulgen_vae_tpu_torch.ops.groupnorm_gelu import group_norm_act_reference

    b, t, f, c = 4, 12, 300, 16
    rng = np.random.default_rng(0)
    f32 = lambda a: a.astype(np.float32)  # noqa: E731
    h = f32(rng.standard_normal((b, t, f)) * 0.5)
    params = dict(kernel=f32(rng.standard_normal((f, c)) / 4),
                  bias=f32(rng.standard_normal(c) * 0.1),
                  scale=f32(1 + 0.1 * rng.standard_normal(c)),
                  norm_bias=f32(0.1 * rng.standard_normal(c)))
    inv = np.float32(0.37)
    jvars = {"params": {k: jnp.asarray(v) for k, v in params.items()},
             "sn_sigma": {"inv_sigma": jnp.asarray(inv)}}
    want = np.asarray(JaxReadout(c, dtype=jnp.bfloat16).apply(
        jvars, jnp.asarray(h).astype(jnp.bfloat16)).astype(jnp.float32))
    want32 = np.asarray(JaxReadout(c).apply(jvars, jnp.asarray(h)))

    mod, mod32 = FusedPointwiseNormTanh(f, c, dtype=torch.bfloat16), FusedPointwiseNormTanh(f, c)
    with torch.no_grad():
        for m in (mod, mod32):
            m.kernel.copy_(torch.from_numpy(params["kernel"].T.copy()))
            for k in ("bias", "scale", "norm_bias"):
                getattr(m, k).copy_(torch.from_numpy(params[k]))
            m.inv_sigma = torch.tensor(inv)
        hb = torch.from_numpy(h).bfloat16()
        got = mod(hb).float().numpy()
        y = (torch.nn.functional.linear(hb, mod.kernel.bfloat16()) * mod.inv_sigma.bfloat16()
             + mod.bias.bfloat16())
        rounded_twice = group_norm_act_reference(y, mod.scale, mod.norm_bias, mod.num_groups,
                                                 1e-5, "tanh").float().numpy()
        got32 = mod32(torch.from_numpy(h)).numpy()
    port_frac, old_frac = (got != want).mean(), (rounded_twice != want).mean()
    print(f"differing {port_frac:.5f}, max abs {np.abs(got - want).max():.3g}; "
          f"with the product rounded first {old_frac:.4f}")
    assert np.abs(got - want).max() <= 2.0 ** -8
    assert port_frac <= 0.01 < old_frac
    np.testing.assert_allclose(got32, want32, atol=1e-6)
