"""The dy-free readout backward (``readout_bwd_fused``) on the CPU.

The port's plain version ``bwd_fused_reference`` (what ``readout_bwd_fused``
takes for CPU tensors) against the JAX op's gradients with the JAX package's
fused backward forced (``SIMULGEN_READOUT_BWD=fused``, its Pallas kernel
``_bwd_fused_dw_kernel`` in interpret mode) at a geometry where the JAX rule
engages; the port's two backward flavors against each other; the ``bwd``
argument; the engage rule. Inputs come from numpy seeds. The port keeps the
readout kernel as ``[C, F]``; JAX's is ``[F, C]``.
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
JAX_GEOM = (3, 5, 16, 1100)          # the JAX rule engages its fused backward here
FLAVOR_GEOMS = [(3, 5, 16, 1100, 4), (2, 37, 64, 300, 6), (4, 12, 128, 640, 8)]


def _case(b, t, f, c, seed=0, inv=0.8):
    rng = np.random.default_rng(seed)
    f32 = lambda a: a.astype(np.float32)  # noqa: E731
    return dict(
        h=f32(rng.standard_normal((b, t, f)) * 0.3),
        kernel=f32(rng.standard_normal((f, c)) * 0.1),      # JAX layout [F, C]
        bias=f32(rng.standard_normal(c) * 0.1),
        scale=f32(1.0 + 0.1 * rng.standard_normal(c)),
        norm_bias=f32(rng.standard_normal(c) * 0.1),
        x=f32(rng.standard_normal((b, t, c)) * 0.5),
        inv=np.float32(inv))


def _torch_args(case, dtype=torch.float32):
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in case.items()
         if k not in ("inv", "kernel")}
    t["kernel"] = torch.from_numpy(np.ascontiguousarray(case["kernel"].T))  # [C, F]
    t["inv"] = torch.tensor(float(case["inv"]))
    t["h"], t["x"] = t["h"].to(dtype), t["x"].to(dtype)
    for k in ("h", "kernel", "bias", "scale", "norm_bias", "inv"):
        t[k].requires_grad_()
    return t


def _torch_grads(case, groups, lossfun, bwd, dtype=torch.float32):
    t = _torch_args(case, dtype)
    l, m = trc.readout_chain_loss(t["h"], t["kernel"], t["bias"], t["scale"], t["norm_bias"],
                                  t["x"], t["inv"], groups, 1e-5, lossfun, bwd=bwd)
    (l + 0.3 * m).backward()
    return [t["h"].grad.float(), t["kernel"].grad.t(), t["bias"].grad, t["scale"].grad,
            t["norm_bias"].grad, t["inv"].grad]


NAMES = ["dh", "dW", "dbias", "dscale", "dnorm_bias", "dinv_sigma"]


@pytest.mark.parametrize("inv", [1.0, 1.3])
@pytest.mark.parametrize("lossfun", LOSSES)
def test_fused_backward_matches_jax_fused_backward(monkeypatch, lossfun, inv):
    """f32, rtol 5e-4 with atol 1e-6 (the JAX package's own bound for this op:
    sums over T x C in another order)."""
    monkeypatch.setenv("SIMULGEN_READOUT_BWD", "fused")
    b, t, f, c = JAX_GEOM
    assert jrc.bwd_flavor(b, t, f, c) == "fused"
    case = _case(b, t, f, c, seed=1, inv=inv)
    h, kernel, bias, scale, nb, x, inv_ = (jnp.asarray(case[k]) for k in
                                           ("h", "kernel", "bias", "scale", "norm_bias",
                                            "x", "inv"))

    def loss(h_, k_, b_, s_, nb_, i_):
        l, m = jrc.readout_chain_loss(h_, k_, b_, s_, nb_, x, i_, 4, 1e-5, lossfun)
        return l + 0.3 * m

    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4, 5))(h, kernel, bias, scale, nb, inv_)
    got = _torch_grads(case, 4, lossfun, "fused")
    for name, a, b_ in zip(NAMES, got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b_), rtol=5e-4, atol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("geom", FLAVOR_GEOMS, ids=lambda g: "x".join(map(str, g)))
def test_backward_flavors_agree_f32(geom):
    """rtol 2e-3 (JAX's own bound between its two flavors) with atol 1e-6."""
    b, t, f, c, g = geom
    case = _case(b, t, f, c, seed=2, inv=1.2)
    fused = _torch_grads(case, g, "Huber", "fused")
    mat = _torch_grads(case, g, "Huber", "materialize")
    for name, a, b_ in zip(NAMES, fused, mat):
        np.testing.assert_allclose(a.numpy(), b_.numpy(), rtol=2e-3, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("geom", FLAVOR_GEOMS, ids=lambda g: "x".join(map(str, g)))
def test_backward_flavors_agree_bf16(geom):
    """bf16 maps: the fused flavor rounds dy once and keeps f32 dW and dh, the
    materializing one also rounds the products' outputs: rel-L2 2e-2."""
    b, t, f, c, g = geom
    case = _case(b, t, f, c, seed=3, inv=0.9)
    fused = _torch_grads(case, g, "MSE", "fused", torch.bfloat16)
    mat = _torch_grads(case, g, "MSE", "materialize", torch.bfloat16)
    for name, a, b_ in zip(NAMES, fused, mat):
        rel = float(torch.linalg.vector_norm(a - b_) / torch.linalg.vector_norm(b_))
        assert rel <= 2e-2, f"{name}: rel-L2 {rel:.3g}"


def test_plain_version_rounds_dy_before_the_products_only():
    """dW and dh use dy rounded to the map's dtype; dbias and dinv the f32 dy."""
    b, t, f, c, g = 2, 6, 16, 200, 8
    case = _case(b, t, f, c, seed=4)
    a = _torch_args(case, torch.bfloat16)
    with torch.no_grad():
        w = a["kernel"].bfloat16()
        y, stats = trc.matmul_stats_reference(a["h"], w, a["bias"], a["inv"], g)
        gvec = torch.tensor([1.0, 0.3, float(a["inv"])])
        n_elem = float(b * t * c)
        chain = (a["x"], a["scale"], a["norm_bias"])
        msums = trc.bwd_stats_reference(y, *chain, stats, gvec, n_elem, g)[0]
        dw, dh, dbias, dinv = trc.bwd_fused_reference(y, *chain, a["bias"], a["h"], w, stats,
                                                      msums, gvec, n_elem, g)
        dy, dbias_p, dinv_p = trc.bwd_dy_reference(y, *chain, a["bias"], stats, msums, gvec,
                                                   n_elem, g)
    assert dw.dtype == dh.dtype == dbias.dtype == dinv.dtype == torch.float32
    assert tuple(dw.shape) == (c, f) and tuple(dh.shape) == (b, t, f) and dinv.dim() == 0
    dy2 = dy.float().reshape(b * t, c)                       # the rounded dy
    np.testing.assert_allclose(dw.numpy(), (dy2.t() @ a["h"].detach().float().reshape(-1, f)).numpy(),
                               rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(dh.reshape(-1, f).numpy(), (dy2 @ w.float()).numpy(),
                               rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(dbias.numpy(), dbias_p.sum(0).numpy(), rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(float(dinv), float(dinv_p.sum()), rtol=1e-4)


@pytest.mark.parametrize("bwd, fused_calls, dy_calls",
                         [("fused", 1, 0), ("materialize", 0, 1)])
def test_bwd_argument_selects_the_flavor(monkeypatch, bwd, fused_calls, dy_calls):
    """On the CPU the wrappers take their plain versions: count those calls."""
    calls = {"fused": 0, "dy": 0}
    real_fused, real_dy = trc.bwd_fused_reference, trc.bwd_dy_reference
    monkeypatch.setattr(trc, "bwd_fused_reference",
                        lambda *a, **k: calls.__setitem__("fused", calls["fused"] + 1)
                        or real_fused(*a, **k))
    monkeypatch.setattr(trc, "bwd_dy_reference",
                        lambda *a, **k: calls.__setitem__("dy", calls["dy"] + 1)
                        or real_dy(*a, **k))
    trc.reset_launch_counts()
    _torch_grads(_case(2, 6, 64, 200, seed=5), 8, "MSE", bwd)
    assert (calls["fused"], calls["dy"]) == (fused_calls, dy_calls)
    assert all(n == 0 for n in trc.LAUNCHES.values())       # no kernel on the CPU


def test_auto_follows_the_engage_rule_and_unknown_values_raise(monkeypatch):
    seen = []
    real = trc.bwd_flavor
    monkeypatch.setattr(trc, "bwd_flavor", lambda *g: seen.append(g) or real(*g))
    _torch_grads(_case(2, 6, 64, 200, seed=6), 8, "MSE", "auto")
    assert seen == [(2, 6, 64, 200)]
    t = _torch_args(_case(2, 6, 64, 200))
    with pytest.raises(ValueError, match="bwd must be"):
        trc.readout_chain_loss(t["h"], t["kernel"], t["bias"], t["scale"], t["norm_bias"],
                               t["x"], t["inv"], 8, bwd="dy_free")


def test_engage_rule_names_both_flavors():
    geoms = [(16, 200, 1024, 95008), (16, 200, 128, 95008), (16, 200, 128, 5120),
             (4, 200, 128, 5120), (2, 37, 64, 300), (3, 50, 64, 1100), (3, 5, 16, 1100)]
    answers = [trc.bwd_flavor(*g) for g in geoms]
    assert set(answers) == {"fused", "materialize"}
    assert answers[0] == "materialize"          # the flagship: as the JAX rule answers
    assert trc.bwd_flavor(3, 5, 16, 1100) == "materialize"   # F is no multiple of 64
    assert trc.bwd_flavor(3, 50, 64, 1100) == "fused"


def test_other_devices_raise_and_nothing_falls_back():
    t = {k: v.detach().to("meta") for k, v in _torch_args(_case(2, 6, 64, 200)).items()}
    stats = torch.empty((2, 2, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        trc.readout_bwd_fused(t["x"], t["x"], t["scale"], t["norm_bias"], t["bias"], t["h"],
                              t["kernel"], stats, stats, t["bias"], 1.0, 8)
    with pytest.raises(ValueError, match="no readout kernel"):
        trc.readout_chain_loss(t["h"], t["kernel"], t["bias"], t["scale"], t["norm_bias"],
                               t["x"], t["inv"], 8, bwd="fused")
    assert trc.LAUNCHES["readout_bwd_fused"] == 0


def test_build_list_holds_thirteen_kernels_with_their_sources():
    assert len(_build.KERNELS) == len(set(_build.KERNELS)) == 13
    for name in _build.KERNELS:
        assert (_build.CSRC / f"{name}.cu").exists(), name
    assert {"readout_bwd_fused", "fused_adamw"} <= set(_build.KERNELS)
    src = (_build.CSRC / "readout_bwd_fused.cu").read_text()
    assert "atomicAdd" not in src and "wmma::mma_sync" in src and "fmaf" in src
    assert "readout_bwd_fused" in trc.LAUNCHES
