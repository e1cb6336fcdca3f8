"""The benched optimizer stack of the port against the JAX package's, on the CPU.

``sr_round_bf16`` is held bit for bit to JAX's ``_sr_round_bf16_fused``;
``FusedAdamW`` (its plain version, which the CPU takes) to the JAX class from
the same state, for f32, round-to-nearest bf16 and stochastically rounded
bf16 moments; ``resolve_perf_stack`` to the JAX function off a TPU. Inputs
come from numpy seeds. The JAX class walks its leaves in sorted-key order and
the port in insertion order, so the trees here are keyed in sorted order.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simulgen_vae_tpu.config import VAEConfig as JaxCfg
from simulgen_vae_tpu.config import resolve_perf_stack as jax_resolve
from simulgen_vae_tpu.train.optim import FusedAdamW as JaxAdamW
from simulgen_vae_tpu.train.optim import FusedAdamWState, _sr_round_bf16_fused
from simulgen_vae_tpu_torch.config import VAEConfig, resolve_perf_stack
from simulgen_vae_tpu_torch.train.optim import FusedAdamW, sr_round_bf16, sr_seed

SHAPES = {"a_dense": (40, 24), "b_conv": (6, 5, 3), "c_vec": (37,), "d_scalar": ()}


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, dtype=np.float32)).view(np.uint32)


def _special_values(rng):
    tie = np.float32(1.0) + np.float32(2.0 ** -8)        # exactly between two bf16 values
    vals = np.concatenate([
        rng.standard_normal(4000).astype(np.float32) * 10.0 ** rng.integers(-6, 4, 4000),
        np.array([0.0, -0.0, tie, -tie, 1e-40, -3e-39, 1.17549435e-38, 3.0e38, -65504.0,
                  1.0, -1.0, 0.333333343], np.float32)])
    return vals.astype(np.float32).reshape(4, -1)


@pytest.mark.parametrize("seed", [0, 12345, 2 ** 32 - 3, 0x9E3779B9])
def test_sr_round_bf16_is_bit_equal_to_jax(seed):
    x = _special_values(np.random.default_rng(7))
    want = _sr_round_bf16_fused(jnp.asarray(x), jnp.uint32(seed)).astype(jnp.float32)
    idx = torch.arange(x.size).reshape(x.shape)
    got = sr_round_bf16(torch.from_numpy(x), idx, seed)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(got.float().numpy()), _bits(want))
    # the index is the element's linear index: the high end of a uint32 wraps too
    far = idx + (2 ** 32 - 1000)
    a = sr_round_bf16(torch.from_numpy(x), far, seed)
    b = sr_round_bf16(torch.from_numpy(x), far % 2 ** 32, seed)
    assert torch.equal(a, b)


def test_sr_round_bf16_is_unbiased_and_picks_a_neighbour():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.uniform(0.5, 2.0, 64).astype(np.float32)
                         * rng.choice([-1.0, 1.0], 64).astype(np.float32))
    idx = torch.arange(64)
    lo = (x.view(torch.int32) & -65536).view(torch.float32)        # truncation toward zero
    hi = ((x.view(torch.int32) & -65536) + 65536).view(torch.float32)
    draws = torch.stack([sr_round_bf16(x, idx, s).float() for s in range(4096)])
    assert bool(((draws == lo) | (draws == hi)).all())
    mean, sem = draws.double().mean(0), draws.double().std(0) / 4096 ** 0.5
    assert bool(((mean - x.double()).abs() <= 3.0 * sem + 1e-12).all())


def _state(rng, dtype=np.float32):
    params = {k: (0.1 * rng.standard_normal(s)).astype(np.float32) for k, s in SHAPES.items()}
    grads = {k: (0.05 * rng.standard_normal(s)).astype(np.float32) for k, s in SHAPES.items()}
    mu = {k: (0.01 * rng.standard_normal(s)).astype(np.float32) for k, s in SHAPES.items()}
    nu = {k: (1e-4 * rng.standard_normal(s) ** 2).astype(np.float32) for k, s in SHAPES.items()}
    return params, grads, mu, nu


def _t(tree, dtype=torch.float32):
    return {k: torch.from_numpy(np.array(v)).to(dtype) for k, v in tree.items()}


def _j(tree, dtype=jnp.float32):
    return {k: jnp.asarray(v).astype(dtype) for k, v in tree.items()}


def _bf16_neighbours(v32: torch.Tensor):
    down = (v32.view(torch.int32) & -65536).view(torch.float32)
    up = ((v32.view(torch.int32) & -65536) + 65536).view(torch.float32)
    return down, up


MODES = {"float32": dict(), "bfloat16_rtn": dict(moment_dtype="bfloat16"),
         "bfloat16": dict(moment_dtype="bfloat16", stochastic_round=True)}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_one_step_matches_the_jax_class(mode):
    """Parameters and the gradient norm rtol 1e-6 in every mode (the update
    uses the unrounded moments). Moments: f32 rtol 1e-6; round-to-nearest
    bf16 equal to JAX's up to one ulp (where the f32 value sits at a tie);
    stochastically rounded bf16: each stored value is one of the two bf16
    neighbours of the exact f32 moment (the dither's leaf and element order
    are the port's own, so the bits differ from JAX's)."""
    kw = MODES[mode]
    rng = np.random.default_rng(11)
    params, grads, mu, nu = _state(rng)
    jdt = jnp.bfloat16 if kw else jnp.float32
    tdt = torch.bfloat16 if kw else torch.float32
    jopt = JaxAdamW(moment_dtype=jnp.bfloat16 if kw else None,
                    stochastic_round=kw.get("stochastic_round", False))
    jstate = FusedAdamWState(count=jnp.int32(3), mu=_j(mu, jdt), nu=_j(nu, jdt))
    want_p, want_s, want_norm = jopt.apply(_j(grads), jstate, _j(params), 1e-3)

    opt = FusedAdamW(**kw)
    tp = _t(params)
    state = {"count": 3, "mu": _t(mu, tdt), "nu": _t(nu, tdt)}
    start = {k: (state["mu"][k].float().clone(), state["nu"][k].float().clone())
             for k in SHAPES}
    norm = opt.apply(_t(grads), state, tp, 1e-3)
    assert state["count"] == 4 == int(want_s.count)
    np.testing.assert_allclose(float(norm), float(want_norm), rtol=1e-6)
    for k in SHAPES:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(want_p[k]), rtol=1e-6,
                                   atol=1e-9, err_msg=k)
        got_m, got_v = state["mu"][k], state["nu"][k]
        assert got_m.dtype == got_v.dtype == tdt
        wm = np.asarray(want_s.mu[k].astype(jnp.float32))
        wv = np.asarray(want_s.nu[k].astype(jnp.float32))
        if mode == "float32":
            np.testing.assert_allclose(got_m.numpy(), wm, rtol=1e-6, atol=1e-12, err_msg=k)
            np.testing.assert_allclose(got_v.numpy(), wv, rtol=1e-6, atol=1e-15, err_msg=k)
        elif mode == "bfloat16_rtn":
            np.testing.assert_allclose(got_m.float().numpy(), wm, rtol=2.0 ** -7, atol=1e-30)
            np.testing.assert_allclose(got_v.float().numpy(), wv, rtol=2.0 ** -7, atol=1e-30)
            assert (got_m.float().numpy() == wm).mean() >= 0.99
        else:
            g = torch.from_numpy(np.array(grads[k]))
            m0, v0 = start[k]
            exact_m = 0.9 * m0 + (1.0 - 0.9) * g
            exact_v = 0.999 * v0 + (1.0 - 0.999) * g * g
            for got, exact in ((got_m, exact_m), (got_v, exact_v)):
                down, up = _bf16_neighbours(exact.float().contiguous())
                ok = (got.float() == down) | (got.float() == up)
                # an exact value an f32 ulp from a bf16 value may land on its far side
                near = (got.float() - exact).abs() <= exact.abs() * 2.0 ** -7
                assert bool((ok | near).all()), k


def test_five_steps_f32_match_jax():
    rng = np.random.default_rng(5)
    params, _, _, _ = _state(rng)
    jopt, opt = JaxAdamW(), FusedAdamW()
    jp, js = _j(params), jopt.init(_j(params))
    tp = _t(params)
    ts = opt.init(tp)
    for step in range(5):
        grads = {k: (0.05 * rng.standard_normal(s)).astype(np.float32)
                 for k, s in SHAPES.items()}
        jp, js, jn = jopt.apply(_j(grads), js, jp, 1e-3 * (step + 1))
        tn = opt.apply(_t(grads), ts, tp, 1e-3 * (step + 1))
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for k in SHAPES:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-5, atol=1e-9)
        np.testing.assert_allclose(ts["mu"][k].numpy(), np.asarray(js.mu[k]), rtol=1e-5,
                                   atol=1e-12)
        np.testing.assert_allclose(ts["nu"][k].numpy(), np.asarray(js.nu[k]), rtol=1e-5,
                                   atol=1e-15)


def test_stochastic_moments_follow_seed_index_and_leaf():
    """The plain apply stores moment i of step t through sr_round_bf16 with the
    element's linear index and the seed of (t, 2 i) / (t, 2 i + 1)."""
    rng = np.random.default_rng(9)
    params, grads, mu, nu = _state(rng)
    opt = FusedAdamW(moment_dtype="bfloat16", stochastic_round=True)
    state = {"count": 6, "mu": _t(mu, torch.bfloat16), "nu": _t(nu, torch.bfloat16)}
    m0 = {k: v.float().clone() for k, v in state["mu"].items()}
    v0 = {k: v.float().clone() for k, v in state["nu"].items()}
    opt.apply(_t(grads), state, _t(params), 1e-3)
    for i, k in enumerate(SHAPES):
        g = torch.from_numpy(np.array(grads[k]))
        m2 = m0[k] * 0.9 + g * (1.0 - 0.9)
        v2 = v0[k] * 0.999 + (g * (1.0 - 0.999)) * g
        idx = torch.arange(g.numel()).reshape(g.shape)
        assert torch.equal(state["mu"][k], sr_round_bf16(m2, idx, sr_seed(7, 2 * i)))
        assert torch.equal(state["nu"][k], sr_round_bf16(v2, idx, sr_seed(7, 2 * i + 1)))
    assert sr_seed(7, 3) == (7 * 0x85EBCA6B + ((3 * 0xC2B2AE35) & 0xFFFFFFFF)) & 0xFFFFFFFF


def test_bf16_moments_cross_the_bridge_exactly():
    """``convert.train_state_from_jax`` carries bf16 moments over as f32 values
    (numpy has no bf16) and casts them to the trainer's moment dtype: the bits
    are the JAX state's."""
    from types import SimpleNamespace

    from simulgen_vae_tpu_torch import convert
    from simulgen_vae_tpu_torch.train.vae_trainer import VAETrainer

    cfg = VAEConfig(num_time=12, num_node=300, latent_dim_end=8, latent_dim=4,
                    num_filter_enc=[16, 8, 8], batch_size=4, use_spectral_norm=False,
                    opt_state_dtype="bfloat16")
    rng = np.random.default_rng(2)
    tree = convert.random_vae_tree(cfg, rng)
    import jax

    noisy = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda a: jnp.asarray(rng.standard_normal(a.shape), jnp.bfloat16), t)
    jstate = FusedAdamWState(count=jnp.int32(5), mu=noisy(tree), nu=noisy(tree))
    trainer = VAETrainer(cfg, device="cpu")
    state = convert.train_state_from_jax(trainer, SimpleNamespace(
        params=tree, opt_state=jax.tree_util.tree_map(np.asarray, jstate), sn_u={}, epoch=3))
    assert state.epoch == 3 and state.opt_state["count"] == 5
    want = convert.vae_state(jax.tree_util.tree_map(
        lambda a: np.asarray(a.astype(jnp.float32)), jstate.mu))
    for k, v in state.opt_state["mu"].items():
        assert v.dtype == torch.bfloat16
        np.testing.assert_array_equal(v.float().numpy(), want[k])


def test_mixed_moment_dtypes_and_other_devices():
    opt = FusedAdamW(moment_dtype="bfloat16", nu_dtype="float32")
    state = opt.init({"w": torch.zeros(3, 2)})
    assert state["mu"]["w"].dtype == torch.bfloat16 and state["nu"]["w"].dtype == torch.float32
    meta = {"w": torch.zeros(3, 2, device="meta")}
    with pytest.raises(ValueError, match="no AdamW kernel"):
        FusedAdamW().apply(meta, FusedAdamW().init(meta), meta, 1e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cadence", ["auto", "step", "epoch"])
@pytest.mark.parametrize("osd", ["auto", "float32", "bfloat16", "bfloat16_rtn"])
def test_resolve_perf_stack_matches_jax_off_a_tpu(osd, cadence, dtype):
    kw = dict(opt_state_dtype=osd, sn_cadence=cadence, dtype=dtype)
    assert resolve_perf_stack(VAEConfig(**kw)) == jax_resolve(JaxCfg(**kw), backend="cpu")


@pytest.mark.parametrize("kw", [dict(opt_state_dtype="float16"), dict(sn_cadence="never")])
def test_resolve_perf_stack_refuses_unknown_values(kw):
    with pytest.raises(ValueError):
        resolve_perf_stack(VAEConfig(**kw))
    with pytest.raises(ValueError):
        jax_resolve(JaxCfg(**kw), backend="cpu")


def test_trainer_builds_the_stack_it_is_asked_for():
    from simulgen_vae_tpu_torch.train.vae_trainer import VAETrainer

    cfg = VAEConfig(num_time=12, num_node=300, latent_dim_end=8, latent_dim=4,
                    num_filter_enc=[16, 8, 8], batch_size=4)
    plain = VAETrainer(cfg, device="cpu")
    assert plain.opt.moment_dtype == plain.opt.nu_dtype == torch.float32
    assert not plain.opt.sr and not plain.sn_per_epoch and plain.readout_bwd == "auto"
    stack = VAETrainer(dataclasses.replace(cfg, opt_state_dtype="bfloat16",
                                           sn_cadence="epoch", remat=True),
                       device="cpu", fused_readout=True, readout_bwd="fused")
    assert stack.opt.moment_dtype == stack.opt.nu_dtype == torch.bfloat16
    assert stack.opt.sr and stack.sn_per_epoch and stack.readout_bwd == "fused"
    state = stack.init_state(0)
    assert all(v.dtype == torch.bfloat16 for v in state.opt_state["mu"].values())
    assert state.model.decoder.remat and state.model.encoder.remat
    with pytest.raises(ValueError, match="readout_bwd"):
        VAETrainer(cfg, device="cpu", readout_bwd="dy_free")
