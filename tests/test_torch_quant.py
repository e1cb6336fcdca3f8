"""The port's int8 serving decode (``ops/quant.py``, the int8 branches of
``models/blocks.py``, ``generate``'s quantize modes) against the JAX package's.

* ``quantize_kernel`` on the port's ``[F, C, k]`` / ``[out, in]`` weights and
  ``_quantize_act`` give the JAX functions' bits (the latter against JAX run op
  by op: under ``jit`` XLA turns the division by 127 into a product with its
  reciprocal, which moves a scale by an ulp).
* ``int8_dot`` and ``int8_conv1d_same`` (k = 1, 3, 5) agree with the jitted
  JAX functions within 1e-6 of the output's largest magnitude: the same int32
  products, rescaled in f32 with a reciprocal in JAX and a division here and
  summed over taps in another order (a few f32 ulps).
* The int8 decode (T = 8, 300 nodes, decoder filters [4, 8, 16, 32], four
  weight draws) agrees with JAX's int8 decode to atol/rtol 1e-4. Measured:
  at most 1e-6 apart (rel-L2 1.6e-7), while int8 stands 0.07-0.18 (rel-L2
  1.3-2%) from the float decode. A flip of one activation quantum, possible
  where the f32 activations differ in their last bits, would move outputs by
  about 1e-2 and fail the check; none occurs on these draws.
* The per-model self-check passes on a well-behaved model and falls back to
  float with a warning on an outlier-weighted one; ``resolve_quantize`` is
  pinned.
"""

import logging
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simulgen_vae_tpu import generate as jgen
from simulgen_vae_tpu.models import LatentConditioner as JaxLC
from simulgen_vae_tpu.models.vae import VAE as JaxVAE
from simulgen_vae_tpu.ops import quant as jq
from simulgen_vae_tpu_torch import convert
from simulgen_vae_tpu_torch import generate as tgen
from simulgen_vae_tpu_torch.config import LCConfig, VAEConfig
from simulgen_vae_tpu_torch.data.scaler import MinMaxScaler
from simulgen_vae_tpu_torch.models import blocks
from simulgen_vae_tpu_torch.ops import quant as tq

T, NODE, Z, HIER = 8, 300, 8, 4
ENC, LC_FILTERS, N_IN = [32, 16, 8, 4], [8, 16, 16], 12
CFG = VAEConfig(num_time=T, num_node=NODE, latent_dim_end=Z, latent_dim=HIER,
                num_filter_enc=ENC)
LC_CFG = LCConfig(filters=LC_FILTERS, input_type="csv")


def _port_layout(w: np.ndarray) -> torch.Tensor:
    """A JAX kernel ([k, C, F] or [C, F]) in the port's layout."""
    return torch.from_numpy(np.ascontiguousarray(w.transpose(2, 1, 0) if w.ndim == 3 else w.T))


@pytest.mark.parametrize("shape", [(3, 64, 32), (5, 40, 24), (64, 48), (1, 8, 4)])
def test_quantize_kernel_gives_jax_bits(shape):
    rng = np.random.default_rng(len(shape) + shape[-1])
    w = rng.standard_normal(shape).astype(np.float32)
    w[..., 5 % shape[-1]] *= 40.0          # an outlier channel
    if shape == (1, 8, 4):
        w[..., 2] = 0.0                      # an all-zero channel
    kq, s = jq.quantize_kernel(w)
    pq, ps = tq.quantize_kernel(_port_layout(w))
    assert pq.dtype == torch.int8 and ps.dtype == torch.float32
    np.testing.assert_array_equal(_port_layout(kq).numpy(), pq.numpy())
    np.testing.assert_array_equal(s, ps.numpy())


def test_quantize_act_gives_jax_bits():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((4, 20, 64)) * rng.uniform(1e-3, 1e3, (4, 20, 1))).astype(np.float32)
    x[0, 0] = 0.0                            # a zero row: scale 1e-30 / 127
    x[1, 1, :4] = [2.5, -2.5, 0.5, 127.0]    # exact halves round to even
    with jax.disable_jit():
        xq, sx = jq._quantize_act(jnp.asarray(x))
    pq, ps = tq._quantize_act(torch.from_numpy(x))
    np.testing.assert_array_equal(np.asarray(xq), pq.numpy())
    np.testing.assert_array_equal(np.asarray(sx), ps.numpy())


def test_int8_dot_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 20, 64)).astype(np.float32)
    kq, s = jq.quantize_kernel(rng.standard_normal((64, 48)).astype(np.float32))
    want = np.asarray(jax.jit(jq.int8_dot)(x, kq, s))
    got = tq.int8_dot(torch.from_numpy(x), _port_layout(kq), torch.from_numpy(s)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("k", [1, 3, 5])
def test_int8_conv1d_same_matches_jax(k):
    rng = np.random.default_rng(k)
    x = rng.standard_normal((2, 16, 32)).astype(np.float32)
    kq, s = jq.quantize_kernel(rng.standard_normal((k, 32, 24)).astype(np.float32))
    want = np.asarray(jax.jit(jq.int8_conv1d_same)(x, kq, s))
    taps = torch.from_numpy(np.ascontiguousarray(kq.transpose(0, 2, 1)))   # [k, F, C]
    got = tq.int8_conv1d_same(torch.from_numpy(x), taps, torch.from_numpy(s)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


def test_int8_mm_is_exact_and_counts_only_the_card():
    rng = np.random.default_rng(2)
    a = torch.from_numpy(rng.integers(-127, 128, (19, 40), dtype=np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (13, 40), dtype=np.int8))
    tq.reset_launch_counts()
    got = tq.int8_mm(a, w)
    assert got.dtype == torch.int32 and tq.LAUNCHES["int8_mm"] == 0
    want = a.numpy().astype(np.int64) @ w.numpy().astype(np.int64).T
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="int8"):
        tq.int8_mm(a.float(), w)


def _trees(seed: int):
    rng = np.random.default_rng(seed)
    dec = convert.random_decoder_tree(CFG, rng)
    # quiet prior/posterior heads keep mode='fix' noise at std 1e-8
    for name, sub in dec.items():
        if name.startswith("condition_"):
            sub["Conv1d_0"]["Conv_0"]["kernel"] *= 0.1
    lc = convert.random_conditioner_tree(LC_CFG, CFG, N_IN, rng)
    scalers = {name: MinMaxScaler(rng.uniform(0.5, 2.0, n).astype(np.float32),
                                  rng.uniform(-0.3, 0.3, n).astype(np.float32))
               for name, n in (("lv_scaler", Z), ("xs_scaler", CFG.num_hier * HIER),
                               ("data_scaler", NODE))}
    return dec, lc, scalers


def _pipelines(dec, lc, scalers):
    vae = JaxVAE(latent_dim=Z, hierarchical_dim=HIER, num_filter_enc=ENC,
                 num_filter_dec=ENC[::-1], num_node=NODE, num_time=T, small=True)
    jax_pipe = dict(
        cfg=SimpleNamespace(num_node=NODE), vae_model=vae,
        vae_vars={"params": {"decoder": dec}},
        lc_model=JaxLC(LC_FILTERS, Z, N_IN, HIER, CFG.num_hier, dropout_rate=0.0),
        lc_vars={"params": lc},
        **{k: SimpleNamespace(scale_=s.scale_, min_=s.min_) for k, s in scalers.items()})
    port_pipe = tgen.make_pipeline(CFG, LC_CFG, {"decoder": dec}, lc, device="cpu",
                                   dtype=torch.float32, **scalers)
    return jax_pipe, port_pipe


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_int8_decode_matches_jax_int8_decode(seed):
    jax_pipe, port_pipe = _pipelines(*_trees(seed))
    x = np.random.default_rng(10 + seed).standard_normal((16, N_IN)).astype(np.float32)
    want = jgen.generate(jax_pipe, x, quantize="int8")
    got = tgen.generate(port_pipe, x, quantize="int8").numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    float_gap = np.abs(want - tgen.generate(port_pipe, x).numpy()).max()
    assert float_gap > 100 * np.abs(got - want).max() and float_gap > 1e-2
    # the float pipeline's modules stay float: the mirror is a copy
    assert all(m.weight_q is None for m in port_pipe["vae"].modules()
               if getattr(m, "quant_weight", None))
    assert all(m.weight_q is not None and m.weight_q.dtype == torch.int8
               for m in port_pipe["_int8_vae"].modules() if getattr(m, "quant_weight", None))


def _outliers(tree):
    """Every kernel (JAX layout) with its first two rows of [-1, F] scaled
    100x: per-channel quantization then loses ~7 bits on the rest of each
    channel, as ``tests/test_quant.py`` plants it for JAX."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _outliers(v)
        elif k == "kernel":
            w = np.array(v)
            w.reshape(-1, w.shape[-1])[:2] *= 100.0
            out[k] = w
        else:
            out[k] = v
    return out


@pytest.mark.parametrize("outliers", [False, True], ids=["passes", "falls_back"])
def test_int8_self_check(monkeypatch, caplog, outliers):
    monkeypatch.setattr(tgen, "resolve_quantize", lambda mode, device, dtype: "int8")
    dec, lc, scalers = _trees(5)
    pipe = tgen.make_pipeline(CFG, LC_CFG, {"decoder": _outliers(dec) if outliers else dec},
                              lc, device="cpu", dtype=torch.float32, **scalers)
    x = np.random.default_rng(6).standard_normal((6, N_IN)).astype(np.float32)
    with caplog.at_level(logging.WARNING, "simulgen_vae_tpu_torch.generate"):
        out = tgen.generate(pipe, x, quantize="auto")
    ok, rel = pipe["_int8_check"]
    out_f = tgen._cached_fn(pipe, True, None)(x)
    out_q = tgen._cached_fn(pipe, True, "int8")(x)
    warned = any("int8 self-check FAILED" in r.message for r in caplog.records)
    if outliers:
        assert not ok and rel > 0.05 and warned
        np.testing.assert_array_equal(out.numpy(), out_f.numpy())
    else:
        assert ok and 0 < rel <= 0.05 and not warned
        np.testing.assert_array_equal(out.numpy(), out_q.numpy())
        assert not torch.allclose(out, out_f)
    assert tgen.int8_self_check(pipe, x) is pipe["_int8_check"]   # cached


def test_resolve_quantize_rule():
    """'auto' is int8 for an f32 pipeline on CUDA only, where the card
    decoded faster in int8 than in f32 (and slower than in bf16; PERF.md);
    explicit modes pass through."""
    assert tgen.resolve_quantize("auto", "cuda", torch.float32) == "int8"
    assert tgen.resolve_quantize("auto") == "int8"             # the defaults: cuda, f32
    assert tgen.resolve_quantize("auto", "cuda", torch.bfloat16) is None
    assert tgen.resolve_quantize("auto", "cpu", torch.float32) is None
    assert tgen.resolve_quantize("auto", torch.device("cpu"), torch.bfloat16) is None
    for device in ("cuda", "cpu"):
        assert tgen.resolve_quantize("none", device) is None
        assert tgen.resolve_quantize(None, device) is None
        assert tgen.resolve_quantize("int8", device, torch.bfloat16) == "int8"


def test_auto_serves_float_on_the_cpu():
    """On the CPU 'auto' decodes in float and runs no self-check."""
    _, port_pipe = _pipelines(*_trees(7))
    x = np.random.default_rng(8).standard_normal((3, N_IN)).astype(np.float32)
    got = tgen.generate(port_pipe, x, quantize="auto")
    np.testing.assert_array_equal(got.numpy(), tgen.generate(port_pipe, x).numpy())
    assert "_int8_check" not in port_pipe and "_int8_vae" not in port_pipe
    with pytest.raises(ValueError, match="unknown quantize"):
        tgen.make_generate_fn({"cfg": CFG, "device": torch.device("cpu"),
                               "dtype": torch.float32}, quantize="int4")


def test_layers_without_a_mirror_keep_their_state_dict():
    """The empty weight_q / weight_s slots add no state-dict entries."""
    conv = blocks.Conv1d(4, 6, 3)
    assert set(conv.state_dict()) == {"weight", "bias"}
    readout = blocks.FusedPointwiseNormTanh(4, 12)
    assert "weight_q" not in readout.state_dict()
