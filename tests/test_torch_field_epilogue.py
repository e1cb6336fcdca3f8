"""The served field's epilogue (``ops/field_epilogue.py``): the plain version
against ``MinMaxScaler.inverse_transform`` bit for bit, the wrapper's
checks, the launch counter on the CPU, and ``make_generate_fn`` placing each
chunk's rows against an unchunked call. The kernel itself runs only on the
card: the test marked ``chip`` holds it against the plain version there and
skips without one.

Nothing here imports JAX: the pipeline is built from the port's own modules
at a tiny width.
"""

import numpy as np
import pytest
import torch

from simulgen_vae_tpu_torch.config import VAEConfig
from simulgen_vae_tpu_torch.data.scaler import MinMaxScaler
from simulgen_vae_tpu_torch.generate import make_generate_fn
from simulgen_vae_tpu_torch.models.conditioner_mlp import LatentConditioner
from simulgen_vae_tpu_torch.models.vae import VAE
from simulgen_vae_tpu_torch.ops import _build
from simulgen_vae_tpu_torch.ops import field_epilogue as fe
from simulgen_vae_tpu_torch.utils import profiling

FLAGSHIP_N, ODD_N, QUAD_N = 95008, 1001, 1004
T, NODE, INPUTS, MAX_BATCH = 8, 64, 5, 4


def _field(shape, dtype, device="cpu", seed=0):
    g = torch.Generator().manual_seed(seed)
    return (3.0 * torch.rand(shape, generator=g) - 1.5).to(dtype).to(device)


def _scaler(n, device="cpu", seed=1):
    """Per-node statistics as a fitted field scaler holds them: scale in
    [0.2, 2], min in [-0.9, 0.9], f32."""
    g = torch.Generator().manual_seed(seed)
    scale = 0.2 + 1.8 * torch.rand(n, generator=g)
    min_ = 1.8 * torch.rand(n, generator=g) - 0.9
    return MinMaxScaler(scale.to(device), min_.to(device))


@pytest.mark.parametrize("n", [FLAGSHIP_N, ODD_N])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_plain_version_is_the_scalers_inverse_bit_for_bit(dtype, n):
    x = _field((2, 3, n), dtype)
    s = _scaler(n)
    out = torch.full((4, 3, n), 7.0)
    got = fe.field_epilogue(x, s.min_, s.scale_, out[1:3])
    want = s.inverse_transform(x.float())
    assert got.data_ptr() == out[1:3].data_ptr() and got.dtype == torch.float32
    assert torch.equal(out[1:3], want)
    assert bool((out[0] == 7.0).all()) and bool((out[3] == 7.0).all())


def _args(n=16):
    s = _scaler(n)
    return _field((2, 3, n), torch.bfloat16), s.min_, s.scale_, torch.empty((2, 3, n))


@pytest.mark.parametrize("case", ["dtype", "min_shape", "scale_dtype", "noncontiguous",
                                  "out_shape", "out_dtype", "out_noncontiguous"])
def test_wrapper_raises_on_what_the_kernel_does_not_take(case):
    x, min_, scale, out = _args()
    if case == "dtype":
        x, err = x.half(), TypeError
    elif case == "min_shape":
        min_, err = torch.cat([min_, min_[:1]]), ValueError
    elif case == "scale_dtype":
        scale, err = scale.double(), ValueError
    elif case == "noncontiguous":
        x, err = _field((2, 16, 3), torch.bfloat16).transpose(1, 2), ValueError
    elif case == "out_shape":
        out, err = torch.empty((3, 3, 16))[1:2], ValueError
    elif case == "out_dtype":
        out, err = out.bfloat16(), ValueError
    else:
        out, err = torch.empty((2, 16, 3)).transpose(1, 2), ValueError
    with pytest.raises(err):
        fe.field_epilogue(x, min_, scale, out)


def test_cpu_tensors_launch_nothing_and_the_kernel_is_built_and_counted():
    fe.reset_launch_counts()
    x, min_, scale, out = _args()
    fe.field_epilogue(x, min_, scale, out)
    assert fe.LAUNCHES["field_epilogue"] == 0
    assert "field_epilogue" in profiling.counters()
    assert "field_epilogue" in _build.KERNELS
    src = (_build.CSRC / "field_epilogue.cu").read_text()
    assert "__fdiv_rn(__fsub_rn(" in src and "__stcs" in src


def _pipeline(dtype=torch.float32):
    cfg = VAEConfig(num_param=8, num_time=T, num_node=NODE, latent_dim_end=8, latent_dim=4,
                    num_filter_enc=[16, 8, 8], small=True)
    torch.manual_seed(0)
    vae = VAE(cfg.latent_dim_end, cfg.latent_dim, cfg.num_filter_dec, cfg.num_node,
              cfg.num_time, cfg.small, "cpu", dtype).eval()
    lc = LatentConditioner([16, 16], cfg.latent_dim_end, INPUTS, cfg.latent_dim,
                           cfg.num_hier, "cpu").eval()

    def unit(n):
        return MinMaxScaler(torch.full((n,), 0.5), torch.zeros(n))

    return dict(cfg=cfg, lc_cfg=None, device=torch.device("cpu"), dtype=dtype,
                vae=vae, decoder_tree=None, lc=lc, lv_scaler=unit(cfg.latent_dim_end),
                xs_scaler=unit(cfg.latent_dim * cfg.num_hier), data_scaler=_scaler(NODE))


def _per_chunk(fn, x):
    """``fn`` on each chunk of MAX_BATCH rows as the serving function cuts a
    larger request (the tail padded by repeating its last row), the padding
    dropped: one unchunked call a chunk."""
    if len(x) <= MAX_BATCH:
        return fn(x)
    parts = []
    for s in range(0, len(x), MAX_BATCH):
        c = x[s: s + MAX_BATCH]
        parts.append(fn(np.concatenate([c, np.repeat(c[-1:], MAX_BATCH - len(c), 0)]))[: len(c)])
    return torch.cat(parts)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("descale", [True, False])
@pytest.mark.parametrize("n", [2 * MAX_BATCH, MAX_BATCH + 3, MAX_BATCH - 1])
def test_chunks_write_their_rows_as_an_unchunked_call(n, descale, dtype):
    """A request of ``n`` rows at MAX_BATCH a chunk: the same bits as
    unchunked calls of the same chunks (the CPU's products depend on the
    batch), descaled by the scaler's own inverse; in f32 also within 1e-5
    of one call of all ``n`` rows."""
    pipe = _pipeline(dtype)
    x = np.random.default_rng(n).uniform(-0.5, 0.5, (n, INPUTS)).astype(np.float32)
    fe.reset_launch_counts()
    got = make_generate_fn(pipe, descale_output=descale, max_batch=MAX_BATCH)(x)
    raw = _per_chunk(make_generate_fn(pipe, descale_output=False, max_batch=MAX_BATCH), x)
    ds = pipe["data_scaler"]
    want = ds.inverse_transform(raw.float()) if descale else raw
    assert got.shape == (n, T, NODE)
    assert got.dtype == (torch.float32 if descale else dtype)
    assert torch.equal(got, want)
    assert fe.LAUNCHES["field_epilogue"] == 0
    if dtype == torch.float32:
        whole = make_generate_fn(pipe, descale_output=descale, max_batch=n)(x)
        torch.testing.assert_close(got, whole, rtol=1e-5, atol=1e-5)


@pytest.mark.chip
@pytest.mark.parametrize("n", [FLAGSHIP_N, ODD_N, QUAD_N])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_equals_the_plain_version_on_the_card(dtype, n):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU version")
    dev = torch.device("cuda", 0)
    x = _field((3, 5, n), dtype, dev)
    s = _scaler(n, dev)
    fe.reset_launch_counts()
    for rows in (slice(0, 3), slice(1, 4)):  # an aligned and a shifted row base
        out = torch.full((4, 5, n), float("nan"), device=dev)
        fe.field_epilogue(x, s.min_, s.scale_, out[rows])
        want = fe.field_epilogue_reference(x, s.min_, s.scale_, torch.empty_like(out[rows]))
        torch.cuda.synchronize()
        assert torch.equal(out[rows], want)
        assert int(out.isnan().sum()) == out.numel() - x.numel()
    assert fe.LAUNCHES["field_epilogue"] == 2
