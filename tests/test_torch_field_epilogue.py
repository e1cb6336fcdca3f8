"""The served field's last step (``ops/field_epilogue.py``): the plain
descale against ``MinMaxScaler.inverse_transform`` bit for bit,
``make_generate_fn`` placing each chunk's rows against an unchunked call, and
the readout's fused pass (``gn_apply_field_epilogue``): its plain version
against the readout's GroupNorm apply, rounding and descale, its checks, its
launch counter on the CPU, and which serving and training paths take it. The
kernel itself runs only on the card: the test marked ``chip`` holds it
against the plain versions there and skips without one.

Nothing here imports JAX: the pipeline is built from the port's own modules
at a tiny width.
"""

import contextlib

import numpy as np
import pytest
import torch

from simulgen_vae_tpu_torch.config import VAEConfig
from simulgen_vae_tpu_torch.data.scaler import MinMaxScaler
from simulgen_vae_tpu_torch.generate import make_generate_fn
from simulgen_vae_tpu_torch.models import blocks
from simulgen_vae_tpu_torch.models.conditioner_mlp import LatentConditioner
from simulgen_vae_tpu_torch.models.vae import VAE
from simulgen_vae_tpu_torch.ops import _build
from simulgen_vae_tpu_torch.ops import field_epilogue as fe
from simulgen_vae_tpu_torch.ops import groupnorm_gelu as gg
from simulgen_vae_tpu_torch.train.lc_e2e_trainer import E2ETrainer
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
    got = fe.field_epilogue_reference(x, s.min_, s.scale_, out[1:3])
    want = s.inverse_transform(x.float())
    assert got.data_ptr() == out[1:3].data_ptr() and got.dtype == torch.float32
    assert torch.equal(out[1:3], want)
    assert bool((out[0] == 7.0).all()) and bool((out[3] == 7.0).all())


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
    assert fe.LAUNCHES["gn_apply_field_epilogue"] == 0
    if dtype == torch.float32:
        whole = make_generate_fn(pipe, descale_output=descale, max_batch=n)(x)
        torch.testing.assert_close(got, whole, rtol=1e-5, atol=1e-5)


# -- the readout's GroupNorm apply, tanh and descale in one pass -------------------

FUSED_ROWS = {"whole": (slice(0, 3), 3), "tail": (slice(1, 3), 2), "shifted": (slice(1, 4), 3)}


def _readout(shape, dtype, device="cpu", seed=2):
    """A readout product's pre-norm map with its GroupNorm statistics and f32
    affine: ``(y, stats, gscale, gbias, groups)``."""
    g = torch.Generator().manual_seed(seed)
    n = shape[2]
    groups = blocks.group_count(n)
    y = (2.0 * torch.randn(shape, generator=g) + 0.3).to(dtype)
    gscale = 2.0 * torch.rand(n, generator=g) - 0.5
    gbias = torch.rand(n, generator=g) - 0.5
    y, gscale, gbias = (t.to(device) for t in (y, gscale, gbias))
    return y, gg.group_stats_reference(y, groups), gscale, gbias, groups


@pytest.mark.parametrize("rows", list(FUSED_ROWS))
@pytest.mark.parametrize("n", [FLAGSHIP_N, ODD_N, QUAD_N])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fused_plain_version_is_the_readouts_apply_then_the_descale(dtype, n, rows):
    """Into rows ``FUSED_ROWS[rows]`` of a larger field: the GroupNorm apply
    and tanh of the map's first rows rounded to its dtype, then the scaler's
    inverse, bit for bit; no other row is written ("tail": the padded
    chunk's extra row is never read)."""
    y, stats, gscale, gbias, groups = _readout((3, 4, n), dtype)
    s = _scaler(n)
    where, r = FUSED_ROWS[rows]
    out = torch.full((4, 4, n), 7.0)
    got = fe.gn_apply_field_epilogue(y, stats, gscale, gbias, s.min_, s.scale_, out[where],
                                     groups)
    act = gg.group_apply_reference(y, gscale, gbias, stats, groups, act="tanh")
    assert act.dtype == dtype
    want = s.inverse_transform(act[:r].float())
    assert got.data_ptr() == out[where].data_ptr() and got.dtype == torch.float32
    assert torch.equal(out[where], want)
    untouched = torch.ones(4, dtype=torch.bool)
    untouched[where] = False
    assert bool((out[untouched] == 7.0).all())


def _fused_args(n=16):
    y, stats, gscale, gbias, groups = _readout((2, 3, n), torch.bfloat16)
    s = _scaler(n)
    return dict(y=y, stats=stats, gscale=gscale, gbias=gbias, min_=s.min_, scale=s.scale_,
                out=torch.empty((2, 3, n)), num_groups=groups)


FUSED_BAD = {
    "dtype": (lambda a: dict(y=a["y"].half()), TypeError),
    "groups": (lambda a: dict(num_groups=3), ValueError),
    "stats_groups": (lambda a: dict(stats=a["stats"][:, :, :-1].contiguous()), ValueError),
    "stats_samples": (lambda a: dict(stats=a["stats"][:1]), ValueError),
    "stats_dtype": (lambda a: dict(stats=a["stats"].double()), ValueError),
    "gscale_shape": (lambda a: dict(gscale=torch.cat([a["gscale"], a["gscale"][:1]])),
                     ValueError),
    "gbias_dtype": (lambda a: dict(gbias=a["gbias"].bfloat16()), ValueError),
    "min_shape": (lambda a: dict(min_=a["min_"][:-1]), ValueError),
    "scale_noncontiguous": (lambda a: dict(scale=torch.stack([a["scale"]] * 2, 1)[:, 0]),
                            ValueError),
    "out_rows": (lambda a: dict(out=torch.empty((3, 3, 16))), ValueError),
    "out_empty": (lambda a: dict(out=torch.empty((0, 3, 16))), ValueError),
    "out_width": (lambda a: dict(out=torch.empty((2, 3, 15))), ValueError),
    "out_dtype": (lambda a: dict(out=a["out"].bfloat16()), ValueError),
    "out_time": (lambda a: dict(out=torch.empty((2, 4, 16))), ValueError),
    "out_noncontiguous": (lambda a: dict(out=torch.empty((2, 16, 3)).transpose(1, 2)),
                          ValueError),
    "noncontiguous": (lambda a: dict(y=a["y"].transpose(0, 1).contiguous().transpose(0, 1)),
                      ValueError),
    "stats_noncontiguous": (lambda a: dict(stats=a["stats"].transpose(0, 1).contiguous()
                                           .transpose(0, 1)), ValueError),
    "scale_dtype": (lambda a: dict(scale=a["scale"].double()), ValueError),
    "min_device": (lambda a: dict(min_=torch.empty(16, device="meta")), ValueError),
}


@pytest.mark.parametrize("case", list(FUSED_BAD))
def test_fused_wrapper_raises_on_what_the_kernel_does_not_take(case):
    args = _fused_args()
    change, err = FUSED_BAD[case]
    args.update(change(args))
    with pytest.raises(err):
        fe.gn_apply_field_epilogue(**args)


def test_fused_cpu_tensors_launch_nothing_and_the_kernel_is_counted():
    fe.reset_launch_counts()
    fe.gn_apply_field_epilogue(**_fused_args())
    assert fe.LAUNCHES == {"gn_apply_field_epilogue": 0}
    assert "gn_apply_field_epilogue" in profiling.counters()
    assert "field_epilogue" in _build.KERNELS
    src = (_build.CSRC / "field_epilogue.cu").read_text()
    assert "__fdiv_rn(__fsub_rn(" in src and "__stcs" in src
    # the readers find the kernel by both of its layers' names
    assert "gn_apply_field_epilogue_kernel" in src and '#include "gn_common.cuh"' in src
    assert "gn::activate<gn::kActTanh>(xn * sc + bi)" in src


@contextlib.contextmanager
def _readout_calls():
    """Spy on the readout's two routes: the fused pass's calls (the rows each
    wrote) and the activations of every ``group_norm_act`` call."""
    fused, acts = [], []
    real_fused, real_gn = blocks.gn_apply_field_epilogue, blocks.group_norm_act

    def spy_fused(y, stats, gscale, gbias, min_, scale, out, num_groups):
        fused.append(out.shape[0])
        return real_fused(y, stats, gscale, gbias, min_, scale, out, num_groups)

    def spy_gn(x, scale, bias, num_groups, eps=1e-5, act="gelu"):
        acts.append(act)
        return real_gn(x, scale, bias, num_groups, eps, act)

    blocks.gn_apply_field_epilogue, blocks.group_norm_act = spy_fused, spy_gn
    try:
        yield fused, acts
    finally:
        blocks.gn_apply_field_epilogue, blocks.group_norm_act = real_fused, real_gn


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [2 * MAX_BATCH + 3, MAX_BATCH - 1])
def test_descaling_requests_take_the_fused_readout_once_a_chunk(n, dtype):
    """Two chunks and a padded tail (or one chunk): one fused pass a chunk,
    each writing the chunk's real rows, and no tanh ``group_norm_act``, so
    no normalised map is made; the field is the one served raw and
    descaled."""
    pipe = _pipeline(dtype)
    x = np.random.default_rng(n).uniform(-0.5, 0.5, (n, INPUTS)).astype(np.float32)
    with _readout_calls() as (fused, acts):
        got = make_generate_fn(pipe, max_batch=MAX_BATCH)(x)
    chunks = [min(MAX_BATCH, n - s) for s in range(0, n, MAX_BATCH)]
    assert fused == chunks and "tanh" not in acts and "gelu" in acts
    raw = _per_chunk(make_generate_fn(pipe, descale_output=False, max_batch=MAX_BATCH), x)
    assert torch.equal(got, pipe["data_scaler"].inverse_transform(raw.float()))


def test_raw_requests_and_the_e2e_decoder_keep_the_plain_readout():
    """``descale_output=False`` and the E2E trainer's frozen decoder (under
    autograd, no field handed over) normalise through ``group_norm_act``."""
    pipe = _pipeline()
    x = np.random.default_rng(0).uniform(-0.5, 0.5, (2 * MAX_BATCH, INPUTS)).astype(np.float32)
    with _readout_calls() as (fused, acts):
        make_generate_fn(pipe, descale_output=False, max_batch=MAX_BATCH)(x)
    assert fused == [] and acts.count("tanh") == 2
    cfg = pipe["cfg"]
    trainer = E2ETrainer(pipe["lc"], pipe["vae"], pipe["lv_scaler"], pipe["xs_scaler"],
                         epochs=1, lr=1e-3, batch_size=MAX_BATCH, device="cpu")
    z = torch.randn(MAX_BATCH, cfg.latent_dim_end, requires_grad=True)
    xs = torch.randn(MAX_BATCH, cfg.num_hier, cfg.latent_dim)
    with _readout_calls() as (fused, acts):
        field = trainer.decode(z, xs)
    assert fused == [] and acts.count("tanh") == 1
    assert field.shape == (MAX_BATCH, T, NODE) and field.requires_grad


def _plain_gap(got, want, scale, dtype):
    """How far the kernel's field lies from the plain version's, in the
    tanh'd map's units (the gap times the scaler's scale_), and whether that
    is no more than the rounding of one side's tanh (torch.tanh against
    tanhf, a separate multiply and add against an FMA) can explain: at most
    one bf16 step of a value in (-1, 1) on at most a thousandth of the
    elements in bf16, 1e-5 in f32."""
    gap = (got - want).abs() * scale
    worst, share = float(gap.max()), int((gap > 0).sum()) / gap.numel()
    ok = worst <= 2.0 ** -8 + 1e-5 and share <= 1e-3 if dtype == torch.bfloat16 else worst <= 1e-5
    return worst, share, ok


@pytest.mark.chip
@pytest.mark.parametrize("n", [FLAGSHIP_N, ODD_N, QUAD_N])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fused_kernel_equals_gn_apply_then_the_descale_on_the_card(dtype, n):
    """Bit for bit ``gn_apply(act="tanh")`` then the plain descale on the
    card, and within :func:`_plain_gap` of the whole plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU version")
    dev = torch.device("cuda", 0)
    y, _, gscale, gbias, groups = _readout((3, 5, n), dtype, dev)
    stats = gg.gn_stats(y, groups)
    s = _scaler(n, dev)
    act = gg.gn_apply(y, gscale, gbias, stats, groups, act="tanh")
    fe.reset_launch_counts()
    for where, r in FUSED_ROWS.values():
        out = torch.full((4, 5, n), float("nan"), device=dev)
        fe.gn_apply_field_epilogue(y, stats, gscale, gbias, s.min_, s.scale_, out[where],
                                   groups)
        want = fe.field_epilogue_reference(act[:r], s.min_, s.scale_,
                                           torch.empty_like(out[where]))
        plain = fe.gn_apply_field_epilogue_reference(y, stats, gscale, gbias, s.min_, s.scale_,
                                                     torch.empty_like(out[where]), groups)
        torch.cuda.synchronize()
        assert torch.equal(out[where], want)
        assert _plain_gap(out[where], plain, s.scale_, dtype)[2]
        assert int(out.isnan().sum()) == out.numel() - want.numel()
    assert fe.LAUNCHES == {"gn_apply_field_epilogue": len(FUSED_ROWS)}
