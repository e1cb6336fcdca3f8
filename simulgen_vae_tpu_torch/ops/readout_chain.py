"""Fused train-path readout: k=1 conv -> GroupNorm -> Tanh -> reconstruction loss.

Counterpart of ``simulgen_vae_tpu/ops/readout_chain.py``. The train step needs
the reconstruction loss, not the reconstruction: this op maps the decoder's
last ``[B, T, F]`` map to ``(recon_loss, recon_mse)`` without ever writing
``x_hat``, in four passes over the ``[B, T, C]`` readout-width maps:

forward
  1. ``readout_matmul_stats``: ``y = round((h @ W^T) * inv_sigma + bias)``,
     written once, with the per-(sample, group) statistics **of the rounded
     y** taken in the product's epilogue (no separate statistics pass);
  2. ``readout_loss``: reads y and the target once; normalize, affine, tanh,
     and the sums of the configured loss and of the squared error.

backward
  3. ``readout_bwd_stats``: recomputes xn, o, da from y and the target;
     per-(sample, group) means of dxn and dxn * xn, per-column sums over T of
     da (d norm_bias) and da * xn (d scale);
  then one of two flavors (``bwd="materialize" | "fused"``; ``"auto"`` asks
  :func:`bwd_flavor`):
  4a. ``readout_bwd_dy`` (materialize): the same recomputation, writes ``dy``
     in the map's dtype, per-column sums of dy (d bias) and the partials of
     ``sum(dy * (y - bias) / inv_sigma)`` (d inv_sigma); ``dW = dy^T h *
     inv_sigma`` and ``dh = dy W * inv_sigma`` are then ``torch.matmul``, as
     the JAX package leaves them to XLA;
  4b. ``readout_bwd_fused`` (fused, the JAX ``_bwd_fused_dw_kernel``): dy is
     recomputed stage by stage, rounded to the map's dtype and contracted at
     once into the f32 ``dW`` and ``dh`` inside the kernel, with d bias and
     d inv_sigma from the f32 dy; the ``[B, T, C]`` dy map is never written.
     In bf16 each of its two passes recomputes dy once: a thread-block
     cluster spans the F tiles of an output tile (:func:`bwd_fused_cluster`)
     and shares each stage of dy between its blocks.

Layouts: ``h`` ``[B, T, F]``, ``kernel`` ``[C, F]`` (the port's dense layout;
JAX's is ``[F, C]``), maps ``[B, T, C]``, per-column vectors ``[C]`` f32,
statistics ``[B, 2, G]`` f32 of (mean, rsqrt(max(var, 0) + eps)).
``inv_sigma`` is spectral norm's output scale as a 0-d f32 tensor (1.0 when
spectral norm is off); it and the two cotangents reach the kernels as device
scalars, so nothing here waits for the card.

Each wrapper takes its plain version (``*_reference``) for a CPU tensor and
launches its hand-written kernel (``ops/csrc/readout_*.cu``) for a CUDA
tensor, or raises: there is no fallback. ``LAUNCHES`` counts the launches.
"""

from __future__ import annotations

import ctypes

import torch

from simulgen_vae_tpu_torch.ops.groupnorm_gelu import (
    _DTYPE_CODES,
    _check_like,
    _check_map,
    _check_stats,
    _check_vec,
    _expand,
    _fn,
    _group_sums,
    _ptr,
    _raise_on,
    _stream,
)

LAUNCHES = {"readout_matmul_stats": 0, "readout_loss": 0, "readout_bwd_stats": 0,
            "readout_bwd_dy": 0, "readout_bwd_fused": 0}
BWD_FLAVORS = ("fused", "materialize")

# smoothL1 (beta = 1) and Huber (delta = 1) are one function.
_LOSS_CODES = {"MSE": 0, "MAE": 1, "smoothL1": 2, "Huber": 2}
# Depth of one shared-memory stage of the bf16 product (readout_matmul_stats.cu).
BF16_K_STEP = 64
# Output tile of the bf16 product: rows over the flattened B*T rows, columns over C.
BF16_TILE_M, BF16_TILE_N = 128, 256
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


# The bf16 dy-free backward (ops/csrc/readout_bwd_fused.cu): F tiles of
# BWD_FUSED_TILE_N (128 where F <= 128), one thread-block cluster spanning at
# most BWD_FUSED_MAX_RANKS of them.
BWD_FUSED_TILE_N, BWD_FUSED_MAX_RANKS = 256, 8


def bwd_fused_cluster(f: int) -> tuple[int, int, int]:
    """``(F tile, ranks, clusters along F)`` of the bf16 dy-free backward at
    depth ``f``: one cluster spans all F tiles up to
    :data:`BWD_FUSED_MAX_RANKS` (4 ranks of 256 at F = 1024, one rank at
    F <= 256), else the fewest clusters of equal size that do; each cluster
    recomputes dy once a pass."""
    tile = BWD_FUSED_TILE_N if f > 128 else 128
    f_tiles = -(-f // tile)
    groups = -(-f_tiles // BWD_FUSED_MAX_RANKS)
    return tile, -(-f_tiles // groups), groups


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# Maps of B*T*C elements from FUSED_BWD_ELEMENTS[0] to [1] take the dy-free
# backward (the window the measured table below supports).
FUSED_BWD_ELEMENTS = (1 << 20, 1 << 26)


def bwd_flavor(b: int, t: int, f: int, c: int) -> str:
    """Which backward ``bwd="auto"`` runs at a geometry: ``"fused"`` (dy never
    written, ``readout_bwd_fused``) or ``"materialize"`` (``readout_bwd_dy``
    and two ``torch.matmul``s).

    The rule is this card's, written from the backward segment's device-only
    times in ``chip_smoke.py --ab readout-bwd`` (``readout_bwd_stats`` +
    ``readout_bwd_fused`` against ``readout_bwd_stats`` + ``readout_bwd_dy`` +
    the two products, bf16, replayed CUDA graphs, two turns each; NVIDIA H100
    80GB HBM3, 700.00 W):

        (B, T, F, C)              dy-free ms         materializing ms
        (2, 37, 64, 300)          0.073 - 0.074      0.042 - 0.043
        (3, 50, 64, 1100)         0.084              0.056
        (4, 200, 128, 5120)       0.241 - 0.254      0.299 - 0.300
        (16, 200, 128, 5120)      0.393 - 0.395      0.440 - 0.442
        (16, 200, 128, 95008)     2.748 - 2.802      1.856
        (16, 200, 1024, 95008)    4.825 - 4.879      3.168 - 3.386

    The dy-free kernel recomputes every dy element once in each of its two
    passes and moves y and x twice; the materializing segment writes dy once
    and reads it back twice at the memory's rate. On the tiny maps launches
    and a pass's start-up latency set both times and the three launches of
    the materializing segment are shorter; at C = 95008 the recomputation
    (and at F = 1024 the products) keep the dy-free kernel behind; in
    between it wins. At the flagship geometry the answer is "materialize",
    as the JAX rule's is (for a TPU reason: its dh accumulator does not fit
    VMEM). The bf16 products take F a multiple of 64."""
    if f % BF16_K_STEP:
        return "materialize"
    lo, hi = FUSED_BWD_ELEMENTS
    return "fused" if lo <= b * t * c <= hi else "materialize"


def _resolve_bwd(bwd: str, b: int, t: int, f: int, c: int) -> str:
    if bwd == "auto":
        return bwd_flavor(b, t, f, c)
    if bwd not in BWD_FLAVORS:
        raise ValueError(f"bwd must be 'auto', 'fused' or 'materialize', got {bwd!r}")
    return bwd


# -- elementwise losses -------------------------------------------------------

def _loss_code(lossfun: str) -> int:
    if lossfun not in _LOSS_CODES:
        raise ValueError(f"unsupported fused lossfun '{lossfun}'")
    return _LOSS_CODES[lossfun]


def elem_loss(o: torch.Tensor, x: torch.Tensor, lossfun: str) -> torch.Tensor:
    d = o - x
    code = _loss_code(lossfun)
    if code == 0:
        return d * d
    ad = d.abs()
    if code == 1:
        return ad
    return torch.where(ad < 1.0, 0.5 * ad * ad, ad - 0.5)


def elem_loss_grad(o: torch.Tensor, x: torch.Tensor, lossfun: str) -> torch.Tensor:
    """d elem_loss / d o."""
    d = o - x
    code = _loss_code(lossfun)
    if code == 0:
        return 2.0 * d
    s = torch.sign(d)
    if code == 1:
        return s
    return torch.where(d.abs() < 1.0, d, s)


# -- plain versions, one per kernel -------------------------------------------

def matmul_stats_reference(h, kernel, bias, inv_sigma, num_groups: int,
                           eps: float = 1e-5):
    """Plain version of ``readout_matmul_stats`` (the JAX
    ``_matmul_stats_kernel`` and the finalize after it): ``(y [B, T, C] in
    h's dtype, stats [B, 2, G] f32)``. The product accumulates in f32; the
    scale and the f32 bias are applied before the one rounding; the
    statistics are those of the rounded y."""
    b, t, _ = h.shape
    c = kernel.shape[0]
    yr = torch.matmul(h.float(), kernel.float().t())
    y = (yr * inv_sigma.float() + bias.float()).to(h.dtype)
    yf = y.float()
    denom = float(t * (c // num_groups))
    mean = _group_sums(yf, num_groups) / denom
    var = _group_sums(yf * yf, num_groups) / denom - mean * mean
    inv_std = torch.rsqrt(var.clamp_min(0.0) + eps)
    return y, torch.stack([mean, inv_std], dim=1)


def _recompute(y, x, scale, norm_bias, stats):
    """xn and o = tanh(xn * scale + norm_bias), f32 ``[B, T, C]``."""
    c = y.shape[2]
    xn = (y.float() - _expand(stats[:, 0], c)) * _expand(stats[:, 1], c)
    return xn, torch.tanh(xn * scale.float() + norm_bias.float())


def loss_reference(y, x, scale, norm_bias, stats, num_groups: int,
                   lossfun: str = "MSE") -> torch.Tensor:
    """Plain version of ``readout_loss`` (the JAX ``_loss_kernel`` and the sum
    of its partials): f32 ``[2]`` of (sum of elem_loss, sum of squared error)
    over the whole map."""
    _, o = _recompute(y, x, scale, norm_bias, stats)
    x32 = x.float()
    return torch.stack([elem_loss(o, x32, lossfun).sum(), ((o - x32) ** 2).sum()])


def _bwd_terms(y, x, scale, norm_bias, stats, g, n_elem, lossfun):
    """xn and da = dL/do * (1 - o^2) (the JAX ``_bwd_common``); ``g`` holds the
    cotangents of (loss, mse) in its first two entries."""
    xn, o = _recompute(y, x, scale, norm_bias, stats)
    x32 = x.float()
    dl_do = (g[0] * elem_loss_grad(o, x32, lossfun) + g[1] * 2.0 * (o - x32)) / n_elem
    return xn, dl_do * (1.0 - o * o)


def bwd_stats_reference(y, x, scale, norm_bias, stats, g, n_elem: float,
                        num_groups: int, lossfun: str = "MSE"):
    """Plain version of ``readout_bwd_stats`` (the JAX ``_bwd_stats_kernel``
    with the tile sum and the division after it): ``(msums [B, 2, G] of the
    group means of dxn and dxn * xn, d scale partials [B, C], d norm_bias
    partials [B, C])``, all f32."""
    _, t, c = y.shape
    xn, da = _bwd_terms(y, x, scale, norm_bias, stats, g, n_elem, lossfun)
    dxn = da * scale.float()
    denom = float(t * (c // num_groups))
    msums = torch.stack([_group_sums(dxn, num_groups),
                         _group_sums(dxn * xn, num_groups)], dim=1) / denom
    return msums, (da * xn).sum(dim=1), da.sum(dim=1)


def bwd_dy_reference(y, x, scale, norm_bias, bias, stats, msums, g, n_elem: float,
                     num_groups: int, lossfun: str = "MSE"):
    """Plain version of ``readout_bwd_dy`` (the JAX ``_bwd_dy_kernel``):
    ``(dy [B, T, C] in y's dtype, d bias partials [B, C] f32, d inv_sigma
    partials [B] f32)``; ``g`` is (cotangent of loss, of mse, inv_sigma)."""
    c = y.shape[2]
    xn, da = _bwd_terms(y, x, scale, norm_bias, stats, g, n_elem, lossfun)
    dy = (da * scale.float() - _expand(msums[:, 0], c)
          - xn * _expand(msums[:, 1], c)) * _expand(stats[:, 1], c)
    yr = (y.float() - bias.float()) / g[2]
    return dy.to(y.dtype), dy.sum(dim=1), (dy * yr).sum(dim=(1, 2))


def bwd_fused_reference(y, x, scale, norm_bias, bias, h, kernel, stats, msums, g,
                        n_elem: float, num_groups: int, lossfun: str = "MSE"):
    """Plain version of ``readout_bwd_fused`` (the JAX ``_bwd_fused_dw_kernel``):
    ``(dW_p [C, F] f32, dh_p [B, T, F] f32, d bias [C] f32, d inv_sigma 0-d
    f32)``, dW_p and dh_p before the ``inv_sigma`` scaling. As in the kernel,
    dy is rounded to the map's dtype before both products (which accumulate in
    f32), while d bias and d inv_sigma sum the f32 dy. ``g`` is (cotangent of
    loss, of mse, inv_sigma)."""
    b, t, c = y.shape
    f = h.shape[2]
    xn, da = _bwd_terms(y, x, scale, norm_bias, stats, g, n_elem, lossfun)
    dy = (da * scale.float() - _expand(msums[:, 0], c)
          - xn * _expand(msums[:, 1], c)) * _expand(stats[:, 1], c)
    del xn, da
    dbias = dy.sum(dim=(0, 1))
    # summed in f64, as the kernel's threads do: the terms cancel to a small rest
    dinv = (dy.double() * ((y.float() - bias.float()) / g[2])).sum().float()
    dy_lo = dy.to(y.dtype).float().reshape(b * t, c)
    del dy
    dw_p = torch.matmul(dy_lo.t(), h.float().reshape(b * t, f))
    dh_p = torch.matmul(dy_lo, kernel.float()).reshape(b, t, f)
    return dw_p, dh_p, dbias, dinv


def readout_chain_loss_reference(h, kernel, bias, scale, norm_bias, x_target,
                                 inv_sigma, num_groups: int, eps: float = 1e-5,
                                 lossfun: str = "MSE"):
    """The unfused composition (matmul, GroupNorm + tanh, mean losses) under
    autograd: what the fused op must equal, values and gradients."""
    from simulgen_vae_tpu_torch.ops.groupnorm_gelu import group_norm_act_reference

    y = torch.matmul(h, kernel.to(h.dtype).t()).float()
    y = (y * inv_sigma.float() + bias.float()).to(h.dtype)
    o = group_norm_act_reference(y, scale, norm_bias, num_groups, eps, act="tanh").float()
    x32 = x_target.float()
    return elem_loss(o, x32, lossfun).mean(), ((o - x32) ** 2).mean()


# -- kernel wrappers ----------------------------------------------------------

def _check_f32(v: torch.Tensor, shape, device, what: str) -> None:
    if (v.device != device or v.dtype != torch.float32 or tuple(v.shape) != tuple(shape)
            or not v.is_contiguous()):
        raise ValueError(f"{what} must be a contiguous float32 {list(shape)} tensor "
                         f"on {device}")


def _check_aligned(what: str, *tensors: torch.Tensor) -> None:
    """The kernels load 16 bytes at a time from the start of a row."""
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{what} must start on a 16-byte boundary")


def _check_chain(y, x, scale, norm_bias, stats, num_groups) -> None:
    _check_map(y, num_groups)
    _check_like(x, y, "x")
    _check_aligned("y and x", y, x)
    _check_vec(scale, y, "scale")
    _check_vec(norm_bias, y, "norm_bias")
    _check_stats(stats, y, num_groups, "stats")


def flat_tiles(b: int, t: int, c: int, tile_m: int = BF16_TILE_M,
               tile_n: int = BF16_TILE_N) -> tuple[int, int, int]:
    """``(row tiles, column tiles, sample slots)`` of the bf16 product, whose
    row tiles run over the ``b * t`` rows across sample boundaries: a tile of
    ``tile_m`` rows touches at most ``ceil((tile_m - 1) / t) + 1`` samples
    (and no more than ``b``), and its partials keep one slot for each."""
    return (-(-(b * t) // tile_m), -(-c // tile_n),
            min(b, -(-(tile_m - 1) // t) + 1))


def slot_rows(tile: int, slot: int, b: int, t: int, tile_m: int = BF16_TILE_M) -> range:
    """The flattened rows whose statistics go to ``(tile, slot)``: the rows
    of sample ``tile * tile_m // t + slot`` inside the tile (none where the
    tile ends first)."""
    m0 = tile * tile_m
    sample = m0 // t + slot
    rows = range(max(sample * t, m0), min((sample + 1) * t, m0 + tile_m, b * t))
    return rows if len(rows) else range(m0, m0)


def slot_table(b: int, t: int, tile_m: int = BF16_TILE_M) -> torch.Tensor:
    """int32 ``[row tiles, slots, 3]``: (sample, first row, end row) of the
    flattened rows each sample slot of each row tile holds (:func:`slot_rows`),
    sample -1 where it holds none. The bf16 kernel reads it as it is: its
    epilogue adds each slot's rows into the slot's partial, its finalize adds
    per sample the partials of the slots that name it."""
    row_tiles, _, slots = flat_tiles(b, t, 1, tile_m)
    table = [[[rows.start // t if len(rows) else -1, rows.start, rows.stop]
              for rows in (slot_rows(tile, slot, b, t, tile_m) for slot in range(slots))]
             for tile in range(row_tiles)]
    return torch.tensor(table, dtype=torch.int32)


_SLOT_TABLES: dict = {}


def _slot_table_on(device: torch.device, b: int, t: int, tile_m: int) -> torch.Tensor:
    """:func:`slot_table` on the card, copied there once per shape."""
    key = (device, b, t, tile_m)
    if key not in _SLOT_TABLES:
        _SLOT_TABLES[key] = slot_table(b, t, tile_m).to(device)
    return _SLOT_TABLES[key]


def readout_matmul_stats(h: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                         inv_sigma: torch.Tensor, num_groups: int, eps: float = 1e-5):
    """``(y, stats)`` from ``h`` [B, T, F] and ``kernel`` [C, F], both in the
    compute dtype (kernel ``readout_matmul_stats``). In bf16 the product runs
    on the tensor cores (wgmma fed by TMA) with f32 accumulation over row
    tiles of the flattened B*T rows (:func:`flat_tiles`, :func:`slot_table`)
    and needs F to be a multiple of 64; in f32 it accumulates with plain f32
    FMAs (never TF32)."""
    if h.device.type == "cpu":
        return matmul_stats_reference(h, kernel, bias, inv_sigma, num_groups, eps)
    if h.device.type != "cuda":
        raise ValueError(f"expected a CUDA tensor, got h on {h.device}")
    if h.dim() != 3 or not h.is_contiguous() or h.dtype not in _DTYPE_CODES:
        raise ValueError(f"h must be a contiguous float32 or bfloat16 [B, T, F] tensor, "
                         f"got {h.dtype} {tuple(h.shape)}")
    b, t, f = h.shape
    if (kernel.device != h.device or kernel.dtype != h.dtype or kernel.dim() != 2
            or kernel.shape[1] != f or not kernel.is_contiguous()):
        raise ValueError(f"kernel must be a contiguous {h.dtype} [C, {f}] tensor on "
                         f"{h.device}, got {kernel.dtype} {tuple(kernel.shape)}")
    c = kernel.shape[0]
    if num_groups <= 0 or c % num_groups:
        raise ValueError(f"{c} channels do not split into {num_groups} groups")
    code = _DTYPE_CODES[h.dtype]
    tile = _fn("readout_matmul_stats", "readout_matmul_stats_tile", [_I, _I])
    if h.dtype == torch.bfloat16:
        if f % BF16_K_STEP:
            raise ValueError(f"the bf16 product takes F a multiple of {BF16_K_STEP}, got "
                             f"h {tuple(h.shape)}, kernel {tuple(kernel.shape)}")
        _check_aligned("h and kernel", h, kernel)
        row_tiles, col_tiles, slots = flat_tiles(b, t, c, tile(code, 0), tile(code, 1))
        part_shape = (row_tiles, col_tiles, slots, 2, num_groups)
        table = _ptr(_slot_table_on(h.device, b, t, tile(code, 0)))
    else:
        row_tiles, col_tiles, slots = -(-t // tile(code, 0)), -(-c // tile(code, 1)), 1
        if col_tiles > 65535:
            raise ValueError(f"C = {c} gives {col_tiles} column tiles, above 65535")
        part_shape = (b, row_tiles, col_tiles, 2, num_groups)
        table = None
    _check_f32(bias, (c,), h.device, "bias")
    _check_f32(inv_sigma, (), h.device, "inv_sigma")
    fn = _fn("readout_matmul_stats", "readout_matmul_stats",
             [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I, _P, _P])
    y = torch.empty((b, t, c), device=h.device, dtype=h.dtype)
    partials = torch.empty(part_shape, device=h.device, dtype=torch.float32)
    stats = torch.empty((b, 2, num_groups), device=h.device, dtype=torch.float32)
    with torch.cuda.device(h.device):
        err = fn(_ptr(h), _ptr(kernel), _ptr(bias), _ptr(inv_sigma), _ptr(y),
                 _ptr(partials), _ptr(stats), b, t, f, c, num_groups, eps, code, slots,
                 table, _stream(h))
    _raise_on(err, "readout_matmul_stats")
    LAUNCHES["readout_matmul_stats"] += 1
    return y, stats


def readout_loss(y: torch.Tensor, x: torch.Tensor, scale: torch.Tensor,
                 norm_bias: torch.Tensor, stats: torch.Tensor, num_groups: int,
                 lossfun: str = "MSE") -> torch.Tensor:
    """f32 ``[2]``: the sums over the map of the configured loss and of the
    squared error of ``tanh(GroupNorm(y))`` against ``x`` (kernel
    ``readout_loss``; its per-block partials are added in order here)."""
    if y.device.type == "cpu":
        return loss_reference(y, x, scale, norm_bias, stats, num_groups, lossfun)
    _check_chain(y, x, scale, norm_bias, stats, num_groups)
    b, t, c = y.shape
    code = _DTYPE_CODES[y.dtype]
    blocks = _fn("readout_loss", "readout_loss_blocks", [_I, _I, _I])(t, c, code)
    fn = _fn("readout_loss", "readout_loss",
             [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P])
    partials = torch.empty((b, blocks, 2), device=y.device, dtype=torch.float32)
    with torch.cuda.device(y.device):
        err = fn(_ptr(y), _ptr(x), _ptr(scale), _ptr(norm_bias), _ptr(stats),
                 _ptr(partials), b, t, c, num_groups, code, _loss_code(lossfun),
                 _stream(y))
    _raise_on(err, "readout_loss")
    LAUNCHES["readout_loss"] += 1
    return partials.sum(dim=(0, 1))


def readout_bwd_stats(y, x, scale, norm_bias, stats, g, n_elem: float,
                      num_groups: int, lossfun: str = "MSE"):
    """Backward phase A (kernel ``readout_bwd_stats``): ``(msums [B, 2, G],
    d scale partials [B, C], d norm_bias partials [B, C])``, all f32. ``g`` is
    an f32 device vector whose first two entries are the cotangents of
    (loss, mse)."""
    if y.device.type == "cpu":
        return bwd_stats_reference(y, x, scale, norm_bias, stats, g, n_elem,
                                   num_groups, lossfun)
    _check_chain(y, x, scale, norm_bias, stats, num_groups)
    _check_f32(g, (3,), y.device, "g")
    b, t, c = y.shape
    code = _DTYPE_CODES[y.dtype]
    tiles = _fn("readout_bwd_stats", "readout_bwd_stats_tiles", [_I, _I])(c, code)
    fn = _fn("readout_bwd_stats", "readout_bwd_stats",
             [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _F, _I, _I, _I, _I, _I, _I, _P])
    partials = torch.empty((b, tiles, 2, num_groups), device=y.device,
                           dtype=torch.float32)
    msums = torch.empty((b, 2, num_groups), device=y.device, dtype=torch.float32)
    dscale_p = torch.empty((b, c), device=y.device, dtype=torch.float32)
    dnb_p = torch.empty((b, c), device=y.device, dtype=torch.float32)
    with torch.cuda.device(y.device):
        err = fn(_ptr(y), _ptr(x), _ptr(scale), _ptr(norm_bias), _ptr(stats), _ptr(g),
                 _ptr(partials), _ptr(msums), _ptr(dscale_p), _ptr(dnb_p),
                 float(n_elem), b, t, c, num_groups, code, _loss_code(lossfun),
                 _stream(y))
    _raise_on(err, "readout_bwd_stats")
    LAUNCHES["readout_bwd_stats"] += 1
    return msums, dscale_p, dnb_p


def readout_bwd_dy(y, x, scale, norm_bias, bias, stats, msums, g, n_elem: float,
                   num_groups: int, lossfun: str = "MSE"):
    """Backward phase B (kernel ``readout_bwd_dy``): ``(dy in y's dtype,
    d bias partials [B, C] f32, d inv_sigma partials [B] f32)``. ``g`` is the
    f32 device vector (cotangent of loss, of mse, inv_sigma)."""
    if y.device.type == "cpu":
        return bwd_dy_reference(y, x, scale, norm_bias, bias, stats, msums, g, n_elem,
                                num_groups, lossfun)
    _check_chain(y, x, scale, norm_bias, stats, num_groups)
    b, t, c = y.shape
    _check_vec(bias, y, "bias")
    _check_stats(msums, y, num_groups, "msums")
    _check_f32(g, (3,), y.device, "g")
    code = _DTYPE_CODES[y.dtype]
    tiles = _fn("readout_bwd_dy", "readout_bwd_dy_tiles", [_I, _I])(c, code)
    fn = _fn("readout_bwd_dy", "readout_bwd_dy",
             [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _F, _I, _I, _I, _I, _I, _I, _P])
    dy = torch.empty_like(y)
    dbias_p = torch.empty((b, c), device=y.device, dtype=torch.float32)
    dinv_p = torch.empty((b, tiles), device=y.device, dtype=torch.float32)
    with torch.cuda.device(y.device):
        err = fn(_ptr(y), _ptr(x), _ptr(scale), _ptr(norm_bias), _ptr(bias), _ptr(stats),
                 _ptr(msums), _ptr(g), _ptr(dy), _ptr(dbias_p), _ptr(dinv_p),
                 float(n_elem), b, t, c, num_groups, code, _loss_code(lossfun),
                 _stream(y))
    _raise_on(err, "readout_bwd_dy")
    LAUNCHES["readout_bwd_dy"] += 1
    return dy, dbias_p, dinv_p.sum(dim=1)


def readout_bwd_fused(y, x, scale, norm_bias, bias, h, kernel, stats, msums, g,
                      n_elem: float, num_groups: int, lossfun: str = "MSE"):
    """Backward phase B without dy (kernel ``readout_bwd_fused``): ``(dW_p
    [C, F], dh_p [B, T, F], d bias [C], d inv_sigma 0-d)``, all f32, dW_p and
    dh_p before the ``inv_sigma`` scaling. ``h`` [B, T, F] and ``kernel``
    [C, F] are in the map's dtype; ``g`` is the f32 device vector (cotangent
    of loss, of mse, inv_sigma). In bf16 both products run on the tensor cores
    (``wgmma`` fed by TMA, dy shared across a cluster: :func:`bwd_fused_cluster`)
    with f32 accumulation and need F to be a multiple of 64; in f32 they
    accumulate with plain f32 FMAs (never TF32)."""
    if y.device.type == "cpu":
        return bwd_fused_reference(y, x, scale, norm_bias, bias, h, kernel, stats, msums,
                                   g, n_elem, num_groups, lossfun)
    _check_chain(y, x, scale, norm_bias, stats, num_groups)
    b, t, c = y.shape
    _check_vec(bias, y, "bias")
    _check_stats(msums, y, num_groups, "msums")
    _check_f32(g, (3,), y.device, "g")
    if (h.device != y.device or h.dtype != y.dtype or h.dim() != 3
            or tuple(h.shape[:2]) != (b, t) or not h.is_contiguous()):
        raise ValueError(f"h must be a contiguous {y.dtype} [{b}, {t}, F] tensor on "
                         f"{y.device}, got {h.dtype} {tuple(h.shape)}")
    f = h.shape[2]
    if (kernel.device != y.device or kernel.dtype != y.dtype
            or tuple(kernel.shape) != (c, f) or not kernel.is_contiguous()):
        raise ValueError(f"kernel must be a contiguous {y.dtype} [{c}, {f}] tensor on "
                         f"{y.device}, got {kernel.dtype} {tuple(kernel.shape)}")
    if y.dtype == torch.bfloat16 and f % BF16_K_STEP:
        raise ValueError(f"the bf16 products take F a multiple of {BF16_K_STEP}, got "
                         f"h {tuple(h.shape)}, kernel {tuple(kernel.shape)}")
    _check_aligned("h, kernel, scale, norm_bias and bias", h, kernel, scale, norm_bias, bias)
    code = _DTYPE_CODES[y.dtype]
    geom = (b, t, f, c, code)
    # the bf16 plan asks the card how many clusters it holds: a negative
    # answer is a cudaError_t
    tiles = _fn("readout_bwd_fused", "readout_bwd_fused_tiles", [_I] * 5)(*geom)
    scratch_floats = _fn("readout_bwd_fused", "readout_bwd_fused_scratch", [_I] * 5)(*geom)
    _raise_on(-min(tiles, scratch_floats, 0), "readout_bwd_fused")
    fn = _fn("readout_bwd_fused", "readout_bwd_fused",
             [_P] * 15 + [_F] + [_I] * 7 + [_P])
    dw_p = torch.empty((c, f), device=y.device, dtype=torch.float32)
    dh_p = torch.empty((b, t, f), device=y.device, dtype=torch.float32)
    dbias = torch.empty((c,), device=y.device, dtype=torch.float32)
    dinv_p = torch.empty((tiles,), device=y.device, dtype=torch.float32)
    # partial outputs of the passes whose loop is cut into slabs, and in bf16
    # the (slab, rank) partials of d bias
    scratch = torch.empty((max(scratch_floats, 1),), device=y.device, dtype=torch.float32)
    with torch.cuda.device(y.device):
        err = fn(_ptr(y), _ptr(x), _ptr(scale), _ptr(norm_bias), _ptr(bias), _ptr(h),
                 _ptr(kernel), _ptr(stats), _ptr(msums), _ptr(g), _ptr(dw_p), _ptr(dh_p),
                 _ptr(dbias), _ptr(dinv_p), _ptr(scratch), float(n_elem), b, t, f, c,
                 num_groups, code, _loss_code(lossfun), _stream(y))
    _raise_on(err, "readout_bwd_fused")
    LAUNCHES["readout_bwd_fused"] += 1
    return dw_p, dh_p, dbias, dinv_p.sum()


# -- the op -------------------------------------------------------------------

class ReadoutChainLoss(torch.autograd.Function):
    """``(loss, mse)`` means whose backward is the kernels' (the JAX
    ``custom_vjp``). Saves the inputs, y and the statistics; ``x_hat`` and the
    f32 temporaries of the loss never exist."""

    @staticmethod
    def forward(ctx, h, kernel, bias, scale, norm_bias, x_target, inv_sigma,
                num_groups, eps, lossfun, bwd):
        h = h.contiguous()
        w = kernel.to(h.dtype)
        x = x_target.to(h.dtype).contiguous()
        inv = inv_sigma.detach().float()
        y, stats = readout_matmul_stats(h, w, bias, inv, num_groups, eps)
        sums = readout_loss(y, x, scale, norm_bias, stats, num_groups, lossfun)
        ctx.save_for_backward(h, w, bias, scale, norm_bias, x, inv, y, stats)
        ctx.cfg = (num_groups, lossfun, kernel.dtype, bwd)
        means = sums / float(y.numel())
        return means[0], means[1]

    @staticmethod
    def backward(ctx, gl, gm):
        h, w, bias, scale, norm_bias, x, inv, y, stats = ctx.saved_tensors
        num_groups, lossfun, kernel_dtype, bwd = ctx.cfg
        b, t, f = h.shape
        c = w.shape[0]
        n_elem = float(y.numel())
        g = torch.stack([gl.float(), gm.float(), inv])
        msums, dscale_p, dnb_p = readout_bwd_stats(y, x, scale, norm_bias, stats, g,
                                                   n_elem, num_groups, lossfun)
        # dy is the gradient of yr * inv + bias: inv scales the products' outputs
        # ([C, F] and [B, T, F]), not the [B, T, C] map.
        if bwd == "fused":
            dw_p, dh_p, dbias, dinv = readout_bwd_fused(y, x, scale, norm_bias, bias, h, w,
                                                        stats, msums, g, n_elem, num_groups,
                                                        lossfun)
            d_kernel = (dw_p * inv).to(kernel_dtype)
            dh = (dh_p * inv).to(h.dtype)
        else:
            dy, dbias_p, dinv_p = readout_bwd_dy(y, x, scale, norm_bias, bias, stats, msums,
                                                 g, n_elem, num_groups, lossfun)
            dy2 = dy.reshape(b * t, c)
            d_kernel = torch.matmul(dy2.t(), h.reshape(b * t, f)).to(kernel_dtype) * inv
            dh = (torch.matmul(dy2, w).float() * inv).to(h.dtype).reshape(b, t, f)
            dbias, dinv = dbias_p.sum(dim=0), dinv_p.sum()
        return (dh, d_kernel, dbias, dscale_p.sum(dim=0), dnb_p.sum(dim=0),
                None, dinv, None, None, None, None)


def readout_chain_loss(h: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                       scale: torch.Tensor, norm_bias: torch.Tensor,
                       x_target: torch.Tensor, inv_sigma: torch.Tensor,
                       num_groups: int, eps: float = 1e-5, lossfun: str = "MSE",
                       bwd: str = "auto"):
    """Fused train-path readout: ``(recon_loss, recon_mse)`` means as 0-d f32
    tensors, ``x_hat`` never written. ``h`` [B, T, F] sets the compute dtype
    (``kernel`` [C, F] and ``x_target`` are cast to it); bias, scale and
    norm_bias are f32 ``[C]``; ``inv_sigma`` is a 0-d f32 tensor. ``bwd``
    picks the backward: ``"fused"`` (dy never written), ``"materialize"``, or
    ``"auto"`` (:func:`bwd_flavor` of the geometry)."""
    _loss_code(lossfun)
    if h.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no readout kernel for device {h.device}")
    flavor = _resolve_bwd(bwd, h.shape[0], h.shape[1], h.shape[2], kernel.shape[0])
    return ReadoutChainLoss.apply(h, kernel, bias, scale, norm_bias, x_target,
                                  inv_sigma, num_groups, eps, lossfun, flavor)
