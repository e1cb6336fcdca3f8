"""GroupNorm + activation over ``[B, T, C]`` maps: CUDA kernels and plain versions.

Counterpart of ``simulgen_vae_tpu/ops/groupnorm_gelu.py``. Per sample,
GroupNorm takes statistics over (T x the group's channels) in f32, then the
affine, then ``gelu`` (exact erf), ``tanh`` or ``none``; the result has x's
dtype. Hand-written kernels (``ops/csrc/``) compute it on the card.

Forward:

* ``gn_act_onepass``: each sample in the shared memory of one thread-block
  cluster of :data:`ONEPASS_CLUSTER` blocks (:func:`cluster_rows`), for maps
  whose whole sample would fit one block (:func:`onepass_fits`);
* ``gn_stats`` (one launch: a cluster of :data:`STATS_CLUSTER` blocks per
  sample over the column slices of :func:`cluster_columns`, the finalize in
  the kernel) then ``gn_apply``: two passes for wider maps, such as the
  95008-channel readout with 11876-wide groups.

Backward (the JAX ``custom_vjp`` of ``fused_group_norm_gelu`` and
``tiled_group_norm_gelu``), through :class:`GroupNormAct`:

* ``gn_bwd_onepass``: x and the incoming gradient of one sample in the
  shared memory of one cluster of :data:`ONEPASS_CLUSTER` blocks, rows split
  as in the forward (:func:`onepass_bwd_fits`: at T = 200 every map of the
  one-pass forward fits);
* ``gn_bwd_stats`` (one launch: a cluster of :data:`ONEPASS_CLUSTER` blocks
  per sample over the column slices of :func:`cluster_columns`) then
  ``gn_bwd_apply``: two passes for wider maps, with the
  statistics the two-phase forward saved. Where a one-pass forward's
  backward would not fit (not at T = 200), ``gn_stats`` recomputes them. The
  forward stays the serving forward, bit for bit.

:func:`group_norm_act` dispatches: a CPU tensor goes to the plain versions, a
CUDA tensor to the kernels, anything else raises. There is no fallback from a
kernel to the plain version. Each kernel wrapper counts its launches in
:data:`LAUNCHES`, so a run can show which kernels it went through.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from simulgen_vae_tpu_torch.ops import _build
from simulgen_vae_tpu_torch.utils import profiling

LAUNCHES = profiling.register({"gn_act_onepass": 0, "gn_stats": 0, "gn_apply": 0,
                               "gn_bwd_onepass": 0, "gn_bwd_stats": 0, "gn_bwd_apply": 0})

# Largest dynamic shared memory one block may opt into on an H100 (227 KB).
ONEPASS_SMEM_LIMIT = 232448
# Blocks in the cluster that holds one sample in gn_act_onepass (8 is the
# portable cluster size: 128 blocks at B = 16); gn_bwd_onepass and
# gn_bwd_stats are built for the same (their `kCluster`).
ONEPASS_CLUSTER = 8
# Blocks in gn_stats' cluster a sample (its `kCluster`) and the bytes its
# rank slices are aligned to: an H100 holds 17 clusters of 6 blocks that
# each take a whole SM at once but only 15 of 7 or 8, so at B = 16 every
# sample's cluster gets SMs of its own.
STATS_CLUSTER = 6
STATS_UNIT_BYTES = 128
# Threads of a gn_bwd_onepass block (its kThreads), which its shared memory
# counts.
_BWD_ONEPASS_THREADS = 512

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ACT_CODES = {"none": 0, "gelu": 1, "tanh": 2}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _activate(x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "gelu":
        return F.gelu(x)  # exact erf form
    if act == "tanh":
        return torch.tanh(x)
    if act == "none":
        return x
    raise ValueError(f"unknown activation '{act}'")


# -- plain versions -----------------------------------------------------------

def group_norm_act_reference(x: torch.Tensor, scale: torch.Tensor,
                             bias: torch.Tensor, num_groups: int,
                             eps: float = 1e-5, act: str = "gelu") -> torch.Tensor:
    """Plain GroupNorm([B,T,C], groups over C) -> activation (the JAX
    ``group_norm_gelu_reference``)."""
    b, t, c = x.shape
    xg = x.float().reshape(b, t, num_groups, c // num_groups)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = ((xg - mean) ** 2).mean(dim=(1, 3), keepdim=True)
    xn = ((xg - mean) * torch.rsqrt(var + eps)).reshape(b, t, c)
    out = xn * scale.float() + bias.float()
    return _activate(out, act).to(x.dtype)


def group_stats_reference(x: torch.Tensor, num_groups: int,
                          eps: float = 1e-5) -> torch.Tensor:
    """Plain version of ``gn_stats``: ``[B, 2, G]`` f32 of (mean, rsqrt(var + eps))."""
    b, t, c = x.shape
    xg = x.float().reshape(b, t, num_groups, c // num_groups)
    mean = xg.mean(dim=(1, 3))
    var = ((xg - mean[:, None, :, None]) ** 2).mean(dim=(1, 3))
    return torch.stack([mean, torch.rsqrt(var + eps)], dim=1)


def group_apply_reference(x: torch.Tensor, scale: torch.Tensor,
                          bias: torch.Tensor, stats: torch.Tensor,
                          num_groups: int, act: str = "gelu") -> torch.Tensor:
    """Plain version of ``gn_apply``: normalise with ``stats`` ([B, 2, G])."""
    b, t, c = x.shape
    xg = x.float().reshape(b, t, num_groups, c // num_groups)
    mean = stats[:, 0, None, :, None]
    inv = stats[:, 1, None, :, None]
    xn = ((xg - mean) * inv).reshape(b, t, c)
    out = xn * scale.float() + bias.float()
    return _activate(out, act).to(x.dtype)


def _act_grad(y: torch.Tensor, act: str) -> torch.Tensor:
    """d act(y) / dy (exact GELU's derivative for ``gelu``)."""
    if act == "gelu":
        return (0.5 * (1.0 + torch.erf(y * 0.7071067811865476))
                + y * 0.3989422804014327 * torch.exp(-0.5 * y * y))
    if act == "tanh":
        th = torch.tanh(y)
        return 1.0 - th * th
    if act == "none":
        return torch.ones_like(y)
    raise ValueError(f"unknown activation '{act}'")


def _bwd_terms(x, scale, bias, grad, mean, inv, num_groups, act):
    """xn, da = g * act'(y) and dxn = da * scale, all f32 ``[B, T, C]``;
    ``mean``/``inv`` are ``[B, G]``."""
    b, t, c = x.shape
    cg = c // num_groups
    xn = ((x.float().reshape(b, t, num_groups, cg) - mean[:, None, :, None])
          * inv[:, None, :, None]).reshape(b, t, c)
    y = xn * scale.float() + bias.float()
    da = grad.float() * _act_grad(y, act)
    return xn, da, da * scale.float()


def _group_sums(v: torch.Tensor, num_groups: int) -> torch.Tensor:
    """Per-(sample, group) sums of a ``[B, T, C]`` f32 map -> ``[B, G]``."""
    b, t, c = v.shape
    return v.reshape(b, t, num_groups, c // num_groups).sum(dim=(1, 3))


def _expand(v: torch.Tensor, c: int) -> torch.Tensor:
    """``[B, G]`` per-group values -> ``[B, 1, C]`` per column."""
    return v.repeat_interleave(c // v.shape[1], dim=1)[:, None, :]


def group_norm_act_backward_reference(x, scale, bias, grad, num_groups: int,
                                      eps: float = 1e-5, act: str = "gelu"):
    """Plain version of ``gn_bwd_onepass`` (the JAX ``_bwd_kernel``):
    statistics recomputed from x, then ``dx = (dxn - m1 - xn * m2) * inv``
    with m1, m2 the group means of dxn and dxn * xn. Returns
    ``(dx [B,T,C] in x's dtype, dscale [C] f32, dbias [C] f32)``."""
    stats = group_stats_reference(x, num_groups, eps)
    msums, dscale_p, dbias_p = gn_bwd_stats_reference(x, scale, bias, grad, stats,
                                                      num_groups, act)
    dx = gn_bwd_apply_reference(x, scale, bias, grad, stats, msums, num_groups, act)
    return dx, dscale_p.sum(dim=0), dbias_p.sum(dim=0)


def gn_bwd_stats_reference(x, scale, bias, grad, stats, num_groups: int,
                           act: str = "gelu"):
    """Plain version of ``gn_bwd_stats`` (the JAX ``_bwd_stats_kernel`` with
    the tile sum and the division that follow it): ``(msums [B, 2, G] f32 of
    (mean of dxn, mean of dxn * xn) per group, dscale partials [B, C],
    dbias partials [B, C])``."""
    b, t, c = x.shape
    xn, da, dxn = _bwd_terms(x, scale, bias, grad, stats[:, 0], stats[:, 1],
                             num_groups, act)
    denom = float(t * (c // num_groups))
    msums = torch.stack([_group_sums(dxn, num_groups),
                         _group_sums(dxn * xn, num_groups)], dim=1) / denom
    return msums, (da * xn).sum(dim=1), da.sum(dim=1)


def gn_bwd_apply_reference(x, scale, bias, grad, stats, msums, num_groups: int,
                           act: str = "gelu") -> torch.Tensor:
    """Plain version of ``gn_bwd_apply`` (the JAX ``_bwd_apply_kernel``):
    ``dx = (dxn - m1 - xn * m2) * inv`` in x's dtype."""
    c = x.shape[2]
    xn, _, dxn = _bwd_terms(x, scale, bias, grad, stats[:, 0], stats[:, 1],
                            num_groups, act)
    dx = (dxn - _expand(msums[:, 0], c) - xn * _expand(msums[:, 1], c)) \
        * _expand(stats[:, 1], c)
    return dx.to(x.dtype)


# -- kernel wrappers ----------------------------------------------------------

def onepass_smem_bytes(t: int, c: int, num_groups: int, elem_bytes: int) -> int:
    """Shared memory the whole sample takes in one block, with its column and
    group statistics: the measure of the engage rule, which sends a map to
    the one-pass route where this fits one block. A ``gn_act_onepass`` block
    holds the same head (the kernel's ``stage_offset``) and only its rank's
    rows (:func:`cluster_rows`), so it never needs more than this; the rule
    is narrower than the kernel needs (ROADMAP.md, Queue 2)."""
    head = (2 * c + 2 * num_groups) * 4
    return ((head + 15) // 16) * 16 + t * c * elem_bytes


def onepass_bwd_smem_bytes(t: int, c: int, num_groups: int, elem_bytes: int) -> int:
    """Shared memory of one ``gn_bwd_onepass`` block, the most any rank of
    its cluster of k = :data:`ONEPASS_CLUSTER` takes (mirrors the kernel's
    ``stage_offset``: four column vectors, the k ranks' two sets of group
    partials and their sums over the rank's ``ceil(c / k)`` columns, two
    group vectors and two floats for each of its 512 threads, then the rank's
    ``ceil(t / k)`` rows of x and of g, each map starting on a 16-byte
    boundary)."""
    def round16(v):
        return (v + 15) // 16 * 16

    k = ONEPASS_CLUSTER
    staged = -(-t // k) * c * elem_bytes
    head = (4 * c + 4 * k * num_groups + 2 * k * -(-c // k) + 2 * num_groups
            + 2 * _BWD_ONEPASS_THREADS) * 4
    return round16(head) + round16(staged) + staged


def onepass_bwd_fits(t: int, c: int, num_groups: int, elem_bytes: int) -> bool:
    """Engage rule of the one-pass backward: one rank's rows of x and of the
    gradient, staged in x's dtype, plus column and group sums fit one
    block's shared memory. At T = 200 (25 rows a rank): C <= 1840 in bf16,
    C <= 1018 in f32, so every map the one-pass forward takes fits."""
    return onepass_bwd_smem_bytes(t, c, num_groups, elem_bytes) <= ONEPASS_SMEM_LIMIT


def bwd_onepass_engages(t: int, c: int, num_groups: int, elem_bytes: int) -> bool:
    """Whether the backward takes ``gn_bwd_onepass``: the forward took the
    one-pass route (no saved statistics) and a rank's x and g fit one block.
    At T = 200 that is every map of the one-pass forward."""
    return (onepass_fits(t, c, num_groups, elem_bytes)
            and onepass_bwd_fits(t, c, num_groups, elem_bytes))


def onepass_fits(t: int, c: int, num_groups: int, elem_bytes: int) -> bool:
    """Engage rule of the one-pass kernel: the sample, staged in its own
    dtype, plus column and group statistics would fit one block's shared
    memory. At T = 200: C <= 256 in f32, C <= 512 in bf16."""
    return onepass_smem_bytes(t, c, num_groups, elem_bytes) <= ONEPASS_SMEM_LIMIT


def _check_map(x: torch.Tensor, num_groups: int) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"expected a CUDA tensor, got one on {x.device}")
    if x.dim() != 3:
        raise ValueError(f"expected [B, T, C], got shape {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"unsupported dtype {x.dtype} (float32 or bfloat16)")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if num_groups <= 0 or x.shape[2] % num_groups:
        raise ValueError(f"{x.shape[2]} channels do not split into {num_groups} groups")
    if x.shape[0] > 65535:
        raise ValueError("batch above 65535")


def _check_like(g: torch.Tensor, x: torch.Tensor, what: str) -> None:
    if (g.device != x.device or g.dtype != x.dtype or g.shape != x.shape
            or not g.is_contiguous()):
        raise ValueError(f"{what} must be a contiguous {x.dtype} {tuple(x.shape)} "
                         f"tensor on {x.device}")


def _check_stats(st: torch.Tensor, x: torch.Tensor, num_groups: int, what: str) -> None:
    b = x.shape[0]
    if (st.device != x.device or st.dtype != torch.float32
            or tuple(st.shape) != (b, 2, num_groups) or not st.is_contiguous()):
        raise ValueError(f"{what} must be a contiguous float32 [{b}, 2, {num_groups}] "
                         f"tensor on {x.device}")


def _check_vec(v: torch.Tensor, x: torch.Tensor, what: str) -> None:
    if (v.device != x.device or v.dtype != torch.float32
            or tuple(v.shape) != (x.shape[2],) or not v.is_contiguous()):
        raise ValueError(f"{what} must be a contiguous float32 [{x.shape[2]}] "
                         f"tensor on {x.device}")


def _act_code(act: str) -> int:
    if act not in _ACT_CODES:
        raise ValueError(f"unknown activation '{act}'")
    return _ACT_CODES[act]


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed with cudaError {err}")


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(x: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)


def _fn(lib_name: str, fn_name: str, argtypes):
    fn = getattr(_build.load(lib_name), fn_name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def cluster_rows(t: int, k: int = ONEPASS_CLUSTER) -> list[range]:
    """The rows of a sample that each of the ``k`` blocks of its cluster
    stages in ``gn_act_onepass``: ``ceil(t / k)`` contiguous rows per rank,
    clipped to ``t`` (ranks past the end hold none). The kernel takes this
    split as it is (:func:`_rank_begin`)."""
    per = -(-t // k)
    return [range(min(t, r * per), min(t, (r + 1) * per)) for r in range(k)]


@functools.lru_cache(maxsize=64)
def _rank_begin(t: int, k: int):
    """:func:`cluster_rows` as the kernel's argument: the first row of each
    rank, then ``t``."""
    return (ctypes.c_int * (k + 1))(*[r.start for r in cluster_rows(t, k)], t)


def gn_act_onepass(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   num_groups: int, eps: float = 1e-5,
                   act: str = "gelu") -> torch.Tensor:
    """One-pass GroupNorm + activation (kernel ``gn_act_onepass``): one
    cluster of :data:`ONEPASS_CLUSTER` blocks per sample, the statistics
    shared through distributed shared memory."""
    if x.device.type == "cpu":
        return group_norm_act_reference(x, scale, bias, num_groups, eps, act)
    _check_map(x, num_groups)
    _check_vec(scale, x, "scale")
    _check_vec(bias, x, "bias")
    b, t, c = x.shape
    if not onepass_fits(t, c, num_groups, x.element_size()):
        raise ValueError(f"[T={t}, C={c}] {x.dtype} does not fit one block")
    fn = _fn("gn_act_onepass", "gn_act_onepass",
             [_P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, ctypes.POINTER(_I), _I, _P])
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = fn(_ptr(x), _ptr(scale), _ptr(bias), _ptr(out), b, t, c,
                 num_groups, eps, _DTYPE_CODES[x.dtype], _act_code(act),
                 _rank_begin(t, ONEPASS_CLUSTER), ONEPASS_CLUSTER, _stream(x))
    _raise_on(err, "gn_act_onepass")
    LAUNCHES["gn_act_onepass"] += 1
    return out


def gn_stats(x: torch.Tensor, num_groups: int, eps: float = 1e-5) -> torch.Tensor:
    """Group statistics ``[B, 2, G]`` f32 of (mean, inv) (kernel ``gn_stats``,
    one launch: a cluster of :data:`STATS_CLUSTER` blocks per sample over
    the column slices of :func:`cluster_columns`, finalized in the kernel)."""
    if x.device.type == "cpu":
        return group_stats_reference(x, num_groups, eps)
    _check_map(x, num_groups)
    b, t, c = x.shape
    fn = _fn("gn_stats", "gn_stats",
             [_P, _P, _I, _I, _I, _I, _F, _I, ctypes.POINTER(_I), _P])
    stats = torch.empty((b, 2, num_groups), device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        err = fn(_ptr(x), _ptr(stats), b, t, c, num_groups, eps,
                 _DTYPE_CODES[x.dtype], stats_col_begin(c, x.element_size()), _stream(x))
    _raise_on(err, "gn_stats")
    LAUNCHES["gn_stats"] += 1
    return stats


def gn_apply(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
             stats: torch.Tensor, num_groups: int,
             act: str = "gelu") -> torch.Tensor:
    """Normalise with ``stats`` from :func:`gn_stats`, affine, activate
    (kernel ``gn_apply``)."""
    if x.device.type == "cpu":
        return group_apply_reference(x, scale, bias, stats, num_groups, act)
    _check_map(x, num_groups)
    _check_vec(scale, x, "scale")
    _check_vec(bias, x, "bias")
    b, t, c = x.shape
    _check_stats(stats, x, num_groups, "stats")
    fn = _fn("gn_apply", "gn_apply",
             [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P])
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = fn(_ptr(x), _ptr(scale), _ptr(bias), _ptr(stats), _ptr(out), b, t,
                 c, num_groups, _DTYPE_CODES[x.dtype], _act_code(act), _stream(x))
    _raise_on(err, "gn_apply")
    LAUNCHES["gn_apply"] += 1
    return out


def gn_bwd_onepass(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   grad: torch.Tensor, num_groups: int, eps: float = 1e-5,
                   act: str = "gelu"):
    """One-pass GroupNorm + activation backward (kernel ``gn_bwd_onepass``):
    one cluster of :data:`ONEPASS_CLUSTER` blocks per sample, each holding
    the rows :func:`cluster_rows` gives it. ``(dx, dscale, dbias)``; the
    per-sample dscale/dbias partials the kernel writes are summed over the
    batch here, in order."""
    if x.device.type == "cpu":
        return group_norm_act_backward_reference(x, scale, bias, grad, num_groups,
                                                 eps, act)
    _check_map(x, num_groups)
    _check_like(grad, x, "grad")
    _check_vec(scale, x, "scale")
    _check_vec(bias, x, "bias")
    b, t, c = x.shape
    if not onepass_bwd_fits(t, c, num_groups, x.element_size()):
        raise ValueError(f"[T={t}, C={c}] {x.dtype} backward does not fit one block")
    fn = _fn("gn_bwd_onepass", "gn_bwd_onepass",
             [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I,
              ctypes.POINTER(_I), _P])
    dx = torch.empty_like(x)
    dscale_p = torch.empty((b, c), device=x.device, dtype=torch.float32)
    dbias_p = torch.empty((b, c), device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        err = fn(_ptr(x), _ptr(scale), _ptr(bias), _ptr(grad), _ptr(dx),
                 _ptr(dscale_p), _ptr(dbias_p), b, t, c, num_groups, eps,
                 _DTYPE_CODES[x.dtype], _act_code(act),
                 _rank_begin(t, ONEPASS_CLUSTER), _stream(x))
    _raise_on(err, "gn_bwd_onepass")
    LAUNCHES["gn_bwd_onepass"] += 1
    return dx, dscale_p.sum(dim=0), dbias_p.sum(dim=0)


def cluster_columns(c: int, elem_bytes: int, k: int = ONEPASS_CLUSTER,
                    unit_bytes: int = 16) -> list[range]:
    """The columns of a sample that each of the k blocks of its cluster sums
    in ``gn_bwd_stats`` (k = :data:`ONEPASS_CLUSTER`, 16-byte units) and
    ``gn_stats`` (:data:`STATS_CLUSTER`, :data:`STATS_UNIT_BYTES`):
    contiguous slices of ``ceil(units / k)`` units of ``unit_bytes //
    elem_bytes`` columns, clipped to ``c`` (ranks past the end hold none).
    The kernels take this split as it is (:func:`_col_begin`)."""
    vec = unit_bytes // elem_bytes
    units = -(-c // vec)
    per = -(-units // k) * vec
    return [range(min(c, r * per), min(c, (r + 1) * per)) for r in range(k)]


bwd_stats_columns = cluster_columns


@functools.lru_cache(maxsize=64)
def _col_begin(c: int, elem_bytes: int, k: int = ONEPASS_CLUSTER, unit_bytes: int = 16):
    """:func:`cluster_columns` as the kernels' argument: the first column
    of each rank, then ``c``."""
    starts = [r.start for r in cluster_columns(c, elem_bytes, k, unit_bytes)]
    return (ctypes.c_int * (len(starts) + 1))(*starts, c)


def stats_col_begin(c: int, elem_bytes: int, k: int = STATS_CLUSTER):
    """``gn_stats``' column split for a cluster of k blocks (its build's
    ``kCluster``) as the kernel's argument."""
    return _col_begin(c, elem_bytes, k, STATS_UNIT_BYTES)


def gn_bwd_stats(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                 grad: torch.Tensor, stats: torch.Tensor, num_groups: int,
                 act: str = "gelu"):
    """Backward phase A (kernel ``gn_bwd_stats``, one launch: a cluster of
    :data:`ONEPASS_CLUSTER` blocks per sample over the column slices of
    :func:`cluster_columns`): ``(msums [B, 2, G], dscale partials [B, C],
    dbias partials [B, C])``, all f32."""
    if x.device.type == "cpu":
        return gn_bwd_stats_reference(x, scale, bias, grad, stats, num_groups, act)
    _check_map(x, num_groups)
    _check_like(grad, x, "grad")
    _check_vec(scale, x, "scale")
    _check_vec(bias, x, "bias")
    _check_stats(stats, x, num_groups, "stats")
    b, t, c = x.shape
    fn = _fn("gn_bwd_stats", "gn_bwd_stats",
             [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
              ctypes.POINTER(_I), _P])
    msums = torch.empty((b, 2, num_groups), device=x.device, dtype=torch.float32)
    dscale_p = torch.empty((b, c), device=x.device, dtype=torch.float32)
    dbias_p = torch.empty((b, c), device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        err = fn(_ptr(x), _ptr(scale), _ptr(bias), _ptr(grad), _ptr(stats),
                 _ptr(msums), _ptr(dscale_p), _ptr(dbias_p),
                 b, t, c, num_groups, _DTYPE_CODES[x.dtype], _act_code(act),
                 _col_begin(c, x.element_size()), _stream(x))
    _raise_on(err, "gn_bwd_stats")
    LAUNCHES["gn_bwd_stats"] += 1
    return msums, dscale_p, dbias_p


def gn_bwd_apply(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                 grad: torch.Tensor, stats: torch.Tensor, msums: torch.Tensor,
                 num_groups: int, act: str = "gelu") -> torch.Tensor:
    """Backward phase B (kernel ``gn_bwd_apply``): dx in x's dtype."""
    if x.device.type == "cpu":
        return gn_bwd_apply_reference(x, scale, bias, grad, stats, msums,
                                      num_groups, act)
    _check_map(x, num_groups)
    _check_like(grad, x, "grad")
    _check_vec(scale, x, "scale")
    _check_vec(bias, x, "bias")
    _check_stats(stats, x, num_groups, "stats")
    _check_stats(msums, x, num_groups, "msums")
    b, t, c = x.shape
    fn = _fn("gn_bwd_apply", "gn_bwd_apply",
             [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P])
    dx = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = fn(_ptr(x), _ptr(scale), _ptr(bias), _ptr(grad), _ptr(stats),
                 _ptr(msums), _ptr(dx), b, t, c, num_groups,
                 _DTYPE_CODES[x.dtype], _act_code(act), _stream(x))
    _raise_on(err, "gn_bwd_apply")
    LAUNCHES["gn_bwd_apply"] += 1
    return dx


def _forward(x, scale, bias, num_groups, eps, act):
    """The forward route: ``(out, stats or None)``."""
    if onepass_fits(x.shape[1], x.shape[2], num_groups, x.element_size()):
        return gn_act_onepass(x, scale, bias, num_groups, eps, act), None
    stats = gn_stats(x, num_groups, eps)
    return gn_apply(x, scale, bias, stats, num_groups, act), stats


class GroupNormAct(torch.autograd.Function):
    """GroupNorm + activation whose backward is the kernels' (the JAX
    ``custom_vjp``): the forward saves ``(x, scale, bias)`` and, on the
    two-phase route, the ``[B, 2, G]`` statistics."""

    @staticmethod
    def forward(ctx, x, scale, bias, num_groups, eps, act):
        out, stats = _forward(x, scale, bias, num_groups, eps, act)
        ctx.save_for_backward(x, scale, bias, stats)
        ctx.cfg = (num_groups, eps, act)
        return out

    @staticmethod
    def backward(ctx, grad):
        x, scale, bias, stats = ctx.saved_tensors
        num_groups, eps, act = ctx.cfg
        grad = grad.contiguous()
        if bwd_onepass_engages(x.shape[1], x.shape[2], num_groups, x.element_size()):
            dx, dscale, dbias = gn_bwd_onepass(x, scale, bias, grad, num_groups,
                                               eps, act)
        else:
            if stats is None:
                stats = gn_stats(x, num_groups, eps)
            msums, dscale_p, dbias_p = gn_bwd_stats(x, scale, bias, grad, stats,
                                                    num_groups, act)
            dx = gn_bwd_apply(x, scale, bias, grad, stats, msums, num_groups, act)
            dscale, dbias = dscale_p.sum(dim=0), dbias_p.sum(dim=0)
        return dx, dscale, dbias, None, None, None


def group_norm_act(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   num_groups: int, eps: float = 1e-5,
                   act: str = "gelu") -> torch.Tensor:
    """GroupNorm + activation over ``[B, T, C]``: the plain versions on the
    CPU, the one-pass kernel on the card where the sample fits one block,
    else ``gn_stats`` + ``gn_apply``. Where a gradient is wanted it goes
    through :class:`GroupNormAct`, whose backward is the kernels' too."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no GroupNorm kernel for device {x.device}")
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad
                                    or bias.requires_grad):
        return GroupNormAct.apply(x, scale, bias, num_groups, eps, act)
    if x.device.type == "cpu":
        return group_norm_act_reference(x, scale, bias, num_groups, eps, act)
    _check_map(x, num_groups)
    return _forward(x, scale, bias, num_groups, eps, act)[0]
