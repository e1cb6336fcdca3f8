"""GroupNorm + activation over ``[B, T, C]`` maps: CUDA kernels and plain versions.

Counterpart of ``simulgen_vae_tpu/ops/groupnorm_gelu.py``. Per sample,
GroupNorm takes statistics over (T x the group's channels) in f32, then the
affine, then ``gelu`` (exact erf), ``tanh`` or ``none``; the result has x's
dtype. Three hand-written kernels (``ops/csrc/``) compute it on the card:

* ``gn_act_onepass``: the whole sample in shared memory, for maps that fit
  (:func:`onepass_fits`);
* ``gn_stats`` then ``gn_apply``: two passes for wider maps, such as the
  95008-channel readout with 11876-wide groups.

:func:`group_norm_act` dispatches: a CPU tensor goes to the plain version, a
CUDA tensor to the kernels, anything else raises. There is no fallback from a
kernel to the plain version. Each kernel wrapper counts its launches in
:data:`LAUNCHES`, so a run can show which kernels it went through.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from simulgen_vae_tpu_torch.ops import _build

LAUNCHES = {"gn_act_onepass": 0, "gn_stats": 0, "gn_apply": 0}

# Largest dynamic shared memory one block may opt into on an H100 (227 KB).
ONEPASS_SMEM_LIMIT = 232448

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


# -- kernel wrappers ----------------------------------------------------------

def onepass_smem_bytes(t: int, c: int, num_groups: int, elem_bytes: int) -> int:
    """Shared memory of one ``gn_act_onepass`` block (mirrors the kernel's
    ``stage_offset`` plus the staged sample)."""
    head = (2 * c + 2 * num_groups) * 4
    return ((head + 15) // 16) * 16 + t * c * elem_bytes


def onepass_fits(t: int, c: int, num_groups: int, elem_bytes: int) -> bool:
    """Engage rule of the one-pass kernel: the sample, staged in its own
    dtype, plus column and group statistics fit one block's shared memory.
    At T = 200: C <= 256 in f32, C <= 512 in bf16."""
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


def gn_act_onepass(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   num_groups: int, eps: float = 1e-5,
                   act: str = "gelu") -> torch.Tensor:
    """One-pass GroupNorm + activation (kernel ``gn_act_onepass``)."""
    if x.device.type == "cpu":
        return group_norm_act_reference(x, scale, bias, num_groups, eps, act)
    _check_map(x, num_groups)
    _check_vec(scale, x, "scale")
    _check_vec(bias, x, "bias")
    b, t, c = x.shape
    if not onepass_fits(t, c, num_groups, x.element_size()):
        raise ValueError(f"[T={t}, C={c}] {x.dtype} does not fit one block")
    fn = _fn("gn_act_onepass", "gn_act_onepass",
             [_P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _P])
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = fn(_ptr(x), _ptr(scale), _ptr(bias), _ptr(out), b, t, c,
                 num_groups, eps, _DTYPE_CODES[x.dtype], _act_code(act),
                 _stream(x))
    _raise_on(err, "gn_act_onepass")
    LAUNCHES["gn_act_onepass"] += 1
    return out


def gn_stats(x: torch.Tensor, num_groups: int, eps: float = 1e-5) -> torch.Tensor:
    """Group statistics ``[B, 2, G]`` f32 of (mean, inv) (kernel ``gn_stats``)."""
    if x.device.type == "cpu":
        return group_stats_reference(x, num_groups, eps)
    _check_map(x, num_groups)
    b, t, c = x.shape
    fn = _fn("gn_stats", "gn_stats", [_P, _P, _P, _I, _I, _I, _I, _F, _I, _P])
    tiles = _fn("gn_stats", "gn_stats_tiles", [_I])(c)
    partials = torch.empty((b, tiles, 2, num_groups), device=x.device,
                           dtype=torch.float32)
    stats = torch.empty((b, 2, num_groups), device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        err = fn(_ptr(x), _ptr(partials), _ptr(stats), b, t, c, num_groups,
                 eps, _DTYPE_CODES[x.dtype], _stream(x))
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
    if (stats.device != x.device or stats.dtype != torch.float32
            or tuple(stats.shape) != (b, 2, num_groups) or not stats.is_contiguous()):
        raise ValueError(f"stats must be a contiguous float32 [{b}, 2, {num_groups}] "
                         f"tensor on {x.device}")
    fn = _fn("gn_apply", "gn_apply",
             [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P])
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = fn(_ptr(x), _ptr(scale), _ptr(bias), _ptr(stats), _ptr(out), b, t,
                 c, num_groups, _DTYPE_CODES[x.dtype], _act_code(act), _stream(x))
    _raise_on(err, "gn_apply")
    LAUNCHES["gn_apply"] += 1
    return out


def group_norm_act(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   num_groups: int, eps: float = 1e-5,
                   act: str = "gelu") -> torch.Tensor:
    """GroupNorm + activation over ``[B, T, C]``: the plain version on the CPU,
    the one-pass kernel on the card where the sample fits one block, else
    ``gn_stats`` + ``gn_apply``."""
    if x.device.type == "cpu":
        return group_norm_act_reference(x, scale, bias, num_groups, eps, act)
    if x.device.type != "cuda":
        raise ValueError(f"no GroupNorm kernel for device {x.device}")
    _check_map(x, num_groups)
    if onepass_fits(x.shape[1], x.shape[2], num_groups, x.element_size()):
        return gn_act_onepass(x, scale, bias, num_groups, eps, act)
    return gn_apply(x, scale, bias, gn_stats(x, num_groups, eps), num_groups, act)
