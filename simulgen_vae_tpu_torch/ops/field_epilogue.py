"""The served field's last step: the readout's GroupNorm apply, tanh and
the data scaler's inverse into the request's rows, the wrapper of
``ops/csrc/field_epilogue.cu``.

``gn_apply_field_epilogue(y, stats, gscale, gbias, min_, scale, out,
num_groups)`` starts from the readout product's pre-norm ``[B, T, N]`` map
(bf16 or f32): the GroupNorm apply with ``stats`` from ``gn_stats``, tanh,
rounding to y's dtype, then ``(float(v) - min_) / scale`` (the scaler's
``inverse_transform``), into ``out``, f32 rows that are usually a slice of
the request's output (the first ``out.shape[0]`` of y's: a padded chunk's
extra rows are never read). On the card that is one launch of the
hand-written kernel, one read of the map and one write of the field,
bit-equal to ``gn_apply(..., act="tanh")`` then the PyTorch descale; on the
CPU it is :func:`gn_apply_field_epilogue_reference`, that composition of the
plain versions. The checks are the same on both; a CUDA tensor takes the
kernel or raises. ``LAUNCHES["gn_apply_field_epilogue"]`` counts its
launches: the served path's, two a 128-field request in chunks of 64 on the
card.
"""

from __future__ import annotations

import ctypes

import torch

from simulgen_vae_tpu_torch.ops import _build
from simulgen_vae_tpu_torch.ops.groupnorm_gelu import group_apply_reference
from simulgen_vae_tpu_torch.utils import profiling

LAUNCHES = profiling.register({"gn_apply_field_epilogue": 0})

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def field_epilogue_reference(x: torch.Tensor, min_: torch.Tensor, scale: torch.Tensor,
                             out: torch.Tensor) -> torch.Tensor:
    """Plain version: ``(x.float() - min_) / scale``, as
    ``MinMaxScaler.inverse_transform`` computes it, written into ``out``."""
    return torch.div(x.float() - min_, scale, out=out)


def gn_apply_field_epilogue_reference(y: torch.Tensor, stats: torch.Tensor,
                                      gscale: torch.Tensor, gbias: torch.Tensor,
                                      min_: torch.Tensor, scale: torch.Tensor,
                                      out: torch.Tensor, num_groups: int) -> torch.Tensor:
    """Plain version: the GroupNorm apply and tanh of y's first
    ``out.shape[0]`` rows in y's dtype, then :func:`field_epilogue_reference`
    into ``out``."""
    r = out.shape[0]
    act = group_apply_reference(y[:r], gscale, gbias, stats[:r], num_groups, act="tanh")
    return field_epilogue_reference(act, min_, scale, out)


def _check(y, stats, gscale, gbias, min_, scale, out, num_groups) -> None:
    if y.dtype not in _DTYPE_CODES:
        raise TypeError(f"unsupported map dtype {y.dtype} (float32 or bfloat16)")
    if y.dim() != 3 or not y.is_contiguous():
        raise ValueError(f"the map must be a contiguous [B, T, N] tensor, got {tuple(y.shape)}")
    b, t, n = y.shape
    if num_groups <= 0 or n % num_groups:
        raise ValueError(f"{n} nodes do not split into {num_groups} groups")
    if (stats.device != y.device or stats.dtype != torch.float32
            or tuple(stats.shape) != (b, 2, num_groups) or not stats.is_contiguous()):
        raise ValueError(f"stats must be a contiguous float32 [{b}, 2, {num_groups}] tensor "
                         f"on {y.device}, got {stats.dtype} {tuple(stats.shape)}")
    for name, v in (("gscale", gscale), ("gbias", gbias), ("min_", min_), ("scale", scale)):
        if (v.device != y.device or v.dtype != torch.float32 or tuple(v.shape) != (n,)
                or not v.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 [{n}] tensor on "
                             f"{y.device}, got {v.dtype} {tuple(v.shape)} on {v.device}")
    if (out.device != y.device or out.dtype != torch.float32 or out.dim() != 3
            or not 1 <= out.shape[0] <= b or tuple(out.shape[1:]) != (t, n)
            or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous float32 [1..{b}, {t}, {n}] tensor on "
                         f"{y.device}, got {out.dtype} {tuple(out.shape)} on {out.device}")


def gn_apply_field_epilogue(y: torch.Tensor, stats: torch.Tensor, gscale: torch.Tensor,
                            gbias: torch.Tensor, min_: torch.Tensor, scale: torch.Tensor,
                            out: torch.Tensor, num_groups: int) -> torch.Tensor:
    """``out = (round(tanh(GroupNorm(y) * gscale + gbias)) - min_) / scale``
    for y's first ``out.shape[0]`` rows: a ``[B, T, N]`` pre-norm map with
    its ``[B, 2, num_groups]`` statistics from ``gn_stats`` and ``[N]`` f32
    vectors, rounded to y's dtype before the descale; returns ``out``."""
    _check(y, stats, gscale, gbias, min_, scale, out, num_groups)
    if y.device.type == "cpu":
        return gn_apply_field_epilogue_reference(y, stats, gscale, gbias, min_, scale, out,
                                                 num_groups)
    if y.device.type != "cuda":
        raise ValueError(f"expected a CUDA or CPU tensor, got one on {y.device}")
    fn = _build.load("field_epilogue").gn_apply_field_epilogue
    if fn.argtypes is None:
        fn.argtypes = [_P] * 7 + [_LL, _I, _I, _I, _I, _P]
        fn.restype = ctypes.c_int
    with torch.cuda.device(y.device):
        err = fn(*(ctypes.c_void_p(t.data_ptr())
                   for t in (y, stats, gscale, gbias, min_, scale, out)),
                 out.shape[0] * out.shape[1], y.shape[1], y.shape[2], num_groups,
                 _DTYPE_CODES[y.dtype],
                 ctypes.c_void_p(torch.cuda.current_stream(y.device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"gn_apply_field_epilogue launch failed with cudaError {err}")
    LAUNCHES["gn_apply_field_epilogue"] += 1
    return out
