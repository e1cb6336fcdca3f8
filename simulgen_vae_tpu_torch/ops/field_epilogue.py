"""The served field's last step: a decoded chunk descaled into its rows of
the request's field, the wrapper of ``ops/csrc/field_epilogue.cu``.

``field_epilogue(x, min_, scale, out)`` writes ``(float(x) - min_) / scale``
(the data scaler's ``inverse_transform`` of a ``[rows, T, N]`` chunk in the
decoder's dtype, bf16 or f32) into ``out``, an f32 tensor of the same shape
that is usually a slice of the request's output. On the card that is one
launch of the hand-written kernel, one read of the chunk and one write of
the field, with the bits of the PyTorch expression on the card; on the CPU
it is :func:`field_epilogue_reference`, the same expression. The checks are
the same on both; a CUDA tensor takes the kernel or raises. ``LAUNCHES``
counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from simulgen_vae_tpu_torch.ops import _build
from simulgen_vae_tpu_torch.utils import profiling

LAUNCHES = profiling.register({"field_epilogue": 0})

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def reset_launch_counts() -> None:
    LAUNCHES["field_epilogue"] = 0


def field_epilogue_reference(x: torch.Tensor, min_: torch.Tensor, scale: torch.Tensor,
                             out: torch.Tensor) -> torch.Tensor:
    """Plain version: ``(x.float() - min_) / scale``, as
    ``MinMaxScaler.inverse_transform`` computes it, written into ``out``."""
    return torch.div(x.float() - min_, scale, out=out)


def _check(x, min_, scale, out) -> None:
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"unsupported field dtype {x.dtype} (float32 or bfloat16)")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"the field must be a contiguous [rows, T, N] tensor, got "
                         f"{tuple(x.shape)}")
    n = x.shape[2]
    for name, v in (("min_", min_), ("scale", scale)):
        if (v.device != x.device or v.dtype != torch.float32 or tuple(v.shape) != (n,)
                or not v.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 [{n}] tensor on "
                             f"{x.device}, got {v.dtype} {tuple(v.shape)} on {v.device}")
    if (out.device != x.device or out.dtype != torch.float32 or out.shape != x.shape
            or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous float32 {tuple(x.shape)} tensor on "
                         f"{x.device}, got {out.dtype} {tuple(out.shape)} on {out.device}")


def field_epilogue(x: torch.Tensor, min_: torch.Tensor, scale: torch.Tensor,
                   out: torch.Tensor) -> torch.Tensor:
    """``out = (float(x) - min_) / scale`` for a ``[rows, T, N]`` field and
    ``[N]`` f32 statistics; returns ``out``."""
    _check(x, min_, scale, out)
    if x.device.type == "cpu":
        return field_epilogue_reference(x, min_, scale, out)
    if x.device.type != "cuda":
        raise ValueError(f"expected a CUDA or CPU tensor, got one on {x.device}")
    fn = _build.load("field_epilogue").field_epilogue
    if fn.argtypes is None:
        fn.argtypes = [_P] * 4 + [_LL, _I, _I, _P]
        fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        err = fn(*(ctypes.c_void_p(t.data_ptr()) for t in (x, min_, scale, out)),
                 x.shape[0] * x.shape[1], x.shape[2], _DTYPE_CODES[x.dtype],
                 ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"field_epilogue launch failed with cudaError {err}")
    LAUNCHES["field_epilogue"] += 1
    return out
