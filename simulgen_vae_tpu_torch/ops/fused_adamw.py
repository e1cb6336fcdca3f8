"""One-sweep AdamW on the card: the wrapper of ``ops/csrc/fused_adamw.cu``.

``fused_adamw`` updates lists of parameters and moments in place from their
gradients in one pass over device memory (read p, g, m, v; write p, m, v) and
returns the global gradient norm as a 0-d device tensor. Moments are f32 or
bf16, each stored by round-to-nearest or by the stochastic rounding of
``train.optim.sr_round_bf16``. The table of tensors travels in the kernel's
arguments, :func:`max_tensors` tensors a launch, so a step launches the
sweep ``ceil(len(params) / max_tensors)`` times, then once more a one-block
kernel that adds the per-block sums of g^2 in order. The values that change
from step to step (lr, the bias corrections, the stochastic rounding's step
word) are read by the kernel from ``step``, four words in device memory
(:func:`step_words` makes them; ``train.optim.FusedAdamW.apply`` stages
them with one copy), so a CUDA graph that captured the launches replays each
step with its own values. Nothing waits for the card. ``LAUNCHES`` counts
the sweep launches.

The plain version is ``train.optim.FusedAdamW.apply_reference``; this module
takes CUDA tensors only and raises on anything else.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence

import numpy as np
import torch

from simulgen_vae_tpu_torch.ops import _build
from simulgen_vae_tpu_torch.utils import profiling

LAUNCHES = profiling.register({"fused_adamw": 0})

STORE_CODES = {"float32": 0, "bfloat16_rtn": 1, "bfloat16": 2}
STEP_WORDS = 4  # lr, c1, c2 (f32), the dither word (its bits)
_P, _I = ctypes.c_void_p, ctypes.c_int


def reset_launch_counts() -> None:
    LAUNCHES["fused_adamw"] = 0


def store_code(dtype: torch.dtype, stochastic_round: bool) -> int:
    """The kernel's code for a moment's storage."""
    if dtype == torch.float32:
        return STORE_CODES["float32"]
    if dtype == torch.bfloat16:
        return STORE_CODES["bfloat16" if stochastic_round else "bfloat16_rtn"]
    raise TypeError(f"moments are float32 or bfloat16, got {dtype}")


def sr_step(count: int) -> int:
    """The stochastic rounding's step word: ``count * 0x85EBCA6B`` mod 2**32."""
    return (count * 0x85EBCA6B) & 0xFFFFFFFF


def step_words(lr: float, c1: float, c2: float, count: int) -> np.ndarray:
    """The four words of ``step``: lr, c1, c2 rounded to f32 and the dither
    word of step ``count``, as ``int32`` bits."""
    words = np.empty(STEP_WORDS, dtype=np.int32)
    words.view(np.float32)[:3] = (lr, c1, c2)
    words.view(np.uint32)[3] = sr_step(count)
    return words


def _lib():
    lib = _build.load("fused_adamw")
    if lib.fused_adamw.argtypes is None:
        lib.fused_adamw.argtypes = [_P] * 6 + [_I, _I, _I, _P, _P, _P, _P]
        lib.fused_adamw.restype = ctypes.c_int
        lib.fused_adamw_grad_norm.argtypes = [_P, _I, _P, _P]
        lib.fused_adamw_grad_norm.restype = ctypes.c_int
        lib.fused_adamw_max_tensors.restype = ctypes.c_int
        lib.fused_adamw_span.restype = ctypes.c_int
    return lib


def max_tensors() -> int:
    """Tensors one sweep launch takes."""
    return int(_lib().fused_adamw_max_tensors())


def _check(params, grads, mu, nu, step) -> torch.device:
    if not (len(params) == len(grads) == len(mu) == len(nu)) or not params:
        raise ValueError("params, grads, mu and nu must be equally long and not empty")
    device = params[0].device
    if device.type != "cuda":
        raise ValueError(f"expected CUDA tensors, got parameters on {device}")
    if (step.device != device or step.dtype not in (torch.float32, torch.int32)
            or tuple(step.shape) != (STEP_WORDS,) or not step.is_contiguous()):
        raise ValueError(f"step must be a contiguous 4-byte [{STEP_WORDS}] tensor on {device}")
    for i, (p, g, m, v) in enumerate(zip(params, grads, mu, nu)):
        for what, t, dtypes in (("parameter", p, (torch.float32,)),
                                ("gradient", g, (torch.float32,)),
                                ("first moment", m, (mu[0].dtype,)),
                                ("second moment", v, (nu[0].dtype,))):
            if (t.device != device or t.dtype not in dtypes or t.shape != p.shape
                    or not t.is_contiguous()):
                raise ValueError(f"{what} {i} must be a contiguous {dtypes[0]} "
                                 f"{tuple(p.shape)} tensor on {device}, got {t.dtype} "
                                 f"{tuple(t.shape)} on {t.device}")
        if not 0 < p.numel() < 2 ** 32:
            raise ValueError(f"parameter {i} has {p.numel()} elements")
    return device


def fused_adamw(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
                mu: Sequence[torch.Tensor], nu: Sequence[torch.Tensor], *,
                step: torch.Tensor, b1: float, b2: float, eps: float, weight_decay: float,
                stochastic_round: bool) -> torch.Tensor:
    """One AdamW step over the lists, in place (kernel ``fused_adamw``); returns
    the gradient norm. ``params`` and ``grads`` are f32; ``mu`` and ``nu`` f32 or
    bf16 (each list of one dtype); ``step`` the step's four words on the card
    (:func:`step_words`: the learning rate, the bias corrections and the step
    word that keys the stochastic rounding, with the tensor's position in the
    lists as the leaf index)."""
    device = _check(params, grads, mu, nu, step)
    lib = _lib()
    m_code = store_code(mu[0].dtype, stochastic_round)
    v_code = store_code(nu[0].dtype, stochastic_round)
    per_launch, span = max_tensors(), int(lib.fused_adamw_span())
    sizes = [p.numel() for p in params]
    blocks = [-(-n // span) for n in sizes]
    partials = torch.empty((sum(blocks),), device=device, dtype=torch.float32)
    out = torch.empty((), device=device, dtype=torch.float32)
    hyper = (ctypes.c_float * 6)(b1, b2, 1.0 - b1, 1.0 - b2, eps, weight_decay)
    stream = ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)

    def pointers(tensors: List[torch.Tensor]):
        return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))

    done_blocks = 0
    with torch.cuda.device(device):
        for lo in range(0, len(params), per_launch):
            hi = min(lo + per_launch, len(params))
            err = lib.fused_adamw(
                pointers(params[lo:hi]), pointers(grads[lo:hi]), pointers(mu[lo:hi]),
                pointers(nu[lo:hi]), (ctypes.c_uint * (hi - lo))(*sizes[lo:hi]),
                (ctypes.c_uint * (hi - lo))(*range(lo, hi)), hi - lo, m_code, v_code,
                hyper, ctypes.c_void_p(step.data_ptr()),
                ctypes.c_void_p(partials.data_ptr() + 4 * done_blocks), stream)
            if err != 0:
                raise RuntimeError(f"fused_adamw launch failed with cudaError {err}")
            LAUNCHES["fused_adamw"] += 1
            done_blocks += sum(blocks[lo:hi])
        err = lib.fused_adamw_grad_norm(ctypes.c_void_p(partials.data_ptr()),
                                        int(partials.numel()), ctypes.c_void_p(out.data_ptr()),
                                        stream)
    if err != 0:
        raise RuntimeError(f"fused_adamw_grad_norm launch failed with cudaError {err}")
    return out


def launches_per_step(n_tensors: int) -> int:
    """Sweep launches one step makes over ``n_tensors`` tensors."""
    return -(-n_tensors // max_tensors())
