"""The VAE's reconstruction loss pair on the card: the wrapper of
``ops/csrc/recon_loss.cu``.

``recon_loss_pair(pred, target, name)`` gives ``(recon_loss, recon_loss_mse)``:
the mean of loss flavor ``name``'s element loss (``losses.RECON_LOSSES``) and
the mean squared error of ``pred`` against ``target``, two f32 scalars, with
the pair's gradient under autograd. ``pred`` and ``target`` are contiguous
maps of one shape and one dtype (bf16 or f32). On the card the forward is one
pass over both maps (two launches: the per-block sums and a one-block
finalize, both in a fixed order) and the backward one more pass that writes
the gradient, bit-equal to the plain backward; on the CPU it is
``losses.make_recon_loss_pair``, the plain f32 expression. The checks are the
same on both; a CUDA tensor takes the kernels or raises.

``LAUNCHES["recon_loss_pair_fwd"]`` and ``["recon_loss_pair_bwd"]`` count the
forward and backward passes launched: one each a train step on the card.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from simulgen_vae_tpu_torch.losses import RECON_LOSSES, make_recon_loss_pair
from simulgen_vae_tpu_torch.ops import _build
from simulgen_vae_tpu_torch.utils import profiling

LAUNCHES = profiling.register({"recon_loss_pair_fwd": 0, "recon_loss_pair_bwd": 0})

# Each flavor as the kernels take it: (kind, threshold); kinds 0 squared,
# 1 absolute, 2 smooth L1 (beta), 3 Huber (delta).
LOSS_KINDS = {"MSE": (0, 0.0), "MAE": (1, 0.0), "smoothL1": (2, 1.0), "SmoothL1": (2, 0.1),
              "Huber": (3, 1.0), "Huber0.1": (3, 0.1)}
PARTIAL_BLOCKS = 4096  # the forward's grid at most, one pair of partial sums a block

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def f32_reciprocal(x: float) -> float:
    """``1 / x`` as PyTorch forms it on the card to divide a tensor by the
    host scalar ``x``: both rounded to f32, then the f32 quotient."""
    return float(np.float32(1.0) / np.float32(x))


def _check(pred: torch.Tensor, target: torch.Tensor, name: str) -> None:
    if name not in LOSS_KINDS:
        raise KeyError(f"Unknown loss '{name}'; options: {sorted(RECON_LOSSES)}")
    if pred.dtype not in _DTYPE_CODES or target.dtype != pred.dtype:
        raise TypeError(f"pred and target must share a dtype, float32 or bfloat16; got "
                        f"{pred.dtype} and {target.dtype}")
    if target.device != pred.device:
        raise ValueError(f"pred is on {pred.device}, target on {target.device}")
    if target.shape != pred.shape or pred.numel() == 0:
        raise ValueError(f"pred and target must have one non-empty shape, got "
                         f"{tuple(pred.shape)} and {tuple(target.shape)}")
    if not (pred.is_contiguous() and target.is_contiguous()):
        raise ValueError("pred and target must be contiguous")


def _fn(name: str, argtypes):
    fn = getattr(_build.load("recon_loss"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _ptr(t):
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def recon_loss_pair_fwd(pred: torch.Tensor, target: torch.Tensor, name: str):
    """The forward kernels on CUDA tensors: ``(flavor mean, MSE mean)``, two
    0-d f32 tensors on the maps' device."""
    kind, thr = LOSS_KINDS[name]
    dev = pred.device
    partials = torch.empty(2 * PARTIAL_BLOCKS, dtype=torch.float64, device=dev)
    out_f, out_m = (torch.empty((), dtype=torch.float32, device=dev) for _ in range(2))
    fn = _fn("recon_loss_pair_fwd", [_P, _P, _LL, _I, _I, _F, _F, _P, _I, _P, _P, _P])
    with torch.cuda.device(dev):
        err = fn(_ptr(pred), _ptr(target), pred.numel(), _DTYPE_CODES[pred.dtype], kind, thr,
                 f32_reciprocal(thr) if thr else 0.0, _ptr(partials), PARTIAL_BLOCKS,
                 _ptr(out_f), _ptr(out_m),
                 ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err != 0:
        raise RuntimeError(f"recon_loss_pair_fwd launch failed with cudaError {err}")
    LAUNCHES["recon_loss_pair_fwd"] += 1
    return out_f, out_m


def recon_loss_pair_bwd(pred: torch.Tensor, target: torch.Tensor, g_flavor: torch.Tensor,
                        g_mse: torch.Tensor, name: str, want_pred: bool, want_target: bool):
    """The backward kernel on CUDA tensors: ``(grad_pred, grad_target)`` from
    the two upstream gradients (0-d f32 tensors on the maps' device, read
    there), each None where it is not wanted."""
    for g in (g_flavor, g_mse):
        if g.dtype != torch.float32 or g.numel() != 1 or g.device != pred.device:
            raise ValueError(f"upstream gradients must be one float32 value on {pred.device}, "
                             f"got {g.dtype} {tuple(g.shape)} on {g.device}")
    kind, thr = LOSS_KINDS[name]
    dev = pred.device
    gp = torch.empty_like(pred) if want_pred else None
    gt = torch.empty_like(target) if want_target else None
    fn = _fn("recon_loss_pair_bwd", [_P] * 6 + [_LL, _I, _I, _F, _F, _F, _P])
    with torch.cuda.device(dev):
        err = fn(_ptr(pred), _ptr(target), _ptr(g_flavor), _ptr(g_mse), _ptr(gp), _ptr(gt),
                 pred.numel(), _DTYPE_CODES[pred.dtype], kind, thr,
                 f32_reciprocal(thr) if thr else 0.0, f32_reciprocal(pred.numel()),
                 ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err != 0:
        raise RuntimeError(f"recon_loss_pair_bwd launch failed with cudaError {err}")
    LAUNCHES["recon_loss_pair_bwd"] += 1
    return gp, gt


class _KernelPair(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pred, target, name):
        ctx.save_for_backward(pred, target)
        ctx.name = name
        return recon_loss_pair_fwd(pred, target, name)

    @staticmethod
    def backward(ctx, g_flavor, g_mse):
        pred, target = ctx.saved_tensors
        gp, gt = recon_loss_pair_bwd(pred, target, g_flavor, g_mse, ctx.name,
                                     *ctx.needs_input_grad[:2])
        return gp, gt, None


def recon_loss_pair(pred: torch.Tensor, target: torch.Tensor, name: str):
    """``(recon_loss, recon_loss_mse)`` of ``pred`` against ``target`` in loss
    flavor ``name``, differentiable in both: the kernels on CUDA tensors, the
    plain f32 expression on CPU ones."""
    _check(pred, target, name)
    if pred.device.type == "cpu":
        return make_recon_loss_pair(name)(pred, target)
    if pred.device.type != "cuda":
        raise ValueError(f"expected CUDA or CPU tensors, got them on {pred.device}")
    return _KernelPair.apply(pred, target, name)
