"""Int8 serving decode (``simulgen_vae_tpu/ops/quant.py``).

* :func:`quantize_kernel`: symmetric per-output-channel int8 weights. The
  port's weights keep the output channel on axis 0 (conv ``[F, C, k]``,
  dense and readout ``[out, in]``), so the scale of a channel is over every
  other axis; that gives the JAX function's bits on its ``[k, C, F]`` and
  ``[C, F]`` kernels.
* :func:`_quantize_act`: dynamic per-row activation quantization; the
  contraction axis is the last one, so a row's scale factors out of the
  int32 product.
* :func:`int8_mm`: the int8 x int8 -> int32 product. On a CUDA tensor it is
  ``torch._int_mm`` (cuBLASLt on the int8 tensor cores, int32 accumulation;
  the JAX function is an XLA ``dot_general``, no Pallas kernel), with the
  operands padded with zeros to what that call takes: more than 16 rows, a
  depth and a width that are multiples of 8. On the CPU it is the plain
  version, :func:`int8_mm_reference`, exact in f64. ``LAUNCHES["int8_mm"]``
  counts the card's calls.
* :func:`int8_dot`, :func:`int8_conv1d_same`: the quantized linear cores,
  rescaled to f32 as the JAX functions order it (``y * (sx * scale)``; per
  conv tap before the cross-tap sum). The rescale is plain PyTorch: it reads
  the int32 map back (at the readout a ``[3200, 95008]`` map, 1.2 GB at
  batch 16), which XLA fuses into the product.
* :func:`build_quant_collection`: the int8 mirror of a module tree's
  weights, as ``weight_q`` / ``weight_s`` buffers on each linear layer
  (``models/blocks.py`` switches such a layer to the int8 path).

Quantization happens once, at pipeline build, from the f32 weights; GroupNorm
statistics, biases and activations stay in the compute dtype.
"""

from __future__ import annotations

import copy

import torch
import torch.nn.functional as F
from torch import nn

from simulgen_vae_tpu_torch.utils import profiling

LAUNCHES = profiling.register({"int8_mm": 0})


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def quantize_kernel(weight: torch.Tensor):
    """``weight`` (output channels on axis 0) -> ``(kq int8 [same shape],
    scale f32 [out])`` with ``weight ~= kq * scale``; an all-zero channel
    gets scale 1 / 127."""
    w = weight.float()
    amax = w.abs().amax(dim=tuple(range(1, w.dim())))
    scale = torch.where(amax > 0, amax, torch.ones_like(amax)) / 127.0
    kq = torch.clamp(torch.round(w / scale.reshape(-1, *[1] * (w.dim() - 1))), -127, 127)
    return kq.to(torch.int8), scale


def _quantize_act(x: torch.Tensor):
    """Per-row symmetric quantization over the last axis -> ``(xq int8,
    sx f32 [..., 1])`` with ``x ~= xq * sx``. ``torch.round`` rounds half to
    even, as ``jnp.round`` does."""
    x32 = x.float()
    sx = x32.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30) / 127.0
    xq = torch.clamp(torch.round(x32 / sx), -127, 127).to(torch.int8)
    return xq, sx


def int8_mm_reference(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The plain version of :func:`int8_mm`: ``a @ w^T`` in f64, which holds
    every int32 sum of int8 products exactly."""
    return torch.matmul(a.double(), w.double().t()).to(torch.int32)


def int8_mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a`` int8 ``[M, K]`` times ``w`` int8 ``[N, K]`` transposed -> int32
    ``[M, N]``, exact."""
    if a.dtype != torch.int8 or w.dtype != torch.int8 or a.dim() != 2 or w.dim() != 2 \
            or a.shape[1] != w.shape[1]:
        raise ValueError(f"int8_mm takes int8 [M, K] and [N, K], got {a.dtype} "
                         f"{tuple(a.shape)} and {w.dtype} {tuple(w.shape)}")
    if a.device.type == "cpu":
        return int8_mm_reference(a, w)
    if a.device.type != "cuda":
        raise ValueError(f"int8_mm runs on cuda or the cpu, not {a.device}")
    m, k = a.shape
    n = w.shape[0]
    pad_m, pad_k, pad_n = (32 - m if m <= 16 else 0), -k % 8, -n % 8
    if pad_m or pad_k:
        a = F.pad(a, (0, pad_k, 0, pad_m))
    if pad_k or pad_n:
        w = F.pad(w, (0, pad_k, 0, pad_n))
    LAUNCHES["int8_mm"] += 1
    y = torch._int_mm(a.contiguous(), w.contiguous().t())
    return y[:m, :n] if pad_m or pad_n else y


def int8_dot(x: torch.Tensor, kq: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``x @ dequant(kq)^T``: ``x`` float ``[..., C]``, ``kq`` int8 ``[F, C]``,
    ``scale`` f32 ``[F]`` -> f32 ``[..., F]``."""
    xq, sx = _quantize_act(x)
    y = int8_mm(xq.reshape(-1, x.shape[-1]), kq).reshape(*x.shape[:-1], kq.shape[0])
    return y * (sx * scale)


def int8_conv1d_same(x: torch.Tensor, kq: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Stride-1 SAME conv of ``x`` ``[B, T, C]`` with the int8 taps ``kq``
    ``[k, F, C]`` (odd k): the zero-padded input is quantized once, each tap
    is an int8 product on a shifted view, rescaled by its rows' scales before
    the cross-tap sum; the sum is scaled per output channel."""
    k = kq.shape[0]
    if k == 1:
        return int8_dot(x, kq[0], scale)
    b, t, c = x.shape
    pad = k // 2
    xq, sx = _quantize_act(F.pad(x, (0, 0, pad, pad)))
    acc = None
    for d in range(k):
        y = int8_mm(xq[:, d:d + t].reshape(b * t, c), kq[d]).reshape(b, t, -1)
        y = y * sx[:, d:d + t]
        acc = y if acc is None else acc + y
    return acc * scale


def build_quant_collection(module: nn.Module, state: dict, device) -> nn.Module:
    """The int8 mirror of ``module``: a copy that shares its parameters, whose
    linear layers (the modules with a ``quant_weight`` attribute naming their
    weight) hold ``weight_q`` and ``weight_s`` buffers on ``device``,
    quantized from the f32 arrays of ``state`` (keyed like
    ``module.state_dict()``); a conv's int8 taps are stored tap-major,
    ``[k, F, C]``, as :func:`int8_conv1d_same` takes them."""
    shared = {id(t): t for t in (*module.parameters(), *module.buffers())}
    for m in module.modules():  # a mesh's process group is shared, not copied
        group = getattr(m, "node_group", None)
        if group is not None:
            shared[id(group)] = group
    out = copy.deepcopy(module, shared)
    for name, m in out.named_modules():
        key = getattr(m, "quant_weight", None)
        if key is None:
            continue
        w = torch.as_tensor(state[f"{name}.{key}" if name else key]).to(device)
        kq, s = quantize_kernel(w)
        if kq.dim() == 3:
            kq = kq.permute(2, 0, 1).contiguous()
        m.register_buffer("weight_q", kq)
        m.register_buffer("weight_s", s)
    return out
