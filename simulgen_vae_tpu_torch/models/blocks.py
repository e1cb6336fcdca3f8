"""Encoder and decoder building blocks over ``[B, T, C]`` maps (time, then channels).

Counterpart of ``simulgen_vae_tpu/models/blocks.py``. Public tensors keep the
JAX layout ``[B, T, C]``; convolution weights use PyTorch's ``[out, in, k]``
and dense weights ``[out, in]`` (``convert.py`` carries JAX parameters over).
Every GroupNorm + activation goes through :class:`NormAct`, which calls
``ops.groupnorm_gelu.group_norm_act``: the hand-written kernels on the card,
the plain version on the CPU, with a kernel backward when gradients flow.

Conventions as in the JAX package: GroupNorm(:func:`group_count` groups,
eps 1e-5) with f32 statistics, exact (erf) GELU, residual branches scaled by
0.1. Each module computes in its ``compute_dtype`` (inputs, weights and biases
are cast at use, as flax's ``promote_dtype`` does); GroupNorm affines stay f32.
Serving builds the parameters in the compute dtype, so the casts are free;
the trainer keeps f32 master parameters and sets a lower compute dtype with
:func:`set_compute_dtype`.

Spectral norm: :class:`Conv1d`, :class:`Dense` and the readout read an
optional ``inv_sigma`` attribute (a 0-d f32 tensor, set by
``models.spectral_norm.attach_inv_sigmas``) and scale their output by it
before the bias, which equals using ``W / sigma`` since each is linear in W.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from simulgen_vae_tpu_torch.ops.groupnorm_gelu import group_norm_act
from simulgen_vae_tpu_torch.ops.readout_chain import readout_chain_loss


def group_count(channels: int) -> int:
    """min(8, max(1, C // 4)), reduced to the nearest divisor of C."""
    g = min(8, max(1, channels // 4))
    while channels % g != 0:
        g -= 1
    return g


@functools.lru_cache(maxsize=None)
def _in_dtype(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as JAX casts a constant to x's dtype."""
    return float(torch.tensor(value, dtype=dtype))


class _RoundedGelu(torch.autograd.Function):
    """``jax.nn.gelu(approximate=False)`` below f32, forward and backward
    rounded to x's dtype after each operation in JAX's order. Forward:
    ``(0.5 * x) * erfc(u)`` with u = x * -s, s = sqrt(0.5) in x's dtype.
    Backward: JAX's vjp of it, ``(k * ((0.5 * x) * ct) * exp(-u^2)) * -s +
    0.5 * (ct * erfc(u))`` with k = -2 / sqrt(pi) in x's dtype (autograd's
    own erfc backward and product rule round elsewhere and put ~23% of bf16
    gradients off JAX's)."""

    @staticmethod
    def forward(ctx, x):
        u = x * -_in_dtype(0.5 ** 0.5, x.dtype)
        erfc = torch.erfc(u)
        ctx.save_for_backward(x, u, erfc)
        return (0.5 * x) * erfc

    @staticmethod
    def backward(ctx, ct):
        x, u, erfc = ctx.saved_tensors
        k = _in_dtype(-2.0 / torch.pi ** 0.5, x.dtype)
        # a negation is exact, so JAX's -((k * l * e) * s) is (-k * l * e) * s
        through_erfc = ((-k * ((0.5 * x) * ct)) * torch.exp(-(u * u))) \
            * _in_dtype(0.5 ** 0.5, x.dtype)
        return through_erfc + 0.5 * (ct * erfc)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf-based) GELU. Below f32 it is ``jax.nn.gelu``'s expression,
    ``0.5 * x * erfc(-x * sqrt(0.5))``, and its gradient JAX's, each rounded
    to x's dtype after every operation (:class:`_RoundedGelu`; one fused
    ``F.gelu`` rounds once and puts ~40% of bf16 outputs an ulp off)."""
    if x.element_size() >= 4:
        return F.gelu(x)
    return _RoundedGelu.apply(x)


def conv1d_same(x: torch.Tensor, weight: torch.Tensor,
                bias: torch.Tensor | None = None) -> torch.Tensor:
    """Stride-1 SAME 1-D convolution of ``x`` [B, T, C] with ``weight``
    [F, C, k] (odd k; cross-correlation, no tap flip). Returns a contiguous
    [B, T, F] map."""
    k = weight.shape[-1]
    if k == 1:
        return F.linear(x, weight[:, :, 0], bias)
    y = F.conv1d(x.transpose(1, 2), weight, bias, padding=k // 2)
    return y.transpose(1, 2).contiguous()


def _param(shape, device, dtype, fill: float | None = None) -> nn.Parameter:
    data = torch.empty(shape, device=device, dtype=dtype)
    if fill is None:
        bound = (6.0 / (data[0].numel() if data.dim() > 1 else 1)) ** 0.5
        nn.init.uniform_(data, -bound, bound)  # He-uniform over fan_in
    else:
        data.fill_(fill)
    return nn.Parameter(data)


def set_compute_dtype(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Make every layer under ``module`` compute in ``dtype`` whatever its
    parameters' dtype (f32 master weights, bf16 compute)."""
    for m in module.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = dtype
    return module


def _biased(product, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
            inv_sigma) -> torch.Tensor:
    """``product(x, w)`` plus the bias, as the JAX layers order it: below f32
    the product is rounded to the compute dtype before the bias is added
    (``y + bias`` rounds a second time), with spectral norm scaled by
    inv_sigma in between (:func:`_scaled`); f32 keeps the bias inside the
    product."""
    if inv_sigma is not None:
        return _scaled(product(x, w), inv_sigma, b)
    if x.element_size() >= 4:
        return product(x, w, b)
    return product(x, w) + b


def _scaled(y: torch.Tensor, inv_sigma, bias: torch.Tensor) -> torch.Tensor:
    """``y * inv_sigma + bias`` with inv_sigma cast to y's dtype first, as the
    JAX layers round it (``y * inv.astype(y.dtype) + bias``)."""
    return y * inv_sigma.to(y.dtype) + bias


def linear_f32_bias(h: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``round(h @ w^T + bias)`` in h's (low-precision) dtype with the f32
    bias added inside the product's f32 accumulation, so the sum is rounded
    once, as the JAX readout rounds it. The bias is split into
    ``hi = round(bias)`` and ``lo = round(bias - hi)`` in h's dtype, appended
    to ``w`` as two columns against two columns of ones appended to ``h`` (the
    depth padded to a multiple of 8 with zeros): one matmul accumulates
    ``h . w + hi + lo`` in f32. ``hi + lo`` carries 16 mantissa bits of the
    bias, not 24. ``h`` [..., F], ``w`` [C, F], ``bias`` [C] f32."""
    dt = h.dtype
    b32 = bias.float()
    hi = b32.to(dt)
    lo = (b32 - hi.float()).to(dt)
    f = w.shape[1]
    pad = -(f + 2) % 8
    w_ext = torch.cat([w, hi[:, None], lo[:, None], w.new_zeros((w.shape[0], pad))], dim=1)
    ones = h.new_ones((*h.shape[:-1], 2))
    h_ext = torch.cat([h, ones, h.new_zeros((*h.shape[:-1], pad))], dim=-1)
    return F.linear(h_ext, w_ext)


class NormAct(nn.Module):
    """GroupNorm (+ fused activation) over [B, T, C]; ``act`` in
    {'gelu', 'tanh', 'none'}."""

    def __init__(self, channels: int, act: str = "gelu", device=None):
        super().__init__()
        self.act = act
        self.num_groups = group_count(channels)
        self.scale = _param((channels,), device, torch.float32, 1.0)
        self.bias = _param((channels,), device, torch.float32, 0.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm_act(x.contiguous(), self.scale, self.bias,
                              self.num_groups, act=self.act)


class Conv1d(nn.Module):
    """k-tap SAME conv over the time axis of [B, T, C] data."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 1,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        self.inv_sigma = None
        self.weight = _param((features, in_features, kernel_size), device, dtype)
        self.bias = _param((features,), device, dtype, 0.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        return _biased(conv1d_same, x.to(cd), self.weight.to(cd), self.bias.to(cd),
                       self.inv_sigma)


class Dense(nn.Module):
    def __init__(self, in_features: int, features: int, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        self.inv_sigma = None
        self.weight = _param((features, in_features), device, dtype)
        self.bias = _param((features,), device, dtype, 0.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        return _biased(F.linear, x.to(cd), self.weight.to(cd), self.bias.to(cd),
                       self.inv_sigma)


class _ConvNormStages(nn.Module):
    """A chain of (Conv1d -> NormAct gelu) stages, given (in, out, k) each."""

    def __init__(self, stages, device=None, dtype=torch.float32):
        super().__init__()
        self.convs = nn.ModuleList(
            Conv1d(i, o, k, device, dtype) for i, o, k in stages)
        self.norms = nn.ModuleList(
            NormAct(o, "gelu", device) for _, o, _ in stages)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv, norm in zip(self.convs, self.norms):
            x = norm(conv(x))
        return x


class ConvBlock(_ConvNormStages):
    """Encoder conv block: Conv(k=1) -> GN -> GELU, and for ``small=False``
    a further Conv(k=3) -> GN -> GELU."""

    def __init__(self, in_features: int, features: int, small: bool = True,
                 device=None, dtype=torch.float32):
        stages = [(in_features, features, 1)]
        if not small:
            stages.append((features, features, 3))
        super().__init__(stages, device, dtype)


class ResidualBlock(_ConvNormStages):
    """x + 0.1 * seq(x); seq = (Conv k=3 -> GN -> GELU) x (1 small / 2 large)."""

    def __init__(self, features: int, small: bool = True, device=None,
                 dtype=torch.float32):
        reps = 1 if small else 2
        super().__init__([(features, features, 3)] * reps, device, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + 0.1 * super().forward(x)


class EncoderResidualBlock(ResidualBlock):
    """The encoder's residual block: the same structure as :class:`ResidualBlock`."""


class DecoderResidualBlock(_ConvNormStages):
    """x + 0.1 * bottleneck(x) with 5x channel expansion.

    small: k=1 expand -> k=5 -> k=1 contract (each Conv -> GN -> GELU)
    large: k=1 keep  -> k=5 expand -> k=5 -> k=1 contract
    """

    EXPANSION = 5

    def __init__(self, features: int, small: bool = True, device=None,
                 dtype=torch.float32):
        f, m = features, features * self.EXPANSION
        if small:
            stages = [(f, m, 1), (m, m, 5), (m, f, 1)]
        else:
            stages = [(f, f, 1), (f, m, 5), (m, m, 5), (m, f, 1)]
        super().__init__(stages, device, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + 0.1 * super().forward(x)


class DecoderBlock(nn.Module):
    """Conv(k=3, SAME) -> GELU (the reference's stride-1 ConvTranspose1d,
    with its taps flipped into a regular conv)."""

    def __init__(self, in_features: int, features: int, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.conv = Conv1d(in_features, features, 3, device, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return gelu(self.conv(x))


class FusedPointwiseNormTanh(nn.Module):
    """Readout: k=1 conv [B, T, F] -> [B, T, nodes], then GroupNorm + Tanh.

    The direct path of the JAX module (``analytic=False``): one matmul in the
    compute dtype with f32 accumulation, the f32 bias added before the one
    rounding to the compute dtype, then ``group_norm_act(..., act='tanh')``.
    In bf16 the bias rides inside the product's f32 accumulation
    (:func:`linear_f32_bias`), which keeps 16 of its 24 mantissa bits.

    With spectral norm and ``F <= nodes`` the input is scaled by inv_sigma
    (in f32, then rounded), as the JAX module does, so sigma's backward runs
    on the narrow ``[B, T, F]`` side. With ``F > nodes`` the output is
    scaled: the product of the rounded operands is taken in f32, scaled
    and biased in f32 and rounded once, as the JAX module does; that
    geometry has few nodes, so the f32 product costs little.

    With ``x_target`` the fused train path runs instead
    (``ops.readout_chain.readout_chain_loss``): the product with the GroupNorm
    statistics in its epilogue, then normalize + tanh + loss in one read, and
    ``(recon_loss, recon_mse)`` means come back in place of ``x_hat``, which
    is never written. There inv_sigma scales the product's f32 output (no
    input-side scaling) and the f32 bias is added before the one rounding;
    ``readout_bwd`` picks its backward (``"auto"``, ``"fused"``,
    ``"materialize"``).
    """

    def __init__(self, in_features: int, num_node: int, eps: float = 1e-5,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.eps = eps
        self.num_groups = group_count(num_node)
        self.compute_dtype = dtype
        self.inv_sigma = None
        self.kernel = _param((num_node, in_features), device, dtype)
        self.bias = _param((num_node,), device, torch.float32, 0.0)
        self.scale = _param((num_node,), device, torch.float32, 1.0)
        self.norm_bias = _param((num_node,), device, torch.float32, 0.0)

    def forward(self, h: torch.Tensor, x_target: torch.Tensor | None = None,
                lossfun: str = "MSE", readout_bwd: str = "auto"):
        cd = self.compute_dtype
        if x_target is not None:
            inv = self.inv_sigma
            if inv is None:
                inv = torch.ones((), device=h.device, dtype=torch.float32)
            return readout_chain_loss(h.to(cd), self.kernel, self.bias,
                                      self.scale, self.norm_bias, x_target, inv,
                                      self.num_groups, self.eps, lossfun, readout_bwd)
        w, inv = self.kernel.to(cd), self.inv_sigma
        h = h.to(cd)
        if inv is not None and w.shape[1] <= w.shape[0]:
            h, inv = (h.float() * inv).to(cd), None
        if inv is not None:
            # products of the rounded operands summed in f32, scaled and
            # biased in f32, rounded once (the JAX module's order)
            y = (torch.matmul(h.float(), w.float().t()) * inv.float()
                 + self.bias.float()).to(cd)
        elif cd == torch.float32:
            y = F.linear(h, w, self.bias.float())
        else:
            y = linear_f32_bias(h, w, self.bias)
        return group_norm_act(y, self.scale, self.norm_bias, self.num_groups,
                              eps=self.eps, act="tanh")


def flatten_channels_first(x: torch.Tensor) -> torch.Tensor:
    """Flatten ``[B, T, C]`` -> ``[B, C*T]`` in channel-major order (the
    reference flattens ``[B, C, T]`` maps before its linear heads)."""
    return x.transpose(1, 2).reshape(x.shape[0], -1)
