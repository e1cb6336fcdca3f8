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

Convolutions with k > 1 run in cuDNN's channels-last layout, which a
``[B, T, C]`` map already has (:func:`conv1d_same`). Weights that no longer
change (served, frozen) are held in that order once
(:func:`hold_conv_weights`); a trained conv keeps contiguous masters and
its per-call cast to the compute dtype writes the order (:func:`_conv_weight`).

Spectral norm: :class:`Conv1d`, :class:`Dense` and the readout read an
optional ``inv_sigma`` attribute (a 0-d f32 tensor, set by
``models.spectral_norm.attach_inv_sigmas``) and scale their output by it
before the bias, which equals using ``W / sigma`` since each is linear in W.

Int8 serving: the same three hold ``weight_q`` / ``weight_s`` buffers in the
int8 mirror ``ops.quant.build_quant_collection`` makes (``quant_weight``
names the weight it quantizes), and then take the int8 product in the JAX
layers' order: conv and dense round the f32 product to the compute dtype,
scale by inv_sigma and add the bias; the readout adds the f32 bias to the f32
product and rounds once.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from simulgen_vae_tpu_torch.ops.field_epilogue import gn_apply_field_epilogue
from simulgen_vae_tpu_torch.ops.groupnorm_gelu import gn_stats, group_norm_act
from simulgen_vae_tpu_torch.parallel.collectives import grad_sum_over, sum_over
from simulgen_vae_tpu_torch.ops.quant import int8_conv1d_same, int8_dot
from simulgen_vae_tpu_torch.ops.readout_chain import readout_chain_loss
from simulgen_vae_tpu_torch.utils import profiling

# k > 1 convolutions by whether their input or weight had to be copied into
# cuDNN's channels-last order (conv1d_same); counted when a call runs (on a
# CUDA graph's path at its capture only)
CONV_LAYOUT = profiling.register({"conv.direct": 0, "conv.input_copied": 0,
                                  "conv.weight_copied": 0})


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
    [B, T, F] map.

    k > 1 runs as a 2-D convolution in channels-last form: ``x`` as a
    ``[B, C, 1, T]`` view, which for a contiguous map is channels-last with
    no copy, and the weight as ``[F, C, 1, k]`` channels-last, so cuDNN's
    NHWC kernel reads and writes the maps as they lie and transposes
    nothing. An input view in another order (a transposed map) or a weight
    not held in cuDNN's order (:func:`cudnn_order`) is copied into it
    first; :data:`CONV_LAYOUT` counts the calls each way."""
    k = weight.shape[-1]
    if k == 1:
        return F.linear(x, weight[:, :, 0], bias)
    x4, w4 = x.transpose(1, 2).unsqueeze(2), weight.unsqueeze(2)
    direct = True
    if not x4.is_contiguous(memory_format=torch.channels_last):
        x4, direct = x4.contiguous(memory_format=torch.channels_last), False
        CONV_LAYOUT["conv.input_copied"] += 1
    if not w4.is_contiguous(memory_format=torch.channels_last):
        w4, direct = w4.contiguous(memory_format=torch.channels_last), False
        CONV_LAYOUT["conv.weight_copied"] += 1
    if direct:
        CONV_LAYOUT["conv.direct"] += 1
    y = F.conv2d(x4, w4, bias, padding=(0, k // 2))
    return y.squeeze(2).transpose(1, 2)


def cudnn_order(weight: torch.Tensor) -> torch.Tensor:
    """``weight`` [F, C, k] re-strided to ``(k * C, 1, C)``: the same values,
    laid out so that ``weight.unsqueeze(2)`` is a channels-last
    ``[F, C, 1, k]`` tensor, the order cuDNN's NHWC kernel reads."""
    return weight.unsqueeze(2).contiguous(memory_format=torch.channels_last).squeeze(2)


def _conv_weight(weight: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A conv's ``weight`` in its compute ``dtype``. A k > 1 weight that
    needs the cast is written in cuDNN's order in the same pass (autograd
    then saves it in that order, and the data gradient reads it as it
    lies); one already in ``dtype`` comes back as it is."""
    if weight.dtype == dtype or weight.shape[-1] == 1:
        return weight.to(dtype)
    return weight.unsqueeze(2).to(dtype, memory_format=torch.channels_last).squeeze(2)


@torch.no_grad()
def hold_conv_weights(module: nn.Module) -> nn.Module:
    """Hold every k > 1 :class:`Conv1d` weight under ``module`` in cuDNN's
    order (:func:`cudnn_order`), in place: for weights that no longer change
    (a served or frozen decoder), so that no call copies them into it. The
    parameters stay the same objects with the same values."""
    for m in module.modules():
        if isinstance(m, Conv1d) and m.weight.shape[-1] > 1:
            m.weight.data = cudnn_order(m.weight.data)
    return module


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


def _node_summed(product, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 inv_sigma, group) -> torch.Tensor:
    """:func:`_biased` for a layer whose contraction runs over the node axis,
    of which this rank holds one block (the encoder's embedding on a mesh):
    the partial products summed over ``group`` (``parallel.collectives.
    sum_over``), below f32 in f32 and rounded once, then inv_sigma and the
    bias, added once, after the sum."""
    if x.element_size() >= 4:
        y = sum_over(product(x, w), group)
    else:
        y = sum_over(product(x.float(), w.float()), group).to(x.dtype)
    if inv_sigma is not None:
        return _scaled(y, inv_sigma, b)
    return y + b


def _int8_biased(product, x: torch.Tensor, layer: nn.Module, b: torch.Tensor) -> torch.Tensor:
    """The int8 path of :class:`Conv1d` and :class:`Dense`: the f32 product
    of the int8 operands rounded to x's dtype, then inv_sigma and the bias."""
    y = product(x, layer.weight_q, layer.weight_s).to(x.dtype)
    if layer.inv_sigma is not None:
        return _scaled(y, layer.inv_sigma, b)
    return y + b


def _int8_buffers(module: nn.Module) -> None:
    """Empty ``weight_q`` / ``weight_s`` slots (no state-dict entries) that
    ``ops.quant.build_quant_collection`` fills in an int8 mirror."""
    module.register_buffer("weight_q", None)
    module.register_buffer("weight_s", None)


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

    quant_weight = "weight"

    def __init__(self, in_features: int, features: int, kernel_size: int = 1,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        self.inv_sigma = None
        # the model axis's group where in_features is this rank's block of
        # the node axis (the embedding on a mesh), else None
        self.node_group = None
        self.weight = _param((features, in_features, kernel_size), device, dtype)
        self.bias = _param((features,), device, dtype, 0.0)
        _int8_buffers(self)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        if self.weight_q is not None:
            return _int8_biased(int8_conv1d_same, x.to(cd), self, self.bias.to(cd))
        w = _conv_weight(self.weight, cd)
        if self.node_group is not None:
            return _node_summed(conv1d_same, x.to(cd), w, self.bias.to(cd),
                                self.inv_sigma, self.node_group)
        return _biased(conv1d_same, x.to(cd), w, self.bias.to(cd), self.inv_sigma)


class Dense(nn.Module):
    quant_weight = "weight"

    def __init__(self, in_features: int, features: int, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        self.inv_sigma = None
        self.weight = _param((features, in_features), device, dtype)
        self.bias = _param((features,), device, dtype, 0.0)
        _int8_buffers(self)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        if self.weight_q is not None:
            return _int8_biased(int8_dot, x.to(cd), self, self.bias.to(cd))
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

    With ``field_out=(min_, scale, out)`` the serving path runs instead: the
    same product, then ``gn_stats`` and one pass (``ops.field_epilogue.
    gn_apply_field_epilogue``) that normalises, applies tanh, rounds to the
    compute dtype and descales by the data scaler's ``[nodes]`` f32 ``min_``
    and ``scale`` into ``out``, ``[rows, T, nodes]`` f32 with ``rows`` up to
    the batch (a padded chunk's real rows); it returns ``out``, and no
    normalised map is kept. For inference only: nothing records a gradient.

    On a mesh (``node_group``) the layer holds one block of ``total_nodes``
    output nodes and ``num_groups`` whole GroupNorm groups of them: the
    forward needs no collective, and the input's gradient (and, scaled on
    the output side, inv_sigma's) is summed over the model axis
    (``parallel.collectives.grad_sum_over``). Which side inv_sigma scales
    follows ``total_nodes``, as on one device.
    """

    quant_weight = "kernel"

    def __init__(self, in_features: int, num_node: int, eps: float = 1e-5,
                 device=None, dtype=torch.float32, num_groups: int | None = None,
                 total_nodes: int | None = None, node_group=None):
        super().__init__()
        self.eps = eps
        self.num_groups = num_groups or group_count(num_node)
        self.input_side = in_features <= (total_nodes or num_node)
        self.node_group = node_group
        self.compute_dtype = dtype
        self.inv_sigma = None
        self.kernel = _param((num_node, in_features), device, dtype)
        self.bias = _param((num_node,), device, torch.float32, 0.0)
        self.scale = _param((num_node,), device, torch.float32, 1.0)
        self.norm_bias = _param((num_node,), device, torch.float32, 0.0)
        _int8_buffers(self)

    def forward(self, h: torch.Tensor, x_target: torch.Tensor | None = None,
                lossfun: str = "MSE", readout_bwd: str = "auto", field_out: tuple | None = None):
        cd = self.compute_dtype
        if x_target is not None:
            if self.node_group is not None:
                raise ValueError("the fused readout runs on one device, not on a mesh")
            inv = self.inv_sigma
            if inv is None:
                inv = torch.ones((), device=h.device, dtype=torch.float32)
            return readout_chain_loss(h.to(cd), self.kernel, self.bias,
                                      self.scale, self.norm_bias, x_target, inv,
                                      self.num_groups, self.eps, lossfun, readout_bwd)
        w, inv = self.kernel.to(cd), self.inv_sigma
        h = h.to(cd)
        if inv is not None and self.input_side:
            h, inv = (h.float() * inv).to(cd), None
        if self.node_group is not None:
            h = grad_sum_over(h, self.node_group)
            if inv is not None:
                inv = grad_sum_over(inv, self.node_group)
        if self.weight_q is not None:
            y = int8_dot(h, self.weight_q, self.weight_s)
            if inv is not None:
                y = y * inv.float()
            y = (y + self.bias.float()).to(cd)
        elif inv is not None:
            # products of the rounded operands summed in f32, scaled and
            # biased in f32, rounded once (the JAX module's order)
            y = (torch.matmul(h.float(), w.float().t()) * inv.float()
                 + self.bias.float()).to(cd)
        elif cd == torch.float32:
            y = F.linear(h, w, self.bias.float())
        else:
            y = linear_f32_bias(h, w, self.bias)
        if field_out is not None:
            min_, scale, out = field_out
            stats = gn_stats(y, self.num_groups, self.eps)
            with profiling.span("serve.descale"):
                return gn_apply_field_epilogue(y, stats, self.scale, self.norm_bias, min_, scale,
                                               out, self.num_groups)
        return group_norm_act(y, self.scale, self.norm_bias, self.num_groups,
                              eps=self.eps, act="tanh")


def flatten_channels_first(x: torch.Tensor) -> torch.Tensor:
    """Flatten ``[B, T, C]`` -> ``[B, C*T]`` in channel-major order (the
    reference flattens ``[B, C, T]`` maps before its linear heads)."""
    return x.transpose(1, 2).reshape(x.shape[0], -1)
