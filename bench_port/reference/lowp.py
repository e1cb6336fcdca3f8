"""The control's precision: 8-bit floats, the step below the
configurations' bfloat16. The reference rounds with it every tensor that a
program would store in that precision: the batch, both operands of every
product and every layer's output.

Values round to e4m3 with one scale a tensor (its largest magnitude maps to
448, the format's largest finite value); gradients flowing back through a
rounded tensor round to e5m2 the same way (largest 57344). The arithmetic
between the roundings stays f32.
"""

from __future__ import annotations

import torch

_FORMATS = {"e4m3": (torch.float8_e4m3fn, 448.0), "e5m2": (torch.float8_e5m2, 57344.0)}


def round_to(x: torch.Tensor, fmt: str) -> torch.Tensor:
    dtype, top = _FORMATS[fmt]
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / top, torch.ones_like(amax))
    return ((x / scale).to(dtype).to(x.dtype)) * scale


class _Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return round_to(x, "e4m3")

    @staticmethod
    def backward(ctx, g):
        return round_to(g, "e5m2")


class LowPrecision:
    """Callable that rounds one operand (a ``lowp`` for the reference)."""

    name = "fp8"

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return _Round.apply(x)
