"""Everything a run feeds the program, made on the device from the run's seed
in a few large calls: weights, power-iteration vectors, the resident
ensemble, design rows, images and scalers. The same seed gives the same
tensors, so the reference can be handed the very same inputs."""

from __future__ import annotations

import hashlib
import math

import torch


def subseed(seed: int, tag: str) -> int:
    """A 63-bit seed for the stream ``tag`` of run seed ``seed``."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device).manual_seed(subseed(seed, tag))


def _kind(name: str, shape) -> str:
    if len(shape) >= 2:
        return "kernel"
    if name.endswith((".scale", ".weight", ".var")):
        return "scale"
    return "bias"


@torch.no_grad()
def weights(shapes: dict, seed: int, tag: str, device) -> dict:
    """f32 weights for ``{name: shape}``: kernels He-uniform over their
    fan-in, norm scales 1 +- 0.1, biases +- 0.02. One draw for all."""
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.rand(total, generator=generator(seed, tag, device), device=device)
    flat.mul_(2.0).sub_(1.0)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        w = flat[at: at + n].view(shape)
        at += n
        kind = _kind(name, shape)
        if kind == "kernel":
            w.mul_(math.sqrt(6.0 / math.prod(shape[1:])))
        elif kind == "scale":
            w.mul_(0.1).add_(1.0)
        else:
            w.mul_(0.02)
        out[name] = w
    return out


@torch.no_grad()
def unit_vectors(shapes: dict, names, seed: int, device) -> dict:
    """One f32 unit vector ``[out]`` per spectrally normalised kernel."""
    sizes = [shapes[k][0] for k in names]
    flat = torch.randn(sum(sizes), generator=generator(seed, "sn_u", device), device=device)
    out = {}
    for k, part in zip(names, flat.split(sizes)):
        out[k] = part / (torch.linalg.vector_norm(part) + 1e-12)
    return out


@torch.no_grad()
def ensemble(n: int, t: int, nodes: int, seed: int, device, dtype=torch.bfloat16,
             chunk: int = 16) -> torch.Tensor:
    """The resident ensemble ``[n, t, nodes]``: sample p is ``a_p sin(2 pi
    f_p t / T + phi_node) + 0.05 noise``, with amplitudes ``a_p`` in [0.2,
    1] (so samples differ in scale, as designs do) and frequencies in [0.5,
    3]."""
    g = generator(seed, "ensemble", device)
    amp = torch.rand(n, generator=g, device=device) * 0.8 + 0.2
    freq = torch.rand(n, generator=g, device=device) * 2.5 + 0.5
    phase = torch.rand(nodes, generator=g, device=device) * (2 * math.pi)
    tt = torch.arange(t, device=device, dtype=torch.float32) / t
    out = torch.empty((n, t, nodes), device=device, dtype=dtype)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        x = torch.randn((e - s, t, nodes), generator=g, device=device).mul_(0.05)
        arg = (2 * math.pi) * freq[s:e, None, None] * tt[None, :, None] + phase
        x.add_(amp[s:e, None, None] * torch.sin(arg))
        out[s:e] = x
        del x, arg
    return out


@torch.no_grad()
def scaler(width: int, seed: int, tag: str, device, low=(-3.0, -1.0), high=(1.0, 3.0)):
    """``(scale, min)`` of a min-max scaler to (-0.7, 0.7) fitted on data
    whose range is drawn per feature from ``low`` and ``high``."""
    g = generator(seed, tag, device)
    dmin = low[0] + (low[1] - low[0]) * torch.rand(width, generator=g, device=device)
    dmax = high[0] + (high[1] - high[0]) * torch.rand(width, generator=g, device=device)
    scale = 1.4 / (dmax - dmin)
    return scale, -0.7 - dmin * scale


@torch.no_grad()
def designs(count: int, rows: int, width: int, seed: int, device) -> torch.Tensor:
    """``count`` requests of ``rows`` scaled design rows in [-0.7, 0.7]."""
    g = generator(seed, "designs", device)
    return (torch.rand((count, rows, width), generator=g, device=device) - 0.5) * 1.4
