"""Spectral normalization of the VAE's kernels by power iteration
(``simulgen_vae_tpu/models/spectral_norm.py``).

Every conv, dense and readout kernel is normalised by its leading singular
value, with one power iteration per step and a persistent unit vector ``u``
per kernel, as torch's ``spectral_norm`` does. No ``W / sigma`` copy is made:
:func:`compute_sigmas` returns ``inv_sigma = 1 / (sigma + eps)`` per kernel,
:func:`attach_inv_sigmas` hands each to its layer, which scales its output
(``models/blocks.py``). Making each ``inv_sigma`` a leaf that requires grad,
its ``.grad`` after the backward is the JAX package's ``g_sigmas``, and
:func:`add_sigma_rank1_grads` adds sigma's share of the kernel gradient as a
rank-1 term, in place.

Matrix view. JAX reshapes a kernel to ``M = [rest, out]``; the port works on
the transpose in its own layout, ``W_o = [out, rest]`` (a view, no copy):
conv ``[F, C, k] -> [F, C*k]``, dense ``[out, in]``, readout ``[nodes, F]``.
``sigma(M) = sigma(W_o)``; only the order of the ``rest`` axis differs from
JAX's (``(c, tap)`` here, ``(tap, c)`` there) for k > 1 convs, which changes
no sigma and no ``u`` (``u`` lives on the out axis). A plain loop of matvecs
per kernel: JAX's bucketing of small kernels is a TPU dispatch fix.

Names: state is keyed by the parameter's name in the model (for example
``decoder.dec_block.0.conv.weight``), as ``named_parameters`` gives it.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch
from torch import nn

from simulgen_vae_tpu_torch.models.blocks import Conv1d, Dense, FusedPointwiseNormTanh

EPS = 1e-12


def sn_layers(model: nn.Module) -> Dict[str, nn.Module]:
    """``{kernel parameter name: layer}`` for every spectrally normalised layer."""
    out = {}
    for name, mod in model.named_modules():
        prefix = f"{name}." if name else ""
        if isinstance(mod, (Conv1d, Dense)):
            out[prefix + "weight"] = mod
        elif isinstance(mod, FusedPointwiseNormTanh):
            out[prefix + "kernel"] = mod
    return out


def _kernel(mod: nn.Module) -> torch.Tensor:
    return mod.kernel if isinstance(mod, FusedPointwiseNormTanh) else mod.weight


def _out_rest(mod: nn.Module) -> torch.Tensor:
    """The layer's kernel as ``[out, rest]`` (a view of the parameter)."""
    w = _kernel(mod)
    return w.reshape(w.shape[0], -1)


def init_sn_state(model: nn.Module, generator: Optional[torch.Generator] = None
                  ) -> Dict[str, torch.Tensor]:
    """One random f32 unit vector ``u`` [out] per kernel."""
    state = {}
    for name, mod in sn_layers(model).items():
        w = _kernel(mod)
        u = torch.randn(w.shape[0], generator=generator, device=w.device)
        state[name] = u / (torch.linalg.vector_norm(u) + EPS)
    return state


@torch.no_grad()
def compute_sigmas(model: nn.Module, state: Dict[str, torch.Tensor],
                   update: bool = True, compute_dtype: Optional[torch.dtype] = None,
                   with_grad_factors: bool = False):
    """``(inv_sigmas, new_state[, factors])``, each keyed by kernel name.

    ``update=True`` runs one power iteration (``v = M u / |M u|``,
    ``sigma = |M^T v|``, ``u' = M^T v / sigma``); ``update=False`` reuses ``u``
    (eval: ``sigma = |M u|``). ``compute_dtype`` runs the matvecs on the kernel
    cast to that dtype (the JAX trainer's bf16 power iteration for bf16 runs).
    ``factors[name] = (row [rest], col [out], inv)`` with ``d sigma / dW_o =
    col row^T``. Nothing here takes part in autograd.
    """
    inv_sigmas, new_u, factors = {}, {}, {}
    for name, mod in sn_layers(model).items():
        w = _out_rest(mod).detach()
        w = w.to(compute_dtype if compute_dtype is not None else torch.float32)
        u = state[name]
        if update:
            mu = (u.to(w.dtype) @ w).float()                      # M u, [rest]
            v = mu / (torch.linalg.vector_norm(mu) + EPS)
            mtv = (w @ v.to(w.dtype)).float()                     # M^T v, [out]
            sigma = torch.linalg.vector_norm(mtv)
            u_next = mtv / (sigma + EPS)
            row, col = v, mtv / sigma
        else:
            mu = (u.to(w.dtype) @ w).float()
            sigma = torch.linalg.vector_norm(mu)
            u_next = u
            row, col = mu / sigma, u.float()
        inv = 1.0 / (sigma + EPS)
        inv_sigmas[name], new_u[name] = inv, u_next
        factors[name] = (row, col, inv)
    if with_grad_factors:
        return inv_sigmas, new_u, factors
    return inv_sigmas, new_u


@torch.no_grad()
def spectral_normalize(model: nn.Module, state: Dict[str, torch.Tensor],
                       update: bool = False,
                       compute_dtype: Optional[torch.dtype] = None):
    """``(normed, new_state)``: every spectrally normalised kernel divided by
    its leading singular value (the JAX ``spectral_normalize``), keyed by
    kernel name and shaped as the parameter; the model is not touched.
    ``update=False`` reuses the stored ``u`` (eval, torch's semantics):
    ``sigma = |M u|``; ``update=True`` runs one power iteration first. With
    ``compute_dtype`` the matvecs run on the kernel cast to that dtype and the
    normalised kernels come out in it."""
    normed, new_u = {}, {}
    for name, mod in sn_layers(model).items():
        kernel = _kernel(mod).detach()
        w = _out_rest(mod).detach()
        w = w.to(compute_dtype if compute_dtype is not None else torch.float32)
        u = state[name]
        if update:
            v = (u.to(w.dtype) @ w).float()
            v = v / (torch.linalg.vector_norm(v) + EPS)
            u = (w @ v.to(w.dtype)).float()
            u = u / (torch.linalg.vector_norm(u) + EPS)
        mu = (u.to(w.dtype) @ w).float()                          # M u, [rest]
        v = mu / (torch.linalg.vector_norm(mu) + EPS)
        sigma = v @ mu
        out_dtype = compute_dtype if compute_dtype is not None else kernel.dtype
        normed[name] = (w / sigma.to(out_dtype)).to(out_dtype).reshape(kernel.shape)
        new_u[name] = u
    return normed, new_u


@contextlib.contextmanager
def attach_inv_sigmas(model: nn.Module, inv_sigmas: Dict[str, torch.Tensor]):
    """Hand each layer its ``inv_sigma`` for the duration of the block."""
    layers = sn_layers(model)
    try:
        for name, inv in inv_sigmas.items():
            layers[name].inv_sigma = inv
        yield
    finally:
        for mod in layers.values():
            mod.inv_sigma = None


@torch.no_grad()
def add_sigma_rank1_grads(grads: Dict[str, torch.Tensor],
                          g_inv: Dict[str, Optional[torch.Tensor]],
                          factors) -> Dict[str, torch.Tensor]:
    """``grads[name] += g_inv * (-inv^2) * col row^T`` for every kernel whose
    ``inv_sigma`` got a gradient: sigma's share of dL/dW, added in place
    (``addr_``, no ``[out, rest]`` temporary)."""
    for name, (row, col, inv) in factors.items():
        gi = g_inv.get(name)
        if gi is None:
            continue
        g = grads[name]
        coef = (gi * (-(inv * inv))).to(g.dtype)
        g.view(g.shape[0], -1).addr_(col.to(g.dtype) * coef, row.to(g.dtype))
    return grads
