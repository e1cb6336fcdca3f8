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

A ``filter_fn`` on those names (the image CNN conditioner's
``models.conditioner_cnn.sn_filter``, JAX's ``filter_fn`` on parameter
paths) selects the layers instead: every ``nn.Linear``, ``nn.Conv2d``,
``Conv1d`` and ``Dense`` whose kernel name it accepts. A 2-D conv kernel
``[out, in, kh, kw]`` is viewed as ``[out, in*kh*kw]``, JAX's HWIO as
``[kh*kw*in, out]``: the same sigma and ``u``. :func:`spectral_normalize`
keeps sigma's gradient with respect to the kernels (``u`` and ``v`` are
constants), so a forward on its output trains through ``W / sigma`` as
JAX's ``spectral_normalize`` does; under ``torch.no_grad`` it is the
serving copy.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional

import torch
from torch import nn

from simulgen_vae_tpu_torch.models.blocks import Conv1d, Dense, FusedPointwiseNormTanh
from simulgen_vae_tpu_torch.parallel.collectives import all_reduce_

EPS = 1e-12


def sn_layers(model: nn.Module, filter_fn: Optional[Callable[[str], bool]] = None
              ) -> Dict[str, nn.Module]:
    """``{kernel parameter name: layer}`` for every spectrally normalised
    layer: every VAE layer, or with ``filter_fn`` the linear and conv layers
    whose kernel name it accepts."""
    out = {}
    for name, mod in model.named_modules():
        prefix = f"{name}." if name else ""
        if filter_fn is not None:
            if (isinstance(mod, (nn.Linear, nn.Conv2d, Conv1d, Dense))
                    and filter_fn(prefix + "weight")):
                out[prefix + "weight"] = mod
        elif isinstance(mod, (Conv1d, Dense)):
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


def init_sn_state(model: nn.Module, generator: Optional[torch.Generator] = None,
                  filter_fn: Optional[Callable[[str], bool]] = None
                  ) -> Dict[str, torch.Tensor]:
    """One random f32 unit vector ``u`` [out] per kernel."""
    state = {}
    for name, mod in sn_layers(model, filter_fn).items():
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

    On a mesh a layer with a ``node_group`` holds one block of its kernel's
    node axis: the rest axis of the embedding, the out axis of the readout
    (whose ``u`` is then this rank's block). The matvecs that contract that
    axis and the norms over it are summed over the group
    (:func:`_sigma_on_blocks`); ``row`` and ``col`` keep this rank's blocks,
    so the rank-1 term stays local.
    """
    inv_sigmas, new_u, factors = {}, {}, {}
    for name, mod in sn_layers(model).items():
        w = _out_rest(mod).detach()
        w = w.to(compute_dtype if compute_dtype is not None else torch.float32)
        u = state[name]
        group = getattr(mod, "node_group", None)
        if group is not None:
            sigma, u_next, row, col = _sigma_on_blocks(
                w, u, update, group, out_split=isinstance(mod, FusedPointwiseNormTanh))
        elif update:
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


def spectral_normalize(model: nn.Module, state: Dict[str, torch.Tensor],
                       update: bool = False,
                       compute_dtype: Optional[torch.dtype] = None,
                       filter_fn: Optional[Callable[[str], bool]] = None):
    """``(normed, new_state)``: every spectrally normalised kernel divided by
    its leading singular value (the JAX ``spectral_normalize``), keyed by
    kernel name and shaped as the parameter; the model is not touched.
    ``v = M u / |M u|`` from the stored ``u``; ``update=False`` (eval,
    torch's semantics) keeps ``u``, ``update=True`` moves it to ``M^T v /
    |M^T v|`` (one power iteration); then ``sigma = v . M u``. ``u`` and
    ``v`` are constants, so ``normed`` has
    the gradient of ``W / sigma(W)``. With ``compute_dtype`` the matvecs run
    on the kernel cast to that dtype and the normalised kernels come out in
    it."""
    normed, new_u = {}, {}
    for name, mod in sn_layers(model, filter_fn).items():
        kernel = _kernel(mod)
        w = _out_rest(mod).to(compute_dtype if compute_dtype is not None else torch.float32)
        u = state[name]
        with torch.no_grad():
            wd = w.detach()
            v = (u.to(wd.dtype) @ wd).float()                      # M u, [rest]
            v = v / (torch.linalg.vector_norm(v) + EPS)
            if update:
                u = (wd @ v.to(wd.dtype)).float()                  # M^T v, [out]
                u = u / (torch.linalg.vector_norm(u) + EPS)
        sigma = v @ (u.to(w.dtype) @ w).float()
        out_dtype = compute_dtype if compute_dtype is not None else kernel.dtype
        normed[name] = (w / sigma.to(out_dtype)).to(out_dtype).reshape(kernel.shape)
        new_u[name] = u
    return normed, new_u


def _sigma_on_blocks(w: torch.Tensor, u: torch.Tensor, update: bool, group,
                     out_split: bool):
    """:func:`compute_sigmas`' iteration on one block of ``W_o`` [out, rest]:
    of its rows (``out_split``, ``u`` a block too) or of its columns.
    Returns ``(sigma, u_next, row, col)``."""
    def norm(v, split):
        if not split:
            return torch.linalg.vector_norm(v)
        return torch.sqrt(all_reduce_((v * v).sum(), group))

    mu = (u.to(w.dtype) @ w).float()                              # M u, [rest]
    if out_split:
        all_reduce_(mu, group)
    if not update:
        sigma = norm(mu, not out_split)
        return sigma, u, mu / sigma, u.float()
    v = mu / (norm(mu, not out_split) + EPS)
    mtv = (w @ v.to(w.dtype)).float()                             # M^T v, [out]
    if not out_split:
        all_reduce_(mtv, group)
    sigma = norm(mtv, out_split)
    return sigma, mtv / (sigma + EPS), v, mtv / sigma


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
