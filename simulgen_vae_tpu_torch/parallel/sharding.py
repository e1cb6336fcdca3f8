"""Sharding rules for the VAE's state and data (``simulgen_vae_tpu/parallel/sharding.py``).

The scale axis of the model is ``num_node`` (95008 at the flagship): the
encoder's embedding kernel, the decoder's readout kernel and its node-sized
vectors, and the ``[B, T, nodes]`` fields carry it. The rule is JAX's
(``_leaf_spec``, ``batch_sharding``): split the first node-sized dimension
of a leaf over ``model``, the batch over ``data``, replicate the rest.

The port applies it to the leaves of the layers that carry the node axis,
by name (:func:`node_leaves`: the embedding's kernel, the readout's kernel,
bias and GroupNorm affines, and the readout's spectral-norm ``u``), and
splits the node axis only where every block holds whole GroupNorm groups of
the readout (:func:`node_parts`: ``num_node % model == 0`` and
``group_count(num_node) % model == 0``). Then the readout's GroupNorm runs
on each block with ``groups / model`` groups and needs no collective. Where
that fails the node axis is replicated, as JAX's ``node_ok`` replicates it
when ``num_node % model != 0``, and one line says so.

JAX places a global array; a rank here holds a tensor of its block:
:func:`shard_tensor` slices it out of the host value and copies it to the
rank's device, :func:`gather_tensor` assembles the whole tensor on every
rank of the model axis (checkpoints, ``eval_params``, ``model_save/``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from simulgen_vae_tpu_torch.parallel import collectives
from simulgen_vae_tpu_torch.parallel.mesh import Mesh


def node_parts(mesh: Optional[Mesh], num_node: int, announce: bool = False) -> int:
    """How many blocks the node axis is split into on ``mesh``: its model
    axis where each block then holds whole readout groups, else 1."""
    from simulgen_vae_tpu_torch.models.blocks import group_count

    model = 1 if mesh is None else mesh.shape["model"]
    if model == 1:
        return 1
    if num_node % model == 0 and group_count(num_node) % model == 0:
        return model
    if announce:
        print(f"sharding: {num_node} nodes in {group_count(num_node)} GroupNorm groups do "
              f"not split into {model} blocks of whole groups: the node axis is "
              "replicated over 'model'")
    return 1


def batch_parts(mesh: Optional[Mesh], rows: int) -> int:
    """How many blocks ``rows`` requests or samples split into over ``data``:
    the data axis where it divides them, else 1 (replicated)."""
    data = 1 if mesh is None else mesh.shape["data"]
    return data if rows % data == 0 else 1


def block(x: torch.Tensor, dim: Optional[int], index: int, parts: int) -> torch.Tensor:
    """Block ``index`` of ``parts`` equal blocks of ``x`` along ``dim`` (a
    view; ``x`` itself for ``dim`` None or one part)."""
    if dim is None or parts == 1:
        return x
    n = x.shape[dim] // parts
    return x.narrow(dim, index * n, n)


def node_leaves(model: nn.Module) -> Dict[str, int]:
    """``{parameter name: split dimension}`` of the node-carrying leaves of
    a VAE in the port's layout: the embedding's kernel ``[f0, nodes, 1]``
    (dim 1) and the readout's kernel ``[nodes, F]``, bias, scale and
    norm bias (dim 0). JAX's rule gives the same dimensions on its layout
    (``[1, nodes, f0]``, ``[F, nodes]``, ``[nodes]``)."""
    from simulgen_vae_tpu_torch.models.blocks import FusedPointwiseNormTanh

    out = {}
    encoder = getattr(model, "encoder", None)
    if encoder is not None:
        out["encoder.enc_block.0.convs.0.weight"] = 1
    for name, mod in model.named_modules():
        if isinstance(mod, FusedPointwiseNormTanh):
            for leaf in ("kernel", "bias", "scale", "norm_bias"):
                out[f"{name}.{leaf}"] = 0
    return out


def sn_u_leaves(model: nn.Module) -> Dict[str, int]:
    """``{kernel name: split dimension}`` of the spectral-norm vectors: the
    readout's ``u`` is node-sized (its kernel's out axis); the embedding's
    ``u`` lives on its ``f0`` out axis and is replicated."""
    return {k: 0 for k in node_leaves(model) if k.endswith(".kernel")}


@dataclasses.dataclass
class Layout:
    """How a train state is split: the mesh, the node blocks, and the split
    dimension of each parameter (and moment) and of each ``u`` by name."""
    mesh: Mesh
    parts: int
    params: Dict[str, int]
    sn_u: Dict[str, int]

    @property
    def index(self) -> int:
        return self.mesh.coords["model"] if self.parts > 1 else 0

    @property
    def group(self):
        return self.mesh.group("model") if self.parts > 1 else None


def shard_tensor(x: torch.Tensor, dim: Optional[int], layout: Layout,
                 device=None) -> torch.Tensor:
    """This rank's block of the whole tensor ``x``, copied into a new
    contiguous tensor on ``device``."""
    part = block(x, dim, layout.index, layout.parts)
    return torch.empty(part.shape, device=device or x.device, dtype=x.dtype).copy_(part)


def gather_tensor(x: torch.Tensor, dim: Optional[int], layout: Layout) -> torch.Tensor:
    """The whole tensor from this rank's block ``x`` (a collective over the
    model axis when ``dim`` is split)."""
    if dim is None or layout.parts == 1:
        return x
    return collectives.all_gather_cat(x, layout.group, dim)


def shard_tree(tree: Dict[str, torch.Tensor], dims: Dict[str, int], layout: Layout,
               device=None) -> Dict[str, torch.Tensor]:
    return {k: shard_tensor(v, dims.get(k), layout, device) for k, v in tree.items()}


def gather_tree(tree: Dict[str, torch.Tensor], dims: Dict[str, int],
                layout: Layout) -> Dict[str, torch.Tensor]:
    return {k: gather_tensor(v, dims.get(k), layout) for k, v in tree.items()}


def shard_state(state, layout: Layout, local_model: nn.Module):
    """A train state (whole tensors, any device) as this rank's block of it:
    ``local_model`` (built at the block's width) receives its parameters,
    the moments and ``u`` vectors are sliced, and the state records its
    ``layout``."""
    device = next(local_model.parameters()).device
    with torch.no_grad():
        params = dict(state.model.named_parameters())
        for k, p in local_model.named_parameters():
            p.copy_(shard_tensor(params[k].detach(), layout.params.get(k), layout, device))
    opt = dict(state.opt_state)
    for part in ("mu", "nu"):
        opt[part] = shard_tree(state.opt_state[part], layout.params, layout, device)
    sn_u = shard_tree(state.sn_u, layout.sn_u, layout, device)
    return dataclasses.replace(state, model=local_model, opt_state=opt, sn_u=sn_u,
                               layout=layout)


def gather_payload(state) -> Tuple[Dict, Dict, Dict, Dict]:
    """``(params, mu, nu, sn_u)`` of a split state as whole tensors on
    every rank of its model axis."""
    layout = state.layout
    params = {k: p.detach() for k, p in state.model.named_parameters()}
    return (gather_tree(params, layout.params, layout),
            gather_tree(state.opt_state["mu"], layout.params, layout),
            gather_tree(state.opt_state["nu"], layout.params, layout),
            gather_tree(state.sn_u, layout.sn_u, layout))


def shard_batch(x: torch.Tensor, mesh: Optional[Mesh], parts: int) -> torch.Tensor:
    """This rank's block of ``[batch, time, nodes]`` data: rows over
    ``data`` where the data axis divides them, nodes over ``model`` in
    ``parts`` blocks. A view of ``x``."""
    if mesh is None:
        return x
    d = batch_parts(mesh, x.shape[0])
    x = block(x, 0, mesh.coords["data"] if d > 1 else 0, d)
    return block(x, x.dim() - 1, mesh.coords["model"] if parts > 1 else 0, parts)
