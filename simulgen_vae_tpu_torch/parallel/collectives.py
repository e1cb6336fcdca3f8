"""The collectives of the sharded train step and serving, written out.

JAX's GSPMD inserts these by itself from the sharding rules
(``parallel/sharding.py``); here they are explicit, built only on
``all_reduce``, ``broadcast``, ``all_gather`` and ``barrier`` (the four that
gloo also takes on CUDA tensors, so that two ranks can rehearse on one
card). Every helper takes a process group from ``Mesh.group(axis)`` and does
nothing when it is None (an axis of one rank).

* :func:`sum_over`: forward all-reduce, backward identity. The encoder's
  node embedding (each rank holds a block of the node axis of its kernel:
  the partial products are summed) and the losses summed over shards.
* :func:`grad_sum_over`: forward identity, backward all-reduce (in f32). The
  readout's input, replicated over ``model`` while each rank holds a block of
  the readout's output nodes: each rank's ``dh`` is a partial sum.
* :func:`all_reduce_grads`: the gradient mean over ``data``, one flat
  buffer per dtype (in buckets of at most ``BUCKET_ELEMENTS``).
* :func:`global_grad_norm`: split leaves summed over ``model``, replicated
  leaves counted once.

Each call into ``torch.distributed`` is a span of ``utils.profiling``
(``collective.all_reduce``, ``collective.all_gather``,
``collective.broadcast``), recorded inside ``profiling.recording()``: on the
host's clock, from the call to its return, which on NCCL is when the
collective is queued, not done; a trace's kernels launched inside the span
show its device time.
"""

from __future__ import annotations

from typing import Dict, Iterable, List

import torch
import torch.distributed as dist

from simulgen_vae_tpu_torch.utils.profiling import span

BUCKET_ELEMENTS = 1 << 26


def all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce of ``t`` over ``group`` (nothing for None)."""
    if group is not None:
        with span("collective.all_reduce"):
            dist.all_reduce(t, op=op, group=group)
    return t


def all_gather_cat(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``t`` of ``group``, in rank order, concatenated along
    ``dim`` (``t`` itself for None). All ranks' blocks have ``t``'s shape."""
    if group is None:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    with span("collective.all_gather"):
        dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


def broadcast_(t: torch.Tensor, group, src_rank: int) -> torch.Tensor:
    """In-place broadcast from global rank ``src_rank`` of ``group``."""
    if group is not None:
        with span("collective.broadcast"):
            dist.broadcast(t, src=src_rank, group=group)
    return t


class _SumForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        # below f32 the partial sums are added in f32 and rounded once
        return all_reduce_(g.to(torch.float32, copy=True), ctx.group).to(g.dtype), None


def sum_over(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``; each rank's gradient flows to its own
    ``x`` unchanged (the ranks' terms are distinct inputs of one sum)."""
    return x if group is None else _SumForward.apply(x, group)


def grad_sum_over(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` unchanged; its gradient summed over ``group`` (``x`` is
    replicated and each rank's consumer sees part of the outputs)."""
    return x if group is None else _SumBackward.apply(x, group)


def mean_over_(t: torch.Tensor, group, size: int) -> torch.Tensor:
    """In-place mean of ``t`` over ``group`` of ``size`` ranks."""
    if group is not None:
        all_reduce_(t, group).div_(size)
    return t


def _buckets(tensors: List[torch.Tensor]) -> Iterable[List[torch.Tensor]]:
    """Consecutive runs of one dtype, each at most ``BUCKET_ELEMENTS``
    elements (a larger tensor is a bucket of its own)."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for run in by_dtype.values():
        bucket, n = [], 0
        for t in run:
            if bucket and n + t.numel() > BUCKET_ELEMENTS:
                yield bucket
                bucket, n = [], 0
            bucket.append(t)
            n += t.numel()
        if bucket:
            yield bucket


@torch.no_grad()
def all_reduce_grads(grads: Dict[str, torch.Tensor], group, size: int) -> None:
    """Replace every gradient by its mean over ``group`` of ``size`` ranks,
    in place: one all-reduce per bucket of a flat buffer."""
    if group is None:
        return
    for bucket in _buckets(list(grads.values())):
        if len(bucket) == 1:
            mean_over_(bucket[0], group, size)
            continue
        flat = torch.cat([t.reshape(-1) for t in bucket])
        mean_over_(flat, group, size)
        offset = 0
        for t in bucket:
            t.copy_(flat[offset: offset + t.numel()].view_as(t))
            offset += t.numel()


@torch.no_grad()
def global_grad_norm(grads: Dict[str, torch.Tensor], split: Iterable[str],
                     model_group) -> torch.Tensor:
    """The L2 norm of the whole gradient: the squares of the leaves named in
    ``split`` (each rank holds a block) summed over ``model_group``, the
    replicated leaves' counted once. A 0-d f32 tensor."""
    split = set(split)
    sq = {True: [], False: []}
    for k, g in grads.items():
        sq[k in split].append(torch.linalg.vector_norm(g.float()) ** 2)
    zero = next(iter(grads.values())).new_zeros((), dtype=torch.float32)
    blocks = torch.stack(sq[True]).sum() if sq[True] else zero
    all_reduce_(blocks, model_group)
    rest = torch.stack(sq[False]).sum() if sq[False] else zero
    return torch.sqrt(blocks + rest)


def agree_any(flag: bool, group, device) -> bool:
    """True on every rank of ``group`` when it is true on any of them."""
    if group is None:
        return bool(flag)
    t = torch.tensor([1.0 if flag else 0.0], device=device)
    all_reduce_(t, group, op=dist.ReduceOp.MAX)
    return bool(t.item() > 0)


def broadcast_flag(flag: bool, group, src_rank: int, device) -> bool:
    """Rank ``src_rank``'s ``flag`` on every rank of ``group``."""
    if group is None:
        return bool(flag)
    t = torch.tensor([1.0 if flag else 0.0], device=device)
    broadcast_(t, group, src_rank)
    return bool(t.item() > 0)
