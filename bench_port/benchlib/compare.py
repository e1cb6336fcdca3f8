"""The numbers that decide ``correct``: the program's outputs against the
plain reference's, each a gap that its limit bounds from above.

Training (three steps from the same inputs):

* ``loss_gap``: the worst step's ``|loss - loss_ref| / |loss_ref|``;
* ``grad_gap``: the worst leaf's ``| |g| - |g_ref| | / max(|g_ref|,
  median leaf |g_ref|)``, with the program's first gradient read from its
  optimizer as the first moment over ``1 - b1``;
* ``change_gap``: the same of each leaf's change after three steps, over
  the leaves whose reference gradient is at least a thousandth of the
  median leaf's (a smaller gradient moves the leaf under AdamW by round-off
  alone).

Serving: ``field_gap``, the worst sampled field's rel-L2 against the
reference's.
"""

from __future__ import annotations

import contextlib
import statistics

import torch

B1 = 0.9
MOVING_LEAF = 1e-3


@contextlib.contextmanager
def exact_f32():
    """f32 products without TF32 on the card, restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.float())) for k, v in tensors.items()}


def leaf_gap(have: dict, want: dict, leaves=None) -> tuple:
    """``(gap, leaf)``: the worst leaf's gap of norms, against the larger of
    the leaf's reference norm and the median leaf's."""
    keys = sorted(want) if leaves is None else sorted(leaves)
    median = statistics.median(want[k] for k in keys)
    worst, at = 0.0, None
    for k in keys:
        gap = abs(have[k] - want[k]) / max(want[k], median)
        if gap >= worst:
            worst, at = gap, k
    return worst, at


def train_readings(program: dict, ref: dict, params0: dict) -> dict:
    """The three training numbers and the leaves that set them."""
    losses = [abs(p - r) / abs(r) for p, r in zip(program["losses"], ref["losses"])]
    if len(losses) != len(ref["losses"]):
        losses.append(float("inf"))
    g_ref = _norms(ref["grads"])
    g_have = {k: float(torch.linalg.vector_norm(v / (1.0 - B1))) for k, v in program["mu1"].items()}
    median = statistics.median(g_ref.values())
    moving = [k for k, v in g_ref.items() if v >= MOVING_LEAF * median]
    d_ref = {k: float(torch.linalg.vector_norm(ref["params"][k].float() - params0[k]))
             for k in moving}
    d_have = {k: float(torch.linalg.vector_norm(program["params"][k] - params0[k].cpu()))
              for k in moving}
    grad, grad_leaf = leaf_gap(g_have, g_ref)
    change, change_leaf = leaf_gap(d_have, d_ref)
    return dict(loss_gap=max(losses), grad_gap=grad, change_gap=change,
                grad_leaf=grad_leaf, change_leaf=change_leaf,
                left_out=sorted(set(g_ref) - set(moving)))


def train_checks(program: dict, ref: dict, params0: dict, limits: dict) -> dict:
    r = train_readings(program, ref, params0)
    return {k: (r[k], float(limits[k])) for k in ("loss_gap", "grad_gap", "change_gap")}


def field_gap(have: torch.Tensor, want: torch.Tensor) -> float:
    """The worst row's ``|have - want| / |want|`` (rows along dim 0)."""
    d = (have.float() - want.float()).flatten(1)
    return float((torch.linalg.vector_norm(d, dim=1)
                  / torch.linalg.vector_norm(want.float().flatten(1), dim=1)).max())
