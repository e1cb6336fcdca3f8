"""Model and train-state summaries printed when a model is built
(``simulgen_vae_tpu/utils/summary.py``).

A torchinfo-style table of a module's parameters grouped by the first
``depth`` parts of their names, then the rest of the train state (AdamW
moments, spectral-norm vectors, the image conditioners' BatchNorm
statistics): the bottom line is the device memory one train state holds. Counted from the tensors' shapes and dtypes; nothing is
allocated.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import torch
from torch import nn


def _leaf_stats(named: Iterable[Tuple[str, torch.Tensor]]):
    """[(name, n_params, n_bytes)] for every tensor."""
    return [(name, t.numel(), t.numel() * t.element_size()) for name, t in named]


def _group(stats, depth: int) -> Dict[str, list]:
    groups: dict = {}
    for path, n, b in stats:
        prefix = ".".join(path.split(".")[:depth]) or "(root)"
        g = groups.setdefault(prefix, [0, 0, 0])
        g[0] += 1
        g[1] += n
        g[2] += b
    return groups


def _mb(nbytes: int) -> str:
    return f"{nbytes / 2**20:,.2f}"


def _tensors(tree) -> list:
    """The tensors of a nested dict (moments: ``{"count", "mu", "nu"}``)."""
    if torch.is_tensor(tree):
        return [("", tree)]
    if isinstance(tree, dict):
        return [(k, t) for v in tree.values() for k, t in _tensors(v)]
    return []


def model_summary(module: nn.Module, name: str = "model", depth: int = 2,
                  opt_state=None, sn_u=None, batch_stats=None) -> str:
    """The parameter table of ``module``; ``opt_state`` / ``sn_u`` /
    ``batch_stats`` add the train state's other rows and its total."""
    groups = _group(_leaf_stats(module.named_parameters()), depth)
    rows = [(k, *v) for k, v in sorted(groups.items())]

    name_w = max([len(r[0]) for r in rows] + [len("module"), 24])
    header = (f"{'module':<{name_w}}  {'tensors':>7}  {'params':>13}  "
              f"{'size (MB)':>10}")
    sep = "=" * len(header)
    lines = [sep, f"{name} — parameter summary", sep, header, "-" * len(header)]
    for mod, t, n, b in rows:
        lines.append(f"{mod:<{name_w}}  {t:>7}  {n:>13,}  {_mb(b):>10}")
    total_t = sum(r[1] for r in rows)
    total_n = sum(r[2] for r in rows)
    total_b = sum(r[3] for r in rows)
    lines.append("-" * len(header))
    lines.append(f"{'trainable params':<{name_w}}  {total_t:>7}  "
                 f"{total_n:>13,}  {_mb(total_b):>10}")

    state_b = total_b
    for label, tree in (("optimizer state", opt_state), ("spectral-norm u", sn_u),
                        ("batch stats", batch_stats)):
        if not tree:
            continue
        s = _leaf_stats(_tensors(tree))
        b = sum(x[2] for x in s)
        state_b += b
        lines.append(f"{label:<{name_w}}  {len(s):>7}  {sum(x[1] for x in s):>13,}  "
                     f"{_mb(b):>10}")
    if state_b != total_b:
        lines.append("-" * len(header))
        lines.append(f"{'train state':<{name_w}}  {'':>7}  "
                     f"{'':>13}  {_mb(state_b):>10}")
    lines.append(sep)
    return "\n".join(lines)


def train_state_summary(state, name: str, depth: int = 2) -> str:
    """The table of a trainer's state (``VAETrainState``, ``LCTrainState``);
    the module's buffers are its batch statistics."""
    return model_summary(state.model, name=name, depth=depth,
                         opt_state=state.opt_state, sn_u=state.sn_u,
                         batch_stats=dict(state.model.named_buffers()))
