"""The work of one step of the E2E job with a ViT conditioner, counted from
the configuration's shapes whatever implements it: model FLOPs for
``mfu.train``. Frozen here, like ``work`` and ``e2e_work``, so that a later
change to the program cannot move the numerator.

A training step on a batch of B designs runs the ViT's forward and backward
(3x its forward) and the frozen decoder's forward and its data gradient (2x
its forward), as ``e2e_work.step_flops`` counts the CNN's; the held-out
pass's forwards are spread over the epoch's training steps. The ViT's FLOPs
are those of its products, 2 per multiply-add: the patch embedding, each
block's q, k, v and output projections, its two attention products (scores
and weighted values) and its two MLP layers, and the two heads.
"""

from __future__ import annotations

from benchlib import e2e_work, work


def vit_forward_flops(c: dict, outputs) -> float:
    """Forward FLOPs of one ``image_side``-pixel square image through the ViT
    of conditioner ``c`` (``patch_size``, ``embed_dim``, ``depth``,
    ``mlp_ratio``) with heads of widths ``outputs``."""
    d, p = c["embed_dim"], c["patch_size"]
    n = (c["image_side"] // p) ** 2
    per_block = (2.0 * n * d * d * 4          # q, k, v, output projection
                 + 2.0 * n * n * d * 2        # q k^T and the weighted values
                 + 2.0 * n * d * d * c["mlp_ratio"] * 2)
    return 2.0 * n * p * p * d + c["depth"] * per_block + 2.0 * d * sum(outputs)


def step_flops(cfg: dict) -> float:
    """Model FLOPs of one training step, the held-out pass's share included."""
    levels = len(cfg["num_filter_enc"]) - 1
    vit = vit_forward_flops(cfg["conditioner"], (cfg["latent_dim_end"], cfg["latent_dim"] * levels))
    dec = work.field_flops(cfg)
    steps, held_out = e2e_work.split(cfg)
    b = cfg["e2e"]["batch_size"]
    return b * (3.0 * vit + 2.0 * dec) + held_out * b / steps * (vit + dec)
