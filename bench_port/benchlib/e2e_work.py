"""The work of one step of the end-to-end (E2E) conditioner job, counted from
the configuration's shapes whatever implements it: model FLOPs for
``mfu.train`` and the least bytes of the GroupNorm work for
``gn_roofline.e2e``. Frozen here, like ``work``, so that a later change to
the program cannot move the numerators.

A training step on a batch of B designs runs the CNN's forward and backward
(3x its forward) and the frozen decoder's forward and its data gradient
(2x its forward: no weight gradient). The held-out pass's forwards, of
``n_val // B`` batches an epoch, are spread over the epoch's ``n_train //
B`` steps. The CNN's FLOPs are those of its products (convolutions and
linear layers, 2 per multiply-add); the decoder's are ``work.field_flops``.
"""

from __future__ import annotations

from benchlib import work


def _conv2d(cin: int, cout: int, k: int, side: int) -> float:
    return 2.0 * cin * cout * k * k * side * side


def cnn_forward_flops(filters, side: int, outputs) -> float:
    """Forward FLOPs of one ``side x side`` image through the CNN conditioner
    (7x7 stem, 3x3/2 pool, bottleneck blocks with stride 2 on blocks 1 and 3,
    squeeze-excitation and 7x7 spatial attention on blocks 2-4, then the
    linear layers and the two heads of widths ``outputs``)."""
    f = list(filters)
    fl = _conv2d(1, f[0], 7, side)
    s = side // 2
    for i, (cin, cout) in enumerate(zip(f[:-1], f[1:])):
        mid, out = cout // 2, s // 2 if i in (1, 3) else s
        fl += _conv2d(cin, mid, 1, s) + _conv2d(mid, cout, 3, out)
        if i in (1, 3) or cin != cout:
            fl += _conv2d(cin, cout, 1, out)
        if 2 <= i <= 4:
            fl += 2.0 * 2 * cout * max(cout // 16, 1) + _conv2d(2, 1, 7, out)
        s = out
    hidden = 2 * f[-1]
    fl += 2.0 * (f[-1] * hidden + hidden * hidden)
    for width in outputs:
        fl += 2.0 * (hidden * hidden // 2 + hidden // 2 * hidden // 4 + hidden * hidden // 4
                     + hidden // 4 * width)
    return fl


def split(cfg: dict) -> tuple:
    """``(training steps, held-out batches)`` of one epoch."""
    n, b = cfg["num_param"], cfg["e2e"]["batch_size"]
    n_val = int(n * cfg["e2e"]["val_split"])
    return (n - n_val) // b, n_val // b


def step_flops(cfg: dict) -> float:
    """Model FLOPs of one training step, the held-out pass's share included."""
    c = cfg["conditioner"]
    levels = len(cfg["num_filter_enc"]) - 1
    cnn = cnn_forward_flops(c["filters"], c["image_side"],
                            (cfg["latent_dim_end"], cfg["latent_dim"] * levels))
    dec = work.field_flops(cfg)
    steps, held_out = split(cfg)
    b = cfg["e2e"]["batch_size"]
    return b * (3.0 * cnn + 2.0 * dec) + held_out * b / steps * (cnn + dec)


def gn_bytes(cfg: dict) -> float:
    """The least bytes of one training step's GroupNorm-plus-activation work:
    every decoder map at the batch read (x) and written (y) once forward,
    read (x, dy) and written (dx) once backward; the held-out pass's forward
    maps spread over the epoch's steps."""
    b = cfg["e2e"]["batch_size"]
    steps, held_out = split(cfg)
    elems = sum(n * t * c for n, t, c in work.gn_maps(cfg, b, train=False))
    return elems * work.DTYPE_BYTES[cfg["dtype"]] * (5.0 + 2.0 * held_out / steps)
