"""The work a cell asks of the chip, counted from the configuration's shapes
whatever implements it: model FLOPs for ``mfu.*`` and the least bytes of
the GroupNorm and AdamW work for their rooflines.

The FLOP model is a frozen copy of the op inventory of the reference VAE
(small variant) that ``bench_baseline.reference_step_ops`` counts, FLOPs
only: a train step is 3x the forward FLOPs of the ops that take part in the
backward; a decoded field is the decoder's and readout's forward share of
one sample. It is frozen here so that a later change to the program cannot
move the numerator of ``mfu.*``.
"""

from __future__ import annotations

EXPANSION = 5


def _conv(b, t, cin, cout, k):
    return 2.0 * b * t * cin * cout * k


def forward_ops(batch: int, t: int, node: int, filters, z: int, hier: int) -> list:
    """``[(name, forward FLOPs, in_backward)]`` of one forward pass."""
    ops = []
    f = list(filters)
    chans = [node] + f
    for i in range(len(f)):
        cin, cout = chans[i], chans[i + 1]
        ops.append((f"enc{i} conv k=1", _conv(batch, t, cin, cout, 1), True))
        ops.append((f"enc{i} GN+GELU", batch * t * cout, True))
        ops.append((f"enc{i} res k=3", _conv(batch, t, cout, cout, 3), True))
        ops.append((f"enc{i} res GN+GELU+add", batch * t * cout, True))
        ops.append((f"enc{i} xs linear", 2.0 * batch * cout * t * hier, True))
    ops.append(("enc final linear", 2.0 * batch * f[-1] * t * 2 * z, True))
    dec = f[::-1]
    ops.append(("dec z->z*t linear", 2.0 * batch * z * z * t, True))
    ops.append(("dec seq_start conv k=5", _conv(batch, t, z, dec[0], 5), True))
    for i in range(len(dec) - 1):
        cout = dec[i + 1]
        m = cout * EXPANSION
        ops.append((f"dec{i} block k=3", _conv(batch, t, dec[i], cout, 3), True))
        ops.append((f"dec{i} block GELU", batch * t * cout, True))
        ops.append((f"dec{i} res expand", _conv(batch, t, cout, m, 1), True))
        ops.append((f"dec{i} res k=5", _conv(batch, t, m, m, 5), True))
        ops.append((f"dec{i} res contract", _conv(batch, t, m, cout, 1), True))
        ops.append((f"dec{i} res GN+GELU", batch * t * (2 * m + cout), True))
        if i < len(dec) - 2:
            nxt = cout
            ops.append((f"dec{i} cond_z res", _conv(batch, t, nxt, nxt, 3), True))
            ops.append((f"dec{i} cond_z out", _conv(batch, t, nxt, 2 * nxt, 3), True))
            ops.append((f"dec{i} xs inject linear", 2.0 * batch * hier * nxt * t, True))
            ops.append((f"dec{i} cond_xz res", _conv(batch, t, 2 * nxt, 2 * nxt, 3), True))
            ops.append((f"dec{i} cond_xz out", _conv(batch, t, 2 * nxt, 2 * nxt, 3), True))
            ops.append((f"dec{i} kl_2 + reparam", batch * t * 2 * nxt, True))
    ops.append(("readout k=1", _conv(batch, t, dec[-1], node, 1), True))
    ops.append(("recon GroupNorm", batch * t * node, True))
    ops.append(("recon tanh", batch * t * node, True))
    ops.append(("recon MSE + monitor MSE", batch * t * node, True))
    return ops


def _geometry(cfg: dict) -> dict:
    return dict(t=cfg["num_time"], node=cfg["num_node"], filters=cfg["num_filter_enc"],
                z=cfg["latent_dim_end"], hier=cfg["latent_dim"])


def train_step_flops(cfg: dict, batch: int) -> float:
    """Model FLOPs of one train step: 3x the forward."""
    return 3.0 * sum(fl for _, fl, bwd in forward_ops(batch, **_geometry(cfg)) if bwd)


def field_flops(cfg: dict, batch: int = 16) -> float:
    """Forward FLOPs of one decoded field: the decoder and readout ops of a
    batch, over the batch."""
    ops = forward_ops(batch, **_geometry(cfg))
    dec = sum(fl for name, fl, _ in ops
              if name.startswith(("dec", "readout", "recon")))
    return dec / batch


def mlp_flops(filters, inputs: int, latent: int, outputs: int) -> float:
    """Forward FLOPs of one row through the MLP conditioner's products."""
    f = list(filters)
    fl = 2.0 * inputs * f[0]
    for a, b in zip(f[:-1], f[1:]):
        fl += 2.0 * (a * b + b * b + (a * b if a != b else 0))
    hidden = max(latent * 2, f[-1] // min(8, max(2, inputs // 64)))
    for width in outputs:
        fl += 2.0 * (f[-1] * hidden + hidden * (hidden // 2) + (hidden // 2) * width)
    return fl


def gn_maps(cfg: dict, batch: int, train: bool) -> list:
    """``[(B, T, C)]`` of every GroupNorm map of a train step (encoder and
    decoder) or of a decode (decoder only)."""
    t, n = cfg["num_time"], cfg["num_node"]
    f = list(cfg["num_filter_enc"])
    d = f[::-1]
    maps = []
    if train:
        for c in f:
            maps += [(batch, t, c), (batch, t, c)]
    maps.append((batch, t, d[0]))
    for i in range(len(d) - 1):
        c = d[i + 1]
        maps += [(batch, t, c * EXPANSION), (batch, t, c * EXPANSION), (batch, t, c)]
        if i < len(d) - 2:
            maps += [(batch, t, c), (batch, t, c), (batch, t, 2 * c)]
    maps.append((batch, t, n))
    return maps


DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def gn_bytes(cfg: dict, batch: int, train: bool) -> float:
    """The least bytes of a step's (or a decode's) GroupNorm-plus-activation
    work: forward reads x and writes y once; backward reads x and dy and
    writes dx once."""
    elems = sum(b * t * c for b, t, c in gn_maps(cfg, batch, train))
    size = DTYPE_BYTES[cfg["dtype"]]
    return elems * size * (2 + (3 if train else 0))


def adamw_bytes(param_count: int, moment_bytes: int = 4) -> float:
    """The least bytes of one AdamW step: f32 parameters read and written,
    f32 gradients read, both moments read and written."""
    return param_count * (4 + 4 + 4 + 4 * moment_bytes)
