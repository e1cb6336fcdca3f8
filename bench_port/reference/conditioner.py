"""Plain references of the latent conditioners (the MLP on design rows, the
CNN on images) in evaluation mode and of the serving path around them, f32.

MLP: LayerNorm(input) -> Linear -> LayerNorm -> GELU; residual blocks
``GELU(LN(W1 GELU(LN(W0 x))) + skip)``, the skip a Linear + LayerNorm
where the width changes; LayerNorm on the features; two heads
``tanh(W2 GELU(LN(W1 GELU(LN(W0 f)))))`` of widths ``hidden``, ``hidden / 2``
with ``hidden = max(2 z, filters[-1] // min(8, max(2, inputs // 64)))``.
LayerNorm eps is 1e-6. Dropout is off when serving.

CNN on ``[B, side^2]`` images in [0, 1] (moved there from [-1, 1] when the
batch's minimum is below -0.1): 7x7 conv -> GroupNorm -> ReLU -> 3x3/2 max
pool; bottleneck blocks (1x1 conv to half width, GN, ReLU, 3x3 conv with
stride 2 on blocks 1 and 3, GN; on blocks 2-4 squeeze-excitation and a 7x7
spatial attention over the channel mean and max; a 1x1 conv + GN skip
where the shape changes; ReLU of the sum); global mean; two Linear ->
LayerNorm -> ReLU of width 2 filters[-1]; heads ``Linear(a + skip)`` with
``a`` two Linear -> BatchNorm (running statistics) -> ReLU stages. GroupNorm
takes the largest of 32, 16, 8, 4, 2, 1 groups dividing the channels.

Serving: ``z = (main - lv_min) / lv_scale``, the hierarchical latents
likewise with the xs scaler, the decoder's mean path, then the field
``(x - data_min) / data_scale`` per node.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from reference import vae

LN_EPS = 1e-6


def head_width(filters, inputs: int, latent: int) -> int:
    ratio = min(8, max(2, inputs // 64))
    return max(latent * 2, filters[-1] // ratio)


def mlp_shapes(filters, inputs: int, latent: int, hier: int, levels: int) -> dict:
    """``{name: shape}`` of the MLP conditioner, in the program's order."""
    out: dict = {}

    def ln(name, c):
        out[f"{name}.weight"], out[f"{name}.bias"] = (c,), (c,)

    def lin(name, o, i):
        out[f"{name}.weight"], out[f"{name}.bias"] = (o, i), (o,)

    f = list(filters)
    ln("input_norm", inputs)
    lin("stem", f[0], inputs)
    ln("stem_norm", f[0])
    for i in range(1, len(f)):
        b = f"blocks.{i - 1}"
        lin(f"{b}.dense0", f[i], f[i - 1])
        ln(f"{b}.norm0", f[i])
        lin(f"{b}.dense1", f[i], f[i])
        ln(f"{b}.norm1", f[i])
        if f[i - 1] != f[i]:
            lin(f"{b}.project.0", f[i], f[i - 1])
            ln(f"{b}.project.1", f[i])
    hidden = head_width(f, inputs, latent)
    ln("feature_norm", f[-1])
    for name, width in (("latent_out", latent), ("xs_out", hier * levels)):
        lin(f"{name}.dense0", hidden, f[-1])
        ln(f"{name}.norm0", hidden)
        lin(f"{name}.dense1", hidden // 2, hidden)
        ln(f"{name}.norm1", hidden // 2)
        lin(f"{name}.dense2", width, hidden // 2)
    return out


def mlp(p: dict, x: torch.Tensor, filters, levels: int, hier: int, lowp=None):
    """``(main [B, z], xs [B, levels, hier])``."""
    def q(t):
        return t if lowp is None else lowp(t)

    def lin(name, t):
        return q(q(t) @ q(p[f"{name}.weight"]).t() + p[f"{name}.bias"])

    def ln(name, t):
        return F.layer_norm(t, t.shape[-1:], p[f"{name}.weight"], p[f"{name}.bias"], LN_EPS)

    h = F.gelu(ln("stem_norm", lin("stem", ln("input_norm", x))))
    f = list(filters)
    for i in range(1, len(f)):
        b = f"blocks.{i - 1}"
        y = F.gelu(ln(f"{b}.norm0", lin(f"{b}.dense0", h)))
        y = ln(f"{b}.norm1", lin(f"{b}.dense1", y))
        skip = h if f[i - 1] == f[i] else ln(f"{b}.project.1", lin(f"{b}.project.0", h))
        h = F.gelu(y + skip)
    feats = ln("feature_norm", h)

    def head(name):
        y = F.gelu(ln(f"{name}.norm0", lin(f"{name}.dense0", feats)))
        y = F.gelu(ln(f"{name}.norm1", lin(f"{name}.dense1", y)))
        return torch.tanh(lin(f"{name}.dense2", y))

    return head("latent_out"), head("xs_out").reshape(-1, levels, hier)


def cnn_groups(c: int) -> int:
    return next(g for g in (32, 16, 8, 4, 2, 1) if c % g == 0)


def cnn_shapes(filters, latent: int, hier: int, levels: int, attention: bool) -> dict:
    """``{name: shape}`` of the CNN conditioner's parameters and BatchNorm
    statistics, in the program's order."""
    out: dict = {}

    def norm(name, c, stats=False):
        out[f"{name}.weight"], out[f"{name}.bias"] = (c,), (c,)
        if stats:
            out[f"{name}.mean"], out[f"{name}.var"] = (c,), (c,)

    def lin(name, o, i):
        out[f"{name}.weight"], out[f"{name}.bias"] = (o, i), (o,)

    f = list(filters)
    out["sn_initial_conv.weight"] = (f[0], 1, 7, 7)
    norm("norm0", f[0])
    for i, (cin, cout) in enumerate(zip(f[:-1], f[1:])):
        b, mid = f"layers.{i}", cout // 2
        out[f"{b}.sn_conv1.weight"] = (mid, cin, 1, 1)
        norm(f"{b}.norm1", mid)
        out[f"{b}.sn_conv2.weight"] = (cout, mid, 3, 3)
        norm(f"{b}.norm2", cout)
        if attention and 2 <= i <= 4:
            lin(f"{b}.se.fc1", max(cout // 16, 1), cout)
            lin(f"{b}.se.fc2", cout, max(cout // 16, 1))
            out[f"{b}.spatial.conv.weight"] = (1, 2, 7, 7)
        if i in (1, 3) or cin != cout:
            out[f"{b}.sn_skip.weight"] = (cout, cin, 1, 1)
            norm(f"{b}.skip_norm", cout)
    hidden = 2 * f[-1]
    lin("sn_fp1", hidden, f[-1])
    norm("ln1", hidden)
    lin("sn_fp2", hidden, hidden)
    norm("ln2", hidden)
    for name, width in (("latent_main", latent), ("xs", hier * levels)):
        lin(f"{name}.layer1.sn_linear", hidden // 2, hidden)
        norm(f"{name}.layer1.norm", hidden // 2, stats=True)
        lin(f"{name}.layer2.sn_linear", hidden // 4, hidden // 2)
        norm(f"{name}.layer2.norm", hidden // 4, stats=True)
        lin(f"{name}.skip_proj", hidden // 4, hidden)
        lin(f"{name}.output", width, hidden // 4)
    return out


def cnn(p: dict, x: torch.Tensor, filters, levels: int, hier: int, attention: bool,
        lowp=None):
    """``(main [B, z], xs [B, levels, hier])`` of images ``[B, side^2]``."""
    def q(t):
        return t if lowp is None else lowp(t)

    def conv(name, t, stride=1):
        w = p[f"{name}.weight"]
        return q(F.conv2d(q(t), q(w), None, stride, w.shape[-1] // 2))

    def gn(name, t):
        return F.group_norm(t, cnn_groups(t.shape[1]), p[f"{name}.weight"],
                            p[f"{name}.bias"], 1e-5)

    def lin(name, t):
        return q(q(t) @ q(p[f"{name}.weight"]).t() + p[f"{name}.bias"])

    def ln(name, t):
        return F.layer_norm(t, t.shape[-1:], p[f"{name}.weight"], p[f"{name}.bias"], LN_EPS)

    side = int(round(x.shape[-1] ** 0.5))
    x = x.reshape(x.shape[0], 1, side, side)
    x = torch.where(x.min() < -0.1, (x + 1.0) / 2.0, x)
    h = F.max_pool2d(F.relu(gn("norm0", conv("sn_initial_conv", x))), 3, 2, 1)
    f = list(filters)
    for i, (cin, cout) in enumerate(zip(f[:-1], f[1:])):
        b, stride = f"layers.{i}", 2 if i in (1, 3) else 1
        y = F.relu(gn(f"{b}.norm1", conv(f"{b}.sn_conv1", h)))
        y = gn(f"{b}.norm2", conv(f"{b}.sn_conv2", y, stride))
        if attention and 2 <= i <= 4:
            s = torch.sigmoid(lin(f"{b}.se.fc2", F.relu(lin(f"{b}.se.fc1", y.mean((2, 3))))))
            y = y * s[:, :, None, None]
            a = torch.cat([y.mean(1, keepdim=True), y.amax(1, keepdim=True)], dim=1)
            y = y * torch.sigmoid(conv(f"{b}.spatial.conv", a))
        skip = h if f"{b}.sn_skip.weight" not in p else gn(
            f"{b}.skip_norm", conv(f"{b}.sn_skip", h, stride))
        h = F.relu(y + skip)
    h = F.relu(ln("ln1", lin("sn_fp1", h.mean((2, 3)))))
    feats = F.relu(ln("ln2", lin("sn_fp2", h)))

    def bn_stage(name, t):
        t = lin(f"{name}.sn_linear", t)
        scale = p[f"{name}.norm.weight"] * torch.rsqrt(p[f"{name}.norm.var"] + 1e-5)
        return F.relu((t - p[f"{name}.norm.mean"]) * scale + p[f"{name}.norm.bias"])

    def head(name):
        a = bn_stage(f"{name}.layer2", bn_stage(f"{name}.layer1", feats))
        return lin(f"{name}.output", a + lin(f"{name}.skip_proj", feats))

    return head("latent_main"), head("xs").reshape(-1, levels, hier)


def conditioner_shapes(cfg: dict) -> dict:
    c = cfg["conditioner"]
    levels = len(cfg["num_filter_enc"]) - 1
    if c["type"] == "mlp":
        return mlp_shapes(c["filters"], c["inputs"], cfg["latent_dim_end"], cfg["latent_dim"],
                          levels)
    return cnn_shapes(c["filters"], cfg["latent_dim_end"], cfg["latent_dim"], levels,
                      c["spatial_attention"])


def serve(cfg: dict, dec: dict, cond: dict, scalers: dict, designs: torch.Tensor,
          lowp=None) -> torch.Tensor:
    """The descaled fields ``[n, T, N]`` of ``designs`` (``[n, inputs]`` rows
    or ``[n, side^2]`` images)."""
    levels = len(cfg["num_filter_enc"]) - 1
    c = cfg["conditioner"]
    if c["type"] == "mlp":
        main, xs = mlp(cond, designs, c["filters"], levels, cfg["latent_dim"], lowp)
    else:
        main, xs = cnn(cond, designs, c["filters"], levels, cfg["latent_dim"],
                       c["spatial_attention"], lowp)
    z = (main - scalers["lv_min"]) / scalers["lv_scale"]
    n = xs.shape[0]
    xs = ((xs.reshape(n, -1) - scalers["xs_min"]) / scalers["xs_scale"]).reshape(xs.shape)
    x_hat, _ = vae.decode(vae.Layers(dec, lowp), z, [xs[:, i] for i in range(levels)],
                          cfg["num_time"], levels)
    return (x_hat - scalers["data_min"]) / scalers["data_scale"]
