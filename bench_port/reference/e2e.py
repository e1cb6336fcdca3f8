"""Plain reference of the end-to-end (E2E) latent-conditioner training step:
the image CNN trained through the frozen VAE decoder, in f32 with TF32 off.

Written from the published description (SimulGen-VAE,
``modules/latent_conditioner_e2e.py:213-561``, configured by
``input_data/condition.txt``, ``%End-to-End Training Configuration``). A
step on a batch ``(x, y1, y2, target)`` that already carries its input
noise:

* the CNN of ``reference.conditioner`` in training mode: GroupNorm, the
  heads' BatchNorms on the batch's statistics (biased variance, eps 1e-5),
  dropout, squeeze-excitation and spatial attention, and spectral norm on
  every ``sn_*`` kernel with one power iteration a step (``reference.vae``'s
  ``normalized``: ``u`` and ``v`` constants, sigma carrying W's gradient);
* the latents' affine descale ``z = (main - lv_min) / lv_scale``, the
  hierarchical ones likewise with the xs scaler;
* the frozen decoder's ``"fix"`` decode (``reference.vae``'s layers): its
  kernels divided by sigma from the stored vectors (no iteration, as a
  trained VAE is served), each level's sample ``mu + eps * clamp(1e-10 std,
  1e-8, 10)``;
* the loss ``LC_alpha * Huber_0.1(field, target) + latent_reg_weight *
  (0.9 MSE(main, y1) + 0.1 MSE(hier, y2))``, means over every element;
* the gradient by autograd, the hybrid clip of the global norm to [1e-5,
  10], then AdamW (decoupled decay, eps outside the root) at
  ``CosineAnnealingLR``'s rate for the epoch.

It draws nothing: every random draw is handed to it as the program made it
(the noisy batch, the dropout masks in call order, the decoder's noise).

Departures from ``latent_conditioner_e2e.py``:

* the descale stays in the autograd graph. The original detaches it (it
  round-trips through numpy for sklearn's ``inverse_transform``), so its
  reconstruction term trains nothing and only the regularisation does; the
  program keeps the gradient, and so does this reference;
* the decoder decodes in ``"fix"`` mode (the evaluator's), not ``"random"``;
* the hierarchical latents pass as one ``[B, levels, latent]`` tensor for
  any number of levels (the original hard-codes three in one branch).

``lowp`` (a ``reference.lowp.LowPrecision``) rounds the batch, both operands
of every product and every layer's output: the control.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from reference import conditioner as cond
from reference import vae

B1, B2, ADAM_EPS = 0.9, 0.999, 1e-8
BN_EPS = 1e-5
HUBER_DELTA = 0.1
CLIP_MIN, CLIP_MAX = 1e-5, 10.0
FIX_STD, STD_MIN, STD_MAX = 1e-10, 1e-8, 10.0
ETA_MIN = 1e-8


def sn_names(shapes: dict) -> list:
    """The conditioner's spectrally normalised kernels: a part of the name
    starts with ``sn_``."""
    return [k for k, s in shapes.items() if k.endswith(".weight") and len(s) >= 2
            and any(part.startswith("sn_") for part in k.split("."))]


def learning_rate(epoch: int, base_lr: float, epochs: int) -> float:
    """``CosineAnnealingLR(T_max=epochs, eta_min=1e-8)`` at ``epoch``."""
    t = min(max(epoch, 0), epochs)
    return ETA_MIN + (base_lr - ETA_MIN) * (1.0 + math.cos(math.pi * t / epochs)) / 2.0


@torch.no_grad()
def folded_decoder(dec: dict, us: dict) -> dict:
    """The decoder's weights with each kernel divided by ``|u^T W|`` (its
    stored vector, no iteration), as a trained VAE is handed over."""
    out = dict(dec)
    for k in vae.sn_names({n: tuple(t.shape) for n, t in dec.items()}):
        w = dec[k]
        sigma = torch.linalg.vector_norm(us[k] @ w.reshape(w.shape[0], -1))
        out[k] = w / sigma
    return out


def cnn_train(p: dict, x: torch.Tensor, filters, levels: int, hier: int, attention: bool,
              masks, lowp=None):
    """``(main [B, z], xs [B, levels, hier])`` of images ``[B, side^2]`` in
    training mode; ``masks`` yields the dropout masks (kept units scaled by
    1 / (1 - rate), dropped ones 0) in the order the layers draw them."""
    def q(t):
        return t if lowp is None else lowp(t)

    def conv(name, t, stride=1):
        w = p[f"{name}.weight"]
        return q(F.conv2d(q(t), q(w), None, stride, w.shape[-1] // 2))

    def gn(name, t):
        return F.group_norm(t, cond.cnn_groups(t.shape[1]), p[f"{name}.weight"],
                            p[f"{name}.bias"], 1e-5)

    def lin(name, t):
        return q(q(t) @ q(p[f"{name}.weight"]).t() + p[f"{name}.bias"])

    def ln(name, t):
        return F.layer_norm(t, t.shape[-1:], p[f"{name}.weight"], p[f"{name}.bias"],
                            cond.LN_EPS)

    def drop(t):
        return t * next(masks)

    side = int(round(x.shape[-1] ** 0.5))
    x = q(x).reshape(x.shape[0], 1, side, side)
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
    h = drop(h.mean((2, 3)))
    h = drop(F.relu(ln("ln1", lin("sn_fp1", h))))
    feats = drop(F.relu(ln("ln2", lin("sn_fp2", h))))

    def bn_stage(name, t):
        t = lin(f"{name}.sn_linear", t)
        mean = t.mean(0)
        var = ((t - mean) ** 2).mean(0)
        t = (t - mean) * torch.rsqrt(var + BN_EPS) * p[f"{name}.norm.weight"]
        return drop(F.relu(t + p[f"{name}.norm.bias"]))

    def head(name):
        a = bn_stage(f"{name}.layer2", bn_stage(f"{name}.layer1", feats))
        return lin(f"{name}.output", a + lin(f"{name}.skip_proj", feats))

    return head("latent_main"), head("xs").reshape(-1, levels, hier)


def decode_fix(m: vae.Layers, z: torch.Tensor, xs, t: int, levels: int, eps) -> torch.Tensor:
    """The decoder's ``"fix"`` decode ``[B, T, nodes]``; ``eps[i]`` the noise
    of level i's sample."""
    out = None
    for i in range(levels):
        zs = m.injector("decoder.sequence_start", z, t) if i == 0 else out + z
        out = F.gelu(m.conv(f"decoder.dec_block.{i}.conv", zs))
        out = out + 0.1 * m.stages(f"decoder.dec_res.{i}", out, 3)
        if i == levels - 1:
            break
        mu, log_var = m.head(f"decoder.condition_z.{i}", out).chunk(2, dim=-1)
        xs_sample = m.injector(f"decoder.xs_sequence.{i}", xs[i], t)
        d_mu, d_log_var = m.head(f"decoder.condition_xz.{i}",
                                 torch.cat([xs_sample, out], dim=-1)).chunk(2, dim=-1)
        mu, log_var = mu + d_mu, log_var + d_log_var
        std = torch.exp(0.5 * log_var.clamp(-vae.LOG_VAR_CLAMP, vae.LOG_VAR_CLAMP))
        z = mu + eps[i] * (std * FIX_STD).clamp(STD_MIN, STD_MAX)
    return m.readout(out)


def huber(pred: torch.Tensor, target: torch.Tensor, delta: float = HUBER_DELTA):
    d = (pred - target).abs()
    return torch.where(d < delta, 0.5 * d * d, delta * (d - 0.5 * delta)).mean()


def loss(cfg: dict, p: dict, dec: vae.Layers, scalers: dict, batch, masks, eps, lowp=None):
    """The E2E loss of one noisy batch."""
    c, e = cfg["conditioner"], cfg["e2e"]
    levels = len(cfg["num_filter_enc"]) - 1
    x, y1, y2, target = batch
    main, hier = cnn_train(p, x, c["filters"], levels, cfg["latent_dim"],
                           c["spatial_attention"], iter(masks), lowp)
    z = (main - scalers["lv_min"]) / scalers["lv_scale"]
    n = hier.shape[0]
    xs = ((hier.reshape(n, -1) - scalers["xs_min"]) / scalers["xs_scale"]).reshape(hier.shape)
    field = decode_fix(dec, z, [xs[:, i] for i in range(levels)], cfg["num_time"], levels, eps)
    reg = 0.9 * torch.mean((main - y1) ** 2) + 0.1 * torch.mean((hier - y2) ** 2)
    return e["lc_alpha"] * huber(field, target) + e["latent_reg_weight"] * reg


def hybrid_clip(grads: list) -> list:
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    if norm > CLIP_MAX:
        scale = CLIP_MAX / (norm + 1e-12)
    elif 0 < norm < CLIP_MIN:
        scale = CLIP_MIN / (norm + 1e-12)
    else:
        return grads
    return [g * scale for g in grads]


def train_steps(cfg: dict, params: dict, us: dict, dec: dict, dec_us: dict, scalers: dict,
                batches, masks, eps, epoch: int = 0, lowp=None) -> dict:
    """Run ``len(batches)`` steps from the conditioner's ``params`` (f32
    parameters and BatchNorm statistics, not modified) and vectors ``us``,
    through the decoder ``dec`` (raw f32 weights, folded with ``dec_us``).
    Returns ``{"losses", "grads": the first step's clipped gradient,
    "step_grads": each step's, "params": the parameters after the last step,
    "us": the vectors after it}``. Products run in f32, TF32 off."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        return _steps(cfg, params, us, dec, dec_us, scalers, batches, masks, eps, epoch, lowp)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _steps(cfg, params, us, dec, dec_us, scalers, batches, masks, eps, epoch, lowp):
    e = cfg["e2e"]
    lr = learning_rate(epoch, e["lr"], e["epochs"])
    stats = {k for k in params if k.endswith((".mean", ".var"))}
    p = {k: v.detach().clone() for k, v in params.items() if k not in stats}
    fixed = {k: params[k] for k in stats}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    names = sn_names({k: tuple(t.shape) for k, t in p.items()})
    layers = vae.Layers(folded_decoder(dec, dec_us), lowp)
    us = dict(us)
    losses, step_grads = [], []
    for t, (batch, mk, ep) in enumerate(zip(batches, masks, eps), start=1):
        leaves = {k: w.requires_grad_() for k, w in p.items()}
        normed, us = vae.normalized(leaves, us, names)
        value = loss(cfg, {**normed, **fixed}, layers, scalers, batch, mk, ep, lowp)
        grads = torch.autograd.grad(value, list(leaves.values()), allow_unused=True)
        grads = hybrid_clip([torch.zeros_like(w) if g is None else g
                             for w, g in zip(leaves.values(), grads)])
        losses.append(float(value.detach()))
        with torch.no_grad():
            p = {k: w.detach() for k, w in leaves.items()}
            step_grads.append({k: g.clone() for k, g in zip(p, grads)})
            c1, c2 = 1.0 - B1 ** t, 1.0 - B2 ** t
            for (k, w), g in zip(p.items(), grads):
                m[k].mul_(B1).add_(g, alpha=1.0 - B1)
                v2[k].mul_(B2).add_(g * g, alpha=1.0 - B2)
                upd = (m[k] / c1) / (torch.sqrt(v2[k] / c2) + ADAM_EPS) + e["weight_decay"] * w
                w.sub_(lr * upd)
        del grads, value, normed, leaves
    return {"losses": losses, "grads": step_grads[0], "step_grads": step_grads, "params": p,
            "us": us}
