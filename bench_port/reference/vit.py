"""Plain reference of ViT-B/16 as the end-to-end (E2E) image conditioner: its
forward in training mode and the E2E step that trains it through the frozen
VAE decoder, in f32 with TF32 off.

Written from Dosovitskiy et al., "An Image is Worth 16x16 Words" (ICLR 2021,
arXiv:2010.11929, eq. 1-4 and Table 1, "ViT-Base": 12 layers, hidden 768,
MLP 3072, 12 heads, 16 x 16 patches) and the description of SimulGen's ViT
conditioner. On an image ``[B, side^2]``:

* the ``side / 16`` squared patches in row-major order, each patch's 256
  pixels row-major, through one linear embedding; learned positions added;
  dropout on the tokens;
* each block pre-LN: ``t + Attn(LN1(t))`` then ``t + W2 drop(GELU(W1
  LN2(t)))``; the attention's q, k and v linear over ``heads * 64``, q
  scaled by ``1 / sqrt(64)``, a softmax over the keys, the dropout mask, the
  weighted values, the output projection;
* LayerNorm, the mean over the tokens, and two linear heads: the main
  latents ``[B, z]`` and the hierarchical ones ``[B, levels, hier]``.

Departures from ViT-B/16, as the program computes them:

* one input channel, so the patch embedding is 256 -> 768;
* the mean over the LayerNorm'd tokens in place of a class token;
* two linear heads (32 main latents, 3 x 8 hierarchical) in place of the
  classifier;
* learned positions for the 256 tokens of a 256 x 256 image;
* the attention dropout one mask ``[1, 1, q, k]`` for every sample and head
  (flax's ``broadcast_dropout``);
* dropout 0.2 on the tokens, the attention weights and the MLP's hidden
  units (the shipped condition file's rate, not the paper's regime);
* LayerNorm epsilon 1e-6; the exact (erf) GELU.

The E2E step is ``reference.e2e``'s with this conditioner: the descale, the
frozen decoder's ``"fix"`` decode, ``LC_alpha * Huber_0.1 + latent_reg_weight
* (0.9 MSE(main) + 0.1 MSE(hier))``, the hybrid clip, AdamW at the cosine
rate. The ViT has no spectral norm and no BatchNorm. It draws nothing: the
noisy batches, the dropout masks in call order (the tokens', then each
block's attention mask and MLP mask) and the decoder's noise are handed to
it as the program drew them.

``lowp`` (a ``reference.lowp.LowPrecision``) rounds the batch, both operands
of every product and every layer's output: the control.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from reference import e2e
from reference import vae

LN_EPS = 1e-6


def vit_shapes(cfg: dict) -> dict:
    """``{name: shape}`` of the ViT's parameters, under the program's names."""
    c = cfg["conditioner"]
    d, p = c["embed_dim"], c["patch_size"]
    wide = d * c["mlp_ratio"]
    tokens = (c["image_side"] // p) ** 2
    levels = len(cfg["num_filter_enc"]) - 1
    out = {"patch_embed.weight": (d, p * p), "patch_embed.bias": (d,),
           "pos_embed": (1, tokens, d)}

    def lin(name, o, i):
        out[f"{name}.weight"], out[f"{name}.bias"] = (o, i), (o,)

    def ln(name):
        out[f"{name}.weight"], out[f"{name}.bias"] = (d,), (d,)

    for i in range(c["depth"]):
        b = f"blocks.{i}"
        ln(f"{b}.ln1")
        for name in ("query", "key", "value", "out"):
            lin(f"{b}.attn.{name}", d, d)
        ln(f"{b}.ln2")
        lin(f"{b}.fc1", wide, d)
        lin(f"{b}.fc2", d, wide)
    ln("norm")
    lin("latent_main_head", cfg["latent_dim_end"], d)
    lin("xs_head", cfg["latent_dim"] * levels, d)
    return out


def vit_train(p: dict, x: torch.Tensor, c: dict, levels: int, hier: int, masks, lowp=None):
    """``(main [B, z], hier [B, levels, hier])`` of images ``[B, side^2]`` in
    training mode; ``masks`` yields the dropout masks (kept units scaled by
    1 / (1 - rate), dropped ones 0) in the order the layers draw them."""
    def q(t):
        return t if lowp is None else lowp(t)

    def lin(name, t):
        return q(q(t) @ q(p[f"{name}.weight"]).t() + p[f"{name}.bias"])

    def ln(name, t):
        return F.layer_norm(t, t.shape[-1:], p[f"{name}.weight"], p[f"{name}.bias"], LN_EPS)

    def drop(t):
        return t * next(masks).to(t.device)

    b, ps, heads = x.shape[0], c["patch_size"], c["num_heads"]
    side = int(round(x.shape[-1] ** 0.5))
    g = side // ps
    img = q(x).reshape(b, side, side)[:, : g * ps, : g * ps]
    patches = img.reshape(b, g, ps, g, ps).permute(0, 1, 3, 2, 4).reshape(b, g * g, ps * ps)
    t = drop(lin("patch_embed", patches) + p["pos_embed"])
    n, d = t.shape[1], t.shape[2]
    dh = d // heads
    for i in range(c["depth"]):
        blk = f"blocks.{i}"
        h = ln(f"{blk}.ln1", t)

        def split(name):
            return lin(f"{blk}.attn.{name}", h).reshape(b, n, heads, dh).transpose(1, 2)

        qs = split("query") / math.sqrt(dh)
        a = drop(q(torch.softmax(q(qs) @ q(split("key")).transpose(-1, -2), dim=-1)))
        o = q(q(a) @ q(split("value"))).transpose(1, 2).reshape(b, n, d)
        t = t + lin(f"{blk}.attn.out", o)
        h = drop(F.gelu(lin(f"{blk}.fc1", ln(f"{blk}.ln2", t))))
        t = t + lin(f"{blk}.fc2", h)
    f = ln("norm", t).mean(1)
    return lin("latent_main_head", f), lin("xs_head", f).reshape(-1, levels, hier)


def loss(cfg: dict, p: dict, dec: vae.Layers, scalers: dict, batch, masks, eps, lowp=None):
    """``(E2E loss, (main, hier))`` of one noisy batch."""
    e = cfg["e2e"]
    levels = len(cfg["num_filter_enc"]) - 1
    x, y1, y2, target = batch
    main, hier = vit_train(p, x, cfg["conditioner"], levels, cfg["latent_dim"], iter(masks),
                           lowp)
    z = (main - scalers["lv_min"]) / scalers["lv_scale"]
    n = hier.shape[0]
    xs = ((hier.reshape(n, -1) - scalers["xs_min"]) / scalers["xs_scale"]).reshape(hier.shape)
    field = e2e.decode_fix(dec, z, [xs[:, i] for i in range(levels)], cfg["num_time"], levels,
                           eps)
    reg = 0.9 * torch.mean((main - y1) ** 2) + 0.1 * torch.mean((hier - y2) ** 2)
    return e["lc_alpha"] * e2e.huber(field, target) + e["latent_reg_weight"] * reg, (main, hier)


def train_steps(cfg: dict, params: dict, dec: dict, dec_us: dict, scalers: dict, batches,
                masks, eps, epoch: int = 0, lowp=None) -> dict:
    """Run ``len(batches)`` steps from the ViT's f32 ``params`` (not
    modified) through the decoder ``dec`` (raw f32 weights, folded with
    ``dec_us``). Returns ``{"losses", "grads": the first step's clipped
    gradient, "step_grads": each step's, "params": the parameters after the
    last step, "latents": the first step's ``(main, hier)``}``. Products run
    in f32, TF32 off."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        return _steps(cfg, params, dec, dec_us, scalers, batches, masks, eps, epoch, lowp)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _steps(cfg, params, dec, dec_us, scalers, batches, masks, eps, epoch, lowp):
    e = cfg["e2e"]
    lr = e2e.learning_rate(epoch, e["lr"], e["epochs"])
    p = {k: v.detach().clone() for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    layers = vae.Layers(e2e.folded_decoder(dec, dec_us), lowp)
    losses, step_grads, latents = [], [], None
    for t, (batch, mk, ep) in enumerate(zip(batches, masks, eps), start=1):
        leaves = {k: w.requires_grad_() for k, w in p.items()}
        value, out = loss(cfg, leaves, layers, scalers, batch, mk, ep, lowp)
        if latents is None:
            latents = tuple(o.detach().clone() for o in out)
        grads = torch.autograd.grad(value, list(leaves.values()))
        grads = e2e.hybrid_clip(list(grads))
        losses.append(float(value.detach()))
        with torch.no_grad():
            p = {k: w.detach() for k, w in leaves.items()}
            step_grads.append({k: g.clone() for k, g in zip(p, grads)})
            c1, c2 = 1.0 - e2e.B1 ** t, 1.0 - e2e.B2 ** t
            for (k, w), g in zip(p.items(), grads):
                m[k].mul_(e2e.B1).add_(g, alpha=1.0 - e2e.B1)
                v2[k].mul_(e2e.B2).add_(g * g, alpha=1.0 - e2e.B2)
                upd = (m[k] / c1) / (torch.sqrt(v2[k] / c2) + e2e.ADAM_EPS) + e["weight_decay"] * w
                w.sub_(lr * upd)
        del grads, value, out, leaves
    return {"losses": losses, "grads": step_grads[0], "step_grads": step_grads, "params": p,
            "latents": latents}
