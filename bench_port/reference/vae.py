"""Plain reference of the hierarchical conv VAE that the benchmark holds the
port against: its parameter shapes, forward pass, losses and spectral norm,
written from the published architecture in plain PyTorch, f32 by default.

It imports nothing of the program. Tensors are ``[B, T, C]`` (time, then
channels); convolution weights ``[out, in, k]``, dense weights ``[out, in]``.
Parameters are a flat ``{name: tensor}`` dict whose names are the interface
the benchmark shares with the program (``param_shapes``). Only the ``small``
variant is written.

Layers (``f`` the encoder's filters, ``d = f[::-1]`` the decoder's, L =
len(d) - 1 levels, ``h`` the hierarchical latent, ``z`` the main latent):

* GroupNorm over ``[B, T, C]`` with ``min(8, max(1, C // 4))`` groups
  (lowered to a divisor of C), eps 1e-5, then GELU (erf), tanh or nothing.
* Encoder level i: k=1 conv -> GN+GELU; then x + 0.1 GN+GELU(k=3 conv(x));
  a dense head on the channel-major flattened map gives the level's
  hierarchical latent; a last dense gives (mu, log_var). The deepest level's
  latent is dropped and the rest reversed.
* Decoder: dense z -> z*T, unflattened channel-major, k=5 conv, GN+GELU;
  per level: GELU(k=3 conv), then x + 0.1 (k=1 expand 5x, k=5, k=1
  contract, each GN+GELU); between levels a prior head (residual, GELU,
  k=3 conv to 2 c) and a posterior head on [injected h latent, x], a kl_2
  term, then z = mu + eps * std added to the next level's input.
* Readout: k=1 conv to the nodes, GroupNorm, tanh.

``lowp`` (a :class:`reference.lowp.LowPrecision`) rounds the batch, both
operands of every product and every layer's output, as a program storing
its tensors in that precision would: the control.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

EXPANSION = 5
GN_EPS = 1e-5
LOG_VAR_CLAMP = 30.0
SN_EPS = 1e-12


def group_count(channels: int) -> int:
    g = min(8, max(1, channels // 4))
    while channels % g:
        g -= 1
    return g


# -- parameters ----------------------------------------------------------------

def _conv(out: dict, name: str, c_out: int, c_in: int, k: int) -> None:
    out[f"{name}.weight"] = (c_out, c_in, k)
    out[f"{name}.bias"] = (c_out,)


def _dense(out: dict, name: str, c_out: int, c_in: int) -> None:
    out[f"{name}.weight"] = (c_out, c_in)
    out[f"{name}.bias"] = (c_out,)


def _norm(out: dict, name: str, c: int) -> None:
    out[f"{name}.scale"] = (c,)
    out[f"{name}.bias"] = (c,)


def _stages(out: dict, name: str, stages) -> None:
    for j, (i, o, k) in enumerate(stages):
        _conv(out, f"{name}.convs.{j}", o, i, k)
    for j, (_, o, _) in enumerate(stages):
        _norm(out, f"{name}.norms.{j}", o)


def _injector(out: dict, name: str, latent: int, features: int, t: int) -> None:
    _dense(out, f"{name}.dense", latent * t, latent)
    _conv(out, f"{name}.conv", features, latent, 5)
    _norm(out, f"{name}.norm", features)


def decoder_shapes(cfg: dict) -> dict:
    """``{name: shape}`` of the decoder, in the program's order."""
    t, n, z, h = cfg["num_time"], cfg["num_node"], cfg["latent_dim_end"], cfg["latent_dim"]
    d = list(cfg["num_filter_enc"])[::-1]
    levels = len(d) - 1
    out: dict = {}
    _injector(out, "decoder.sequence_start", z, d[0], t)
    for i in range(levels):
        _conv(out, f"decoder.dec_block.{i}.conv", d[i + 1], d[i], 3)
    for i in range(levels):
        c, m = d[i + 1], d[i + 1] * EXPANSION
        _stages(out, f"decoder.dec_res.{i}", [(c, m, 1), (m, m, 5), (m, c, 1)])
    for i in range(levels - 1):
        c = d[i + 1]
        _stages(out, f"decoder.condition_z.{i}.res", [(c, c, 3)])
        _conv(out, f"decoder.condition_z.{i}.conv", 2 * c, c, 3)
    for i in range(levels - 1):
        _injector(out, f"decoder.xs_sequence.{i}", h, d[i + 1], t)
    for i in range(levels - 1):
        c = 2 * d[i + 1]
        _stages(out, f"decoder.condition_xz.{i}.res", [(c, c, 3)])
        _conv(out, f"decoder.condition_xz.{i}.conv", c, c, 3)
    out["decoder.recon.kernel"] = (n, d[-1])
    out["decoder.recon.bias"] = (n,)
    out["decoder.recon.scale"] = (n,)
    out["decoder.recon.norm_bias"] = (n,)
    return out


def param_shapes(cfg: dict) -> dict:
    """``{name: shape}`` of the whole VAE (encoder, then decoder)."""
    if not cfg.get("small", True):
        raise NotImplementedError("the reference writes the small variant only")
    t, n, z, h = cfg["num_time"], cfg["num_node"], cfg["latent_dim_end"], cfg["latent_dim"]
    f = list(cfg["num_filter_enc"])
    out: dict = {}
    for i, (c_in, c) in enumerate(zip([n] + f[:-1], f)):
        _stages(out, f"encoder.enc_block.{i}", [(c_in, c, 1)])
    for i, c in enumerate(f):
        _stages(out, f"encoder.enc_res.{i}", [(c, c, 3)])
    for i, c in enumerate(f):
        _dense(out, f"encoder.xs_linear.{i}", h, c * t)
    _dense(out, "encoder.last_x_linear", 2 * z, f[-1] * t)
    out.update(decoder_shapes(cfg))
    return out


def sn_names(shapes: dict) -> list:
    """The spectrally normalised kernels: every conv and dense weight and the
    readout kernel."""
    return [k for k, s in shapes.items() if k.endswith(".weight") and len(s) >= 2
            or k.endswith("recon.kernel")]


# -- layers --------------------------------------------------------------------

class Layers:
    """The model's operations over a parameter dict ``p``; ``lowp`` rounds
    the operands of every product and every output."""

    def __init__(self, p: dict, lowp=None):
        self.p, self.lowp = p, lowp

    def _q(self, x):
        return x if self.lowp is None else self.lowp(x)

    def conv(self, name: str, x: torch.Tensor) -> torch.Tensor:
        w, b = self._q(self.p[f"{name}.weight"]), self.p[f"{name}.bias"]
        x = self._q(x)
        k = w.shape[-1]
        if k == 1:
            return self._q(x @ w[:, :, 0].t() + b)
        y = F.conv1d(x.transpose(1, 2), w, b, padding=k // 2)
        return self._q(y.transpose(1, 2))

    def dense(self, name: str, x: torch.Tensor) -> torch.Tensor:
        y = self._q(x) @ self._q(self.p[f"{name}.weight"]).t() + self.p[f"{name}.bias"]
        return self._q(y)

    def norm(self, name: str, x: torch.Tensor, act: str = "gelu", scale_key="scale",
             bias_key="bias") -> torch.Tensor:
        b, t, c = x.shape
        g = group_count(c)
        xg = x.reshape(b, t, g, c // g)
        mean = xg.mean(dim=(1, 3), keepdim=True)
        var = ((xg - mean) ** 2).mean(dim=(1, 3), keepdim=True)
        y = ((xg - mean) / torch.sqrt(var + GN_EPS)).reshape(b, t, c)
        y = y * self.p[f"{name}.{scale_key}"] + self.p[f"{name}.{bias_key}"]
        if act == "gelu":
            return self._q(F.gelu(y))
        if act == "tanh":
            return self._q(torch.tanh(y))
        return self._q(y)

    def stages(self, name: str, x: torch.Tensor, count: int) -> torch.Tensor:
        for j in range(count):
            x = self.norm(f"{name}.norms.{j}", self.conv(f"{name}.convs.{j}", x))
        return x

    def injector(self, name: str, v: torch.Tensor, t: int) -> torch.Tensor:
        hdn = self.dense(f"{name}.dense", v).reshape(v.shape[0], v.shape[1], t)
        return self.norm(f"{name}.norm", self.conv(f"{name}.conv", hdn.transpose(1, 2)))

    def head(self, name: str, x: torch.Tensor) -> torch.Tensor:
        r = x + 0.1 * self.stages(f"{name}.res", x, 1)
        return self.conv(f"{name}.conv", F.gelu(r))

    def readout(self, h: torch.Tensor) -> torch.Tensor:
        w = self._q(self.p["decoder.recon.kernel"])
        y = self._q(h) @ w.t() + self.p["decoder.recon.bias"]
        return self.norm("decoder.recon", y, "tanh", "scale", "norm_bias")


def flatten_channels_first(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(1, 2).reshape(x.shape[0], -1)


def encode(m: Layers, x: torch.Tensor, levels: int, z_dim: int):
    xs = []
    for i in range(levels):
        x = m.stages(f"encoder.enc_block.{i}", x, 1)
        x = x + 0.1 * m.stages(f"encoder.enc_res.{i}", x, 1)
        xs.append(m.dense(f"encoder.xs_linear.{i}", flatten_channels_first(x)))
    last = m.dense("encoder.last_x_linear", flatten_channels_first(x))
    return last[:, :z_dim], last[:, z_dim:], xs[:-1][::-1]


def kl(mu, log_var):
    log_var = log_var.clamp(-LOG_VAR_CLAMP, LOG_VAR_CLAMP)
    return (0.5 * torch.sum(mu ** 2 + torch.exp(log_var) - log_var - 1.0, dim=1)).mean()


def kl_2(delta_mu, delta_log_var, mu, log_var):
    log_var = log_var.clamp(-LOG_VAR_CLAMP, LOG_VAR_CLAMP)
    delta_log_var = delta_log_var.clamp(-LOG_VAR_CLAMP, LOG_VAR_CLAMP)
    var = torch.exp(log_var) + 1e-8
    terms = (torch.exp(delta_log_var) / var + (mu - delta_mu) ** 2 / var
             - delta_log_var + log_var - 1.0)
    return (0.5 * torch.sum(terms, dim=tuple(range(1, mu.dim())))).mean()


def decode(m: Layers, z: torch.Tensor, xs, t: int, levels: int, eps=None):
    """``(x_hat, kl_terms)``. ``eps`` holds the noise of each level's sample
    (``[B, T, c]``); None decodes the mean, as generation does (its std of
    1e-8 is below the f32 rounding of any sample)."""
    kls, out = [], None
    for i in range(levels):
        zs = m.injector("decoder.sequence_start", z, t) if i == 0 else out + z
        out = F.gelu(m.conv(f"decoder.dec_block.{i}.conv", zs))
        out = out + 0.1 * m.stages(f"decoder.dec_res.{i}", out, 3)
        if i == levels - 1:
            break
        mu, log_var = m.head(f"decoder.condition_z.{i}", out).chunk(2, dim=-1)
        xs_sample = m.injector(f"decoder.xs_sequence.{i}", xs[i], t)
        cond = m.head(f"decoder.condition_xz.{i}", torch.cat([xs_sample, out], dim=-1))
        d_mu, d_log_var = cond.chunk(2, dim=-1)
        kls.append(kl_2(d_mu, d_log_var, mu, log_var))
        mu, log_var = mu + d_mu, log_var + d_log_var
        if eps is None:
            z = mu
        else:
            std = torch.exp(0.5 * log_var.clamp(-LOG_VAR_CLAMP, LOG_VAR_CLAMP))
            z = mu + eps[i + 1] * std.clamp(1e-8, 10.0)
    return m.readout(out), kls


def forward_loss(m: Layers, cfg: dict, x: torch.Tensor, eps, beta: float):
    """The training loss ``alpha * MSE + beta * (KL + sum kl_2)`` of batch
    ``x`` with the noise ``eps`` (``[B, z]``, then one ``[B, T, c]`` per
    sampled level)."""
    levels = len(cfg["num_filter_enc"])
    x = m._q(x)
    mu, log_var, xs = encode(m, x, levels, cfg["latent_dim_end"])
    log_var = log_var.clamp(-LOG_VAR_CLAMP, LOG_VAR_CLAMP)
    std = torch.exp(0.5 * log_var).clamp(1e-8, 10.0)
    z = mu + eps[0] * std
    x_hat, kls = decode(m, z, xs, cfg["num_time"], levels - 1, eps)
    recon = torch.mean((x_hat - x) ** 2)
    return cfg["alpha"] * recon + beta * (kl(mu, log_var) + sum(kls))


def noise_shapes(cfg: dict, batch: int) -> list:
    """The shapes of one step's reparameterisation noise, in draw order."""
    d = list(cfg["num_filter_enc"])[::-1]
    return [(batch, cfg["latent_dim_end"])] + [(batch, cfg["num_time"], d[i + 1])
                                                for i in range(len(d) - 2)]


# -- spectral norm -------------------------------------------------------------

@torch.no_grad()
def power_iteration(w: torch.Tensor, u: torch.Tensor):
    """One power iteration on ``W`` viewed as ``[out, rest]``: ``(u', v)``."""
    mat = w.reshape(w.shape[0], -1)
    v = u @ mat
    v = v / (torch.linalg.vector_norm(v) + SN_EPS)
    mtv = mat @ v
    return mtv / (torch.linalg.vector_norm(mtv) + SN_EPS), v


def normalized(p: dict, us: dict, names) -> tuple:
    """``(p with every kernel in names divided by sigma, new us)``; sigma =
    u'^T W v carries W's gradient, u' and v are constants."""
    out, new_u = dict(p), {}
    for k in names:
        w = p[k]
        u2, v = power_iteration(w.detach(), us[k])
        sigma = u2 @ (w.reshape(w.shape[0], -1) @ v)
        out[k] = w / (sigma + SN_EPS)
        new_u[k] = u2
    return out, new_u
