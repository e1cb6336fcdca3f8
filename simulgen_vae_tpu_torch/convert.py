"""Weight bridge: JAX trees (nested dicts of numpy arrays) -> the port's modules and state.

Layout rules (the same as ``scripts/export_torch_state.py``, re-implemented):

* a k-tap conv kernel, HIO ``[k, C, F]``, becomes ``[F, C, k]``; no tap flip,
  since both packages run a cross-correlation;
* a dense kernel ``[in, out]`` becomes ``[out, in]``;
* the readout kernel ``[F, nodes]`` becomes ``[nodes, F]``;
* GroupNorm and LayerNorm affines keep their shapes.

Each ``*_state`` function returns a flat ``{name: array}`` keyed like the
port module's ``state_dict``; :func:`load_state` copies it in (strict: every
key must match). The VAE's functions take a ``leaves`` strategy, so that
one walk of the tree serves every tree of the VAE's layout: parameters, and
equally gradients and AdamW moments (:data:`PARAMS`), or the spectral-norm
``u`` vectors, one per kernel, keyed by their kernel's name (:data:`SN_U`).
The ``random_*_tree`` functions make trees with the JAX modules' paths and
shapes from a numpy generator, for runs without trained weights.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from simulgen_vae_tpu_torch.config import LCConfig, VAEConfig
from simulgen_vae_tpu_torch.models.conditioner_mlp import LatentConditioner
from simulgen_vae_tpu_torch.models.vae import VAE

State = Dict[str, np.ndarray]


def _np(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float32)


class _Params:
    """Leaves of a parameter-shaped tree (parameters, gradients, moments)."""

    @staticmethod
    def conv(a):
        return _np(a).transpose(2, 1, 0)

    @staticmethod
    def dense(a):
        return _np(a).T

    vec = staticmethod(_np)


class _SnU:
    """Leaves of a spectral-norm ``u`` tree: one ``[out]`` vector per kernel,
    kept as it is (it lives on the out axis in both layouts); no vectors."""

    conv = dense = staticmethod(_np)
    vec = None


PARAMS, SN_U = _Params(), _SnU()


def _prefixed(prefix: str, state: State) -> State:
    return {f"{prefix}.{k}": v for k, v in state.items()}


def _vecs(tree, names, leaves) -> State:
    """The vector leaves ``names`` of ``tree`` as they are (none for u trees)."""
    if leaves.vec is None:
        return {}
    return {port: leaves.vec(tree[jax]) for jax, port in names}


def conv_state(tree, leaves=PARAMS) -> State:
    """flax ``Conv1d`` subtree ``{Conv_0: {kernel [k, C, F], bias}}``."""
    return {"weight": leaves.conv(tree["Conv_0"]["kernel"]),
            **_vecs(tree["Conv_0"], [("bias", "bias")], leaves)}


def linear_state(tree, leaves=PARAMS) -> State:
    """A dense layer's ``{kernel [in, out], bias}``."""
    return {"weight": leaves.dense(tree["kernel"]),
            **_vecs(tree, [("bias", "bias")], leaves)}


def norm_state(tree, leaves=PARAMS) -> State:
    return _vecs(tree, [("scale", "scale"), ("bias", "bias")], leaves)


def layer_norm_state(tree) -> State:
    return {"weight": _np(tree["scale"]), "bias": _np(tree["bias"])}


def stages_state(tree, leaves=PARAMS) -> State:
    """``Conv1d_j`` / ``NormAct_j`` stages: ConvBlock, ResidualBlock,
    EncoderResidualBlock, DecoderResidualBlock."""
    out = {}
    for j in range(sum(1 for k in tree if k.startswith("Conv1d_"))):
        out.update(_prefixed(f"convs.{j}", conv_state(tree[f"Conv1d_{j}"], leaves)))
        out.update(_prefixed(f"norms.{j}", norm_state(tree.get(f"NormAct_{j}"), leaves)))
    return out


def decoder_block_state(tree, leaves=PARAMS) -> State:
    return _prefixed("conv", conv_state(tree["Conv1d_0"], leaves))


def latent_injector_state(tree, leaves=PARAMS) -> State:
    return {**_prefixed("dense", linear_state(tree["Dense_0"]["Dense_0"], leaves)),
            **_prefixed("conv", conv_state(tree["Conv1d_0"], leaves)),
            **_prefixed("norm", norm_state(tree.get("NormAct_0"), leaves))}


def condition_head_state(tree, leaves=PARAMS) -> State:
    return {**_prefixed("res", stages_state(tree["ResidualBlock_0"], leaves)),
            **_prefixed("conv", conv_state(tree["Conv1d_0"], leaves))}


def readout_state(tree, leaves=PARAMS) -> State:
    return {"kernel": leaves.dense(tree["kernel"]),
            **_vecs(tree, [("bias", "bias"), ("scale", "scale"),
                           ("norm_bias", "norm_bias")], leaves)}


def decoder_state(tree, leaves=PARAMS) -> State:
    """The ``vae_params['decoder']`` tree -> ``models.decoder.Decoder``."""
    out = _prefixed("sequence_start",
                    latent_injector_state(tree["sequence_start"], leaves))
    n = sum(1 for k in tree if k.startswith("dec_block_"))
    for i in range(n):
        out.update(_prefixed(f"dec_block.{i}",
                             decoder_block_state(tree[f"dec_block_{i}"], leaves)))
        out.update(_prefixed(f"dec_res.{i}", stages_state(tree[f"dec_res_{i}"], leaves)))
    for i in range(n - 1):
        out.update(_prefixed(f"condition_z.{i}",
                             condition_head_state(tree[f"condition_z_{i}"], leaves)))
        out.update(_prefixed(f"xs_sequence.{i}",
                             latent_injector_state(tree[f"xs_sequence_{i}"], leaves)))
        out.update(_prefixed(f"condition_xz.{i}",
                             condition_head_state(tree[f"condition_xz_{i}"], leaves)))
    out.update(_prefixed("recon", readout_state(tree["recon"], leaves)))
    return out


def encoder_state(tree, leaves=PARAMS) -> State:
    """The ``vae_params['encoder']`` tree -> ``models.encoder.Encoder``."""
    out = {}
    n = sum(1 for k in tree if k.startswith("enc_block_"))
    for i in range(n):
        out.update(_prefixed(f"enc_block.{i}", stages_state(tree[f"enc_block_{i}"], leaves)))
        out.update(_prefixed(f"enc_res.{i}", stages_state(tree[f"enc_res_{i}"], leaves)))
        out.update(_prefixed(f"xs_linear.{i}",
                             linear_state(tree[f"xs_linear_{i}"]["Dense_0"], leaves)))
    out.update(_prefixed("last_x_linear",
                         linear_state(tree["last_x_linear"]["Dense_0"], leaves)))
    return out


def vae_state(tree, leaves=PARAMS) -> State:
    """A whole VAE tree (``{'encoder', 'decoder'}``) -> ``models.vae.VAE``
    names: parameters, gradients or AdamW moments."""
    return {**_prefixed("encoder", encoder_state(tree["encoder"], leaves)),
            **_prefixed("decoder", decoder_state(tree["decoder"], leaves))}


def sn_u_state(tree) -> State:
    """A JAX ``sn_u`` tree -> ``{kernel parameter name: u}``, the keys of
    ``models.spectral_norm``'s state."""
    return vae_state(tree, SN_U)


def adamw_state(opt_state) -> dict:
    """A JAX ``FusedAdamWState`` (``count``, ``mu``, ``nu``) -> the port's
    ``{"count", "mu", "nu"}`` keyed by parameter name, as f32 numpy arrays.
    numpy has no bf16: bf16 moments come over as their f32 values, which are
    exact in bf16, and :func:`train_state_from_jax` casts them back."""
    return {"count": int(np.asarray(opt_state.count)),
            "mu": vae_state(opt_state.mu), "nu": vae_state(opt_state.nu)}


def _mlp_block_state(tree) -> State:
    out = {**_prefixed("dense0", linear_state(tree["Dense_0"])),
           **_prefixed("norm0", layer_norm_state(tree["LayerNorm_0"])),
           **_prefixed("dense1", linear_state(tree["Dense_1"])),
           **_prefixed("norm1", layer_norm_state(tree["LayerNorm_1"]))}
    if "Dense_2" in tree:  # the projected identity
        out.update(_prefixed("project.0", linear_state(tree["Dense_2"])))
        out.update(_prefixed("project.1", layer_norm_state(tree["LayerNorm_2"])))
    return out


def _head_state(tree) -> State:
    return {**_prefixed("dense0", linear_state(tree["Dense_0"])),
            **_prefixed("norm0", layer_norm_state(tree["LayerNorm_0"])),
            **_prefixed("dense1", linear_state(tree["Dense_1"])),
            **_prefixed("norm1", layer_norm_state(tree["LayerNorm_1"])),
            **_prefixed("dense2", linear_state(tree["Dense_2"]))}


def conditioner_state(tree) -> State:
    """The MLP conditioner's ``params`` tree -> ``LatentConditioner``."""
    out = {**_prefixed("input_norm", layer_norm_state(tree["input_norm"])),
           **_prefixed("stem", linear_state(tree["Dense_0"])),
           **_prefixed("stem_norm", layer_norm_state(tree["LayerNorm_0"])),
           **_prefixed("feature_norm", layer_norm_state(tree["feature_norm"])),
           **_prefixed("latent_out", _head_state(tree["latent_out"])),
           **_prefixed("xs_out", _head_state(tree["xs_out"]))}
    n = sum(1 for k in tree if k.startswith("_MLPResidualBlock_"))
    for j in range(n):
        out.update(_prefixed(f"blocks.{j}", _mlp_block_state(tree[f"_MLPResidualBlock_{j}"])))
    return out


def load_state(module: nn.Module, state: State) -> nn.Module:
    """Copy ``state`` into ``module``, cast to each parameter's dtype and
    device; every key must match and every shape agree."""
    tensors = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in state.items()}
    module.load_state_dict(tensors, strict=True)
    return module


def _tensors(state: State, device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)).to(device)
            for k, v in state.items()}


def train_state_from_jax(trainer, jax_state):
    """A JAX ``VAETrainState`` as numpy (``params``, ``opt_state``, ``sn_u``,
    ``epoch``) -> the port's ``VAETrainState`` for ``trainer``, the moments in
    the dtypes of the trainer's optimizer."""
    from simulgen_vae_tpu_torch.train.vae_trainer import VAETrainState

    model = load_state(trainer.build_model(), vae_state(jax_state.params))
    opt = adamw_state(jax_state.opt_state)
    for part, dtype in (("mu", trainer.opt.moment_dtype), ("nu", trainer.opt.nu_dtype)):
        opt[part] = {k: v.to(dtype) for k, v in _tensors(opt[part], trainer.device).items()}
    sn_u = _tensors(sn_u_state(jax_state.sn_u), trainer.device) if jax_state.sn_u else {}
    return VAETrainState(model, opt, sn_u, int(np.asarray(jax_state.epoch)))


def vae_from_jax(decoder_tree, cfg: VAEConfig, device,
                 dtype: torch.dtype = torch.float32) -> VAE:
    vae = VAE(cfg.latent_dim_end, cfg.latent_dim, cfg.num_filter_dec,
              cfg.num_node, cfg.num_time, cfg.small, device, dtype)
    load_state(vae.decoder, decoder_state(decoder_tree))
    return vae.eval()


def conditioner_from_jax(tree, lc_cfg: LCConfig, cfg: VAEConfig,
                         device) -> LatentConditioner:
    input_shape = np.shape(tree["input_norm"]["scale"])[0]
    lc = LatentConditioner(lc_cfg.filters, cfg.latent_dim_end, input_shape,
                           cfg.latent_dim, cfg.num_hier, device)
    load_state(lc, conditioner_state(tree))
    return lc.eval()


# -- random trees in the JAX layout -------------------------------------------

def _he(rng: np.random.Generator, shape, fan_in: int) -> np.ndarray:
    bound = np.sqrt(6.0 / fan_in)
    return rng.uniform(-bound, bound, shape).astype(np.float32)


def _small(rng: np.random.Generator, n: int, around: float = 0.0) -> np.ndarray:
    return (around + 0.1 * rng.standard_normal(n)).astype(np.float32)


def _rand_dense(rng, fin, fout):
    return {"kernel": _he(rng, (fin, fout), fin), "bias": _small(rng, fout)}


def _rand_conv(rng, k, fin, fout):
    return {"Conv_0": {"kernel": _he(rng, (k, fin, fout), k * fin),
                       "bias": _small(rng, fout)}}


def _rand_norm(rng, c):
    return {"scale": _small(rng, c, 1.0), "bias": _small(rng, c)}


def _rand_stages(rng, stages):
    out = {}
    for j, (fin, fout, k) in enumerate(stages):
        out[f"Conv1d_{j}"] = _rand_conv(rng, k, fin, fout)
        out[f"NormAct_{j}"] = _rand_norm(rng, fout)
    return out


def _rand_injector(rng, latent, features, num_time):
    return {"Dense_0": {"Dense_0": _rand_dense(rng, latent, latent * num_time)},
            "Conv1d_0": _rand_conv(rng, 5, latent, features),
            "NormAct_0": _rand_norm(rng, features)}


def _rand_dense_layer(rng, fin, fout):
    return {"Dense_0": _rand_dense(rng, fin, fout)}


def _rand_head(rng, fin, features, small):
    reps = 1 if small else 2
    return {"ResidualBlock_0": _rand_stages(rng, [(fin, fin, 3)] * reps),
            "Conv1d_0": _rand_conv(rng, 3, fin, 2 * features)}


def random_decoder_tree(cfg: VAEConfig, rng: np.random.Generator) -> dict:
    """A ``vae_params['decoder']`` tree: He-uniform kernels, biases and norm
    affines near their inits (0 and 1) with spread 0.1."""
    f, t = cfg.num_filter_dec, cfg.num_time
    n = len(f) - 1
    tree = {"sequence_start": _rand_injector(rng, cfg.latent_dim_end, f[0], t)}
    for i in range(n):
        g, m = f[i + 1], 5 * f[i + 1]
        tree[f"dec_block_{i}"] = {"Conv1d_0": _rand_conv(rng, 3, f[i], g)}
        stages = ([(g, m, 1), (m, m, 5), (m, g, 1)] if cfg.small
                  else [(g, g, 1), (g, m, 5), (m, m, 5), (m, g, 1)])
        tree[f"dec_res_{i}"] = _rand_stages(rng, stages)
        if i < n - 1:
            tree[f"condition_z_{i}"] = _rand_head(rng, g, g, cfg.small)
            tree[f"xs_sequence_{i}"] = _rand_injector(rng, cfg.latent_dim, g, t)
            tree[f"condition_xz_{i}"] = _rand_head(rng, 2 * g, g, cfg.small)
    c = cfg.num_node
    tree["recon"] = {"kernel": _he(rng, (f[-1], c), f[-1]), "bias": _small(rng, c),
                     "scale": _small(rng, c, 1.0), "norm_bias": _small(rng, c)}
    return tree


def random_encoder_tree(cfg: VAEConfig, rng: np.random.Generator) -> dict:
    """A ``vae_params['encoder']`` tree, drawn as :func:`random_decoder_tree`."""
    f, t = list(cfg.num_filter_enc), cfg.num_time
    tree = {}
    for i, (fin, c) in enumerate(zip([cfg.num_node] + f[:-1], f)):
        stages = [(fin, c, 1)] + ([] if cfg.small else [(c, c, 3)])
        tree[f"enc_block_{i}"] = _rand_stages(rng, stages)
        tree[f"enc_res_{i}"] = _rand_stages(rng, [(c, c, 3)] * (1 if cfg.small else 2))
        tree[f"xs_linear_{i}"] = _rand_dense_layer(rng, c * t, cfg.latent_dim)
    tree["last_x_linear"] = _rand_dense_layer(rng, f[-1] * t, 2 * cfg.latent_dim_end)
    return tree


def random_vae_tree(cfg: VAEConfig, rng: np.random.Generator) -> dict:
    """A whole VAE ``params`` tree (``{'encoder', 'decoder'}``)."""
    return {"encoder": random_encoder_tree(cfg, rng),
            "decoder": random_decoder_tree(cfg, rng)}


def _rand_ln(rng, c):
    return {"scale": _small(rng, c, 1.0), "bias": _small(rng, c)}


def _rand_mlp_head(rng, fin, hidden, out_dim):
    return {"Dense_0": _rand_dense(rng, fin, hidden), "LayerNorm_0": _rand_ln(rng, hidden),
            "Dense_1": _rand_dense(rng, hidden, hidden // 2),
            "LayerNorm_1": _rand_ln(rng, hidden // 2),
            "Dense_2": _rand_dense(rng, hidden // 2, out_dim)}


def random_conditioner_tree(lc_cfg: LCConfig, cfg: VAEConfig, input_shape: int,
                            rng: np.random.Generator) -> dict:
    """An MLP conditioner ``params`` tree with the JAX module's paths."""
    filt = list(lc_cfg.filters)
    tree = {"input_norm": _rand_ln(rng, input_shape),
            "Dense_0": _rand_dense(rng, input_shape, filt[0]),
            "LayerNorm_0": _rand_ln(rng, filt[0])}
    for j in range(1, len(filt)):
        fin, fout = filt[j - 1], filt[j]
        block = {"Dense_0": _rand_dense(rng, fin, fout), "LayerNorm_0": _rand_ln(rng, fout),
                 "Dense_1": _rand_dense(rng, fout, fout), "LayerNorm_1": _rand_ln(rng, fout)}
        if fin != fout:
            block["Dense_2"] = _rand_dense(rng, fin, fout)
            block["LayerNorm_2"] = _rand_ln(rng, fout)
        tree[f"_MLPResidualBlock_{j - 1}"] = block
    hidden = max(cfg.latent_dim_end * 2,
                 filt[-1] // min(8, max(2, input_shape // 64)))
    tree["feature_norm"] = _rand_ln(rng, filt[-1])
    tree["latent_out"] = _rand_mlp_head(rng, filt[-1], hidden, cfg.latent_dim_end)
    tree["xs_out"] = _rand_mlp_head(rng, filt[-1], hidden,
                                    cfg.latent_dim * cfg.num_hier)
    return tree
