"""Weight bridge between JAX trees (nested dicts of numpy arrays) and the port's modules.

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
shapes from a numpy generator, for runs without trained weights (or, given
no generator, a skeleton of those paths with empty leaves).

The other direction, :func:`vae_tree` and :func:`conditioner_tree`, turns a
trained port module into the tree the JAX package's ``save_flax_model``
writes: the ``*_state`` walk runs over a skeleton whose leaves are their own
paths (:data:`PATHS`), which maps each port name to its JAX path and layout,
and each tensor goes back through the inverse layout rule.

The image conditioners (CNN, simple CNN, ViT) are mapped by
:func:`image_conditioner_paths`: ``{port name: (layout, JAX path)}`` read off
the port module, over the whole flax variables tree (``params`` and
``batch_stats``), with 2-D convs (HWIO ``[kh, kw, in, out]`` <-> ``[out, in,
kh, kw]``) and the attention's ``DenseGeneral`` kernels (``[in, heads,
head_dim]`` and ``[heads, head_dim, out]`` <-> ``nn.Linear`` over ``heads *
head_dim``) among its layouts. Both directions read the same map, so a leaf
that one side lacks raises, named.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from simulgen_vae_tpu_torch.config import LCConfig, VAEConfig
from simulgen_vae_tpu_torch.models.conditioner_cnn import LatentConditionerImg
from simulgen_vae_tpu_torch.models.conditioner_mlp import LatentConditioner
from simulgen_vae_tpu_torch.models.conditioner_simple_cnn import SimpleLatentConditionerImg
from simulgen_vae_tpu_torch.models.conditioner_vit import LatentConditionerViT
from simulgen_vae_tpu_torch.models.vae import VAE

IMAGE_INPUT_TYPES = ("image", "image_vit")

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


class _Paths:
    """Leaves of a tree of paths: each becomes ``(layout, path)``."""

    conv = staticmethod(lambda path: ("conv", path))
    dense = staticmethod(lambda path: ("dense", path))
    vec = staticmethod(lambda path: ("vec", path))


PARAMS, SN_U, PATHS = _Params(), _SnU(), _Paths()


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


def _norm_at(tree, name: str, leaves) -> State:
    """The GroupNorm ``tree[name]``; u trees have none."""
    return norm_state(tree[name], leaves) if leaves.vec is not None else {}


def layer_norm_state(tree, leaves=PARAMS) -> State:
    return _vecs(tree, [("scale", "weight"), ("bias", "bias")], leaves)


def stages_state(tree, leaves=PARAMS) -> State:
    """``Conv1d_j`` / ``NormAct_j`` stages: ConvBlock, ResidualBlock,
    EncoderResidualBlock, DecoderResidualBlock."""
    out = {}
    for j in range(sum(1 for k in tree if k.startswith("Conv1d_"))):
        out.update(_prefixed(f"convs.{j}", conv_state(tree[f"Conv1d_{j}"], leaves)))
        out.update(_prefixed(f"norms.{j}", _norm_at(tree, f"NormAct_{j}", leaves)))
    return out


def decoder_block_state(tree, leaves=PARAMS) -> State:
    return _prefixed("conv", conv_state(tree["Conv1d_0"], leaves))


def latent_injector_state(tree, leaves=PARAMS) -> State:
    return {**_prefixed("dense", linear_state(tree["Dense_0"]["Dense_0"], leaves)),
            **_prefixed("conv", conv_state(tree["Conv1d_0"], leaves)),
            **_prefixed("norm", _norm_at(tree, "NormAct_0", leaves))}


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


def _mlp_block_state(tree, leaves) -> State:
    out = {**_prefixed("dense0", linear_state(tree["Dense_0"], leaves)),
           **_prefixed("norm0", layer_norm_state(tree["LayerNorm_0"], leaves)),
           **_prefixed("dense1", linear_state(tree["Dense_1"], leaves)),
           **_prefixed("norm1", layer_norm_state(tree["LayerNorm_1"], leaves))}
    if "Dense_2" in tree:  # the projected identity
        out.update(_prefixed("project.0", linear_state(tree["Dense_2"], leaves)))
        out.update(_prefixed("project.1", layer_norm_state(tree["LayerNorm_2"], leaves)))
    return out


def _head_state(tree, leaves) -> State:
    return {**_prefixed("dense0", linear_state(tree["Dense_0"], leaves)),
            **_prefixed("norm0", layer_norm_state(tree["LayerNorm_0"], leaves)),
            **_prefixed("dense1", linear_state(tree["Dense_1"], leaves)),
            **_prefixed("norm1", layer_norm_state(tree["LayerNorm_1"], leaves)),
            **_prefixed("dense2", linear_state(tree["Dense_2"], leaves))}


def conditioner_state(tree, leaves=PARAMS) -> State:
    """The MLP conditioner's ``params`` tree (or its gradients) ->
    ``LatentConditioner`` names."""
    out = {**_prefixed("input_norm", layer_norm_state(tree["input_norm"], leaves)),
           **_prefixed("stem", linear_state(tree["Dense_0"], leaves)),
           **_prefixed("stem_norm", layer_norm_state(tree["LayerNorm_0"], leaves)),
           **_prefixed("feature_norm", layer_norm_state(tree["feature_norm"], leaves)),
           **_prefixed("latent_out", _head_state(tree["latent_out"], leaves)),
           **_prefixed("xs_out", _head_state(tree["xs_out"], leaves))}
    n = sum(1 for k in tree if k.startswith("_MLPResidualBlock_"))
    for j in range(n):
        out.update(_prefixed(f"blocks.{j}",
                             _mlp_block_state(tree[f"_MLPResidualBlock_{j}"], leaves)))
    return out


def _host_tensor(a: np.ndarray) -> torch.Tensor:
    """``a`` (a transposed view, often) as a contiguous CPU tensor. torch
    lays a transposed view out several times faster than numpy does at the
    flagship's conv kernels (``[5, 5120, 5120]`` -> ``[5120, 5120, 5]``)."""
    if not a.flags.writeable:
        a = a.copy(order="K")   # in memory order: a plain copy
    return torch.from_numpy(a).contiguous()


def load_state(module: nn.Module, state: State) -> nn.Module:
    """Copy ``state`` into ``module``, cast to each parameter's dtype and
    device; every key must match and every shape agree."""
    module.load_state_dict({k: _host_tensor(v) for k, v in state.items()}, strict=True)
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


def conditioner_from_jax(tree, lc_cfg: LCConfig, cfg: VAEConfig, device,
                         batch_stats=None) -> nn.Module:
    """The conditioner of ``lc_cfg.input_type`` from its JAX ``params`` tree
    (and, for the CNN, its ``batch_stats``), in eval mode: the CNN
    (``image``), the ViT (``image_vit``) or the MLP (any other)."""
    if lc_cfg.input_type in IMAGE_INPUT_TYPES:
        variables = {"params": tree, "batch_stats": batch_stats or {}}
        lc = image_conditioner(lc_cfg, cfg, device, variables)
        return load_image_conditioner(lc, variables).eval()
    input_shape = np.shape(tree["input_norm"]["scale"])[0]
    lc = LatentConditioner(lc_cfg.filters, cfg.latent_dim_end, input_shape,
                           cfg.latent_dim, cfg.num_hier, device, lc_cfg.dropout_rate)
    load_state(lc, conditioner_state(tree))
    return lc.eval()


# -- the port's modules -> JAX trees --------------------------------------------

def _path_tree(tree, prefix=()) -> dict:
    """``tree`` with each leaf replaced by its path (a tuple of keys)."""
    return {k: _path_tree(v, prefix + (k,)) if isinstance(v, dict) else prefix + (k,)
            for k, v in tree.items()}


def _to_tree(state_fn, skeleton: dict, module: nn.Module) -> dict:
    """``module``'s tensors as the JAX tree that ``state_fn`` reads: each port
    name's f32 array, in its JAX layout, at its JAX path."""
    names = state_fn(_path_tree(skeleton), PATHS)
    tensors = module.state_dict()
    if set(names) != set(tensors):
        raise ValueError(f"the module's names differ from the JAX layout's: "
                         f"{sorted(set(names) ^ set(tensors))[:8]}")
    out: dict = {}
    for name, (layout, path) in names.items():
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        t = _to_flax(layout, tensors[name].detach().float()).contiguous()
        node[path[-1]] = t.cpu().numpy()
    return out


def vae_tree(model: VAE, cfg: VAEConfig) -> dict:
    """A port VAE with its encoder (``VAETrainer.eval_params`` gives the one to
    serve) -> the JAX VAE's ``params`` tree (``{'encoder', 'decoder'}``)."""
    return _to_tree(vae_state, random_vae_tree(cfg, None), model)


def conditioner_tree(lc: nn.Module, lc_cfg: LCConfig, cfg: VAEConfig,
                     input_shape: Optional[int] = None) -> dict:
    """A port conditioner -> the JAX conditioner's ``params`` (the MLP's
    needs its ``input_shape``)."""
    return conditioner_variables(lc, lc_cfg, cfg, input_shape)["params"]


def conditioner_variables(lc: nn.Module, lc_cfg: LCConfig, cfg: VAEConfig,
                          input_shape: Optional[int] = None) -> dict:
    """A port conditioner -> ``{"params", "batch_stats"}``, the tree the JAX
    CLI saves as ``model_save/LatentConditioner`` (``batch_stats`` empty but
    for the CNNs')."""
    if lc_cfg.input_type in IMAGE_INPUT_TYPES:
        return image_conditioner_variables(lc)
    return {"params": _to_tree(conditioner_state,
                               random_conditioner_tree(lc_cfg, cfg, input_shape, None), lc),
            "batch_stats": {}}


# -- random trees in the JAX layout -------------------------------------------

def _he(rng: Optional[np.random.Generator], shape, fan_in: int) -> np.ndarray:
    if rng is None:  # a skeleton: the path is all that is read
        return np.empty(0, np.float32)
    bound = np.sqrt(6.0 / fan_in)
    return rng.uniform(-bound, bound, shape).astype(np.float32)


def _small(rng: Optional[np.random.Generator], n: int, around: float = 0.0) -> np.ndarray:
    if rng is None:
        return np.empty(0, np.float32)
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


# -- the image conditioners ----------------------------------------------------

def _path_recorders():
    out: dict = {}

    def conv(port, *path):
        out[f"{port}.weight"] = ("conv2d", ("params", *path, "kernel"))

    def dense(port, *path):
        out[f"{port}.weight"] = ("dense", ("params", *path, "kernel"))
        out[f"{port}.bias"] = ("vec", ("params", *path, "bias"))

    def norm(port, *path):
        out[f"{port}.weight"] = ("vec", ("params", *path, "scale"))
        out[f"{port}.bias"] = ("vec", ("params", *path, "bias"))

    def batch_norm(port, *path):
        norm(port, *path)
        out[f"{port}.mean"] = ("vec", ("batch_stats", *path, "mean"))
        out[f"{port}.var"] = ("vec", ("batch_stats", *path, "var"))

    return out, conv, dense, norm, batch_norm


def _cnn_paths(m: LatentConditionerImg) -> dict:
    out, conv, dense, norm, batch_norm = _path_recorders()
    conv("sn_initial_conv", "sn_initial_conv")
    norm("norm0", "GroupNorm_0")
    for i, block in enumerate(m.layers):
        p, j = f"layers.{i}", f"layer_{i}"
        conv(f"{p}.sn_conv1", j, "sn_conv1")
        norm(f"{p}.norm1", j, "GroupNorm_0")
        conv(f"{p}.sn_conv2", j, "sn_conv2")
        norm(f"{p}.norm2", j, "GroupNorm_1")
        if block.se is not None:
            dense(f"{p}.se.fc1", j, "SqueezeExcitation_0", "Dense_0")
            dense(f"{p}.se.fc2", j, "SqueezeExcitation_0", "Dense_1")
        if block.spatial is not None:
            conv(f"{p}.spatial.conv", j, "SpatialAttention_0", "Conv_0")
        if block.sn_skip is not None:
            conv(f"{p}.sn_skip", j, "sn_skip")
            norm(f"{p}.skip_norm", j, "GroupNorm_2")
    dense("sn_fp1", "sn_fp1")
    norm("ln1", "LayerNorm_0")
    dense("sn_fp2", "sn_fp2")
    norm("ln2", "LayerNorm_1")
    for head in ("latent_main", "xs"):
        for k in (1, 2):
            dense(f"{head}.layer{k}.sn_linear", f"{head}_layer{k}", "sn_linear")
            batch_norm(f"{head}.layer{k}.norm", f"{head}_layer{k}", "BatchNorm_0")
        dense(f"{head}.skip_proj", f"{head}_skip_proj")
        dense(f"{head}.output", f"{head}_output")
    return out


def _simple_cnn_paths(m: SimpleLatentConditionerImg) -> dict:
    out, conv, dense, _, batch_norm = _path_recorders()
    for i in range(len(m.convs)):
        conv(f"convs.{i}", f"Conv_{i}")
        batch_norm(f"norms.{i}", f"BatchNorm_{i}")
    for j, port in enumerate(("dense0", "dense1", "latent_main", "xs")):
        dense(port, f"Dense_{j}")
    return out


def _vit_paths(m: LatentConditionerViT) -> dict:
    out, _, dense, norm, _ = _path_recorders()
    h = m.num_heads
    dense("patch_embed", "patch_embed")
    out["pos_embed"] = ("vec", ("params", "pos_embed"))
    for i in range(len(m.blocks)):
        p, j = f"blocks.{i}", f"block_{i}"
        attn = (j, "MultiHeadDotProductAttention_0")
        norm(f"{p}.ln1", j, "LayerNorm_0")
        for name in ("query", "key", "value"):
            out[f"{p}.attn.{name}.weight"] = (("heads_in", h), ("params", *attn, name, "kernel"))
            out[f"{p}.attn.{name}.bias"] = (("heads_bias", h), ("params", *attn, name, "bias"))
        out[f"{p}.attn.out.weight"] = (("heads_out", h), ("params", *attn, "out", "kernel"))
        out[f"{p}.attn.out.bias"] = ("vec", ("params", *attn, "out", "bias"))
        norm(f"{p}.ln2", j, "LayerNorm_1")
        dense(f"{p}.fc1", j, "Dense_0")
        dense(f"{p}.fc2", j, "Dense_1")
    norm("norm", "LayerNorm_0")
    dense("latent_main_head", "latent_main_head")
    dense("xs_head", "xs_head")
    return out


def image_conditioner_paths(model: nn.Module) -> Dict[str, tuple]:
    """``{port state-dict name: (layout, JAX path)}`` of an image
    conditioner; each path starts with ``params`` or ``batch_stats``."""
    for cls, fn in ((LatentConditionerImg, _cnn_paths),
                    (SimpleLatentConditionerImg, _simple_cnn_paths),
                    (LatentConditionerViT, _vit_paths)):
        if isinstance(model, cls):
            return fn(model)
    raise TypeError(f"not an image conditioner: {type(model).__name__}")


def flax_ndim(layout) -> Optional[int]:
    """The rank of a leaf of ``layout`` in the flax tree (None: as the port's)."""
    kind = layout if isinstance(layout, str) else layout[0]
    return {"conv2d": 4, "dense": 2, "heads_in": 3, "heads_out": 3,
            "heads_bias": 2}.get(kind)


def _from_flax(layout, a: np.ndarray) -> np.ndarray:
    kind = layout if isinstance(layout, str) else layout[0]
    a = _np(a)
    if kind == "conv2d":
        return a.transpose(3, 2, 0, 1)
    if kind == "dense":
        return a.T
    if kind == "heads_in":
        return a.reshape(a.shape[0], -1).T
    if kind == "heads_out":
        return a.reshape(-1, a.shape[-1]).T
    if kind == "heads_bias":
        return a.reshape(-1)
    return a


def _to_flax(layout, t: torch.Tensor) -> torch.Tensor:
    """A port tensor back in the flax layout, on the tensor's device (a card
    transposes the flagship's [5120, 5120, 5] kernels far faster than numpy
    does)."""
    kind = layout if isinstance(layout, str) else layout[0]
    if kind == "conv":
        return t.permute(2, 1, 0)
    if kind == "conv2d":
        return t.permute(2, 3, 1, 0)
    if kind == "dense":
        return t.t()
    if kind == "heads_in":
        return t.t().reshape(t.shape[1], layout[1], -1)
    if kind == "heads_out":
        return t.t().reshape(layout[1], -1, t.shape[0])
    if kind == "heads_bias":
        return t.reshape(layout[1], -1)
    return t


def _leaf(tree, path: tuple):
    """``tree[path[0]][path[1]]...``; a plain dict without the key raises a
    KeyError naming the path (a tree read from a file names its file too)."""
    node = tree
    for i, key in enumerate(path):
        if not isinstance(node, Mapping) or (isinstance(node, dict) and key not in node):
            raise KeyError(f"{'/'.join(path[: i + 1])} is missing")
        node = node[key]
    return node


def _leaf_paths(tree, prefix=()) -> list:
    out = []
    for k, v in tree.items():
        out += _leaf_paths(v, prefix + (k,)) if isinstance(v, Mapping) else [prefix + (k,)]
    return out


def load_image_conditioner(model: nn.Module, variables) -> nn.Module:
    """Copy flax ``{"params", "batch_stats"}`` into an image conditioner. A
    leaf the model has and the tree lacks raises a KeyError naming its path,
    a leaf the tree has and the model lacks a ValueError naming it."""
    paths = image_conditioner_paths(model)
    state = {name: _from_flax(layout, _leaf(variables, path))
             for name, (layout, path) in paths.items()}
    extra = set(_leaf_paths(variables)) - {p for _, p in paths.values()}
    if extra:
        raise ValueError("leaves the conditioner does not have: "
                         + ", ".join("/".join(p) for p in sorted(extra)[:8]))
    return load_state(model, state)


def image_conditioner_variables(model: nn.Module) -> dict:
    """An image conditioner -> its flax ``{"params", "batch_stats"}`` (f32
    numpy leaves, ``batch_stats`` empty for the ViT)."""
    tensors = model.state_dict()
    out: dict = {"params": {}, "batch_stats": {}}
    for name, (layout, path) in image_conditioner_paths(model).items():
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = _to_flax(layout, tensors[name].detach().float()).contiguous().cpu().numpy()
    return out


def image_conditioner(lc_cfg: LCConfig, cfg: VAEConfig, device,
                      variables: Optional[dict] = None, image_side: int = 256) -> nn.Module:
    """The port module of ``lc_cfg.input_type`` (``image``: the CNN,
    ``image_vit``: the ViT for ``image_side``-pixel squares, or for the side
    its ``variables``' ``pos_embed`` gives), as ``generate.load_pipeline``
    builds it in JAX."""
    if lc_cfg.input_type == "image":
        return LatentConditionerImg(lc_cfg.filters, cfg.latent_dim_end, cfg.latent_dim,
                                    cfg.num_hier, lc_cfg.dropout_rate,
                                    lc_cfg.use_spatial_attention, device)
    if lc_cfg.input_type == "image_vit":
        side = image_side
        if variables is not None:
            tokens = np.shape(_leaf(variables, ("params", "pos_embed")))[1]
            side = int(round(np.sqrt(tokens))) * 16
        return LatentConditionerViT(cfg.latent_dim_end, cfg.latent_dim, cfg.num_hier,
                                    dropout_rate=lc_cfg.dropout_rate, image_side=side,
                                    device=device)
    raise ValueError(f"not an image input type: {lc_cfg.input_type!r}")
