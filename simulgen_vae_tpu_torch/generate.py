"""Serving: design parameters -> simulation fields (``simulgen_vae_tpu/generate.py``).

The pipeline runs the latent conditioner of the condition file's
``input_type`` (the MLP on CSV rows or, for ``image_pca``, on scaled PCA
coefficients; the CNN on ``image``, the ViT on ``image_vit``),
inverse-scales its latents, decodes
deterministically (``mode='fix'``) and, optionally, inverse-scales the field
to physical units, all on one device. :func:`load_pipeline` builds it from a
trained ``model_save/`` directory as the JAX package writes it (flax msgpack
models and sklearn scaler pickles, read without flax or sklearn);
:func:`make_pipeline` builds it from JAX parameter trees in memory.
``quantize="int8"`` serves the decoder's products in int8 (``ops/quant.py``);
the conditioner stays float.

An image conditioner is served from its ``{"params", "batch_stats"}`` with
the raw kernels, as the JAX package serves it: the files hold the weights
before spectral norm, and nothing divides them by sigma here (ROADMAP Queue
3 records what that does to a CNN trained with spectral norm).

CLI:  python -m simulgen_vae_tpu_torch.generate --inputs params.csv --out gen.npy
      python -m simulgen_vae_tpu_torch.generate --inputs new_images --out gen.npy

The CLI serves ``image_pca`` only from a CSV of PCA coefficients
(``--input_type csv``), as JAX's does: JAX's CLI reads an ``image_pca``
image directory as thresholded pixels, which the MLP cannot take, and the
port refuses it before reading any model or input file (ROADMAP Queue 3
item 6).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(``--device cpu``); asking for CUDA where there is none raises.

``make_generate_fn(..., mesh=...)`` serves on a ``('data', 'model')`` mesh
of ranks (``parallel.make_mesh``; every rank calls it and the function it
returns, with the same requests): the decoder's node-sized leaves are split
over ``model`` by the training rule (the readout's int8 scales with its
kernel), requests over ``data`` where their count divides by it, and every
rank returns the whole field, gathered over both axes.

With ``descale_output`` the decoder's readout writes the field descaled to
f32 physical units: after the readout's product and its GroupNorm
statistics, one pass normalises, applies tanh, rounds to the decoder's
dtype and descales (``ops.field_epilogue.gn_apply_field_epilogue``: on the
card one hand-written kernel; on the CPU the plain versions), the same bits
as the tanh'd field descaled after it. Without a mesh a request larger than
one chunk is allocated once, and each chunk's readout writes its rows
straight into it (a copy of the decoder's field where ``descale_output`` is
off); a mesh gathers each rank's descaled block first and concatenates the
chunks.

A call of the serving function and its phases are spans of
``utils.profiling`` (``serve.request``, ``serve.chunk``,
``serve.conditioner``, ``serve.decode`` with ``decoder.readout`` in it and
``serve.descale`` in that, around the readout's fused pass; ``serve.concat``
around the tail chunk's padding and the mesh path's concatenation), recorded only inside
``profiling.recording()``; ``serve.requests`` counts the calls recorded.
"""

from __future__ import annotations

import argparse
import logging
import os
from collections.abc import Mapping
from typing import Optional

import numpy as np
import torch

from simulgen_vae_tpu_torch.config import (
    LCConfig,
    VAEConfig,
    parse_condition_file,
    parse_training_parameters,
    read_preset,
)
from simulgen_vae_tpu_torch.convert import (
    IMAGE_INPUT_TYPES,
    conditioner_from_jax,
    decoder_state,
    vae_from_jax,
)
from simulgen_vae_tpu_torch.data.scaler import MinMaxScaler
from simulgen_vae_tpu_torch.models.blocks import hold_conv_weights
from simulgen_vae_tpu_torch.models.vae import VAE
from simulgen_vae_tpu_torch.ops.quant import build_quant_collection
from simulgen_vae_tpu_torch.parallel import collectives, sharding
from simulgen_vae_tpu_torch.utils import resolve_device
from simulgen_vae_tpu_torch.utils.checkpoint import load_flax_model
from simulgen_vae_tpu_torch.utils.profiling import span, tick


def make_pipeline(cfg: VAEConfig, lc_cfg: LCConfig, vae_params: dict,
                  lc_params: dict, lv_scaler: MinMaxScaler,
                  xs_scaler: MinMaxScaler, data_scaler: MinMaxScaler,
                  device=None, dtype: torch.dtype = torch.bfloat16,
                  lc_batch_stats: Optional[dict] = None) -> dict:
    """The in-memory counterpart of :func:`load_pipeline`.

    ``vae_params`` is the JAX VAE ``params`` tree (only ``['decoder']`` is
    read, and kept for the int8 mirror, which quantizes its f32 weights),
    ``lc_params`` the conditioner's of ``lc_cfg.input_type`` and
    ``lc_batch_stats`` the CNN's BatchNorm statistics. The decoder computes
    in ``dtype``; the conditioner and the scalers stay in f32.
    """
    device = resolve_device(device)
    return dict(
        cfg=cfg, lc_cfg=lc_cfg, device=device, dtype=dtype,
        vae=vae_from_jax(vae_params["decoder"], cfg, device, dtype),
        decoder_tree=vae_params["decoder"],
        lc=conditioner_from_jax(lc_params, lc_cfg, cfg, device, batch_stats=lc_batch_stats),
        lv_scaler=lv_scaler.to(device), xs_scaler=xs_scaler.to(device),
        data_scaler=data_scaler.to(device),
    )


class _Loaded(Mapping):
    """A tree read from a file: a missing entry raises a KeyError that names
    the file and the entry's path."""

    def __init__(self, tree: dict, where: str):
        self._tree, self._where = tree, where

    def __getitem__(self, key):
        try:
            value = self._tree[key]
        except KeyError:
            raise KeyError(f"{self._where}/{key} is missing") from None
        return _Loaded(value, f"{self._where}/{key}") if isinstance(value, dict) else value

    def __iter__(self):
        return iter(self._tree)

    def __len__(self) -> int:
        return len(self._tree)


def load_pipeline(condition: str = "input_data/condition.txt",
                  preset_file: str = "preset.txt", size: str = "small",
                  model_dir: str = "model_save", device=None,
                  dtype: torch.dtype = torch.float32) -> dict:
    """The serving pipeline from the artifact directory the full-pipeline CLI
    writes: ``SimulGen-VAE`` (``{"params"}``), ``LatentConditioner``
    (``{"params", "batch_stats"}``) and the four scaler pickles, with the
    geometry from ``condition`` and ``preset_file``. The decoder computes in
    ``dtype``, f32 by default as in the JAX package. The CSV conditioner
    also reads ``latent_conditioner_input_scaler.pkl`` (kept as
    ``input_scaler``); the image conditioners take pixels / 255. A missing
    weight raises a KeyError naming it."""
    device = resolve_device(device)
    raw = parse_training_parameters(parse_condition_file(condition))
    _, _, num_filter_enc, lc_filter = read_preset(preset_file)
    cfg = VAEConfig.from_condition(raw, num_filter_enc, small=(size == "small"))
    lc_cfg = LCConfig.from_condition(raw, lc_filter)

    def path(name):
        return os.path.join(model_dir, name)

    vae_vars = _Loaded(load_flax_model(path("SimulGen-VAE")), path("SimulGen-VAE"))
    lc_vars = _Loaded(load_flax_model(path("LatentConditioner")), path("LatentConditioner"))
    scalers = [MinMaxScaler.load(path(name)) for name in
               ("latent_vectors_scaler.pkl", "xs_scaler.pkl", "scaler.pkl")]
    if lc_cfg.input_type in IMAGE_INPUT_TYPES:
        return make_pipeline(cfg, lc_cfg, vae_vars["params"], lc_vars["params"], *scalers,
                             device=device, dtype=dtype,
                             lc_batch_stats=lc_vars.get("batch_stats", {}))
    input_scaler = MinMaxScaler.load(path("latent_conditioner_input_scaler.pkl"))
    width = np.shape(lc_vars["params"]["input_norm"]["scale"])[0]
    if input_scaler.scale_.shape[-1] != width:
        raise ValueError(f"the input scaler has {input_scaler.scale_.shape[-1]} features, "
                         f"the conditioner {width} inputs")
    pipe = make_pipeline(cfg, lc_cfg, vae_vars["params"], lc_vars["params"], *scalers,
                         device=device, dtype=dtype)
    pipe["input_scaler"] = input_scaler
    return pipe


def auto_max_batch(num_time: int, num_node: int, device=None) -> int:
    """Largest per-call batch whose activations fit half the free memory.

    A decode holds the ``[B, time, nodes]`` readout map several times over
    (the map, its normalised copy, the f32 descale and the plain GroupNorm's
    f32 temporaries); budget 8 f32 copies of it per sample. On a card the
    free memory comes from ``torch.cuda.mem_get_info``, on the CPU from the
    available physical pages.
    """
    device = resolve_device(device)
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
    else:
        free = os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    per_sample = num_time * num_node * 4 * 8
    return max(1, int(free // 2 // per_sample))


def _int8_vae(pipeline: dict):
    """The pipeline's VAE with the int8 mirror of its decoder, built once."""
    vae = pipeline.get("_int8_vae")
    if vae is None:
        state = {f"decoder.{k}": v for k, v in decoder_state(pipeline["decoder_tree"]).items()}
        vae = pipeline["_int8_vae"] = build_quant_collection(
            pipeline["vae"], state, pipeline["device"])
    return vae


def _sharded_vae(pipeline: dict, mesh, parts: int, quantize: Optional[str]) -> VAE:
    """This rank's block of the pipeline's decoder (its int8 mirror with
    ``quantize``): the node-sized leaves split over the model axis."""
    cfg, device, dtype = pipeline["cfg"], pipeline["device"], pipeline["dtype"]
    full = pipeline["vae"]
    vae = VAE(cfg.latent_dim_end, cfg.latent_dim, cfg.num_filter_dec, cfg.num_node // parts,
              cfg.num_time, cfg.small, device, dtype, node_parts=parts,
              node_group=mesh.group("model") if parts > 1 else None)
    layout = sharding.Layout(mesh, parts, sharding.node_leaves(vae), {})
    state = sharding.shard_tree(full.state_dict(), layout.params, layout, device)
    vae.load_state_dict(state)
    vae.eval()
    if quantize != "int8":
        return vae
    f32 = {f"decoder.{k}": v for k, v in decoder_state(pipeline["decoder_tree"]).items()}
    f32 = {k: sharding.block(torch.as_tensor(np.asarray(v)), layout.params.get(k),
                             layout.index, parts) for k, v in f32.items()}
    return build_quant_collection(vae, f32, device)


def make_generate_fn(pipeline: dict, descale_output: bool = True,
                     max_batch: Optional[int] = None, quantize: Optional[str] = None,
                     mesh=None):
    """One serving function: preprocessed inputs ``[N, features]`` -> fields
    ``[N, time, nodes]`` on the pipeline's device.

    Batches above ``max_batch`` (None or <= 0: :func:`auto_max_batch`) run in
    chunks of exactly ``max_batch`` rows: the tail chunk is padded by
    repeating its last row and the padding is sliced off, so every call has
    one shape. ``quantize="int8"`` decodes with the int8 mirror of the
    decoder (per-output-channel weights, per-row activations); the
    conditioner, norms and biases stay float.

    ``mesh``: serve on a mesh of ranks (JAX's ``make_generate_fn(mesh=)``).
    The chunk cap is ``auto_max_batch * model``, rounded down to a multiple
    of ``data`` (``max_batch`` takes its place, rounded the same way); a
    chunk splits over ``data`` when its rows divide by it and is replicated
    otherwise; each rank decodes its rows at its nodes and the field is
    gathered over both axes, so every rank returns all of it.

    The served decoder's k > 1 conv weights are held in cuDNN's order once,
    here (``models.blocks.hold_conv_weights``): every pipeline is served
    through this function, and its weights no longer change.
    """
    cfg, device, dtype = pipeline["cfg"], pipeline["device"], pipeline["dtype"]
    if quantize not in (None, "int8"):
        raise ValueError(f"unknown quantize mode {quantize!r} (supported: 'int8')")
    if mesh is not None and mesh.size == 1:
        mesh = None
    parts = sharding.node_parts(mesh, cfg.num_node)
    if mesh is not None:
        vae = _sharded_vae(pipeline, mesh, parts, quantize)
        data_ax = mesh.shape["data"]
        cap = (max_batch if max_batch and max_batch > 0
               else auto_max_batch(cfg.num_time, cfg.num_node, device) * mesh.shape["model"])
        max_batch = max(data_ax, cap - cap % data_ax)
    else:
        vae = _int8_vae(pipeline) if quantize == "int8" else pipeline["vae"]
    hold_conv_weights(vae)
    lc = pipeline["lc"]
    lv, xsc, ds = pipeline["lv_scaler"], pipeline["xs_scaler"], pipeline["data_scaler"]
    if not max_batch or max_batch <= 0:
        max_batch = auto_max_batch(cfg.num_time, cfg.num_node, device)
    if parts > 1:  # the descale of this rank's nodes
        ds = MinMaxScaler(*(sharding.block(t, 0, mesh.coords["model"], parts)
                            if t.dim() == 1 and t.shape[0] == cfg.num_node else t
                            for t in (ds.scale_, ds.min_)))

    def decode(inputs: torch.Tensor, out: Optional[torch.Tensor] = None) -> tuple:
        """A chunk's field, this rank's rows and nodes, and the rows it holds
        on a mesh that splits them (None: all). With ``descale_output`` the
        readout writes it descaled into ``out`` (its first rows are the
        chunk's; a fresh f32 tensor where None), else it is the decoder's
        dtype."""
        rows = None
        if mesh is not None:
            d = sharding.batch_parts(mesh, inputs.shape[0])
            if d > 1:
                n = inputs.shape[0] // d
                rows = (mesh.coords["data"] * n, inputs.shape[0])
                inputs = inputs[rows[0]: rows[0] + n]
        with span("serve.conditioner"):
            y1, y2 = lc(inputs)
            z = lv.inverse_transform(y1)
            b, nh, hd = y2.shape
            xs_flat = xsc.inverse_transform(y2.reshape(b, nh * hd))
            xs = [xs_flat.reshape(b, nh, hd)[:, i].to(dtype) for i in range(nh)]
        field_out = None
        if descale_output:
            if out is None:
                out = torch.empty((b, cfg.num_time, cfg.num_node // parts),
                                  dtype=torch.float32, device=device)
            field_out = (ds.min_, ds.scale_, out)
        with span("serve.decode"):
            # mode='fix' draws noise of std 1e-8; a fixed seed keeps it repeatable.
            gen = torch.Generator(device).manual_seed(0)
            field = vae.generate(z.to(dtype), xs, generator=gen, noise_rows=rows,
                                 field_out=field_out)
        return field, rows

    def place(chunk: torch.Tensor, out: Optional[torch.Tensor], start: int, got: int,
              n: int) -> torch.Tensor:
        """The first ``got`` rows of ``chunk``'s field as rows ``start:`` of
        the request's ``[n, ...]`` output, which the first chunk allocates:
        descaled by the readout, or copied."""
        if out is None:
            out = torch.empty((n, cfg.num_time, cfg.num_node), device=device,
                              dtype=torch.float32 if descale_output else dtype)
        rows = out[start: start + got]
        if descale_output:
            decode(chunk, rows)
        else:
            rows.copy_(decode(chunk)[0][:got])
        return out

    def run(inputs: torch.Tensor) -> torch.Tensor:
        """One chunk's whole field (descaled into a fresh tensor) and, on a
        mesh, gathered."""
        field, rows = decode(inputs)
        if mesh is not None:
            if parts > 1:
                field = collectives.all_gather_cat(field, mesh.group("model"), 2)
            if rows is not None:
                field = collectives.all_gather_cat(field, mesh.group("data"), 0)
        return field

    @torch.inference_mode()
    def generate_fn(inputs) -> torch.Tensor:
        with span("serve.request", tick("serve.requests")):
            x = torch.as_tensor(inputs, dtype=torch.float32, device=device)
            n = x.shape[0]
            if n <= max_batch:
                with span("serve.chunk"):
                    return run(x)
            out, chunks = None, []
            for start in range(0, n, max_batch):
                chunk = x[start: start + max_batch]
                got = chunk.shape[0]
                if got < max_batch:  # pad to the one call shape; the padding is never placed
                    with span("serve.concat"):
                        chunk = torch.cat([chunk, chunk[-1:].expand(max_batch - got, -1)])
                with span("serve.chunk"):
                    if mesh is None:
                        out = place(chunk, out, start, got, n)
                    else:  # the gathered field has to exist before its rows can be placed
                        chunks.append(run(chunk)[:got])
            if out is not None:
                return out
            with span("serve.concat"):
                return torch.cat(chunks)

    return generate_fn


def _cached_fn(pipeline: dict, descale_output: bool, quantize: Optional[str],
               max_batch: int = 0):
    """Pipeline-level cache of serving functions, one per configuration."""
    key = ("_gen_fn", bool(descale_output), quantize, max_batch or 0)
    fn = pipeline.get(key)
    if fn is None:
        fn = pipeline[key] = make_generate_fn(pipeline, descale_output, max_batch,
                                              quantize=quantize)
    return fn


def int8_self_check(pipeline: dict, inputs, descale_output: bool = True,
                    threshold: float = 0.05, probe_n: int = 4):
    """The per-model int8 gate of ``quantize="auto"``: the first ``probe_n``
    requests decoded in int8 and in float, ``(rel-L2 <= threshold, rel-L2)``.
    The verdict is cached on the pipeline; both serving functions are the
    cached ones the decode then reuses."""
    cached = pipeline.get("_int8_check")
    if cached is not None:
        return cached
    probe = inputs[:probe_n]
    f_ref = _cached_fn(pipeline, descale_output, None)(probe).float()
    f_q = _cached_fn(pipeline, descale_output, "int8")(probe).float()
    rel = float(torch.linalg.vector_norm(f_q - f_ref)
                / torch.linalg.vector_norm(f_ref).clamp_min(1e-12))
    verdict = pipeline["_int8_check"] = (rel <= threshold, rel)
    return verdict


def resolve_quantize(mode: Optional[str], device="cuda",
                     dtype: torch.dtype = torch.float32) -> Optional[str]:
    """The CLI's quantize mode -> :func:`make_generate_fn`'s (None | 'int8').

    'auto' answers int8 where the card decodes faster in int8 than in the
    float of the pipeline's dtype: an f32 pipeline on CUDA (batch-16 flagship
    decode on an NVIDIA H100 80GB HBM3 at 700 W, PERF.md: 15.3-15.7 ms of
    device time in int8 against 24.9 in f32, best p50 23.0-24.7 against
    27.7-27.9 ms). A bf16 pipeline serves float there (int8 16.9-17.0 ms of
    device time against 11.1, best p50 25.7-28.2 against 14.8-15.8 ms: the
    f32 rescale of the int32 products outweighs them), and so does the CPU,
    as the JAX package does off a TPU.
    """
    if mode == "auto":
        cuda = torch.device(device).type == "cuda"
        return "int8" if cuda and dtype == torch.float32 else None
    if mode in (None, "none"):
        return None
    return mode


def generate(pipeline: dict, inputs, descale_output: bool = True,
             quantize: Optional[str] = None, max_batch: int = 0) -> torch.Tensor:
    """Design inputs -> fields ``[N, time, nodes]`` (a tensor on the
    pipeline's device). ``max_batch`` 0 sizes chunks from free memory.

    ``quantize="auto"`` resolves through :func:`resolve_quantize` for the
    pipeline's device and dtype; where that answers int8,
    :func:`int8_self_check` must pass first, or the decode falls back to
    float with a warning. ``"int8"`` skips the gate.
    """
    if quantize == "auto":
        quantize = resolve_quantize("auto", pipeline["device"], pipeline["dtype"])
        if quantize == "int8":
            ok, rel = int8_self_check(pipeline, inputs, descale_output)
            if not ok:
                logging.getLogger("simulgen_vae_tpu_torch.generate").warning(
                    "int8 self-check FAILED for this model (rel-L2 %.3f > 0.05): serving "
                    "in float instead. Pass --quantize int8 to force, --quantize none to "
                    "silence.", rel)
                quantize = None
    return _cached_fn(pipeline, descale_output, quantize, max_batch)(inputs)


def main(argv=None) -> int:
    from simulgen_vae_tpu_torch.data import images

    ap = argparse.ArgumentParser(
        description="Generate simulation fields from design parameters "
                    "(conditioner -> decoder, no solver)")
    ap.add_argument("--inputs", required=True,
                    help="CSV of parameters, or a directory of images under the working "
                         "directory (read with OpenCV)")
    ap.add_argument("--input_type", default=None, choices=[None, "csv", "image"],
                    help="default: from condition.txt input_type")
    ap.add_argument("--out", default="output/generated.npy")
    ap.add_argument("--condition", default="input_data/condition.txt")
    ap.add_argument("--preset_file", default="preset.txt")
    ap.add_argument("--size", default="small", choices=["small", "large"])
    ap.add_argument("--model_dir", default="model_save")
    ap.add_argument("--raw_scale", action="store_true",
                    help="skip inverse data scaling (keep model units)")
    ap.add_argument("--max_batch", type=int, default=0,
                    help="decode at most this many fields per call (0 = from the "
                         "device's free memory; chunked transparently)")
    ap.add_argument("--quantize", default="auto", choices=["auto", "none", "int8"],
                    help="int8 decoder products; 'auto' (default) = int8 for the f32 "
                         "pipeline on a card, where it decodes faster, float elsewhere, "
                         "AND self-checked per model at first use (int8-vs-float rel-L2 "
                         "on the first requests; falls back to float above 5%%); 'int8' "
                         "forces it without the gate")
    ap.add_argument("--device", default="cuda",
                    help="device to serve on (default cuda; 'cpu' for the plain versions)")
    args = ap.parse_args(argv)
    quantize = None if args.quantize == "none" else args.quantize
    kind = parse_training_parameters(
        parse_condition_file(args.condition))["latent_conditioner_data_type"]
    if kind == "image_pca" and args.input_type != "csv":
        raise NotImplementedError(
            "serving input_type image_pca from images is not supported: the PCA is "
            "fitted at training time and JAX's generate CLI feeds thresholded pixels to "
            "an MLP that takes PCA coefficients (ROADMAP Queue 3 item 6); pass "
            "--input_type csv with a CSV of the PCA coefficients")

    pipe = load_pipeline(args.condition, args.preset_file, args.size, args.model_dir,
                         device=args.device)
    input_type = args.input_type or (
        "image" if pipe["lc_cfg"].input_type.startswith("image") else "csv")
    if input_type == "image":
        param_dir = args.inputs if args.inputs.startswith("/") else "/" + args.inputs
        raw, _ = images.read_latent_conditioner_dataset_img(
            param_dir, pipe["lc_cfg"].param_data_type)
        inputs = raw / 255.0
    else:
        inputs = np.asarray(pipe["input_scaler"].transform(
            images.read_latent_conditioner_dataset(args.inputs)))
    fields = generate(pipe, np.float32(inputs), descale_output=not args.raw_scale,
                      quantize=quantize, max_batch=args.max_batch).cpu().numpy()
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    np.save(args.out, fields)
    print(f"Generated {fields.shape[0]} fields "
          f"[{fields.shape[1]} timesteps x {fields.shape[2]} nodes] -> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
