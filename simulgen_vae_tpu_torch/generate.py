"""Serving: design parameters -> simulation fields (``simulgen_vae_tpu/generate.py``).

The pipeline runs the MLP conditioner, inverse-scales its latents, decodes
deterministically (``mode='fix'``) and, optionally, inverse-scales the field
to physical units, all on one device. :func:`make_pipeline` builds it in
memory from JAX parameter trees (numpy arrays) and scalers; loading trained
artifacts from ``model_save/`` comes with the CLI slice.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
asking for CUDA where there is none raises.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from simulgen_vae_tpu_torch.config import LCConfig, VAEConfig
from simulgen_vae_tpu_torch.convert import conditioner_from_jax, vae_from_jax
from simulgen_vae_tpu_torch.data.scaler import MinMaxScaler


def resolve_device(device=None) -> torch.device:
    """``cuda`` by default; raises when CUDA was asked for and is absent."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    return device


def make_pipeline(cfg: VAEConfig, lc_cfg: LCConfig, vae_params: dict,
                  lc_params: dict, lv_scaler: MinMaxScaler,
                  xs_scaler: MinMaxScaler, data_scaler: MinMaxScaler,
                  device=None, dtype: torch.dtype = torch.bfloat16) -> dict:
    """The in-memory counterpart of the JAX ``load_pipeline``.

    ``vae_params`` is the JAX VAE ``params`` tree (only ``['decoder']`` is
    read) and ``lc_params`` the conditioner's. The decoder computes in
    ``dtype``; the conditioner and the scalers stay in f32.
    """
    device = resolve_device(device)
    return dict(
        cfg=cfg, lc_cfg=lc_cfg, device=device, dtype=dtype,
        vae=vae_from_jax(vae_params["decoder"], cfg, device, dtype),
        lc=conditioner_from_jax(lc_params, lc_cfg, cfg, device),
        lv_scaler=lv_scaler.to(device), xs_scaler=xs_scaler.to(device),
        data_scaler=data_scaler.to(device),
    )


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


def make_generate_fn(pipeline: dict, descale_output: bool = True,
                     max_batch: Optional[int] = None):
    """One serving function: preprocessed inputs ``[N, features]`` -> fields
    ``[N, time, nodes]`` on the pipeline's device.

    Batches above ``max_batch`` (None or <= 0: :func:`auto_max_batch`) run in
    chunks of exactly ``max_batch`` rows: the tail chunk is padded by
    repeating its last row and the padding is sliced off, so every call has
    one shape.
    """
    cfg, device, dtype = pipeline["cfg"], pipeline["device"], pipeline["dtype"]
    vae, lc = pipeline["vae"], pipeline["lc"]
    lv, xsc, ds = pipeline["lv_scaler"], pipeline["xs_scaler"], pipeline["data_scaler"]
    if not max_batch or max_batch <= 0:
        max_batch = auto_max_batch(cfg.num_time, cfg.num_node, device)

    def run(inputs: torch.Tensor) -> torch.Tensor:
        y1, y2 = lc(inputs)
        z = lv.inverse_transform(y1)
        b, nh, hd = y2.shape
        xs_flat = xsc.inverse_transform(y2.reshape(b, nh * hd))
        xs = [xs_flat.reshape(b, nh, hd)[:, i].to(dtype) for i in range(nh)]
        # mode='fix' draws noise of std 1e-8; a fixed seed keeps it repeatable.
        gen = torch.Generator(device).manual_seed(0)
        field = vae.generate(z.to(dtype), xs, generator=gen)
        if descale_output:
            field = ds.inverse_transform(field.float())
        return field

    @torch.inference_mode()
    def generate_fn(inputs) -> torch.Tensor:
        x = torch.as_tensor(inputs, dtype=torch.float32, device=device)
        n = x.shape[0]
        if n <= max_batch:
            return run(x)
        chunks = []
        for start in range(0, n, max_batch):
            chunk = x[start: start + max_batch]
            got = chunk.shape[0]
            if got < max_batch:  # pad to the one call shape, slice after
                chunk = torch.cat([chunk, chunk[-1:].expand(max_batch - got, -1)])
            chunks.append(run(chunk)[:got])
        return torch.cat(chunks)

    return generate_fn


def generate(pipeline: dict, inputs, descale_output: bool = True,
             max_batch: int = 0) -> torch.Tensor:
    """Design inputs -> fields ``[N, time, nodes]`` (a tensor on the
    pipeline's device). ``max_batch`` 0 sizes chunks from free memory."""
    return make_generate_fn(pipeline, descale_output, max_batch)(inputs)
