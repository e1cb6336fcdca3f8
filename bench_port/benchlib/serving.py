"""The serving pipeline a cell times, built from the seed's weights through
the program's own modules, and the same inputs for the reference.

The decoder is served as a trained model is: its weights are the ones that
generate (spectral norm already divided in), in the served dtype; the
conditioner and the scalers stay f32. Requests come from a pool of seeded
design rows or seeded outline images made on the card.
"""

from __future__ import annotations

import torch

from benchlib import inputs, program
from reference import conditioner as ref_cond
from reference import vae as ref_vae

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def scalers(cfg: dict, seed: int, device) -> dict:
    """The three min-max scalers as ``{lv, xs, data}_{scale, min}``."""
    levels = len(cfg["num_filter_enc"]) - 1
    out = {}
    for name, width, low, high in (
            ("lv", cfg["latent_dim_end"], (-3.0, -1.0), (1.0, 3.0)),
            ("xs", cfg["latent_dim"] * levels, (-3.0, -1.0), (1.0, 3.0)),
            ("data", cfg["num_node"], (-2.0, -0.5), (0.5, 2.0))):
        out[f"{name}_scale"], out[f"{name}_min"] = inputs.scaler(width, seed, name, device,
                                                                 low, high)
    return out


def weights(cfg: dict, seed: int, device) -> tuple:
    """``(decoder, conditioner)`` f32 weights of the seed."""
    return (inputs.weights(ref_vae.decoder_shapes(cfg), seed, "decoder", device),
            inputs.weights(ref_cond.conditioner_shapes(cfg), seed, "conditioner", device))


def pipeline(cfg: dict, seed: int, device) -> dict:
    """The program's serving pipeline with the seed's weights and scalers."""
    from simulgen_vae_tpu_torch.data.scaler import MinMaxScaler
    from simulgen_vae_tpu_torch.models.vae import VAE

    vcfg = program.vae_config(cfg)
    dtype = DTYPES[cfg["dtype"]]
    dec_w, cond_w = weights(cfg, seed, device)
    vae = VAE(vcfg.latent_dim_end, vcfg.latent_dim, vcfg.num_filter_dec, vcfg.num_node,
              vcfg.num_time, vcfg.small, device, dtype)
    program.load_state(vae, dec_w)
    c = cfg["conditioner"]
    if c["type"] == "mlp":
        from simulgen_vae_tpu_torch.models.conditioner_mlp import LatentConditioner

        lc = LatentConditioner(c["filters"], vcfg.latent_dim_end, c["inputs"], vcfg.latent_dim,
                               vcfg.num_hier, device, c["dropout_rate"])
    else:
        from simulgen_vae_tpu_torch.models.conditioner_cnn import LatentConditionerImg

        lc = LatentConditionerImg(c["filters"], vcfg.latent_dim_end, vcfg.latent_dim,
                                  vcfg.num_hier, c["dropout_rate"], c["spatial_attention"],
                                  device)
    program.load_state(lc, cond_w)
    del dec_w, cond_w
    s = scalers(cfg, seed, device)
    return dict(cfg=vcfg, lc_cfg=None, device=device, dtype=dtype, vae=vae.eval(),
                decoder_tree=None, lc=lc.eval(),
                lv_scaler=MinMaxScaler(s["lv_scale"], s["lv_min"]),
                xs_scaler=MinMaxScaler(s["xs_scale"], s["xs_min"]),
                data_scaler=MinMaxScaler(s["data_scale"], s["data_min"]))


@torch.no_grad()
def outlines(count: int, side: int, seed: int, device) -> torch.Tensor:
    """``count`` binary outline images ``[count, side^2]`` in {0, 1}: one to
    three filled ellipses each, as pixels / 255 of the image reader."""
    g = inputs.generator(seed, "images", device)
    centre = 0.2 + 0.6 * torch.rand((count, 3, 2), generator=g, device=device)
    radius = 0.08 + 0.22 * torch.rand((count, 3, 2), generator=g, device=device)
    shapes = 1 + torch.randint(0, 3, (count, 1), generator=g, device=device)
    grid = (torch.arange(side, device=device, dtype=torch.float32) + 0.5) / side
    yy, xx = grid[:, None], grid[None, :]
    dy = (yy - centre[..., 0, None, None]) / radius[..., 0, None, None]
    dx = (xx - centre[..., 1, None, None]) / radius[..., 1, None, None]
    inside = (dy * dy + dx * dx) < 1.0                       # [count, 3, side, side]
    used = torch.arange(3, device=device)[None, :] < shapes  # [count, 3]
    img = (inside & used[..., None, None]).any(dim=1)
    return img.reshape(count, side * side).float()


def request_pool(cfg: dict, wl: dict, seed: int, device) -> torch.Tensor:
    """``[pool, rows, width]`` request inputs."""
    c = cfg["conditioner"]
    pool, rows = int(wl["pool"]), int(wl["rows_per_request"])
    if c["type"] == "mlp":
        return inputs.designs(pool, rows, c["inputs"], seed, device)
    side = int(c["image_side"])
    return outlines(pool * rows, side, seed, device).reshape(pool, rows, side * side)


class Cell:
    """A serving cell's set-up, sampled answers and check: the pipeline and
    its generate function, the request pool, and the fields kept for the
    reference (one row of each ``check_every``-th request from an offset
    drawn from the seed, at most ``max_checks``)."""

    def __init__(self, ctx):
        from simulgen_vae_tpu_torch.generate import make_generate_fn

        self.ctx, self.cfg, self.wl, dev = ctx, ctx.config, ctx.workload, ctx.device
        program.build_kernels(dev)
        self.pipe = pipeline(self.cfg, ctx.seed, dev)
        self.fn = make_generate_fn(self.pipe, descale_output=True,
                                   max_batch=int(self.wl["max_batch"]))
        self.pool = request_pool(self.cfg, self.wl, ctx.seed, dev)
        self.rows = int(self.wl["rows_per_request"])
        self.shape = (self.rows, self.cfg["num_time"], self.cfg["num_node"])
        g = torch.Generator().manual_seed(inputs.subseed(ctx.seed, "checks"))
        self.every = int(self.wl["check_every"])
        self.offset = int(torch.randint(0, self.every, (1,), generator=g))
        self.row_gen = g
        self.kept, self.failed = [], 0
        for _ in range(2):  # the one request shape, twice: every kernel built and chosen
            self.fn(self.pool[0])
        program.sync(dev)

    def request(self, i: int):
        """Serve request ``i`` and keep its sampled row; returns the field."""
        out = self.fn(self.pool[i % self.pool.shape[0]])
        if tuple(out.shape) != self.shape:
            self.failed += 1
        elif (i + self.offset) % self.every == 0 and len(self.kept) < int(self.wl["max_checks"]):
            r = int(torch.randint(0, self.rows, (1,), generator=self.row_gen))
            self.kept.append((i, r, out[r].clone()))
        return out

    def checks(self) -> dict:
        """``{"field_gap": (worst sampled row's rel-L2, limit)}``, the
        program's state freed first and the reference run in blocks."""
        import gc

        from benchlib import compare

        dev, cfg = self.ctx.device, self.cfg
        del self.pipe, self.fn
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        if not self.kept:
            return {"field_gap": (float("inf"), float(self.wl["limits"]["field_gap"]))}
        dec, cond = weights(cfg, self.ctx.seed, dev)
        s = scalers(cfg, self.ctx.seed, dev)
        worst = 0.0
        with compare.exact_f32(), torch.no_grad():
            for at in range(0, len(self.kept), 8):
                block = self.kept[at: at + 8]
                x = torch.stack([self.pool[i % self.pool.shape[0], r] for i, r, _ in block])
                want = ref_cond.serve(cfg, dec, cond, s, x)
                have = torch.stack([f for _, _, f in block])
                worst = max(worst, compare.field_gap(have, want))
        return {"field_gap": (worst, float(self.wl["limits"]["field_gap"]))}
