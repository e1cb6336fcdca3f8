"""The port's ``E2ETrainer`` with its ViT conditioner against the benchmark's
plain reference of the ViT E2E step (``bench_port/reference/vit.py``), f32
on the CPU, at a tiny size: a ViT of embedding 64, depth 2 and 4 heads on
32 x 32 images (4 tokens of 16 x 16 patches), a three-level decoder, batch
8, seeded weights, three steps of one epoch.

The program's draws (each noisy batch, the token, attention and MLP dropout
masks, the decoder's noise) are recorded by the benchmark's recorder
(``drivers/e2e_vit_loop.py``'s ``FirstSteps``) and handed to the reference,
which draws nothing. Checked:

* the three consecutive steps' losses, within 1e-5 relative: both sides are
  f32 and the ViT is smooth (no max or pooling winner to flip), so they
  agree to round-off (read 7e-8-1.4e-7 over six seeds);
* step 1's main and hierarchical latents, within rel-L2 1e-5 (read 3.5e-7-
  4.9e-7): the ViT alone, before the decoder;
* each step's clipped gradient, the reference run for one step from the
  program's own state before it (so that one step's round-off does not
  reach the next through AdamW, which turns a gradient of pure round-off
  into a full step): the whole gradient within rel-L2 1e-4 and each leaf
  within 2e-4 of the larger of its norm and the median leaf's (read up to
  1.6e-5 and 2.7e-5);
* the parameter change of the first step, over the leaves whose gradient is
  at least a thousandth of the median leaf's (``benchlib.compare``'s rule)
  and the elements whose gradient is at least a thousandth of their
  leaf's largest, within rel-L2 1e-4: AdamW's first step moves an element
  by nearly the learning rate whatever its gradient's size, so an element
  whose gradient is round-off moves at random (read 1.0e-5 at every seed).

Each tolerance is 6-70 times the largest reading.

Two planted faults fail it, each by at least ten times a tolerance: the
attention dropout drawn per sample and head rather than one mask broadcast
over them (the reference then multiplies by another mask), and the mean
over the tokens replaced by the first token: each reads a gradient gap of
1.5 and a latent gap of 0.65-0.99.

The cell's own driver at this size: in f32 it is ``correct`` at its tiny
limits, the 8-bit control and the ViT computed in bf16 are not; the frozen
FLOP count against a hand count, and ViT-B/16's (46.0 GFLOP an image, 14.70
TFLOP a step at batch 64); the ViT's spans ``vit.attention`` and
``vit.mlp`` nest inside ``lc.conditioner`` once a block a step, and
``vit.blocks`` counts the block forwards.
"""

import statistics
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
BENCH_DIR = ROOT / "bench_port"
for p in (str(ROOT), str(BENCH_DIR), str(BENCH_DIR / "tests")):
    if p not in sys.path:
        sys.path.insert(0, p)

from benchlib import harness, inputs, serving, vit_work, work  # noqa: E402
from reference import vae as ref_vae  # noqa: E402
from reference import vit as ref_vit  # noqa: E402

import e2e_vit_readings  # noqa: E402
import tiny  # noqa: E402

BATCH, STEPS = 8, 3
LOSS_TOL, LATENT_TOL, GRAD_TOL, LEAF_TOL, CHANGE_TOL = 1e-5, 1e-5, 1e-4, 2e-4, 1e-4
CPU = torch.device("cpu")


def e2e_config():
    return tiny.config(
        num_param=5 * BATCH, num_filter_enc=[16, 8, 8, 8],
        conditioner=dict(type="vit", patch_size=16, embed_dim=64, depth=2, num_heads=4,
                         mlp_ratio=4, image_side=32, dropout_rate=0.2),
        e2e=dict(batch_size=BATCH, lr=1e-3, weight_decay=1e-5, epochs=500,
                 loss_function="Huber", lc_alpha=1000.0, latent_regularization=True,
                 latent_reg_weight=1e-3, val_split=0.3))


def _norm(tensors, keys):
    return sum(float(tensors[k].norm()) ** 2 for k in keys) ** 0.5


def _rel(have, want, keys):
    return _norm({k: have[k] - want[k] for k in keys}, keys) / _norm(want, keys)


def _leaf(have, want):
    median = statistics.median(float(v.norm()) for v in want.values())
    return max(float((have[k] - want[k]).norm()) / max(float(want[k].norm()), median)
               for k in want)


def gaps(seed: int) -> dict:
    """The program's first steps against the reference's, as the worst
    numbers of the module docstring."""
    drv = harness.driver("e2e_vit_loop")
    cfg = e2e_config()
    trainer, state, train, _ = drv.build(cfg, seed, CPU)
    grads, before = [], []
    clip, step = trainer.clip, trainer._step

    def clipping(g):
        out = clip(g)
        grads.append({k: v.detach().clone() for k, v in out[0].items()})
        return out

    def stepping(st, batch, lr):
        before.append({k: v.detach().clone() for k, v in st.model.state_dict().items()})
        return step(st, batch, lr)

    trainer.clip, trainer._step = clipping, stepping
    first = drv.FirstSteps(trainer, STEPS)
    trainer.train_epoch(state, *train)
    first.close()
    drawn, seen = first.drawn(), first.seen()
    shapes = ref_vae.param_shapes(cfg)
    w = inputs.weights(shapes, seed, "vae", CPU)
    v = inputs.unit_vectors(shapes, ref_vae.sn_names(shapes), seed, CPU)
    dec = {k: w[k] for k in ref_vae.decoder_shapes(cfg)}
    dec_us = {k: v[k] for k in dec if k in v}
    scalers = serving.scalers(cfg, seed, CPU)
    out = dict(loss=0.0, latent=0.0, grad=0.0, leaf=0.0, change=0.0)
    for k in range(STEPS):
        params = before[k]
        ref = ref_vit.train_steps(cfg, params, dec, dec_us, scalers, drawn["batches"][k:k + 1],
                                  drawn["masks"][k:k + 1], drawn["eps"][k:k + 1])
        r = ref["grads"]
        out["loss"] = max(out["loss"], abs(first.losses[k] - ref["losses"][0])
                          / abs(ref["losses"][0]))
        out["grad"] = max(out["grad"], _rel(grads[k], r, list(r)))
        out["leaf"] = max(out["leaf"], _leaf(grads[k], r))
        if k == 0:
            out["latent"] = drv.latent_gap(seen["latents"], ref["latents"])
            median = statistics.median(float(g.norm()) for g in r.values())
            moving = [q for q, g in r.items() if float(g.norm()) >= 1e-3 * median]
            kept = {q: r[q].abs() >= 1e-3 * r[q].abs().max() for q in moving}
            after = before[1]
            have = {q: (after[q] - params[q]) * kept[q] for q in moving}
            want = {q: (ref["params"][q] - params[q]) * kept[q] for q in moving}
            out["change"] = _rel(have, want, moving)
    return out


def _passes(g: dict) -> bool:
    return (g["loss"] <= LOSS_TOL and g["latent"] <= LATENT_TOL and g["grad"] <= GRAD_TOL
            and g["leaf"] <= LEAF_TOL and g["change"] <= CHANGE_TOL)


def _worst_over_tolerance(g: dict) -> float:
    return max(g["loss"] / LOSS_TOL, g["latent"] / LATENT_TOL, g["grad"] / GRAD_TOL,
               g["leaf"] / LEAF_TOL, g["change"] / CHANGE_TOL)


def _per_head_attention_dropout(monkeypatch):
    from simulgen_vae_tpu_torch.models import conditioner_vit

    def per_head(weights, rate, generator):
        if generator is None or rate == 0.0:
            return weights
        keep = 1.0 - rate
        mask = torch.rand(weights.shape, generator=generator, device=weights.device) < keep
        return weights * (mask.to(weights.dtype) / keep)

    monkeypatch.setattr(conditioner_vit, "attention_dropout", per_head)


def _first_token(monkeypatch):
    from simulgen_vae_tpu_torch.models import conditioner_vit as cv
    from simulgen_vae_tpu_torch.models.conditioner_cnn import image_batch

    def first(self, x, generator=None, train=None):
        tokens = self.patch_embed(self.patchify(image_batch(x))) + self.pos_embed
        tokens = cv.dropout(tokens, self.dropout_rate, generator)
        for block in self.blocks:
            tokens = block(tokens, generator)
        feats = self.norm(tokens)[:, 0]
        xs = self.xs_head(feats).reshape(-1, self.size2, self.latent_dim)
        return self.latent_main_head(feats), xs

    monkeypatch.setattr(cv.LatentConditionerViT, "forward", first)


@pytest.mark.parametrize("fault, seed", [
    (None, 5), (None, 2 ** 31 + 9), (_per_head_attention_dropout, 5), (_first_token, 5)],
    ids=["sound", "sound-large-seed", "per-head-attention-dropout", "first-token"])
def test_the_vit_e2e_trainer_agrees_with_the_plain_reference(monkeypatch, fault, seed):
    if fault is not None:
        fault(monkeypatch)
    g = gaps(seed)
    if fault is None:
        assert _passes(g), g
    else:
        assert _worst_over_tolerance(g) >= 10.0, g


CELL = dict(driver="e2e_vit_loop",
            limits=dict(loss_gap=1e-4, grad_gap=1e-3, change_gap=1e-3, latent_gap=1e-4))


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 5])
def test_the_cell_driver_is_correct_in_f32(seed):
    cfg = e2e_config()
    out = tiny.run(CELL, cfg, seed)
    assert out.correct, out.checks
    assert set(out.checks) == set(CELL["limits"])
    assert out.attempted > 0 and out.attempted % 3 == 0 and out.failed == 0
    assert out.e2e["train_samples_per_s"] > 0 and out.e2e["setup_s"] > 0
    assert out.window["flops_per_unit"] == vit_work.step_flops(cfg)


def test_the_8bit_control_and_the_bf16_vit_are_not_correct():
    cfg = e2e_config()
    got = e2e_vit_readings.control(cfg, 5, CPU)
    assert all(got["program"][k] <= lim for k, lim in CELL["limits"].items()), got
    assert got["control"]["latent_gap"] > CELL["limits"]["latent_gap"], got
    ctx = harness.Ctx("tiny", CELL, cfg, 5, 0.2, False, CPU)
    out = e2e_vit_readings.faulty_run(ctx, "bf16_vit")
    assert not out.correct and out.checks["latent_gap"][0] > CELL["limits"]["latent_gap"]


def test_vit_flops_match_a_hand_count_and_vit_b16():
    # 32 x 32 image: 4 tokens of 256 pixels, width 64, MLP 256, 2 blocks, heads 4 + 6
    per_block = 2 * 4 * 64 * 64 * 4 + 2 * 4 * 4 * 64 * 2 + 2 * 4 * 64 * 256 * 2
    vit = 2 * 4 * 256 * 64 + 2 * per_block + 2 * 64 * (4 + 6)
    c = e2e_config()["conditioner"]
    assert vit_work.vit_forward_flops(c, (4, 6)) == vit
    cfg = e2e_config()
    dec = work.field_flops(cfg)
    # 40 designs: 28 training (3 steps of 8), 12 held out (1 batch)
    assert vit_work.step_flops(cfg) == pytest.approx(8 * (3 * vit + 2 * dec) + 8 / 3 * (vit + dec))
    b16 = dict(c, embed_dim=768, depth=12, num_heads=12, image_side=256)
    assert vit_work.vit_forward_flops(b16, (32, 24)) / 1e9 == pytest.approx(46.0, abs=0.05)
    full = dict(num_param=2000, num_time=50, num_node=95008, num_filter_enc=[1024, 512, 256, 128],
                latent_dim_end=32, latent_dim=8, conditioner=b16, e2e=dict(cfg["e2e"], batch_size=64))
    assert vit_work.step_flops(full) / 1e12 == pytest.approx(14.70, abs=0.005)


def test_the_vit_spans_nest_in_the_conditioner_and_count_the_blocks():
    from simulgen_vae_tpu_torch.utils import profiling

    drv = harness.driver("e2e_vit_loop")
    cfg = e2e_config()
    trainer, state, train, _ = drv.build(cfg, 5, CPU)
    with profiling.recording() as rec:
        trainer.train_epoch(state, *train)
    spans = rec.spans
    depth, steps = cfg["conditioner"]["depth"], STEPS

    def parents(i):
        while spans[i][3] >= 0:
            i = spans[i][3]
            yield spans[i][0]

    for name in ("vit.attention", "vit.mlp"):
        at = [i for i, s in enumerate(spans) if s[0] == name]
        assert len(at) == depth * steps, name
        assert all("lc.conditioner" in parents(i) for i in at), name
    assert rec.counters["vit.blocks"] == depth * steps and rec.counters["lc.steps"] == steps
    out = harness.Outcome(e2e={}, attempted=1, failed=0, checks={}, memory_peak_bytes=0,
                          config=cfg, workload=CELL, traced_units=steps)
    for name in ("vit_attention_ms.e2e", "vit_mlp_ms.e2e"):
        assert harness.reader(name).read(out) is None, name
