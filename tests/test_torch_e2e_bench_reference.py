"""The port's ``E2ETrainer`` against the benchmark's plain reference of the
E2E step (``bench_port/reference/e2e.py``), f32 on the CPU, at a tiny size:
a CNN with filters 8 .. 32 on 64 x 64 images, a three-level decoder, batch
16, seeded weights and power-iteration vectors, three steps of one epoch.

The program's draws (each noisy batch, the dropout masks, the decoder's
noise) are recorded by the benchmark's recorder (``drivers/e2e_loop.py``'s
``FirstSteps``) and handed to the reference, which draws nothing. Checked:

* the three consecutive steps' losses, within 1e-5 relative;
* each step's clipped gradient, the reference run for one step from the
  program's own state before it (so that one step's round-off does not
  reach the next through AdamW, which turns a gradient of pure round-off
  into a full step): the whole gradient within rel-L2 5e-3, and each leaf
  within 2e-2 of the larger of its norm and the median leaf's. Both sides
  are f32 and the CNN is not smooth: where round-off changes a max-pool or
  channel-max winner, the gradient flows through another element (seen
  over eight seeds: the whole gradient up to 1.7e-3, a leaf up to 7.6e-3;
  without such a change they agree to 1e-5), and a bias before a
  training-mode BatchNorm has a gradient of round-off alone, which the
  median floor absorbs;
* the parameter change of the first step, over the leaves whose gradient is
  at least a thousandth of the median leaf's (``benchlib.compare``'s rule)
  and the elements whose gradient is at least a thousandth of their
  leaf's largest, within rel-L2 5e-2: AdamW's first step moves an element
  by nearly the learning rate whatever its gradient's size, so an element
  whose gradient is round-off moves at random (over all elements the gap
  read up to 4.6e-2; over these 1.3e-5, and 1.5e-2 with a changed winner);
* every step's power-iteration vectors, within 1e-5.

Two planted faults fail it, each by at least ten times a tolerance: the
descale detached from the graph (the original's behaviour, which leaves
the reconstruction term training nothing: the gradient reads 1) and the
spatial attention dropped from the CNN (the gradient 0.6-1.2).
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

from benchlib import harness, inputs, serving  # noqa: E402
from reference import e2e as ref_e2e  # noqa: E402
from reference import vae as ref_vae  # noqa: E402

import tiny  # noqa: E402

BATCH, STEPS = 16, 3
LOSS_TOL, GRAD_TOL, LEAF_TOL, CHANGE_TOL, U_TOL = 1e-5, 5e-3, 2e-2, 5e-2, 1e-5
CPU = torch.device("cpu")


def e2e_config():
    return tiny.config(
        num_param=5 * BATCH, num_filter_enc=[16, 8, 8, 8],
        conditioner=dict(type="cnn", filters=[8, 16, 32, 32, 32, 32], image_side=64,
                         spatial_attention=True, dropout_rate=0.2),
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
    drv = harness.driver("e2e_loop")
    cfg = e2e_config()
    trainer, state, train, _ = drv.build(cfg, seed, CPU)
    grads, before = [], []
    clip, step = trainer.clip, trainer._step

    def clipping(g):
        out = clip(g)
        grads.append({k: v.detach().clone() for k, v in out[0].items()})
        return out

    def stepping(st, batch, lr):
        before.append(({k: v.detach().clone() for k, v in st.model.state_dict().items()},
                       dict(st.sn_u)))
        return step(st, batch, lr)

    trainer.clip, trainer._step = clipping, stepping
    first = drv.FirstSteps(trainer, STEPS)
    trainer.train_epoch(state, *train)
    first.close()
    drawn = first.drawn()
    before.append(({k: p.detach() for k, p in state.model.named_parameters()}, first.us))
    shapes = ref_vae.param_shapes(cfg)
    w = inputs.weights(shapes, seed, "vae", CPU)
    v = inputs.unit_vectors(shapes, ref_vae.sn_names(shapes), seed, CPU)
    dec = {k: w[k] for k in ref_vae.decoder_shapes(cfg)}
    dec_us = {k: v[k] for k in dec if k in v}
    scalers = serving.scalers(cfg, seed, CPU)
    out = dict(loss=0.0, grad=0.0, leaf=0.0, change=0.0, u=0.0)
    for k in range(STEPS):
        params, us = before[k]
        ref = ref_e2e.train_steps(cfg, params, us, dec, dec_us, scalers,
                                  drawn["batches"][k:k + 1], drawn["masks"][k:k + 1],
                                  drawn["eps"][k:k + 1])
        r = ref["grads"]
        out["loss"] = max(out["loss"], abs(first.losses[k] - ref["losses"][0])
                          / abs(ref["losses"][0]))
        out["grad"] = max(out["grad"], _rel(grads[k], r, list(r)))
        out["leaf"] = max(out["leaf"], _leaf(grads[k], r))
        nxt = before[k + 1][1]
        out["u"] = max(out["u"], max(float((nxt[q] - ref["us"][q]).norm() / ref["us"][q].norm())
                                     for q in ref["us"]))
        if k == 0:
            median = statistics.median(float(g.norm()) for g in r.values())
            moving = [q for q, g in r.items() if float(g.norm()) >= 1e-3 * median]
            kept = {q: r[q].abs() >= 1e-3 * r[q].abs().max() for q in moving}
            after = before[1][0]
            have = {q: (after[q] - params[q]) * kept[q] for q in moving}
            want = {q: (ref["params"][q] - params[q]) * kept[q] for q in moving}
            out["change"] = _rel(have, want, moving)
    return out


def _passes(g: dict) -> bool:
    return (g["loss"] <= LOSS_TOL and g["grad"] <= GRAD_TOL and g["leaf"] <= LEAF_TOL
            and g["change"] <= CHANGE_TOL and g["u"] <= U_TOL)


def _detached_descale(monkeypatch):
    from simulgen_vae_tpu_torch.train.lc_e2e_trainer import E2ETrainer

    descale = E2ETrainer._descale
    monkeypatch.setattr(E2ETrainer, "_descale",
                        lambda self, a, b: tuple(t.detach() for t in descale(self, a, b)))


def _no_spatial_attention(monkeypatch):
    from simulgen_vae_tpu_torch.models.conditioner_cnn import SpatialAttention

    monkeypatch.setattr(SpatialAttention, "forward", lambda self, x: x)


@pytest.mark.parametrize("fault, seed", [
    (None, 5), (None, 2 ** 31 + 9), (_detached_descale, 5), (_no_spatial_attention, 5)],
    ids=["sound", "sound-large-seed", "detached-descale", "no-spatial-attention"])
def test_the_e2e_trainer_agrees_with_the_plain_reference(monkeypatch, fault, seed):
    if fault is not None:
        fault(monkeypatch)
    g = gaps(seed)
    if fault is None:
        assert _passes(g), g
    else:
        assert not _passes(g), g
