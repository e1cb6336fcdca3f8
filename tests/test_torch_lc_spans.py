"""The latent-conditioner trainers' spans and counters (``utils.profiling``):

* an ``E2ETrainer`` epoch records ``lc.epoch`` holding one ``lc.step`` a
  batch, each with ``lc.augment``, ``lc.conditioner``, ``lc.decode`` (the
  decoder's ``decoder.readout`` inside), ``lc.loss``, ``lc.backward`` and
  ``lc.optimizer`` in that order, keyed by the step; the held-out pass one
  ``lc.eval`` a batch with ``lc.conditioner``, ``lc.decode`` and
  ``lc.loss``; ``lc.steps`` and ``lc.eval_batches`` count the epoch's
  batches;
* the CSV ``LCTrainer``'s steps hold the same phases but the decode;
* outside ``recording()`` nothing is recorded and nothing counted;
* an epoch and its held-out pass give bit-equal metrics and parameters with
  recording on and off, for both trainers.
"""

import numpy as np
import pytest
import torch

from simulgen_vae_tpu_torch.data.scaler import MinMaxScaler
from simulgen_vae_tpu_torch.models.conditioner_cnn import LatentConditionerImg, sn_filter
from simulgen_vae_tpu_torch.models.conditioner_mlp import LatentConditioner
from simulgen_vae_tpu_torch.models.vae import VAE
from simulgen_vae_tpu_torch.train.lc_e2e_trainer import E2ETrainer
from simulgen_vae_tpu_torch.train.lc_trainer import LCTrainer
from simulgen_vae_tpu_torch.utils import profiling

Z, H, DEC, T, NODES, SIDE, N, BATCH = 4, 2, [8, 8, 16], 8, 32, 32, 14, 4
STEP_PHASES = ["lc.augment", "lc.conditioner", "lc.decode", "lc.loss", "lc.backward",
               "lc.optimizer"]
EVAL_PHASES = ["lc.conditioner", "lc.decode", "lc.loss"]
LEVELS = len(DEC) - 1


def _rows(n, *shape, seed):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand((n, *shape), generator=g) - 0.5) * 1.4


def _e2e():
    torch.manual_seed(0)
    vae = VAE(Z, H, DEC, NODES, T, True, "cpu", torch.float32)
    lc = LatentConditionerImg([4, 8, 8, 16, 16, 16], Z, H, LEVELS, 0.2, True, "cpu")
    scale = lambda w: MinMaxScaler(torch.full((w,), 0.7), torch.zeros(w))  # noqa: E731
    trainer = E2ETrainer(lc, vae, scale(Z), scale(H * LEVELS), epochs=10, lr=1e-3,
                         batch_size=BATCH, loss_function="Huber", lc_alpha=1000.0,
                         sn_filter=sn_filter, device="cpu", seed=3)
    data = [_rows(N, SIDE * SIDE, seed=1) + 0.7, _rows(N, Z, seed=2), _rows(N, LEVELS, H, seed=3),
            _rows(N, T, NODES, seed=4)]
    return trainer, data


def _csv():
    lc = LatentConditioner([8, 16], Z, 6, H, LEVELS, "cpu", 0.2)
    trainer = LCTrainer(lc, epochs=10, lr=1e-3, batch_size=BATCH, device="cpu", seed=3)
    return trainer, [_rows(N, 6, seed=1), _rows(N, Z, seed=2), _rows(N, LEVELS, H, seed=3)]


def _epoch(make, record: bool):
    trainer, data = make()
    state = trainer.init_state(0)
    held_out = [t[:BATCH * 2] for t in data]
    if record:
        with profiling.recording() as rec:
            state, metrics = trainer.train_epoch(state, *data)
            val = trainer.eval_epoch(state, *held_out)
    else:
        rec = None
        state, metrics = trainer.train_epoch(state, *data)
        val = trainer.eval_epoch(state, *held_out)
    out = {k: v for k, v in metrics.items() if torch.is_tensor(v)}
    out.update({f"val_{k}": v for k, v in val.items()})
    out.update({f"param:{k}": p.detach() for k, p in state.model.named_parameters()})
    return out, rec


def _children(spans, i):
    return [j for j, s in enumerate(spans) if s[3] == i]


def _names(spans, idx):
    return [spans[j][0] for j in idx]


@pytest.mark.parametrize("make, phases", [(_e2e, STEP_PHASES),
                                          (_csv, [p for p in STEP_PHASES if p != "lc.decode"])],
                         ids=["e2e", "csv"])
def test_an_epoch_records_its_steps_phases_and_held_out_batches(make, phases):
    _, rec = _epoch(make, record=True)
    spans = rec.spans
    steps, evals = N // BATCH, 2
    roots = [i for i, s in enumerate(spans) if s[3] == -1]
    assert _names(spans, roots) == ["lc.epoch"] + ["lc.eval"] * evals
    kids = _children(spans, roots[0])
    assert _names(spans, kids) == ["lc.step"] * steps
    keys = [spans[i][4] for i in kids]
    assert keys == list(range(keys[0], keys[0] + steps))
    assert rec.counters["lc.steps"] == steps and rec.counters["lc.eval_batches"] == evals
    eval_phases = [p for p in EVAL_PHASES if p in phases]
    for i in kids:
        inner = _children(spans, i)
        assert _names(spans, inner) == phases
        assert all(spans[j][4] == spans[i][4] for j in inner)
        for j in inner:
            assert spans[i][1] <= spans[j][1] <= spans[j][2] <= spans[i][2]
    for i in roots[1:]:
        assert _names(spans, _children(spans, i)) == eval_phases
    for i, s in enumerate(spans):
        if s[0] == "lc.decode":
            assert _names(spans, _children(spans, i)) == ["decoder.readout"]


def test_nothing_is_recorded_outside_a_recording():
    before = profiling.counters()
    assert profiling.tick("lc.steps") is None and profiling.tick("lc.eval_batches") is None
    _epoch(_e2e, record=False)
    after = profiling.counters()
    assert after["lc.steps"] == before["lc.steps"]
    assert after["lc.eval_batches"] == before["lc.eval_batches"]
    with profiling.recording() as rec:
        pass
    assert rec.spans == [] and rec.counters["lc.steps"] == 0


@pytest.mark.parametrize("make", [_e2e, _csv], ids=["e2e", "csv"])
def test_recording_leaves_the_epoch_bit_equal(make):
    off, _ = _epoch(make, record=False)
    on, _ = _epoch(make, record=True)
    assert set(off) == set(on)
    for k in off:
        np.testing.assert_array_equal(on[k].numpy(), off[k].numpy(), err_msg=k)
