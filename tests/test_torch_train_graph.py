"""The train step's graph path on the CPU (no capture here: the CPU runs the
eager loop, and a CUDA graph exists only on the card).

* The capturable step body (``VAETrainer._step_body``), reading every host
  value from the staged buffer, gives the eager step's bits for three steps
  from one seed: losses, parameters, AdamW moments and power-iteration
  vectors, for f32 and bf16 compute and f32 and bf16 moments.
* The staged row holds what ``assemble_batch`` hands ``gather_augment``, and
  the host draws keep the trainer's order (permutation, then per step the
  partners, the augmentation scalars, the noise seed), which the benchmark's
  reference replays.
* ``graph_engages``: each condition picks the graph or the eager loop.
* The capture and replay counters are registered and stay 0 on the CPU.
* ``_epoch_metrics`` over per-step rows copied into an epoch buffer equals
  the eager epoch's.

On the card ``chip_smoke.py`` (phase 5, ``graph_against_eager``) holds the
replayed steps against the eager ones.
"""

import dataclasses

import numpy as np
import pytest
import torch

from simulgen_vae_tpu_torch.config import VAEConfig
from simulgen_vae_tpu_torch.data.augmentation import AugmentationConfig
from simulgen_vae_tpu_torch.ops import gather_augment as tga
from simulgen_vae_tpu_torch.train import vae_trainer as vt
from simulgen_vae_tpu_torch.train.vae_trainer import STEP_METRICS, HostStep, VAETrainer
from simulgen_vae_tpu_torch.utils import profiling
from simulgen_vae_tpu_torch.utils.staging import Staging

T, NODE, N, B = 12, 300, 16, 4


def _cfg(**kw):
    base = dict(num_param=N, num_time=T, num_node=NODE, latent_dim_end=8, latent_dim=4,
                num_filter_enc=[16, 8, 8], small=True, n_epochs=30, batch_size=B,
                lr=1e-3, alpha=100.0)
    base.update(kw)
    return VAEConfig(**base)


def _data(dtype=torch.float32):
    rng = np.random.default_rng(0)
    return torch.from_numpy(rng.uniform(-0.7, 0.7, (N, T, NODE)).astype(np.float32)).to(dtype)


def _leaves(state):
    out = [("param " + k, p) for k, p in state.model.named_parameters()]
    for part in ("mu", "nu"):
        out += [(f"{part} {k}", v) for k, v in state.opt_state[part].items()]
    return out + [("u " + k, u) for k, u in state.sn_u.items()]


@pytest.mark.parametrize("dtype,moments", [("float32", "auto"), ("float32", "bfloat16"),
                                           ("bfloat16", "auto"), ("bfloat16", "bfloat16")])
def test_step_body_equals_the_eager_step(dtype, moments):
    cfg = _cfg(dtype=dtype, opt_state_dtype=moments)
    data = _data(vt._DTYPES[dtype])
    eager, staged = VAETrainer(cfg, device="cpu", seed=3), VAETrainer(cfg, device="cpu", seed=3)
    se, sb = eager.init_state(5), staged.init_state(5)
    beta, lr = 0.37, 1.3e-3
    perm_e = eager.rng.permutation(N).reshape(-1, B)
    perm_b = staged.rng.permutation(N).reshape(-1, B)
    for i in range(3):
        m = eager.eager_step(se, data, perm_e[i], beta, lr)
        pidx, scalars, seed = staged._draws(N, B)
        stage = staged._stage_step(sb, HostStep(data, perm_b[i], pidx, scalars, seed), beta, lr)
        vec = staged._step_body(sb, data, stage)
        assert vec.dtype == torch.float32 and vec.shape == (len(STEP_METRICS),)
        assert torch.equal(torch.stack([m[k].float() for k in STEP_METRICS]), vec), i
    assert se.opt_state["count"] == sb.opt_state["count"] == 3
    for (name, a), (_, b) in zip(_leaves(se), _leaves(sb)):
        assert a.dtype == b.dtype and torch.equal(a, b), name


def test_staged_row_holds_what_assemble_batch_hands_the_kernel(monkeypatch):
    """Draw order and packing: the graph path's draws and staged views against
    what ``assemble_batch`` passes ``gather_augment`` from the same seed, and
    both against a fresh generator drawn in the trainer's order."""
    data = _data()
    eager, staged = VAETrainer(_cfg(), device="cpu", seed=11), VAETrainer(_cfg(), device="cpu",
                                                                         seed=11)
    seen = []

    def keep(data, idx, pidx, seed, lam_eff, amp, noise_sd, generator=None):
        seen.append([t.clone() for t in (idx, pidx, seed, lam_eff, amp, noise_sd)])
        return tga.gather_augment_reference(data, idx, pidx, None, lam_eff, amp, noise_sd)

    monkeypatch.setattr(vt, "gather_augment", keep)
    rng = np.random.default_rng(11)
    perm = rng.permutation(N).reshape(-1, B)
    assert np.array_equal(perm, eager.rng.permutation(N).reshape(-1, B))
    assert np.array_equal(perm, staged.rng.permutation(N).reshape(-1, B))
    state = staged.init_state(0)
    for idx in perm[:3]:
        eager.assemble_batch(data, idx)
        pidx, scalars, seed = staged._draws(N, B)
        want_pidx = rng.integers(0, N, B)
        want_scalars = tga.draw_augment_scalars(rng, B)
        want_seed = int(rng.integers(0, 2 ** 31 - 1))
        assert np.array_equal(pidx, want_pidx) and seed == want_seed
        assert all(np.array_equal(a, b) for a, b in zip(scalars, want_scalars))
        stage = staged._stage_step(state, HostStep(data, idx, pidx, scalars, seed), 0.25, 2e-3)
        views = (stage.idx, stage.pidx, stage.seed, stage.lam_eff, stage.amp, stage.noise_sd)
        for got, want in zip(views, seen[-1]):
            assert got.dtype == want.dtype and torch.equal(got, want)
        assert stage.seed.tolist() == [seed] and float(stage.beta) == 0.25
        words = staged.opt.step_words(state.opt_state["count"], 2e-3)
        assert np.array_equal(stage.step.numpy(), words)


def test_step_stage_layout():
    stage = vt.StepStage(3, "cpu")
    assert stage.staging.width == 5 * 3 + 6
    buf = stage.staging.buffer
    views = (stage.idx, stage.pidx, stage.lam_eff, stage.amp, stage.noise_sd, stage.seed,
             stage.step)
    assert all(v.untyped_storage().data_ptr() == buf.untyped_storage().data_ptr()
               for v in views)
    stage.send([1, 2, 3], [4, 5, 6], (np.float32([0.5] * 3), np.float32([1.1] * 3),
                                      np.float32([0.05, 0, 0.05])), 2 ** 32 - 2, 0.75,
               np.arange(4, dtype=np.int32))
    assert stage.idx.tolist() == [1, 2, 3] and stage.pidx.tolist() == [4, 5, 6]
    assert stage.lam_eff.tolist() == [0.5] * 3 and stage.noise_sd[1] == 0
    assert int(stage.seed) % 2 ** 32 == 2 ** 32 - 2 and float(stage.beta) == 0.75
    assert stage.step.tolist() == [0, 1, 2, 3]


def test_staging_sends_the_row_it_handed_out():
    stage = Staging(5, "cpu")
    with pytest.raises(RuntimeError):
        stage.send()
    stage.row()[:] = np.arange(5)
    assert stage.send().tolist() == [0, 1, 2, 3, 4]
    with pytest.raises(RuntimeError):
        stage.send()  # one copy a row


@pytest.mark.parametrize("change,engages", [
    ({}, True),
    ({"device": "cpu"}, False),
    ({"mesh": object()}, False),
    ({"aug": AugmentationConfig(shift_prob=0.5)}, False),
    ({"aug": AugmentationConfig(enabled=False)}, False),
    ({"cfg": {"sn_cadence": "epoch"}}, False),
    ({"cfg": {"sn_cadence": "epoch", "use_spectral_norm": False}}, True),
    ({"cfg": {"sn_cadence": "step"}}, True),
    ({"cfg": {"opt_state_dtype": "bfloat16"}}, True),
    ({"cfg": {"remat": True}}, False),
])
def test_graph_engages_on_what_it_observes(change, engages):
    """The rule on a trainer that looks like one on a card (only its device
    is set: nothing runs)."""
    cfg = dataclasses.replace(_cfg(), **change.get("cfg", {}))
    trainer = VAETrainer(cfg, aug=change.get("aug", AugmentationConfig()), device="cpu")
    trainer.device = torch.device(change.get("device", "cuda"), 0) \
        if change.get("device", "cuda") == "cuda" else torch.device("cpu")
    trainer.mesh = change.get("mesh")
    assert trainer.graph_engages() is engages


def test_counters_are_registered_and_stay_zero_on_the_cpu():
    merged = profiling.counters()
    assert {"train.graph_captures", "train.graph_replays"} <= set(merged)
    before = dict(vt.COUNTERS)
    trainer = VAETrainer(_cfg(), device="cpu", seed=1)
    state = trainer.init_state(1)
    with profiling.recording() as rec:
        state, _ = trainer.train_epoch(state, _data(), max_steps=2)
    assert vt.COUNTERS == before
    assert rec.counters["train.graph_captures"] == rec.counters["train.graph_replays"] == 0
    assert not any(s[0] in ("train.capture", "train.replay") for s in rec.spans)


def test_epoch_metrics_over_copied_rows_equal_the_eager_epochs():
    data = _data()
    eager, staged = VAETrainer(_cfg(), device="cpu", seed=2), VAETrainer(_cfg(), device="cpu",
                                                                        seed=2)
    se, sb = eager.init_state(4), staged.init_state(4)
    _, want = eager.train_epoch(se, data)
    beta, lr = staged._schedules(sb.epoch)
    perm = staged.rng.permutation(N).reshape(-1, B)
    out = torch.empty((len(perm), len(STEP_METRICS)))
    for i, idx in enumerate(perm):
        pidx, scalars, seed = staged._draws(N, B)
        stage = staged._stage_step(sb, HostStep(data, idx, pidx, scalars, seed, out[i]),
                                   beta, lr)
        out[i].copy_(staged._step_body(sb, data, stage))
    got = staged._epoch_metrics(out, beta, lr)
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in STEP_METRICS)
    assert (got["beta"], got["lr"]) == (want["beta"], want["lr"])
