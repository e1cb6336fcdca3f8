"""Checkpoints, rollback, preemption, streaming and spans of the port's
``VAETrainer.fit`` on the CPU at a narrow width (T = 12, 300 nodes, batch 4).

A restored run must equal the uninterrupted one bit for bit: parameters,
moments (bf16 too), ``u`` vectors, epoch and step count, which needs the
host and device generator states to travel with the checkpoint.
"""

import numpy as np
import pytest
import torch

from simulgen_vae_tpu_torch.config import VAEConfig
from simulgen_vae_tpu_torch.train import vae_trainer as vt
from simulgen_vae_tpu_torch.train.nan_guard import rollback
from simulgen_vae_tpu_torch.train.vae_trainer import VAETrainer
from simulgen_vae_tpu_torch.utils import preemption
from simulgen_vae_tpu_torch.utils.checkpoint import CheckpointManager

T, NODE, B = 12, 300, 4


def _cfg(**kw):
    base = dict(num_param=16, num_time=T, num_node=NODE, latent_dim_end=8, latent_dim=4,
                num_filter_enc=[16, 8, 8], small=True, n_epochs=30, batch_size=B,
                lr=1e-3, alpha=100.0)
    base.update(kw)
    return VAEConfig(**base)


@pytest.fixture(scope="module")
def data():
    return (0.4 * np.random.default_rng(0).standard_normal((20, T, NODE))).astype(np.float32)


@pytest.fixture(autouse=True)
def _clear_preemption():
    preemption.clear()
    yield
    preemption.clear()


def _assert_same_state(a, b):
    assert a.epoch == b.epoch and a.opt_state["count"] == b.opt_state["count"]
    for (k, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), k
    for part in ("mu", "nu"):
        for k, v in a.opt_state[part].items():
            assert v.dtype == b.opt_state[part][k].dtype
            assert torch.equal(v, b.opt_state[part][k]), (part, k)
    for k, u in a.sn_u.items():
        assert torch.equal(u, b.sn_u[k]), k


@pytest.mark.parametrize("stack", ["f32", "benched"])
def test_restored_run_equals_the_uninterrupted_one(tmp_path, data, stack):
    kw = {} if stack == "f32" else dict(opt_state_dtype="bfloat16", sn_cadence="epoch")
    fused = stack == "benched"
    mgr = CheckpointManager(str(tmp_path), save_interval_epochs=50)
    first = VAETrainer(_cfg(**kw), device="cpu", seed=5, fused_readout=fused)
    state, _ = first.fit(data, seed=1, epochs=2, val_every=1, ckpt_manager=mgr)
    assert mgr.latest_step() == 2 and state.epoch == 2          # the forced final save
    state, _ = first.fit(data, seed=1, epochs=2, val_every=1, state=state)

    second = VAETrainer(_cfg(**kw), device="cpu", seed=99, fused_readout=fused)
    restored = mgr.restore(second.init_state(7))
    assert restored.epoch == 2 and restored.opt_state["count"] == 8
    if stack == "benched":
        assert all(v.dtype == torch.bfloat16 for v in restored.opt_state["mu"].values())
    resumed, hist = second.fit(data, seed=1, epochs=2, val_every=1, state=restored)
    assert len(hist["loss"]) == 2
    _assert_same_state(resumed, state)


def test_retention_latest_step_and_maybe_save(tmp_path, data):
    trainer = VAETrainer(_cfg(), device="cpu")
    state = trainer.init_state(0)
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2, save_interval_epochs=2)
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore(state)
    assert not mgr.maybe_save(state, 3)             # off the interval
    assert mgr.maybe_save(state, 2) and mgr.latest_step() == 2
    assert not mgr.maybe_save(state, 2)             # this epoch is saved already
    assert not mgr.maybe_save(state, 2, force=True)
    mgr.save(state, 5)
    assert mgr.maybe_save(state, 6)
    assert mgr.steps() == [5, 6] and mgr.latest_step() == 6     # max_to_keep = 2
    assert sorted(p.name for p in tmp_path.iterdir()) == ["ckpt_00000005.pt",
                                                          "ckpt_00000006.pt"]
    state.epoch = 6
    mgr.save(state, 9)
    assert mgr.restore(trainer.init_state(1), step=9).epoch == 6
    mgr.wait()
    mgr.close()
    other = VAETrainer(_cfg(opt_state_dtype="bfloat16"), device="cpu").init_state(0)
    with pytest.raises(ValueError, match="mu"):
        mgr.restore(other)                          # moments of another dtype


def _poison_once(trainer, at_call):
    """Make the trainer's ``at_call``-th epoch report a non-finite loss and
    poison the parameters, as a diverged step would."""
    real, calls = trainer.train_epoch, []

    def epoch(state, data_, max_steps=None):
        state, metrics = real(state, data_, max_steps)
        calls.append(state.epoch)
        if len(calls) == at_call:
            metrics = dict(metrics, loss=torch.tensor(float("nan")))
            with torch.no_grad():
                next(state.model.parameters()).fill_(float("nan"))
        return state, metrics

    trainer.train_epoch = epoch
    return calls


def test_non_finite_loss_rolls_back_and_finishes(tmp_path, data, capsys):
    trainer = VAETrainer(_cfg(), device="cpu", seed=2)
    mgr = CheckpointManager(str(tmp_path), save_interval_epochs=2)
    calls = _poison_once(trainer, at_call=4)
    state, hist = trainer.fit(data, seed=0, epochs=6, val_every=1, ckpt_manager=mgr)
    assert "[nan_guard:vae] non-finite train loss at epoch 3; rolled back to checkpointed "\
           "epoch 2 (retry 1/2)" in capsys.readouterr().out
    # epochs 1-4 ran, the 4th diverged; back to the checkpoint of epoch 2, then 3-6 again
    assert calls == [1, 2, 3, 4, 3, 4, 5, 6]
    assert state.epoch == 6 and len(hist["loss"]) == 6 and np.isfinite(hist["loss"]).all()
    assert all(bool(p.isfinite().all()) for p in state.model.parameters())
    assert mgr.latest_step() == 6


def test_without_a_checkpoint_a_non_finite_loss_raises(data):
    trainer = VAETrainer(_cfg(), device="cpu")
    _poison_once(trainer, at_call=2)
    with pytest.raises(RuntimeError, match=r"nan_guard\[vae\]: non-finite train loss at epoch 1 "
                                           r"and no checkpoint to roll back to"):
        trainer.fit(data, epochs=3, val_every=1)
    quiet = VAETrainer(_cfg(), device="cpu")
    _poison_once(quiet, at_call=2)
    _, hist = quiet.fit(data, epochs=2, val_every=1, nan_guard=False)
    assert np.isnan(hist["loss"][1])


def test_retry_budget_and_never_saving_a_poisoned_state(tmp_path, data):
    trainer = VAETrainer(_cfg(), device="cpu")
    mgr = CheckpointManager(str(tmp_path), save_interval_epochs=1)
    real = trainer.train_epoch

    def always_nan_after_two(state, data_, max_steps=None):
        state, metrics = real(state, data_, max_steps)
        if state.epoch >= 3:
            metrics = dict(metrics, loss=torch.tensor(float("inf")))
        return state, metrics

    trainer.train_epoch = always_nan_after_two
    with pytest.raises(RuntimeError, match="persisted through 2 rollback retries"):
        trainer.fit(data, epochs=5, val_every=1, ckpt_manager=mgr)
    assert mgr.latest_step() == 2                   # epoch 3 was never saved
    with pytest.raises(RuntimeError, match="persisted through 0 rollback retries"):
        rollback(None, 4, 0, {}, mgr, retries=0, max_retries=0)


def test_preemption_stops_after_the_span_and_resumes(tmp_path, data):
    trainer = VAETrainer(_cfg(), device="cpu", seed=4)
    mgr = CheckpointManager(str(tmp_path), save_interval_epochs=50)
    state, hist = trainer.fit(data, seed=0, epochs=6, val_every=2, ckpt_manager=mgr,
                              log_fn=lambda e, m: preemption.request() if e == 1 else None)
    # spans are [0], [1, 2], ...: the request at epoch 1 lands inside the second span
    assert state.epoch == 3 and len(hist["loss"]) == 3 and mgr.latest_step() == 3
    assert preemption.exit_code() == preemption.EX_TEMPFAIL
    preemption.clear()
    fresh = VAETrainer(_cfg(), device="cpu", seed=4)
    restored = mgr.restore(fresh.init_state(0))
    state2, hist2 = fresh.fit(data, seed=0, epochs=3, val_every=2, state=restored,
                              ckpt_manager=mgr)
    assert state2.epoch == 6 and len(hist2["loss"]) == 3 and mgr.latest_step() == 6


def test_streaming_epoch_visits_disjoint_batches(data):
    """18 rows in batches of 4: 4 batches, no wrap-pad; partners from the
    dataset, or the batch rolled by one; max_steps truncates."""
    rows = np.arange(18, dtype=np.float32)[:, None, None] * np.ones((1, T, NODE), np.float32)
    trainer = VAETrainer(_cfg(), device="cpu")
    state = trainer.init_state(0)
    seen = []
    real = trainer.train_step
    trainer.train_step = lambda st, b, p: seen.append((b[:, 0, 0].tolist(), p[:, 0, 0].tolist())) \
        or real(st, b, p)
    state, m = trainer.train_epoch_streaming(state, rows * 0.01)
    batches = [tuple(round(v * 100) for v in b) for b, _ in seen]
    flat = [v for b in batches for v in b]
    assert len(batches) == 4 and len(set(flat)) == 16 and set(flat) <= set(range(18))
    assert state.epoch == 1 and state.opt_state["count"] == 4
    assert torch.is_tensor(m["loss"]) and m["loss"].dim() == 0 and np.isfinite(float(m["loss"]))
    seen.clear()
    state, _ = trainer.train_epoch_streaming(state, rows * 0.01, partner_mode="batch",
                                             max_steps=2)
    assert len(seen) == 2
    for b, p in seen:
        assert p == b[-1:] + b[:-1]                 # the batch rolled by one
    with pytest.raises(ValueError, match="partner_mode"):
        trainer.train_epoch_streaming(state, rows, partner_mode="none")
    with pytest.raises(ValueError, match="host-resident"):
        trainer.train_epoch_streaming(state, torch.zeros((4, T, NODE), device="meta"))


def test_fit_streams_from_the_host(data):
    trainer = VAETrainer(_cfg(dtype="bfloat16"), device="cpu")
    state, hist = trainer.fit(data, epochs=2, val_every=1, stream=True)
    assert state.epoch == 2 and state.opt_state["count"] == 2 * (16 // B)
    assert np.isfinite(hist["loss"]).all() and np.isfinite(hist["val_loss"]).all()


def test_metrics_are_read_back_once_per_span(tmp_path, data, monkeypatch):
    """val_every = 4 over 9 epochs: host-visible boundaries at epochs 0, 4, 8
    (the JAX ``_need_host_state``), so three spans of 1, 4 and 4 epochs; a
    checkpoint interval of 3 adds boundaries after epochs 3 and 6."""
    reads = []
    real = VAETrainer._read_back
    monkeypatch.setattr(VAETrainer, "_read_back",
                        staticmethod(lambda per_epoch: reads.append(len(per_epoch))
                                     or real(per_epoch)))
    trainer = VAETrainer(_cfg(), device="cpu")
    state, hist = trainer.fit(data, epochs=9, val_every=4)
    assert reads == [1, 4, 4] and len(hist["loss"]) == 9 and state.epoch == 9
    assert len(set(hist["val_loss"][1:5])) == 1 and hist["val_loss"][0] != hist["val_loss"][4]
    reads.clear()
    mgr = CheckpointManager(str(tmp_path), save_interval_epochs=3)
    VAETrainer(_cfg(), device="cpu").fit(data, epochs=9, val_every=4, ckpt_manager=mgr)
    assert reads == [1, 2, 2, 1, 3] and mgr.steps() == [3, 6, 9]


def test_validation_draws_nothing_from_the_training_streams(data):
    x = torch.from_numpy(data)
    a, b = VAETrainer(_cfg(), device="cpu", seed=3), VAETrainer(_cfg(), device="cpu", seed=3)
    sa, sb = a.init_state(0), b.init_state(0)
    a.eval_epoch(sa, x)
    sa, _ = a.train_epoch(sa, x)
    sb, _ = b.train_epoch(sb, x)
    _assert_same_state(sa, sb)
    assert vt.STEP_METRICS[-1] == "grad_norm"
