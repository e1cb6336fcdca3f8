"""The port's ``LCTrainer`` and the conditioner's dropout against the JAX
package, on the same numpy inputs and JAX-initialized weights:

* the loss and every gradient against ``jax.value_and_grad(LCTrainer._loss_fn)``
  with dropout off (rate 0), standard and enhanced modes: rtol 1e-5 (a
  gradient element to 1e-5 of itself or of its tensor's largest element);
* three optimizer steps with the clip active against the optax chain
  (``clip_by_global_norm(10)`` then ``adamw``) at the warm-up learning rates:
  rel-L2 1e-6 on every parameter;
* dropout keeps ``1 - rate`` of 10^5 units within 0.01, scaled by 1 / keep;
* ``fit``: the same bits twice from one seed; a checkpointed and resumed run
  equal to the uninterrupted one; a requested preemption stops after one
  epoch with a save; a non-finite loss rolls back; the overfit stop.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from simulgen_vae_tpu.models import LatentConditioner as JaxLC
from simulgen_vae_tpu.train import schedules as jsched
from simulgen_vae_tpu.train.lc_trainer import LCTrainer as JaxLCTrainer
from simulgen_vae_tpu_torch import convert
from simulgen_vae_tpu_torch.config import LCConfig, VAEConfig
from simulgen_vae_tpu_torch.models.conditioner_mlp import LatentConditioner, dropout
from simulgen_vae_tpu_torch.train import schedules as tsched
from simulgen_vae_tpu_torch.train.lc_trainer import LCTrainer, LCTrainState
from simulgen_vae_tpu_torch.utils import preemption
from simulgen_vae_tpu_torch.utils.checkpoint import CheckpointManager

FILTERS, N_IN, Z, HIER, SIZE2, N = [8, 16, 16], 12, 8, 4, 3, 12
CFG = VAEConfig(latent_dim_end=Z, latent_dim=HIER, num_filter_enc=[4] * (SIZE2 + 1))
LC_CFG = LCConfig(filters=FILTERS, dropout_rate=0.0, input_type="csv")


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((N, N_IN)).astype(np.float32)
    y1 = rng.uniform(-0.7, 0.7, (N, Z)).astype(np.float32)
    y2 = rng.uniform(-0.7, 0.7, (N, SIZE2, HIER)).astype(np.float32)
    return x, y1, y2


@pytest.fixture(scope="module")
def jax_params():
    lc = JaxLC(FILTERS, Z, N_IN, HIER, SIZE2, dropout_rate=0.0)
    params = jax.jit(lambda k: lc.init({"params": k, "dropout": k}, jnp.zeros((2, N_IN)),
                                       deterministic=True))(jax.random.PRNGKey(1))["params"]
    rng = np.random.default_rng(2)   # move biases and norms off their inits
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)).astype(np.float32),
        params)


def _port_model(dropout_rate=0.0):
    return LatentConditioner(FILTERS, Z, N_IN, HIER, SIZE2, "cpu", dropout_rate)


def _trainer(epochs=6, seed=0, **kw):
    kw.setdefault("weight_decay", 1e-4)
    return LCTrainer(_port_model(kw.pop("dropout_rate", 0.1)), epochs=epochs, lr=1e-3,
                     batch_size=4, device="cpu", seed=seed, **kw)


def _state_from(trainer, tree) -> LCTrainState:
    model = convert.conditioner_from_jax(tree, LC_CFG, CFG, "cpu").train()
    return LCTrainState(model, trainer.opt.init(dict(model.named_parameters())), {})


def _rel_l2(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("mode", ["standard", "enhanced"])
def test_loss_and_gradients_match_jax(jax_params, data, mode):
    x, y1, y2 = data
    jt = JaxLCTrainer(JaxLC(FILTERS, Z, N_IN, HIER, SIZE2, dropout_rate=0.0), epochs=6,
                      lr=1e-3, batch_size=4, is_image_data=False, loss_mode=mode)
    grad_fn = jax.jit(jax.value_and_grad(jt._loss_fn, has_aux=True))
    (loss, (_, _, metrics)), grads = grad_fn(jax_params, {}, {}, x, y1, y2,
                                             jax.random.PRNGKey(0))

    trainer = _trainer(loss_mode=mode, dropout_rate=0.0)
    state = _state_from(trainer, jax_params)
    got, got_metrics = trainer.loss_fn(state.model, *map(torch.from_numpy, data),
                                       trainer.generator)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(loss), rtol=1e-5)
    for k in ("loss_y1", "loss_y2"):
        np.testing.assert_allclose(float(got_metrics[k]), float(metrics[k]), rtol=1e-5)
    want = convert.conditioner_state(jax.tree_util.tree_map(np.asarray, grads))
    params = dict(state.model.named_parameters())
    assert set(want) == set(params)
    for k, g in want.items():
        # rtol 1e-5 of each element, or of the tensor's largest where the
        # batch sum cancels to a small rest
        np.testing.assert_allclose(params[k].grad.numpy(), g, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(g).max()), err_msg=k)


def test_three_clipped_steps_match_the_optax_chain(jax_params):
    jt = JaxLCTrainer(JaxLC(FILTERS, Z, N_IN, HIER, SIZE2), epochs=6, lr=1e-3,
                      batch_size=4, weight_decay=1e-4, is_image_data=False)
    trainer = _trainer(weight_decay=1e-4)
    state = _state_from(trainer, jax_params)
    rng = np.random.default_rng(3)
    params, opt_state = jax_params, jt.tx.init(jax_params)

    @jax.jit
    def update(grads, opt_state, params):
        updates, opt_state = jt.tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    for epoch in range(3):
        # gradients of global norm ~50: the clip at 10 is active
        grads = jax.tree_util.tree_map(
            lambda a: (3.0 * rng.standard_normal(a.shape)).astype(np.float32), params)
        lr = jsched.lc_warmup_cosine(epoch, 1e-3, 6, jt.warmup_epochs)
        opt_state[1].hyperparams["learning_rate"] = lr
        params, opt_state = update(grads, opt_state, params)
        norm = trainer.apply_grads(
            state, {k: torch.from_numpy(v) for k, v in convert.conditioner_state(grads).items()},
            tsched.lc_warmup_cosine(epoch, 1e-3, 6, trainer.warmup_epochs))
        assert float(norm) > 10.0
        np.testing.assert_allclose(float(norm), float(optax.global_norm(grads)), rtol=1e-5)
    want = convert.conditioner_state(jax.tree_util.tree_map(np.asarray, params))
    got = {k: p.detach().numpy() for k, p in state.model.named_parameters()}
    for k, w in want.items():
        assert _rel_l2(got[k], w) <= 1e-6, k
    assert state.opt_state["count"] == 3


@pytest.mark.parametrize("rate", [0.1, 0.3, 0.5])
def test_dropout_keeps_one_minus_rate(rate):
    gen = torch.Generator().manual_seed(0)
    out = dropout(torch.ones(100_000), rate, gen)
    kept = out != 0
    assert abs(float(kept.float().mean()) - (1.0 - rate)) <= 0.01
    torch.testing.assert_close(out[kept], torch.full_like(out[kept], 1.0 / (1.0 - rate)))


def test_dropout_is_off_without_a_generator_and_at_rate_zero(data):
    x = torch.from_numpy(data[0])
    model = _port_model(0.3)
    with torch.no_grad():
        a = model(x)
        b = model(x, None)
        c = _port_model(0.0)
        c.load_state_dict(model.state_dict())
        d = c(x, torch.Generator().manual_seed(1))
        e = model(x, torch.Generator().manual_seed(1))
    for u, v in zip(a, b):
        torch.testing.assert_close(u, v, rtol=0, atol=0)
    for u, v in zip(a, d):
        torch.testing.assert_close(u, v, rtol=0, atol=0)
    assert not torch.equal(a[0], e[0])   # training mode draws masks


def _params(state):
    return {k: p.detach().clone() for k, p in state.model.named_parameters()}


def _assert_same_bits(a, b):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_fit_gives_the_same_bits_twice(data):
    runs = [_trainer(seed=4).fit(*data, seed=4) for _ in range(2)]
    _assert_same_bits(_params(runs[0][0]), _params(runs[1][0]))
    for k, v in runs[0][1].items():
        if k != "epoch_time":  # the host's clock
            np.testing.assert_array_equal(v, runs[1][1][k], err_msg=k)
    assert runs[0][0].epoch == 6 and len(runs[0][1]["loss"]) == 6
    assert np.isfinite(runs[0][1]["loss"]).all()


def test_resumed_fit_equals_the_uninterrupted_one(data, tmp_path):
    whole, _ = _trainer().fit(*data)
    manager = CheckpointManager(str(tmp_path), save_interval_epochs=100)
    _trainer().fit(*data, epochs=3, ckpt_manager=manager)
    assert manager.latest_step() == 3
    later = _trainer()
    state = manager.restore(later.init_state(0))
    resumed, history = later.fit(*data, state=state, epochs=3)
    assert resumed.epoch == 6 and len(history["loss"]) == 3
    _assert_same_bits(_params(resumed), _params(whole))


def test_preemption_stops_after_the_epoch_with_a_save(data, tmp_path):
    manager = CheckpointManager(str(tmp_path), save_interval_epochs=100)
    preemption.request()
    try:
        state, history = _trainer().fit(*data, ckpt_manager=manager)
    finally:
        preemption.clear()
    assert state.epoch == 1 and len(history["loss"]) == 1
    assert manager.latest_step() == 1


def test_non_finite_loss_rolls_back_or_raises(data, tmp_path, capsys):
    trainer = _trainer()
    real, calls = trainer.loss_fn, []

    def poisoned(model, x, y1, y2, generator=None):
        loss, metrics = real(model, x, y1, y2, generator)
        if generator is not None:
            calls.append(1)
            if len(calls) == 5:   # the first step of the third epoch (2 a epoch), once
                loss = loss * float("nan")
                metrics["loss"] = loss.detach()
        return loss, metrics

    trainer.loss_fn = poisoned
    manager = CheckpointManager(str(tmp_path), save_interval_epochs=1)
    state, history = trainer.fit(*data, ckpt_manager=manager)
    assert "[nan_guard:lc] non-finite train loss at epoch 2; rolled back to " \
           "checkpointed epoch 2" in capsys.readouterr().out
    assert state.epoch == 6 and np.isfinite(history["loss"]).all()

    trainer = _trainer()
    trainer.loss_fn = lambda *a: (lambda lm: (lm[0] * float("nan"),
                                              {**lm[1], "loss": lm[1]["loss"] * float("nan")}))(
        real(*a))
    with pytest.raises(RuntimeError, match="no checkpoint to roll back to"):
        trainer.fit(*data)


def test_overfit_guard_stops(data, capsys):
    state, history = _trainer().fit(*data, overfit_threshold=0.0)
    assert "Severe overfitting detected!" in capsys.readouterr().out
    assert state.epoch == 1 and history == {}


def test_predict_fn_is_the_deterministic_forward(data):
    trainer = _trainer()
    state, _ = trainer.fit(*data, epochs=2)
    y1, y2 = trainer.predict_fn(state)(data[0])
    with torch.no_grad():
        w1, w2 = state.model(torch.from_numpy(data[0]))
    assert y2.shape == (N, SIZE2, HIER)
    torch.testing.assert_close(y1, w1, rtol=0, atol=0)
    torch.testing.assert_close(y2, w2, rtol=0, atol=0)


def test_init_state_is_he_uniform_with_zero_biases():
    state = _trainer().init_state(7)
    w = state.model.stem.weight.detach()
    assert float(w.abs().max()) <= (6.0 / N_IN) ** 0.5
    assert float(w.std()) > 0.3 * (6.0 / N_IN) ** 0.5
    assert not state.model.stem.bias.any()
    assert torch.equal(state.model.input_norm.weight, torch.ones(N_IN))
    _assert_same_bits(_params(state), _params(_trainer().init_state(7)))


def test_refuses_an_unknown_loss_mode():
    with pytest.raises(ValueError, match="loss_mode"):
        _trainer(loss_mode="perceptual")


def test_conditioner_tree_is_the_jax_tree_back(jax_params):
    model = convert.conditioner_from_jax(jax_params, LC_CFG, CFG, "cpu")
    back = convert.conditioner_tree(model, LC_CFG, CFG, N_IN)
    flat_want = jax.tree_util.tree_flatten_with_path(jax_params)[0]
    flat_got = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (path, g), (_, w) in zip(flat_got, flat_want):
        np.testing.assert_array_equal(g, w, err_msg=str(path))
