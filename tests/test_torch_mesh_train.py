"""The port's VAE training on gloo meshes of CPU processes, against JAX and
against the port on one device.

Geometry: T = 12, 32 nodes (8 GroupNorm groups of 4 at the readout, so a
model axis of 2 splits them whole), encoder filters [16, 8], batch 8,
spectral norm on, f32. Each mesh (2 x 1, 1 x 2 and 2 x 2: two, two and four
processes, ``tests/torch_ranks.spawn_ranks``) runs :func:`mesh_worker` once,
which records on rank 0 (and, for the per-rank checks, on every rank):

* one step's loss, metrics, new ``u`` and every gradient, gathered, from the
  weights, batch and reparameterisation noise JAX's ``_loss_and_grads`` is
  given (the noise fed through a monkeypatched ``reparameterize``, each rank
  taking its rows): loss rtol 1e-5, gradients atol 1e-5 + rtol 1e-4, as the
  one-device step test;
* ``fit`` for two epochs (mixup and amplitude on, the kernel's noise off)
  against the port on one device: JAX's own mesh tolerances
  (``tests/test_parallel.py``: atol 2e-5 on a data axis, 3e-4 with a model
  axis), the same loss history within rtol 1e-4;
* the checkpoint that fit wrote, restored in one process, equals the
  gathered mesh state bit for bit and trains on; a one-device checkpoint
  restored on the mesh gives each rank its block bit for bit, and one more
  epoch from it matches one more epoch on one device;
* a NaN injected into one rank's parameters rolls every rank back at the
  same epoch, and a preemption asked for on rank 1 only stops every rank
  after the same span, with the forced checkpoint.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from tests.torch_ranks import spawn_ranks

T, NODE, Z, HIER, B, P = 12, 32, 8, 4, 8, 16
ENC = [16, 8]
GEOM = dict(num_param=P, num_time=T, num_node=NODE, latent_dim_end=Z, latent_dim=HIER,
            num_filter_enc=ENC, small=True, n_epochs=10, batch_size=B, lr=1e-3,
            alpha=100.0, dtype="float32")
BETA = 0.5
MESHES = {"2x1": (2, 1), "1x2": (1, 2), "2x2": (2, 2)}
FIT_ATOL = {"2x1": 2e-5, "1x2": 3e-4, "2x2": 3e-4}
EPOCHS = 2
NAN_AT_STEP = 5          # the first step of the third epoch (two steps an epoch)


def _cfg():
    from simulgen_vae_tpu_torch.config import VAEConfig

    return VAEConfig(**GEOM)


def _aug():
    from simulgen_vae_tpu_torch.data.augmentation import AugmentationConfig

    return AugmentationConfig(noise_prob=0.0)


def _data():
    """The fits' ensemble: seed 10 leaves every nonzero first-step gradient
    of the one-device fit well above f32 rounding
    (:func:`test_fit_data_leaves_no_gradient_at_rounding_level`)."""
    return (0.4 * np.random.default_rng(10).standard_normal((P, T, NODE))).astype(np.float32)


def _state_from(trainer, arrays):
    """A one-device state from port-named parameter and ``u`` arrays."""
    from simulgen_vae_tpu_torch.convert import load_state
    from simulgen_vae_tpu_torch.train.vae_trainer import VAETrainState

    model = load_state(trainer.build_model(full=True), arrays["params"])
    sn_u = {k: torch.from_numpy(v) for k, v in arrays["sn_u"].items()}
    return VAETrainState(model, trainer.opt.init(dict(model.named_parameters())), sn_u)


def _whole(state):
    """A state's tensors by part, as CPU tensors."""
    return {"params": {k: p.detach().clone() for k, p in state.model.named_parameters()},
            "mu": dict(state.opt_state["mu"]), "nu": dict(state.opt_state["nu"]),
            "sn_u": dict(state.sn_u), "epoch": int(state.epoch),
            "count": int(state.opt_state["count"])}


def mesh_worker(rank, world, init, data_ax, model_ax, inputs):
    """One rank of a mesh: every check of this file, in order."""
    import contextlib
    import io

    from simulgen_vae_tpu_torch.models import decoder as tdec
    from simulgen_vae_tpu_torch.models import vae as tvae
    from simulgen_vae_tpu_torch.data.augmentation import AugmentationConfig
    from simulgen_vae_tpu_torch.parallel import initialize_distributed, make_mesh, sharding
    from simulgen_vae_tpu_torch.train.vae_trainer import VAETrainer
    from simulgen_vae_tpu_torch.utils import preemption
    from simulgen_vae_tpu_torch.utils.checkpoint import CheckpointManager

    torch.set_num_threads(1)
    initialize_distributed(device="cpu", init_method=init, world_size=world, rank=rank)
    mesh = make_mesh(data_ax, model_ax)
    arrays = torch.load(inputs, weights_only=False)
    result, mine = {}, {}
    cfg = _cfg()

    # one step against JAX
    trainer = VAETrainer(cfg, aug=AugmentationConfig(enabled=False), device="cpu")
    full = _state_from(trainer, arrays)
    trainer.set_mesh(mesh)
    state = trainer.shard_state(full)
    noise = torch.from_numpy(arrays["noise"])

    def fixed(mu, std, generator=None, rows=None):
        eps = noise if rows is None else noise[rows[0]: rows[0] + mu.shape[0]]
        return mu + eps * std.clamp(1e-8, 10.0)

    real = tvae.reparameterize
    tvae.reparameterize = tdec.reparameterize = fixed
    try:
        block, rows = trainer.local_batch(torch.from_numpy(arrays["batch"]))
        metrics, new_u, grads = trainer.loss_and_grads(state, block.contiguous(), BETA,
                                                       noise_rows=rows)
    finally:
        tvae.reparameterize = tdec.reparameterize = real
    layout = state.layout
    result["step"] = {"metrics": {k: float(v) for k, v in metrics.items()},
                      "grads": sharding.gather_tree(grads, layout.params, layout),
                      "new_u": sharding.gather_tree(new_u, layout.sn_u, layout)}

    # two epochs, writing checkpoints; the one-device checkpoint back on the mesh
    data = _data()
    trainer = VAETrainer(cfg, aug=_aug(), device="cpu", seed=3)
    mgr = CheckpointManager(arrays["mesh_ckpt"], save_interval_epochs=1)
    state, hist = trainer.fit(data, seed=0, epochs=EPOCHS, val_every=1, ckpt_manager=mgr,
                              mesh=mesh)
    result["fit"] = {"state": _whole(trainer.gather_state(state)),
                     "loss": hist["loss"].tolist(), "val_loss": hist["val_loss"].tolist()}
    trainer = VAETrainer(cfg, aug=_aug(), device="cpu", seed=3)
    trainer.set_mesh(mesh)
    restored = CheckpointManager(arrays["single_ckpt"]).restore(trainer.init_state(0))
    whole = torch.load(Path(arrays["single_ckpt"]) / f"ckpt_{EPOCHS:08d}.pt", weights_only=False)
    lay = restored.layout
    same = all(torch.equal(p, sharding.block(whole["params"][k], lay.params.get(k),
                                             lay.index, lay.parts))
               for k, p in restored.model.named_parameters())
    same &= all(torch.equal(v, sharding.block(whole[part][k], lay.params.get(k),
                                              lay.index, lay.parts))
                for part in ("mu", "nu") for k, v in restored.opt_state[part].items())
    same &= all(torch.equal(u, sharding.block(whole["sn_u"][k], lay.sn_u.get(k),
                                              lay.index, lay.parts))
                for k, u in restored.sn_u.items())
    mine["restored_blocks_equal"] = bool(same) and restored.epoch == EPOCHS
    state, _ = trainer.fit(data, seed=0, epochs=1, val_every=1, state=restored)
    result["resumed"] = _whole(trainer.gather_state(state))

    # a NaN in one rank's parameters, in the third epoch's first step
    trainer = VAETrainer(cfg, aug=_aug(), device="cpu", seed=3)
    real_apply, steps = trainer._apply, []

    def apply(state, *a, **k):
        steps.append(1)
        if rank == world - 1 and len(steps) == NAN_AT_STEP:
            with torch.no_grad():
                next(state.model.parameters()).fill_(float("nan"))
        return real_apply(state, *a, **k)

    trainer._apply = apply
    mgr = CheckpointManager(arrays["nan_ckpt"], save_interval_epochs=1)
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        state, hist = trainer.fit(data, seed=0, epochs=4, val_every=1, ckpt_manager=mgr,
                                  mesh=mesh)
    mine["nan"] = {"log": [line for line in text.getvalue().splitlines() if "nan_guard" in line],
                   "epoch": int(state.epoch), "loss": hist["loss"].tolist(),
                   "finite": all(bool(p.isfinite().all()) for p in state.model.parameters())}

    # a preemption asked for on rank 1 alone
    trainer = VAETrainer(cfg, aug=_aug(), device="cpu", seed=4)
    mgr = CheckpointManager(arrays["preempt_ckpt"], save_interval_epochs=50)
    state, hist = trainer.fit(
        data, seed=0, epochs=6, val_every=2, ckpt_manager=mgr, mesh=mesh,
        log_fn=lambda e, m: preemption.request() if rank == 1 and e == 1 else None)
    mine["preempt"] = {"epoch": int(state.epoch), "epochs_run": len(hist["loss"]),
                       "requested": preemption.requested(), "latest": mgr.latest_step()}

    return dict(result, mine=mine) if rank == 0 else {"mine": mine}


@pytest.fixture(scope="module")
def jax_step():
    """JAX's one-device step from random weights, ``u``, batch and noise."""
    import jax
    import jax.numpy as jnp

    from simulgen_vae_tpu.config import VAEConfig as JaxCfg
    from simulgen_vae_tpu.data.augmentation import AugmentationConfig as JaxAug
    from simulgen_vae_tpu.models import decoder as jdec
    from simulgen_vae_tpu.models import vae as jvae
    from simulgen_vae_tpu.models.spectral_norm import init_sn_state
    from simulgen_vae_tpu.train.vae_trainer import VAETrainer as JaxTrainer
    from simulgen_vae_tpu_torch import convert

    rng = np.random.default_rng(0)
    params = convert.random_vae_tree(_cfg(), rng)
    batch = (0.5 * rng.standard_normal((B, T, NODE))).astype(np.float32)
    noise = rng.standard_normal((B, Z)).astype(np.float32)
    trainer = JaxTrainer(JaxCfg(**GEOM), aug=JaxAug(enabled=False), donate=False)
    sn_u = init_sn_state(jax.tree_util.tree_map(jnp.asarray, params), jax.random.PRNGKey(1))

    def fixed(key, mu, std):
        return mu + jnp.asarray(noise) * jnp.clip(std, 1e-8, 10.0)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jvae, "reparameterize", fixed)
        mp.setattr(jdec, "reparameterize", fixed)
        metrics, new_u, grads = jax.jit(trainer._loss_and_grads)(
            jax.tree_util.tree_map(jnp.asarray, params), sn_u, jnp.asarray(batch),
            jax.random.PRNGKey(2), BETA)
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    return dict(params=convert.vae_state(params), sn_u=convert.sn_u_state(to_np(sn_u)),
                batch=batch, noise=noise,
                metrics={k: float(v) for k, v in metrics.items()},
                grads=convert.vae_state(to_np(grads)),
                new_u=convert.sn_u_state(to_np(new_u)))


@pytest.fixture(scope="module")
def single(tmp_path_factory):
    """The port on one device: two epochs with checkpoints, then one more
    epoch from the checkpoint of the second."""
    from simulgen_vae_tpu_torch.train.vae_trainer import VAETrainer
    from simulgen_vae_tpu_torch.utils.checkpoint import CheckpointManager

    torch.manual_seed(0)
    ckpt = tmp_path_factory.mktemp("single_ckpt")
    trainer = VAETrainer(_cfg(), aug=_aug(), device="cpu", seed=3)
    first, apply = {}, trainer.opt.apply

    def keep_first(grads, *args, **kwargs):
        if not first:
            first.update({k: g.detach().clone() for k, g in grads.items()})
        return apply(grads, *args, **kwargs)

    trainer.opt.apply = keep_first
    state, hist = trainer.fit(_data(), seed=0, epochs=EPOCHS, val_every=1,
                              ckpt_manager=CheckpointManager(str(ckpt), save_interval_epochs=1))
    fit = {"state": _whole(state), "loss": hist["loss"].tolist(),
           "val_loss": hist["val_loss"].tolist(), "first_grads": first}
    trainer = VAETrainer(_cfg(), aug=_aug(), device="cpu", seed=3)
    restored = CheckpointManager(str(ckpt)).restore(trainer.init_state(0))
    state, _ = trainer.fit(_data(), seed=0, epochs=1, val_every=1, state=restored)
    return {"ckpt": str(ckpt), "fit": fit, "resumed": _whole(state)}


_RUNS = {}


@pytest.fixture
def run(request, jax_step, single, tmp_path_factory):
    """The workers' results on the mesh ``request.param`` (run once a mesh)."""
    name = request.param
    if name not in _RUNS:
        root = tmp_path_factory.mktemp(f"mesh{name}")
        inputs = dict(jax_step, single_ckpt=single["ckpt"])
        for part in ("mesh_ckpt", "nan_ckpt", "preempt_ckpt"):
            inputs[part] = str(root / part)
        torch.save(inputs, root / "inputs.pt")
        d, m = MESHES[name]
        outputs = spawn_ranks(mesh_worker, d * m, timeout=240, data_ax=d, model_ax=m,
                              inputs=str(root / "inputs.pt"))
        _RUNS[name] = dict(outputs[0], ranks=[o["mine"] for o in outputs], root=root)
    return _RUNS[name]


ALL = pytest.mark.parametrize("run", sorted(MESHES), indirect=True)


@ALL
def test_step_loss_and_metrics_match_jax(run, jax_step):
    for k in ("loss", "recon", "kl", "recon_mse"):
        np.testing.assert_allclose(run["step"]["metrics"][k], jax_step["metrics"][k],
                                   rtol=1e-5, err_msg=k)


@ALL
def test_step_gradients_match_jax(run, jax_step):
    grads = run["step"]["grads"]
    assert set(grads) == set(jax_step["grads"])
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), jax_step["grads"][k], atol=1e-5, rtol=1e-4,
                                   err_msg=k)


@ALL
def test_step_power_iteration_matches_jax(run, jax_step):
    new_u = run["step"]["new_u"]
    assert set(new_u) == set(jax_step["new_u"])
    for k, u in new_u.items():
        np.testing.assert_allclose(u.numpy(), jax_step["new_u"][k], atol=1e-6, err_msg=k)


def test_fit_data_leaves_no_gradient_at_rounding_level(single):
    """The fits are compared element by element, and AdamW's first step
    moves an element by about lr * sign(g): a gradient within f32 rounding
    of zero (~1e-7 here) takes either sign on a mesh and on one device, and
    the element then differs by up to 2 * lr whatever the mesh does right.
    So every nonzero gradient of the one-device fit's first step is at least
    1e-6 (with the ensemble of seed 5 one was 1.6e-7)."""
    g = torch.cat([v.flatten() for v in single["fit"]["first_grads"].values()]).abs()
    assert float(g[g > 0].min()) >= 1e-6


@ALL
def test_two_epochs_match_one_device(run, single, request):
    name = request.node.callspec.params["run"]
    got, want = run["fit"]["state"], single["fit"]["state"]
    assert got["epoch"] == want["epoch"] == EPOCHS and got["count"] == want["count"]
    for k, p in got["params"].items():
        np.testing.assert_allclose(p.numpy(), want["params"][k].numpy(),
                                   atol=FIT_ATOL[name], err_msg=k)
    np.testing.assert_allclose(run["fit"]["loss"], single["fit"]["loss"], rtol=1e-4)
    np.testing.assert_allclose(run["fit"]["val_loss"], single["fit"]["val_loss"], rtol=1e-4)


@ALL
def test_mesh_checkpoint_restores_in_one_process(run):
    from simulgen_vae_tpu_torch.train.vae_trainer import VAETrainer
    from simulgen_vae_tpu_torch.utils.checkpoint import CheckpointManager

    trainer = VAETrainer(_cfg(), aug=_aug(), device="cpu", seed=3)
    mgr = CheckpointManager(str(run["root"] / "mesh_ckpt"))
    assert mgr.latest_step() == EPOCHS
    restored = _whole(mgr.restore(trainer.init_state(0)))
    want = run["fit"]["state"]
    assert restored["epoch"] == want["epoch"] and restored["count"] == want["count"]
    for part in ("params", "mu", "nu", "sn_u"):
        assert set(restored[part]) == set(want[part])
        for k, v in restored[part].items():
            assert torch.equal(v, want[part][k]), (part, k)
    state, hist = trainer.fit(_data(), seed=0, epochs=1, val_every=1,
                              state=mgr.restore(trainer.init_state(0)))
    assert state.epoch == EPOCHS + 1 and np.isfinite(hist["loss"]).all()


@ALL
def test_one_device_checkpoint_resumes_on_the_mesh(run, single, request):
    name = request.node.callspec.params["run"]
    assert all(r["restored_blocks_equal"] for r in run["ranks"])
    got, want = run["resumed"], single["resumed"]
    assert got["epoch"] == want["epoch"] == EPOCHS + 1
    for k, p in got["params"].items():
        np.testing.assert_allclose(p.numpy(), want["params"][k].numpy(),
                                   atol=FIT_ATOL[name], err_msg=k)


@ALL
def test_nan_in_one_rank_rolls_every_rank_back(run):
    nans = [r["nan"] for r in run["ranks"]]
    want = ("[nan_guard:vae] non-finite train loss at epoch 2; rolled back to "
            "checkpointed epoch 2 (retry 1/2)")
    for r in nans:
        assert r["log"] == [want]
        assert r["epoch"] == 4 and len(r["loss"]) == 4 and r["finite"]
        assert np.isfinite(r["loss"]).all()
    assert all(r["loss"] == nans[0]["loss"] for r in nans)


@ALL
def test_preemption_on_one_rank_stops_every_rank(run):
    for r in run["ranks"]:
        # spans [0], [1, 2], ...: rank 1 asks at epoch 1, inside the second span
        assert r["preempt"] == {"epoch": 3, "epochs_run": 3, "requested": True, "latest": 3}
