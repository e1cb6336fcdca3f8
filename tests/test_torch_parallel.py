"""The port's mesh layout and sharding rules against the JAX package's, on
its 8 virtual CPU devices (no process group is needed: the rules are
functions of the mesh's shape and a rank's coordinates).

* ``mesh_grid`` gives JAX's ``make_mesh`` shapes, device order (contiguous
  ranks share the model axis) and errors; ``make_mesh`` also refuses a grid
  that leaves ranks out, and ``initialize_distributed`` without a
  rendezvous hands the device back;
* the split dimension of every parameter, moment and ``u`` leaf, carried
  through ``convert.py``'s names and layouts, is the one JAX's
  ``param_shardings(...).spec`` names;
* each rank's block from ``sharding.shard_state`` (mesh 4 x 2) equals the
  matching JAX device's ``addressable_shards`` after ``shard_state``;
* the node axis splits only into blocks of whole readout GroupNorm groups,
  and the batch only where the data axis divides it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simulgen_vae_tpu.config import VAEConfig as JaxCfg
from simulgen_vae_tpu.parallel import make_mesh as jax_make_mesh
from simulgen_vae_tpu.parallel import param_shardings
from simulgen_vae_tpu.parallel import shard_state as jax_shard_state
from simulgen_vae_tpu.train.vae_trainer import VAETrainer as JaxTrainer
from simulgen_vae_tpu_torch import convert
from simulgen_vae_tpu_torch.config import VAEConfig
from simulgen_vae_tpu_torch.models.vae import VAE
from simulgen_vae_tpu_torch.parallel import (
    Mesh,
    initialize_distributed,
    make_mesh,
    mesh_grid,
    sharding,
)
from simulgen_vae_tpu_torch.parallel import mesh as tmesh
from simulgen_vae_tpu_torch.train.vae_trainer import VAETrainer

GEOM = dict(num_param=16, num_time=12, num_node=32, latent_dim_end=8, latent_dim=4,
            num_filter_enc=[16, 8], small=True, n_epochs=10, batch_size=8, lr=1e-3,
            alpha=100.0)


@pytest.mark.parametrize("data, model", [(None, 1), (None, 2), (None, 4), (2, 2), (1, 8),
                                         (4, 2), (1, 1), (None, 3), (3, 3), (None, 16)])
def test_mesh_grid_matches_jax_make_mesh(data, model):
    try:
        want = jax_make_mesh(data=data, model=model)
    except ValueError:
        with pytest.raises(ValueError):
            mesh_grid(8, data, model)
        return
    grid = mesh_grid(8, data, model)
    assert Mesh(grid, 0).shape == dict(want.shape)
    np.testing.assert_array_equal(grid, np.vectorize(lambda d: d.id)(want.devices))


def test_one_rank_without_a_process_group():
    mesh = make_mesh()
    assert mesh.shape == {"data": 1, "model": 1} and mesh.coords == {"data": 0, "model": 0}
    assert mesh.group("data") is None and mesh.group("model") is None
    assert mesh.everyone() is None


@pytest.mark.parametrize("data, model", [(1, 2), (3, 1)])
def test_make_mesh_refuses_a_grid_that_leaves_ranks_out(monkeypatch, data, model):
    """JAX may lay a mesh over some of its devices; with one process a
    device, a rank left out of the grid would have nothing to run."""
    monkeypatch.setattr(tmesh, "world_size", lambda: 4)
    with pytest.raises(ValueError, match="leaves ranks out of 4"):
        make_mesh(data, model)


def test_initialize_distributed_without_a_rendezvous_returns_the_device(monkeypatch):
    for name in ("WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(name, raising=False)
    assert initialize_distributed("cpu") == torch.device("cpu")
    assert not torch.distributed.is_initialized()


@pytest.fixture(scope="module")
def jax_state():
    trainer = JaxTrainer(JaxCfg(**GEOM), donate=False)
    return trainer.init_state(jax.random.PRNGKey(0))


def _split_markers(tree, specs):
    """Each leaf as an array varying only along its split dimension (its
    coordinate there), zeros where it is replicated."""
    def mark(leaf, spec):
        shape = np.shape(leaf)
        dims = [i for i, s in enumerate(tuple(spec)) if s == "model"]
        if not dims:
            return np.zeros(shape, np.float32)
        return np.indices(shape)[dims[0]].astype(np.float32) + 1.0
    return jax.tree.map(mark, tree, specs)


def _port_split_dim(a: np.ndarray):
    """The one dimension along which ``a`` varies (None: all zeros)."""
    if not a.any():
        return None
    (dim,) = [i for i in range(a.ndim)
              if not np.array_equal(a, np.broadcast_to(a.take([0], axis=i), a.shape))]
    return dim


def test_split_dims_match_jax_param_shardings(jax_state):
    mesh = jax_make_mesh(model=2)
    num_node = GEOM["num_node"]
    specs = param_shardings(jax_state, mesh, num_node)
    spec_of = jax.tree.map(lambda s: s.spec, specs)
    marked = _split_markers(jax_state, spec_of)
    model = VAE(8, 4, [8, 16], num_node, 12, num_filter_enc=[16, 8])
    dims, u_dims = sharding.node_leaves(model), sharding.sn_u_leaves(model)
    params = convert.vae_state(marked.params)
    assert set(params) == {k for k, _ in model.named_parameters()}
    for k, a in params.items():
        assert _port_split_dim(np.asarray(a)) == dims.get(k), k
    opt = convert.adamw_state(marked.opt_state)
    for part in ("mu", "nu"):
        for k, a in opt[part].items():
            assert _port_split_dim(np.asarray(a)) == dims.get(k), (part, k)
    for k, a in convert.sn_u_state(marked.sn_u).items():
        assert _port_split_dim(np.asarray(a)) == u_dims.get(k), k
    assert set(dims) == {"encoder.enc_block.0.convs.0.weight", "decoder.recon.kernel",
                         "decoder.recon.bias", "decoder.recon.scale",
                         "decoder.recon.norm_bias"}


@pytest.mark.parametrize("m", [0, 1])
def test_shard_state_blocks_match_jax_addressable_shards(jax_state, m):
    mesh = jax_make_mesh(model=2)   # 4 x 2
    num_node = GEOM["num_node"]
    placed = jax_shard_state(jax_state, mesh, num_node)
    device = mesh.devices[0, m]

    def shard(a):
        (s,) = [s for s in a.addressable_shards if s.device == device]
        return np.asarray(s.data)

    want = jax.tree.map(shard, placed)
    trainer = VAETrainer(VAEConfig(**GEOM), device="cpu")
    full = convert.train_state_from_jax(trainer, jax.tree.map(np.asarray, jax_state))
    rank = int(np.asarray(mesh_grid(8, model=2))[0, m])
    local = VAE(8, 4, [8, 16], num_node // 2, 12, num_filter_enc=[16, 8], node_parts=2)
    layout = sharding.Layout(Mesh(mesh_grid(8, model=2), rank), 2,
                             sharding.node_leaves(local), sharding.sn_u_leaves(local))
    state = sharding.shard_state(full, layout, local)
    for k, p in convert.vae_state(want.params).items():
        np.testing.assert_array_equal(dict(state.model.named_parameters())[k].detach().numpy(),
                                      p, err_msg=k)
    opt = convert.adamw_state(want.opt_state)
    for part in ("mu", "nu"):
        for k, v in opt[part].items():
            np.testing.assert_array_equal(state.opt_state[part][k].numpy(), v,
                                          err_msg=(part, k))
    for k, u in convert.sn_u_state(want.sn_u).items():
        np.testing.assert_array_equal(state.sn_u[k].numpy(), u, err_msg=k)


@pytest.mark.parametrize("num_node, model, parts", [
    (32, 2, 2), (32, 4, 4), (32, 8, 8), (95008, 2, 2), (95008, 4, 4), (95008, 8, 8),
    (95008, 3, 1),        # 8 groups do not split into 3 blocks
    (24, 4, 1),           # 6 groups of 4: 24 % 4 == 0 (JAX splits) but 6 % 4 != 0
    (30, 4, 1),           # 30 % 4 != 0: JAX replicates too
])
def test_node_axis_splits_only_into_whole_groups(num_node, model, parts, capsys):
    mesh = Mesh(mesh_grid(model, None, model), 0)
    assert sharding.node_parts(mesh, num_node, announce=True) == parts
    said = capsys.readouterr().out
    assert ("replicated over 'model'" in said) == (parts == 1)


@pytest.mark.parametrize("rows, data, parts", [(8, 2, 2), (3, 2, 1), (16, 4, 4), (6, 4, 1)])
def test_batch_splits_only_where_the_data_axis_divides_it(rows, data, parts):
    mesh = Mesh(mesh_grid(data, data, 1), 1)
    assert sharding.batch_parts(mesh, rows) == parts
    x = torch.arange(rows * 2 * 8, dtype=torch.float32).reshape(rows, 2, 8)
    got = sharding.shard_batch(x, mesh, 1)
    want = x[rows // parts: 2 * (rows // parts)] if parts > 1 else x
    assert torch.equal(got, want)
