"""Serving on a mesh: ``make_generate_fn(..., mesh=...)`` on a 2 x 2 gloo mesh
of CPU processes against JAX's one-device ``make_generate_fn``.

The four cases of the JAX package's ``tests/test_generate_mesh.py`` at its
geometry (64 nodes in 8 GroupNorm groups, T = 10, decoder filters [8, 16],
MLP conditioner [8, 8] on 4 inputs, scalers with min 0 and scale 0.5), with
weights from ``convert.random_*_tree``:

* float: against JAX to atol 1e-4 + rtol 1e-4 (as ``tests/
  test_torch_generate.py``) and against the port on one device to JAX's mesh
  tolerance (rtol 2e-5, atol 2e-6);
* int8: within rel-L2 0.05 of JAX's float decode (JAX's bound), and equal to
  the port's one-device int8 decode to rtol 2e-5, atol 2e-6 (the readout's
  per-channel scales are split with its kernel);
* a batch of 3, which the data axis does not divide, runs replicated;
* 10 requests at ``max_batch=4`` (4 + 4 + 2 padded) equal the whole batch.

Every rank returns the whole field, and all four ranks return the same bits.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tests.torch_ranks import spawn_ranks

NODE, T, Z, HIER, N_IN = 64, 10, 8, 4, 4
ENC, LC_FILTERS = [16, 8], [8, 8]
CASES = {"float": dict(rows=4), "int8": dict(rows=4, quantize="int8"),
         "odd": dict(rows=3), "chunked": dict(rows=10, max_batch=4),
         "whole10": dict(rows=10)}


def _configs():
    from simulgen_vae_tpu_torch.config import LCConfig, VAEConfig

    return (VAEConfig(num_time=T, num_node=NODE, latent_dim_end=Z, latent_dim=HIER,
                      num_filter_enc=ENC),
            LCConfig(filters=LC_FILTERS, input_type="csv"))


def _scalers():
    from simulgen_vae_tpu_torch.data.scaler import MinMaxScaler

    cfg, _ = _configs()
    return {name: MinMaxScaler(np.full(n, 0.5, np.float32), np.zeros(n, np.float32))
            for name, n in (("lv_scaler", Z), ("xs_scaler", cfg.num_hier * HIER),
                            ("data_scaler", NODE))}


def _inputs(rows):
    return np.random.default_rng(0).standard_normal((rows, N_IN)).astype(np.float32)


def _port_pipeline(trees):
    from simulgen_vae_tpu_torch import generate as tgen

    cfg, lc_cfg = _configs()
    return tgen.make_pipeline(cfg, lc_cfg, trees["vae"], trees["lc"], device="cpu",
                              dtype=torch.float32, **_scalers())


def _decode(pipe, case, mesh=None):
    from simulgen_vae_tpu_torch import generate as tgen

    spec = CASES[case]
    fn = tgen.make_generate_fn(pipe, max_batch=spec.get("max_batch"),
                               quantize=spec.get("quantize"), mesh=mesh)
    return fn(_inputs(spec["rows"]))


def generate_worker(rank, world, init, trees):
    from simulgen_vae_tpu_torch.parallel import initialize_distributed, make_mesh

    torch.set_num_threads(1)
    initialize_distributed(device="cpu", init_method=init, world_size=world, rank=rank)
    mesh = make_mesh(2, 2)
    pipe = _port_pipeline(torch.load(trees, weights_only=False))
    return {case: _decode(pipe, case, mesh) for case in CASES}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    import jax

    from simulgen_vae_tpu import generate as jgen
    from simulgen_vae_tpu.models import LatentConditioner as JaxLC
    from simulgen_vae_tpu.models.vae import VAE as JaxVAE
    from simulgen_vae_tpu_torch import convert

    cfg, lc_cfg = _configs()
    rng = np.random.default_rng(1)
    trees = {"vae": {"decoder": convert.random_decoder_tree(cfg, rng)},
             "lc": convert.random_conditioner_tree(lc_cfg, cfg, N_IN, rng)}
    for name, sub in trees["vae"]["decoder"].items():  # log_var < 2 ln 100: fix-mode noise 1e-8
        if name.startswith("condition_"):
            sub["Conv1d_0"]["Conv_0"]["kernel"] *= 0.1
    root = tmp_path_factory.mktemp("mesh_generate")
    torch.save(trees, root / "trees.pt")
    ranks = spawn_ranks(generate_worker, 4, timeout=180, trees=str(root / "trees.pt"))

    vae = JaxVAE(latent_dim=Z, hierarchical_dim=HIER, num_filter_enc=ENC,
                 num_filter_dec=ENC[::-1], num_node=NODE, num_time=T, small=True)
    lc = JaxLC(LC_FILTERS, Z, N_IN, HIER, cfg.num_hier, dropout_rate=0.0)
    jax_pipe = dict(cfg=SimpleNamespace(num_node=NODE), vae_model=vae,
                    vae_vars={"params": trees["vae"]}, lc_model=lc,
                    lc_vars={"params": trees["lc"]},
                    **{k: SimpleNamespace(scale_=s.scale_, min_=s.min_)
                       for k, s in _scalers().items()})
    jax_fn = jgen.make_generate_fn(jax_pipe)
    want = {case: np.asarray(jax_fn(jax.numpy.asarray(_inputs(spec["rows"]))))
            for case, spec in CASES.items() if "quantize" not in spec}
    pipe = _port_pipeline(trees)
    single = {case: _decode(pipe, case) for case in CASES}
    return SimpleNamespace(ranks=ranks, jax=want, single=single)


def test_every_rank_returns_the_whole_field(results):
    for case, spec in CASES.items():
        got = results.ranks[0][case]
        assert tuple(got.shape) == (spec["rows"], T, NODE), case
        for other in results.ranks[1:]:
            assert torch.equal(other[case], got), case


def test_sharded_generate_matches_single_device(results):
    got = results.ranks[0]["float"].numpy()
    np.testing.assert_allclose(got, results.jax["float"], atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got, results.single["float"].numpy(), rtol=2e-5, atol=2e-6)


def test_sharded_generate_int8(results):
    got = results.ranks[0]["int8"].numpy()
    ref = results.jax["float"]
    assert np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-9) < 0.05
    np.testing.assert_allclose(got, results.single["int8"].numpy(), rtol=2e-5, atol=2e-6)


def test_sharded_generate_odd_batch_falls_back(results):
    got = results.ranks[0]["odd"].numpy()
    assert got.shape[0] == 3
    np.testing.assert_allclose(got, results.jax["odd"], atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got, results.single["odd"].numpy(), rtol=2e-5, atol=2e-6)


def test_sharded_generate_chunks_oversized_requests(results):
    parts, whole = results.ranks[0]["chunked"], results.ranks[0]["whole10"]
    assert tuple(parts.shape) == tuple(whole.shape) == (10, T, NODE)
    np.testing.assert_allclose(parts.numpy(), whole.numpy(), rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(parts.numpy(), results.jax["chunked"], atol=1e-4, rtol=1e-4)
