"""The port's evaluation against the JAX package's, on JAX-initialized
weights (T = 8, 48 nodes, encoder filters [16, 8, 4]) and the same numpy
inputs:

* ``evaluate_vae_reconstruction`` at P = 5 in batches of 2 (the last one
  padded), ``recon_iter = 1``, with ``reparameterize`` monkeypatched to
  return ``mu`` on both sides: every output within atol 1e-5;
* in the port alone at ``recon_iter = 3``: the kept MSE is at most each
  attempt's, and the kept latent is one of the attempts';
* ``ReconstructionEvaluator.reconstruct_from_latents`` and the comparison's
  per-sample MSEs: atol 1e-5;
* without matplotlib (blocked through ``sys.modules``) each PNG set is
  skipped with one line; with it the PNGs are written.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simulgen_vae_tpu.data import scaler as jscaler
from simulgen_vae_tpu.evaluation import ReconstructionEvaluator as JaxEvaluator
from simulgen_vae_tpu.evaluation import reconstruction as jrec
from simulgen_vae_tpu.models import LatentConditioner as JaxLC
from simulgen_vae_tpu.models.vae import VAE as JaxVAE
from simulgen_vae_tpu_torch import convert
from simulgen_vae_tpu_torch.config import LCConfig, VAEConfig
from simulgen_vae_tpu_torch.data import scaler as tscaler
from simulgen_vae_tpu_torch.evaluation import ReconstructionEvaluator
from simulgen_vae_tpu_torch.evaluation import plotter
from simulgen_vae_tpu_torch.evaluation import reconstruction as trec
from simulgen_vae_tpu_torch.models import decoder as tdecoder
from simulgen_vae_tpu_torch.train.vae_trainer import VAETrainer

T, NODE, Z, HIER, P = 8, 48, 8, 4, 5
ENC = [16, 8, 4]
CFG = VAEConfig(num_time=T, num_node=NODE, latent_dim_end=Z, latent_dim=HIER,
                num_filter_enc=ENC, small=True)


@pytest.fixture(scope="module")
def jax_params():
    vae = JaxVAE(latent_dim=Z, hierarchical_dim=HIER, num_filter_enc=ENC,
                 num_filter_dec=ENC[::-1], num_node=NODE, num_time=T, small=True)
    params = jax.jit(lambda k: vae.init({"params": k, "sample": k},
                                        jnp.zeros((1, T, NODE))))(jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, params["params"])


def _jax_vae():
    """A new module object each time: JAX caches its jitted chunk by id."""
    return JaxVAE(latent_dim=Z, hierarchical_dim=HIER, num_filter_enc=ENC,
                  num_filter_dec=ENC[::-1], num_node=NODE, num_time=T, small=True)


@pytest.fixture(scope="module")
def port_vae(jax_params):
    return convert.load_state(VAETrainer(CFG, device="cpu").build_model(),
                              convert.vae_state(jax_params)).eval()


@pytest.fixture(scope="module")
def data():
    return np.random.default_rng(1).uniform(-0.7, 0.7, (P, T, NODE)).astype(np.float32)


def test_reconstruction_matches_jax(jax_params, port_vae, data, monkeypatch):
    monkeypatch.setattr(jrec, "reparameterize", lambda key, mu, std: mu)
    monkeypatch.setattr(trec, "reparameterize", lambda mu, std, generator=None: mu)
    want = jrec.evaluate_vae_reconstruction(_jax_vae(), jax_params, data,
                                            jax.random.PRNGKey(0), recon_iter=1,
                                            batch_size=2, verbose=False)
    got = trec.evaluate_vae_reconstruction(port_vae, data, 0, recon_iter=1, batch_size=2,
                                           verbose=False)
    assert got[0].shape == (P, Z) and got[1].shape == (P, len(ENC) - 1, HIER)
    assert got[3].shape == (P, T, NODE)
    for g, w in zip(got[:4], want[:4]):
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-5)
    assert got[4] == pytest.approx(want[4], abs=1e-5)


def test_best_of_attempts_keeps_the_least_mse(port_vae, data, monkeypatch):
    """recon_iter = 3 in the port: the decode made deterministic, the drawn z
    recorded; each attempt's MSE recomputed from its z."""
    real, drawn = trec.reparameterize, []
    monkeypatch.setattr(tdecoder, "reparameterize",
                        lambda mu, std, generator=None, rows=None: mu)

    def record(mu, std, generator=None):
        drawn.append(real(mu, std, generator))
        return drawn[-1]

    monkeypatch.setattr(trec, "reparameterize", record)
    z, _, mse, _, _ = trec.evaluate_vae_reconstruction(port_vae, data, 3, recon_iter=3,
                                                       batch_size=2, verbose=False)
    assert len(drawn) == 3 * 3   # three chunks, three attempts each
    with torch.no_grad():
        for c, start in enumerate(range(0, P, 2)):
            chunk = torch.from_numpy(data[start: start + 2])
            if chunk.shape[0] < 2:
                chunk = torch.cat([chunk, chunk[-1:]])
            _, _, xs = port_vae.encode(chunk)
            rows = slice(start, start + 2)
            got = len(mse[rows])
            attempts = []
            for a in range(3):
                zc = drawn[3 * c + a]
                x_hat, _, _ = port_vae.decode(zc, xs, mode="fix")
                attempts.append(((x_hat - chunk) ** 2).mean(dim=(1, 2))[:got].numpy())
                assert (mse[rows] <= attempts[-1]).all()
            best = np.argmin(np.stack(attempts), axis=0)
            for j, a in enumerate(best):
                np.testing.assert_array_equal(z[start + j], drawn[3 * c + a][j].numpy())


@pytest.fixture(scope="module")
def scalers():
    rng = np.random.default_rng(2)
    lv = rng.standard_normal((P, Z)).astype(np.float32)
    xs = rng.standard_normal((P, len(ENC) - 1, HIER)).astype(np.float32)
    j = (jscaler.latent_conditioner_scaler(lv)[1], jscaler.latent_conditioner_scaler(xs)[1])
    t = (tscaler.latent_conditioner_scaler(lv)[1], tscaler.latent_conditioner_scaler(xs)[1])
    return j, t


def _latents(seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-0.7, 0.7, (P, Z)).astype(np.float32),
            rng.uniform(-0.7, 0.7, (P, len(ENC) - 1, HIER)).astype(np.float32))


def test_reconstruct_from_latents_matches_jax(jax_params, port_vae, scalers):
    y1, y2 = _latents(3)
    want = JaxEvaluator(_jax_vae(), jax_params, T).reconstruct_from_latents(y1, y2, *scalers[0])
    got = ReconstructionEvaluator(port_vae, batch_size=2).reconstruct_from_latents(
        y1, y2, *scalers[1])
    assert got.shape == (P, T, NODE) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)


def test_comparison_matches_jax_and_skips_pngs_without_matplotlib(
        jax_params, port_vae, scalers, data, tmp_path, monkeypatch, capsys):
    n_in, filters = 6, [8, 16]
    inputs = np.random.default_rng(4).uniform(-0.7, 0.7, (P, n_in)).astype(np.float32)
    jlc = JaxLC(filters, Z, n_in, HIER, len(ENC) - 1)
    lc_params = jax.jit(lambda k: jlc.init({"params": k, "dropout": k}, jnp.zeros((1, n_in)),
                                           deterministic=True))(jax.random.PRNGKey(5))["params"]
    lc = convert.conditioner_from_jax(jax.tree_util.tree_map(np.asarray, lc_params),
                                      LCConfig(filters=filters, input_type="csv"), CFG, "cpu")
    y1, y2 = _latents(6)
    want = JaxEvaluator(_jax_vae(), jax_params, T).evaluate_reconstruction_comparison(
        lambda x: jlc.apply({"params": lc_params}, x, deterministic=True), inputs, y1, y2,
        data, *scalers[0], save_plots=False)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with torch.no_grad():
        got = ReconstructionEvaluator(port_vae, batch_size=2).evaluate_reconstruction_comparison(
            lc, inputs, y1, y2, data, *scalers[1], save_dir=str(tmp_path))
    for k in ("pred_mse", "true_mse", "predicted", "true_recon"):
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=1e-5, err_msg=k)
    assert (f"Skipped {P} comparison PNGs ({tmp_path}/reconstruction_dual_view_0.png ..): "
            "matplotlib is not installed") in capsys.readouterr().out
    assert not list(tmp_path.iterdir())
    assert not plotter.have_matplotlib()


def test_pngs_are_written_with_matplotlib(port_vae, data, tmp_path, capsys):
    trec._save_comparison_pngs(data, data * 0.5, np.ones(P), "Validation",
                               save_dir=str(tmp_path / "v"), max_images=1)
    assert (tmp_path / "v" / "reconstruction_sample_001.png").exists()
    plotter.dual_view_plotter(data, param_idx=1, save_path=str(tmp_path / "dual.png"))
    assert (tmp_path / "dual.png").exists()
    ReconstructionEvaluator._plot_comparison(plotter.pyplot(), 0, data[0], data[0] * 0.5,
                                             data[0] * 0.9, str(tmp_path))
    assert (tmp_path / "reconstruction_dual_view_0.png").exists()
    assert "Saved 1 reconstruction images" in capsys.readouterr().out


def test_recon_png_skip_line_names_the_slug(port_vae, data, tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.chdir(tmp_path)
    trec.evaluate_vae_reconstruction(port_vae, data, 0, batch_size=2, verbose=False,
                                     dataset_name="Training Reconstruction", save_images=True)
    assert ("Skipped 5 reconstruction PNGs (checkpoints/training_reconstruction/"
            "reconstruction_sample_001.png ..): matplotlib is not installed"
            ) in capsys.readouterr().out
    assert not (tmp_path / "checkpoints").exists()


def test_vae_tree_is_the_jax_tree_back(jax_params, port_vae):
    """``convert.vae_tree`` inverts ``vae_state``: the JAX-initialized tree
    comes back with its paths, shapes and bits."""
    back = convert.vae_tree(port_vae, CFG)
    flat_want = jax.tree_util.tree_flatten_with_path(jax_params)[0]
    flat_got = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (path, g), (_, w) in zip(flat_got, flat_want):
        assert g.dtype == np.float32 and g.flags.c_contiguous, path
        np.testing.assert_array_equal(g, w, err_msg=str(path))
