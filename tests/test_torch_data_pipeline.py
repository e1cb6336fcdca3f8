"""The training CLI's numpy and host layers against the JAX package's, on the
same numpy inputs from a seed:

* dataset loading, reduction and the synthetic ensemble: the same bits;
* ``data_scaler`` (all rows, and a sampled fit of more than 1000 rows) and
  ``latent_conditioner_scaler``: the same scaled bits and equal pickled
  statistics, each package reading the other's pickle;
* ``lc_warmup_cosine`` and ``cosine_annealing`` over epochs 0-250: rtol 1e-6
  (both in f32; at some other schedule lengths the two f32 ``cos`` can differ
  by one ulp near the end of the cosine, where ``1 + cos`` is small);
* the enhanced and perceptual losses and ``log_sum_exp``: rtol 1e-6;
* ``save_latents`` / ``save_l2_loss`` (the same bytes), the stdin preset,
  the epoch log line and the summary's parameter count.
"""

import io
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simulgen_vae_tpu import config as jconfig
from simulgen_vae_tpu import losses as jlosses
from simulgen_vae_tpu.data import dataset as jdataset
from simulgen_vae_tpu.data import scaler as jscaler
from simulgen_vae_tpu.train import schedules as jsched
from simulgen_vae_tpu.utils import checkpoint as jckpt
from simulgen_vae_tpu.utils import logging as jlogging
from simulgen_vae_tpu.utils import summary as jsummary
from simulgen_vae_tpu_torch import config as tconfig
from simulgen_vae_tpu_torch import convert
from simulgen_vae_tpu_torch import losses as tlosses
from simulgen_vae_tpu_torch.data import dataset as tdataset
from simulgen_vae_tpu_torch.data import scaler as tscaler
from simulgen_vae_tpu_torch.train import schedules as tsched
from simulgen_vae_tpu_torch.utils import checkpoint as tckpt
from simulgen_vae_tpu_torch.utils import logging as tlogging
from simulgen_vae_tpu_torch.utils import summary as tsummary

STATS = ("data_min_", "data_max_", "scale_", "min_")


@pytest.mark.parametrize("p, t, n, seed", [(12, 10, 32, 0), (5, 7, 300, 3)])
def test_synthetic_dataset_same_bits(p, t, n, seed):
    got = tdataset.synthetic_dataset(p, t, n, seed=seed)
    want = jdataset.synthetic_dataset(p, t, n, seed=seed)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_input_dataset_reads_the_pickle(tmp_path, capsys):
    data = np.random.default_rng(0).standard_normal((4, 6, 9)).astype(np.float32)
    with open(tmp_path / "dataset3.pickle", "wb") as f:
        pickle.dump(data, f)
    got = tdataset.input_dataset(4, 6, 9, 3, base_dir=str(tmp_path))
    want = jdataset.input_dataset(4, 6, 9, 3, base_dir=str(tmp_path))
    np.testing.assert_array_equal(got, want)
    assert "Dataset size:  (4, 6, 9)" in capsys.readouterr().out


@pytest.mark.parametrize("time_to, start, end", [(10, 0, 32), (7, 4, 29)],
                         ids=["uncut", "cut"])
def test_reduce_dataset_same_bits(time_to, start, end):
    data = np.random.default_rng(1).standard_normal((3, 10, 32)).astype(np.float32)
    got = tdataset.reduce_dataset(data, time_to, end - start, 3, 10, start, end)
    want = jdataset.reduce_dataset(data, time_to, end - start, 3, 10, start, end)
    assert got[0] == want[0] and got[2] == want[2]
    np.testing.assert_array_equal(got[1], want[1])
    assert got[1].flags.c_contiguous


def _load_stats(path):
    return tscaler.MinMaxScaler.load(str(path))


def _assert_same_pickles(port_path, jax_path):
    """Both pickles hold the same statistics, and each package reads the
    other's."""
    got, want = _load_stats(port_path), _load_stats(jax_path)
    for k in STATS:
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype == np.float64
        np.testing.assert_array_equal(a, b)
    assert got.feature_range == want.feature_range
    crossed = jscaler.MinMaxScaler.load(str(port_path))
    for k in STATS:
        np.testing.assert_array_equal(getattr(crossed, k), getattr(want, k))


@pytest.mark.parametrize("p, t, n", [(12, 10, 32), (60, 200, 40), (3, 5, 8)],
                         ids=["all_rows", "sampled_1200_rows", "constant_column"])
def test_data_scaler_same_bits_and_pickles(tmp_path, p, t, n):
    data = (np.random.default_rng(p).standard_normal((p, t, n)) * 3.0 + 1.0).astype(np.float32)
    data[:, :, 0] = 2.5 if n == 8 else data[:, :, 0]   # a constant feature scales by 1
    got, shape, scaler = tscaler.data_scaler(data, t, n, save_path=str(tmp_path / "t.pkl"))
    want, jshape, _ = jscaler.data_scaler(data, t, n, save_path=str(tmp_path / "j.pkl"))
    assert shape == jshape and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    _assert_same_pickles(tmp_path / "t.pkl", tmp_path / "j.pkl")
    if n == 8:
        assert scaler.scale_[0] == np.float32(1.4)


@pytest.mark.parametrize("shape", [(12, 4), (12, 3, 8)], ids=["2d", "3d"])
def test_latent_conditioner_scaler_same_bits_and_pickles(tmp_path, shape):
    data = np.random.default_rng(5).standard_normal(shape) * 2.0 - 0.5
    got, scaler = tscaler.latent_conditioner_scaler(data, str(tmp_path / "t.pkl"))
    want, _ = jscaler.latent_conditioner_scaler(data, str(tmp_path / "j.pkl"))
    assert got.shape == shape
    np.testing.assert_array_equal(got, want)
    _assert_same_pickles(tmp_path / "t.pkl", tmp_path / "j.pkl")
    np.testing.assert_allclose(scaler.inverse_transform(got.reshape(12, -1)),
                               data.reshape(12, -1), rtol=1e-12, atol=1e-12)


def test_latent_conditioner_scaler_refuses_empty_data():
    with pytest.raises(ValueError, match="Empty data array"):
        tscaler.latent_conditioner_scaler(np.zeros((0, 4)))


@pytest.mark.parametrize("total, warmup", [(6, 3), (30, 15), (200, 100), (500, 100)])
def test_lc_warmup_cosine_matches_jax(total, warmup):
    got = [tsched.lc_warmup_cosine(e, 1e-3, total, warmup) for e in range(251)]
    want = [float(jsched.lc_warmup_cosine(e, 1e-3, total, warmup)) for e in range(251)]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[0] == pytest.approx(1e-5, rel=1e-6)


@pytest.mark.parametrize("total", [6, 30, 200, 500])
def test_cosine_annealing_matches_jax(total):
    got = [tsched.cosine_annealing(e, 1e-3, total) for e in range(251)]
    want = [float(jsched.cosine_annealing(e, 1e-3, total)) for e in range(251)]
    np.testing.assert_allclose(got, want, rtol=1e-6)


def _latent_pairs(seed):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-0.7, 0.7, s).astype(np.float32)
            for s in ((6, 8), (6, 3, 4), (6, 8), (6, 3, 4))]


@pytest.mark.parametrize("cfg", [
    {},
    {"mse_weight": 0.5, "mae_weight": 0.0, "huber_weight": 0.5, "huber_beta": 0.05,
     "main_weight": 0.7, "hier_weight": 0.3},
    {"huber_weight": 0.0},
], ids=["defaults", "no_mae", "no_huber"])
def test_enhanced_loss_matches_jax(cfg):
    p1, p2, y1, y2 = _latent_pairs(0)
    got = tlosses.compute_enhanced_loss(*map(torch.from_numpy, (p1, p2, y1, y2)), cfg)
    want = jlosses.compute_enhanced_loss(*map(jnp.asarray, (p1, p2, y1, y2)), cfg)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("weight", [0, 0.5])
def test_perceptual_loss_matches_jax(weight):
    p1, p2, y1, y2 = _latent_pairs(1)
    cfg = {"perceptual_weight": weight}
    got = tlosses.compute_perceptual_loss(*map(torch.from_numpy, (p1, p2, y1, y2)), cfg)
    want = jlosses.compute_perceptual_loss(*map(jnp.asarray, (p1, p2, y1, y2)), cfg)
    if weight == 0:
        assert got == want == 0.0
    else:
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("shape", [(4, 7), (3, 5, 6)])
def test_log_sum_exp_matches_jax(shape):
    x = (np.random.default_rng(2).standard_normal(shape) * 20.0).astype(np.float32)
    got = tlosses.log_sum_exp(torch.from_numpy(x)).numpy()
    want = np.asarray(jlosses.log_sum_exp(jnp.asarray(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_latent_and_l2_files_have_the_same_bytes(tmp_path):
    rng = np.random.default_rng(4)
    lv, xs = rng.standard_normal((5, 8)).astype(np.float32), rng.standard_normal((5, 2, 4))
    loss = rng.uniform(0, 1, 5).astype(np.float32)
    for root, mod in ((tmp_path / "t", tckpt), (tmp_path / "j", jckpt)):
        mod.save_latents(str(root), lv, xs)
        mod.save_l2_loss(str(root / "l2.txt"), loss)
    for name in ("latent_vectors.npy", "xs.npy", "l2.txt"):
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()


def test_input_user_variables_matches_jax(monkeypatch):
    answers = "2\n3\n64 32 16\n8 16\n"
    monkeypatch.setattr("sys.stdin", io.StringIO(answers))
    got = tconfig.input_user_variables()
    monkeypatch.setattr("sys.stdin", io.StringIO(answers))
    assert got == jconfig.input_user_variables() == (2, 3, [64, 32, 16], [8, 16])


def test_epoch_log_line_matches_jax():
    m = {"loss": 1.25, "val_loss": 2.5, "recon": 0.75, "kl": 3.0, "beta": 1e-4,
         "grad_norm": 9.5, "epoch_time": 2.0, "lr": 1e-3}
    assert tlogging.epoch_log_line(3, 10, m) == jlogging.epoch_log_line(3, 10, m)
    assert tlogging.epoch_log_line(0, 1, {}) == jlogging.epoch_log_line(0, 1, {})


def test_metrics_logger_writes_the_console_line(caplog, tmp_path):
    logger = tlogging.MetricsLogger(log_dir=str(tmp_path), name="VAE", samples_per_epoch=8)
    with caplog.at_level("INFO"):
        logger.log(0, {"loss": 1.0, "epoch_time": 0.5}, 2)
    logger.close()
    assert "[Epoch 1/2] Loss: 1.0000E+00" in caplog.text
    # TensorBoard events where tensorboardX is installed (it is here, not on the card)
    assert (logger.writer is None) == (not list(tmp_path.iterdir()))


def test_summary_counts_the_parameters_jax_counts():
    """The port's table counts the parameters JAX's table counts on the same
    conditioner tree."""
    filters, n_in = [8, 16, 16], 12
    cfg = tconfig.VAEConfig(latent_dim_end=8, latent_dim=4, num_filter_enc=[4] * 4)
    lc_cfg = tconfig.LCConfig(filters=filters, input_type="csv")
    tree = convert.random_conditioner_tree(lc_cfg, cfg, n_in, np.random.default_rng(0))
    lc = convert.conditioner_from_jax(tree, lc_cfg, cfg, "cpu")

    def total(table):
        row = next(ln for ln in table.splitlines() if ln.startswith("trainable params"))
        return int(row.split()[3].replace(",", ""))

    want = total(jsummary.model_summary(tree, name="lc"))
    assert total(tsummary.model_summary(lc, name="lc")) == want == sum(
        p.numel() for p in lc.parameters())
