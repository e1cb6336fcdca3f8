"""The port's readers and writers of ``model_save/`` and of the config files,
against the JAX package's (flax, msgpack, sklearn and pandas are here; the
card's machine has none of them).

* Config: ``input_data/condition.txt`` + ``preset.txt`` and the CLI test's
  condition give the same dicts and ``VAEConfig`` / ``LCConfig`` fields.
* Msgpack: a tree JAX's ``save_flax_model`` writes (f32, int32, 0-d and
  scalar leaves, nesting, an empty ``batch_stats``) reads back with the same
  dtypes, shapes and bits, and the port's writer gives flax's bytes; flax
  reads the port's file given a template; a chunked leaf (flax's
  ``MAX_CHUNK_SIZE`` made small) reads back whole.
* Scalers: sklearn pickles written by the JAX package give the same
  statistics' bits, the port's pickles give JAX's ``MinMaxScaler.load`` the
  same ones, and a pickle naming any other global is refused.
* CSV: the numpy reader against pandas' ``read_csv(header=None).values``.
"""

import os
import pickle
from pathlib import Path

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from simulgen_vae_tpu import config as jcfg
from simulgen_vae_tpu.data import scaler as jscaler
from simulgen_vae_tpu.data.images import read_latent_conditioner_dataset as jax_read_csv
from simulgen_vae_tpu.utils import checkpoint as jckpt
from simulgen_vae_tpu_torch import config as tcfg
from simulgen_vae_tpu_torch.data.images import read_latent_conditioner_dataset
from simulgen_vae_tpu_torch.data.scaler import MinMaxScaler
from simulgen_vae_tpu_torch.utils import checkpoint as tckpt
from simulgen_vae_tpu_torch.utils import msgpack_tree

REPO = Path(__file__).resolve().parent.parent


def _cli_condition(tmp_path) -> str:
    from tests.test_cli_pipeline import CONDITION

    path = tmp_path / "condition.txt"
    path.write_text(CONDITION)
    return str(path)


@pytest.mark.parametrize("which", ["repo", "cli_test"])
def test_config_parsing_matches_jax(tmp_path, which):
    condition = (str(REPO / "input_data" / "condition.txt") if which == "repo"
                 else _cli_condition(tmp_path))
    raw = tcfg.parse_condition_file(condition)
    assert raw == jcfg.parse_condition_file(condition)
    typed = tcfg.parse_training_parameters(raw)
    assert typed == jcfg.parse_training_parameters(raw)
    preset = tcfg.read_preset(str(REPO / "preset.txt"))
    assert preset == jcfg.read_preset(str(REPO / "preset.txt"))
    assert tcfg.LOSS_NAMES == jcfg.LOSS_NAMES
    for small in (True, False):
        got = tcfg.VAEConfig.from_condition(typed, preset[2], small=small)
        want = jcfg.VAEConfig.from_condition(typed, preset[2], small=small)
        for f in got.__dataclass_fields__:
            assert getattr(got, f) == getattr(want, f), f
        assert got.num_filter_dec == want.num_filter_dec and got.num_hier == want.num_hier
    got, want = tcfg.LCConfig.from_condition(typed, preset[3]), \
        jcfg.LCConfig.from_condition(typed, preset[3])
    assert set(got.__dataclass_fields__) == set(want.__dataclass_fields__)
    for f in got.__dataclass_fields__:
        assert getattr(got, f) == getattr(want, f), f
    assert tcfg.LCConfig() == tcfg.LCConfig(**{
        f: getattr(jcfg.LCConfig(), f) for f in want.__dataclass_fields__})


def _tree():
    rng = np.random.default_rng(0)
    return {
        "params": {
            "Dense_0": {"kernel": rng.standard_normal((12, 70)).astype(np.float32),
                        "bias": rng.standard_normal(70).astype(np.float32)},
            "deep": {"deeper": {"w": rng.standard_normal((3, 5, 4)).astype(np.float32),
                                "ids": np.arange(-3, 300, dtype=np.int32)}},
            "zero_d": np.asarray(1.5, np.float32),
            "scalar": np.float32(-2.25),
            "count": np.int32(7),
        },
        "batch_stats": {},
    }


def _assert_same(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            _assert_same(got[k], want[k], f"{path}/{k}")
        return
    got_a, want_a = np.asarray(got), np.asarray(want)
    assert got_a.dtype == want_a.dtype and got_a.shape == want_a.shape, path
    np.testing.assert_array_equal(got_a.reshape(-1).view(np.uint8),
                                  want_a.reshape(-1).view(np.uint8), err_msg=path)


def test_msgpack_reads_jax_files_and_writes_flax_bytes(tmp_path):
    tree = _tree()
    jckpt.save_flax_model(str(tmp_path / "jax_model"), tree)
    got = tckpt.load_flax_model(str(tmp_path / "jax_model"))
    _assert_same(got, tree)
    assert isinstance(got["params"]["scalar"], np.float32)     # ext 3 -> numpy scalar
    assert got["params"]["Dense_0"]["kernel"].flags.writeable
    tckpt.save_flax_model(str(tmp_path / "port_model"), got)
    assert (tmp_path / "port_model").read_bytes() == (tmp_path / "jax_model").read_bytes()


def test_jax_reads_port_files(tmp_path):
    tree = _tree()
    tckpt.save_flax_model(str(tmp_path / "sub" / "port_model"), tree)
    template = jax.tree_util.tree_map(np.zeros_like, tree)
    _assert_same(jckpt.load_flax_model(str(tmp_path / "sub" / "port_model"), template), tree)


def test_chunked_leaves_read_back_whole(tmp_path, monkeypatch):
    """flax splits leaves above MAX_CHUNK_SIZE bytes into flat chunks."""
    from flax import serialization

    tree = _tree()
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 256)
    jckpt.save_flax_model(str(tmp_path / "chunked"), tree)
    raw = (tmp_path / "chunked").read_bytes()
    assert msgpack_tree.CHUNKED.encode() in raw
    _assert_same(msgpack_tree.unpackb(raw), tree)
    monkeypatch.setattr(msgpack_tree, "MAX_CHUNK_SIZE", 256)
    assert msgpack_tree.packb(tree) == raw


def _jax_scaler(rng, shape):
    return jscaler.MinMaxScaler().fit(rng.standard_normal(shape) * 3.0 + 1.0)


def test_scaler_pickles_round_trip(tmp_path):
    rng = np.random.default_rng(0)
    want = _jax_scaler(rng, (40, 9))
    want.save(str(tmp_path / "jax.pkl"))                       # an sklearn pickle
    got = MinMaxScaler.load(str(tmp_path / "jax.pkl"))
    for attr in ("scale_", "min_", "data_min_", "data_max_"):
        assert getattr(got, attr).dtype == np.float64
        np.testing.assert_array_equal(getattr(got, attr), getattr(want, attr))
    assert got.feature_range == want.feature_range
    got.save(str(tmp_path / "port.pkl"))
    back = jscaler.MinMaxScaler.load(str(tmp_path / "port.pkl"))
    for attr in ("scale_", "min_", "data_min_", "data_max_"):
        np.testing.assert_array_equal(getattr(back, attr), getattr(want, attr))
    x = rng.standard_normal((5, 9))
    np.testing.assert_array_equal(got.transform(x), want.transform(x))
    # a scaler made from scale_ and min_ alone derives its data range
    bare = MinMaxScaler(np.float32([2.0, 0.5]), np.float32([0.1, -0.2]))
    bare.save(str(tmp_path / "bare.pkl"))
    again = jscaler.MinMaxScaler.load(str(tmp_path / "bare.pkl"))
    np.testing.assert_array_equal(again.scale_, [2.0, 0.5])
    np.testing.assert_array_equal(again.min_, np.float32([0.1, -0.2]).astype(np.float64))
    np.testing.assert_allclose(again.data_min_ * again.scale_ + again.min_, -0.7)
    np.testing.assert_allclose(again.data_max_ * again.scale_ + again.min_, 0.7)
    dev = got.to("cpu")
    assert dev.scale_.dtype == torch.float32 and torch.equal(
        dev.scale_, torch.from_numpy(want.scale_.astype(np.float32)))


class _Evil:
    def __reduce__(self):
        return (os.system, ("echo pwned",))


@pytest.mark.parametrize("payload", ["os.system", "builtins.eval", "sklearn.Pipeline"])
def test_scaler_unpickler_refuses_other_globals(tmp_path, payload):
    path = tmp_path / "evil.pkl"
    if payload == "os.system":
        path.write_bytes(pickle.dumps(_Evil()))
    elif payload == "builtins.eval":
        path.write_bytes(pickle.dumps(eval))
    else:
        from sklearn.pipeline import Pipeline
        from sklearn.preprocessing import MinMaxScaler as SkScaler

        path.write_bytes(pickle.dumps(Pipeline([("s", SkScaler())])))
    with pytest.raises(pickle.UnpicklingError, match="may not name"):
        MinMaxScaler.load(str(path))


@pytest.mark.parametrize("case", ["ints", "floats", "exponents", "single_row"])
def test_csv_reader_matches_pandas(tmp_path, case):
    rng = np.random.default_rng(3)
    path = tmp_path / f"{case}.csv"
    if case == "ints":
        path.write_text("1,2,3\n4,-5,6\n70000,0,-1\n")
    elif case == "floats":
        np.savetxt(path, rng.standard_normal((30, 6)) * 10.0 ** rng.integers(-6, 6, (30, 6)),
                   delimiter=",")
    elif case == "exponents":
        path.write_text("1e-5,2.5E+3,-3.125e-10\n7.0e300,-0.0,1.7976931348623157e308\n")
    else:
        path.write_text("0.1,0.2,0.3,0.7\n")
    want = jax_read_csv(str(path))
    got = read_latent_conditioner_dataset(str(path))
    assert got.shape == want.shape and got.dtype == np.float64
    if case == "floats":
        # pandas' default parser is up to 2 ulps off a correctly rounded f64
        # on 17-digit numbers; numpy rounds correctly, as pandas' round_trip
        # parser does. What the model sees, the f32 cast, is the same.
        np.testing.assert_array_equal(
            got, pd.read_csv(path, header=None, float_precision="round_trip").values)
        np.testing.assert_array_less(np.abs(got.view(np.int64) - want.view(np.int64)), 3)
        np.testing.assert_array_equal(got.astype(np.float32), want.astype(np.float32))
    else:
        np.testing.assert_array_equal(got, want.astype(np.float64))
