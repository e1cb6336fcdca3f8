"""The streamed epoch's host gather (``vae_trainer.gather_rows``) against
``index_select`` and the JAX package's native gather, on the CPU.

Every comparison is exact: the f32 gather is a copy, and the bf16 gather
rounds to nearest even as ``Tensor.to(torch.bfloat16)`` and JAX's
``native_loader.gather_rows(..., to_bf16=True)`` do (a NaN stays a NaN; its
payload may differ). A bf16 trainer stages bf16 rows, and its streamed epoch
gives the same bits as the route that gathers f32 rows with ``index_select``
and casts them afterwards.
"""

import struct

import numpy as np
import pytest
import torch

from simulgen_vae_tpu.data import native_loader as jnl
from simulgen_vae_tpu_torch.config import VAEConfig
from simulgen_vae_tpu_torch.train import vae_trainer as vt


def _f32(bits: int) -> float:
    return struct.unpack("<f", struct.pack("<I", bits))[0]


def _edge_rows() -> np.ndarray:
    """[20, 33] f32: seeded values of both signs, and in row 0 the edges of
    the rounding: ties to even both ways, subnormals (one rounding to a bf16
    subnormal, one to zero), values that round up to the next binade and to
    infinity, zeros, infinities and a NaN."""
    src = (np.random.default_rng(1).standard_normal((20, 33)) * 100).astype(np.float32)
    edges = [0x3F808000, 0x3F818000, 0xBF808000, 0x00000001, 0x00018000, 0x007FFFFF,
             0x3FFFFFFF, 0x7F7FFFFF, 0xFF7FFFFF, 0x7F7F7FFF]
    src[0, :len(edges)] = [_f32(b) for b in edges]
    src[0, len(edges):len(edges) + 5] = [0.0, -0.0, np.inf, -np.inf, np.nan]
    return src


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> None:
    assert a.dtype == b.dtype and a.shape == b.shape
    nan = torch.isnan(a.float())
    assert torch.equal(nan, torch.isnan(b.float()))
    width = torch.int16 if a.element_size() == 2 else torch.int32
    assert torch.equal(a.view(width)[~nan], b.view(width)[~nan])


def test_f32_gather_equals_index_select_and_jax():
    rng = np.random.default_rng(0)
    src = rng.standard_normal((50, 7, 13)).astype(np.float32)
    idx = rng.integers(0, 50, size=16)
    out = torch.empty((16, 7, 13))
    assert vt.gather_rows(torch.from_numpy(src), idx, out) is out
    assert torch.equal(out, torch.index_select(torch.from_numpy(src), 0, torch.from_numpy(idx)))
    np.testing.assert_array_equal(out.numpy(), jnl.gather_rows(src, idx))


def test_bf16_gather_rounds_as_torch_and_as_jax():
    src = _edge_rows()
    idx = np.array([0, 5, 0, 19, 3, 7, 0, 11])
    out = vt.gather_rows(torch.from_numpy(src), idx, torch.empty((8, 33), dtype=torch.bfloat16))
    want = torch.index_select(torch.from_numpy(src), 0, torch.from_numpy(idx)).to(torch.bfloat16)
    _same_bits(out, want)
    ref = jnl.gather_rows(src, idx, to_bf16=True)
    _same_bits(out, torch.from_numpy(ref.view(np.int16).copy()).view(torch.bfloat16))
    row0 = out[0].view(torch.int16).numpy().view(np.uint16)
    assert list(row0[:10]) == [0x3F80, 0x3F82, 0xBF80, 0x0000, 0x0002, 0x0080, 0x4000,
                               0x7F80, 0xFF80, 0x7F7F]
    assert torch.isnan(out[0, 14].float())


@pytest.mark.parametrize("src_dtype", [torch.float64, torch.bfloat16])
def test_other_source_dtypes_gather_as_the_cast(src_dtype):
    src = torch.from_numpy(np.random.default_rng(2).standard_normal((10, 6))).to(src_dtype)
    idx = np.array([9, 0, 4])
    out = vt.gather_rows(src, idx, torch.empty((3, 6), dtype=torch.bfloat16))
    assert torch.equal(out, src[torch.from_numpy(idx)].to(torch.bfloat16))


def test_gather_refuses_indices_outside_the_source():
    src = torch.zeros((5, 4))
    with pytest.raises(IndexError):
        vt.gather_rows(src, [0, 5], torch.empty((2, 4)))


def _stream_cfg(dtype: str) -> VAEConfig:
    return VAEConfig(num_param=16, num_time=12, num_node=300, latent_dim_end=8, latent_dim=4,
                     num_filter_enc=[16, 8, 8], small=True, n_epochs=4, batch_size=4,
                     lr=1e-3, alpha=100.0, dtype=dtype)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_streamed_epoch_same_bits_as_the_index_select_route(monkeypatch, dtype):
    """One streamed epoch (partners from the dataset) from one seed: the
    staging buffers are of the trainer's compute dtype, and the row-wise cast
    gives the same parameters and metrics, bit for bit, as gathering f32 rows
    with index_select and casting them afterwards."""
    data = (0.4 * np.random.default_rng(0).standard_normal((13, 12, 300))).astype(np.float32)
    staged = []

    def run():
        trainer = vt.VAETrainer(_stream_cfg(dtype), device="cpu", seed=3)
        return trainer.train_epoch_streaming(trainer.init_state(0), data)

    real = vt.gather_rows

    def row_wise(src, idx, out):
        staged.append(out.dtype)
        return real(src, idx, out)

    monkeypatch.setattr(vt, "gather_rows", row_wise)
    state, metrics = run()
    assert staged and set(staged) == {getattr(torch, dtype)}

    def index_select(src, idx, out):
        rows = torch.index_select(src, 0, torch.from_numpy(np.int64(idx)))
        return out.copy_(rows.to(out.dtype))

    monkeypatch.setattr(vt, "gather_rows", index_select)
    state2, metrics2 = run()
    assert state.opt_state["count"] == 3
    for (k, p), q in zip(state.model.named_parameters(), state2.model.parameters()):
        assert torch.equal(p, q), k
    for k in metrics:
        assert torch.equal(torch.as_tensor(metrics[k]), torch.as_tensor(metrics2[k])), k
