"""Port GroupNorm + activation (simulgen_vae_tpu_torch.ops.groupnorm_gelu) vs the
JAX kernels, which run here in Pallas interpret mode. f32, atol 1e-5.

The CUDA kernels themselves run only on the card; ``chip_smoke.py`` holds each
against these plain versions there.
"""

import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from simulgen_vae_tpu.ops import groupnorm_gelu as jgg
from simulgen_vae_tpu_torch.ops import _build
from simulgen_vae_tpu_torch.ops import groupnorm_gelu as tgg

ACTS = ("gelu", "tanh", "none")


def _case(b, t, c, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    scale = rng.standard_normal(c).astype(np.float32)
    bias = rng.standard_normal(c).astype(np.float32)
    return x, scale, bias


def _port(fn, x, scale, bias, *args):
    return fn(torch.from_numpy(x), torch.from_numpy(scale),
              torch.from_numpy(bias), *args).numpy()


def _two_phase(x, scale, bias, g, act):
    """The port's gn_stats + gn_apply split, on the CPU (their plain versions)."""
    xt = torch.from_numpy(x)
    stats = tgg.gn_stats(xt, g)
    return tgg.gn_apply(xt, torch.from_numpy(scale), torch.from_numpy(bias),
                        stats, g, act).numpy()


@pytest.mark.parametrize("act", ACTS)
def test_reference_matches_jax_onepass_kernel(act):
    x, scale, bias = _case(2, 8, 24, seed=0)
    want = np.asarray(jgg.fused_group_norm_gelu(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), 3, 1e-5, act))
    got = _port(tgg.group_norm_act_reference, x, scale, bias, 3, 1e-5, act)
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(_port(tgg.gn_act_onepass, x, scale, bias, 3, 1e-5, act),
                               want, atol=1e-5)


@pytest.mark.parametrize("act", ACTS)
def test_reference_matches_jax_tiled_kernel(monkeypatch, act):
    """C = 300 in 4 groups of 75: the JAX kernel's 128-wide tiles cross groups
    and its last tile is ragged."""
    monkeypatch.setattr(jgg, "VMEM_BLOCK_BYTES", 6 * 128 * 4)  # ct = 128
    x, scale, bias = _case(2, 6, 300, seed=3)
    want = np.asarray(jgg.tiled_group_norm_gelu(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), 4, 1e-5, act))
    got = _port(tgg.group_norm_act_reference, x, scale, bias, 4, 1e-5, act)
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(_two_phase(x, scale, bias, 4, act), want, atol=1e-5)


def test_flagship_group_width_matches_jax_tiled_kernel():
    """2969-wide groups (the flagship's 11876 = 4 x 2969), C not a multiple of 128."""
    x, scale, bias = _case(1, 4, 2969 * 4, seed=6)
    want = np.asarray(jgg.tiled_group_norm_gelu(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), 4, 1e-5, "tanh"))
    got = _port(tgg.group_norm_act_reference, x, scale, bias, 4, 1e-5, "tanh")
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(_two_phase(x, scale, bias, 4, "tanh"), want, atol=1e-5)


def test_dispatcher_takes_plain_version_on_cpu():
    x, scale, bias = _case(2, 5, 40, seed=1)
    tgg.reset_launch_counts()
    got = _port(tgg.group_norm_act, x, scale, bias, 8, 1e-5, "gelu")
    want = _port(tgg.group_norm_act_reference, x, scale, bias, 8, 1e-5, "gelu")
    np.testing.assert_array_equal(got, want)
    assert all(n == 0 for n in tgg.LAUNCHES.values())


def test_dispatcher_raises_on_other_devices():
    x = torch.empty((1, 2, 8), device="meta")
    s = torch.empty(8, device="meta")
    with pytest.raises(ValueError):
        tgg.group_norm_act(x, s, s, 2)


@pytest.mark.parametrize("t,c,elem,fits", [
    (200, 256, 4, True), (200, 290, 4, False),      # f32: C <= 256 at T = 200
    (200, 512, 2, True), (200, 1024, 2, False),     # bf16: C <= 512
    (200, 95008, 2, False),
])
def test_onepass_engage_rule(t, c, elem, fits):
    assert tgg.onepass_fits(t, c, 8, elem) is fits
    assert (tgg.onepass_smem_bytes(t, c, 8, elem) <= 232448) is fits


def test_build_path_follows_sources(tmp_path, monkeypatch):
    """A kernel's library name hashes its own source and the shared headers
    it includes (directly or through another), so an edit rebuilds it and an
    edit of another kernel, or of a header it does not include, does not."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = {k: _build.library_path(k) for k in _build.KERNELS}
    (csrc / "gn_stats.cu").write_text((csrc / "gn_stats.cu").read_text() + "\n")
    after = {k: _build.library_path(k) for k in _build.KERNELS}
    assert after["gn_stats"] != before["gn_stats"]
    assert after["gn_apply"] == before["gn_apply"]
    for header, users in (
            # field_epilogue's fused readout pass applies GroupNorm with its helpers
            ("gn_common.cuh", {k for k in _build.KERNELS if k.startswith(("gn_", "readout_"))}
             | {"field_epilogue"}),
            ("hopper.cuh", {"readout_matmul_stats", "readout_bwd_fused"})):
        (csrc / header).write_text((csrc / header).read_text() + "\n")
        edited = {k: _build.library_path(k) for k in _build.KERNELS}
        assert {k for k in _build.KERNELS if edited[k] != after[k]} == users, header
        after = edited


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()
