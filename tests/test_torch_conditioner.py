"""Port MLP latent conditioner vs the JAX one in deterministic mode, f32, atol 1e-5.

The low-variance case pins flax's LayerNorm eps of 1e-6: with input variance
near 1e-6, PyTorch's default eps of 1e-5 would move the normalised values by
tens of percent.
"""

import jax
import numpy as np
import pytest
import torch

from simulgen_vae_tpu.models import LatentConditioner as JaxLC
from simulgen_vae_tpu_torch import convert
from simulgen_vae_tpu_torch.config import LCConfig, VAEConfig


@pytest.mark.parametrize("filters,n_in,x_scale", [
    ([8, 16, 16], 12, 1.0),          # one projected block, one plain block
    ([8, 16, 32], 200, 1.0),         # hidden from the complexity ratio (200 // 64)
    ([8, 16, 16], 12, 1e-3),         # input variance ~1e-6: eps matters
])
def test_conditioner_matches_jax(filters, n_in, x_scale):
    z_end, hier, size2 = 8, 4, 3
    x = (x_scale * np.random.default_rng(n_in).standard_normal((5, n_in))).astype(np.float32)
    jlc = JaxLC(filters, z_end, n_in, hier, size2, dropout_rate=0.3)
    params = jlc.init({"params": jax.random.PRNGKey(1), "dropout": jax.random.PRNGKey(2)},
                      x, deterministic=True)["params"]
    rng = np.random.default_rng(3)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.1 * rng.standard_normal(a.shape)).astype(np.float32),
        params)
    want1, want2 = jlc.apply({"params": params}, x, deterministic=True)

    cfg = VAEConfig(latent_dim_end=z_end, latent_dim=hier,
                    num_filter_enc=[4] * (size2 + 1))
    lc = convert.conditioner_from_jax(params, LCConfig(filters=filters), cfg, "cpu")
    with torch.inference_mode():
        got1, got2 = lc(torch.from_numpy(x))
    assert got2.shape == (5, size2, hier)
    np.testing.assert_allclose(got1.numpy(), np.asarray(want1), atol=1e-5)
    np.testing.assert_allclose(got2.numpy(), np.asarray(want2), atol=1e-5)
