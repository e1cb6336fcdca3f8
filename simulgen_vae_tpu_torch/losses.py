"""The hierarchical KL term the decoder returns (``simulgen_vae_tpu/losses.py``)."""

from __future__ import annotations

import torch

LOG_VAR_CLAMP = 30.0


def kl_2(delta_mu: torch.Tensor, delta_log_var: torch.Tensor,
         mu: torch.Tensor, log_var: torch.Tensor) -> torch.Tensor:
    """KL of the delta-posterior against the conv prior, summed over every
    non-batch axis, mean over the batch."""
    log_var = log_var.clamp(-LOG_VAR_CLAMP, LOG_VAR_CLAMP)
    delta_log_var = delta_log_var.clamp(-LOG_VAR_CLAMP, LOG_VAR_CLAMP)
    var = torch.exp(log_var) + 1e-8
    delta_var = torch.exp(delta_log_var)
    loss = 0.5 * torch.sum(
        delta_var / var + (mu - delta_mu) ** 2 / var - delta_log_var + log_var - 1.0,
        dim=tuple(range(1, mu.dim())),
    )
    return loss.mean(dim=0)
