"""AdamW for the VAE train step (``simulgen_vae_tpu/train/optim.py`` ``FusedAdamW``).

Math of torch ``AdamW(lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01)``
on every parameter (decoupled decay, eps outside the sqrt):

    m <- b1 m + (1 - b1) g          v <- b2 v + (1 - b2) g^2
    p <- p - lr * (m / c1 / (sqrt(v / c2) + eps) + wd * p)

with c1 = 1 - b1^t, c2 = 1 - b2^t. State is f32 (the TPU-only bf16 moments
with stochastic rounding are not ported). The update runs as
``torch._foreach_*`` sweeps over the parameter list, in place (parameters and
moments are overwritten), and returns the global gradient norm as a 0-d
device tensor, so a step needs no host sync.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


class FusedAdamW:
    def __init__(self, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.01):
        self.b1, self.b2, self.eps, self.wd = b1, b2, eps, weight_decay

    def init(self, params: Dict[str, torch.Tensor]) -> dict:
        """``{"count": 0, "mu": {name: zeros}, "nu": {name: zeros}}``, f32."""
        zeros = lambda: {k: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
                         for k, p in params.items()}
        return {"count": 0, "mu": zeros(), "nu": zeros()}

    def apply(self, grads: Dict[str, torch.Tensor], state: dict,
              params: Dict[str, torch.Tensor], lr: float) -> torch.Tensor:
        """Update ``params`` and ``state`` in place from ``grads`` (same keys);
        returns the global gradient norm."""
        names = list(params)
        p = [params[k].data for k in names]
        g = [grads[k].float() for k in names]
        m = [state["mu"][k] for k in names]
        v = [state["nu"][k] for k in names]
        state["count"] += 1
        t = np.float32(state["count"])
        # Bias corrections in f32, as the JAX update computes them.
        c1 = float(np.float32(1.0) - np.float32(self.b1) ** t)
        c2 = float(np.float32(1.0) - np.float32(self.b2) ** t)

        grad_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g)))
        torch._foreach_mul_(m, self.b1)
        torch._foreach_add_(m, g, alpha=1.0 - self.b1)
        torch._foreach_mul_(v, self.b2)
        torch._foreach_addcmul_(v, g, g, value=1.0 - self.b2)
        upd = torch._foreach_div(m, c1)
        den = torch._foreach_div(v, c2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        torch._foreach_div_(upd, den)
        del den
        torch._foreach_add_(upd, p, alpha=self.wd)
        torch._foreach_add_(p, upd, alpha=-lr)
        return grad_norm
