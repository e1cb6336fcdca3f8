"""AdamW for the VAE train step (``simulgen_vae_tpu/train/optim.py`` ``FusedAdamW``).

Math of torch ``AdamW(lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01)``
on every parameter (decoupled decay, eps outside the sqrt), all in f32:

    m <- b1 m + (1 - b1) g          v <- b2 v + ((1 - b2) g) g
    p <- p - lr * ((m / c1) / (sqrt(v / c2) + eps) + wd * p)

with c1 = 1 - b1^t, c2 = 1 - b2^t. ``moment_dtype`` / ``nu_dtype`` store the
moments in bf16 (the update still uses the unrounded f32 values), by
round-to-nearest or, with ``stochastic_round``, by :func:`sr_round_bf16`: an
unbiased rounding whose dither is a hash of (element index, step, leaf,
moment), so no random stream is drawn or stored.

On CUDA tensors :meth:`FusedAdamW.apply` is one hand-written sweep
(``ops.fused_adamw``, for every moment dtype); on CPU tensors it is
:meth:`FusedAdamW.apply_reference`, the plain version: ``torch._foreach_*``
sweeps in which every product and sum is its own rounded operation, the order
the kernel keeps. Both update parameters and moments in place and return the
global gradient norm as a 0-d device tensor, so a step needs no host sync.

The values that change from step to step (lr, the bias corrections, the
stochastic rounding's step word) reach the kernel as four words on the card
(:meth:`FusedAdamW.step_words`). :meth:`FusedAdamW.apply` advances the
count and stages them with one copy (``utils.staging``);
:meth:`FusedAdamW.apply_staged` takes words the caller staged, as a captured
train step does (``train.vae_trainer``), and leaves the count to it.

The dither's element index is the linear index in the port's layout
(``[F, C, k]``, ``[out, in]``) and the leaf index the parameter's position in
the port's parameter order, not the JAX tree's: after a stochastic rounding
the moments are not bit-equal to the JAX package's, while the rounding
function itself is (``tests/test_torch_train_optim_stack.py``).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from simulgen_vae_tpu_torch.utils.staging import Staging

_U32 = 0xFFFFFFFF


def sr_round_bf16(x: torch.Tensor, idx: torch.Tensor, seed: int) -> torch.Tensor:
    """Stochastic f32 -> bf16 rounding (the JAX ``_sr_round_bf16_fused``, bit
    for bit): add 16 bits of dither below the bf16 cut, then truncate.

        bits(x) + (lowbias32(idx * 0x9E3779B9 + seed) & 0xFFFF)  &  0xFFFF0000

    in uint32 arithmetic. ``idx`` holds each element's linear index (an int64
    tensor of x's shape), ``seed`` is taken mod 2**32. The result rounds up
    with probability equal to the distance to the lower neighbour, so its
    mean over seeds is x."""
    bits = x.float().contiguous().view(torch.int32).to(torch.int64) & _U32
    # int64 products wrap mod 2**64, which keeps their low 32 bits right
    h = (idx.to(torch.int64) * 0x9E3779B9 + (int(seed) & _U32)) & _U32
    h = ((h ^ (h >> 16)) * 0x7FEB352D) & _U32
    h = ((h ^ (h >> 15)) * 0x846CA68B) & _U32
    h = h ^ (h >> 16)
    bits = (bits + (h & 0xFFFF)) & 0xFFFF0000
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits).to(torch.int32)
    # the masked f32 is exactly representable in bf16
    return bits.view(torch.float32).to(torch.bfloat16)


def sr_seed(count: int, leaf_key: int) -> int:
    """The dither seed of one (step, leaf and moment): ``leaf_key`` is 2 i for
    the first and 2 i + 1 for the second moment of parameter i."""
    return _leaf_seed((count * 0x85EBCA6B) & _U32, leaf_key)


def _leaf_seed(step_word: int, leaf_key: int) -> int:
    """:func:`sr_seed` from the step's dither word ``count * 0x85EBCA6B``."""
    return (step_word + ((leaf_key * 0xC2B2AE35) & _U32)) & _U32


def _dtype(d) -> Optional[torch.dtype]:
    if d is None or d == "" or isinstance(d, torch.dtype):
        return d or None
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[str(d)]


class FusedAdamW:
    def __init__(self, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.01, moment_dtype=None, nu_dtype="same",
                 stochastic_round: bool = False):
        """``moment_dtype`` (None: f32) stores both moments in a lower
        precision while the update math stays f32; ``nu_dtype`` overrides the
        second moment's storage (``"same"`` follows ``moment_dtype``);
        ``stochastic_round`` rounds every bf16 moment store stochastically."""
        self.b1, self.b2, self.eps, self.wd = b1, b2, eps, weight_decay
        self.moment_dtype = _dtype(moment_dtype) or torch.float32
        self.nu_dtype = (self.moment_dtype if isinstance(nu_dtype, str) and nu_dtype == "same"
                         else _dtype(nu_dtype) or torch.float32)
        self.sr = bool(stochastic_round)
        self._staging: Dict[torch.device, Staging] = {}  # apply's step words, per card

    def init(self, params: Dict[str, torch.Tensor]) -> dict:
        """``{"count": 0, "mu": {name: zeros}, "nu": {name: zeros}}`` in the
        moments' dtypes."""
        def zeros(dtype):
            return {k: torch.zeros_like(p, dtype=dtype) for k, p in params.items()}

        return {"count": 0, "mu": zeros(self.moment_dtype), "nu": zeros(self.nu_dtype)}

    def _corrections(self, count: int):
        """Bias corrections in f32, as the JAX update computes them."""
        t = np.float32(count)
        return (float(np.float32(1.0) - np.float32(self.b1) ** t),
                float(np.float32(1.0) - np.float32(self.b2) ** t))

    def step_words(self, count: int, lr: float) -> np.ndarray:
        """Step ``count``'s four words (``ops.fused_adamw.step_words``): lr,
        its bias corrections and its dither word."""
        from simulgen_vae_tpu_torch.ops.fused_adamw import step_words

        return step_words(lr, *self._corrections(count), count)

    def apply(self, grads: Dict[str, torch.Tensor], state: dict,
              params: Dict[str, torch.Tensor], lr: float) -> torch.Tensor:
        """Update ``params`` and ``state`` in place from ``grads`` (same keys);
        returns the global gradient norm. CPU tensors take the plain version,
        CUDA tensors the kernel, with the step's words staged by one copy;
        anything else raises."""
        device = next(iter(params.values())).device
        if device.type == "cpu":
            return self.apply_reference(grads, state, params, lr)
        if device.type != "cuda":
            raise ValueError(f"no AdamW kernel for device type {device.type!r}")
        state["count"] += 1
        words = self.step_words(state["count"], lr)
        stage = self._staging.get(device)
        if stage is None:
            stage = self._staging[device] = Staging(len(words), device)
        stage.row()[:] = words
        return self.apply_staged(grads, state, params, stage.send())

    def apply_staged(self, grads: Dict[str, torch.Tensor], state: dict,
                     params: Dict[str, torch.Tensor], step: torch.Tensor) -> torch.Tensor:
        """:meth:`apply` with the step's four words already on the device
        (``step``, an ``int32`` [4] tensor of :meth:`step_words`, written by
        the caller, who advanced ``state["count"]`` with them). Reads nothing
        else from the host that changes between steps, so a captured call
        replays. On CPU tensors the plain version with the words' values."""
        names = list(params)
        if step.device.type == "cpu":
            lr, c1, c2 = (float(v) for v in step[:3].view(torch.float32))
            return self._reference(grads, state, params, lr, c1, c2,
                                   int(step[3]) & 0xFFFFFFFF)
        from simulgen_vae_tpu_torch.ops.fused_adamw import fused_adamw

        return fused_adamw(
            [params[k].data for k in names], [grads[k].float().contiguous() for k in names],
            [state["mu"][k] for k in names], [state["nu"][k] for k in names], step=step,
            b1=self.b1, b2=self.b2, eps=self.eps, weight_decay=self.wd,
            stochastic_round=self.sr)

    def _store(self, dst, src, step_word: int, key_offset: int) -> None:
        """Write the f32 moments ``src`` into their storage ``dst``."""
        if dst[0].dtype == torch.float32:
            return  # updated in place
        for i, (d, s) in enumerate(zip(dst, src)):
            if self.sr:
                idx = torch.arange(s.numel(), device=s.device).reshape(s.shape)
                d.copy_(sr_round_bf16(s, idx, _leaf_seed(step_word, 2 * i + key_offset)))
            else:
                d.copy_(s)

    def apply_reference(self, grads: Dict[str, torch.Tensor], state: dict,
                        params: Dict[str, torch.Tensor], lr: float) -> torch.Tensor:
        """The plain version of :meth:`apply`, on any device: ``_foreach``
        sweeps, every product and sum rounded on its own."""
        state["count"] += 1
        count = state["count"]
        return self._reference(grads, state, params, lr, *self._corrections(count),
                               sr_seed(count, 0))

    def _reference(self, grads, state, params, lr: float, c1: float, c2: float,
                   step_word: int) -> torch.Tensor:
        names = list(params)
        p = [params[k].data for k in names]
        g = [grads[k].float() for k in names]
        mu = [state["mu"][k] for k in names]
        nu = [state["nu"][k] for k in names]
        # f32 working moments: the stored tensors themselves when they are f32
        m = mu if self.moment_dtype == torch.float32 else [t.float() for t in mu]
        v = nu if self.nu_dtype == torch.float32 else [t.float() for t in nu]

        grad_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g)))
        torch._foreach_mul_(m, self.b1)
        torch._foreach_add_(m, torch._foreach_mul(g, 1.0 - self.b1))
        g2 = torch._foreach_mul(g, 1.0 - self.b2)
        torch._foreach_mul_(g2, g)
        torch._foreach_mul_(v, self.b2)
        torch._foreach_add_(v, g2)
        del g2
        upd = torch._foreach_div(m, c1)
        den = torch._foreach_div(v, c2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        torch._foreach_div_(upd, den)
        del den
        torch._foreach_add_(upd, torch._foreach_mul(p, self.wd))
        torch._foreach_mul_(upd, lr)
        torch._foreach_sub_(p, upd)
        del upd
        self._store(mu, m, step_word, 0)
        self._store(nu, v, step_word, 1)
        return grad_norm
