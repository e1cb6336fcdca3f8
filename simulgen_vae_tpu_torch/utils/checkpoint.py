"""Checkpoints of the whole train state (``simulgen_vae_tpu/utils/checkpoint.py``
``CheckpointManager``), in a format of the port's own.

One file per saved epoch, ``ckpt_<epoch>.pt``: ``torch.save`` of the
parameters, the AdamW moments in their dtype, the step count, the
spectral-norm ``u`` vectors, the epoch, and the trainer's generator states
(``VAETrainState.rng``), all on the CPU. A save copies the state to the host
once, writes to a temporary name and renames it, so a reader never sees half
a file; it is synchronous, and :meth:`CheckpointManager.wait` is there for the
interface. The newest ``max_to_keep`` files are kept. Reading the JAX
package's orbax checkpoints is not this module's job.
"""

from __future__ import annotations

import os
import re
from typing import Any, List, Optional

import torch

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


def _to_cpu(tree: dict) -> dict:
    return {k: v.detach().cpu() for k, v in tree.items()}


def _copy_into(dst: dict, src: dict, what: str) -> None:
    if set(dst) != set(src):
        raise ValueError(f"checkpoint {what} keys differ from the state's")
    for k, t in dst.items():
        if t.shape != src[k].shape or t.dtype != src[k].dtype:
            raise ValueError(f"checkpoint {what}[{k}] is {src[k].dtype} "
                             f"{tuple(src[k].shape)}, the state holds {t.dtype} "
                             f"{tuple(t.shape)}")
        t.copy_(src[k])


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3,
                 save_interval_epochs: int = 50):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.save_interval = save_interval_epochs

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step:08d}.pt")

    def steps(self) -> List[int]:
        """The saved epochs, oldest first."""
        found = (_NAME.match(name) for name in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def maybe_save(self, state: Any, epoch: int, force: bool = False) -> bool:
        """Save at multiples of the interval (or when forced), unless this
        epoch is the newest one saved already."""
        if not force and epoch % self.save_interval != 0:
            return False
        if self.latest_step() == epoch:
            return False
        payload = {
            "params": _to_cpu(dict(state.model.named_parameters())),
            "mu": _to_cpu(state.opt_state["mu"]),
            "nu": _to_cpu(state.opt_state["nu"]),
            "count": int(state.opt_state["count"]),
            "sn_u": _to_cpu(state.sn_u),
            "epoch": int(state.epoch),
            "rng": state.rng,
        }
        tmp = self._path(epoch) + f".{os.getpid()}.tmp"
        torch.save(payload, tmp)
        os.replace(tmp, self._path(epoch))
        for old in self.steps()[:-self.max_to_keep] if self.max_to_keep else []:
            os.remove(self._path(old))
        return True

    def save(self, state: Any, epoch: int) -> None:
        self.maybe_save(state, epoch, force=True)

    def restore(self, state: Any, step: Optional[int] = None) -> Any:
        """Load the checkpoint of ``step`` (default: the newest) into ``state``
        (one from ``init_state`` works): its tensors are overwritten in place,
        on its device, and the same object is returned."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        payload = torch.load(self._path(step), map_location="cpu", weights_only=True)
        with torch.no_grad():
            _copy_into(dict(state.model.named_parameters()), payload["params"], "params")
            _copy_into(state.opt_state["mu"], payload["mu"], "mu")
            _copy_into(state.opt_state["nu"], payload["nu"], "nu")
            _copy_into(state.sn_u, payload["sn_u"], "sn_u")
        state.opt_state["count"] = payload["count"]
        state.epoch = payload["epoch"]
        state.rng = payload["rng"]
        return state

    def wait(self) -> None:
        """Saves are synchronous: nothing to wait for."""

    def close(self) -> None:
        """Nothing is held open."""
