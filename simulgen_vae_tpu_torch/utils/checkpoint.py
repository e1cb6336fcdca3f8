"""Checkpoints of the whole train state (``simulgen_vae_tpu/utils/checkpoint.py``
``CheckpointManager``), in a format of the port's own.

One file per saved epoch, ``ckpt_<epoch>.pt``: ``torch.save`` of the
parameters, the module's buffers (the image conditioners' BatchNorm running
statistics; none in the VAE), the AdamW moments in their dtype, the step count, the
spectral-norm ``u`` vectors, the epoch, and the trainer's generator states
(``VAETrainState.rng``), all on the CPU. A save copies the state to the host
once, writes to a temporary name and renames it, so a reader never sees half
a file; it is synchronous, and :meth:`CheckpointManager.wait` is there for the
interface. The newest ``max_to_keep`` files are kept. Reading the JAX
package's orbax checkpoints is not this module's job.

A state split over a mesh (``state.layout``, ``parallel.sharding``) is
saved whole, in the same format: rank 0 decides whether to save and tells
every rank, the blocks are gathered over the model axis, rank 0 writes the
file and every rank waits for it. Restore reads the file on every rank and
slices each rank's block, so a checkpoint moves between mesh shapes and one
device, as orbax reshards in JAX.

The trained models of ``model_save/`` (``SimulGen-VAE``,
``LatentConditioner``) are flax msgpack files: :func:`load_flax_model` and
:func:`save_flax_model` read and write them without flax
(``utils/msgpack_tree.py``). :func:`save_latents` and :func:`save_l2_loss`
write the training CLI's other artifacts in the JAX package's layout.
"""

from __future__ import annotations

import os
import re
from typing import Any, List, Optional

import numpy as np
import torch

from simulgen_vae_tpu_torch.utils import msgpack_tree

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


def _to_cpu(tree: dict) -> dict:
    return {k: v.detach().cpu() for k, v in tree.items()}


def _payload_trees(state: Any):
    """``(params, mu, nu, sn_u)`` of a state on one device."""
    return (dict(state.model.named_parameters()), state.opt_state["mu"],
            state.opt_state["nu"], state.sn_u)


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
        epoch is the newest one saved already. On a mesh every rank calls
        it: a collective."""
        layout = getattr(state, "layout", None)
        if layout is None:
            if not self._due(epoch, force):
                return False
            self._write(state, epoch, *_payload_trees(state))
            return True
        from simulgen_vae_tpu_torch.parallel import collectives, sharding

        mesh = layout.mesh
        everyone = mesh.everyone()
        device = next(state.model.parameters()).device
        if not collectives.broadcast_flag(mesh.rank == 0 and self._due(epoch, force),
                                          everyone, 0, device):
            return False
        if mesh.coords["data"] == 0:  # the first line of the model axis holds it all
            trees = sharding.gather_payload(state)
            if mesh.rank == 0:
                self._write(state, epoch, *trees)
        if everyone is not None:
            collectives.all_reduce_(torch.zeros(1, device=device), everyone)  # the file is there
        return True

    def _due(self, epoch: int, force: bool) -> bool:
        if not force and epoch % self.save_interval != 0:
            return False
        return self.latest_step() != epoch

    def _write(self, state: Any, epoch: int, params, mu, nu, sn_u) -> None:
        payload = {
            "params": _to_cpu(params),
            "buffers": _to_cpu(dict(state.model.named_buffers())),
            "mu": _to_cpu(mu),
            "nu": _to_cpu(nu),
            "count": int(state.opt_state["count"]),
            "sn_u": _to_cpu(sn_u),
            "epoch": int(state.epoch),
            "rng": state.rng,
        }
        tmp = self._path(epoch) + f".{os.getpid()}.tmp"
        torch.save(payload, tmp)
        os.replace(tmp, self._path(epoch))
        for old in self.steps()[:-self.max_to_keep] if self.max_to_keep else []:
            os.remove(self._path(old))

    def save(self, state: Any, epoch: int) -> None:
        self.maybe_save(state, epoch, force=True)

    def restore(self, state: Any, step: Optional[int] = None) -> Any:
        """Load the checkpoint of ``step`` (default: the newest) into ``state``
        (one from ``init_state`` works): its tensors are overwritten in place,
        on its device, and the same object is returned. A state split over a
        mesh receives its blocks of the whole tensors."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        payload = torch.load(self._path(step), map_location="cpu", weights_only=True)
        layout = getattr(state, "layout", None)
        if layout is not None:
            from simulgen_vae_tpu_torch.parallel import sharding

            for part, dims in (("params", layout.params), ("mu", layout.params),
                               ("nu", layout.params), ("sn_u", layout.sn_u)):
                payload[part] = {k: sharding.block(v, dims.get(k), layout.index, layout.parts)
                                 for k, v in payload[part].items()}
        with torch.no_grad():
            _copy_into(dict(state.model.named_parameters()), payload["params"], "params")
            _copy_into(dict(state.model.named_buffers()), payload.get("buffers", {}), "buffers")
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


def load_flax_model(path: str) -> dict:
    """A flax msgpack file (the JAX package's ``save_flax_model``) -> its
    variables as nested dicts of numpy arrays. No template: the caller checks
    the paths it needs."""
    return msgpack_tree.load(path)


def save_flax_model(path: str, tree: dict) -> None:
    """Write nested dicts of numpy arrays as flax's ``to_bytes`` does, so that
    the JAX package's ``load_flax_model`` reads them given a template."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        msgpack_tree.dump(tree, f)


def save_latents(save_dir: str, latent_vectors: np.ndarray,
                 hierarchical: np.ndarray) -> None:
    """``latent_vectors.npy`` [P, latent_dim_end] and ``xs.npy``
    [P, n_hier, latent_dim] in ``save_dir``."""
    os.makedirs(save_dir, exist_ok=True)
    np.save(os.path.join(save_dir, "latent_vectors"), latent_vectors)
    np.save(os.path.join(save_dir, "xs"), hierarchical)


def save_l2_loss(path: str, reconstruction_loss: np.ndarray) -> None:
    """The per-sample reconstruction MSEs, one ``%e`` line each
    (``SimulGen-VAE_L2_loss.txt``)."""
    np.savetxt(path, reconstruction_loss, fmt="%e")
