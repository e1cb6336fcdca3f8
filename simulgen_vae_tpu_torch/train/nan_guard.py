"""Divergence detection and checkpoint rollback for the trainers
(``simulgen_vae_tpu/train/nan_guard.py``).

A trainer checks the train loss at its host-visible boundaries (the values
are read there anyway) and on a non-finite one rolls back to the last
checkpoint and retries with the randomness that follows, a bounded number of
times. A poisoned state is never checkpointed: the check runs before
``maybe_save``.
"""

from __future__ import annotations

from typing import Dict, Tuple


def rollback(poisoned_state, epoch: int, base_epoch: int, history: Dict,
             ckpt_manager, retries: int, max_retries: int,
             stage: str = "train",
             fallback_state=None) -> Tuple[object, int, Dict]:
    """Restore the last checkpoint and rewind the epoch counter.

    ``poisoned_state`` is the restore template (its tensors are overwritten).
    Returns ``(restored_state, rewound_epoch, trimmed_history)``; raises
    RuntimeError when there is nothing to roll back to or the retry budget is
    spent. ``fallback_state`` (a best state kept in memory, say) is used when
    no checkpoint exists. The caller's generators have already advanced past
    the failed span, so the retry sees other shuffles and augmentations.
    """
    at_epoch = base_epoch + epoch
    if retries >= max_retries:
        raise RuntimeError(
            f"nan_guard[{stage}]: non-finite train loss at epoch {at_epoch} "
            f"persisted through {max_retries} rollback retries — lower the "
            "learning rate or inspect the data for out-of-range values")
    if ckpt_manager is not None and ckpt_manager.latest_step() is not None:
        ckpt_manager.wait()
        restored = ckpt_manager.restore(poisoned_state)
        source = f"checkpointed epoch {int(restored.epoch)}"
    elif fallback_state is not None:
        restored = fallback_state
        source = f"in-memory best state (epoch {int(restored.epoch)})"
    else:
        raise RuntimeError(
            f"nan_guard[{stage}]: non-finite train loss at epoch {at_epoch} "
            "and no checkpoint to roll back to (pass ckpt_manager= to make "
            "divergence recoverable, or nan_guard=False to disable "
            "detection)")
    new_epoch = min(max(int(restored.epoch) - base_epoch, 0), epoch)
    print(f"[nan_guard:{stage}] non-finite train loss at epoch {at_epoch}; "
          f"rolled back to {source} (retry {retries + 1}/{max_retries})",
          flush=True)
    history = {k: v[:new_epoch] for k, v in history.items()}
    return restored, new_epoch, history
