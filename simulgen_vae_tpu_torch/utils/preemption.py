"""Preemption-safe training: SIGTERM -> checkpoint -> clean resume
(the port's own copy of ``simulgen_vae_tpu/utils/preemption.py``).

Cluster schedulers deliver SIGTERM with a short grace window before they kill
a preempted worker. A process-global guard turns the signal into a
cooperative stop: every trainer's ``fit`` loop polls :func:`requested` at its
host-visible boundary, force-saves the full train state through its
``CheckpointManager`` and returns early. A caller can then exit with
``EX_TEMPFAIL`` (75) so that a scheduler requeues the job; the rerun restores
the state and continues from that epoch.

Design notes:

* A signal handler runs on the main thread between bytecodes and must not
  touch the device. It only flips a flag; the training loop, already at a
  safe boundary when it polls, does the save.
* A second SIGTERM restores the previous handler and re-raises the signal:
  if the grace window is too short for a checkpoint the process still dies
  fast instead of looping.
* ``install`` is idempotent and chainable: the prior handler is kept and put
  back by :func:`uninstall` (tests restore state between cases).
* The response waits for one host-visible span: up to ``val_every`` epochs
  run between two polls. Where a scheduler's grace window is shorter than
  that, lower ``val_every`` or checkpoint more often.
"""

from __future__ import annotations

import os
import signal
import threading
from typing import Iterable

EX_TEMPFAIL = 75  # BSD sysexits: "temp failure; user is invited to retry"

_lock = threading.Lock()
_requested = False
_prev_handlers: dict = {}


def _handler(signum, frame):
    # Lock-free on purpose: the handler runs on the main thread between
    # bytecodes, so taking _lock here would deadlock if the signal lands while
    # the main thread is inside one of the locked sections below. Plain bool
    # loads and stores are atomic under the GIL.
    global _requested
    if _requested:
        # Second signal: stop cooperating, die the default way.
        prev = _prev_handlers.get(signum, signal.SIG_DFL)
        signal.signal(signum, prev if callable(prev) or prev in (
            signal.SIG_DFL, signal.SIG_IGN) else signal.SIG_DFL)
        os.kill(os.getpid(), signum)
        return
    _requested = True


def install(signals: Iterable[int] = (signal.SIGTERM,)) -> None:
    """Install the cooperative-stop handler (idempotent). Only the main thread
    may install signal handlers; on a worker thread this does nothing (the
    flag can still be set through :func:`request`)."""
    if threading.current_thread() is not threading.main_thread():
        return
    with _lock:
        for sig in signals:
            if sig not in _prev_handlers:
                _prev_handlers[sig] = signal.signal(sig, _handler)


def uninstall() -> None:
    """Restore the previous handlers and clear the flag."""
    global _requested
    with _lock:
        for sig, prev in _prev_handlers.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, TypeError):
                signal.signal(sig, signal.SIG_DFL)
        _prev_handlers.clear()
        _requested = False


def request() -> None:
    """Set the stop flag from the program itself (tests, in-process schedulers)."""
    global _requested
    with _lock:
        _requested = True


def clear() -> None:
    global _requested
    with _lock:
        _requested = False


def requested() -> bool:
    """True once a preemption signal (or :func:`request`) arrived. Trainers
    poll this at epoch boundaries; it never blocks and never touches the
    device."""
    return _requested


def exit_code(default: int = 0) -> int:
    """75 (EX_TEMPFAIL) when preempted, else ``default``."""
    return EX_TEMPFAIL if _requested else default
