"""Run a function on several ranks, one spawned process each, with a time limit.

    spawn_ranks(fn, world=2, timeout=120, x=1)

calls ``fn(rank, world, init_method, x=1)`` in ``world`` processes
(``torch.multiprocessing.start_processes``) and returns what each returned,
in rank order. ``fn`` must be importable by name; ``init_method`` is a
``file://`` rendezvous in a fresh directory, for
``parallel.initialize_distributed``. A rank that raises stops the others and
raises here with its traceback; ranks that outlive ``timeout`` (a hung
rendezvous or collective) are killed and raise ``TimeoutError``. With
``log_dir`` each rank's output goes to ``rank<r>.log`` there. The CPU tests
drive gloo meshes with it, and ``chip_smoke.py`` rehearses several ranks on
one card; ``torchrun`` is the launcher for real runs.
"""

import os
import sys
import tempfile
import time

import torch
import torch.multiprocessing as mp


def _rank(rank, fn, world, init, kwargs, tmp, log_dir):
    if log_dir is not None:
        log = os.open(os.path.join(log_dir, f"rank{rank}.log"),
                      os.O_WRONLY | os.O_CREAT | os.O_TRUNC)
        sys.stdout.flush()
        sys.stderr.flush()
        os.dup2(log, 1)
        os.dup2(log, 2)
    torch.save(fn(rank, world, init, **kwargs), os.path.join(tmp, f"rank{rank}.pt"))


def spawn_ranks(fn, world, timeout, log_dir=None, **kwargs):
    with tempfile.TemporaryDirectory() as tmp:
        init = f"file://{os.path.join(tmp, 'rendezvous')}"
        ctx = mp.start_processes(_rank, (fn, world, init, kwargs, tmp, log_dir), nprocs=world,
                                 join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(max(deadline - time.monotonic(), 0.0)):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"{fn.__name__}: the ranks did not finish within "
                                       f"{timeout:.0f} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]
