"""Build the hand-written CUDA kernels at first use and load them with ctypes.

Each ``ops/csrc/<name>.cu`` compiles on its own with ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface (no PyTorch headers, so a
build takes seconds). Libraries go to ``simulgen_vae_tpu_torch/_build/``
(git-ignored) under a name that carries a hash of the sources and flags, so
an edited source rebuilds and an unchanged one is reused. Nothing here runs
at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
KERNELS = ("gn_act_onepass", "gn_stats", "gn_apply", "gn_bwd_onepass", "gn_bwd_stats",
           "gn_bwd_apply", "gather_augment", "readout_matmul_stats", "readout_loss",
           "readout_bwd_stats", "readout_bwd_dy", "readout_bwd_fused", "fused_adamw",
           "field_epilogue", "recon_loss")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_LOG: dict[str, str] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def sources_of(source: Path) -> list[Path]:
    """``source`` and the headers of ``CSRC`` it includes, directly or through
    another (``#include "name.cuh"``), in the order first reached."""
    found, todo = [], [source]
    while todo:
        src = todo.pop(0)
        if src in found:
            continue
        found.append(src)
        todo += [CSRC / n for n in re.findall(r'^#include "([^"]+)"', src.read_text(), re.M)]
    return found


def library_path(name: str) -> Path:
    """Where ``name``'s library lives for the current sources and flags: a
    change to the source or to a header it includes rebuilds it (hopper.cuh,
    for one, rebuilds readout_matmul_stats and readout_bwd_fused)."""
    h = hashlib.sha256()
    for src in sources_of(CSRC / f"{name}.cu"):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=KERNELS) -> dict[str, float]:
    """Compile every missing library in ``names``, one ``nvcc`` each, all at
    once. Returns the seconds each build took (0 for one already built);
    raises with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    start = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    seconds = {name: 0.0 for name in names}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - start
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib
