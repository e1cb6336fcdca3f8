"""The port's ``utils/profiling.py`` against the JAX package's, on the CPU.

The CPU device reports no memory statistics in either framework, so
``device_memory_mb`` gives JAX's three keys at zero; ``trace`` writes a
Chrome trace of the block.
"""

import contextlib
import json

import numpy as np
import pytest
import torch

from simulgen_vae_tpu.utils import profiling as jprof
from simulgen_vae_tpu_torch.utils import profiling


def test_device_memory_keys_and_values_equal_jax_on_the_cpu():
    got, want = profiling.device_memory_mb("cpu"), jprof.device_memory_mb()
    assert got == want == {"bytes_in_use_mb": 0.0, "peak_bytes_in_use_mb": 0.0,
                           "bytes_limit_mb": 0.0}


def test_device_memory_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profiling.device_memory_mb()


@pytest.mark.parametrize("fails", [False, True], ids=["ok", "raises"])
def test_trace_writes_a_chrome_trace(tmp_path, fails):
    """One file holding the block's operators, also when the block raises."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((64, 64)).astype(np.float32))
    with pytest.raises(ValueError) if fails else contextlib.nullcontext():
        with profiling.trace(str(tmp_path)) as prof:
            (x @ x).sum()
            if fails:
                raise ValueError("in the block")
    files = list(tmp_path.iterdir())
    assert len(files) == 1 and files[0].name.startswith("trace-") and files[0].suffix == ".json"
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("cat") == "cpu_op" and e.get("name") == "aten::mm" for e in events)
    assert any(e.key == "aten::mm" for e in prof.key_averages())

