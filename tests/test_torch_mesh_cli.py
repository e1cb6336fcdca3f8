"""The port's training CLI on a mesh: two CPU ranks under
``torch.distributed.run`` (gloo), ``--mesh_data 2 --device cpu``, at the
geometry of ``tests/test_torch_cli_train.py`` (12 samples of 10 x 32,
encoder [16, 8], the CSV conditioner), 2 + 2 epochs.

A small runner starts each rank in a directory of its own holding the same
inputs, and sends its output to a log of its own, so that what each rank
writes can be told apart: rank 0 writes the JAX CLI's ``model_save/`` and
the loss file, rank 1 writes no file at all; both print the mesh, only rank
0 the epoch lines; the latents are finite and of the right shapes.
"""

import os
import shutil
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from tests.test_torch_cli_train import HIER, MODEL_SAVE, P, Z, _write_inputs

REPO = Path(__file__).resolve().parent.parent
RUNNER = """\
import os, runpy, sys
rank = int(os.environ["RANK"])
log = open(os.path.join(sys.argv[3], f"rank{rank}.log"), "w")
os.dup2(log.fileno(), 1)
os.dup2(log.fileno(), 2)
os.chdir(sys.argv[1 + min(rank, 1)])
sys.argv = ["simulgen_vae_tpu_torch"] + sys.argv[4:]
runpy.run_module("simulgen_vae_tpu_torch", run_name="__main__")
"""


def _files(root: Path) -> set:
    return {str(p.relative_to(root)) for p in root.rglob("*") if p.is_file()}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    base = tmp_path_factory.mktemp("mesh_cli")
    ranks = [_write_inputs(base / "rank0"), base / "rank1"]
    shutil.copytree(ranks[0], ranks[1])
    before = _files(ranks[1])
    logs = base / "logs"
    logs.mkdir()
    runner = base / "runner.py"
    runner.write_text(RUNNER)
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1",
           "MPLBACKEND": "Agg"}
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           "2", str(runner), str(ranks[0]), str(ranks[1]), str(logs), "--preset=1",
           "--plot=2", "--size=small", "--device", "cpu", "--no_preempt_guard",
           "--lc_only=0", "--mesh_data", "2", "--epochs", "2", "--lc_epochs", "2"]
    # a session of its own, so that a hung run's workers die with the launcher
    with subprocess.Popen(cmd, cwd=base, env=env, stdout=subprocess.PIPE,
                          stderr=subprocess.PIPE, text=True, start_new_session=True) as proc:
        try:
            out, err = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            raise
    texts = [(logs / f"rank{r}.log").read_text() for r in (0, 1)]
    assert proc.returncode == 0, (out[-3000:], err[-3000:], texts)
    return dict(ranks=ranks, texts=texts, before=before)


def test_both_ranks_train_on_the_mesh(run):
    for text in run["texts"]:
        assert "Mesh: {'data': 2, 'model': 1}" in text
        assert "Done." in text


def test_only_rank_0_writes(run):
    root0, root1 = run["ranks"]
    assert all((root0 / "model_save" / name).exists() for name in MODEL_SAVE)
    assert (root0 / "SimulGen-VAE_L2_loss.txt").exists()
    assert _files(root1) == run["before"]
    assert "[Epoch 2/2]" in run["texts"][0]
    assert "[Epoch" not in run["texts"][1]


def test_latents_are_finite_and_shaped(run):
    root0 = run["ranks"][0]
    latents = np.load(root0 / "model_save" / "latent_vectors.npy")
    xs = np.load(root0 / "model_save" / "xs.npy")
    assert latents.shape == (P, Z) and np.isfinite(latents).all()
    assert xs.shape[0] == P and xs.shape[-1] == HIER and np.isfinite(xs).all()
    losses = np.loadtxt(root0 / "SimulGen-VAE_L2_loss.txt")
    assert losses.shape == (P,) and np.isfinite(losses).all()
