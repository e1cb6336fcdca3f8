"""The port stands alone: no JAX, flax or JAX-package import, nor msgpack,
sklearn, pandas or ml_dtypes, which the card's machine lacks, and matplotlib, PIL,
tensorboardX and OpenCV (also absent there) only inside the functions that use
them; and its entry points refuse to fall back to the CPU when CUDA was asked
for and is absent."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "simulgen_vae_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "simulgen_vae_tpu", "scripts",
             "msgpack", "sklearn", "pandas", "ml_dtypes")
LAZY = ("matplotlib", "PIL", "tensorboardX", "cv2")


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield path, ".".join(parts)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_importing_every_module_loads_no_jax():
    names = [name for _, name in _modules()]
    code = (
        "import sys\n"
        f"for m in {names!r}: __import__(m)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN + LAZY!r}]\n"
        "from simulgen_vae_tpu_torch.ops import _build\n"
        "assert not _build._LIBS, 'a kernel library was loaded at import time'\n"
        "print('BAD', bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, env=_env(), timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


@pytest.mark.parametrize("path", [p for p, _ in _modules()] + [REPO / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_forbidden_import_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots = [node.module.split(".")[0]]
        else:
            continue
        assert not set(roots) & set(FORBIDDEN), f"{path}:{node.lineno} imports {roots}"


@pytest.mark.parametrize("path", [p for p, _ in _modules()],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_plotting_and_tensorboard_are_imported_inside_functions(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in tree.body:   # the module's own statements, not function bodies
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            continue
        for sub in ast.walk(node):
            if isinstance(sub, ast.Import):
                roots = [a.name.split(".")[0] for a in sub.names]
            elif isinstance(sub, ast.ImportFrom) and sub.level == 0:
                roots = [sub.module.split(".")[0]]
            else:
                continue
            assert not set(roots) & set(LAZY), f"{path}:{sub.lineno} imports {roots}"


def test_the_stack_modules_are_among_those_checked():
    names = {name for _, name in _modules()}
    for mod in ("ops.fused_adamw", "train.nan_guard", "train.optim", "utils.checkpoint",
                "utils.preemption", "train.vae_trainer", "utils.msgpack_tree", "ops.quant",
                "data.images", "data.scaler", "generate", "cli", "__main__",
                "train.lc_trainer", "data.dataset", "evaluation.evaluator",
                "evaluation.reconstruction", "evaluation.plotter", "utils.logging",
                "utils.summary", "models.conditioner_cnn", "models.conditioner_simple_cnn",
                "models.conditioner_vit", "models.flax_layers", "data.image_augmentation",
                "train.lc_e2e_trainer"):
        assert f"simulgen_vae_tpu_torch.{mod}" in names


# The serving layer and the CLI sit on top: only they, ``__main__`` and the
# package's own ``__init__`` name them (the package imports absolutely).
TOP = ("simulgen_vae_tpu_torch.generate", "simulgen_vae_tpu_torch.cli")
ABOVE_SERVING = {PKG / "generate.py", PKG / "cli.py", PKG / "__main__.py", PKG / "__init__.py"}


def test_nothing_below_serving_imports_it():
    offenders = []
    for path, _ in _modules():
        if path in ABOVE_SERVING:
            continue
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module] + [f"{node.module}.{a.name}" for a in node.names]
            else:
                continue
            if any(n == top or n.startswith(top + ".") for n in names for top in TOP):
                offenders.append(f"{path.relative_to(REPO)}:{node.lineno} imports {names[0]}")
    assert not offenders, offenders


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    from simulgen_vae_tpu_torch import generate as tgen
    from simulgen_vae_tpu_torch.utils import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgen.auto_max_batch(200, 95008)
    assert resolve_device("cpu").type == "cpu"


def test_make_pipeline_raises_without_cuda(monkeypatch):
    from simulgen_vae_tpu_torch import generate as tgen
    from simulgen_vae_tpu_torch.config import LCConfig, VAEConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgen.make_pipeline(VAEConfig(), LCConfig(), {"decoder": {}}, {},
                           None, None, None)


def test_chip_smoke_fails_without_a_card(tmp_path):
    """Without CUDA the smoke script exits non-zero and prints no result;
    alone in a directory (no package beside it) it fails too."""
    env = _env()
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], cwd=REPO,
                         capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout

    (tmp_path / "chip_smoke.py").write_text((REPO / "chip_smoke.py").read_text())
    env.pop("PYTHONPATH")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
