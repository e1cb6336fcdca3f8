"""``BENCHMARK.json`` against the benchmark's contract, and the harness's
finding of a cell's files by name."""

import ast
import json
import re
import shutil
import subprocess
import sys

import pytest

from benchlib import harness, work

BENCH_DIR = harness.BENCH_DIR
ROOT = harness.ROOT
MAN = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
FORBIDDEN = {"jax", "jaxlib", "flax", "simulgen_vae_tpu"}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert MAN["paths"] == ["bench_port"] and not BENCH_DIR.name.endswith("_torch")
    assert 1 <= len(MAN["command"]) <= 32 and all(_line(w) for w in MAN["command"])
    assert (ROOT / MAN["command"][1]).resolve().is_relative_to(BENCH_DIR)
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_budget_of_a_full_check_fits_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (MAN["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_single_lines():
    entries = MAN["configs"] + MAN["workloads"] + MAN["end_to_end"] + MAN["per_layer"]
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in MAN[group]]
        assert len(names) == len(set(names)), group
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for w in MAN["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["chips"] == 1
    for c in MAN["configs"]:
        assert _line(c["source"]) and c["source"].startswith("https://")
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for m in MAN["per_layer"]:
        assert _line(m["layer"])


def test_entries_have_just_the_contract_keys():
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in MAN["end_to_end"])
    for w in MAN["workloads"]:
        e2e, layer = harness.cell_metrics(MAN, w["name"])
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2 and layer, w["name"]


def test_each_per_layer_metric_moves_an_end_to_end_metric_its_cells_report():
    for m in MAN["per_layer"]:
        for cell in m["workloads"]:
            e2e, _ = harness.cell_metrics(MAN, cell)
            assert m["moves"] in {e["name"] for e in e2e}, (m["name"], cell)


def test_every_cell_finds_its_files_by_name():
    for w in MAN["workloads"]:
        workload, config = harness.cell_files(w["name"])
        assert workload["config"] == w["config"] == config["name"]
        assert workload["traffic"] == w["traffic"]
        assert hasattr(harness.driver(workload["driver"]), "run")
        _, layer = harness.cell_metrics(MAN, w["name"])
        for m in layer:
            assert hasattr(harness.reader(m["name"]), "read"), m["name"]


def test_configuration_files_state_source_reduced_assumed_and_bytes():
    files = [c["file"] for c in MAN["configs"]]
    assert len(files) == len(set(files))
    for c in MAN["configs"]:
        path = ROOT / c["file"]
        assert path.resolve().is_relative_to(BENCH_DIR) and path.name == f"{c['name']}.json"
        cfg = json.loads(path.read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] == []
        assert cfg["assumed"] and cfg["device_bytes"]["ensemble_bf16"] > 0
        assert any(w["config"] == c["name"] for w in MAN["workloads"])


def test_a_configuration_and_cell_added_as_files_are_found_without_an_edit(tmp_path):
    copy = tmp_path / "checkout"
    shutil.copytree(BENCH_DIR, copy / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((BENCH_DIR / "configs" / "vae_flagship_t200.json").read_text())
    cfg.update(name="vae_other", num_time=100)
    (copy / "bench_port" / "configs" / "vae_other.json").write_text(json.dumps(cfg))
    (copy / "bench_port" / "traffic" / "sweep_32.json").write_text(json.dumps(
        dict(json.loads((BENCH_DIR / "traffic" / "sweep_128.json").read_text()),
             rows_per_request=32)))
    (copy / "bench_port" / "workloads" / "serve_sweep_t100.json").write_text(json.dumps(
        {"config": "vae_other", "traffic": "sweep_32", "limits": {"field_gap": 0.1}}))
    (copy / "bench_port" / "metrics" / "requests.sweep.py").write_text(
        "def read(run):\n    return run.attempted\n")
    man["configs"].append({"name": "vae_other", "source": "https://example.org/other",
                           "file": "bench_port/configs/vae_other.json", "reduced": [],
                           "why": "another length"})
    man["workloads"].append({"name": "serve_sweep_t100", "config": "vae_other",
                             "traffic": "sweep_32", "chips": 1, "why": "a sweep at T = 100"})
    for m in man["end_to_end"]:
        if m["name"] == "serve_fields_per_s":
            m["workloads"].append("serve_sweep_t100")
    man["per_layer"].append({"name": "requests.sweep", "unit": "requests", "better": "higher",
                             "source": "program_counter", "layer": "serving entry",
                             "moves": "serve_fields_per_s",
                             "workloads": ["serve_sweep_t100"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(man))
    probe = (
        "import sys; sys.path[:0] = [sys.argv[1] + '/bench_port', sys.argv[1]]\n"
        "from benchlib import harness\n"
        "wl, cfg = harness.cell_files('serve_sweep_t100')\n"
        "e2e, layer = harness.cell_metrics(harness.manifest(), 'serve_sweep_t100')\n"
        "d = harness.driver(wl['driver'])\n"
        "r = harness.reader('requests.sweep').read(type('O', (), {'attempted': 7})())\n"
        "print(cfg['num_time'], wl['rows_per_request'], sorted(m['name'] for m in e2e),"
        " [m['name'] for m in layer], r, hasattr(d, 'run'))\n")
    out = subprocess.run([sys.executable, "-c", probe, str(copy)], capture_output=True,
                         text=True, check=True).stdout.split()
    assert out[:2] == ["100", "32"]
    assert "['serve_fields_per_s'," in out and "['requests.sweep']" in out
    assert out[-2:] == ["7", "True"]


@pytest.mark.parametrize("t, step_tflop, field_gflop", [(200, 7.648, 118.5), (50, 1.912, 29.6)])
def test_frozen_flop_model_gives_the_issue_numbers(t, step_tflop, field_gflop):
    cfg = dict(num_time=t, num_node=95008, num_filter_enc=[1024, 512, 256, 128],
               latent_dim_end=32, latent_dim=8)
    assert work.train_step_flops(cfg, 16) / 1e12 == pytest.approx(step_tflop, abs=5e-4)
    assert work.field_flops(cfg) / 1e9 == pytest.approx(field_gflop, abs=0.05)


def test_groupnorm_maps_of_a_step_and_a_decode():
    cfg = json.loads((BENCH_DIR / "configs" / "vae_flagship_t200.json").read_text())
    assert len(work.gn_maps(cfg, 16, train=True)) == 25
    assert len(work.gn_maps(cfg, 16, train=False)) == 17
    assert work.adamw_bytes(403486656) == 403486656 * 28


def _modules():
    mods = ["benchlib." + p.stem for p in (BENCH_DIR / "benchlib").glob("*.py")]
    mods += ["reference." + p.stem for p in (BENCH_DIR / "reference").glob("*.py")]
    return sorted(mods)


def test_nothing_of_the_benchmark_loads_jax_or_the_jax_package():
    files = [str(p) for sub in ("drivers", "metrics") for p in (BENCH_DIR / sub).glob("*.py")]
    probe = (
        "import sys, runpy; sys.path[:0] = [sys.argv[1], sys.argv[2]]\n"
        "import importlib\n"
        "for m in sys.argv[3].split(','): importlib.import_module(m)\n"
        "from benchlib import harness\n"
        "for i, f in enumerate(sys.argv[4:]): harness.load_module(__import__('pathlib').Path(f), f'm{i}')\n"
        "print(sorted({n.split('.')[0] for n in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", probe, str(BENCH_DIR), str(ROOT),
                          ",".join(_modules()), *files], capture_output=True, text=True,
                         check=True).stdout
    loaded = set(ast.literal_eval(out.strip().splitlines()[-1]))
    assert not loaded & FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH_DIR / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] in {"torch", "numpy", "math", "__future__",
                                           "reference"}, (path.name, n)
    probe = ("import sys; sys.path.insert(0, sys.argv[1])\n"
             "import reference.vae, reference.train, reference.batch, reference.conditioner,"
             " reference.lowp\n"
             "print(sorted({n.split('.')[0] for n in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", probe, str(BENCH_DIR)], capture_output=True,
                         text=True, check=True).stdout
    loaded = set(ast.literal_eval(out.strip().splitlines()[-1]))
    assert not loaded & (FORBIDDEN | {"simulgen_vae_tpu_torch", "benchlib"})


def test_a_run_without_a_card_fails_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is there: the run would measure")
    proc = subprocess.run([sys.executable, str(BENCH_DIR / "run.py"), "--workload",
                           "train_t200", "--seed", "3000000001", "--seconds", "1"],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert not any(line.startswith("{") for line in proc.stdout.splitlines())


def test_parked_cells_find_their_files_by_name():
    """Cells with files but no entry in BENCHMARK.json (PERF.md, Open
    questions) stay ready to be added by entries alone."""
    listed = {w["name"] for w in MAN["workloads"]}
    parked = sorted(p.stem for p in (BENCH_DIR / "workloads").glob("*.json")
                    if p.stem not in listed)
    assert parked == ["serve_interactive_t50"]
    for cell in parked:
        workload, config = harness.cell_files(cell)
        assert hasattr(harness.driver(workload["driver"]), "run")
        assert workload["limits"] and config["name"] == workload["config"]
    for metric in ("device_idle.interactive", "launch_calls.interactive"):
        assert hasattr(harness.reader(metric), "read")
