"""BENCHMARK.json against the benchmark's contract, and the harness's
look-up of cells, configurations and metrics by name."""

from __future__ import annotations

import ast
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from conftest import BENCH, ROOT, bench_spec
from pbcore import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def test_names_units_and_keys():
    b = bench_spec()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] in (1, 4) and TEXT.match(w["why"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert TEXT.match(m["layer"])
    names = [x["name"] for x in b["configs"] + b["workloads"]] + \
        [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    assert len(json.dumps(b)) < 64 * 1024


def test_every_name_has_its_file():
    b = bench_spec()
    for c in b["configs"]:
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).exists()
        assert c["name"] in {w["config"] for w in b["workloads"]}
    for w in b["workloads"]:
        wl = harness.load_json(BENCH / "workloads" / f"{w['traffic']}.json")
        assert (BENCH / "drivers" / f"{wl['driver']}.py").exists()
    for m in b["end_to_end"]:
        assert harness.reader_path(BENCH / "e2e_metrics", m["name"]).exists()
    for m in b["per_layer"]:
        assert harness.reader_path(BENCH / "layer_metrics", m["name"]).exists()
    for path in BENCH.rglob("*"):
        if "__pycache__" not in path.parts:
            assert re.match(r"^[A-Za-z0-9_./-]+$", str(path.relative_to(ROOT))), path


def test_a_reader_serves_its_quantity(tmp_path):
    """``<quantity>.<cells>`` is read by ``<quantity>.py`` unless a file of
    the whole name exists."""
    (tmp_path / "mfu.py").write_text("")
    assert harness.reader_path(tmp_path, "mfu.serve") == tmp_path / "mfu.py"
    assert harness.reader_path(tmp_path, "mfu.serve.b8") == tmp_path / "mfu.py"
    (tmp_path / "mfu.serve.py").write_text("")
    assert harness.reader_path(tmp_path, "mfu.serve.b8") == tmp_path / "mfu.serve.py"
    assert not harness.reader_path(tmp_path, "idle_share.train").exists()


def test_each_cell_reports_enough():
    b = bench_spec()
    for w in b["workloads"]:
        e2e = {m["name"] for m in harness.reported(b["end_to_end"], w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.layer_metrics_of(b, w["name"])


def test_layer_metrics_cells_report_what_they_move():
    b = bench_spec()
    for m in b["per_layer"]:
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}
        for cell in m.get("workloads", []):
            e2e = {e["name"] for e in harness.reported(b["end_to_end"], cell)}
            assert m["moves"] in e2e, (m["name"], cell)
        layers = {x["layer"] for x in b["per_layer"]}
        assert m["layer"] in layers


def test_a_new_workload_file_is_found_by_name(tmp_path):
    """A later change adds a cell as files and an entry; nothing else moves."""
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = bench_spec()
    b["workloads"].append({"name": "serve.embed_detect.b16", "config": "waveverify_base_r5",
                           "traffic": "serve.embed_detect.b16", "chips": 1,
                           "why": "a smaller batch"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    (tmp_path / "portbench" / "workloads" / "serve.embed_detect.b16.json").write_text(
        json.dumps({"driver": "serve_batch", "batch": 16, "clip_s": 1.0, "pool": 2}))
    code = (
        "import sys; sys.path.insert(0, 'portbench')\n"
        "from pbcore import harness\n"
        "b = harness.load_json(harness.ROOT / 'BENCHMARK.json')\n"
        "e = harness.cell_entry(b, 'serve.embed_detect.b16')\n"
        "wl = harness.load_json(harness.BENCH_DIR / 'workloads' / (e['traffic'] + '.json'))\n"
        "mod = harness.load_module(harness.BENCH_DIR / 'drivers' / (wl['driver'] + '.py'))\n"
        "print(wl['batch'], mod.Driver.__name__, harness.config_entry(b, e['config'])['file'],\n"
        "      sorted(m['name'] for m in harness.layer_metrics_of(b, e['name'])))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=120, env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("16 Driver portbench/configs/waveverify_base_r5.json")


def _run(cwd: Path, env_extra: dict) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "serve.embed_detect.b64",
         "--seed", "4294967311", "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env={**os.environ, **env_extra})


def test_run_fails_without_a_card():
    out = _run(ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


def test_run_fails_with_the_benchmark_alone(tmp_path):
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = _run(tmp_path, {"CUDA_VISIBLE_DEVICES": "", "PYTHONPATH": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("folder", ["", "reference"])
def test_imports(folder):
    """Nothing under portbench imports JAX or the JAX package (whole
    top-level names: the port's name begins with the JAX package's); the
    reference imports nothing of the port either."""
    banned = {"jax", "jaxlib", "flax", "waveverify_tpu"}
    if folder == "reference":
        banned.add("waveverify_torch")
    files = list((BENCH / folder).rglob("*.py"))
    assert files
    for f in files:
        found = set(_imports(f)) & banned
        assert not found, (f, found)


def test_foreign_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "waveverify_tpu_extra", sys)
    assert "waveverify_tpu" not in harness.foreign_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in harness.foreign_modules()
