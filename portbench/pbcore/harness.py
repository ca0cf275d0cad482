"""One run of one cell: find its files by name, set up, measure, check,
and build the result line.

Everything that belongs to one cell, configuration or metric is a file of
its own, found by the name ``BENCHMARK.json`` gives it:

- ``portbench/workloads/<traffic>.json``: a cell's traffic, and the
  driver that makes it;
- ``portbench/drivers/<driver>.py``: a ``Driver`` class (``setup``,
  ``run_window``, ``release``, ``check``);
- a configuration's ``file``, as ``BENCHMARK.json`` names it;
- ``portbench/e2e_metrics/<metric>.py`` and
  ``portbench/layer_metrics/<metric>.py``: a ``read(record)`` that returns
  the metric's value, or None where the run holds nothing to read. One
  reader serves every metric of its quantity: ``idle_share.train`` is
  read by ``idle_share.py`` where no ``idle_share.train.py`` exists.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional

from pbcore.trace import Tracer

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
OUT_DIR = ROOT / "build" / "portbench"
FOREIGN = ("jax", "jaxlib", "flax", "waveverify_tpu")


def load_json(path: Path) -> Any:
    return json.loads(Path(path).read_text())


def load_module(path: Path) -> ModuleType:
    """Import a file of the benchmark by path (names may hold dots)."""
    name = "pb_" + path.stem.replace(".", "_").replace("-", "_") + "_" + path.parent.name
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader_path(folder: Path, metric: str) -> Path:
    """The reader of ``metric`` in ``folder``: ``<metric>.py``, else the
    file of the name with its last dotted parts taken off, one by one
    (``mfu.serve`` -> ``mfu.py``)."""
    name = metric
    while True:
        path = folder / f"{name}.py"
        if path.exists() or "." not in name:
            return path
        name = name.rsplit(".", 1)[0]


def cell_entry(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_entry(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def reported(metrics: List[dict], cell: str) -> List[dict]:
    """The metrics of a list that a cell reports: those without a
    ``workloads`` key, and those that list the cell."""
    return [m for m in metrics if cell in m.get("workloads", [cell])]


def layer_metrics_of(bench: dict, cell: str) -> List[dict]:
    """The per-layer metrics a cell reports: those that list it, and those
    without a list whose end-to-end metric the cell reports."""
    e2e = {m["name"] for m in reported(bench["end_to_end"], cell)}
    return [m for m in bench["per_layer"]
            if ("workloads" in m and cell in m["workloads"])
            or ("workloads" not in m and m["moves"] in e2e)]


def foreign_modules() -> List[str]:
    """Top-level names in ``sys.modules`` that the port must not load."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FOREIGN))


@dataclass
class Context:
    """What a driver is given."""

    cell: str
    seed: int
    device: Any
    config: dict
    workload: dict
    tracer: Tracer
    root: Path = ROOT


def card_info() -> Dict[str, str]:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return {}
    if not out:
        return {}
    name, _, limit = out[0].partition(",")
    return {"name": name.strip(), "power_limit": limit.strip()}


def run_cell(bench: dict, cell: str, seed: int, seconds: float, trace: bool,
             device, t_start: float, config: Optional[dict] = None,
             workload: Optional[dict] = None) -> Dict[str, Any]:
    """Set up, measure and check one cell; returns the result line's dict
    (the numbers compared last). ``config`` / ``workload`` replace the
    cell's files (the tests run small ones on the CPU)."""
    import torch

    entry = cell_entry(bench, cell)
    if workload is None:
        workload = load_json(BENCH_DIR / "workloads" / f"{entry['traffic']}.json")
    if config is None:
        config = load_json(ROOT / config_entry(bench, entry["config"])["file"])
    tag = f"{cell}.seed{seed}.trace{int(trace)}"
    tracer = Tracer(trace, OUT_DIR, tuple(workload.get("profile", (0, 0, 0))), tag)
    ctx = Context(cell, seed, device, config, workload, tracer)
    driver = load_module(BENCH_DIR / "drivers" / f"{workload['driver']}.py").Driver(ctx)
    cuda = torch.device(device).type == "cuda"

    driver.setup()
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    tracer.open = True
    window = driver.run_window(seconds)
    if cuda:
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    tracer.finish()
    driver.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    verdict = driver.check(count=trace)

    record = {"setup_s": setup_s, "window": window, "peak_bytes": peak,
              "tracer": tracer, "trace": tracer.trace, "annotated": tracer.annotated,
              "config": config, "workload": workload, "flop": verdict.get("flop")}
    if trace:
        wanted = layer_metrics_of(bench, cell)
        folder = BENCH_DIR / "layer_metrics"
    else:
        wanted = reported(bench["end_to_end"], cell)
        folder = BENCH_DIR / "e2e_metrics"
    metrics = {}
    for m in wanted:
        value = load_module(reader_path(folder, m["name"])).read(record)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": entry["chips"], "memory_peak_bytes": int(peak)}
    result: Dict[str, Any] = {
        "correct": bool(verdict["correct"]),
        "attempted": int(window["attempted"]),
        "failed": int(window.get("failed", 0)),
        "metrics": metrics,
        "device": dev,
    }
    if trace and tracer.trace is not None:
        dev["busy_s"] = tracer.trace.busy_s
        dev["window_s"] = tracer.trace.window_s
        result["breakdown"] = {"device_ops": tracer.trace.top_ops(),
                               "idle_gaps": (tracer.annotated.idle_gaps()
                                             if tracer.annotated is not None else [])}
    if cuda:
        result["card"] = card_info()
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                        for c in verdict["checks"]}
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / f"{tag}.window.json").write_text(json.dumps(window, default=float))
    return result
