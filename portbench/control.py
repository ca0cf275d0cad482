"""Readings of the comparison that decides ``correct``: the program's and
the control's (the plain reference in TF32 put in the program's place), on
several seeds in one process.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 --seconds 3

Per seed: set-up, a short window at the cell's own load (training's
lasts until the window's checked step is done), then the program's
numbers and, unless ``--program-only``, the control's. ``--fault <name>``
plants one of ``pbcore.faults`` in the port first. One JSON line per seed
on standard output, with each comparison's detail; all of them in ``--out``
when given. Needs a card.
"""

import argparse
import json
import sys
import time
import types
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--program-only", action="store_true")
    ap.add_argument("--fault", help="a fault of pbcore.faults planted in the port")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(HERE), str(ROOT)]
    import torch

    from pbcore import faults, harness
    from pbcore.trace import Tracer

    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    entry = harness.cell_entry(bench, args.workload)
    config = harness.load_json(ROOT / harness.config_entry(bench, entry["config"])["file"])
    workload = harness.load_json(HERE / "workloads" / f"{entry['traffic']}.json")
    if args.fault:
        kinds = faults.TRAIN if workload["driver"] == "train_step" else faults.SERVE
        kinds[args.fault](types.SimpleNamespace(setattr=setattr))
    driver_mod = harness.load_module(HERE / "drivers" / f"{workload['driver']}.py")
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        ctx = harness.Context(args.workload, seed, torch.device("cuda", 0),
                              config, workload, Tracer(False, harness.OUT_DIR))
        d = driver_mod.Driver(ctx)
        d.setup()
        d.run_window(args.seconds)
        d.release()
        torch.cuda.empty_cache()
        prog = d.check()
        row = {"seed": seed, "fault": args.fault,
               "program": {c["name"]: c["value"] for c in prog["checks"]},
               "program_detail": prog.get("detail")}
        if not args.program_only:
            ctrl = d.control_check()
            row["control"] = {c["name"]: c["value"] for c in ctrl["checks"]}
            row["control_detail"] = ctrl.get("detail")
        row["seconds"] = time.perf_counter() - t0
        rows.append(row)
        print(json.dumps(row), flush=True)
        del d
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
