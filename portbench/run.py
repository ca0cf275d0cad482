"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints the numbers compared with the plain
reference as the last lines of standard error, and the result as one JSON
object on the last line of standard output. Exits with a code other than 0,
and prints no result, without a CUDA card (or fewer cards than the cell
asks for), or when the process holds JAX or the JAX package after the
window. Outputs (spans, the profiler's trace, the window's calls) go to
``build/portbench/``; the port's kernel builds to ``build/kernels/``.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _environment() -> None:
    """Caches inside the checkout, at fixed paths; no JAX through the
    libraries the port uses."""
    cache = ROOT / "build" / "portbench" / "cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ["USE_TF"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    sys.path.insert(0, str(HERE))
    sys.path.insert(1, str(ROOT))
    from pbcore import harness

    bench = harness.load_json(ROOT / "BENCHMARK.json")
    cell = harness.cell_entry(bench, args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    result = harness.run_cell(bench, args.workload, args.seed, args.seconds,
                              bool(args.trace), torch.device("cuda", 0), T_START)
    foreign = harness.foreign_modules()
    if foreign:
        print(f"portbench: the process loaded {', '.join(foreign)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(f"check correct = {result['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
