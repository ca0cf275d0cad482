"""Probe of the persistent LSTM recurrence kernel
(waveverify_torch/csrc/lstm_recurrence.cu) on one Hopper card:

  python3 tools/hopper_probes/lstm_recurrence.py [--quick]

1. The card's name and power limit; the build, with ptxas's registers and
   spills per kernel.
2. The step barrier alone: us per round over 43, 86, 129 and 132 CTAs.
3. AudioSeal's LSTM (two layers of 512, T = 1500, B = 8, PyTorch's default
   draws) through the kernel against the reference's loop of f32 products
   on the card, against cuDNN, and the TF32 control; gap over the
   reference's peak.
4. Times by CUDA events: the kernel's launch alone (us per wavefront step),
   the whole call (the input GEMM too), cuDNN's LSTM eager; at B = 8 and 64.
5. A profiled call: the kernel's correlation id and the runtime call that
   launched it (the `lstm_ms` reader matches them).

The barrier is lstm_barrier.cu beside this file, which includes the
kernel's source and is built by the same nvcc.build.

Writes chiprun_out/lstm_probe.json.
"""

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "portbench"))

from reference import audioseal as ra  # noqa: E402
from reference.ops import Ops, strict_f32  # noqa: E402
from waveverify_torch import spans  # noqa: E402
from waveverify_torch.ops import lstm_recurrence as lr  # noqa: E402
from waveverify_torch.ops import nvcc  # noqa: E402

BARRIER_SOURCE = Path(__file__).resolve().parent / "lstm_barrier.cu"


def weights_of(p, layers):
    return [tuple(p[f"l.{n}_l{i}"] for n in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"))
            for i in range(layers)]


def draw(seed, h, layers, dev):
    g = torch.Generator().manual_seed(seed)
    return {k: ((torch.rand(s, generator=g) * 2 - 1) * h ** -0.5).to(dev)
            for k, s, *_ in ra._lstm_spec("l", h, layers)}


def rel_gap(a, ref):
    return float((a.double() - ref.double()).abs().max() / ref.double().abs().max())


def barrier_us(ctas, steps=20000):
    """Microseconds per round of the kernel's step barrier alone over
    ``ctas`` co-resident CTAs, timed with CUDA events."""
    lib = ctypes.CDLL(str(nvcc.build(BARRIER_SOURCE, depends=[lr._SOURCE])))
    lib.wv_lstm_barrier_probe.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                                          ctypes.c_longlong, ctypes.c_void_p]
    counter = torch.zeros(lr._COUNTER_STRIDE, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def run(n):
        counter.zero_()
        err = lib.wv_lstm_barrier_probe(ctas, n, counter.data_ptr(), lr._SPIN_NS, stream)
        if err:
            sys.exit(f"barrier probe failed: error {err}")

    run(100)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    run(steps)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e3 / steps


def events_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()
    out = {}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    out["card"] = smi
    print("card:", smi, "torch", torch.__version__, "cuda", torch.version.cuda, flush=True)
    lib = lr.build()
    log = (lib.parent / f"{lib.stem}.log").read_text()
    out["ptxas"] = [line.strip() for line in log.splitlines()
                    if "registers" in line or "spill" in line or "Compiling entry" in line]
    print("\n".join(out["ptxas"]), flush=True)
    strict_f32()
    dev = torch.device("cuda")

    out["barrier_us"] = {n: barrier_us(n) for n in (43, 86, 129, 132)}
    print("barrier us per round:", out["barrier_us"], flush=True)

    h, layers, t_len = 512, 2, 1500
    plan = lr.device_plan(dev, h, layers)
    print("plan:", plan, flush=True)
    out["plan"] = str(plan)
    gaps = []
    for seed in (0, 1) if not args.quick else (0,):
        p = draw(seed, h, layers, dev)
        gen = torch.Generator(device=dev).manual_seed(seed)
        x = torch.randn(8, h, t_len, device=dev, generator=gen)
        seq = x.permute(2, 0, 1).contiguous()
        with torch.no_grad():
            got = lr.lstm_recurrence(seq, weights_of(p, layers)) + seq
            want = ra.lstm(Ops(), p, "l", x, layers).permute(2, 0, 1)
            control = ra.lstm(Ops(tf32=True), p, "l", x, layers).permute(2, 0, 1)
            m = torch.nn.LSTM(h, h, layers).to(dev)
            m.load_state_dict({k[2:]: v for k, v in p.items()})
            cudnn = m(seq)[0] + seq
        gaps.append({"seed": seed, "kernel": rel_gap(got, want), "cudnn": rel_gap(cudnn, want),
                     "tf32_control": rel_gap(control, want)})
        print("gaps:", gaps[-1], flush=True)
    out["gaps"] = gaps

    times = {}
    for batch in (8, 64) if not args.quick else (8,):
        p = draw(0, h, layers, dev)
        ws = weights_of(p, layers)
        seq = torch.randn(t_len, batch, h, device=dev)
        pre = lr._input_product(seq, ws[0][0], ws[0][2], ws[0][3])
        outs = [torch.empty_like(seq) for _ in range(layers)]
        counters = torch.zeros(layers * lr._COUNTER_STRIDE, dtype=torch.int32, device=dev)

        def launch():
            counters.zero_()
            lr._launch(pre, ws, [0, 1], outs, counters, 0, batch, plan)

        m = torch.nn.LSTM(h, h, layers).to(dev).eval()
        with torch.no_grad():
            k_ms = events_ms(launch, 5)
            call_ms = events_ms(lambda: lr.lstm_recurrence(seq, ws), 5)
            gemm_ms = events_ms(lambda: lr._input_product(seq, ws[0][0], ws[0][2], ws[0][3]), 5)
            cudnn_ms = events_ms(lambda: m(seq), 3)
        times[batch] = {"kernel_ms": k_ms, "us_per_step": k_ms * 1e3 / (t_len + layers - 1),
                        "call_ms": call_ms, "input_gemm_ms": gemm_ms, "cudnn_eager_ms": cudnn_ms}
        print(f"B={batch}:", times[batch], flush=True)
    out["times"] = times

    from torch.profiler import ProfilerActivity, profile
    seq = torch.randn(t_len, 8, h, device=dev)
    ws = weights_of(draw(0, h, layers, dev), layers)
    trace = ROOT / "chiprun_out" / "lstm_probe.trace.json"
    trace.parent.mkdir(exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof, torch.no_grad():
        with spans.span("seanet.lstm", device=True):
            lr.lstm_recurrence(seq, ws)
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel" and "lstm_recurrence" in e["name"]]
    ids = {k.get("args", {}).get("correlation") for k in kernels}
    runtime = [e["name"] for e in events if e.get("cat") == "cuda_runtime"
               and e.get("args", {}).get("correlation") in ids]
    out["profile"] = {"kernels": [(k["name"], k["dur"]) for k in kernels], "launched_by": runtime,
                      "events_by_cat": {c: sum(1 for e in events if e.get("cat") == c)
                                        for c in {e.get("cat") for e in events}}}
    print("profile:", out["profile"], flush=True)
    spans.drain()
    (ROOT / "chiprun_out" / "lstm_probe.json").write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
