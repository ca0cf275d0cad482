#!/usr/bin/env python3
"""Drive the PyTorch port (waveverify_torch) on one NVIDIA GPU and check it.

Phases, each fatal on failure:
  1. card: name and power limit (nvidia-smi), torch and CUDA versions;
  2. build: compile csrc/resblock_chain.cu for sm_90a with nvcc;
  3. kernel vs plain version on the card: the 12 resblock chains of
     embed+detect at batch 2, ragged tiles with M = 1/2/3 and non-zero
     biases, narrow widths (C = 32, 48), a T shorter than the halo, batch 1,
     f32 (TF32 off) and bf16, and the autograd Function's gradients;
  4. main path: the committed r5 checkpoint served through
     WaveVerify.embed_batch / detect_batch and serve.embed_detect at batch
     64 x 1 s, f32 and bf16, with the kernel's launch count read around it,
     and a batch-4 comparison against the port on the CPU;
  5. times (CUDA events, after warm-up): embed+detect clips/s at batch 64,
     the host time to submit one call, the device's busy share, and per
     chain shape the kernel, the plain version, the bound, the product's
     rows per pass, registers and CTAs per SM, and the chain's C x C
     products alone through torch.matmul.

With --kernel-only the run stops after phase 3 and prints no result line.

Prints the card line and the kernels JSON line before the last line, which
is {"ok": true, "device": {...}}. Details go to chiprun_out/chip_smoke.json.
Run from the repository root: python3 chip_smoke.py
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Published H100 SXM peaks (NVIDIA data sheet, dense, 700 W): f32 outside
# the tensor cores, TF32 in them, and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12
# The kernel's f32 product is three TF32 passes (split TF32).
TF32_PASSES = 3

BATCH = 64
CLIP = 16000
RES_SCALE = 0.5773502691896258
# (T, C, M) of the resblock chains one embed+detect runs, in order
GEN_ENC = [(16000, 64, 2), (8000, 128, 2), (2000, 256, 2), (400, 512, 2)]
GEN_DEC = [(400, 768, 3), (2000, 384, 3), (8000, 192, 3), (16000, 96, 3)]
DET_ENC = GEN_ENC
CHAINS = GEN_ENC + GEN_DEC + DET_ENC
F32_TOL = dict(atol=2e-5, rtol=1e-5)
# The f32 kernel's max |err| grows with the width (more sums per output); it
# must stay under half of atol at every width, so that a drift shows here
# before it reaches the tolerance.
F32_DRIFT = 0.5 * F32_TOL["atol"]
# bf16 I/O: each launch rounds its output once to bf16 (8-bit mantissa); a
# per-block plan rounds up to M times, so allow two roundings at the
# output's largest magnitude
BF16_REL = 2.0**-6


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def chain_inputs(torch, b, t, c, m, seed, dtype, device="cuda"):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, c, t, generator=g) * 0.3
    ws = [torch.randn(m, c, c, generator=g) / c**0.5,
          torch.randn(m, 5, c, generator=g) * 0.3,
          torch.randn(m, c, generator=g) * 0.1,
          torch.randn(m, c, c, generator=g) / c**0.5,
          torch.randn(m, 5, c, generator=g) * 0.3,
          torch.randn(m, c, generator=g) * 0.1]
    prescales = tuple((1.0 + (i + 1) * RES_SCALE**2) ** -0.5 for i in range(m))
    # weights rounded to the activation dtype, passed as f32 (the wrapper's rule)
    return (x.to(device, dtype), [w.to(device, dtype).float() for w in ws],
            prescales)


def check_close(torch, y, ref, what):
    err = (y.float() - ref.float()).abs().max().item()
    if y.dtype == torch.float32:
        torch.testing.assert_close(y, ref, **F32_TOL, msg=lambda m: f"{what}: {m}")
        if not err <= F32_DRIFT:
            raise AssertionError(f"{what}: f32 max err {err} > {F32_DRIFT}, half of atol")
    else:
        scale = ref.float().abs().max().item()
        if not err <= BF16_REL * scale:
            raise AssertionError(f"{what}: bf16 max err {err} > {BF16_REL} * {scale}")
    return err


def cuda_time(torch, fn, iters, warmup=2):
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(torch, fn, iters=10):
    """Host time to submit one call, from an idle card to the call's return,
    with no synchronisation of ours inside the window: what the Python side
    costs per call, waits on the card included."""
    fn()
    total = 0.0
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        total += time.perf_counter() - t0
    torch.cuda.synchronize()
    return total / iters * 1e3


def device_breakdown(torch, fn, iters=3):
    """Device time by kernel over ``iters`` calls under torch.profiler:
    (busy share of the window, [(kernel, ms per call)] largest first)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    per_kernel = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            per_kernel[e.key] = per_kernel.get(e.key, 0.0) + e.self_device_time_total
    busy_us = sum(per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])
    return busy_us / wall_us, [(k[:90], us / iters / 1e3) for k, us in top]


def chain_cost(b, t, c, m, itemsize, k=5):
    """(FLOP, bytes) one chain needs: the JAX cost formula's FLOP (two CxC
    products and two depthwise convs per block, no halo recompute), each
    input read once and the output written once."""
    flops = m * 2 * b * t * c * (2 * c + 2 * k)
    nbytes = itemsize * (2 * b * t * c + m * (2 * c * c + 2 * k * c + 2 * c))
    return flops, nbytes


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "waveverify_torch" / "csrc" / "resblock_chain.cu").exists():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from waveverify_torch import WaveVerify
    from waveverify_torch.ops import resblock_chain as rc
    from waveverify_torch.serve import embed_detect, strict_f32

    report = {}
    t_start = time.perf_counter()

    # 1. card
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, {torch.cuda.get_device_name(0)}")
    report["card"] = card

    # 2. build
    t0 = time.perf_counter()
    lib = rc.build()
    report["build_s"] = time.perf_counter() - t0
    print(f"build: {lib.name} in {report['build_s']:.1f} s")
    ptxas = (lib.parent / f"{lib.stem}.log").read_text()
    kernels_built = []
    for entry, stack, stores, loads, regs in re.findall(
            r"Compiling entry function '(\w+)'.*?(\d+) bytes stack frame, (\d+) bytes "
            r"spill stores, (\d+) bytes spill loads.*?Used (\d+) registers", ptxas, re.S):
        io = "bf16" if "bfloat16" in entry else "f32"
        nt, mt, minb = re.search(r"Li(\d+)ELi(\d+)ELi(\d+)ELi5E", entry).groups()
        kernels_built.append({"io": io, "tiling": [int(nt), int(mt)],
                              "min_ctas_per_sm": int(minb), "registers": int(regs),
                              "spill_store_bytes": int(stores),
                              "spill_load_bytes": int(loads), "stack_bytes": int(stack)})
    report["ptxas"] = kernels_built
    print("ptxas (NT x MT, min CTAs/SM: registers f32 / bf16): " + ", ".join(
        f"{k['tiling'][0]}x{k['tiling'][1]},{k['min_ctas_per_sm']}: "
        + " / ".join(str(j["registers"]) for j in kernels_built
                     if j["tiling"] == k["tiling"])
        for k in kernels_built if k["io"] == "f32"))
    # every function of the log, the kernels' device functions included
    spilled = [(name[-60:], int(st), int(ld)) for name, st, ld in re.findall(
        r"Function properties for (\w+)\s+\d+ bytes stack frame, (\d+) bytes spill "
        r"stores, (\d+) bytes spill loads", ptxas) if int(st) or int(ld)]
    print(f"ptxas: {len(kernels_built)} kernels, spills (function, bytes stored, "
          f"loaded): {spilled or 'none'}")
    if len(kernels_built) != 2 * len(rc._TILINGS):
        raise AssertionError("ptxas log does not list every instantiation")
    if spilled:
        raise AssertionError("ptxas spilled registers in some instantiation")

    # 3. kernel against its plain version
    strict_f32()
    errs = {"float32": 0.0, "bfloat16": 0.0}
    errs_by_width = {}
    shapes = [(2, t, c, m) for t, c, m in CHAINS]
    shapes += [(2, 1000, 64, 1), (2, 777, 128, 2), (2, 131, 96, 3),
               (2, 100, 768, 3)]  # ragged
    # few n-tiles and idle warps; all of tile 0's halo is padding; batch 1
    shapes += [(2, 300, 32, 1), (2, 300, 48, 2), (2, 20, 96, 3), (2, 20, 768, 3),
               (1, 1000, 128, 2)]
    for i, (b, t, c, m) in enumerate(shapes):
        for dtype in (torch.float32, torch.bfloat16):
            x, ws, ps = chain_inputs(torch, b, t, c, m, i, dtype)
            y = rc.resblock_chain(x, *ws, prescales=ps, res_scale=RES_SCALE)
            ref = rc.resblock_chain_ref(x, *ws, prescales=ps, res_scale=RES_SCALE)
            torch.cuda.synchronize()
            name = str(dtype).split(".")[1]
            err = check_close(torch, y, ref, f"chain B={b} T={t} C={c} M={m} {name}")
            errs[name] = max(errs[name], err)
            if dtype == torch.float32:
                errs_by_width[c] = max(errs_by_width.get(c, 0.0), err)
    x, ws, ps = chain_inputs(torch, 2, 64, 16, 2, 99, torch.float32)
    leaves = [x] + ws
    for v in leaves:
        v.requires_grad_(True)
    slots = [tuple(w[j] for w in ws) for j in range(2)]
    y = rc.fused_resblock_chain(x, rc.stack_chain_weights(slots, x.dtype),
                                prescales=ps, res_scale=RES_SCALE)
    g_k = torch.autograd.grad(y.square().sum(), leaves)
    y_ref = rc.resblock_chain_ref(x, *ws, prescales=ps, res_scale=RES_SCALE)
    g_r = torch.autograd.grad(y_ref.square().sum(), leaves)
    for a, b in zip(g_k, g_r):
        torch.testing.assert_close(a, b, atol=2e-4, rtol=1e-4)
    torch.cuda.synchronize()
    report["kernel_check_max_abs_err"] = errs
    report["kernel_check_f32_max_abs_err_by_width"] = errs_by_width
    print(f"kernel vs plain: {len(shapes)} shapes x f32/bf16 ok, max |err| "
          f"f32 {errs['float32']:.3e} bf16 {errs['bfloat16']:.3e}; gradients ok")
    print(f"kernel vs plain, f32 max |err| by width (limit {F32_DRIFT:.1e}, half of "
          "atol): " + ", ".join(f"C={c} {e:.2e}" for c, e in sorted(errs_by_width.items())))
    if "--kernel-only" in sys.argv[1:]:
        return 0

    # 4. main path
    r5 = ROOT / "weights" / "waveverify_demo_r5.npz"
    rng = np.random.RandomState(0)
    audio = (rng.randn(BATCH, CLIP) * 0.1).astype(np.float32)
    bits = rng.randint(0, 2, (BATCH, 16)).astype(np.float32)
    servers = {d: WaveVerify(r5, device="cuda", serve_dtype=d)
               for d in ("float32", "bfloat16")}
    per_call = {
        "embed_batch": sum(rc.launches_per_chain(c, m) for _, c, m in GEN_ENC + GEN_DEC),
        "detect_batch": sum(rc.launches_per_chain(c, m) for _, c, m in DET_ENC),
    }
    per_call["embed_detect"] = per_call["embed_batch"] + per_call["detect_batch"]
    a_dev = torch.tensor(audio, device="cuda")
    m_dev = torch.tensor(bits, device="cuda")
    launches = {}
    rc.resblock_chain.launches = 0
    for dname, wv in servers.items():
        before = rc.resblock_chain.launches
        wm = wv.embed_batch(audio, bits)
        n_embed = rc.resblock_chain.launches - before
        det_bits, conf = wv.detect_batch(wm)
        n_detect = rc.resblock_chain.launches - before - n_embed
        w, p = embed_detect(wv.models, a_dev, m_dev, dname)
        torch.cuda.synchronize()
        n_ed = rc.resblock_chain.launches - before - n_embed - n_detect
        launches[dname] = {"embed_batch": n_embed, "detect_batch": n_detect,
                           "embed_detect": n_ed}
        for arr in (wm, conf, w.cpu().numpy(), p.cpu().numpy()):
            if not np.isfinite(arr).all():
                raise AssertionError(f"{dname}: non-finite output")
        if launches[dname] != per_call:
            raise AssertionError(f"{dname}: launches {launches[dname]} != {per_call}")
    main_path_launches = rc.resblock_chain.launches
    if main_path_launches == 0:
        raise AssertionError("the main path launched no kernel")
    report["launches"] = launches
    print(f"main path: launches per call {per_call}; total {main_path_launches}")

    cpu = WaveVerify(r5, device="cpu")
    a4, m4 = torch.tensor(audio[:4]), torch.tensor(bits[:4])
    w_cpu, p_cpu = embed_detect(cpu.models, a4, m4, "float32")
    p_cpu = p_cpu.numpy()
    report["vs_cpu"] = {}
    for dname, wv in servers.items():
        w_gpu, p_gpu = embed_detect(wv.models, a4.cuda(), m4.cuda(), dname)
        w_gpu, p_gpu = w_gpu.cpu().numpy(), p_gpu.cpu().numpy()
        dw = float(np.abs(w_gpu - w_cpu.numpy()).max())
        dp = float(np.abs(p_gpu - p_cpu).max())
        # f32 must agree with the CPU wherever the decision is not a
        # coin-flip; bf16 rounds activations, so its margin is wider
        margin = 1e-3 if dname == "float32" else 0.05
        sure = np.abs(p_cpu - 0.5) > margin
        same = bool(((p_gpu > 0.5) == (p_cpu > 0.5))[sure].all())
        report["vs_cpu"][dname] = {"max_watermarked_dev": dw, "max_prob_dev": dp,
                                   "decided_bits": int(sure.sum()), "same": same}
        print(f"{dname} vs CPU port at batch 4: max |watermarked dev| {dw:.3e}, "
              f"max |prob dev| {dp:.3e}, bits identical on {int(sure.sum())} "
              f"decided bits: {same}")
        if not same:
            raise AssertionError(f"{dname}: bits differ from the CPU port")

    # 5. times
    report["clips_per_s"] = {}
    for dname, wv in servers.items():
        ms = cuda_time(torch, lambda: embed_detect(wv.models, a_dev, m_dev, dname), 10)
        report["clips_per_s"][dname] = BATCH / (ms / 1e3)
        print(f"embed+detect {dname} batch {BATCH} x 1 s: {ms:.3f} ms/batch, "
              f"{BATCH / (ms / 1e3):.2f} clips/s")
    report["host_ms_per_call"] = {}
    for dname, wv in servers.items():
        hms = host_ms(torch, lambda: embed_detect(wv.models, a_dev, m_dev, dname))
        report["host_ms_per_call"][dname] = hms
        print(f"embed+detect {dname}: host {hms:.3f} ms to submit one call")
    report["device_breakdown"] = {}
    for dname, wv in servers.items():
        busy, top = device_breakdown(
            torch, lambda: embed_detect(wv.models, a_dev, m_dev, dname))
        chain_ms = sum(ms for k, ms in top if "resblock_chain" in k)
        total_ms = sum(ms for _, ms in top)
        report["device_breakdown"][dname] = {
            "busy_share": busy, "device_ms_per_call": total_ms,
            "chain_kernel_ms_per_call": chain_ms, "top": top[:12]}
        print(f"profile {dname}: device busy {busy:.3f} of the window, "
              f"{total_ms:.3f} device ms/call, chain kernel {chain_ms:.3f} ms; top: "
              + "; ".join(f"{k[:40]} {ms:.2f}" for k, ms in top[:4]))

    def bounds(flops, nbytes):
        """(FMA bound, bound, bound_by) in seconds: the f32 FMA rate the first
        kernel was held to, and the split-TF32 tensor-core rate it runs at now."""
        t_bytes = nbytes / PEAK_BYTES
        t_ops = TF32_PASSES * flops / PEAK_TF32_FLOPS
        return (max(flops / PEAK_F32_FLOPS, t_bytes), max(t_ops, t_bytes),
                "operations" if t_ops >= t_bytes else "bytes")

    def products_matmul_ms(x, ws, m, allow_tf32):
        """The chain's 2 m C x C products alone, each as one torch.matmul
        over x: what the library's GEMM takes for the kernel's main work."""
        mats = [ws[j][i].t().contiguous() for i in range(m) for j in (0, 3)]
        torch.backends.cuda.matmul.allow_tf32 = allow_tf32
        ms = cuda_time(torch, lambda: [torch.matmul(w, x) for w in mats], 3)
        torch.backends.cuda.matmul.allow_tf32 = False
        return ms

    rows = []
    tot = {"ms": 0.0, "plain_ms": 0.0, "flops": 0, "bytes": 0, "err": 0.0,
           "matmul_f32_ms": 0.0, "matmul_tf32_ms": 0.0}
    unique = list(dict.fromkeys(CHAINS))
    for i, (t, c, m) in enumerate(unique):
        count = CHAINS.count((t, c, m))
        x, ws, ps = chain_inputs(torch, BATCH, t, c, m, 100 + i, torch.float32)
        run_k = lambda: rc.resblock_chain(x, *ws, prescales=ps, res_scale=RES_SCALE)
        run_p = lambda: rc.resblock_chain_ref(x, *ws, prescales=ps, res_scale=RES_SCALE)
        err = check_close(torch, run_k(), run_p(), f"batch-64 chain T={t} C={c}")
        ms_k = cuda_time(torch, run_k, 5)
        ms_p = cuda_time(torch, run_p, 3)
        mm_f32 = products_matmul_ms(x, ws, m, False)
        mm_tf32 = products_matmul_ms(x, ws, m, True)
        flops, nbytes = chain_cost(BATCH, t, c, m, 4)
        fma_bound, bound, bound_by = bounds(flops, nbytes)
        if ms_k < bound * 1e3:
            raise AssertionError(f"chain T={t} C={c}: kernel {ms_k} ms is under its "
                                 f"bound {bound * 1e3} ms: the count is wrong")
        plan = rc.chain_plan(c, m, 5)
        slab_rows = plan[0][0] * 8 + min(plan[0][1], t)
        regs, ctas = rc.kernel_info(c, slab_rows)
        nt, mt, _ = rc.product_tiling(c)
        row = {"T": t, "C": c, "M": m, "per_call": count,
               "launches": len(plan), "plan": plan,
               "ms": ms_k, "plain_ms": ms_p, "bound_us": bound * 1e6,
               "fma_bound_us": fma_bound * 1e6, "bound_by": bound_by,
               "max_abs_err": err, "tiling": [nt, mt], "rows_per_pass": rc.chunk_rows(c),
               "slab_rows": slab_rows, "registers": regs, "ctas_per_sm": ctas,
               "products_matmul_ms": {"f32": mm_f32, "tf32": mm_tf32}}
        rows.append(row)
        tot["ms"] += count * ms_k
        tot["plain_ms"] += count * ms_p
        tot["flops"] += count * flops
        tot["bytes"] += count * nbytes
        tot["matmul_f32_ms"] += count * mm_f32
        tot["matmul_tf32_ms"] += count * mm_tf32
        tot["err"] = max(tot["err"], err)
        print(f"chain T={t} C={c} M={m} x{count}: kernel {ms_k:.3f} ms, plain "
              f"{ms_p:.3f} ms, bound {bound * 1e6:.1f} us ({bound_by}; f32 FMA bound "
              f"{fma_bound * 1e6:.1f} us), {len(plan)} launch(es) {plan}; NT x MT "
              f"{nt} x {mt}, R {row['rows_per_pass']} of {slab_rows} slab rows, "
              f"{regs} registers, {ctas} CTA/SM; products alone by torch.matmul "
              f"{mm_f32:.3f} ms f32, {mm_tf32:.3f} ms TF32", flush=True)
    report["chains_f32_batch64"] = rows
    print("library_ms: none (no single PyTorch call computes a resblock chain); "
          f"products_matmul_ms per embed+detect, informational: f32 "
          f"{tot['matmul_f32_ms']:.3f}, TF32 allowed {tot['matmul_tf32_ms']:.3f}")

    fma_bound, bound, bound_by = bounds(tot["flops"], tot["bytes"])
    print(f"chain kernel per embed+detect: {tot['ms']:.3f} ms; bound "
          f"{bound * 1e3:.3f} ms ({TF32_PASSES} TF32 passes at "
          f"{PEAK_TF32_FLOPS / 1e12:.0f} TFLOP/s); f32 FMA bound {fma_bound * 1e3:.3f} ms")
    kernels = {"kernels": [{
        "name": "resblock_chain",
        "route": "cuda",
        "source": "waveverify_torch/csrc/resblock_chain.cu",
        "replaces": "waveverify_tpu/ops/pallas_kernels.py:354",
        "launches": main_path_launches,
        "max_abs_err": tot["err"],
        "ms": tot["ms"],
        "plain_ms": tot["plain_ms"],
        "bound_ms": bound * 1e3,
        "bound_by": bound_by,
        "library_ms": None,
    }]}
    report["kernels"] = kernels
    report["fma_bound_ms"] = fma_bound * 1e3
    report["products_matmul_ms"] = {"f32": tot["matmul_f32_ms"],
                                    "tf32": tot["matmul_tf32_ms"]}
    report["seconds"] = time.perf_counter() - t_start
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))

    print(f"card: {card_line()}")
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
