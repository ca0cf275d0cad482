"""Probes behind the design of the chain kernel's wgmma route
(waveverify_torch/csrc/resblock_chain.cu), run on one Hopper card:

  python3 tools/hopper_probes/run_probes.py

1. wgmma_contract.cu: the TF32 RS wgmma contract (fragment layouts, the
   K-major B descriptor, scale-d = 0, bulk copy + mbarrier staging) at
   N = 32, 64, 96, both readings of the descriptor's two byte offsets;
   max |err| against the exact integer product.
2. bulk_feed.cu: GB/s one CTA receives per SM from a ring of bulk copies
   and from plain loads, with every SM streaming at once.

Prints the card's nvidia-smi name and power limit first; builds into
build/probes/ with nvcc for sm_90a."""

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
OUT = HERE.parent.parent / "build" / "probes"


def build(name):
    OUT.mkdir(parents=True, exist_ok=True)
    lib = OUT / f"{name}.so"
    nvcc = "/usr/local/cuda/bin/nvcc"
    r = subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                        "-shared", "-Xcompiler", "-fPIC", "-o", str(lib), str(HERE / f"{name}.cu")],
                       capture_output=True, text=True)
    if r.returncode:
        sys.exit(f"nvcc failed for {name}:\n{r.stderr}")
    return ctypes.CDLL(str(lib))


def contract():
    lib = build("wgmma_contract")
    lib.run_probe.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
    rng = np.random.RandomState(0)
    for n in (32, 64, 96):
        a = rng.randint(-4, 5, (64, 8)).astype(np.float32)
        b = rng.randint(-4, 5, (8, n)).astype(np.float32)  # B[k][n]
        img = np.zeros(n * 8, np.float32)
        for nn in range(n):
            for k in range(8):
                img[(nn // 8) * 64 + (k // 4) * 32 + (nn % 8) * 4 + k % 4] = b[k, nn]
        at, it = torch.tensor(a, device="cuda"), torch.tensor(img, device="cuda")
        for lbo, sbo in ((128, 256), (256, 128)):
            for bulk in (0, 1):
                d = torch.zeros(64, n, device="cuda")
                rc = lib.run_probe(n, at.data_ptr(), it.data_ptr(), d.data_ptr(), lbo, sbo, bulk)
                err = float(np.abs(d.cpu().numpy() - a @ b).max()) if rc == 0 else None
                print(f"wgmma m64n{n}k8 tf32 RS: leading byte offset {lbo}, stride byte "
                      f"offset {sbo}, B staged by {'bulk copy' if bulk else 'stores'}: "
                      f"rc {rc}, max |err| {err}", flush=True)


def feed():
    lib = build("bulk_feed")
    f, i, p = ctypes.c_float, ctypes.c_int, ctypes.c_void_p
    lib.run_bulk.argtypes = [p, i, i, i, i, i, i, i, p, ctypes.POINTER(f)]
    lib.run_ldg.argtypes = [p, i, i, i, i, p, p, ctypes.POINTER(f)]
    total = 192 * 192 * 8 * 4  # four f32 wgmma images of a C = 192 matrix
    src = torch.randn(264 * total // 4 + 1024, device="cuda")
    out = torch.zeros(264, dtype=torch.int64, device="cuda")
    sink = torch.zeros(264, device="cuda")
    ms = f()
    modes = {0: "same addresses", 1: "staggered start", 2: "own copy per CTA"}

    def bulk(ctas, mode, stage, stages, split=1):
        iters = min(2000, 4 * total // stage)
        for _ in range(2):
            rc = lib.run_bulk(src.data_ptr(), total, stage, stages, iters, mode, split, ctas,
                              out.data_ptr(), ctypes.byref(ms))
        torch.cuda.synchronize()
        gbs = ctas * iters * stage / (ms.value * 1e-3) / 1e9
        print(f"bulk copies: {ctas} CTAs, {modes[mode]}, {stage} B stages x {stages}, "
              f"{split} issuing thread(s): rc {rc}, {gbs / 132:.1f} GB/s per SM", flush=True)

    for mode in (0, 1, 2):
        for stage, stages in ((4096, 2), (4096, 6), (12288, 2), (12288, 4), (24576, 2),
                              (49152, 2), (12288, 8)):
            bulk(132, mode, stage, stages)
    for split in (2, 4, 8):
        bulk(132, 0, 12288, 2, split)
        bulk(132, 0, 6144, 4, split)
    for stage, stages in ((12288, 2), (6144, 4), (24576, 2)):
        bulk(264, 0, stage, stages)
    for ctas in (132, 264):
        for mode in (0, 2):
            per_cta = 4 * total
            for _ in range(2):
                rc = lib.run_ldg(src.data_ptr(), total, per_cta, mode, ctas, sink.data_ptr(),
                                 out.data_ptr(), ctypes.byref(ms))
            torch.cuda.synchronize()
            gbs = ctas * per_cta / (ms.value * 1e-3) / 1e9
            print(f"plain loads (4 float4 in flight per thread): {ctas} CTAs, {modes[mode]}: "
                  f"rc {rc}, {gbs / 132:.1f} GB/s per SM", flush=True)


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("run_probes: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    contract()
    feed()
