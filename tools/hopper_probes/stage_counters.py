"""Where a wgmma product stage's time goes, on one Hopper card:

  python3 tools/hopper_probes/stage_counters.py

Copies waveverify_torch/ into build/stage_counters/, adds clock64 counters
to the chain kernel's wgmma route (per CTA in shared memory, one global add
per CTA at its end), builds that copy, and runs the batch-64 f32 chain at
C = 192, the one width that route serves.
Prints per stage, in SM cycles, averaged over the CTAs: warp 0's and warp
4's wait for the stage's bulk copy, warp 0's time from the stage's data to
the slot's release (its wgmma group, the wait for it, the next A loads),
the time from a copy's issue to warp 0 seeing it, and per CTA the product
passes' share of the kernel."""

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent.parent
COPY = REPO / "build" / "stage_counters"

PATCHES = [
    ("struct ChainScalars {", """__device__ unsigned long long g_dbg[16];

struct ChainScalars {"""),
    ("  int total;      // stages of the launch\n", """  int total;      // stages of the launch
  long long* dbg;        // per-CTA counters in shared memory
  long long* issue_clk;  // when each slot's copy was issued
"""),
    ("    bulk_load(data + slot_at * stage_bytes, img, stage_bytes, bar);\n",
     """    bulk_load(data + slot_at * stage_bytes, img, stage_bytes, bar);
    issue_clk[slot_at] = clock64();
"""),
    ("  const int tiles = wg_sweep_tiles<NB, UNITS>(C);\n  for (int r0 = 0; r0 < P;",
     "  const int tiles = wg_sweep_tiles<NB, UNITS>(C);\n  const long long tp = clock64();\n"
     "  for (int r0 = 0; r0 < P;"),
    ("""        mbar_wait(ring.full + 8 * ring.slot, ring.phase);
        __syncwarp();
        const int scale_first""", """        const long long tw0 = clock64();
        mbar_wait(ring.full + 8 * ring.slot, ring.phase);
        const long long tw1 = clock64();
        if (threadIdx.x == 0) {
          ring.dbg[0] += tw1 - tw0;
          ring.dbg[2] += 1;
          ring.dbg[3] += tw1 - ring.issue_clk[ring.slot];
        }
        if (threadIdx.x == 128) ring.dbg[7] += tw1 - tw0;
        __syncwarp();
        const int scale_first"""),
    ("""        if (lane == 0) ring.release(ring.slot, ring.index);
        ring.advance();""", """        if (lane == 0) ring.release(ring.slot, ring.index);
        if (threadIdx.x == 0) ring.dbg[1] += clock64() - tw1;
        ring.advance();"""),
    ("""          o[ld + 8] = sum[j][4 * jn + 3];
        }
      }
    }
    __syncthreads();
  }
}""", """          o[ld + 8] = sum[j][4 * jn + 3];
        }
      }
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) ring.dbg[4] += clock64() - tp;
}"""),
    ("""  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(ring.full + 8 * i, 1);""", """  __shared__ long long dbg_s[8], issue_s[kMaxStages];
  ring.dbg = dbg_s;
  ring.issue_clk = issue_s;
  const long long tk = clock64();
  if (threadIdx.x < 8) dbg_s[threadIdx.x] = 0;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(ring.full + 8 * i, 1);"""),
    ("""    pointwise_wgmma<NB, UNITS, kSplitB>(u, Pu, C, ldu, ring);
  };
  run_chain<T, K>(x, out, xs, xs + C * ld, dw1, b1, dw2, b2, C, T_len, M, t_tile, sc,
                  product);
""", """    pointwise_wgmma<NB, UNITS, kSplitB>(u, Pu, C, ldu, ring);
  };
  run_chain<T, K>(x, out, xs, xs + C * ld, dw1, b1, dw2, b2, C, T_len, M, t_tile, sc,
                  product);
  if (threadIdx.x == 0) {
    dbg_s[6] = clock64() - tk;
    for (int i = 0; i < 8; ++i) atomicAdd(&g_dbg[i], (unsigned long long)dbg_s[i]);
    atomicAdd(&g_dbg[8], 1ull);
  }
"""),
    ("const char* wv_error_string(int err)", """int wv_counters(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_dbg, sizeof(g_dbg));
  unsigned long long zero[16] = {0};
  cudaMemcpyToSymbol(g_dbg, zero, sizeof(zero));
  return (int)e;
}

const char* wv_error_string(int err)"""),
]


def main():
    if not torch.cuda.is_available():
        sys.exit("stage_counters: no CUDA device")
    shutil.rmtree(COPY, ignore_errors=True)
    COPY.mkdir(parents=True)
    shutil.copytree(REPO / "waveverify_torch", COPY / "waveverify_torch")
    src = COPY / "waveverify_torch" / "csrc" / "resblock_chain.cu"
    text = src.read_text()
    for old, new in PATCHES:
        if old not in text:
            sys.exit(f"stage_counters: the kernel source changed; no anchor for {old[:60]!r}")
        text = text.replace(old, new, 1)
    src.write_text(text)
    sys.path.insert(0, str(COPY))
    sys.path.insert(1, str(REPO))
    import chip_smoke as cs
    from waveverify_torch.ops import resblock_chain as rc
    from waveverify_torch.serve import strict_f32

    print(cs.card_line(), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), "max SM clock")
    lib = rc._library()
    lib.wv_counters.argtypes = [ctypes.c_void_p]
    strict_f32()
    buf = (ctypes.c_ulonglong * 16)()
    t, c, m = 8000, 192, 3
    x, ws, ps = cs.chain_inputs(torch, cs.BATCH, t, c, m, 1, torch.float32)
    run = lambda: rc.resblock_chain(x, *ws, prescales=ps, res_scale=cs.RES_SCALE)
    run()
    torch.cuda.synchronize()
    lib.wv_counters(buf)
    ms = cs.cuda_time(torch, run, 3, warmup=0)
    lib.wv_counters(buf)
    v = list(buf)
    n, st = v[8], v[2]
    print(f"T={t} C={c} M={m} wgmma: {ms:.3f} ms per chain with the counters; per "
          f"stage (cycles): wait for the copy warp 0 {v[0] / st:.0f}, warp 4 "
          f"{v[7] / st:.0f}; data to release {v[1] / st:.0f}; issue to seen "
          f"{v[3] / st:.0f}; per CTA: {st / n:.0f} stages, products "
          f"{v[4] / n:.0f} of {v[6] / n:.0f} cycles", flush=True)


if __name__ == "__main__":
    main()
