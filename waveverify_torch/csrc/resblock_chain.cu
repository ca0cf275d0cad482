// Fused chain of SEANet residual blocks for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels _resblock_kernel_tbc / _resblock_kernel
// (waveverify_tpu/ops/pallas_kernels.py, launched by _pallas_forward_tbc and
// _pallas_forward). For M blocks i = 0..M-1 (M <= 8 per launch) over an
// activation x [B, C, T], C a multiple of 16 up to 768, depthwise taps
// K = 3 or 5:
//
//   u = ELU(x * ps_i)
//   u = pw1_i^T u                 (1x1 conv, C x C)
//   u = causal depthwise_k(u) + b1_i, rows t < 0 zeroed, then ELU
//   u = pw2_i^T u
//   u = causal depthwise_k(u) + b2_i
//   x = x + res_scale * u         (rows t < 0 zeroed)
//
// with ELU(v) = v > 0 ? v : alpha * (exp(min(v, 0)) - 1), as the TPU kernel
// writes it. x and the output are f32 or bf16; the weights arrive as f32
// (under bf16 serving their values are already rounded to bf16 by the
// wrapper); the activation stays f32 inside the kernel.
//
// Design. One CTA owns one (batch, T-tile). Its 256 worker threads load the
// tile plus H = M * 2 * (K - 1) rows of history into shared memory as an
// f32 slab stored channel-major, xs[c][row], and walk all M blocks there,
// so device memory sees one read of x and one write of the output for the
// whole launch. A second slab us holds u; the pass that produces a block's
// input (the load, or the previous block's last depthwise pass) also
// writes its ELU there. The depthwise convolutions run in place: each
// thread scans a (channel, row-segment) item in time order, with the K - 1
// history values read into registers before anyone writes. Rows before the
// start of time are loaded as zero and re-zeroed after every bias add,
// which is the causal zero padding; the history rows at the top of a later
// tile are recomputed and discarded.
//
// The 1x1 products run on the tensor cores, in place on us, by one of two
// routes; ops/resblock_chain.py picks the route and its tiling per width
// from a table (_WGMMA_WIDTHS) and passes them to the launch. Both read a
// 16 x 8 piece of A (time rows x input channels) from the slab with four
// 4-byte shared loads, A[r][ci] = us[ci * ld + r], and both write a chunk
// of rows back only after every warp has read it (sums in registers,
// barrier, write, barrier).
//
// Route 0, mma.sync. The warp-level
//   mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32
// with M = time rows, N = output channels, K = input channels. With
// g = lane >> 2 and t = lane & 3 a lane holds
//   A (16 x 8):  a0 = A[g][t]   a1 = A[g+8][t]   a2 = A[g][t+4]  a3 = A[g+8][t+4]
//   B (8 x 8):   b0 = B[t][g]   b1 = B[t+4][g]
//   D (16 x 8):  d0 = D[g][2t]  d1 = D[g][2t+1]  d2 = D[g+8][2t] d3 = D[g+8][2t+1]
// B[ci][co] = pw[ci][co] goes from global memory (L2) straight to
// registers, as f32, split there: every warp owns distinct output columns.
// The wrapper lays pw out in fragment order (pack_chain_weights): for
// k-step ks and the pair p of neighbouring n-tiles, lane l finds its four
// values as one float4 at [(ks * C / 16 + p) * 32 + l]. A warp keeps MT x
// NT accumulator tiles in registers; wn = ceil(C / (8 NT)) warps cover the
// columns and 8 / wn row groups share a chunk of R = (8 / wn) * 16 * MT
// rows. What bounds it: per chunk the CTA re-reads the whole C x C matrix
// from L2, R / 2 FLOP per L2 byte, and each warp feeds the tensor core from
// its own registers (37-57% of the TF32 rate per product pass, measured).
//
// Route 1, wgmma. Two warpgroups (warps 0-3, 4-7) run
//   wgmma.mma_async.sync.aligned.m64nNk8.f32.tf32.tf32 d, {a0..a3}, b-desc,
//       scale-d, 1, 1
// (the RS form: A from registers, B from shared memory; N = NB; the operand
// form of CUTLASS's MMA_64xNx8_F32TF32TF32_RS_TN, in
// cute/arch/mma_sm90_gmma.hpp). The contract, as used here and checked on
// an H100 (CUDA 12.9) by products of integers against the exact result
// (tools/hopper_probes/run_probes.py):
//   A: warp w of the warpgroup holds rows 16w..16w+15 of the 64 x 8 tile
//      in the mma.sync A layout above (a0 = A[16w+g][t], a1 = A[16w+g+8][t],
//      a2 = A[16w+g][t+4], a3 = A[16w+g+8][t+4]);
//   D: d[4j..4j+3] = D[16w+g][8j+2t], D[16w+g][8j+2t+1], D[16w+g+8][8j+2t],
//      D[16w+g+8][8j+2t+1] for j < N / 8;
//   B: TF32 takes its shared-memory operands K-major only. No swizzle: a
//      core matrix is 8 output channels by 4 input channels, 16 contiguous
//      bytes per channel, 128 bytes in all; the descriptor holds (address
//      >> 4) in bits 0-13, the leading byte offset (between the two core
//      matrices of the k-chunk, along K: 128) >> 4 in bits 16-29, the
//      stride byte offset (between core matrices 8 output channels apart:
//      256) >> 4 in bits 32-45, layout type 0 in bits 62-63 (CUTLASS's
//      GmmaDescriptor, cute/arch/mma_sm90_desc.hpp; the swapped reading of
//      the two offsets gives wrong sums). So B[k][n] of a column block sits
//      at float (n / 8) * 64 + (k / 4) * 32 + (n % 8) * 4 + k % 4;
//   scale-d = 0 ignores d's old value (checked with d preset to 1e6);
//   wgmma.fence before the first wgmma of a group whose A or d registers
//   were written by ordinary instructions; wgmma.commit_group closes the
//   group; wgmma.wait_group N returns when at most N of the warpgroup's
//   groups are pending, after which the done groups' smem reads are over and
//   their d may be read. The compiler does not know the instruction is
//   asynchronous, so the d and A registers are marked as touched after the
//   wait (fence_regs). ptxas serializes every wgmma of a function where one
//   sits in a divergent path (its advisory C7520), so no branch encloses
//   one.
// The weights stay in the layout the wrapper chose (pack_wgmma_weights):
// per block, for each k-chunk ks of 8 input channels, one ring stage: for
// each column block cb of NB output channels the exact shared-memory image
// of B[8 ks .. 8 ks + 8][NB cb .. NB cb + NB] in TF32 hi, then (f32 only)
// lo. One 1-D
//   cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes
// moves a stage into a ring of 2-8 slots behind the slabs; its full
// mbarrier takes the issuer's expect_tx and the copy's bytes. A 1-D bulk
// copy needs no tensor map and so no driver API: the stage is contiguous in
// the packed image. Thread 0 starts the first stages before the slabs
// load; after that the last of the eight warps to finish with a slot (a
// count in shared memory) starts the stage `stages` ahead into it at once,
// so no thread waits to feed the ring and the next product's first stages
// land during the depthwise pass. There is no producer warp: the SM spreads
// a CTA's warps over four sub-partitions of 16K registers each, so a ninth
// warp puts three on one and caps every thread at 168 registers (96 at two
// CTAs per SM), under which the first tilings spilled. The two warpgroups
// split a sweep of the product into 2 UNITS (row tile, column block) units:
// warpgroup wg owns units wg, wg + 2, ..., each 64 x NB sums in registers,
// and each stage of B serves every unit.
// What bounds it, measured on an H100 (tools/hopper_probes): one CTA's bulk
// copies complete one after another, about 0.5 us each up to 24 KB,
// whatever the number in flight, so a CTA receives 8 GB/s in 4 KB copies,
// 24 GB/s in 12 KB and 45 GB/s in 24 KB; hence one copy per whole k-chunk.
// At C = 192 (12 KB f32 stages, two slots) a k-chunk's copy takes about as
// long as its products, and the f32 image moves twice the bytes mma.sync
// reads (hi and lo against f32). The products of a stage are short (a 64 x
// 96 x 8 TF32 product is 48 cycles of the SM's tensor cores) and chained
// three deep into the same sums, so a stage's latency, not the tensor
// core's rate, bounds the rest: the units' passes are interleaved and the
// next k-chunk's A is loaded while they run.
//
// Why each width takes its route (both routes timed on an H100; PERF.md):
// at C = 192 the slabs of 128 rows and two 12 KB slots fill the CTA and
// wgmma is faster. At C = 384 two 24 KB slots cost 16 of the 64 slab rows,
// at C = 128 two 8 KB slots 16 of 96 (two CTAs per SM), and the emptier
// 64-row tiles and the extra recompute lose to mma.sync; at C = 64 and 96
// (two CTAs per SM, 4-6 KB copies) the feed is slower per byte and
// mma.sync is as fast or faster. Those widths were timed with tilings for
// two CTAs per SM (64 x 2, 96 x 1) that are no longer compiled: 96 x 2,
// for C = 192, is the one wgmma tiling built. At C = 32, 256, 512 and 768
// no wgmma tiling fits (their column blocks do not fit one sweep, or the
// sums do not fit the registers).
//
// Why the slab stays channel-major. wgmma's RS form takes A from registers,
// so only B has to be K-major, and B is the weights, whose layout the
// wrapper owns. The depthwise scans, the load and the store, the halo rule
// and chain_plan's frame stay as the mma.sync route had them.
//
// Split TF32. TF32 keeps 10 mantissa bits, so one product pass is not an
// f32 product. Each operand is split, hi = tf32(v) (round to nearest on the
// f32 bit pattern: add 0x1000, clear the low 13 bits) and lo = tf32(v - hi)
// (toward zero, by the tensor core itself), and three products a_lo b_hi,
// a_hi b_lo, a_hi b_hi go into the same f32 accumulators, small terms
// first. What is dropped (a_lo b_lo and lo's own rounding) is of relative
// size 2^-21. A is split in registers on both routes; B in registers by
// mma.sync, in the packed image for wgmma. Under bf16 serving the weights
// are bf16 values, exact in TF32, so b_lo = 0 and that pass is skipped (the
// bf16 instantiations; the wgmma ring then carries hi alone).
//
// Where the sums are kept. The tensor core adds into its f32 sums toward
// zero, so sums carried through it drift low by up to half an ulp per
// product. Measured on an H100, max |err| against the f32 product at phase
// 3's shapes: mma.sync with its sums in the tensor core 7.4e-06 at C = 768
// (288 mma's per sum), with each k-step's three products started from zero
// and added to the running sums in f32 (FLUSH) 4.2e-07; wgmma at C = 192
// 2.0e-06 in the tensor core across the sweep, 6.3e-07 flushed every four
// k-chunks, 4.2e-07 flushed every k-chunk. The mma.sync tilings for one CTA
// per SM (C > 128) flush every k-step, for 6% of the kernel's time; those
// for two CTAs per SM (C <= 128, at most 16 k-steps) keep their sums in the
// tensor core, as under their register cap the flush spills. The wgmma
// tiling (one CTA per SM) flushes every four k-chunks: every k-chunk
// (part registers and a wait per unit) made the route slower than mma.sync
// at C = 192; never flushing read 9.1e-06 on phase 10's kernel_alpha
// chains, near phase 3's limit of 1e-05; every four costs 0.2 ms per
// embed+detect and reads 6.3e-07 (phase 3) at C = 192.
//
// The plan. The Python wrapper (ops/resblock_chain.py) chooses between one
// launch for the chain and one launch per block (halo 8) by a cost model
// of halo recompute against extra device-memory traffic, with the slabs
// and, on the wgmma route, two ring stages inside the CTA's shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kMaxM = 8;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;         // rows of one mma tile
constexpr int kWgRows = 64;       // rows of one wgmma tile
constexpr int kMaxItems = 3;      // depthwise (channel, segment) items per thread
constexpr int kSlabPad = 4;       // floats of padding per channel of a slab
constexpr int kMaxSmem = 232448;  // opt-in shared memory per block on sm_90
constexpr int kMaxStages = 8;     // ring stages of the wgmma route
constexpr int kBarBytes = 2 * kMaxStages * 8;  // the ring's mbarriers and release counts
// The K-major B image, no swizzle: a core matrix is 8 output channels by 4
// input channels (16 bytes each), 128 contiguous bytes.
constexpr uint32_t kLbo = 128;    // between the two core matrices of a k-chunk (K)
constexpr uint32_t kSbo = 256;    // between core matrices 8 output channels apart (N)

// Product tilings compiled, ops/resblock_chain.py holds the same tables:
// mma.sync X(NT, MT, CTAs per SM the register budget aims at) (_TILINGS);
// wgmma X(NB, UNITS, CTAs per SM) (the values of _WGMMA_WIDTHS): 96 x 2,
// the one width the route serves, C = 192.
#define WV_TILINGS(X) X(12, 2, 1) X(8, 3, 1) X(6, 4, 1) X(6, 2, 2) X(4, 3, 2)
#define WV_WG_TILINGS(X) X(96, 2, 1)

struct ChainScalars {
  float ps[kMaxM];
  float res_scale;
  float alpha;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Four consecutive time steps of x or the output as one 16-byte (f32) or
// 8-byte (bf16) access; p must be aligned to it.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  return make_float4(__low2float(lo), __high2float(lo), __low2float(hi), __high2float(hi));
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<const unsigned int*>(&lo);
  raw.y = *reinterpret_cast<const unsigned int*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

// Row stride of a channel in the slab: whole 16-row groups (the product
// works on 16-row tiles) plus kSlabPad floats, which sets the bank pattern
// of the A-fragment loads and of the depthwise scans.
__host__ __device__ __forceinline__ int slab_stride(int P) {
  return (P + kRows - 1) / kRows * kRows + kSlabPad;
}

__device__ __forceinline__ float elu(float v, float alpha) {
  return v > 0.f ? v : alpha * (expf(fminf(v, 0.f)) - 1.f);
}

// Round an f32 bit pattern to TF32 (10 mantissa bits), to nearest.
__device__ __forceinline__ uint32_t tf32_bits(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// hi = tf32(v), lo = v - hi. lo is handed over with all its f32 bits: the
// tensor core reads the upper 19 and drops the rest, which is lo's rounding
// to TF32 toward zero (measured on the card: the same error as rounding lo
// to nearest, and two instructions fewer per element).
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_bits(v);
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// ---------------------------------------------------------------------------
// route 0: mma.sync
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a b, with no sums carried in.
__device__ __forceinline__ void mma_tf32_first(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

// s[co][r] = sum_ci s[ci][r] * w[ci][co] for all P rows, in place, by split
// TF32 mma. wp is w in fragment order (see the header). The slab's row
// stride ld covers every 16-row group, so a tile's rows stay inside its
// channel; rows P.. of the last group hold no data and their sums go back
// there unread. SPLIT_B = false takes w as exact in TF32. FLUSH: the sums
// are carried in f32 adds outside the tensor core (see the header).
template <int NT, int MT, bool SPLIT_B, bool FLUSH>
__device__ void pointwise_inplace(float* s, int P, int C, int ld,
                                  const float4* __restrict__ wp, int wn, int wm) {
  static_assert(NT % 2 == 0, "n-tiles are packed in pairs");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int cgi = warp % wn, rgi = warp / wn;
  const int npairs = C >> 4, nks = C >> 3;
  const int p0 = cgi * (NT / 2);
  const int np = min(NT / 2, npairs - p0);  // pairs of n-tiles this warp owns
  const int chunk = wm * MT * kRows;
  const float4* wbase = wp + p0 * 32 + lane;
  for (int r0 = 0; r0 < P; r0 += chunk) {
    const int rb = r0 + rgi * MT * kRows;
    const bool active = rgi < wm && np > 0 && rb < P;
    float acc[MT][NT][4];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int nj = 0; nj < NT; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.f;
    if (active) {
      float4 bnext[NT / 2];
#pragma unroll
      for (int q = 0; q < NT / 2; ++q)
        bnext[q] = q < np ? __ldg(wbase + q * 32) : make_float4(0.f, 0.f, 0.f, 0.f);
      for (int ks = 0; ks < nks; ++ks) {
        // this k-step's B fragments; the next one's are fetched meanwhile
        float4 bcur[NT / 2];
#pragma unroll
        for (int q = 0; q < NT / 2; ++q) bcur[q] = bnext[q];
        if (ks + 1 < nks) {
          const float4* wk = wbase + (ks + 1) * npairs * 32;
#pragma unroll
          for (int q = 0; q < NT / 2; ++q)
            if (q < np) bnext[q] = __ldg(wk + q * 32);
        }
        uint32_t ah[MT][4], al[MT][4];
        const float* ap = s + (ks * 8 + t) * ld + rb + g;
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          if (rb + mi * kRows < P) {
            split_tf32(ap[mi * kRows], ah[mi][0], al[mi][0]);
            split_tf32(ap[mi * kRows + 8], ah[mi][1], al[mi][1]);
            split_tf32(ap[4 * ld + mi * kRows], ah[mi][2], al[mi][2]);
            split_tf32(ap[4 * ld + mi * kRows + 8], ah[mi][3], al[mi][3]);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) ah[mi][e] = al[mi][e] = 0u;
          }
        }
#pragma unroll
        for (int q = 0; q < NT / 2; ++q) {
          if (q < np) {
            const float bv[4] = {bcur[q].x, bcur[q].y, bcur[q].z, bcur[q].w};
            uint32_t bh[4], bl[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              if (SPLIT_B) {
                split_tf32(bv[e], bh[e], bl[e]);
              } else {
                bh[e] = __float_as_uint(bv[e]);
                bl[e] = 0u;
              }
            }
            // a tile's three products, small terms first; with FLUSH they
            // start from zero and join the running sums by an f32 add
#pragma unroll
            for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                float part[4];
                float(&d)[4] = FLUSH ? part : acc[mi][2 * q + h];
                if (FLUSH) {
                  mma_tf32_first(d, al[mi], bh[2 * h], bh[2 * h + 1]);
                } else {
                  mma_tf32(d, al[mi], bh[2 * h], bh[2 * h + 1]);
                }
                if (SPLIT_B) mma_tf32(d, ah[mi], bl[2 * h], bl[2 * h + 1]);
                mma_tf32(d, ah[mi], bh[2 * h], bh[2 * h + 1]);
                if (FLUSH) {
#pragma unroll
                  for (int e = 0; e < 4; ++e) acc[mi][2 * q + h][e] += part[e];
                }
              }
            }
          }
        }
      }
    }
    __syncthreads();
    if (active) {
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        if (rb + mi * kRows < P) {
#pragma unroll
          for (int nj = 0; nj < NT; ++nj) {
            if ((nj >> 1) < np) {
              float* o = s + ((p0 * 2 + nj) * 8 + 2 * t) * ld + rb + mi * kRows + g;
              o[0] = acc[mi][nj][0];
              o[ld] = acc[mi][nj][1];
              o[8] = acc[mi][nj][2];
              o[ld + 8] = acc[mi][nj][3];
            }
          }
        }
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// route 1: wgmma, B staged by bulk copies
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Wait for the phase of parity `parity` to complete. A ring that never
// completes is a fault of the kernel: after 10 s of waiting the thread
// traps (a launch error the caller sees) instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint64_t start = 0;
  for (uint32_t n = 1;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if ((n & 1023u) == 0) {
      uint64_t now;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
      if (start == 0) {
        start = now;
      } else if (now - start > 10000000000ull) {
        __trap();
      }
    }
  }
}

// One bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from global to shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Matrix descriptor of a K-major B operand in the image above, no swizzle.
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(kLbo >> 4) << 16) |
         ((uint64_t)(kSbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// Wait until at most N of the warpgroup's committed groups are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Registers the asynchronous wgmma writes or reads: after its wait, each is
// marked as touched here, so that no read of the sums and no reuse of the A
// registers is moved before the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&r)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d (+)= A B for a 64 x N tile: A (64 x 8, TF32) from registers, B (8 x N)
// from shared memory by descriptor; scale_d = 0 ignores d's old value.
// The operand form of CUTLASS's MMA_64xNx8_F32TF32TF32_RS_TN.
__device__ __forceinline__ void wgmma_tf32_n96(float (&d)[48], const uint32_t (&a)[4],
                                                uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <int NB>
__device__ __forceinline__ void wgmma_tf32(float (&d)[NB / 2], const uint32_t (&a)[4],
                                           uint64_t desc, int scale_d) {
  static_assert(NB == 96, "no wgmma wrapper for this NB");
  wgmma_tf32_n96(d, a, desc, scale_d);
}

// The ring of B stages: `stages` slots of `stage_bytes` (one k-chunk of 8
// input channels by all C output channels), each with a full barrier (the
// issuer's expect_tx and the bulk copy's bytes) and a release count in
// shared memory. Every thread keeps the consumer's place: `index` counts
// the stages of the launch it has entered, `slot` and `phase` follow it.
// The source walks the launch's stages in the workers' order (M blocks x
// pw1, pw2 x sweeps x k-chunks): stage ks of block i's image starts (i C /
// 8 + ks) stages into it; a sweep over more rows reads the same stages
// again.
struct Ring {
  uint32_t data, full;
  int* released;
  int stages, stage_bytes;
  int index, slot;
  uint32_t phase;
  const char* pw1;
  const char* pw2;
  int per_block;  // stages of one block's image
  int sweeps;     // sweeps per product
  int total;      // stages of the launch

  __device__ __forceinline__ void advance() {
    ++index;
    if (++slot == stages) {
      slot = 0;
      phase ^= 1u;
    }
  }

  // One thread: start stage `at` of the launch into its slot.
  __device__ void issue(int at) const {
    const int slot_at = at % stages;
    const uint32_t bar = full + 8 * slot_at;
    const int per_product = sweeps * per_block;
    const int blk = at / (2 * per_product), rem = at % (2 * per_product);
    const char* img = (rem >= per_product ? pw2 : pw1) +
                      ((size_t)blk * per_block + rem % per_block) * stage_bytes;
    mbar_expect_tx(bar, stage_bytes);
    bulk_load(data + slot_at * stage_bytes, img, stage_bytes, bar);
  }

  // Lane 0 of each warp, when the warp's products have read stage `at`
  // (in slot `at_slot`): the last of the kWarps warps to release the slot
  // refills it with the stage `stages` ahead, so no thread ever waits to
  // feed the ring.
  __device__ __forceinline__ void release(int at_slot, int at) const {
    if (atomicAdd(released + at_slot, 1) == kWarps - 1) {
      released[at_slot] = 0;
      if (at + stages < total) issue(at + stages);
    }
  }
};

// Rows one sweep of the wgmma product covers: the 2 UNITS (row tile,
// column block) units of the two warpgroups cover every column block of
// 2 UNITS / (C / NB) row tiles.
template <int NB, int UNITS>
__device__ __forceinline__ int wg_sweep_tiles(int C) {
  return 2 * UNITS / (C / NB);
}

// s[co][r] = sum_ci s[ci][r] * w[ci][co] for all P rows, in place, by split
// TF32 wgmma. Warpgroup wg owns units q = wg + 2 j (j < UNITS) of a sweep:
// column block q / tiles, row tile q % tiles, its 64 x NB sums in registers.
// The tensor core carries them over kFlushChunks k-chunks, starting from
// zero (scale-d = 0), and then they join running sums kept in f32
// registers (see the header). For each
// k-chunk ks of 8 input channels the ring holds B's stage: per column block
// cb the K-major image of w[8 ks .. 8 ks + 8][NB cb .. NB cb + NB] in TF32
// hi and, with SPLIT_B, lo (pack_wgmma_weights). A warp's 16 x 8 piece of A
// comes from the slab as in pointwise_inplace; rows P.. of the last 16-row
// group hold no data and their sums go back there unread, and a warp whose
// 16 rows lie past P loads zeros and writes nothing.
//
// A stage's products are one group: the units' two or three passes go out
// interleaved (u0 p1, u1 p1, u0 p2, ...), so that a product summing into a
// unit's registers has the other units' beside it in the tensor core's
// pipeline; then the warps wait for the group and release the stage's slot
// at once (with two slots, holding one longer starves the copies). The next
// k-chunk's A fragments come from the slab while the group runs, into the
// other of two register sets. No branch encloses a wgmma (ptxas serializes
// them there): a unit whose rows lie past P runs on zeros and is not
// written back.
template <int NB, int UNITS, bool SPLIT_B>
__device__ void pointwise_wgmma(float* s, int P, int C, int ld, Ring& ring) {
  constexpr int kFlushChunks = 4;  // k-chunks the sums stay in the tensor core
  constexpr int NR = NB / 2;  // sums per thread of one unit
  constexpr int kBlockBytes = (SPLIT_B ? 2 : 1) * NB * 32;  // a column block's image
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wg = warp >> 2, wi = warp & 3;
  const int nks = C >> 3;  // even: C is a multiple of 16
  const int tiles = wg_sweep_tiles<NB, UNITS>(C);
  for (int r0 = 0; r0 < P; r0 += tiles * kWgRows) {
    float acc[UNITS][NR];
#pragma unroll
    for (int j = 0; j < UNITS; ++j)
#pragma unroll
      for (int e = 0; e < NR; ++e) acc[j][e] = 0.f;
    float sum[UNITS][NR];
#pragma unroll
    for (int j = 0; j < UNITS; ++j)
#pragma unroll
      for (int e = 0; e < NR; ++e) sum[j][e] = 0.f;
    uint32_t ah[2][UNITS][4], al[2][UNITS][4];
    // k-chunk ks's A fragments of every unit into register set `par`
    auto load_a = [&](int ks, int par) {
#pragma unroll
      for (int j = 0; j < UNITS; ++j) {
        const int q = wg + 2 * j;
        const int rw = r0 + (q % tiles) * kWgRows + 16 * wi;  // this warp's rows
        if (rw < P) {
          const float* ap = s + (ks * 8 + t) * ld + rw + g;
          split_tf32(ap[0], ah[par][j][0], al[par][j][0]);
          split_tf32(ap[8], ah[par][j][1], al[par][j][1]);
          split_tf32(ap[4 * ld], ah[par][j][2], al[par][j][2]);
          split_tf32(ap[4 * ld + 8], ah[par][j][3], al[par][j][3]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) ah[par][j][e] = al[par][j][e] = 0u;
        }
      }
    };
    load_a(0, 0);
    for (int ks0 = 0; ks0 < nks; ks0 += 2) {
#pragma unroll
      for (int par = 0; par < 2; ++par) {
        const int ks = ks0 + par;
        const uint32_t stage = ring.data + ring.slot * ring.stage_bytes;
        mbar_wait(ring.full + 8 * ring.slot, ring.phase);
        __syncwarp();
        const int scale_first = ks % kFlushChunks == 0 ? 0 : 1;
        wgmma_fence();
        // pass 0: a_lo b_hi; pass 1 (SPLIT_B): a_hi b_lo; pass 2: a_hi b_hi
#pragma unroll
        for (int pass = 0; pass < 3; ++pass) {
          if (pass == 1 && !SPLIT_B) continue;
#pragma unroll
          for (int j = 0; j < UNITS; ++j) {
            const uint32_t blk = stage + ((wg + 2 * j) / tiles) * kBlockBytes;
            wgmma_tf32<NB>(acc[j], pass == 0 ? al[par][j] : ah[par][j],
                           b_desc(pass == 1 ? blk + NB * 32 : blk),
                           pass == 0 ? scale_first : 1);
          }
        }
        wgmma_commit();
        if (ks + 1 < nks) load_a(ks + 1, par ^ 1);
        wgmma_wait<0>();
#pragma unroll
        for (int j = 0; j < UNITS; ++j) {
          fence_regs(acc[j]);
          fence_regs(ah[par][j]);
          fence_regs(al[par][j]);
        }
        if (ks % kFlushChunks == kFlushChunks - 1 || ks == nks - 1) {
#pragma unroll
          for (int j = 0; j < UNITS; ++j)
#pragma unroll
            for (int e = 0; e < NR; ++e) sum[j][e] += acc[j][e];
        }
        __syncwarp();
        if (lane == 0) ring.release(ring.slot, ring.index);
        ring.advance();
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < UNITS; ++j) {
      const int q = wg + 2 * j;
      const int rw = r0 + (q % tiles) * kWgRows + 16 * wi;
      if (rw < P) {
#pragma unroll
        for (int jn = 0; jn < NB / 8; ++jn) {
          float* o = s + ((q / tiles) * NB + 8 * jn + 2 * t) * ld + rw + g;
          o[0] = sum[j][4 * jn];
          o[ld] = sum[j][4 * jn + 1];
          o[8] = sum[j][4 * jn + 2];
          o[ld + 8] = sum[j][4 * jn + 3];
        }
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// the passes both routes share
// ---------------------------------------------------------------------------

// Causal depthwise conv of u in place (row t reads rows t-K+1..t), plus
// bias, with rows before the start of time (global time gbase + row < 0)
// zeroed. LAST = false: u = ELU(result). LAST = true: xs += res_scale *
// result, zeroed at the same rows, and, if a block follows, u = ELU(xs *
// ps_next), the next block's input.
template <int K, bool LAST>
__device__ void depthwise_inplace(float* u, float* xs, int P, int C, int ld,
                                  const float* __restrict__ dw,
                                  const float* __restrict__ bias, int gbase,
                                  const ChainScalars& sc, bool more = false,
                                  float ps_next = 1.f) {
  const int nseg = max(1, min(P, kMaxItems * kThreads / C));
  const int seglen = (P + nseg - 1) / nseg;
  const int items = C * nseg;
  float hist[kMaxItems][K - 1];
#pragma unroll
  for (int it = 0; it < kMaxItems; ++it) {
    const int item = threadIdx.x + it * kThreads;
    if (item < items) {
      const int c = item % C, s0 = (item / C) * seglen;
#pragma unroll
      for (int j = 0; j < K - 1; ++j) {
        const int r = s0 - (K - 1) + j;
        hist[it][j] = (r >= 0 && r < P) ? u[c * ld + r] : 0.f;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int it = 0; it < kMaxItems; ++it) {
    const int item = threadIdx.x + it * kThreads;
    if (item < items) {
      const int c = item % C, s0 = (item / C) * seglen;
      const int s1 = min(P, s0 + seglen);
      float w[K];
#pragma unroll
      for (int j = 0; j < K; ++j) w[j] = dw[j * C + c];
      const float b = bias[c];
      float h[K - 1];
#pragma unroll
      for (int j = 0; j < K - 1; ++j) h[j] = hist[it][j];
      for (int t = s0; t < s1; ++t) {
        const float v = u[c * ld + t];
        float acc = v * w[K - 1];
#pragma unroll
        for (int j = 0; j < K - 1; ++j) acc = acc + h[j] * w[j];
        acc = acc + b;
        const bool pad = gbase + t < 0;
        if (LAST) {
          const float xv = pad ? 0.f : acc * sc.res_scale + xs[c * ld + t];
          xs[c * ld + t] = xv;
          if (more) u[c * ld + t] = elu(xv * ps_next, sc.alpha);
        } else {
          u[c * ld + t] = elu(pad ? 0.f : acc, sc.alpha);
        }
#pragma unroll
        for (int j = 0; j < K - 2; ++j) h[j] = h[j + 1];
        h[K - 2] = v;
      }
    }
  }
  __syncthreads();
}

// The chain on one (batch, T-tile) of kThreads threads: load the slabs,
// walk the M blocks (product(u, P, ld, i, second) is the route's 1x1
// product of block i, the first or the second of the block), store.
template <typename T, int K, typename Product>
__device__ void run_chain(const T* __restrict__ x, T* __restrict__ out, float* xs,
                          float* us, const float* __restrict__ dw1,
                          const float* __restrict__ b1, const float* __restrict__ dw2,
                          const float* __restrict__ b2, int C, int T_len, int M,
                          int t_tile, const ChainScalars& sc, Product product) {
  const int H = M * 2 * (K - 1);
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * t_tile;
  const int tt = min(t_tile, T_len - t0);
  const int P = H + tt;
  const int ld = slab_stride(P);
  const int gbase = t0 - H;

  // Tiles start at multiples of 4 and halos are multiples of 4, so when T
  // is a multiple of 4 (and the pointers and the slab stride are aligned)
  // every group of 4 rows is one aligned access, wholly before the start of
  // time or wholly inside the tile: four times the bytes in flight per
  // thread, which is what the load is short of at one CTA per SM.
  const bool vec4 =
      T_len % 4 == 0 && t_tile % 4 == 0 && ld % 4 == 0 &&
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) %
              (4 * sizeof(T)) == 0;
  const T* xb = x + (size_t)b * C * T_len;
  const float ps0 = sc.ps[0];
  if (vec4) {
    const int P4 = P / 4;
    for (int idx = threadIdx.x; idx < C * P4; idx += kThreads) {
      const int c = idx / P4, r = (idx - c * P4) * 4;
      const int g = gbase + r;
      const float4 v = g >= 0 ? load4(xb + (size_t)c * T_len + g)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
      store4(xs + c * ld + r, v);
      store4(us + c * ld + r,
             make_float4(elu(v.x * ps0, sc.alpha), elu(v.y * ps0, sc.alpha),
                         elu(v.z * ps0, sc.alpha), elu(v.w * ps0, sc.alpha)));
    }
  } else {
    for (int idx = threadIdx.x; idx < C * P; idx += kThreads) {
      const int c = idx / P, r = idx - c * P;
      const int g = gbase + r;
      const float v = g >= 0 ? to_f(xb[(size_t)c * T_len + g]) : 0.f;
      xs[c * ld + r] = v;
      us[c * ld + r] = elu(v * ps0, sc.alpha);
    }
  }
  __syncthreads();

  for (int i = 0; i < M; ++i) {
    product(us, P, ld, i, 0);
    depthwise_inplace<K, false>(us, xs, P, C, ld, dw1 + (size_t)i * K * C,
                                b1 + (size_t)i * C, gbase, sc);
    product(us, P, ld, i, 1);
    depthwise_inplace<K, true>(us, xs, P, C, ld, dw2 + (size_t)i * K * C,
                               b2 + (size_t)i * C, gbase, sc, i + 1 < M,
                               sc.ps[i + 1 < M ? i + 1 : i]);
  }

  T* ob = out + (size_t)b * C * T_len;
  if (vec4) {
    const int tt4 = tt / 4;
    for (int idx = threadIdx.x; idx < C * tt4; idx += kThreads) {
      const int c = idx / tt4, r = (idx - c * tt4) * 4;
      store4(ob + (size_t)c * T_len + t0 + r, load4(xs + c * ld + H + r));
    }
  } else {
    for (int idx = threadIdx.x; idx < C * tt; idx += kThreads) {
      const int c = idx / tt, r = idx - c * tt;
      ob[(size_t)c * T_len + t0 + r] = from_f<T>(xs[c * ld + H + r]);
    }
  }
}

// T = float: f32 I/O, weights split into hi and lo (three passes).
// T = bf16: bf16 I/O, weights exact in TF32 (two passes).
template <typename T, int NT, int MT, int MINB, int K>
__global__ void __launch_bounds__(kThreads, MINB)
resblock_chain_kernel(const T* __restrict__ x, const float* __restrict__ pw1,
                      const float* __restrict__ dw1, const float* __restrict__ b1,
                      const float* __restrict__ pw2, const float* __restrict__ dw2,
                      const float* __restrict__ b2, T* __restrict__ out, int C,
                      int T_len, int M, int t_tile, int stages, ChainScalars sc) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr bool kSplitB = sizeof(T) == sizeof(float);
  const int H = M * 2 * (K - 1);
  const int ld = slab_stride(H + min(t_tile, T_len - (int)blockIdx.x * t_tile));
  const int wn = (C + 8 * NT - 1) / (8 * NT), wm = kWarps / wn;
  const size_t wstride = (size_t)C * C / 4;  // float4's of one block's pw
  float* xs = reinterpret_cast<float*>(smem);
  auto product = [&](float* u, int P, int ldu, int i, int second) {
    const float4* wp = reinterpret_cast<const float4*>(second ? pw2 : pw1) + i * wstride;
    pointwise_inplace<NT, MT, kSplitB, MINB == 1>(u, P, C, ldu, wp, wn, wm);
  };
  run_chain<T, K>(x, out, xs, xs + C * ld, dw1, b1, dw2, b2, C, T_len, M, t_tile, sc,
                  product);
}

// The wgmma route: the same chain, with B's ring behind the slabs, fed by
// thread 0.
template <typename T, int NB, int UNITS, int MINB, int K>
__global__ void __launch_bounds__(kThreads, MINB)
resblock_chain_wgmma_kernel(const T* __restrict__ x, const float* __restrict__ pw1,
                            const float* __restrict__ dw1, const float* __restrict__ b1,
                            const float* __restrict__ pw2, const float* __restrict__ dw2,
                            const float* __restrict__ b2, T* __restrict__ out, int C,
                            int T_len, int M, int t_tile, int stages, ChainScalars sc) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr bool kSplitB = sizeof(T) == sizeof(float);
  const int H = M * 2 * (K - 1);
  const int P = H + min(t_tile, T_len - (int)blockIdx.x * t_tile);
  const int ld = slab_stride(P);
  const int rows_per_sweep = wg_sweep_tiles<NB, UNITS>(C) * kWgRows;
  float* xs = reinterpret_cast<float*>(smem + kBarBytes);
  Ring ring;
  ring.full = smem_addr(smem);
  ring.released = reinterpret_cast<int*>(smem + 8 * kMaxStages);
  ring.data = smem_addr(xs + 2 * C * ld);
  ring.stages = stages;
  ring.stage_bytes = (kSplitB ? 2 : 1) * C * 32;
  ring.index = 0;
  ring.slot = 0;
  ring.phase = 0;
  ring.pw1 = reinterpret_cast<const char*>(pw1);
  ring.pw2 = reinterpret_cast<const char*>(pw2);
  ring.per_block = C / 8;
  ring.sweeps = (P + rows_per_sweep - 1) / rows_per_sweep;
  ring.total = M * 2 * ring.sweeps * ring.per_block;
  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(ring.full + 8 * i, 1);
      ring.released[i] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    // the first stages land while the slabs load
    for (int i = 0; i < stages && i < ring.total; ++i) ring.issue(i);
  }
  __syncthreads();
  auto product = [&](float* u, int Pu, int ldu, int, int) {
    pointwise_wgmma<NB, UNITS, kSplitB>(u, Pu, C, ldu, ring);
  };
  run_chain<T, K>(x, out, xs, xs + C * ld, dw1, b1, dw2, b2, C, T_len, M, t_tile, sc,
                  product);
}

template <typename T>
using Kernel = void (*)(const T*, const float*, const float*, const float*, const float*,
                        const float*, const float*, T*, int, int, int, int, int,
                        ChainScalars);

enum Route { kMmaSync = 0, kWgmma = 1 };

// Every tiling is compiled for each depthwise width K the wrapper takes
// (KERNEL_SIZES in ops/resblock_chain.py). (a, b) is (NT, MT) for mma.sync
// and (NB, UNITS) for wgmma.
template <typename T>
Kernel<T> select_kernel(int route, int a, int b, int k) {
#define X(NT_, MT_, MINB_)                                                     \
  if (route == kMmaSync && a == NT_ && b == MT_ && k == 3)                     \
    return resblock_chain_kernel<T, NT_, MT_, MINB_, 3>;                       \
  if (route == kMmaSync && a == NT_ && b == MT_ && k == 5)                     \
    return resblock_chain_kernel<T, NT_, MT_, MINB_, 5>;
  WV_TILINGS(X)
#undef X
#define X(NB_, UNITS_, MINB_)                                                  \
  if (route == kWgmma && a == NB_ && b == UNITS_ && k == 3)                    \
    return resblock_chain_wgmma_kernel<T, NB_, UNITS_, MINB_, 3>;              \
  if (route == kWgmma && a == NB_ && b == UNITS_ && k == 5)                    \
    return resblock_chain_wgmma_kernel<T, NB_, UNITS_, MINB_, 5>;
  WV_WG_TILINGS(X)
#undef X
  return nullptr;
}

// Shared memory of one CTA whose slabs hold `rows` rows (and, for wgmma,
// the ring's barriers and stages); 0 if it does not fit.
size_t chain_smem(int route, int C, int rows, int nb, int stages, bool bf16) {
  size_t smem = 2 * (size_t)C * slab_stride(rows) * sizeof(float);
  if (route == kWgmma) smem += kBarBytes + (size_t)stages * (bf16 ? 1 : 2) * C * 32;
  return smem <= (size_t)kMaxSmem ? smem : 0;
}

bool shape_ok(int C, int M, int K, int route, int a, int b, int stages) {
  if ((K != 3 && K != 5) || M < 1 || M > kMaxM || C < 16 || C % 16 != 0) return false;
  if (route == kMmaSync) {
    if ((C + 8 * a - 1) / (8 * a) > kWarps) return false;
  } else if (route == kWgmma) {
    // whole column blocks, and every column block of a row tile in one sweep
    if (C % a != 0 || (2 * b) % (C / a) != 0 || stages < 2 || stages > kMaxStages)
      return false;
  } else {
    return false;
  }
  // the depthwise pass holds at most kMaxItems items per thread
  const int nseg_max = kMaxItems * kThreads / C;
  return C * (nseg_max > 1 ? nseg_max : 1) <= kMaxItems * kThreads;
}

template <typename T>
cudaError_t launch(const void* x, const void* pw1, const void* dw1, const void* b1,
                   const void* pw2, const void* dw2, const void* b2, void* out, int B,
                   int C, int T_len, int M, int K, int t_tile, int route, int a, int b,
                   int stages, const ChainScalars& sc, cudaStream_t stream) {
  Kernel<T> kern = select_kernel<T>(route, a, b, K);
  if (kern == nullptr) return cudaErrorInvalidValue;
  const int H = M * 2 * (K - 1);
  const size_t smem = chain_smem(route, C, H + (t_tile < T_len ? t_tile : T_len), a, stages,
                                 sizeof(T) != sizeof(float));
  if (smem == 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((T_len + t_tile - 1) / t_tile, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(pw1),
      static_cast<const float*>(dw1), static_cast<const float*>(b1),
      static_cast<const float*>(pw2), static_cast<const float*>(dw2),
      static_cast<const float*>(b2), static_cast<T*>(out), C, T_len, M, t_tile, stages,
      sc);
  return cudaGetLastError();
}

template <typename T>
cudaError_t info(int C, int rows, int route, int a, int b, int stages, int* regs,
                 int* ctas_per_sm, int* smem_bytes) {
  Kernel<T> kern = select_kernel<T>(route, a, b, 5);
  const size_t smem = chain_smem(route, C, rows, a, stages, sizeof(T) != sizeof(float));
  if (kern == nullptr || smem == 0) return cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kern);
  if (err != cudaSuccess) return err;
  *regs = attr.numRegs;
  *smem_bytes = (int)smem;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, kern, kThreads, smem);
}

}  // namespace

extern "C" {

// pw1 and pw2 are in the route's order (pack_chain_weights for mma.sync,
// pack_wgmma_weights for wgmma); (a, b) names one of the route's compiled
// tilings; stages is the wgmma ring's depth (ignored by mma.sync).
int wv_resblock_chain(const void* x, const void* pw1, const void* dw1, const void* b1,
                      const void* pw2, const void* dw2, const void* b2, void* out, int B,
                      int C, int T_len, int M, int K, int t_tile, int route, int a, int b,
                      int stages, const float* prescales, float res_scale, float alpha,
                      int is_bf16, void* stream) {
  if (B < 1 || T_len < 1 || t_tile < 1 || !shape_ok(C, M, K, route, a, b, stages))
    return (int)cudaErrorInvalidValue;
  ChainScalars sc;
  for (int i = 0; i < kMaxM; ++i) sc.ps[i] = i < M ? prescales[i] : 1.f;
  sc.res_scale = res_scale;
  sc.alpha = alpha;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(x, pw1, dw1, b1, pw2, dw2, b2, out, B, C, T_len, M,
                                      K, t_tile, route, a, b, stages, sc, s)
              : launch<float>(x, pw1, dw1, b1, pw2, dw2, b2, out, B, C, T_len, M, K,
                              t_tile, route, a, b, stages, sc, s);
  return (int)err;
}

// Registers per thread of the instantiation (route, a, b, is_bf16) at K = 5,
// the shared memory of one CTA whose slabs hold `rows` rows of C channels
// (with `stages` ring stages for wgmma), and the CTAs of it one SM holds.
int wv_resblock_chain_info(int C, int rows, int route, int a, int b, int stages, int is_bf16,
                           int* regs, int* ctas_per_sm, int* smem_bytes) {
  if (!shape_ok(C, 1, 5, route, a, b, route == kWgmma ? stages : 2) || rows < 1)
    return (int)cudaErrorInvalidValue;
  return (int)(is_bf16 ? info<__nv_bfloat16>(C, rows, route, a, b, stages, regs,
                                             ctas_per_sm, smem_bytes)
                       : info<float>(C, rows, route, a, b, stages, regs, ctas_per_sm,
                                     smem_bytes));
}

const char* wv_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
