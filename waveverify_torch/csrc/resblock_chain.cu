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
// Design. One CTA of 256 threads owns one (batch, T-tile). It loads the tile
// plus H = M * 2 * (K - 1) rows of history into shared memory as an f32 slab
// stored channel-major, xs[c][row], and walks all M blocks there, so device
// memory sees one read of x and one write of the output for the whole
// launch. A second slab us holds u; the pass that produces a block's input
// (the load, or the previous block's last depthwise pass) also writes its
// ELU there. The depthwise convolutions run in place:
// each thread scans a (channel, row-segment) item in time order, with the
// K - 1 history values read into registers before anyone writes. Rows before
// the start of time are loaded as zero and re-zeroed after every bias add,
// which is the causal zero padding; the history rows at the top of a later
// tile are recomputed and discarded.
//
// The 1x1 products run on the tensor cores, in place on us, a chunk of R
// rows by all C columns at a time. The instruction is the warp-level
//   mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32
// with M = time rows, N = output channels, K = input channels. With
// g = lane >> 2 and t = lane & 3 a lane holds
//   A (16 x 8):  a0 = A[g][t]   a1 = A[g+8][t]   a2 = A[g][t+4]  a3 = A[g+8][t+4]
//   B (8 x 8):   b0 = B[t][g]   b1 = B[t+4][g]
//   D (16 x 8):  d0 = D[g][2t]  d1 = D[g][2t+1]  d2 = D[g+8][2t] d3 = D[g+8][2t+1]
// A[r][ci] = us[ci * ld + r] comes from the slab with four 4-byte shared
// loads per 16 x 8 tile. B[ci][co] = pw[ci][co] goes from global memory (L2)
// straight to registers: every warp owns distinct output columns, so no pw
// element is shared inside a CTA and shared memory would buy nothing. The
// wrapper lays pw out in fragment order (pack_chain_weights): for k-step ks
// and the pair p of neighbouring n-tiles, lane l finds its four values
// (b0, b1 of tile 2p, b0, b1 of tile 2p + 1) as one float4 at
// [(ks * C / 16 + p) * 32 + l], so a warp's load is 512 contiguous bytes.
// The next k-step's fragments are fetched while the current mma's run. A
// warp keeps MT x NT accumulator tiles (16 MT rows by 8 NT columns) in
// registers; wn = ceil(C / (8 NT)) warps cover the columns and 8 / wn row
// groups share a chunk, so R = (8 / wn) * 16 * MT. The CTA writes a chunk
// only after every warp has read it (sums in registers, barrier, write,
// barrier).
//
// Split TF32. TF32 keeps 10 mantissa bits, so one product pass is not an
// f32 product. Each operand is split in registers, hi = tf32(v) (round to
// nearest on the f32 bit pattern: add 0x1000, clear the low 13 bits) and
// lo = tf32(v - hi) (toward zero, by the tensor core itself), and three
// products a_lo b_hi, a_hi b_lo, a_hi b_hi go into the same f32
// accumulators, small terms first. What is dropped (a_lo b_lo and lo's own
// rounding) is of relative size 2^-21. Under bf16
// serving the weights are bf16 values, exact in TF32, so b_lo = 0 and that
// pass is skipped (the bf16 instantiations).
//
// Where the sums are kept. The tensor core adds into its f32 sums toward
// zero, so sums carried through it drift low by up to half an ulp per mma:
// measured on an H100, max |err| against the f32 product grew with the
// number of k-steps, to 7.4e-06 at C = 768 (288 mma's per sum). The tilings
// for one CTA per SM (C > 128) therefore start each k-step's three products
// from zero and add them to the running sums with an f32 add, which rounds
// to nearest: 4.2e-07 at C = 768, for 6% of the kernel's time. The tilings
// for two CTAs per SM (C <= 128, at most 16 k-steps, max |err| 1.2e-06) keep
// their sums in the tensor core: under their 128-register cap the extra
// four registers per tile in flight spill.
//
// What bounds it. Per chunk the CTA re-reads the whole C x C matrix from
// L2: 2 R C^2 FLOP per 4 C^2 bytes, i.e. R / 2 FLOP per L2 byte, and R is
// capped by the registers that hold the sums (R C / 256 per thread, 96 at
// most) and by the two slabs in 227 KB of shared memory (32 rows at
// C = 768). Measured on an H100, one product pass runs at 37% of the TF32
// peak at R = 32 (C = 768) and at 57% at R = 128 (C = 192): the L2 reads
// weigh most where R is smallest, and elsewhere the rate at which mma.sync
// is fed from registers is the limit. The products are about 60% of the
// kernel's time; the rest are the elementwise passes (depthwise, load,
// store), which are latency-bound at one CTA per SM. The Python wrapper
// (ops/resblock_chain.py) picks NT, MT and the tile per width, and chooses
// between one launch for the chain and one launch per block (halo 8) by a
// cost model of halo recompute against extra device-memory traffic.
//
// Why not wgmma. Hopper's warpgroup mma reaches a higher rate, but in TF32
// it takes its shared-memory operands K-major only. The slab is contiguous
// in rows per channel, which the depthwise scans depend on; wgmma would need
// a transposed, swizzled slab and a rewrite of those passes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kMaxM = 8;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;         // rows of one mma tile
constexpr int kMaxItems = 3;      // depthwise (channel, segment) items per thread
constexpr int kSlabPad = 4;       // floats of padding per channel of a slab
constexpr int kMaxSmem = 232448;  // opt-in shared memory per block on sm_90

// Product tilings compiled: X(NT, MT, CTAs per SM the register budget aims
// at). ops/resblock_chain.py holds the same table (_TILINGS).
#define WV_TILINGS(X) X(12, 2, 1) X(8, 3, 1) X(6, 4, 1) X(6, 2, 2) X(4, 3, 2)

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

// T = float: f32 I/O, weights split into hi and lo (three passes).
// T = bf16: bf16 I/O, weights exact in TF32 (two passes).
template <typename T, int NT, int MT, int MINB, int K>
__global__ void __launch_bounds__(kThreads, MINB)
resblock_chain_kernel(const T* __restrict__ x, const float4* __restrict__ pw1,
                      const float* __restrict__ dw1, const float* __restrict__ b1,
                      const float4* __restrict__ pw2, const float* __restrict__ dw2,
                      const float* __restrict__ b2, T* __restrict__ out, int C,
                      int T_len, int M, int t_tile, ChainScalars sc) {
  extern __shared__ __align__(16) float smem[];
  constexpr bool kSplitB = sizeof(T) == sizeof(float);
  constexpr bool kFlush = MINB == 1;
  const int H = M * 2 * (K - 1);
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * t_tile;
  const int tt = min(t_tile, T_len - t0);
  const int P = H + tt;
  const int ld = slab_stride(P);
  const int gbase = t0 - H;
  const int wn = (C + 8 * NT - 1) / (8 * NT), wm = kWarps / wn;
  const size_t wstride = (size_t)C * C / 4;  // float4's of one block's pw
  float* xs = smem;
  float* us = smem + C * ld;

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
    pointwise_inplace<NT, MT, kSplitB, kFlush>(us, P, C, ld, pw1 + i * wstride, wn, wm);
    depthwise_inplace<K, false>(us, xs, P, C, ld, dw1 + (size_t)i * K * C,
                                   b1 + (size_t)i * C, gbase, sc);
    pointwise_inplace<NT, MT, kSplitB, kFlush>(us, P, C, ld, pw2 + i * wstride, wn, wm);
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

template <typename T>
using Kernel = void (*)(const T*, const float4*, const float*, const float*,
                        const float4*, const float*, const float*, T*, int, int, int,
                        int, ChainScalars);

// Every tiling is compiled for each depthwise width K the wrapper takes
// (KERNEL_SIZES in ops/resblock_chain.py).
template <typename T>
Kernel<T> select_kernel(int nt, int mt, int k) {
#define X(NT_, MT_, MINB_)                                                 \
  if (nt == NT_ && mt == MT_ && k == 3)                                    \
    return resblock_chain_kernel<T, NT_, MT_, MINB_, 3>;                   \
  if (nt == NT_ && mt == MT_ && k == 5)                                    \
    return resblock_chain_kernel<T, NT_, MT_, MINB_, 5>;
  WV_TILINGS(X)
#undef X
  return nullptr;
}

// Shared memory of one CTA whose slabs hold `rows` rows; 0 if it does not fit.
size_t slab_smem(int C, int rows) {
  const size_t smem = 2 * (size_t)C * slab_stride(rows) * sizeof(float);
  return smem <= (size_t)kMaxSmem ? smem : 0;
}

bool shape_ok(int C, int M, int K, int nt) {
  if ((K != 3 && K != 5) || M < 1 || M > kMaxM || C < 16 || C % 16 != 0) return false;
  if ((C + 8 * nt - 1) / (8 * nt) > kWarps) return false;
  // the depthwise pass holds at most kMaxItems items per thread
  const int nseg_max = kMaxItems * kThreads / C;
  return C * (nseg_max > 1 ? nseg_max : 1) <= kMaxItems * kThreads;
}

template <typename T>
cudaError_t launch(const void* x, const void* pw1, const void* dw1, const void* b1,
                   const void* pw2, const void* dw2, const void* b2, void* out, int B,
                   int C, int T_len, int M, int K, int t_tile, int nt, int mt,
                   const ChainScalars& sc, cudaStream_t stream) {
  Kernel<T> kern = select_kernel<T>(nt, mt, K);
  if (kern == nullptr) return cudaErrorInvalidValue;
  const int H = M * 2 * (K - 1);
  const size_t smem = slab_smem(C, H + (t_tile < T_len ? t_tile : T_len));
  if (smem == 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((T_len + t_tile - 1) / t_tile, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float4*>(pw1),
      static_cast<const float*>(dw1), static_cast<const float*>(b1),
      static_cast<const float4*>(pw2), static_cast<const float*>(dw2),
      static_cast<const float*>(b2), static_cast<T*>(out), C, T_len, M, t_tile, sc);
  return cudaGetLastError();
}

template <typename T>
cudaError_t info(int C, int rows, int nt, int mt, int* regs, int* ctas_per_sm) {
  Kernel<T> kern = select_kernel<T>(nt, mt, 5);
  const size_t smem = slab_smem(C, rows);
  if (kern == nullptr || smem == 0) return cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kern);
  if (err != cudaSuccess) return err;
  *regs = attr.numRegs;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, kern, kThreads, smem);
}

}  // namespace

extern "C" {

// pw1 and pw2 are in fragment order (pack_chain_weights); nt, mt name one of
// the compiled product tilings.
int wv_resblock_chain(const void* x, const void* pw1, const void* dw1, const void* b1,
                      const void* pw2, const void* dw2, const void* b2, void* out, int B,
                      int C, int T_len, int M, int K, int t_tile, int nt, int mt,
                      const float* prescales, float res_scale, float alpha,
                      int is_bf16, void* stream) {
  if (B < 1 || T_len < 1 || t_tile < 1 || !shape_ok(C, M, K, nt))
    return (int)cudaErrorInvalidValue;
  ChainScalars sc;
  for (int i = 0; i < kMaxM; ++i) sc.ps[i] = i < M ? prescales[i] : 1.f;
  sc.res_scale = res_scale;
  sc.alpha = alpha;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(x, pw1, dw1, b1, pw2, dw2, b2, out, B, C, T_len, M,
                                      K, t_tile, nt, mt, sc, s)
              : launch<float>(x, pw1, dw1, b1, pw2, dw2, b2, out, B, C, T_len, M, K,
                              t_tile, nt, mt, sc, s);
  return (int)err;
}

// Registers per thread of the instantiation (nt, mt, is_bf16) at K = 5 and
// the CTAs of it one SM holds when the slabs hold `rows` rows of C channels.
int wv_resblock_chain_info(int C, int rows, int nt, int mt, int is_bf16,
                           int* regs, int* ctas_per_sm) {
  if (!shape_ok(C, 1, 5, nt) || rows < 1) return (int)cudaErrorInvalidValue;
  return (int)(is_bf16 ? info<__nv_bfloat16>(C, rows, nt, mt, regs, ctas_per_sm)
                       : info<float>(C, rows, nt, mt, regs, ctas_per_sm));
}

const char* wv_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
