// Fused dense residual block of audiocraft's SEANet for NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no AudioSeal. The port's
// SEANetResnetBlock (modules/audiocraft.py) ran the block as ten launches or
// more: an ELU, a zero-pad copy, cuDNN's conv, a bias add, an ELU, another
// pad copy, cuDNN's 1x1 conv, a bias add and the skip's add, each reading and
// writing the activation in device memory, about 15 times its size a block.
// This kernel runs the whole block in one launch. Over x [B, C, T] (f32,
// contiguous), with hidden width C / 2 and a k-tap conv (k odd) of dilation
// d, zero-padded by H = d (k - 1) / 2 samples on each side:
//
//   u = ELU(x)                              (samples outside [0, T) are 0)
//   h = ELU(W1 (*) u + b1)                  W1 [C/2, C, k], b1 [C/2]
//   y = x + b2 + W2 h                       W2 [C, C/2], b2 [C]
//
// with ELU(v) = v > 0 ? v : alpha (exp(v) - 1). Since ELU(0) = 0, zeroing the
// raw samples outside the clip is the zero padding of ELU(x).
//
// What bounds it. The block does 4 C^2 FLOP a sample (at k = 3) against 8 C
// bytes a sample that device memory must move at least (x in, y out): 16
// FLOP a byte at C = 32, 128 at C = 256, so the bytes bound every AudioSeal
// width at the TF32 peak. The design reads x once and writes y once, keeps
// u and h in shared memory, and runs both products on the tensor cores.
// What bounds it as built, measured on an H100 (clock64 marks per phase in
// a copy of the kernel; PERF.md): the products' mma.sync, which issues an
// m16n8k8 TF32 product about every 11.5 cycles per SM sub-partition, tripled
// by the split below. They take about 75% of a tile's cycles at C = 128 and
// 256, about half at C = 32 and 64, where the ELU pass takes about a fifth.
//
// Design. One CTA of 256 threads owns one (batch row, tile of R samples).
// 1. It copies x over [t0 - HP, t0 + R + HP) for every channel into shared
//    memory (HP = H rounded up to 4, so that a 16-byte copy stays inside
//    the clip or outside it when T % 4 == 0; else 4-byte copies), all of the
//    tile's copies in flight at once (cp.async, zero-filled outside the
//    clip), applies the ELU there, and keeps u channel-major, us[c][q], row
//    stride ld.
// 2. First product, h[r][co] = sum over (tap j, ci) of u[ci][r + j d + HP - H]
//    W1[co][ci][j]: M = the R samples, N = C / 2, K = k C in k-steps of 8
//    input channels of one tap. The taps are shifted views of the slab: no
//    im2col copy. Then + b1 and the ELU, in registers.
// 3. After a barrier h goes into shared memory over the slab (hs[co][r],
//    stride ldh); a barrier.
// 4. Second product, y[r][co] = x + b2 + sum over ci of h[ci][r] W2[co][ci]:
//    M = R, N = C, K = C / 2. The sums start from x (re-read from device
//    memory: the tile's own bytes, which the first load left in L2) plus
//    b2, and go to y.
//
// Both products are warp-level
//   mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32
// with M = samples, N = output channels, K = input channels. With g = lane
// >> 2 and t = lane & 3 a lane holds
//   A (16 x 8):  a0 = A[g][t]   a1 = A[g+8][t]   a2 = A[g][t+4]  a3 = A[g+8][t+4]
//   B (8 x 8):   b0 = B[t][g]   b1 = B[t+4][g]
//   D (16 x 8):  d0 = D[g][2t]  d1 = D[g][2t+1]  d2 = D[g+8][2t] d3 = D[g+8][2t+1]
// A[r][ci] = us[ci * ld + r + shift] (and hs for the second product): the
// strides ld and ldh are 8 mod 32, so the 32 lanes' loads of a fragment fall
// in 32 different banks whatever the shift. B is the weights: the wrapper
// lays each product's B = [K, N] out in fragment order, split into TF32 hi
// and lo (ops/dense_resblock.py pack_weights): for k-step ks and the pair p
// of neighbouring n-tiles, lane l finds its four values' hi as one float4 at
// [(ks * N / 16 + p) * 64 + l] and their lo 32 float4 further. They
// go from device memory (L2, where the few KB to 0.5 MB of a block's weights
// stay) straight to registers, the next k-step's while this one's products
// run. Warps split the tile's rows and columns (the tiling, per C, below);
// each warp keeps MT x NT accumulator tiles, all of its part of the product,
// in registers.
//
// Split TF32. TF32 keeps 10 mantissa bits, so one product pass is not an
// f32 product (the ROADMAP's rule: the TF32 reference fails the limits).
// Each operand is split, hi = tf32(v) (round to nearest on the f32 bit
// pattern) and lo = v - hi, and three products a_lo b_hi, a_hi b_lo, a_hi b_hi
// go into the sums, small terms first; a_lo b_lo (relative size 2^-21) is
// dropped. Each k-step's three products start from zero and join the
// running sums by an f32 add: the tensor core adds toward zero, and sums
// carried through it over the 96 k-steps of C = 256 would drift low
// (resblock_chain.cu measured the same on this card).
//
// Tilings, (NT1, MT1, NT2, MT2): per warp NT n-tiles of 8 columns and MT
// m-tiles of 16 samples in the first and second product. The warps split
// N = C / 2 (then C) into wn = N / (8 NT) column groups and 8 / wn row
// groups. The first product covers the tile in one pass, R = (8 / wn1) MT1
// 16 (h goes over the slab only once every warp is done with u); the second
// in R / ((8 / wn2) MT2 16) passes, which keeps its sums in fewer registers.
// The launch plan (R, the slab's strides, the shared memory) is the
// wrapper's, ops/dense_resblock.py resblock_plan, passed to every launch:
//   C = 32:  (2, 2, 2, 2), R = 256     C = 64:  (2, 2, 2, 2), R = 128
//   C = 128: (4, 2, 4, 2), R = 128     C = 256: (4, 2, 4, 2), R = 64
// two passes of the second product at each width. The slab holds 34-74 KB;
// the first tiling runs within 80 registers, three CTAs an SM, the second
// within 128, two. Measured on an H100 at the AudioSeal cell's shapes
// (PERF.md): both products' mma.sync issue bounds C = 128 and 256, and at
// C = 32 and 64 a third CTA an SM, whose phases (copies, ELU, products)
// overlap the others', gained 15-20% over two.
//
// The weights' split and layout is one small launch per conv (pack_kernel),
// from the conv's effective weight.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmem = 232448;  // opt-in shared memory per block on sm_90

// (NT1, MT1, NT2, MT2, CTAs per SM the register budget aims at) of each
// compiled tiling, in the order of ops/dense_resblock.py's TILINGS, whose
// plan decides the rows of a launch.
#define WV_DR_TILINGS(X) X(2, 2, 2, 2, 3) X(4, 2, 4, 2, 2)

struct Args {
  const float* x;
  float* y;
  const float4* w1;  // first product's B in fragment order
  const float* b1;   // [C / 2]
  const float4* w2;  // second product's B in fragment order
  const float* b2;   // [C]
  int C, T, k, d;
  int halo, hp;      // H = d (k - 1) / 2; H rounded up to 4
  int rows, tiles;   // R; tiles of R samples per batch row
  int ld, ldh;       // slab strides of u and h
  float alpha;
};

// ELU with the hardware's exp (ex2.approx): within about 1e-7 of
// alpha * expm1(v), the size of an f32 rounding of the activations.
__device__ __forceinline__ float elu(float v, float alpha) {
  return v > 0.f ? v : alpha * (__expf(v) - 1.f);
}

// Round an f32 bit pattern to TF32 (10 mantissa bits), to nearest.
__device__ __forceinline__ uint32_t tf32_bits(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// hi = tf32(v), lo = v - hi, handed over with all its f32 bits: the tensor
// core reads the upper 19 (lo's rounding to TF32 toward zero).
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_bits(v);
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// A copy of N bytes (4 or 16, both addresses aligned to it) from global to
// shared memory that does not hold the thread; zeros where `in` is false.
template <int N>
__device__ __forceinline__ void copy_async(float* dst, const float* src, bool in) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if (N == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(in ? 16 : 0)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
                 "r"(in ? 4 : 0)
                 : "memory");
  }
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

// acc[mi][nj] += A B over nks k-steps. A[r][ci] of k-step ks sits at
// s[row_of(ks) + (ci % 8) * ld + r], r counted from this warp's first row
// (s already points there, lane offsets included: s + t * ld + g); wb points
// at this warp's first n-tile pair of k-step 0 (lane included), np pairs a
// k-step. row_of(ks) = (ks / steps) * shift + (ks % steps) * 8 * ld walks the
// taps (a shift of the slab) and the input channels within one tap.
template <int NT, int MT>
__device__ __forceinline__ void product(float (&acc)[MT][NT][4], const float* s, int ld,
                                        int steps, int nks, int shift,
                                        const float4* __restrict__ wb, int np) {
  static_assert(NT % 2 == 0, "n-tiles are packed in pairs");
  float4 bnext[NT / 2][2];
#pragma unroll
  for (int q = 0; q < NT / 2; ++q) {
    bnext[q][0] = __ldg(wb + q * 64);
    bnext[q][1] = __ldg(wb + q * 64 + 32);
  }
  int tap = 0, cs = 0;
  for (int ks = 0; ks < nks; ++ks) {
    // this k-step's B fragments, hi and lo; the next one's are fetched
    // meanwhile
    uint32_t bh[NT / 2][4], bl[NT / 2][4];
#pragma unroll
    for (int q = 0; q < NT / 2; ++q) {
      const float4 h = bnext[q][0], l = bnext[q][1];
      bh[q][0] = __float_as_uint(h.x), bh[q][1] = __float_as_uint(h.y);
      bh[q][2] = __float_as_uint(h.z), bh[q][3] = __float_as_uint(h.w);
      bl[q][0] = __float_as_uint(l.x), bl[q][1] = __float_as_uint(l.y);
      bl[q][2] = __float_as_uint(l.z), bl[q][3] = __float_as_uint(l.w);
    }
    if (ks + 1 < nks) {
      const float4* wk = wb + (ks + 1) * np * 64;
#pragma unroll
      for (int q = 0; q < NT / 2; ++q) {
        bnext[q][0] = __ldg(wk + q * 64);
        bnext[q][1] = __ldg(wk + q * 64 + 32);
      }
    }
    const float* ap = s + tap * shift + cs * 8 * ld;
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      uint32_t ah[4], al[4];
      split_tf32(ap[mi * 16], ah[0], al[0]);
      split_tf32(ap[mi * 16 + 8], ah[1], al[1]);
      split_tf32(ap[4 * ld + mi * 16], ah[2], al[2]);
      split_tf32(ap[4 * ld + mi * 16 + 8], ah[3], al[3]);
#pragma unroll
      for (int q = 0; q < NT / 2; ++q) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float part[4];
          mma_tf32_first(part, al, bh[q][2 * h], bh[q][2 * h + 1]);
          mma_tf32(part, ah, bl[q][2 * h], bl[q][2 * h + 1]);
          mma_tf32(part, ah, bh[q][2 * h], bh[q][2 * h + 1]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][2 * q + h][e] += part[e];
        }
      }
    }
    if (++cs == steps) {
      cs = 0;
      ++tap;
    }
  }
}

// The thread's items (c, q) of a C x n grid, row by row, kThreads apart.
struct Walk {
  int n, c, q, dc, dq;
  __device__ __forceinline__ explicit Walk(int n_) : n(n_) {
    c = threadIdx.x / n;
    q = threadIdx.x - c * n;
    dc = kThreads / n;
    dq = kThreads - dc * n;
  }
  __device__ __forceinline__ void next() {
    c += dc;
    q += dq;
    if (q >= n) {
      q -= n;
      ++c;
    }
  }
};

// Start the copies of xb [C, T] over [lo, lo + width) into the slab `us`
// (zero outside the clip) as one group, all in flight at once.
__device__ __forceinline__ void stage_tile(const Args& a, const float* xb, int lo, int width,
                                           float* us) {
  const int C = a.C, T = a.T, ld = a.ld;
  if ((T & 3) == 0 && (reinterpret_cast<uintptr_t>(xb) & 15) == 0) {
    for (Walk w(width >> 2); w.c < C; w.next()) {
      const int tt = lo + 4 * w.q;
      const bool in = tt >= 0 && tt < T;
      copy_async<16>(us + w.c * ld + 4 * w.q, in ? xb + (size_t)w.c * T + tt : xb, in);
    }
  } else {
    for (Walk w(width); w.c < C; w.next()) {
      const int tt = lo + w.q;
      const bool in = tt >= 0 && tt < T;
      copy_async<4>(us + w.c * ld + w.q, in ? xb + (size_t)w.c * T + tt : xb, in);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int NT1, int MT1, int NT2, int MT2, int MINB>
__global__ void __launch_bounds__(kThreads, MINB) dense_resblock_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float* const us = reinterpret_cast<float*>(smem4);
  const int C = a.C, T = a.T, R = a.rows, ld = a.ld, ldh = a.ldh;
  const float alpha = a.alpha;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int width = R + 2 * a.hp;
  const int b = blockIdx.x / a.tiles;
  const int t0 = (blockIdx.x - b * a.tiles) * R;
  const float* xb = a.x + (size_t)b * C * T;
  float* yb = a.y + (size_t)b * C * T;

  // 1. u = ELU(x), in place once the tile's copies have landed
  stage_tile(a, xb, t0 - a.hp, width, us);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  for (Walk w(width >> 2); w.c < C; w.next()) {
    float4* u = reinterpret_cast<float4*>(us + w.c * ld + 4 * w.q);
    float4 v = *u;
    v.x = elu(v.x, alpha);
    v.y = elu(v.y, alpha);
    v.z = elu(v.z, alpha);
    v.w = elu(v.w, alpha);
    *u = v;
  }
  __syncthreads();

  // 2. h = ELU(W1 (*) u + b1), in registers
  const int n1 = C >> 1;
  const int wn1 = n1 / (8 * NT1);
  const int cg1 = warp % wn1, rb1 = (warp / wn1) * MT1 * 16;
  float acc1[MT1][NT1][4];
#pragma unroll
  for (int mi = 0; mi < MT1; ++mi)
#pragma unroll
    for (int nj = 0; nj < NT1; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc1[mi][nj][e] = 0.f;
  product<NT1, MT1>(acc1, us + t * ld + rb1 + g + (a.hp - a.halo), ld, C >> 3, a.k * (C >> 3),
                    a.d, a.w1 + cg1 * (NT1 / 2) * 64 + lane, n1 >> 4);
  __syncthreads();  // every warp is done with u: h goes over it

  // 3. h into shared memory, hs[co][r]
  float* hs = us;
#pragma unroll
  for (int nj = 0; nj < NT1; ++nj) {
    const int co = (cg1 * NT1 + nj) * 8 + 2 * t;
    const float c0 = __ldg(a.b1 + co), c1 = __ldg(a.b1 + co + 1);
#pragma unroll
    for (int mi = 0; mi < MT1; ++mi) {
      float* o = hs + co * ldh + rb1 + mi * 16 + g;
      o[0] = elu(acc1[mi][nj][0] + c0, alpha);
      o[ldh] = elu(acc1[mi][nj][1] + c1, alpha);
      o[8] = elu(acc1[mi][nj][2] + c0, alpha);
      o[ldh + 8] = elu(acc1[mi][nj][3] + c1, alpha);
    }
  }
  __syncthreads();

  // 4. y = x + b2 + W2 h, in passes of chunk2 rows
  const int wn2 = C / (8 * NT2);
  const int cg2 = warp % wn2;
  const int chunk2 = kWarps / wn2 * MT2 * 16;
  for (int r0 = 0; r0 < R && t0 + r0 < T; r0 += chunk2) {
    const int rb2 = r0 + (warp / wn2) * MT2 * 16;
    float acc2[MT2][NT2][4];
#pragma unroll
    for (int nj = 0; nj < NT2; ++nj) {
      const int co = (cg2 * NT2 + nj) * 8 + 2 * t;
      const float c0 = __ldg(a.b2 + co), c1 = __ldg(a.b2 + co + 1);
      const float* x0 = xb + (size_t)co * T;
#pragma unroll
      for (int mi = 0; mi < MT2; ++mi) {
        const int r = t0 + rb2 + mi * 16 + g;
        acc2[mi][nj][0] = (r < T ? __ldg(x0 + r) : 0.f) + c0;
        acc2[mi][nj][1] = (r < T ? __ldg(x0 + T + r) : 0.f) + c1;
        acc2[mi][nj][2] = (r + 8 < T ? __ldg(x0 + r + 8) : 0.f) + c0;
        acc2[mi][nj][3] = (r + 8 < T ? __ldg(x0 + T + r + 8) : 0.f) + c1;
      }
    }
    product<NT2, MT2>(acc2, hs + t * ldh + rb2 + g, ldh, n1 >> 3, n1 >> 3, 0,
                      a.w2 + cg2 * (NT2 / 2) * 64 + lane, C >> 4);
#pragma unroll
    for (int nj = 0; nj < NT2; ++nj) {
      const int co = (cg2 * NT2 + nj) * 8 + 2 * t;
      float* y0 = yb + (size_t)co * T;
#pragma unroll
      for (int mi = 0; mi < MT2; ++mi) {
        const int r = t0 + rb2 + mi * 16 + g;
        if (r < T) {
          y0[r] = acc2[mi][nj][0];
          y0[T + r] = acc2[mi][nj][1];
        }
        if (r + 8 < T) {
          y0[r + 8] = acc2[mi][nj][2];
          y0[T + r + 8] = acc2[mi][nj][3];
        }
      }
    }
  }
}

// The fragment-order image of B[j K + ci][n] = w[n][ci][j] (w [N, K, taps]),
// hi then lo per (k-step, n-tile pair): out[(((ks NP + p) 2 + part) 32 + l) 4
// + e] with ks = j K / 8 + ci / 8, l = 4 g + t, e = 2 hn + hk for n = 16 p + 8
// hn + g and ci = 8 (ks % (K / 8)) + 4 hk + t (ops/dense_resblock.py
// pack_weights is the same in PyTorch).
__global__ void pack_kernel(const float* __restrict__ w, float* __restrict__ out, int N,
                            int K, int taps) {
  const int np = N / 16, cs = K / 8;
  const int total = taps * cs * np * 128;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total; i += gridDim.x * blockDim.x) {
    const int e = i & 3, lane = (i >> 2) & 31, rest = i >> 7;
    const int p = rest % np, ks = rest / np;
    const int j = ks / cs, c8 = ks - j * cs;
    const int g = lane >> 2, t = lane & 3, hn = e >> 1, hk = e & 1;
    const int n = 16 * p + 8 * hn + g, ci = 8 * c8 + 4 * hk + t;
    const float v = w[((size_t)n * K + ci) * taps + j];
    const float hi = __uint_as_float(tf32_bits(v));
    const size_t o = ((size_t)(ks * np + p) * 2 * 32 + lane) * 4 + e;
    out[o] = hi;
    out[o + 128] = v - hi;
  }
}

template <int NT1, int MT1, int NT2, int MT2, int MINB>
int launch(const Args& a, int smem, int grid, cudaStream_t stream) {
  auto* kernel = dense_resblock_kernel<NT1, MT1, NT2, MT2, MINB>;
  cudaError_t err = cudaFuncSetAttribute((const void*)kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One block over x [B, C, T] into y [B, C, T] (both f32, contiguous, not
// overlapping) on `stream`; w1 and w2 in fragment order. The plan: tiling
// `tiling`, R samples a CTA, the halo rounded up to hp, the slab's strides
// ld and ldh, smem bytes of shared memory. A plan whose slab would not hold
// the tile and its halo, or h, is refused.
int wv_dense_resblock(const void* x, void* y, const void* w1, const void* b1, const void* w2,
                      const void* b2, int B, int C, int T, int k, int d, float alpha,
                      int tiling, int R, int hp, int ld, int ldh, int smem, void* stream) {
  const int halo = d * (k - 1) / 2;
  if (B < 1 || T < 1 || C < 32 || C % 32 || k < 1 || k % 2 == 0 || d < 1 || R < 1 ||
      hp < halo || hp % 4 || ld < R + 2 * hp || ldh < R || smem > kMaxSmem ||
      (long long)smem < 4LL * C * ld || (long long)smem < 4LL * (C / 2) * ldh)
    return (int)cudaErrorInvalidValue;
  const long long tiles = (T + R - 1) / R;
  if (tiles * B > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  Args a;
  a.x = static_cast<const float*>(x);
  a.y = static_cast<float*>(y);
  a.w1 = static_cast<const float4*>(w1);
  a.b1 = static_cast<const float*>(b1);
  a.w2 = static_cast<const float4*>(w2);
  a.b2 = static_cast<const float*>(b2);
  a.C = C;
  a.T = T;
  a.k = k;
  a.d = d;
  a.halo = halo;
  a.hp = hp;
  a.rows = R;
  a.tiles = (int)tiles;
  a.ld = ld;
  a.ldh = ldh;
  a.alpha = alpha;
  const int grid = (int)(tiles * B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int i = 0;
#define WV_LAUNCH(A, B2, C2, D, E) \
  if (i++ == tiling) return launch<A, B2, C2, D, E>(a, smem, grid, st);
  WV_DR_TILINGS(WV_LAUNCH)
#undef WV_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// The fragment-order hi / lo image of a conv weight w [N, K, taps] (f32,
// contiguous) into out (2 N K taps floats), on `stream`.
int wv_dense_resblock_pack(const void* w, void* out, int N, int K, int taps, void* stream) {
  if (N < 16 || N % 16 || K < 8 || K % 8 || taps < 1) return (int)cudaErrorInvalidValue;
  const int total = taps * (K / 8) * (N / 16) * 128;
  const int grid = (total + 255) / 256;
  pack_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), static_cast<float*>(out), N, K, taps);
  return (int)cudaGetLastError();
}

const char* wv_dense_resblock_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
