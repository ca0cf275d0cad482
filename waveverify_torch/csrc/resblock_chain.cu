// Fused chain of SEANet residual blocks for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels _resblock_kernel_tbc / _resblock_kernel
// (waveverify_tpu/ops/pallas_kernels.py, launched by _pallas_forward_tbc and
// _pallas_forward). For M blocks i = 0..M-1 over an activation x [B, C, T]:
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
// wrapper); all arithmetic is f32.
//
// Design. One CTA of 256 threads owns one (batch, T-tile). It loads the tile
// plus H = M * 2 * (K - 1) rows of history into shared memory as an f32 slab
// stored channel-major, xs[c][row], and walks all M blocks there, so device
// memory sees one read of x and one write of the output for the whole
// launch. A second slab us holds u. The 1x1 products run in place on us, a
// chunk of rows at a time: each warp keeps a 16-row by (32 * NC)-column tile
// of sums in registers, reads its 16 rows of one input channel with four
// 16-byte broadcast loads, and streams its pw columns from L2, one input
// channel per step. The depthwise convolutions also run in place: each
// thread scans a (channel, row-segment) item in time order, with the K - 1
// history values read into registers before anyone writes. Rows before the
// start of time are loaded as zero and re-zeroed after every bias add, which
// is the causal zero padding; the history rows at the top of a later tile
// are recomputed and discarded.
//
// What bounds it. At the main path's widths the products need 4 C^2 f32
// FLOP per row and block against 8 C bytes of f32 I/O per row, so the chain
// is bound by f32 FMA throughput (no tensor cores in this version), and by
// the L2 reads of pw, which each 16-row chunk repeats. Two f32 slabs limit a
// tile to about 227 KB / (8 C) rows: at C = 768 that is 32 rows, so with the
// 24-row halo of M = 3 most of the work would be recompute. The Python
// wrapper (ops/resblock_chain.py, chain_plan) therefore chooses per C
// between one launch for the chain and one launch per block (halo 8) by a
// cost model of recompute against extra I/O.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>

namespace {

constexpr int kMaxM = 8;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;         // rows of the product tile each warp owns
constexpr int kMaxItems = 6;      // depthwise (channel, segment) items per thread
constexpr int kMaxSmem = 232448;  // opt-in shared memory per block on sm_90

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

// Row stride of a channel in the slab: whole 16-row groups (the product
// reads them with float4 loads) plus 4 floats, so that neighbouring channels
// fall 4 banks apart for the depthwise scans.
__host__ __device__ __forceinline__ int slab_stride(int P) {
  return (P + kRows - 1) / kRows * kRows + 4;
}

__device__ __forceinline__ float elu(float v, float alpha) {
  return v > 0.f ? v : alpha * (expf(fminf(v, 0.f)) - 1.f);
}

// s[co][r] = sum_ci s[ci][r] * w[ci][co] for all P rows, in place. The
// slab's row stride ld is a multiple of 4 and covers every 16-row group, so
// the float4 loads stay aligned and inside the slab.
template <int NC>
__device__ void pointwise_inplace(float* s, int P, int C, int ld,
                                  const float* __restrict__ w, int ncg, int rg_count) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cg = warp % ncg, rg = warp / ncg;
  const int chunk = rg_count * kRows;
  int co[NC];
  bool ok[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    co[j] = cg * 32 * NC + lane + 32 * j;
    ok[j] = co[j] < C;
  }
  for (int r0 = 0; r0 < P; r0 += chunk) {
    const int rb = r0 + rg * kRows;
    const bool active = rg < rg_count && rb < P;
    float acc[kRows][NC];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[r][j] = 0.f;
    if (active) {
      for (int ci = 0; ci < C; ++ci) {
        float wv[NC];
#pragma unroll
        for (int j = 0; j < NC; ++j)
          wv[j] = ok[j] ? __ldg(w + (size_t)ci * C + co[j]) : 0.f;
        const float4* src = reinterpret_cast<const float4*>(s + ci * ld + rb);
#pragma unroll
        for (int q = 0; q < kRows / 4; ++q) {
          const float4 a = src[q];
#pragma unroll
          for (int j = 0; j < NC; ++j) {
            acc[4 * q + 0][j] = fmaf(a.x, wv[j], acc[4 * q + 0][j]);
            acc[4 * q + 1][j] = fmaf(a.y, wv[j], acc[4 * q + 1][j]);
            acc[4 * q + 2][j] = fmaf(a.z, wv[j], acc[4 * q + 2][j]);
            acc[4 * q + 3][j] = fmaf(a.w, wv[j], acc[4 * q + 3][j]);
          }
        }
      }
    }
    __syncthreads();
    if (active) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (rb + r < P) {
#pragma unroll
          for (int j = 0; j < NC; ++j)
            if (ok[j]) s[co[j] * ld + rb + r] = acc[r][j];
        }
      }
    }
    __syncthreads();
  }
}

// Causal depthwise conv of u in place (row t reads rows t-K+1..t), plus
// bias, with rows before the start of time (global time gbase + row < 0)
// zeroed. LAST = false: u = ELU(result). LAST = true: xs += res_scale *
// result, zeroed at the same rows.
template <int K, bool LAST>
__device__ void depthwise_inplace(float* u, float* xs, int P, int C, int ld,
                                  const float* __restrict__ dw,
                                  const float* __restrict__ bias,
                                  int gbase, const ChainScalars& sc) {
  const int nseg = max(1, min(P, (2 * kThreads + C - 1) / C));
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
          const float xv = acc * sc.res_scale + xs[c * ld + t];
          xs[c * ld + t] = pad ? 0.f : xv;
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

template <typename T, int NC, int K>
__global__ void __launch_bounds__(kThreads, 2)
resblock_chain_kernel(const T* __restrict__ x, const float* __restrict__ pw1,
                      const float* __restrict__ dw1, const float* __restrict__ b1,
                      const float* __restrict__ pw2, const float* __restrict__ dw2,
                      const float* __restrict__ b2, T* __restrict__ out, int C,
                      int T_len, int M, int t_tile, ChainScalars sc, int ncg,
                      int rg_count) {
  extern __shared__ __align__(16) float smem[];
  const int H = M * 2 * (K - 1);
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * t_tile;
  const int tt = min(t_tile, T_len - t0);
  const int P = H + tt;
  const int ld = slab_stride(P);
  const int gbase = t0 - H;
  float* xs = smem;
  float* us = smem + C * ld;

  const T* xb = x + (size_t)b * C * T_len;
  for (int idx = threadIdx.x; idx < C * P; idx += kThreads) {
    const int c = idx / P, r = idx - c * P;
    const int g = gbase + r;
    xs[c * ld + r] = g >= 0 ? to_f(xb[(size_t)c * T_len + g]) : 0.f;
  }
  __syncthreads();

  for (int i = 0; i < M; ++i) {
    const float ps = sc.ps[i];
    for (int idx = threadIdx.x; idx < C * P; idx += kThreads) {
      const int c = idx / P, r = idx - c * P;
      us[c * ld + r] = elu(xs[c * ld + r] * ps, sc.alpha);
    }
    __syncthreads();
    pointwise_inplace<NC>(us, P, C, ld, pw1 + (size_t)i * C * C, ncg, rg_count);
    depthwise_inplace<K, false>(us, xs, P, C, ld, dw1 + (size_t)i * K * C,
                                   b1 + (size_t)i * C, gbase, sc);
    pointwise_inplace<NC>(us, P, C, ld, pw2 + (size_t)i * C * C, ncg, rg_count);
    depthwise_inplace<K, true>(us, xs, P, C, ld, dw2 + (size_t)i * K * C,
                                  b2 + (size_t)i * C, gbase, sc);
  }

  T* ob = out + (size_t)b * C * T_len;
  for (int idx = threadIdx.x; idx < C * tt; idx += kThreads) {
    const int c = idx / tt, r = idx - c * tt;
    ob[(size_t)c * T_len + t0 + r] = from_f<T>(xs[c * ld + H + r]);
  }
}

template <typename T, int NC, int K>
cudaError_t launch(const void* x, const void* pw1, const void* dw1, const void* b1,
                   const void* pw2, const void* dw2, const void* b2, void* out, int B,
                   int C, int T_len, int M, int t_tile, const ChainScalars& sc,
                   int ncg, int rg_count, cudaStream_t stream) {
  auto kern = resblock_chain_kernel<T, NC, K>;
  const int H = M * 2 * (K - 1);
  const int P = H + (t_tile < T_len ? t_tile : T_len);
  const size_t smem = 2 * (size_t)C * slab_stride(P) * sizeof(float);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((T_len + t_tile - 1) / t_tile, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(pw1),
      static_cast<const float*>(dw1), static_cast<const float*>(b1),
      static_cast<const float*>(pw2), static_cast<const float*>(dw2),
      static_cast<const float*>(b2), static_cast<T*>(out), C, T_len, M, t_tile, sc, ncg,
      rg_count);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_nc(int nc, const void* x, const void* pw1, const void* dw1,
                        const void* b1, const void* pw2, const void* dw2, const void* b2,
                        void* out, int B, int C, int T_len, int M, int t_tile,
                        const ChainScalars& sc, int ncg, int rg_count,
                        cudaStream_t stream) {
  switch (nc) {
    case 1:
      return launch<T, 1, 5>(x, pw1, dw1, b1, pw2, dw2, b2, out, B, C, T_len, M, t_tile,
                             sc, ncg, rg_count, stream);
    case 2:
      return launch<T, 2, 5>(x, pw1, dw1, b1, pw2, dw2, b2, out, B, C, T_len, M, t_tile,
                             sc, ncg, rg_count, stream);
    case 3:
      return launch<T, 3, 5>(x, pw1, dw1, b1, pw2, dw2, b2, out, B, C, T_len, M, t_tile,
                             sc, ncg, rg_count, stream);
    default:
      return launch<T, 4, 5>(x, pw1, dw1, b1, pw2, dw2, b2, out, B, C, T_len, M, t_tile,
                             sc, ncg, rg_count, stream);
  }
}

}  // namespace

extern "C" {

// Columns each lane owns in the product (NC) are chosen to keep the most
// warps busy on useful columns: ncg = ceil(C / (32 NC)) warps cover the
// columns and kWarps / ncg row groups share a chunk.
int wv_resblock_chain(const void* x, const void* pw1, const void* dw1, const void* b1,
                      const void* pw2, const void* dw2, const void* b2, void* out, int B,
                      int C, int T_len, int M, int K, int t_tile,
                      const float* prescales, float res_scale, float alpha,
                      int is_bf16, void* stream) {
  if (K != 5 || M < 1 || M > kMaxM || C < 1 || B < 1 || T_len < 1 || t_tile < 1)
    return (int)cudaErrorInvalidValue;
  int best_nc = 0, best_ncg = 0;
  double best_util = -1.0;
  for (int nc = 4; nc >= 1; --nc) {
    const int ncg = (C + 32 * nc - 1) / (32 * nc);
    if (ncg > kWarps) continue;
    const double util = (double)C / (ncg * 32 * nc) * (ncg * (kWarps / ncg)) / kWarps;
    if (util > best_util) {
      best_util = util;
      best_nc = nc;
      best_ncg = ncg;
    }
  }
  if (best_nc == 0) return (int)cudaErrorInvalidValue;
  // the depthwise pass holds at most kMaxItems items per thread
  const int nseg_max = (2 * kThreads + C - 1) / C;
  if (C * (nseg_max > 1 ? nseg_max : 1) > kMaxItems * kThreads)
    return (int)cudaErrorInvalidValue;
  ChainScalars sc;
  for (int i = 0; i < kMaxM; ++i) sc.ps[i] = i < M ? prescales[i] : 1.f;
  sc.res_scale = res_scale;
  sc.alpha = alpha;
  const int rg_count = kWarps / best_ncg;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_bf16 ? dispatch_nc<__nv_bfloat16>(best_nc, x, pw1, dw1, b1, pw2, dw2, b2, out, B,
                                           C, T_len, M, t_tile, sc, best_ncg, rg_count, s)
              : dispatch_nc<float>(best_nc, x, pw1, dw1, b1, pw2, dw2, b2, out, B, C,
                                   T_len, M, t_tile, sc, best_ncg, rg_count, s);
  return (int)err;
}

const char* wv_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
