// How fast one CTA receives a small weight image from L2 into shared memory
// while every SM does the same: a ring of bulk copies (stage size, depth,
// same / staggered / distinct addresses, one stage split over several
// issuing threads) against plain 16-byte loads. Run by run_probes.py.
#include <cuda_runtime.h>
#include <stdint.h>
__device__ __forceinline__ uint32_t sa(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }
__device__ __forceinline__ void wait(uint32_t bar, uint32_t par) {
  uint32_t ok = 0;
  while (!ok) asm volatile("{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0,1,0,p;\n}\n" : "=r"(ok) : "r"(bar), "r"(par) : "memory");
}
// mode 0: same addresses on every CTA; 1: each CTA starts at a different stage; 2: each CTA its own copy
__global__ void bulk(const char* src, int total, int stage, int S, int nstage_total, int iters, int mode, int split, long long* out) {
  extern __shared__ __align__(128) unsigned char sm[];
  uint64_t* full = (uint64_t*)sm; uint64_t* empty = full + 32;
  unsigned char* ring = sm + 512;
  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(sa(full + i)), "r"(1));
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(sa(empty + i)), "r"((int)(blockDim.x / 32)));
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const char* base = src + (mode == 2 ? (size_t)blockIdx.x * total : 0);
  const int rot = mode == 1 ? (blockIdx.x * 7) % nstage_total : 0;
  long long t0 = clock64();
  int next = 0;
  for (int it = 0; it < iters; ++it) {
    if (threadIdx.x < split) {
      while (next < iters && next < it + S) {
        int slot = next % S;
        if (next >= S) wait(sa(empty + slot), ((next / S) & 1) ^ 1);
        if (threadIdx.x == 0)
          asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" :: "r"(sa(full + slot)), "r"(stage) : "memory");
        __syncwarp((1u << split) - 1);
        const int part = stage / split;
        const char* g = base + (size_t)((next + rot) % nstage_total) * stage + threadIdx.x * part;
        asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
                     :: "r"(sa(ring + slot * stage + threadIdx.x * part)), "l"(g), "r"(part), "r"(sa(full + slot)) : "memory");
        ++next;
      }
    }
    int slot = it % S;
    wait(sa(full + slot), (it / S) & 1);
    __syncwarp();
    if ((threadIdx.x & 31) == 0) asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(sa(empty + slot)) : "memory");
  }
  if (threadIdx.x == 0) out[blockIdx.x] = clock64() - t0;
}
// plain loads: every thread streams float4s, U in flight, into shared memory
template <int U>
__global__ void ldg(const float4* src, int total, int iters_bytes_per_cta, int mode, float* sink, long long* out) {
  extern __shared__ __align__(128) unsigned char sm[];
  float4* buf = (float4*)sm;
  const int n4 = total / 16;
  const int rot = mode == 1 ? (blockIdx.x * 7 * 64) % n4 : 0;
  const float4* base = src + (mode == 2 ? (size_t)blockIdx.x * n4 : 0);
  long long t0 = clock64();
  float acc = 0.f;
  const int steps = iters_bytes_per_cta / 16 / blockDim.x / U;
  for (int s = 0; s < steps; ++s) {
    float4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) v[u] = __ldg(base + ((size_t)(s * U + u) * blockDim.x + threadIdx.x + rot) % n4);
#pragma unroll
    for (int u = 0; u < U; ++u) buf[(u * blockDim.x + threadIdx.x) % 2048] = v[u];
  }
  __syncthreads();
  acc = buf[threadIdx.x].x;
  if (threadIdx.x == 0) { out[blockIdx.x] = clock64() - t0; sink[blockIdx.x] = acc; }
}
extern "C" int run_bulk(const void* src, int total, int stage, int S, int iters, int mode, int split, int ctas, long long* out, float* ms) {
  int smem = 512 + S * stage;
  cudaFuncSetAttribute(bulk, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaEvent_t a, b; cudaEventCreate(&a); cudaEventCreate(&b);
  cudaEventRecord(a);
  bulk<<<ctas, 256, smem>>>((const char*)src, total, stage, S, total / stage, iters, mode, split, out);
  cudaEventRecord(b); cudaEventSynchronize(b); cudaEventElapsedTime(ms, a, b);
  return (int)cudaGetLastError();
}
extern "C" int run_ldg(const void* src, int total, int bytes_per_cta, int mode, int ctas, float* sink, long long* out, float* ms) {
  cudaFuncSetAttribute(ldg<4>, cudaFuncAttributeMaxDynamicSharedMemorySize, 32768);
  cudaEvent_t a, b; cudaEventCreate(&a); cudaEventCreate(&b);
  cudaEventRecord(a);
  ldg<4><<<ctas, 256, 32768>>>((const float4*)src, total, bytes_per_cta, mode, sink, out);
  cudaEventRecord(b); cudaEventSynchronize(b); cudaEventElapsedTime(ms, a, b);
  return (int)cudaGetLastError();
}
