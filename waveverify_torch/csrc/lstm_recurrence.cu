// Persistent LSTM recurrence for NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package runs AudioSeal's LSTM nowhere, and
// the port's StreamableLSTM (modules/audiocraft.py) ran torch.nn.LSTM, whose
// cuDNN path launches a gemv and an elementwise kernel per frame and layer.
// This kernel runs every frame of every layer of one LSTM call in one
// cooperative launch.
//
// For layers l = 0..L-1 over frames t = 0..T-1, from zero state, with
// PyTorch's gate order i, f, g, o and W of shape [4H, H]:
//
//   gates = in_l(t) W_ih_l^T + b_ih_l + b_hh_l + h_l(t-1) W_hh_l^T
//   c_l(t) = sigmoid(f) c_l(t-1) + sigmoid(i) tanh(g)
//   h_l(t) = sigmoid(o) tanh(c_l(t))
//
// with in_0 = the input and in_l = h_{l-1}. Layer 0's input product, with
// both biases, arrives precomputed for every frame (`pre`, one f32 GEMM over
// all frames in the wrapper); layers l >= 1 compute theirs here. Products
// are f32 FMA on the CUDA cores; sigmoid is 1 / (1 + expf(-x)) and tanh is
// tanhf, both accurate (no fast math).
//
// What bounds it: each step is a dependent chain, and per step the card does
// 2 B 4H K FLOP per layer (K = H, or 2H for l >= 1), 50 MFLOP at H = 512,
// B = 8, two layers: about 0.8 us at the f32 FMA peak of 132 SMs. Before
// this kernel each step cost a kernel boundary and a re-read of W_hh (4 MiB)
// from L2. So the design keeps the weights in shared memory for the whole
// launch, and pays one light barrier per step. Measured on an H100 at that
// shape, with clock64() marks at each phase of a step in a copy of the
// kernel: 4.6 us a frame, of which the hand-over of h (the poll, the copy
// from L2, the fenced arrive) takes about 40%, the sums 30% (half the FMA
// issue rate: three warps a scheduler do not hide the shared loads), and
// the partial sums, gates and cells the rest; the barrier alone takes about
// 1 us (tools/hopper_probes/lstm_recurrence.py). Flagged 8-byte words in
// place of the counter, 8 rows a thread over 192 threads, and copying the
// next input half ahead each measured slower.
//
// - Resident weights. CTA k of layer l owns `units[l]` hidden units and holds
//   their 4 gate rows of W_hh (and of W_ih for l >= 1) in shared memory,
//   loaded once. The wrapper (ops/lstm_recurrence.py, lstm_plan) sizes the
//   split so that every CTA fits and all are co-resident (one per SM).
// - Pipeline over the layers. Layer l's CTAs step through time on their own;
//   at frame t they need h_l(t-1) (their own layer's CTAs) and, for l >= 1,
//   h_{l-1}(t) (the layer below, which runs ahead). Every layer writes its
//   whole output sequence to device memory (the last layer's is the result),
//   so no buffer is ever overwritten and a layer may run ahead freely.
// - One counter per layer. After writing its slice of h_l(t) a CTA adds 1 to
//   its layer's counter (a __threadfence, then an atomic add); a CTA needing
//   h_l(t-1) waits until the counter reaches t * ctas[l], then copies h from
//   L2 (cp.async.cg, which skips L1). One thread polls with ld.acquire.gpu
//   and keeps the largest count it has read, so a layer that runs ahead
//   costs its follower no read; above layer 0 the CTA then stages both
//   halves in one batch of copies.
// - Fused gates. The sums, the gates and the c and h updates run in the CTA;
//   c stays in shared memory for the whole launch.
//
// Inside a step, per batch group of 8 rows: the block stages h [8][H] in
// shared memory by cp.async; thread (s, rg) holds 4 gate rows x 8 batch sums
// (kRows x 8 accumulators) over the k-slice s of each half, reading its 4
// weights of one k as a float4 and h as one float4 of 4 k per row. Slices
// interleave by quads of k, so the lanes of a warp, which span two or more
// slices, read neighbouring chunks without bank conflicts (lanes of one
// slice read the same h: a broadcast). The slices' partial sums go through
// shared memory and are added in four chains (slice mod 4), then the
// precomputed product or the bias.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 384;
constexpr int kRows = 4;        // gate rows per thread
constexpr int kGroup = 8;       // batch rows per group
constexpr int kMaxLayers = 4;
constexpr int kCounterStride = 32;  // ints: one 128-byte line per counter
constexpr int kMaxOut = 2;      // gate sums per thread in the reduction

struct Params {
  const float* pre;                // [T, bstride, 4H]: layer 0's x W_ih^T + b_ih + b_hh
  const float* w_ih[kMaxLayers];   // [4H, H], layers >= 1
  const float* w_hh[kMaxLayers];   // [4H, H]
  const float* b_ih[kMaxLayers];   // [4H], layers >= 1
  const float* b_hh[kMaxLayers];   // [4H], layers >= 1
  float* seq[kMaxLayers];          // [T, bstride, H]: each layer's output
  int* counters;                   // [layers * kCounterStride], zero at launch
  int T, B, bstride, H, layers;
  int units[kMaxLayers];           // hidden units per CTA of each layer
  int ctas[kMaxLayers];            // CTAs of each layer
  long long spin_ns;               // a wait longer than this traps
};

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// A CTA of U units: thread (s, rg) = (tid / U, tid % U) holds rows 4 rg ..
// 4 rg + 3 (row r = g U + j is gate g of unit j) over the k-slice s of each
// H-long half. k runs in quads of 4; slice s owns quads s, s + slices, ...,
// `quads` of them, so the slices of a warp read neighbouring 16-byte chunks
// of a row of h. H is zero-padded to `padded` = 4 slices quads. Partial
// sums are [32][pstride], pstride = U mod 32, so that a warp's reads of 32
// consecutive outputs hit 32 banks.
struct Geometry {
  int slices, quads, padded, pstride;
  __host__ __device__ Geometry(int H, int U) {
    const int nq = ceil_div(H, 4);
    quads = ceil_div(nq, kThreads / U);
    slices = ceil_div(nq, quads);
    padded = 4 * slices * quads;
    pstride = slices * U + ((U - slices * U % 32) % 32 + 32) % 32;
  }
};

// Shared memory of one layer's CTA, in floats, for a launch of B batch rows:
// the weights [half][quad][i][slice][U][4], the union of the staged h
// [half][8][padded] and the partial sums, the gate sums [8][4U], and c.
struct Smem {
  int ws, uni, gs, cs;
  __host__ __device__ int total() const { return ws + uni + gs + cs; }
};

__host__ __device__ inline Smem layer_smem(int H, int layer, int units, int B) {
  const Geometry geo(H, units);
  const int halves = layer == 0 ? 1 : 2;
  Smem s;
  s.ws = halves * geo.padded * 4 * units;
  const int stage = halves * kGroup * geo.padded, partials = kRows * kGroup * geo.pstride;
  s.uni = stage > partials ? stage : partials;
  s.gs = kGroup * 4 * units;
  s.cs = ceil_div(units * B, 4) * 4;
  return s;
}

// The launch's dynamic shared memory: each part at its largest over the
// layers (every CTA gets the same).
__host__ __device__ inline Smem launch_smem(int H, int layers, const int* units, int B) {
  Smem m = {0, 0, 0, 0};
  for (int l = 0; l < layers; ++l) {
    Smem s = layer_smem(H, l, units[l], B);
    m.ws = s.ws > m.ws ? s.ws : m.ws;
    m.uni = s.uni > m.uni ? s.uni : m.uni;
    m.gs = s.gs > m.gs ? s.gs : m.gs;
    m.cs = s.cs > m.cs ? s.cs : m.cs;
  }
  return m;
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// The poller thread: return once *ctr >= target, `seen` holding the largest
// count it has read (a count seen once needs no second read). A wait over
// spin_ns traps (a co-residency or ordering fault, never a slow card).
__device__ __forceinline__ void poll(const int* ctr, int target, int& seen, long long spin_ns) {
  if (seen >= target) return;
  seen = ld_acquire(ctr);
  if (seen >= target) return;
  const long long t0 = global_ns();
  while ((seen = ld_acquire(ctr)) < target) {
    if (global_ns() - t0 > spin_ns) __trap();
  }
}

// Block-wide: publish this CTA's writes and count it in.
__device__ __forceinline__ void arrive(int* ctr) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(ctr, 1);
  }
}

__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

// Batch rows [bg, bg + nb) of one frame of h, src[b * H + k], into
// hs[b][padded], zeros past H and past nb: with H a multiple of 4, 16-byte
// cp.async copies that zero-fill, left in flight (staged() waits for them);
// else plain loads.
__device__ __forceinline__ void stage(float* hs, const float* src, int H, int nb,
                                      const Geometry& geo) {
  const int per_row = geo.padded / 4;
  if ((H & 3) == 0) {
    for (int item = threadIdx.x; item < kGroup * per_row; item += kThreads) {
      const int b = item / per_row, k = 4 * (item % per_row);
      const bool live = b < nb && k < H;
      const float* from = live ? src + (size_t)b * H + k : src;
      const unsigned to = (unsigned)__cvta_generic_to_shared(hs + b * geo.padded + k);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
                   :: "r"(to), "l"(from), "r"(live ? 16 : 0) : "memory");
    }
  } else {
    for (int item = threadIdx.x; item < kGroup * geo.padded; item += kThreads) {
      const int b = item / geo.padded, k = item % geo.padded;
      hs[item] = b < nb && k < H ? __ldcg(src + (size_t)b * H + k) : 0.f;
    }
  }
}

// Block-wide: every copy of stage() has landed and is visible.
__device__ __forceinline__ void staged() {
  asm volatile("cp.async.commit_group;\n\tcp.async.wait_group 0;" ::: "memory");
  __syncthreads();
}

// acc[i][b] += the products of k-slice sl: per quad q (k = 4 (q slices + sl)
// + c), the weights ws[q][c][sl][rg][4] (lanes of a warp on consecutive
// float4s) and h[b][k .. k + 3] (one float4 per row; lanes of one slice
// read the same, the next slice the neighbouring chunk).
__device__ __forceinline__ void accumulate(float (&acc)[kRows][kGroup], const float* ws,
                                           const float* hs, int U, int rg, int sl,
                                           const Geometry& geo) {
  const float4* w = reinterpret_cast<const float4*>(ws) + sl * U + rg;
  const float4* h = reinterpret_cast<const float4*>(hs) + sl;
  const int wstep = geo.slices * U, hrow = geo.padded / 4;
#pragma unroll 1
  for (int q = 0; q < geo.quads; ++q) {
    float4 hv[kGroup];
#pragma unroll
    for (int b = 0; b < kGroup; ++b) hv[b] = h[b * hrow + q * geo.slices];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float4 wv = w[(4 * q + c) * wstep];
      const float wr[kRows] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
      for (int b = 0; b < kGroup; ++b) {
        const float hb = c == 0 ? hv[b].x : c == 1 ? hv[b].y : c == 2 ? hv[b].z : hv[b].w;
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][b] = fmaf(wr[i], hb, acc[i][b]);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1) lstm_recurrence_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  // this CTA's layer and units
  int layer = 0, first = 0;
  while (layer + 1 < p.layers && blockIdx.x >= first + p.ctas[layer]) first += p.ctas[layer++];
  const int H = p.H, U = p.units[layer];
  const int u0 = (blockIdx.x - first) * U;
  const int nu = min(U, H - u0);  // units this CTA owns (the last may own fewer)
  const Geometry geo(H, U);
  const int halves = layer == 0 ? 1 : 2;
  const Smem sm = launch_smem(H, p.layers, p.units, p.B);
  float* ws = smem;
  float* uni = ws + sm.ws;
  float* gs = uni + sm.uni;
  float* cs = gs + sm.gs;
  const int tid = threadIdx.x;

  // weights: half e's ws[q][c][sl][rg][i] = W[g H + u0 + j][4 (q slices + sl) + c]
  // for row r = 4 rg + i = g U + j, W = W_hh for layer 0, W_ih then W_hh above
  // it; zero past H and for rows past nu
  for (int idx = tid; idx < halves * 4 * U * geo.padded; idx += kThreads) {
    const int e = idx / (4 * U * geo.padded), r = idx / geo.padded % (4 * U);
    const int k = idx % geo.padded, g = r / U, j = r % U;
    float v = 0.f;
    if (j < nu && k < H) {
      const float* w = layer == 0 ? p.w_hh[0] : (e == 0 ? p.w_ih[layer] : p.w_hh[layer]);
      v = w[((size_t)g * H + u0 + j) * H + k];
    }
    const int quad = k / 4, sl = quad % geo.slices, q = quad / geo.slices;
    ws[(size_t)e * geo.padded * 4 * U + (((size_t)(4 * q + k % 4) * geo.slices + sl) * U + r / 4) * 4 +
       r % 4] = v;
  }
  for (int idx = tid; idx < U * p.B; idx += kThreads) cs[idx] = 0.f;

  // the gate sums this thread reduces: o = q U + rg, q = 8 i + b, row 4 rg + i
  const int n_out = kRows * kGroup * U;
  float bias[kMaxOut];
#pragma unroll
  for (int m = 0; m < kMaxOut; ++m) {
    const int o = tid + m * kThreads;
    const int r = (o % U) * kRows + (o / U) / kGroup;
    bias[m] = 0.f;
    if (layer > 0 && o < n_out && r % U < nu) {
      const int col = (r / U) * H + u0 + r % U;
      bias[m] = p.b_ih[layer][col] + p.b_hh[layer][col];
    }
  }
  __syncthreads();

  const int rg = tid % U, sl = tid / U;
  const bool summing = sl < geo.slices;
  int* const own = p.counters + layer * kCounterStride;
  const int* const below = layer > 0 ? p.counters + (layer - 1) * kCounterStride : nullptr;
  const size_t frame = (size_t)p.bstride * H;  // floats of one frame of h
  float* const out = p.seq[layer];
  float* const hs_in = uni;  // layer >= 1: h_{l-1}(t)
  float* const hs_rec = layer == 0 ? uni : uni + geo.padded * kGroup;  // h_l(t-1)
  const float* const ws_in = ws;
  const float* const ws_rec = layer == 0 ? ws : ws + (size_t)geo.padded * 4 * U;

  const bool poller = tid == kThreads - 1;
  int seen_own = 0, seen_below = 0;  // the poller's
  for (int t = 0; t < p.T; ++t) {
    for (int bg = 0; bg < p.B; bg += kGroup) {
      const int nb = min(kGroup, p.B - bg);
      // layer 0's precomputed products of this group, in flight during the sums
      float pre[kMaxOut];
#pragma unroll
      for (int m = 0; m < kMaxOut; ++m) {
        const int o = tid + m * kThreads;
        const int q = o / U, r = (o % U) * kRows + q / kGroup, b = q % kGroup;
        pre[m] = 0.f;
        if (layer == 0 && o < n_out && r % U < nu && b < nb)
          pre[m] = __ldcg(p.pre + ((size_t)t * p.bstride + bg + b) * 4 * H + (r / U) * H +
                          u0 + r % U);
      }
      float acc[kRows][kGroup];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int b = 0; b < kGroup; ++b) acc[i][b] = 0.f;

      // the input half h_{l-1}(t) (layers above the first) and the recurrent
      // half h_l(t-1) (frames after the first), staged together
      if (bg == 0) {
        if (poller && layer > 0) poll(below, (t + 1) * p.ctas[layer - 1], seen_below, p.spin_ns);
        if (poller && t > 0) poll(own, t * p.ctas[layer], seen_own, p.spin_ns);
        __syncthreads();
      }
      if (layer > 0) stage(hs_in, p.seq[layer - 1] + t * frame + (size_t)bg * H, H, nb, geo);
      if (t > 0) stage(hs_rec, out + (t - 1) * frame + (size_t)bg * H, H, nb, geo);
      staged();
      if (summing) {
        if (layer > 0) accumulate(acc, ws_in, hs_in, U, rg, sl, geo);
        if (t > 0) accumulate(acc, ws_rec, hs_rec, U, rg, sl, geo);
      }
      __syncthreads();  // the stage is read: the partials take its place
      if (summing) {
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int b = 0; b < kGroup; ++b) uni[(i * kGroup + b) * geo.pstride + tid] = acc[i][b];
      }
      __syncthreads();
      // the slices' sums in four chains (slice mod 4), then the product or bias
#pragma unroll
      for (int m = 0; m < kMaxOut; ++m) {
        const int o = tid + m * kThreads;
        if (o < n_out) {
          const int q = o / U, rr = o % U;
          const float* part = uni + q * geo.pstride + rr;
          float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
          int s4 = 0;
#pragma unroll 2
          for (; s4 + 4 <= geo.slices; s4 += 4) {
            a0 += part[s4 * U];
            a1 += part[(s4 + 1) * U];
            a2 += part[(s4 + 2) * U];
            a3 += part[(s4 + 3) * U];
          }
          if (s4 < geo.slices) a0 += part[s4 * U];
          if (s4 + 1 < geo.slices) a1 += part[(s4 + 1) * U];
          if (s4 + 2 < geo.slices) a2 += part[(s4 + 2) * U];
          gs[(q % kGroup) * 4 * U + rr * kRows + q / kGroup] =
              ((a0 + a1) + (a2 + a3)) + (layer == 0 ? pre[m] : bias[m]);
        }
      }
      __syncthreads();
      // cell: thread (j, b) for j < nu, b < nb
      if (tid < nu * nb) {
        const int j = tid % nu, b = tid / nu;
        const float* gb = gs + b * 4 * U + j;
        const float gi = gb[0], gf = gb[U], gg = gb[2 * U], go = gb[3 * U];
        float& c = cs[(size_t)(bg + b) * U + j];
        c = sigmoidf(gf) * c + sigmoidf(gi) * tanhf(gg);
        __stcg(out + t * frame + (size_t)(bg + b) * H + u0 + j, sigmoidf(go) * tanhf(c));
      }
      __syncthreads();  // gs and the stage are free for the next group
    }
    arrive(own);
  }
}

cudaError_t set_smem(const void* fn, int bytes) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory a launch takes (the same formula as
// ops/lstm_recurrence.py's smem_bytes).
int wv_lstm_smem_bytes(int H, int layers, const int* units, int B) {
  return launch_smem(H, layers, units, B).total() * (int)sizeof(float);
}

// One LSTM call over B batch rows (of bstride per frame) in one cooperative
// launch on `stream`. Pointer arrays hold one entry per layer.
int wv_lstm_recurrence(const void* pre, const void* const* w_ih, const void* const* w_hh,
                       const void* const* b_ih, const void* const* b_hh, void* const* seq,
                       void* counters, int T, int B, int bstride, int H, int layers,
                       const int* units, const int* ctas, long long spin_ns, void* stream) {
  if (T < 1 || B < 1 || bstride < B || H < 1 || layers < 1 || layers > kMaxLayers)
    return (int)cudaErrorInvalidValue;
  Params p = {};
  p.pre = static_cast<const float*>(pre);
  int grid = 0;
  for (int l = 0; l < layers; ++l) {
    if (units[l] < 1 || 4 * units[l] * kGroup > kMaxOut * kThreads || units[l] * kGroup > kThreads ||
        ctas[l] * units[l] < H || (ctas[l] - 1) * units[l] >= H)
      return (int)cudaErrorInvalidValue;
    p.w_ih[l] = static_cast<const float*>(w_ih[l]);
    p.w_hh[l] = static_cast<const float*>(w_hh[l]);
    p.b_ih[l] = static_cast<const float*>(b_ih[l]);
    p.b_hh[l] = static_cast<const float*>(b_hh[l]);
    p.seq[l] = static_cast<float*>(seq[l]);
    p.units[l] = units[l];
    p.ctas[l] = ctas[l];
    grid += ctas[l];
  }
  p.counters = static_cast<int*>(counters);
  p.T = T;
  p.B = B;
  p.bstride = bstride;
  p.H = H;
  p.layers = layers;
  p.spin_ns = spin_ns;
  const int smem = wv_lstm_smem_bytes(H, layers, units, B);
  cudaError_t err = set_smem((const void*)lstm_recurrence_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0, dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, lstm_recurrence_kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm * sms < grid) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&p};
  return (int)cudaLaunchCooperativeKernel((const void*)lstm_recurrence_kernel, dim3(grid),
                                          dim3(kThreads), args, (size_t)smem,
                                          static_cast<cudaStream_t>(stream));
}

const char* wv_lstm_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
