// The step barrier of the persistent LSTM kernel alone, for timing it
// (tools/hopper_probes/lstm_recurrence.py): `steps` rounds of the kernel's
// arrive() and poll() on one counter over `ctas` co-resident CTAs of the
// kernel's block size. Built with the kernel's source included, so that it
// times the same device functions.

#include "../../waveverify_torch/csrc/lstm_recurrence.cu"

namespace {

__global__ void __launch_bounds__(kThreads, 1) barrier_probe_kernel(int* counter, int steps,
                                                                   long long spin_ns) {
  int seen = 0;
  for (int t = 1; t <= steps; ++t) {
    arrive(counter);
    if (threadIdx.x == kThreads - 1) poll(counter, t * (int)gridDim.x, seen, spin_ns);
    __syncthreads();
  }
}

}  // namespace

// `steps` rounds over `ctas` CTAs on `stream` (counter zeroed by the caller).
extern "C" int wv_lstm_barrier_probe(int ctas, int steps, void* counter, long long spin_ns,
                                     void* stream) {
  if (ctas < 1 || steps < 1) return (int)cudaErrorInvalidValue;
  int* c = static_cast<int*>(counter);
  void* args[] = {&c, &steps, &spin_ns};
  return (int)cudaLaunchCooperativeKernel((const void*)barrier_probe_kernel, dim3(ctas),
                                          dim3(kThreads), args, 0,
                                          static_cast<cudaStream_t>(stream));
}
