// The float32 FMA ceiling of the card, plain C interface (sm_90a).
//
// Counterpart of bench_roofline.py::vpu_peak (:65-81), which XLA fuses into
// one loop: `fmas` chained x = x * 1.0000001 + 1e-9 an element a pass, over
// n elements, `passes` passes. PyTorch run eagerly would launch a kernel an
// operation and time the memory instead, so the chain is this one kernel: a
// thread takes an element into a register, runs every pass's FMAs on it
// there and writes it once. What bounds it on an H100 SXM: at n = 2^20, 128
// FMAs and 64 passes, 2 * 128 * 64 flops an element against 8 bytes (2,048
// flops a byte), 17.2 GFLOP, 0.26 ms at 67 TFLOP/s; the memory is 8 MB,
// 2.5 us at 3.35 TB/s: operations. Each element's chain is serial, so the
// FMA units' latency is hidden by the number of resident threads, not by
// the thread: 2^20 threads are about four waves of the card's 270,336.

#include "common.cuh"

namespace {

__global__ void __launch_bounds__(256)
fma_chain_kernel(const float* __restrict__ x, float* __restrict__ out, int n,
                 int fmas, int passes) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v = x[i];
  for (int p = 0; p < passes; ++p) {
#pragma unroll 16
    for (int k = 0; k < fmas; ++k) v = fmaf(v, 1.0000001f, 1e-9f);
  }
  out[i] = v;
}

}  // namespace

extern "C" {

// out = x after passes * fmas chained FMAs an element, on `stream`; returns
// the CUDA error code (0 = launched).
int fma_chain_launch(const float* x, float* out, int n, int fmas, int passes,
                     void* stream) {
  if (n < 1 || fmas < 0 || passes < 0) return (int)cudaErrorInvalidValue;
  fma_chain_kernel<<<(n + 255) / 256, 256, 0,
                     static_cast<cudaStream_t>(stream)>>>(x, out, n, fmas,
                                                          passes);
  return (int)cudaGetLastError();
}

}  // extern "C"
