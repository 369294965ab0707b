// Helpers shared by the kernels of csrc/: warp reductions and the error
// string every library exports. Each .cu builds into a library of its own,
// so the one definition below lands once in each.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rgl {

constexpr int kWarps = 8;   // warps of a CTA
constexpr int kMaxF = 4;    // features per lane: d, dv <= 128

enum Epilogue { kNone = 0, kL2Norm = 1, kRelu = 2 };

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The epilogue of a finished output row held as kMaxF features a lane.
template <int EPI>
__device__ __forceinline__ void epilogue(float (&acc)[kMaxF], int lane,
                                         int dv) {
  if (EPI == kL2Norm) {
    float ss = 0.f;
#pragma unroll
    for (int t = 0; t < kMaxF; ++t)
      if (lane + 32 * t < dv) ss = fmaf(acc[t], acc[t], ss);
    const float nrm = fmaxf(sqrtf(warp_sum(ss)), 1e-6f);
#pragma unroll
    for (int t = 0; t < kMaxF; ++t) acc[t] = acc[t] / nrm;
  } else if (EPI == kRelu) {
#pragma unroll
    for (int t = 0; t < kMaxF; ++t) acc[t] = fmaxf(acc[t], 0.f);
  }
}

}  // namespace rgl

extern "C" const char* rgl_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
