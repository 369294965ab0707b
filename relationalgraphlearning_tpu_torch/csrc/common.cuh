// Helpers shared by the kernels of csrc/: warp reductions, the launch's
// shared-memory reservation and the error string every library exports. Each
// .cu builds into a library of its own, so the one definition below lands
// once in each.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <unordered_map>

namespace rgl {

// Let `kern` launch with `smem` bytes of dynamic shared memory. Above the
// 48 KB every kernel may take, cudaFuncSetAttribute raises the kernel's limit,
// once per kernel and size: the largest size granted so far is kept, so a
// launch at that size or below makes no call (nor does one inside a CUDA graph
// capture after a warm-up). A size above the card's shared memory is refused
// there; the error is returned and cleared, so that the next launch's
// cudaGetLastError does not report it. The limits are kept per kernel, not per
// device: one card a process.
inline cudaError_t reserve_smem(const void* kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  static std::mutex mu;
  static std::unordered_map<const void*, size_t> granted;
  std::lock_guard<std::mutex> lock(mu);
  size_t& have = granted[kern];
  if (smem <= have) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  have = smem;
  return cudaSuccess;
}

constexpr int kWarps = 8;   // warps of a CTA
constexpr int kMaxF = 4;    // features per lane: d, dv <= 128

enum Epilogue { kNone = 0, kL2Norm = 1, kRelu = 2 };

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// warp_sum over a group of L lanes (aligned, L a power of two <= 32): each
// group gets its own sum. Every lane of the warp must take part.
template <int L>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The epilogue of a finished output row held by a group of L lanes, F4
// float4s a lane; features past the row's width hold exactly 0, so they add
// nothing to the l2norm's sum of squares.
template <int EPI, int L, int F4>
__device__ __forceinline__ void row_epilogue(float4 (&acc)[F4]) {
  if (EPI == kL2Norm) {
    float ss = 0.f;
#pragma unroll
    for (int u = 0; u < F4; ++u) {
      ss = fmaf(acc[u].x, acc[u].x, ss);
      ss = fmaf(acc[u].y, acc[u].y, ss);
      ss = fmaf(acc[u].z, acc[u].z, ss);
      ss = fmaf(acc[u].w, acc[u].w, ss);
    }
    const float nrm = fmaxf(sqrtf(group_sum<L>(ss)), 1e-6f);
#pragma unroll
    for (int u = 0; u < F4; ++u) {
      acc[u].x = acc[u].x / nrm;
      acc[u].y = acc[u].y / nrm;
      acc[u].z = acc[u].z / nrm;
      acc[u].w = acc[u].w / nrm;
    }
  } else if (EPI == kRelu) {
#pragma unroll
    for (int u = 0; u < F4; ++u) {
      acc[u].x = fmaxf(acc[u].x, 0.f);
      acc[u].y = fmaxf(acc[u].y, 0.f);
      acc[u].z = fmaxf(acc[u].z, 0.f);
      acc[u].w = fmaxf(acc[u].w, 0.f);
    }
  }
}

}  // namespace rgl

extern "C" const char* rgl_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
