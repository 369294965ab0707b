// A stand-in for the CUDA runtime, so that a kernel's source builds with the
// host's C++ compiler and runs on the CPU in a test: a launch runs the grid's
// blocks one after another, each block's threads as host threads;
// __syncthreads is a barrier across them, and a warp's shuffles exchange
// through shared slots between waits at the warp's own barrier (blocks of
// whole warps). Dynamic shared memory is the array
// `smem` that the test appends to the source (stub::kSmemFloat4 float4s,
// the card's opt-in limit). The card reports stub::kSms SMs and one block a
// SM, so that a persistent kernel walks over more tiles than blocks.
#pragma once

#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__
#define __launch_bounds__(...)

namespace stub {
constexpr int kSmemBytes = 232448;
constexpr int kSmemFloat4 = kSmemBytes / 16;
constexpr int kSms = 3;
inline std::barrier<>* block_barrier;
inline std::vector<std::barrier<>*> warp_barriers;  // a block's warps'
inline float slots[1024];                            // a block's threads'
}  // namespace stub

struct float4 {
  float x, y, z, w;
};
inline float4 make_float4(float x, float y, float z, float w) {
  return {x, y, z, w};
}
struct dim3 {
  unsigned x = 0, y = 0, z = 0;
};
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 gridDim;

typedef int cudaError_t;
typedef void* cudaStream_t;
enum {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaErrorInvalidConfiguration = 9
};
enum cudaDeviceAttr {
  cudaDevAttrMultiProcessorCount,
  cudaDevAttrMaxSharedMemoryPerBlockOptin
};
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };

inline cudaError_t cudaGetDevice(int* dev) {
  *dev = 0;
  return cudaSuccess;
}
inline cudaError_t cudaDeviceGetAttribute(int* value, cudaDeviceAttr attr,
                                          int) {
  *value = attr == cudaDevAttrMultiProcessorCount ? stub::kSms
                                                  : stub::kSmemBytes;
  return cudaSuccess;
}
template <class F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) {
  return cudaSuccess;
}
template <class F>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* blocks, F, int,
                                                          size_t smem) {
  *blocks = smem <= (size_t)stub::kSmemBytes ? 1 : 0;
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "stub"; }
inline void __syncthreads() { stub::block_barrier->arrive_and_wait(); }
// A warp's lanes exchange through one slot a thread, between two waits at
// the warp's barrier.
inline float stub_exchange(float v, int from_lane) {
  const int t = threadIdx.x, warp = t / 32;
  stub::slots[t] = v;
  stub::warp_barriers[warp]->arrive_and_wait();
  const float got = stub::slots[warp * 32 + from_lane];
  stub::warp_barriers[warp]->arrive_and_wait();
  return got;
}
inline void __syncwarp(unsigned = 0xffffffffu) {
  stub::warp_barriers[threadIdx.x / 32]->arrive_and_wait();
}
inline float __shfl_sync(unsigned, float v, int src, int width = 32) {
  const int lane = threadIdx.x % 32;
  return stub_exchange(v, (lane & ~(width - 1)) + src % width);
}
inline float __shfl_xor_sync(unsigned, float v, int mask, int = 32) {
  return stub_exchange(v, (threadIdx.x % 32) ^ mask);
}
template <class T>
T __ldg(const T* p) {
  return *p;
}
using std::min;

// kernel<<<grid, threads, smem, stream>>>(args), block after block
template <class K, class A>
void stub_launch(K kernel, unsigned grid, int threads, size_t smem,
                 cudaStream_t, const A& args) {
  if (smem > (size_t)stub::kSmemBytes) return;
  gridDim.x = grid;
  for (unsigned b = 0; b < grid; ++b) {
    std::barrier<> barrier(threads);
    stub::block_barrier = &barrier;
    std::vector<std::unique_ptr<std::barrier<>>> warps;
    stub::warp_barriers.clear();
    for (int w = 0; w < threads / 32; ++w) {
      warps.push_back(std::make_unique<std::barrier<>>(32));
      stub::warp_barriers.push_back(warps.back().get());
    }
    std::vector<std::thread> block;
    for (int t = 0; t < threads; ++t)
      block.emplace_back([&, t, b] {
        threadIdx.x = t;
        blockIdx.x = b;
        kernel(args);
      });
    for (auto& thread : block) thread.join();
  }
}
