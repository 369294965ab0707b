// Fused per-edge gather attention for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel tools/probe_mosaic_gather.py::
// fused_gather_attention (pallas_call at :68, body _kernel :38-62), the
// kernel behind relationalgraphlearning_tpu/ops/pallas_graph.py::
// fused_neighbor_attention (SparseRGL backend="pallas"), which the TPU
// cannot compile (Mosaic has no cross-register row gather) and keeps gated
// off. Hopper gathers rows from device memory directly.
//
// What it computes, for each row i of q [n, d] over its K neighbours
// cols[i, :] (the fixed-K chain sddmm_fixed_k -> neighbor_softmax ->
// spmm_fixed_k of ops/sparse.py):
//   s[k] = mask[i,k] ? q[i,:] . x[cols[i,k],:] : -1e30
//   e[k] = exp(s[k] - max_k s[k])
//   out  = sum_k e[k] v[cols[i,k],:] / max(sum_k e[k], 1e-20)
// A fully masked row has every s[k] = -1e30, so e[k] = 1 and the row is the
// uniform average of v over its cols, as the chain gives (the block kernels
// give 0 there). A duplicate neighbour counts once per occurrence. A null
// mask means every edge is valid. The wrapper checks that every id lies in
// [0, n). All arithmetic is f32 on CUDA cores (no TF32).
//
// Design (simple first): one warp per row, 8 rows per CTA, lanes over the
// feature columns (d, dv <= 128, four a lane). A warp reads its 32 next
// neighbour ids and mask bytes with one load each, then walks them by
// shuffle: for each valid edge it reads the neighbour's key row once
// (coalesced), forms the dot product with a butterfly sum and keeps the
// score in shared memory. A second walk forms e, sum e and sum e*v, reading
// each value row whose weight is not 0.
//
// What bounds it on an H100 SXM: at the relation chain's shapes (n=8192,
// K=16, d=dv=64, x = v) the unique bytes are q, the table, cols and out:
// ~7.3 MB, 2.2 us at 3.35 TB/s; the edges need (2d + 2dv + 2) flops each,
// 34 MFLOP (0.5 us at 67 TFLOP/s f32): bytes bound it. The gathered rows
// (2 x 256 B an edge, ~67 MB) come from L2, which holds the 2 MB table; a
// warp's walk is a chain of dependent L2 reads and shuffles, latency that
// only many warps in flight hide.

#include "common.cuh"

using namespace rgl;

namespace {

template <bool HAS_MASK>
__global__ void __launch_bounds__(kWarps * 32)
fused_gather_attention_kernel(const float* __restrict__ q,      // [n, d]
                              const float* __restrict__ x,      // [n, d]
                              const float* __restrict__ v,      // [n, dv]
                              const int64_t* __restrict__ cols, // [n, K]
                              const uint8_t* __restrict__ mask, // [n, K]
                              float* __restrict__ out,          // [n, dv]
                              int n, int K, int d, int dv) {
  extern __shared__ float smem[];  // [kWarps, K] scores
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + warp;
  if (i >= n) return;  // warp-uniform; the kernel has no CTA barrier
  float* sc = smem + (size_t)warp * K;
  const int64_t* c_i = cols + (size_t)i * K;
  const uint8_t* m_i = HAS_MASK ? mask + (size_t)i * K : nullptr;

  float qv[kMaxF];
#pragma unroll
  for (int t = 0; t < kMaxF; ++t) {
    const int f = lane + 32 * t;
    qv[t] = f < d ? q[(size_t)i * d + f] : 0.f;
  }

  // pass 1: the K scores and their max
  float m = -1e30f;
  for (int k0 = 0; k0 < K; k0 += 32) {
    const int kk = k0 + lane;
    const long long id_l = kk < K ? (long long)c_i[kk] : 0;
    const int ok_l = kk < K && (!HAS_MASK || m_i[kk] != 0);
    const int kn = min(32, K - k0);
    for (int j = 0; j < kn; ++j) {
      const long long id = __shfl_sync(0xffffffffu, id_l, j);
      float p = -1e30f;
      if (__shfl_sync(0xffffffffu, ok_l, j)) {
        const float* xr = x + (size_t)id * d;
        p = 0.f;
#pragma unroll
        for (int t = 0; t < kMaxF; ++t) {
          const int f = lane + 32 * t;
          if (f < d) p = fmaf(qv[t], __ldg(xr + f), p);
        }
        p = warp_sum(p);
      }
      if (lane == 0) sc[k0 + j] = p;
      m = fmaxf(m, p);
    }
  }
  __syncwarp();

  // pass 2: e, sum e and sum e*v
  float acc[kMaxF];
#pragma unroll
  for (int t = 0; t < kMaxF; ++t) acc[t] = 0.f;
  float den = 0.f;
  for (int k0 = 0; k0 < K; k0 += 32) {
    const int kk = k0 + lane;
    const long long id_l = kk < K ? (long long)c_i[kk] : 0;
    const int kn = min(32, K - k0);
    for (int j = 0; j < kn; ++j) {
      const long long id = __shfl_sync(0xffffffffu, id_l, j);
      const float e = expf(sc[k0 + j] - m);
      den += e;
      if (e != 0.f) {
        const float* vr = v + (size_t)id * dv;
#pragma unroll
        for (int t = 0; t < kMaxF; ++t) {
          const int f = lane + 32 * t;
          if (f < dv) acc[t] = fmaf(e, __ldg(vr + f), acc[t]);
        }
      }
    }
  }
  den = fmaxf(den, 1e-20f);
  float* o_i = out + (size_t)i * dv;
#pragma unroll
  for (int t = 0; t < kMaxF; ++t) {
    const int f = lane + 32 * t;
    if (f < dv) o_i[f] = acc[t] / den;
  }
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the CUDA error code (0 = launched). `mask` may
// be null (every edge valid). The caller has checked shapes, types, that
// every id lies in [0, n), and d, dv <= 128.
int fga_launch(const float* q, const float* x, const float* v,
               const int64_t* cols, const uint8_t* mask, float* out, int n,
               int K, int d, int dv, void* stream) {
  if (n < 1 || K < 1 || d < 1 || d > 32 * kMaxF || dv < 1 ||
      dv > 32 * kMaxF)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)kWarps * K * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = (n + kWarps - 1) / kWarps;
  if (mask != nullptr) {
    auto kern = fused_gather_attention_kernel<true>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kern<<<grid, kWarps * 32, smem, s>>>(q, x, v, cols, mask, out, n, K, d,
                                         dv);
  } else {
    auto kern = fused_gather_attention_kernel<false>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kern<<<grid, kWarps * 32, smem, s>>>(q, x, v, cols, mask, out, n, K, d,
                                         dv);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
