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
// Design. A row is a group of L lanes, one float4 of the row a lane (L = 8
// at widths up to 32 floats, 16 up to 64, 32 up to 128): a warp holds 4, 2
// or 1 rows, a CTA of 128 threads 16, 8 or 4. The row's lanes read its ids
// (int64) and mask bytes 32 at a time, coalesced, and pass them around by
// shuffles within the row. The edges go in batches of 8: each lane issues
// the batch's 8 key-row loads (and 8 value-row loads when keys are not
// values) before the first use, forms its share of the 8 scores, and a
// butterfly over the row's lanes sums them. An online softmax folds the
// batch in: the running max m rises to the batch's max, acc and den are
// scaled by exp(m_old - m_new) (0 on the first batch), then e = exp(s - m),
// den += e and acc += e v. The differences s - m are exact at any score
// size (Sterbenz), so the layer-1 scores of ~4.5e3 rescale without loss.
// When keys are values (x is v: both main paths, SparseRGL's pallas backend
// and the relation chain) the row loaded for a score is the row it weights,
// so each neighbour row is read once. A row is a chain of 1 + ceil(K/8)
// dependent L2 round trips (its q and ids, then the batches), not the 2K of
// a walk edge by edge. The kernel takes no shared memory, so its launch sets
// no attribute.
//
// What bounds it on an H100 SXM: at the relation chain's shapes (n=8192,
// K=16, d=dv=64, x = v) the unique bytes are q, the table, cols and out:
// ~7.3 MB, 2.2 us at 3.35 TB/s; the edges need (2d + 2dv + 2) flops each,
// 34 MFLOP (0.5 us at 67 TFLOP/s f32): bytes bound it. The gathered rows
// (256 B an edge, ~34 MB) come from L2, which holds the 2 MB table, 8 edges
// a lane in flight.

#include "block_attention.cuh"

using namespace rgl;

namespace {

constexpr int kThreads = 128;    // a CTA: kThreads / L rows
constexpr int kEdgeBatch = 8;    // edge rows a lane has in flight
constexpr int kIdChunk = 32;     // ids a row reads at once: 32 / L a lane

template <int L, bool SHARED, bool HAS_MASK>
__global__ void __launch_bounds__(kThreads)
fused_gather_attention_kernel(const float* __restrict__ q,      // [n, d]
                              const float* __restrict__ x,      // [*, d]
                              const float* __restrict__ v,      // [*, dv]
                              const int64_t* __restrict__ cols, // [n, K]
                              const uint8_t* __restrict__ mask, // [n, K]
                              float* __restrict__ out,          // [n, dv]
                              int n, int K, int d, int dv) {
  constexpr int kIdLoads = kIdChunk / L;
  const int l = threadIdx.x % L;
  const int i = blockIdx.x * (kThreads / L) + threadIdx.x / L;
  // a row past n computes row n-1 and stores nothing: every lane of the
  // warp takes part in the shuffles
  const size_t r = (size_t)(i < n ? i : n - 1);
  const int f = 4 * l;
  const bool vx = d % 4 == 0 && aligned16(x) && aligned16(q);
  const bool vv = dv % 4 == 0 && aligned16(v);
  const bool vo = dv % 4 == 0 && aligned16(out);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4 qv = load4(q + r * d, f, d, vx);
  const long long* c_r = reinterpret_cast<const long long*>(cols) + r * K;
  const uint8_t* m_r = HAS_MASK ? mask + r * K : nullptr;

  float m = -INFINITY, den = 0.f;
  float4 acc = zero;
  for (int c0 = 0; c0 < K; c0 += kIdChunk) {  // uniform across the warp
    long long id_l[kIdLoads];
    int ok_l[kIdLoads];
#pragma unroll
    for (int t = 0; t < kIdLoads; ++t) {
      const int k = c0 + t * L + l;
      id_l[t] = k < K ? __ldg(c_r + k) : 0;
      ok_l[t] = k < K && (!HAS_MASK || __ldg(m_r + k) != 0);
    }
#pragma unroll
    for (int b = 0; b < kIdChunk / kEdgeBatch; ++b) {
      const int k0 = c0 + b * kEdgeBatch;
      if (k0 >= K) break;  // uniform
      // edge k0 + j is held by lane (b * 8 + j) % L of the row, in slot
      // (b * 8) / L: L is a multiple of 8, so a batch lies in one slot
      const int t = b * kEdgeBatch / L, src = b * kEdgeBatch % L;
      float4 xr[kEdgeBatch], vr[SHARED ? 1 : kEdgeBatch];
      int ok[kEdgeBatch];
#pragma unroll
      for (int j = 0; j < kEdgeBatch; ++j) {
        const long long id = __shfl_sync(0xffffffffu, id_l[t], src + j, L);
        ok[j] = __shfl_sync(0xffffffffu, ok_l[t], src + j, L);
        const bool real = k0 + j < K;
        xr[j] = real ? load4(x + id * d, f, d, vx) : zero;
        if (!SHARED)
          vr[SHARED ? 0 : j] = real ? load4(v + id * dv, f, dv, vv) : zero;
      }
      float p[kEdgeBatch];
#pragma unroll
      for (int j = 0; j < kEdgeBatch; ++j) p[j] = dot4(qv, xr[j], 0.f);
#pragma unroll
      for (int o = L / 2; o > 0; o >>= 1)
#pragma unroll
        for (int j = 0; j < kEdgeBatch; ++j)
          p[j] += __shfl_xor_sync(0xffffffffu, p[j], o);
      float mb = -INFINITY;
#pragma unroll
      for (int j = 0; j < kEdgeBatch; ++j) {
        if (!ok[j]) p[j] = -1e30f;
        if (k0 + j < K) mb = fmaxf(mb, p[j]);
      }
      const float m_new = fmaxf(m, mb);
      const float scale = expf(m - m_new);
      den *= scale;
      acc.x *= scale;
      acc.y *= scale;
      acc.z *= scale;
      acc.w *= scale;
#pragma unroll
      for (int j = 0; j < kEdgeBatch; ++j) {
        if (k0 + j >= K) continue;
        const float e = expf(p[j] - m_new);
        den += e;
        axpy4(e, SHARED ? xr[j] : vr[SHARED ? 0 : j], acc);
      }
      m = m_new;
    }
  }

  if (i >= n || f >= dv) return;
  den = fmaxf(den, 1e-20f);
  acc.x = acc.x / den;
  acc.y = acc.y / den;
  acc.z = acc.z / den;
  acc.w = acc.w / den;
  float* o_r = out + r * dv;
  if (vo) {
    *reinterpret_cast<float4*>(o_r + f) = acc;
  } else {
    o_r[f] = acc.x;
    if (f + 1 < dv) o_r[f + 1] = acc.y;
    if (f + 2 < dv) o_r[f + 2] = acc.z;
    if (f + 3 < dv) o_r[f + 3] = acc.w;
  }
}

template <int L, bool SHARED>
int launch(const float* q, const float* x, const float* v,
           const int64_t* cols, const uint8_t* mask, float* out, int n, int K,
           int d, int dv, cudaStream_t s) {
  constexpr int rows = kThreads / L;
  const int grid = (n + rows - 1) / rows;
  if (mask != nullptr)
    fused_gather_attention_kernel<L, SHARED, true>
        <<<grid, kThreads, 0, s>>>(q, x, v, cols, mask, out, n, K, d, dv);
  else
    fused_gather_attention_kernel<L, SHARED, false>
        <<<grid, kThreads, 0, s>>>(q, x, v, cols, mask, out, n, K, d, dv);
  return (int)cudaGetLastError();
}

template <bool SHARED>
int launch_lanes(const float* q, const float* x, const float* v,
                 const int64_t* cols, const uint8_t* mask, float* out, int n,
                 int K, int d, int dv, cudaStream_t s) {
  const int w = d > dv ? d : dv;
  if (w <= 32)
    return launch<8, SHARED>(q, x, v, cols, mask, out, n, K, d, dv, s);
  if (w <= 64)
    return launch<16, SHARED>(q, x, v, cols, mask, out, n, K, d, dv, s);
  return launch<32, SHARED>(q, x, v, cols, mask, out, n, K, d, dv, s);
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the CUDA error code (0 = launched). `mask` may
// be null (every edge valid). `shared` = 1 says that keys are values (x == v,
// d == dv): each neighbour row is then read once. The caller has checked
// shapes, types, that every id lies in [0, n), and d, dv <= 128.
int fga_launch(const float* q, const float* x, const float* v,
               const int64_t* cols, const uint8_t* mask, float* out, int n,
               int K, int d, int dv, int shared, void* stream) {
  if (n < 1 || K < 1 || d < 1 || d > 32 * kMaxF || dv < 1 ||
      dv > 32 * kMaxF || (shared && (x != v || d != dv)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return shared ? launch_lanes<true>(q, x, v, cols, mask, out, n, K, d, dv, s)
                : launch_lanes<false>(q, x, v, cols, mask, out, n, K, d, dv,
                                      s);
}

}  // extern "C"
