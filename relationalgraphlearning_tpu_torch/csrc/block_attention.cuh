// The windowed block-attention body shared by fused_block_attention.cu
// (kernels #1 and #2) and chunk_block_attention.cu (kernels #4 and #7). The
// kernels differ only in how a CTA learns the table row of each window slot
// (`ids`).
//
// A CTA owns 32 query rows (one mask word row) of one block of B rows, over a
// window of C slots. The calling kernel fills ids[C] (clipped table rows) and
// ms[C] (the CTA's mask words), then calls stage_rows() and attend(). Each
// warp takes one query row at a time: lanes run over feature columns; a
// ballot over the row's edge bits enumerates its edges 32 slots at a time,
// so the work follows the edges, not the window. For each edge the warp
// forms the dot product with a butterfly sum. Masked slots add exactly 0 to
// every sum of the reference too, so skipping them changes no value beyond
// summation order. All arithmetic is f32 on CUDA cores (no TF32).
#pragma once

#include "common.cuh"

namespace rgl {

constexpr int kRowsPerCta = 32;  // one mask word row

struct Window {
  float* xs;     // [C, d] staged key rows
  uint32_t* ms;  // [C] the CTA's mask words: row w*32+j is bit j
  int* ids;      // [C] table row of each slot
  float* sc;     // [kWarps, C] scores of each warp's current row
};

// Dynamic shared memory one CTA needs, in bytes.
inline size_t window_smem_bytes(int C, int d) {
  return (size_t)C * d * sizeof(float) + (size_t)C * 2 * sizeof(int32_t) +
         (size_t)kWarps * C * sizeof(float);
}

__device__ __forceinline__ Window carve_window(float* smem, int C, int d) {
  Window w;
  w.xs = smem;
  w.ms = reinterpret_cast<uint32_t*>(w.xs + (size_t)C * d);
  w.ids = reinterpret_cast<int*>(w.ms + C);
  w.sc = reinterpret_cast<float*>(w.ids + C);
  return w;
}

// Copy the C rows named by ids from table x [*, d] into xs. Neighbouring
// threads read neighbouring floats of a row.
__device__ __forceinline__ void stage_rows(const Window& w,
                                           const float* __restrict__ x,
                                           int C, int d) {
  for (int i = threadIdx.x; i < C * d; i += blockDim.x) {
    const int c = i / d, k = i - c * d;
    w.xs[i] = __ldg(x + (size_t)w.ids[c] * d + k);
  }
}

__device__ __forceinline__ bool has_edge(const Window& w, int lr, int c,
                                         int C) {
  return c < C && ((w.ms[c] >> lr) & 1u) != 0u;
}

// For each of the CTA's 32 rows r of block blk:
//   s[c] = q[blk,r,:] . xs[c,:]                        over the row's edges
//   e[c] = exp(s[c] - m)      m = max over the edges when STABLE, else 0
//   out  = sum_c e[c] v[ids[c],:] / max(sum_c e[c], 1e-20)
// then the epilogue. Values are the staged keys when SHARED. Rows with no
// edge give exactly 0.
template <bool SHARED, bool STABLE, int EPI>
__device__ __forceinline__ void attend(const Window& w,
                                       const float* __restrict__ q,
                                       const float* __restrict__ v,
                                       float* __restrict__ out, int blk,
                                       int wrow, int B, int C, int d, int dv) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* sc_w = w.sc + (size_t)warp * C;
  for (int lr = warp; lr < kRowsPerCta; lr += kWarps) {
    const size_t row = (size_t)blk * B + wrow * kRowsPerCta + lr;
    const float* q_r = q + row * d;
    float qv[kMaxF];
#pragma unroll
    for (int t = 0; t < kMaxF; ++t) {
      const int f = lane + 32 * t;
      qv[t] = f < d ? q_r[f] : 0.f;
    }

    // pass 1: scores of the row's edges, and their max
    float m = -1e30f;
    for (int c0 = 0; c0 < C; c0 += 32) {
      unsigned live = __ballot_sync(
          0xffffffffu, has_edge(w, lr, c0 + lane, C));
      while (live) {
        const int cc = c0 + __ffs(live) - 1;
        live &= live - 1;
        const float* xr = w.xs + (size_t)cc * d;
        float p = 0.f;
#pragma unroll
        for (int t = 0; t < kMaxF; ++t) {
          const int f = lane + 32 * t;
          if (f < d) p = fmaf(qv[t], xr[f], p);
        }
        p = warp_sum(p);
        if (lane == 0) sc_w[cc] = p;
        m = fmaxf(m, p);
      }
    }
    __syncwarp();

    // pass 2: e, sum e and sum e*v over the same edges
    float acc[kMaxF];
#pragma unroll
    for (int t = 0; t < kMaxF; ++t) acc[t] = 0.f;
    float sum_e = 0.f;
    for (int c0 = 0; c0 < C; c0 += 32) {
      unsigned live = __ballot_sync(
          0xffffffffu, has_edge(w, lr, c0 + lane, C));
      while (live) {
        const int cc = c0 + __ffs(live) - 1;
        live &= live - 1;
        const float e = STABLE ? expf(sc_w[cc] - m) : expf(sc_w[cc]);
        sum_e += e;
        const float* vr = SHARED ? w.xs + (size_t)cc * d
                                 : v + (size_t)w.ids[cc] * dv;
#pragma unroll
        for (int t = 0; t < kMaxF; ++t) {
          const int f = lane + 32 * t;
          if (f < dv) acc[t] = fmaf(e, SHARED ? vr[f] : __ldg(vr + f), acc[t]);
        }
      }
    }
    sum_e = fmaxf(sum_e, 1e-20f);
#pragma unroll
    for (int t = 0; t < kMaxF; ++t) acc[t] = acc[t] / sum_e;
    epilogue<EPI>(acc, lane, dv);
    float* o_r = out + row * dv;
#pragma unroll
    for (int t = 0; t < kMaxF; ++t) {
      const int f = lane + 32 * t;
      if (f < dv) o_r[f] = acc[t];
    }
    __syncwarp();  // sc_w is rewritten by the warp's next row
  }
}

}  // namespace rgl
