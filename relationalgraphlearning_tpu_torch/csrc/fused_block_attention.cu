// Fused windowed block attention for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernels of relationalgraphlearning_tpu/ops/pallas_block.py:
//   fused_block_attention_packed_shared (pallas_call at :192, body
//     _kernel_packed_shared :171 + _masked_softmax_agg :119-161)  -> SHARED=true
//   fused_block_attention_packed        (pallas_call at :235, body
//     _kernel_packed :164)                                         -> SHARED=false
//
// What it computes, for each block b of B query rows and each row r:
//   s[c]   = q[b,r,:] . x[cand[b,c],:]           over the C window slots
//   e[c]   = mask(b,r,c) ? exp(s[c] - m) : 0      m = max over real edges when
//            STABLE, m = 0 otherwise (exact unshifted softmax)
//   out    = (sum_c e[c] * v[cand[b,c],:]) / max(sum_c e[c], 1e-20)
//   then the epilogue: none, l2norm (row / max(||row||, 1e-6)) or relu.
// The mask is bitpacked along rows: row w*32+j of block b is bit j of word
// mbits[b, w, c] (pallas_block.py::pack_emask). Sentinel candidates (id n)
// are clipped to n-1, as pallas_block.py:298 does before its gather; their
// mask bits are never set. Keys and values are x when SHARED (the
// SparseRGL production case, values == keys == H); else v is a second table.
// Rows with no edge give exactly 0. All arithmetic is f32 on CUDA cores (no
// TF32): the reference is exact f32.
//
// Design (a simple first kernel, not the TPU's one-grid-step-per-block):
//   grid (nb, B/32), 256 threads = 8 warps. A CTA owns 32 rows of one block,
//   i.e. one mask word row. It gathers its block's C candidate key rows
//   through cand into dynamic shared memory (C*d*4 B: 73,728 B at C=576,
//   d=32, above the 48 KB default, hence the attribute), plus the C mask
//   words and the C clipped ids. Each warp then takes one query row at a
//   time, 4 rows per warp: lanes run over feature columns; a ballot over the
//   row's mask bits enumerates its edges, and for each edge the warp forms
//   the dot product with a butterfly sum. Masked slots contribute exactly 0
//   to every sum, so they are skipped. Scores go to a per-warp row of
//   shared memory; a second walk over the edges forms e, sum e and e*v.
//
// What bounds it on an H100 SXM: at the slice shapes (nb=40, B=256, C=576,
// d=32, K=16 edges a row) the dense formulation is 4*B*C*d*nb = 0.755 GFLOP
// plus 5.9 M exp, 11 us at the 67 TFLOP/s f32 non-tensor peak. Because the
// kernel visits only set mask bits, the work this data needs is 4*E*d flops
// for E = n*K = 163,840 edges (21 MFLOP, 0.3 us), and the unique bytes are
// about 4.8 MB (q 1.31 MB, table 1.31 MB, cand 92 KB, mbits 737 KB, out
// 1.31 MB), 1.4 us at 3.35 TB/s: bytes bound it. The staging re-reads each
// block's table once per CTA (B/32 = 8 times, about 24 MB from L2), which is
// what a faster design would cut first.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerCta = 32;   // one mask word row
constexpr int kMaxF = 4;          // features per lane: d, dv <= 128

enum Epilogue { kNone = 0, kL2Norm = 1, kRelu = 2 };

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <bool SHARED, bool STABLE, int EPI>
__global__ void __launch_bounds__(kWarps * 32)
fused_block_attention_kernel(const float* __restrict__ q,      // [nb, B, d]
                             const float* __restrict__ x,      // [n, d]
                             const float* __restrict__ v,      // [n, dv]
                             const int64_t* __restrict__ cand, // [nb, C]
                             const int32_t* __restrict__ mbits,// [nb, B/32, C]
                             float* __restrict__ out,          // [nb, B, dv]
                             int B, int C, int d, int dv, int n) {
  extern __shared__ float smem[];
  float* xs = smem;                                          // [C, d]
  uint32_t* ms = reinterpret_cast<uint32_t*>(xs + (size_t)C * d);  // [C]
  int* ids = reinterpret_cast<int*>(ms + C);                 // [C]
  float* sc = reinterpret_cast<float*>(ids + C);             // [kWarps, C]

  const int blk = blockIdx.x;
  const int wrow = blockIdx.y;           // mask word row = 32 query rows
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int nthreads = blockDim.x;

  const int64_t* cand_b = cand + (size_t)blk * C;
  const int32_t* m_b = mbits + ((size_t)blk * (B / 32) + wrow) * C;
  for (int c = tid; c < C; c += nthreads) {
    int64_t id = cand_b[c];
    id = id < 0 ? 0 : (id > n - 1 ? n - 1 : id);
    ids[c] = (int)id;
    ms[c] = (uint32_t)m_b[c];
  }
  __syncthreads();
  for (int i = tid; i < C * d; i += nthreads) {
    const int c = i / d, k = i - c * d;
    xs[i] = __ldg(x + (size_t)ids[c] * d + k);
  }
  __syncthreads();

  float* sc_w = sc + (size_t)warp * C;
  for (int lr = warp; lr < kRowsPerCta; lr += kWarps) {
    const int r = wrow * kRowsPerCta + lr;
    const float* q_r = q + ((size_t)blk * B + r) * d;
    float qv[kMaxF];
#pragma unroll
    for (int t = 0; t < kMaxF; ++t) {
      const int f = lane + 32 * t;
      qv[t] = f < d ? q_r[f] : 0.f;
    }

    // pass 1: scores of the row's edges, and their max
    float m = -1e30f;
    for (int c0 = 0; c0 < C; c0 += 32) {
      const int c = c0 + lane;
      const bool bit = c < C && ((ms[c] >> lr) & 1u);
      unsigned live = __ballot_sync(0xffffffffu, bit);
      while (live) {
        const int cc = c0 + __ffs(live) - 1;
        live &= live - 1;
        const float* xr = xs + (size_t)cc * d;
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
    float den = 0.f;
    for (int c0 = 0; c0 < C; c0 += 32) {
      const int c = c0 + lane;
      const bool bit = c < C && ((ms[c] >> lr) & 1u);
      unsigned live = __ballot_sync(0xffffffffu, bit);
      while (live) {
        const int cc = c0 + __ffs(live) - 1;
        live &= live - 1;
        const float e = STABLE ? expf(sc_w[cc] - m) : expf(sc_w[cc]);
        den += e;
        if (SHARED) {
          const float* vr = xs + (size_t)cc * d;
#pragma unroll
          for (int t = 0; t < kMaxF; ++t) {
            const int f = lane + 32 * t;
            if (f < dv) acc[t] = fmaf(e, vr[f], acc[t]);
          }
        } else {
          const float* vr = v + (size_t)ids[cc] * dv;
#pragma unroll
          for (int t = 0; t < kMaxF; ++t) {
            const int f = lane + 32 * t;
            if (f < dv) acc[t] = fmaf(e, __ldg(vr + f), acc[t]);
          }
        }
      }
    }
    den = fmaxf(den, 1e-20f);
#pragma unroll
    for (int t = 0; t < kMaxF; ++t) acc[t] = acc[t] / den;
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
    float* o_r = out + ((size_t)blk * B + r) * dv;
#pragma unroll
    for (int t = 0; t < kMaxF; ++t) {
      const int f = lane + 32 * t;
      if (f < dv) o_r[f] = acc[t];
    }
    __syncwarp();  // sc_w is rewritten by the warp's next row
  }
}

template <bool SHARED, bool STABLE, int EPI>
int launch_one(const float* q, const float* x, const float* v,
               const int64_t* cand, const int32_t* mbits, float* out,
               int nb, int B, int C, int d, int dv, int n, size_t smem,
               cudaStream_t stream) {
  auto kern = fused_block_attention_kernel<SHARED, STABLE, EPI>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(nb, B / kRowsPerCta);
  kern<<<grid, kWarps * 32, smem, stream>>>(q, x, v, cand, mbits, out, B, C,
                                            d, dv, n);
  return (int)cudaGetLastError();
}

template <bool SHARED, bool STABLE>
int launch_epi(int epilogue, const float* q, const float* x, const float* v,
               const int64_t* cand, const int32_t* mbits, float* out, int nb,
               int B, int C, int d, int dv, int n, size_t smem,
               cudaStream_t s) {
  switch (epilogue) {
    case kNone:
      return launch_one<SHARED, STABLE, kNone>(q, x, v, cand, mbits, out, nb,
                                               B, C, d, dv, n, smem, s);
    case kL2Norm:
      return launch_one<SHARED, STABLE, kL2Norm>(q, x, v, cand, mbits, out,
                                                 nb, B, C, d, dv, n, smem, s);
    case kRelu:
      return launch_one<SHARED, STABLE, kRelu>(q, x, v, cand, mbits, out, nb,
                                               B, C, d, dv, n, smem, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory one CTA needs, in bytes. Above the card's limit
// cudaFuncSetAttribute refuses it, and the launch returns that error.
size_t smem_bytes(int C, int d) {
  return (size_t)C * d * sizeof(float) + (size_t)C * 2 * sizeof(int32_t) +
         (size_t)kWarps * C * sizeof(float);
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the CUDA error code (0 = launched). The caller
// has checked shapes, types, B % 32 == 0 and d, dv <= 128.
int fba_launch(const float* q, const float* x, const float* v,
               const int64_t* cand, const int32_t* mbits, float* out, int nb,
               int B, int C, int d, int dv, int n, int shared, int stable,
               int epilogue, void* stream) {
  if (B % kRowsPerCta != 0 || d < 1 || d > 32 * kMaxF || dv < 1 ||
      dv > 32 * kMaxF || (shared && dv != d))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(C, d);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (shared) {
    return stable ? launch_epi<true, true>(epilogue, q, x, x, cand, mbits, out,
                                           nb, B, C, d, dv, n, smem, s)
                  : launch_epi<true, false>(epilogue, q, x, x, cand, mbits,
                                            out, nb, B, C, d, dv, n, smem, s);
  }
  return stable ? launch_epi<false, true>(epilogue, q, x, v, cand, mbits, out,
                                          nb, B, C, d, dv, n, smem, s)
                : launch_epi<false, false>(epilogue, q, x, v, cand, mbits, out,
                                           nb, B, C, d, dv, n, smem, s);
}

const char* fba_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
