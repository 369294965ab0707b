// Fused windowed block attention for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernels of relationalgraphlearning_tpu/ops/pallas_block.py:
//   fused_block_attention_packed_shared (pallas_call at :192, body
//     _kernel_packed_shared :171 + _masked_softmax_agg :119-161)  -> fba_launch, shared=1
//   fused_block_attention_packed        (pallas_call at :235, body
//     _kernel_packed :164)                                         -> fba_launch, shared=0
//   fused_block_attention (the r3 kernel; pallas_call at :99, body
//     _kernel :71-86)                                              -> fba_dense_launch
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
// The r3 kernel takes pre-gathered tables xg [nb, C, d], vg [nb, C, dv] and a
// dense f32 0/1 mask [nb, B, C], always stable, and divides before the value
// product: out = sum_c (e[c] / max(sum e, 1e-20)) vg[b,c,:].
// Rows with no edge give exactly 0. All arithmetic is f32 on CUDA cores (no
// TF32): the reference is exact f32.
//
// Design (a simple first kernel, not the TPU's one-grid-step-per-block):
//   grid (nb, B/32), 256 threads = 8 warps. A CTA owns 32 rows of one block,
//   i.e. one mask word row. It gathers its block's C candidate key rows
//   through cand into dynamic shared memory (C*d*4 B: 73,728 B at C=576,
//   d=32, above the 48 KB default, hence the attribute), plus the C mask
//   words and the C clipped ids; then block_attention.cuh's attend() runs
//   the rows, visiting set mask bits only.
//
// What bounds it on an H100 SXM: at the slice shapes (nb=40, B=256, C=576,
// d=32, K=16 edges a row) the dense formulation is 4*B*C*d*nb = 0.755 GFLOP
// plus 5.9 M exp, 11 us at the 67 TFLOP/s f32 non-tensor peak. Because the
// kernel visits only set mask bits, the work this data needs is 4*E*d flops
// for E = n*K = 163,840 edges (21 MFLOP, 0.3 us), and the unique bytes are
// about 4.8 MB (q 1.31 MB, table 1.31 MB, cand 92 KB, mbits 737 KB, out
// 1.31 MB), 1.4 us at 3.35 TB/s: bytes bound it. The staging re-reads each
// block's table once per CTA (B/32 = 8 times, about 24 MB from L2), which is
// what a faster design would cut first. The r3 form moves its f32 mask
// (32x the packed bits) and two pre-gathered tables: bytes bound it harder.

#include "block_attention.cuh"

using namespace rgl;

namespace {

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
  const Window w = carve_window(smem, C, d);
  const int blk = blockIdx.x, wrow = blockIdx.y;
  const int64_t* cand_b = cand + (size_t)blk * C;
  const int32_t* m_b = mbits + ((size_t)blk * (B / 32) + wrow) * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    int64_t id = cand_b[c];
    id = id < 0 ? 0 : (id > n - 1 ? n - 1 : id);
    w.ids[c] = (int)id;
    w.ms[c] = (uint32_t)m_b[c];
  }
  __syncthreads();
  stage_rows(w, x, C, d);
  __syncthreads();
  attend<SHARED, STABLE, EPI, kBits, false>(w, q, v, nullptr, out, blk, wrow,
                                            B, C, d, dv);
}

// The r3 kernel: pre-gathered tables, dense f32 mask, divide first.
__global__ void __launch_bounds__(kWarps * 32)
fused_block_attention_dense_kernel(const float* __restrict__ q,   // [nb, B, d]
                                   const float* __restrict__ xg,  // [nb, C, d]
                                   const float* __restrict__ vg,  // [nb, C, dv]
                                   const float* __restrict__ em,  // [nb, B, C]
                                   float* __restrict__ out,       // [nb, B, dv]
                                   int B, int C, int d, int dv) {
  extern __shared__ float smem[];
  const Window w = carve_window(smem, C, d);
  const int blk = blockIdx.x, wrow = blockIdx.y;
  for (int c = threadIdx.x; c < C; c += blockDim.x) w.ids[c] = blk * C + c;
  __syncthreads();
  stage_rows(w, xg, C, d);
  __syncthreads();
  attend<false, true, kNone, kDense, true>(w, q, vg, em, out, blk, wrow, B, C,
                                           d, dv);
}

template <typename Kernel, typename... Args>
int launch(Kernel kern, int nb, int B, size_t smem, cudaStream_t stream,
           Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(nb, B / kRowsPerCta);
  kern<<<grid, kWarps * 32, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

template <bool SHARED, bool STABLE>
int launch_epi(int epilogue, const float* q, const float* x, const float* v,
               const int64_t* cand, const int32_t* mbits, float* out, int nb,
               int B, int C, int d, int dv, int n, size_t smem,
               cudaStream_t s) {
  switch (epilogue) {
    case kNone:
      return launch(fused_block_attention_kernel<SHARED, STABLE, kNone>, nb,
                    B, smem, s, q, x, v, cand, mbits, out, B, C, d, dv, n);
    case kL2Norm:
      return launch(fused_block_attention_kernel<SHARED, STABLE, kL2Norm>, nb,
                    B, smem, s, q, x, v, cand, mbits, out, B, C, d, dv, n);
    case kRelu:
      return launch(fused_block_attention_kernel<SHARED, STABLE, kRelu>, nb,
                    B, smem, s, q, x, v, cand, mbits, out, B, C, d, dv, n);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the CUDA error code (0 = launched). Above the
// card's shared memory, cudaFuncSetAttribute refuses and that error is
// returned. The caller has checked shapes, types, B % 32 == 0 and
// d, dv <= 128.
int fba_launch(const float* q, const float* x, const float* v,
               const int64_t* cand, const int32_t* mbits, float* out, int nb,
               int B, int C, int d, int dv, int n, int shared, int stable,
               int epilogue, void* stream) {
  if (B % kRowsPerCta != 0 || d < 1 || d > 32 * kMaxF || dv < 1 ||
      dv > 32 * kMaxF || (shared && dv != d))
    return (int)cudaErrorInvalidValue;
  const size_t smem = window_smem_bytes(C, d);
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

// The r3 kernel (kernel #5): xg [nb, C, d], vg [nb, C, dv], em [nb, B, C].
int fba_dense_launch(const float* q, const float* xg, const float* vg,
                     const float* em, float* out, int nb, int B, int C, int d,
                     int dv, void* stream) {
  if (B % kRowsPerCta != 0 || d < 1 || d > 32 * kMaxF || dv < 1 ||
      dv > 32 * kMaxF)
    return (int)cudaErrorInvalidValue;
  return launch(fused_block_attention_dense_kernel, nb, B,
                window_smem_bytes(C, d), static_cast<cudaStream_t>(stream),
                q, xg, vg, em, out, B, C, d, dv);
}

}  // extern "C"
