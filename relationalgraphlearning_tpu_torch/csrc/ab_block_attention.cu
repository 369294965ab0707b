// The A/B harness's block attention (kernel #6) for Hopper (sm_90a), plain C
// interface.
//
// Replaces the Pallas TPU kernel of tools/ab_kernel.py::make_kernel
// (pallas_call at :73, body :36-88). For each block b of B query rows, its
// pre-gathered window xg[b] of C rows (keys == values) and its bitpacked edge
// mask (row w*32+j of block b is bit j of word mbits[b, w, c]), each row r:
//   s[c]  = q[b,r,:] . xg[b,c,:]          dense over all C slots, f32 sums
//   e[c]  = exp(s[c]) masked               unshifted; INTMASK: the bit is
//           sign-smeared to 0/-1 and ANDed into exp's bits, else a select
//   den   = max(sum_c e[c], 1e-20)
//   out   = DIV_AFTER ? (sum_c T(e[c]) xg[b,c,:]) / den
//                     : sum_c T(e[c] / den) xg[b,c,:]
//   then row / max(||row||, 1e-6), stored as T.
// T is float or __nv_bfloat16: bf16 is loaded, widened to f32 for every
// product and sum, rounded (RNE) to bf16 where the reference casts to
// x.dtype (the weights before the value product) and at the store. Rows with
// no edge give exactly 0. All arithmetic is f32 on CUDA cores (no TF32).
//
// Design (a simple first kernel): grid (nb, B/32), 256 threads = 8 warps. A
// CTA owns 32 rows of one block (one mask word row) and stages its block's
// whole window into shared memory at an odd word stride (so that 32 lanes
// reading 32 rows hit 32 banks), its 32 query rows widened to f32, and its C
// mask words. Each warp owns 4 rows. Pass 1 is dense, as the TPU kernel is:
// lanes run over slots, each lane scoring 4 rows x 4 slots per step of the
// feature loop, and every slot's exp is masked after it is computed (the
// mask forms differ only there, which is what the A/B compares). The e of
// all 32 rows stay in shared memory. Pass 2 turns them into the weights T(e)
// or T(e / den), and lanes run over features, each lane accumulating 4 rows
// x 4 features per slot.
//
// What bounds it on an H100 SXM: at the harness's shapes (nb=32, B=256,
// C=544, d=64, 131,072 edges) the function needs q 2.10 MB + window 4.46 MB
// + mask 0.56 MB + out 2.10 MB = 9.21 MB in f32 (2.75 us at 3.35 TB/s; bf16
// 4.89 MB, 1.46 us) and 4*E*d flops over its edges (0.5 us at 67 TFLOP/s):
// bytes bound the function. The dense form does 4*nb*B*C*d = 1.14 GFLOP by
// design, 17 us at the f32 CUDA-core peak. As written the kernel is held
// back further by shared memory: one shared load for every two FMAs in
// pass 1 and about as many in pass 2, with one CTA an SM (221 KB at C=544,
// d=64 in f32) leaving 8 warps to hide their latency, and each of a
// block's 8 CTAs re-reads the window. A tensor-core product (bf16 mma) or
// visiting set bits only, as #1 does, is the redesign's work.

#include <cuda_bf16.h>

#include "common.cuh"

using namespace rgl;

namespace {

constexpr int kRows = 32;                    // rows of a CTA: one word row
constexpr int kRowsPerWarp = kRows / kWarps; // 4
constexpr int kSlotTile = 4;                 // slot groups of 32 a lane scores

template <typename T> struct Elem;
template <> struct Elem<float> {
  static __device__ __forceinline__ float load(float v) { return v; }
  static __device__ __forceinline__ float round(float v) { return v; }
  static __device__ __forceinline__ float store(float v) { return v; }
  // window row stride in elements: odd in 32-bit words
  static int stride(int d) { return d | 1; }
};
template <> struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float load(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  static __device__ __forceinline__ __nv_bfloat16 store(float v) {
    return __float2bfloat16_rn(v);
  }
  static int stride(int d) { return 2 * (((d + 1) / 2) | 1); }
};

template <typename T>
size_t smem_bytes(int C, int d) {
  const size_t window = (size_t)C * Elem<T>::stride(d) * sizeof(T);
  return (window + 15) / 16 * 16 +
         sizeof(float) * ((size_t)kRows * d + (size_t)kRows * C + C);
}

template <typename T, bool DIV_AFTER, bool INTMASK>
__global__ void __launch_bounds__(kWarps * 32)
ab_block_attention_kernel(const T* __restrict__ q,          // [nb, B, d]
                          const T* __restrict__ xg,         // [nb, C, d]
                          const int32_t* __restrict__ mbits,// [nb, B/32, C]
                          T* __restrict__ out,              // [nb, B, d]
                          int B, int C, int d, int sx) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);                       // [C, sx]
  float* qs = reinterpret_cast<float*>(
      smem + ((size_t)C * sx * sizeof(T) + 15) / 16 * 16);  // [32, d]
  float* ws = qs + kRows * d;                               // [32, C]
  uint32_t* ms = reinterpret_cast<uint32_t*>(ws + kRows * C);  // [C]

  const int blk = blockIdx.x, wrow = blockIdx.y;
  const T* x_b = xg + (size_t)blk * C * d;
  const size_t row0 = (size_t)blk * B + (size_t)wrow * kRows;
  const T* q_b = q + row0 * d;
  const int32_t* m_b = mbits + ((size_t)blk * (B / 32) + wrow) * C;
  for (int i = threadIdx.x; i < C * d; i += blockDim.x) {
    const int c = i / d, k = i - c * d;
    xs[(size_t)c * sx + k] = x_b[i];
  }
  for (int i = threadIdx.x; i < kRows * d; i += blockDim.x)
    qs[i] = Elem<T>::load(q_b[i]);
  for (int c = threadIdx.x; c < C; c += blockDim.x) ms[c] = (uint32_t)m_b[c];
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * kRowsPerWarp;  // the warp's rows r0..r0+3 of 32
  float* ws_w = ws + (size_t)r0 * C;

  // pass 1: every slot's score for the warp's 4 rows; masked e into ws
  float sum[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) sum[i] = 0.f;
  for (int c0 = 0; c0 < C; c0 += 32 * kSlotTile) {
    const T* xr[kSlotTile];
#pragma unroll
    for (int j = 0; j < kSlotTile; ++j) {
      const int c = min(c0 + 32 * j + lane, C - 1);  // past C: discarded
      xr[j] = xs + (size_t)c * sx;
    }
    float s[kRowsPerWarp][kSlotTile];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
      for (int j = 0; j < kSlotTile; ++j) s[i][j] = 0.f;
    for (int k = 0; k < d; ++k) {
      float xv[kSlotTile];
#pragma unroll
      for (int j = 0; j < kSlotTile; ++j) xv[j] = Elem<T>::load(xr[j][k]);
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float qv = qs[(r0 + i) * d + k];  // a broadcast
#pragma unroll
        for (int j = 0; j < kSlotTile; ++j) s[i][j] = fmaf(qv, xv[j], s[i][j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kSlotTile; ++j) {
      const int c = c0 + 32 * j + lane;
      if (c >= C) continue;
      const uint32_t word = ms[c];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const uint32_t bit = (word >> (r0 + i)) & 1u;
        const float ex = expf(s[i][j]);
        const float e = INTMASK ? __int_as_float(__float_as_int(ex) &
                                                 -(int)bit)
                                : (bit ? ex : 0.f);
        ws_w[(size_t)i * C + c] = e;
        sum[i] += e;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i)
    sum[i] = fmaxf(warp_sum(sum[i]), 1e-20f);

  // the weights the value product takes, each lane over the slots it wrote
  for (int c = lane; c < C; c += 32) {
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      float* w = ws_w + (size_t)i * C + c;
      *w = Elem<T>::round(DIV_AFTER ? *w : *w / sum[i]);
    }
  }
  __syncwarp();

  // pass 2: lanes over features, 4 rows x kMaxF features a lane
  float acc[kRowsPerWarp][kMaxF];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
    for (int t = 0; t < kMaxF; ++t) acc[i][t] = 0.f;
  for (int c = 0; c < C; ++c) {
    const T* xr = xs + (size_t)c * sx;
    float xv[kMaxF];
#pragma unroll
    for (int t = 0; t < kMaxF; ++t) {
      const int f = lane + 32 * t;
      xv[t] = f < d ? Elem<T>::load(xr[f]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const float w = ws_w[(size_t)i * C + c];  // a broadcast
#pragma unroll
      for (int t = 0; t < kMaxF; ++t) acc[i][t] = fmaf(w, xv[t], acc[i][t]);
    }
  }

  // the divide (DIV_AFTER), the l2norm epilogue and the store
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    if (DIV_AFTER) {
#pragma unroll
      for (int t = 0; t < kMaxF; ++t) acc[i][t] = acc[i][t] / sum[i];
    }
    epilogue<kL2Norm>(acc[i], lane, d);
    T* o_r = out + (row0 + r0 + i) * d;
#pragma unroll
    for (int t = 0; t < kMaxF; ++t) {
      const int f = lane + 32 * t;
      if (f < d) o_r[f] = Elem<T>::store(acc[i][t]);
    }
  }
}

template <typename T, bool DIV_AFTER, bool INTMASK>
int launch(const void* q, const void* xg, const int32_t* mbits, void* out,
           int nb, int B, int C, int d, cudaStream_t stream) {
  auto kern = ab_block_attention_kernel<T, DIV_AFTER, INTMASK>;
  const size_t smem = smem_bytes<T>(C, d);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(nb, B / kRows);
  kern<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(xg), mbits,
      static_cast<T*>(out), B, C, d, Elem<T>::stride(d));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_flags(int div_after, int intmask, const void* q, const void* xg,
                 const int32_t* mbits, void* out, int nb, int B, int C, int d,
                 cudaStream_t s) {
  if (div_after)
    return intmask ? launch<T, true, true>(q, xg, mbits, out, nb, B, C, d, s)
                   : launch<T, true, false>(q, xg, mbits, out, nb, B, C, d, s);
  return intmask ? launch<T, false, true>(q, xg, mbits, out, nb, B, C, d, s)
                 : launch<T, false, false>(q, xg, mbits, out, nb, B, C, d, s);
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the CUDA error code (0 = launched). bf16 = 0
// takes float tensors, 1 __nv_bfloat16. Above the card's shared memory,
// cudaFuncSetAttribute refuses and that error is returned. The caller has
// checked shapes, types, B % 32 == 0 and d <= 128.
int aba_launch(const void* q, const void* xg, const int32_t* mbits, void* out,
               int nb, int B, int C, int d, int bf16, int div_after,
               int intmask, void* stream) {
  if (B % kRows != 0 || d < 1 || d > 32 * kMaxF || C < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_flags<__nv_bfloat16>(div_after, intmask, q, xg, mbits,
                                            out, nb, B, C, d, s)
              : launch_flags<float>(div_after, intmask, q, xg, mbits, out, nb,
                                    B, C, d, s);
}

}  // extern "C"
