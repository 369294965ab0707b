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
// The packed kernels (#1, #2) compute, for each block b of B query rows and
// each row r:
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
// #1/#2 take float32 (fba_launch) or bfloat16 (fba_launch_bf16) q, x, v and
// give out in the same type; bf16 is read and rounded where the reference
// casts (block_attention.cuh), every sum in f32.
// Design (block_attention.cuh): grid (nb, B/16), a CTA of 16 rows of one
// block, a row a group of 8 lanes (d, dv <= 32) or 16. The CTA writes the
// C clipped ids and its rows' mask words into shared memory once, and each
// row its edge list; then each row reads its edges' x (and v) rows straight
// from L2, 8 float4 loads a lane in flight. Nothing of the window is
// staged: a row's 16 edges touch 16 of its C slots.
// What bounds them on an H100 SXM: at the slice shapes (nb=40, B=256,
// C=576, d=32, K=16 edges a row) the dense formulation is 4*B*C*d*nb = 0.755
// GFLOP, but the kernel visits only set mask bits: 4*E*d flops for E = n*K =
// 163,840 edges (21 MFLOP, 0.3 us), against about 4.8 MB of unique bytes
// (q 1.31 MB, table 1.31 MB, cand 92 KB, mbits 737 KB, out 1.31 MB), 1.4 us
// at 3.35 TB/s: bytes bound them. What a row waits for is a chain of L2
// reads (cand and the mask words, then 2 batches of 8 edges a pass), so the
// design keeps every row of the problem in flight at once: 22 KB of shared
// memory a CTA at C=576, and the slice's 640 CTAs (4.85 an SM) all resident.
// In bf16 at bench_roofline's chain shapes (nb=32, B=256, C=640, d=64,
// 131,072 edges) the unique bytes are 3.96 MB (q and the table 1.05 MB each,
// cand 164 KB, mbits 655 KB, out 1.05 MB), 1.2 us at 3.35 TB/s, against
// 34 MFLOP of f32 work: bytes again, and the same chain of L2 reads.
//
// The r3 kernel (#5) takes pre-gathered tables xg [nb, C, d], vg [nb, C, dv]
// and a dense f32 mask em [nb, B, C] whose slots with em > 0 are edges
// (so -0.0 is none and 0.5 or 2.0 are edges, as the reference reads them),
// and divides before the value product:
//   e[c] = exp(s[c] - max over the row's edges), out = sum_c (e[c] /
//   max(sum e, 1e-20)) vg[b,c,:]
// Rows with no edge give exactly 0. Exact f32 on CUDA cores, no TF32: its
// callers hold it to 1e-5 on unit-normal features at d=64, where scores
// reach |s| ~ 40 and TF32's rounding of s would move exp past that.
// What bounds it: at the chain's window (nb=32, B=256, C=544, d=64, dv=48,
// 131,072 edges) its inputs and output are 29.3 MB (the mask alone 17.8 MB,
// 61 %), 8.7 us at 3.35 TB/s, against 0.3 MFLOP a row: bytes. Design: one
// row a half-warp, 16 rows a CTA, no window staging (a block's xg and vg,
// 243 KB, stay in L2 across its 256 rows, and a CTA needs only
// 16*(C + C/32) words of shared memory, 35.9 KB at C=544; fewer warps a
// CTA where a very wide window would not fit). The row's 16 lanes read its
// f32 mask row once with 16-B loads, neighbouring lanes on neighbouring
// slots, 4 steps of 64 slots in flight, and each 8 lanes OR their 4 edge
// bits apiece into the row's words of 32 slots (17 at C=544), kept in
// shared memory. Every later pass walks those words: the scores (4 edges
// in flight, a 16-B load of xg a lane and edge at d <= 64, coalesced across
// the half-warp), then e, the denominator and e / den with lanes over
// slots, then the value sum over the same edges (4 vg rows in flight).

#include "block_attention.cuh"

using namespace rgl;

namespace {

template <class T, int L, int F4, bool SHARED, bool STABLE, int EPI>
__global__ void __launch_bounds__(kRowsPerCta * L, min_ctas(L, F4))
fused_block_attention_kernel(const T* __restrict__ q,          // [nb, B, d]
                             const T* __restrict__ x,          // [n, d]
                             const T* __restrict__ v,          // [n, dv]
                             const int64_t* __restrict__ cand, // [nb, C]
                             const int32_t* __restrict__ mbits,// [nb, B/32, C]
                             T* __restrict__ out,              // [nb, B, dv]
                             int B, int C, int d, int dv, int n) {
  const int64_t* cand_b = cand + (size_t)blockIdx.x * C;
  block_rows<L, F4, SHARED, STABLE, EPI>(
      [=](int c) { return cand_b[c]; }, q, x, v, mbits, out, B, C, d, dv, n);
}

// The r3 kernel: pre-gathered tables, dense f32 mask, divide first. Two
// rows a warp, one a half-warp of 16 lanes; each row's words and scores
// live in its half-warp's slice of dynamic shared memory (see the header).
constexpr int kHalf = 16;       // lanes of a row
constexpr int kEdgeBatch = 4;   // edges a row has in flight
constexpr int kMaskBatch = 4;   // 64-slot steps of the mask row in flight

// Walks the set bits of a row's mask words, kEdgeBatch at a time, across
// word boundaries. Every lane of the row's half-warp holds the same state.
struct EdgeWalk {
  const uint32_t* words;
  int nw, wi;
  uint32_t live;
  __device__ __forceinline__ EdgeWalk(const uint32_t* w, int n)
      : words(w), nw(n), wi(0), live(n > 0 ? w[0] : 0u) {}
  // The next edge's slot, or -1 when the row has no more.
  __device__ __forceinline__ int next() {
    while (live == 0u && ++wi < nw) live = words[wi];
    if (live == 0u) return -1;
    const int c = wi * 32 + __ffs(live) - 1;
    live &= live - 1;
    return c;
  }
};

template <int F4>  // float4s a lane: d, dv <= 64 F4
__global__ void __launch_bounds__(kWarps * 32)
dense_mask_attention_kernel(const float* __restrict__ q,   // [nb, B, d]
                            const float* __restrict__ xg,  // [nb, C, d]
                            const float* __restrict__ vg,  // [nb, C, dv]
                            const float* __restrict__ em,  // [nb, B, C]
                            float* __restrict__ out,       // [nb, B, dv]
                            int rows, int B, int C, int d, int dv, int nw) {
  extern __shared__ uint32_t dsm[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int l = lane & (kHalf - 1), hw = 2 * warp + (lane >> 4);
  uint32_t* words = dsm + (size_t)hw * nw;                      // [nw]
  float* sc = reinterpret_cast<float*>(dsm + (size_t)2 * warps * nw) +
              (size_t)hw * C;                                   // [C]
  const bool vm = C % 4 == 0 && aligned16(em);
  const bool vx = d % 4 == 0 && aligned16(xg) && aligned16(q);
  const bool vv = dv % 4 == 0 && aligned16(vg) && aligned16(out);
  for (int pair = blockIdx.x * warps + warp; 2 * pair < rows;
       pair += gridDim.x * warps) {
    const int row = 2 * pair + (lane >> 4);  // rows is even: B % 32 == 0
    const size_t blk = (size_t)(row / B);
    const float* m_r = em + (size_t)row * C;
    float4 qv[F4];
#pragma unroll
    for (int u = 0; u < F4; ++u)
      qv[u] = load4(q + (size_t)row * d, 4 * l + 64 * u, d, vx);

    // 1. the f32 mask row, read once: 4 slots a lane, 64 a step, with
    //    kMaskBatch steps' loads in flight; each 8 lanes OR their nibbles
    //    into the word of 32 slots they cover
    for (int cb = 0; cb < C; cb += 64 * kMaskBatch) {
      float4 m4[kMaskBatch];
#pragma unroll
      for (int k = 0; k < kMaskBatch; ++k)
        m4[k] = load4(m_r, cb + 64 * k + 4 * l, C, vm);
#pragma unroll
      for (int k = 0; k < kMaskBatch; ++k) {
        uint32_t word = ((uint32_t)(m4[k].x > 0.f) |
                         (uint32_t)(m4[k].y > 0.f) << 1 |
                         (uint32_t)(m4[k].z > 0.f) << 2 |
                         (uint32_t)(m4[k].w > 0.f) << 3)
                        << (4 * (l & 7));
        word |= __shfl_xor_sync(0xffffffffu, word, 1);
        word |= __shfl_xor_sync(0xffffffffu, word, 2);
        word |= __shfl_xor_sync(0xffffffffu, word, 4);
        const int wi = (cb + 64 * k) / 32 + (l >> 3);
        if ((l & 7) == 0 && wi < nw) words[wi] = word;
      }
    }
    __syncwarp();

    // 2. the edges' scores, kEdgeBatch rows of xg in flight, and their max;
    //    the warp runs until both of its rows are done (the sums shuffle
    //    across the whole warp)
    float m = -1e30f;
    EdgeWalk walk(words, nw);
    for (;;) {
      int cc[kEdgeBatch];
#pragma unroll
      for (int u = 0; u < kEdgeBatch; ++u) cc[u] = walk.next();
      if (!__any_sync(0xffffffffu, cc[0] >= 0)) break;
      float p[kEdgeBatch];
#pragma unroll
      for (int u = 0; u < kEdgeBatch; ++u) {
        p[u] = 0.f;
        if (cc[u] < 0) continue;
        const float* xr = xg + (blk * C + cc[u]) * d;
#pragma unroll
        for (int v = 0; v < F4; ++v) {
          const float4 x = load4(xr, 4 * l + 64 * v, d, vx);
          p[u] = fmaf(qv[v].x, x.x, p[u]);
          p[u] = fmaf(qv[v].y, x.y, p[u]);
          p[u] = fmaf(qv[v].z, x.z, p[u]);
          p[u] = fmaf(qv[v].w, x.w, p[u]);
        }
      }
#pragma unroll
      for (int o = kHalf / 2; o > 0; o >>= 1)
#pragma unroll
        for (int u = 0; u < kEdgeBatch; ++u)
          p[u] += __shfl_xor_sync(0xffffffffu, p[u], o);
#pragma unroll
      for (int u = 0; u < kEdgeBatch; ++u) {
        if (cc[u] < 0) continue;
        if (l == 0) sc[cc[u]] = p[u];
        m = fmaxf(m, p[u]);
      }
    }
    __syncwarp();

    // 3. e, the denominator and the weights e / den: the row's 16 lanes
    //    over each word's 32 slots
    float den = 0.f;
    for (int wi = 0; wi < nw; ++wi) {
      const uint32_t w = words[wi];
#pragma unroll
      for (int b = l; b < 32; b += kHalf) {
        if ((w >> b) & 1u) {
          const float e = expf(sc[wi * 32 + b] - m);
          sc[wi * 32 + b] = e;
          den += e;
        }
      }
    }
#pragma unroll
    for (int o = kHalf / 2; o > 0; o >>= 1)
      den += __shfl_xor_sync(0xffffffffu, den, o);
    den = fmaxf(den, 1e-20f);
    for (int wi = 0; wi < nw; ++wi) {
      const uint32_t w = words[wi];
#pragma unroll
      for (int b = l; b < 32; b += kHalf)
        if ((w >> b) & 1u) sc[wi * 32 + b] = sc[wi * 32 + b] / den;
    }
    __syncwarp();

    // 4. out = sum over edges of weight * vg row, kEdgeBatch rows in flight
    float4 acc[F4];
#pragma unroll
    for (int v = 0; v < F4; ++v) acc[v] = make_float4(0.f, 0.f, 0.f, 0.f);
    walk = EdgeWalk(words, nw);
    for (;;) {
      int cc[kEdgeBatch];
#pragma unroll
      for (int u = 0; u < kEdgeBatch; ++u) cc[u] = walk.next();
      if (cc[0] < 0) break;
#pragma unroll
      for (int u = 0; u < kEdgeBatch; ++u) {
        if (cc[u] < 0) continue;
        const float a = sc[cc[u]];
        const float* vr = vg + (blk * C + cc[u]) * dv;
#pragma unroll
        for (int v = 0; v < F4; ++v) {
          const float4 x = load4(vr, 4 * l + 64 * v, dv, vv);
          acc[v].x = fmaf(a, x.x, acc[v].x);
          acc[v].y = fmaf(a, x.y, acc[v].y);
          acc[v].z = fmaf(a, x.z, acc[v].z);
          acc[v].w = fmaf(a, x.w, acc[v].w);
        }
      }
    }
    float* o_r = out + (size_t)row * dv;
#pragma unroll
    for (int v = 0; v < F4; ++v) {
      const int f = 4 * l + 64 * v;
      if (vv) {
        if (f < dv) *reinterpret_cast<float4*>(o_r + f) = acc[v];
      } else {
        if (f < dv) o_r[f] = acc[v].x;
        if (f + 1 < dv) o_r[f + 1] = acc[v].y;
        if (f + 2 < dv) o_r[f + 2] = acc[v].z;
        if (f + 3 < dv) o_r[f + 3] = acc[v].w;
      }
    }
    __syncwarp();  // words and sc are rewritten for the warp's next rows
  }
}

// Dynamic shared memory a CTA of `warps` warps of the r3 kernel needs, in
// bytes: for each of its rows, the mask words and a score a slot.
inline size_t dense_smem_bytes(int C, int warps) {
  return sizeof(uint32_t) * 2 * (size_t)warps * (((size_t)C + 31) / 32 + C);
}

template <class T, bool SHARED, bool STABLE, int EPI>
int launch_shape(int L, int F4, const T* q, const T* x, const T* v,
                 const int64_t* cand, const int32_t* mbits, T* out, int nb,
                 int B, int C, int d, int dv, int n, size_t smem,
                 cudaStream_t s) {
  if (L == 8)
    return launch_rows(
        fused_block_attention_kernel<T, 8, 1, SHARED, STABLE, EPI>, L, nb, B,
        smem, s, q, x, v, cand, mbits, out, B, C, d, dv, n);
  if (F4 == 1)
    return launch_rows(
        fused_block_attention_kernel<T, 16, 1, SHARED, STABLE, EPI>, L, nb, B,
        smem, s, q, x, v, cand, mbits, out, B, C, d, dv, n);
  return launch_rows(
      fused_block_attention_kernel<T, 16, 2, SHARED, STABLE, EPI>, L, nb, B,
      smem, s, q, x, v, cand, mbits, out, B, C, d, dv, n);
}

template <class T, bool SHARED, bool STABLE>
int launch_epi(int epilogue, int L, int F4, const T* q, const T* x,
               const T* v, const int64_t* cand, const int32_t* mbits, T* out,
               int nb, int B, int C, int d, int dv, int n, size_t smem,
               cudaStream_t s) {
  switch (epilogue) {
    case kNone:
      return launch_shape<T, SHARED, STABLE, kNone>(
          L, F4, q, x, v, cand, mbits, out, nb, B, C, d, dv, n, smem, s);
    case kL2Norm:
      return launch_shape<T, SHARED, STABLE, kL2Norm>(
          L, F4, q, x, v, cand, mbits, out, nb, B, C, d, dv, n, smem, s);
    case kRelu:
      return launch_shape<T, SHARED, STABLE, kRelu>(
          L, F4, q, x, v, cand, mbits, out, nb, B, C, d, dv, n, smem, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// #1/#2 in element type T: a row takes 8 or 16 lanes by its width
// (block_attention.cuh::row_shape).
template <class T>
int fba_launch_t(const T* q, const T* x, const T* v, const int64_t* cand,
                 const int32_t* mbits, T* out, int nb, int B, int C, int d,
                 int dv, int n, int shared, int stable, int epilogue,
                 void* stream) {
  int L = 0, F4 = 0;
  if (B % 32 != 0 || C < 1 || d < 1 || dv < 1 || (shared && dv != d) ||
      !row_shape(d > dv ? d : dv, &L, &F4))
    return (int)cudaErrorInvalidValue;
  const size_t smem = cta_smem_bytes(C);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (shared) {
    return stable ? launch_epi<T, true, true>(epilogue, L, F4, q, x, x, cand,
                                              mbits, out, nb, B, C, d, dv, n,
                                              smem, s)
                  : launch_epi<T, true, false>(epilogue, L, F4, q, x, x, cand,
                                               mbits, out, nb, B, C, d, dv, n,
                                               smem, s);
  }
  return stable ? launch_epi<T, false, true>(epilogue, L, F4, q, x, v, cand,
                                             mbits, out, nb, B, C, d, dv, n,
                                             smem, s)
                : launch_epi<T, false, false>(epilogue, L, F4, q, x, v, cand,
                                              mbits, out, nb, B, C, d, dv, n,
                                              smem, s);
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the CUDA error code (0 = launched). Above the
// card's shared memory, cudaFuncSetAttribute refuses and that error is
// returned. A row takes 8 or 16 lanes by its width
// (block_attention.cuh::row_shape). The caller has checked shapes, types,
// B % 32 == 0 and d, dv <= 128.
int fba_launch(const float* q, const float* x, const float* v,
               const int64_t* cand, const int32_t* mbits, float* out, int nb,
               int B, int C, int d, int dv, int n, int shared, int stable,
               int epilogue, void* stream) {
  return fba_launch_t(q, x, v, cand, mbits, out, nb, B, C, d, dv, n, shared,
                      stable, epilogue, stream);
}

// The same in bfloat16: q, x, v and out __nv_bfloat16.
int fba_launch_bf16(const __nv_bfloat16* q, const __nv_bfloat16* x,
                    const __nv_bfloat16* v, const int64_t* cand,
                    const int32_t* mbits, __nv_bfloat16* out, int nb, int B,
                    int C, int d, int dv, int n, int shared, int stable,
                    int epilogue, void* stream) {
  return fba_launch_t(q, x, v, cand, mbits, out, nb, B, C, d, dv, n, shared,
                      stable, epilogue, stream);
}

// The r3 kernel (kernel #5): xg [nb, C, d], vg [nb, C, dv], em [nb, B, C].
// Two rows a warp, up to kWarps warps a CTA. A window whose mask words and
// scores for one warp's rows exceed the card's shared memory (C above about
// 28,000 on an H100) is refused with cudaErrorInvalidValue.
int fba_dense_launch(const float* q, const float* xg, const float* vg,
                     const float* em, float* out, int nb, int B, int C, int d,
                     int dv, void* stream) {
  if (B % 32 != 0 || C < 1 || d < 1 || d > 32 * kMaxF || dv < 1 ||
      dv > 32 * kMaxF)
    return (int)cudaErrorInvalidValue;
  // 8 warps a CTA where their rows' words and scores fit, else fewer. The
  // card's opt-in limit is read at the first launch (one card a process).
  static int optin = 0;
  if (optin == 0) {
    int dev = 0, got = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &got, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return (int)err;
    optin = got;
  }
  const size_t max_smem = (size_t)optin;
  int warps = kWarps;
  while (warps > 1 && dense_smem_bytes(C, warps) > max_smem) warps /= 2;
  const size_t smem = dense_smem_bytes(C, warps);
  if (smem > max_smem) return (int)cudaErrorInvalidValue;
  auto kern = (d > dv ? d : dv) <= 64 ? dense_mask_attention_kernel<1>
                                      : dense_mask_attention_kernel<2>;
  const cudaError_t err =
      reserve_smem(reinterpret_cast<const void*>(kern), smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = nb * B, pairs = rows / 2;
  kern<<<(pairs + warps - 1) / warps, warps * 32, smem,
         static_cast<cudaStream_t>(stream)>>>(q, xg, vg, em, out, rows, B, C,
                                               d, dv, (C + 31) / 32);
  return (int)cudaGetLastError();
}

}  // extern "C"
