// The edge-following body of the windowed block kernels:
// fused_block_attention.cu (#1, #2) and chunk_block_attention.cu (#4, #7),
// which differ only in how a CTA learns the table row of each window slot
// (`id_of`). The 16-B loads (load4, aligned16) serve the r3 kernel (#5 in
// fused_block_attention.cu) too.
//
// A CTA owns kRowsPerCta = 16 query rows of one block of B rows (half of one
// mask word row) over the block's window of C slots. A row is a group of L
// lanes (8 at row widths up to 32 floats, else 16); lane l holds F4 float4s
// of the row, features 4*l + 4*L*u .. +3 for u < F4. The CTA
//   1. loads its rows of q into registers, in flight while it
//   2. writes the clipped table row of every slot into ids[C] (sentinel ids
//      read row n-1; their mask bits are never set), and
//   3. reads its mask word row mbits[b, w, :] once, 32 words a warp load,
//      and ballots its 16 bits of those words into each row's own words
//      (nw = ceil(C/32); bit j of word i is slot 32 i + j);
//   4. each row turns its words into its edge list, its slots in ascending
//      order (a word a lane, a scan of the bit counts over the row's lanes).
// Then each row reads its edges' key (and value) rows straight from the
// table, kRowLoads float4 loads a lane in flight (8 edges at F4=1, 4 at
// F4=2). Nothing of the window is staged: the whole table (1.3-2.1 MB at
// the main paths' shapes) stays in the card's 50 MB L2, and a row's 16
// edges touch 16 of its C slots. The list is built once, so that every pass
// reads its slots in step across the rows of a warp.
//   STABLE: a first pass takes the row's max score m; the second forms each
//           score again, bit for bit, and e = exp(s - m), sum e and sum e*v
//           (two passes with the true max, no rescaling; recomputing the
//           score keeps a CTA's shared memory at the lists, 22 KB at C=576).
//   else:   one pass, e = exp(s) unshifted as each score lands.
// out = (sum e*v) / max(sum e, 1e-20), then the epilogue over the row's
// lanes. Masked slots are never visited, so they add exactly 0 to every sum,
// as the reference's masked exp does; rows with no edge give exactly 0. All
// arithmetic is f32 on the CUDA cores (no TF32).
// The element type T of q, the tables and out is float or __nv_bfloat16
// (#1/#2 only). In bf16 the body computes what pallas_block.py's kernel
// computes on bf16 inputs: each element widened to f32 as it is read (exact),
// the scores and e in f32, the denominator the sum of the f32 e, the value
// sum over bf16(e) * v (e rounded to nearest even, as `e.astype(v.dtype)`
// does, :153-154) in f32, the divide and the epilogue in f32, and the output
// rounded to nearest even (`o_ref.dtype`, :206, :250). A bf16 row of d=64 is
// 128 B: a lane reads its 4 features as one 8-B load.
#pragma once

#include <cuda_bf16.h>

#include "common.cuh"

namespace rgl {

constexpr int kRowsPerCta = 16;  // query rows of a CTA: half a mask word row
constexpr int kRowLoads = 8;     // float4 loads of edge rows in flight a lane
constexpr int kWordLoads = 4;    // 32-word mask loads in flight a warp

// r[f..f+3], zero past n: one 16-B load where the row allows it.
__device__ __forceinline__ float4 load4(const float* r, int f, int n,
                                        bool vec) {
  if (vec)
    return f < n ? __ldg(reinterpret_cast<const float4*>(r + f))
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  return make_float4(f < n ? __ldg(r + f) : 0.f,
                     f + 1 < n ? __ldg(r + f + 1) : 0.f,
                     f + 2 < n ? __ldg(r + f + 2) : 0.f,
                     f + 3 < n ? __ldg(r + f + 3) : 0.f);
}

// The same four features of a bf16 row, widened to f32 (a bf16 is the top
// half of the f32 with the same value, so the shift is exact: what
// __bfloat162float gives); one 8-B load where the row allows it.
__device__ __forceinline__ float4 load4(const __nv_bfloat16* r, int f, int n,
                                        bool vec) {
  if (vec) {
    if (f >= n) return make_float4(0.f, 0.f, 0.f, 0.f);
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(r + f));
    return make_float4(__uint_as_float(u.x << 16),
                       __uint_as_float(u.x & 0xffff0000u),
                       __uint_as_float(u.y << 16),
                       __uint_as_float(u.y & 0xffff0000u));
  }
  return make_float4(f < n ? __bfloat162float(r[f]) : 0.f,
                     f + 1 < n ? __bfloat162float(r[f + 1]) : 0.f,
                     f + 2 < n ? __bfloat162float(r[f + 2]) : 0.f,
                     f + 3 < n ? __bfloat162float(r[f + 3]) : 0.f);
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0u;
}

// Whether four elements of T at p make one vector load or store: 16 B for
// float, 8 B for bf16.
template <class T>
__device__ __forceinline__ bool aligned4x(const T* p) {
  return (reinterpret_cast<uintptr_t>(p) & (4 * sizeof(T) - 1)) == 0u;
}

// o[f..f+3] = a, rounded to T (bf16: to nearest even), nothing past n.
__device__ __forceinline__ void store4(float* o, int f, int n, bool vec,
                                       float4 a) {
  if (vec) {
    if (f < n) *reinterpret_cast<float4*>(o + f) = a;
  } else {
    if (f < n) o[f] = a.x;
    if (f + 1 < n) o[f + 1] = a.y;
    if (f + 2 < n) o[f + 2] = a.z;
    if (f + 3 < n) o[f + 3] = a.w;
  }
}

__device__ __forceinline__ void store4(__nv_bfloat16* o, int f, int n,
                                       bool vec, float4 a) {
  if (vec) {
    if (f < n) {
      __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(o + f);
      o2[0] = __floats2bfloat162_rn(a.x, a.y);
      o2[1] = __floats2bfloat162_rn(a.z, a.w);
    }
  } else {
    if (f < n) o[f] = __float2bfloat16_rn(a.x);
    if (f + 1 < n) o[f + 1] = __float2bfloat16_rn(a.y);
    if (f + 2 < n) o[f + 2] = __float2bfloat16_rn(a.z);
    if (f + 3 < n) o[f + 3] = __float2bfloat16_rn(a.w);
  }
}

// e as the value product sees it: itself in f32; in bf16 rounded to nearest
// even and widened again.
template <class T>
__device__ __forceinline__ float in_value_type(float e) {
  if constexpr (sizeof(T) == 2) return __bfloat162float(__float2bfloat16_rn(e));
  return e;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float p) {
  p = fmaf(a.x, b.x, p);
  p = fmaf(a.y, b.y, p);
  p = fmaf(a.z, b.z, p);
  return fmaf(a.w, b.w, p);
}

__device__ __forceinline__ void axpy4(float a, float4 x, float4& y) {
  y.x = fmaf(a, x.x, y.x);
  y.y = fmaf(a, x.y, y.y);
  y.z = fmaf(a, x.z, y.z);
  y.w = fmaf(a, x.w, y.w);
}

// Entries of a row's edge list in shared memory: C slots, padded to an odd
// number of 4-byte words, so that the rows of a warp read distinct banks.
inline __host__ __device__ int list_stride(int C) {
  return (C + 3) / 4 * 4 + 2;
}

// Dynamic shared memory of a CTA, in bytes: the slots' table rows, its
// rows' mask words and each row's edge list (a row may have every slot as
// an edge). ops/fused_block.py::cta_smem_bytes is the same reckoning.
inline size_t cta_smem_bytes(int C) {
  const size_t nw = ((size_t)C + 31) / 32;
  return sizeof(int) * (size_t)C + sizeof(uint32_t) * kRowsPerCta * nw +
         sizeof(uint16_t) * kRowsPerCta * (size_t)list_stride(C);
}

// CTAs an SM that a kernel of L lanes a row, F4 float4s a lane, is compiled
// for: at 16 lanes and one float4, 4 (64 registers a thread), so that the
// chain's 8,192 rows are resident at once (nvcc spills 8-64 B a thread
// there); at 8 lanes the registers do not bound it, and at two float4s the
// same cap would spill up to 440 B a thread.
constexpr int min_ctas(int L, int F4) { return L == 16 && F4 == 1 ? 4 : 1; }

// The row shape for rows of up to w floats (w = max(d, dv) <= 128): L = 8
// lanes at w <= 32, else 16, with F4 = 1 float4 a lane up to 64 floats and
// 2 up to 128. Returns false for a width outside 1..128.
inline bool row_shape(int w, int* L, int* F4) {
  if (w < 1 || w > 128) return false;
  *L = w <= 32 ? 8 : 16;
  *F4 = (w + 4 * *L - 1) / (4 * *L);
  return true;
}

// The rows of table t [*, w] at the slots cc (-1: none, zeros), F4 float4s
// a lane.
template <int L, int F4, int N, class T>
__device__ __forceinline__ void edge_rows(const int (&cc)[N], const int* ids,
                                          const T* __restrict__ t, int w,
                                          bool vec, int l,
                                          float4 (&r)[N][F4]) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const T* row = t + (size_t)(cc[k] < 0 ? 0 : ids[cc[k]]) * w;
#pragma unroll
    for (int u = 0; u < F4; ++u)
      r[k][u] = cc[k] < 0 ? make_float4(0.f, 0.f, 0.f, 0.f)
                          : load4(row, 4 * l + 4 * L * u, w, vec);
  }
}

// The key rows of a batch of edges and their scores against q, summed over
// the row's L lanes (a butterfly: every lane ends with the same sum, and
// every lane of the warp must take part).
template <int L, int F4, int N, class T>
__device__ __forceinline__ void edge_scores(const int (&cc)[N], const int* ids,
                                            const T* __restrict__ x, int d,
                                            bool vx, int l,
                                            const float4 (&qv)[F4],
                                            float4 (&xr)[N][F4],
                                            float (&p)[N]) {
  edge_rows<L, F4, N>(cc, ids, x, d, vx, l, xr);
#pragma unroll
  for (int k = 0; k < N; ++k) {
    p[k] = 0.f;
#pragma unroll
    for (int u = 0; u < F4; ++u) p[k] = dot4(qv[u], xr[k][u], p[k]);
  }
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1)
#pragma unroll
    for (int k = 0; k < N; ++k) p[k] += __shfl_xor_sync(0xffffffffu, p[k], o);
}

// The CTA's 16 rows of block blockIdx.x, rows blockIdx.y * 16 .. + 15, over
// C slots whose table rows id_of(c) gives (before clipping to [0, n-1]).
// Values are x when SHARED, else v [n, dv]. T is float or __nv_bfloat16.
// Launched with kRowsPerCta * L threads and cta_smem_bytes(C) of dynamic
// shared memory.
template <int L, int F4, bool SHARED, bool STABLE, int EPI, class IdOf,
          class T>
__device__ __forceinline__ void block_rows(
    IdOf id_of, const T* __restrict__ q, const T* __restrict__ x,
    const T* __restrict__ v, const int32_t* __restrict__ mbits,
    T* __restrict__ out, int B, int C, int d, int dv, int n) {
  constexpr int kThreads = kRowsPerCta * L, kWarpsHere = kThreads / 32;
  constexpr int kBatch = kRowLoads / F4;  // edges a row has in flight
  extern __shared__ int cta_smem[];
  const int tid = threadIdx.x, g = tid / L, l = tid % L;
  const int warp = tid >> 5, lane = tid & 31;
  const int blk = blockIdx.x, r0 = blockIdx.y * kRowsPerCta;
  const size_t row = (size_t)blk * B + r0 + g;
  const int nw = (C + 31) / 32, ls = list_stride(C);
  int* ids = cta_smem;                                           // [C]
  uint32_t* words = reinterpret_cast<uint32_t*>(ids + C);        // [16, nw]
  uint16_t* lst = reinterpret_cast<uint16_t*>(words + kRowsPerCta * nw) +
                  (size_t)g * ls;                                // [C]
  const bool vx = d % 4 == 0 && aligned4x(x) && aligned4x(q);
  const bool vv = dv % 4 == 0 && aligned4x(v);
  const bool vo = dv % 4 == 0 && aligned4x(out);

  // 1. the row's query
  float4 qv[F4];
#pragma unroll
  for (int u = 0; u < F4; ++u)
    qv[u] = load4(q + row * d, 4 * l + 4 * L * u, d, vx);

  // 2. each slot's table row, clipped
#pragma unroll 4
  for (int c = tid; c < C; c += kThreads) {
    const int64_t id = id_of(c);
    ids[c] = (int)(id < 0 ? 0 : (id > n - 1 ? n - 1 : id));
  }

  // 3. the CTA's mask word row, read once; ballot r of a 32-word load is
  //    row r's word of those 32 slots
  const int32_t* m_r = mbits + ((size_t)blk * (B / 32) + r0 / 32) * C;
  const int bit0 = r0 % 32;
  for (int w0 = warp; w0 < nw; w0 += kWordLoads * kWarpsHere) {
    uint32_t mw[kWordLoads];
#pragma unroll
    for (int k = 0; k < kWordLoads; ++k) {
      const int c = (w0 + k * kWarpsHere) * 32 + lane;
      mw[k] = c < C ? (uint32_t)__ldg(m_r + c) : 0u;
    }
#pragma unroll
    for (int k = 0; k < kWordLoads; ++k) {
      const int wi = w0 + k * kWarpsHere;  // warp-uniform
      if (wi >= nw) break;
      uint32_t mine = 0u;
#pragma unroll
      for (int r = 0; r < kRowsPerCta; ++r) {
        const uint32_t b =
            __ballot_sync(0xffffffffu, (mw[k] >> (bit0 + r)) & 1u);
        if (lane == r) mine = b;
      }
      if (lane < kRowsPerCta) words[lane * nw + wi] = mine;
    }
  }
  __syncthreads();

  // 4. the row's edge list, its slots in ascending order: each lane of the
  //    row takes a word, and a scan of their bit counts places its slots
  const uint32_t* my_words = words + g * nw;
  int ne = 0;
  for (int w0 = 0; w0 < nw; w0 += L) {  // uniform across the warp
    const int wi = w0 + l;
    uint32_t w = wi < nw ? my_words[wi] : 0u;
    const int cnt = __popc(w);
    int incl = cnt;
#pragma unroll
    for (int o = 1; o < L; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, incl, o, L);
      if (l >= o) incl += t;
    }
    for (int pos = ne + incl - cnt; w != 0u; w &= w - 1)
      lst[pos++] = (uint16_t)(wi * 32 + __ffs(w) - 1);
    ne += __shfl_sync(0xffffffffu, incl, L - 1, L);
  }
  __syncwarp();

  // 5. the edges, kBatch at a time; the warp loops until all of its rows are
  //    done. STABLE: a first pass takes the row's max score m, and the
  //    second forms each score again as the first did, bit for bit.
  float m = 0.f;
  if (STABLE) {
    m = -1e30f;
    for (int k0 = 0; __any_sync(0xffffffffu, k0 < ne); k0 += kBatch) {
      int cc[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) cc[k] = k0 + k < ne ? lst[k0 + k] : -1;
      float4 xr[kBatch][F4];
      float p[kBatch];
      edge_scores<L, F4, kBatch>(cc, ids, x, d, vx, l, qv, xr, p);
#pragma unroll
      for (int k = 0; k < kBatch; ++k)
        if (cc[k] >= 0) m = fmaxf(m, p[k]);
    }
  }
  float4 acc[F4];
#pragma unroll
  for (int u = 0; u < F4; ++u) acc[u] = make_float4(0.f, 0.f, 0.f, 0.f);
  float den = 0.f;
  for (int k0 = 0; __any_sync(0xffffffffu, k0 < ne); k0 += kBatch) {
    int cc[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) cc[k] = k0 + k < ne ? lst[k0 + k] : -1;
    float4 xr[kBatch][F4], vr[kBatch][F4];
    float p[kBatch];
    edge_scores<L, F4, kBatch>(cc, ids, x, d, vx, l, qv, xr, p);
    if (!SHARED) edge_rows<L, F4, kBatch>(cc, ids, v, dv, vv, l, vr);
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (cc[k] < 0) continue;
      const float e = STABLE ? expf(p[k] - m) : expf(p[k]);
      den += e;
      const float ev = in_value_type<T>(e);
#pragma unroll
      for (int u = 0; u < F4; ++u)
        axpy4(ev, SHARED ? xr[k][u] : vr[k][u], acc[u]);
    }
  }

  den = fmaxf(den, 1e-20f);
#pragma unroll
  for (int u = 0; u < F4; ++u) {
    acc[u].x = acc[u].x / den;
    acc[u].y = acc[u].y / den;
    acc[u].z = acc[u].z / den;
    acc[u].w = acc[u].w / den;
  }
  row_epilogue<EPI, L, F4>(acc);
  T* o_r = out + row * dv;
#pragma unroll
  for (int u = 0; u < F4; ++u) store4(o_r, 4 * l + 4 * L * u, dv, vo, acc[u]);
}

// Launch `kern` (a kernel calling block_rows with L lanes a row) over nb
// blocks of B rows on `stream`; returns the CUDA error code (0 = launched).
// Above the card's shared memory, reserve_smem's cudaFuncSetAttribute
// refuses and that error is returned.
template <typename Kernel, typename... Args>
int launch_rows(Kernel kern, int L, int nb, int B, size_t smem,
                cudaStream_t stream, Args... args) {
  const cudaError_t err =
      reserve_smem(reinterpret_cast<const void*>(kern), smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(nb, B / kRowsPerCta);
  kern<<<grid, kRowsPerCta * L, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace rgl
