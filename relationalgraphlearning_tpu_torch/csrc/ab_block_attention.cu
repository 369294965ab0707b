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
// T is float or __nv_bfloat16; T(.) rounds to T with round-to-nearest-even
// where the reference casts to x.dtype. Rows with no edge give exactly 0
// (exp's overflow to inf is masked to +0.0 too).
//
// What bounds it on an H100 SXM: at the harness's shapes (nb=32, B=256,
// C=544, d=64, 131,072 edges) the function needs q 2.10 MB + window 4.46 MB
// + mask 0.56 MB + out 2.10 MB = 9.21 MB in f32 (2.75 us at 3.35 TB/s; bf16
// 4.89 MB, 1.46 us): bytes bound the function. The dense form the kernel
// keeps, so that the two mask forms stay two code paths, is 4*nb*B*C*d =
// 1.14 GFLOP (1.71 with the divide before: see below): 17 us at the f32
// CUDA-core peak, which is what the first kernel of this source spent its
// time on, from shared memory, at one CTA an SM. Here that product runs on
// the tensor cores: 1.2 us of bf16 work at 989 TFLOP/s, and in f32 three
// TF32 products (3xTF32), 7 us at 495 TFLOP/s.
//
// Design: a CTA takes 64 query rows of one block as 4 row warps of 16 rows,
// and splits the window's slots between 2 slot groups: 8 warps, nb*B/64 =
// 128 CTAs at the harness's shapes, one wave. Each warp keeps its rows' Q
// fragments in registers for the whole window (as TF32 hi and lo parts in
// shared memory for f32 at d > 64, where registers run short). The window
// streams through a ring of 3 shared-memory stages (2 for f32 at d > 64,
// where 3 do not fit) of 64 slots a slot group each (32 KB in f32, 16 KB in
// bf16 at d=64) by cp.async, with the
// CTA's mask words of the same slots; the last stage is ragged and
// zero-filled, so no C is too wide for shared memory. A slot row holds d
// elements padded with zeros to DP = 64 or 128, its 32-bit word w at
// w ^ ((s & 7) << 2) for slot s, which makes both products' fragment loads
// free of bank conflicts. For its 64 slots of each stage, each warp computes
//   S = Q X^T  with mma.sync (bf16 m16n8k16, f32 accumulators; or 3xTF32
//              m16n8k8: x = hi + lo rounded by cvt.rna.tf32.f32, and
//              hi*hi + hi*lo + lo*hi summed in f32),
// masks and exps S on its accumulator fragment (each lane takes its rows'
// bits from the slot's mask word), adds e to its rows' denominators, and
//   O += P X   with the accumulator fragment of S reused as the A fragment
//              of P (bf16: pairs packed with RNE; tf32: the product's k
//              order permuted so that a lane's two slots are its two k
//              values, which sums the same terms); X enters through
//              ldmatrix.trans (bf16) or direct loads (tf32).
// The slot groups' partial O and denominators meet in shared memory at the
// end. In f32 the three TF32 products and the per-warp splits of X into hi
// and lo make the tensor-core issue the limit (the bf16 kernel takes less
// than half the time); a pre-split of each stage shared by the CTA's warps,
// 16-warp CTAs, one slot group, and CTAs of 32 rows were all measured
// slower.
// The exp is unshifted, so no running-max rescale is needed. With the
// divide before the value product, a first sweep over the window computes
// only S, e and the denominators (the slot groups' parts meet in shared
// memory); a second computes S again and feeds T(e / den) to the value
// product (1.5x the dense work, and no e kept).
// Then the divide after (DIV_AFTER), the l2norm across the four lanes that
// share a row, and the store.

#include <cuda_bf16.h>

#include "common.cuh"

using namespace rgl;

namespace {

constexpr int kSlotTile = 64;    // window slots a warp takes from a stage
constexpr int kNTiles = kSlotTile / 8;
constexpr int kWarpRows = 16;    // query rows of a warp: one mma row tile
constexpr int kRowWarps = 4;     // warps of a CTA that split its rows
constexpr int kGroups = 2;       // warps of a CTA that split each stage
constexpr int kCtaRows = kRowWarps * kWarpRows;
constexpr int kWarpsPerCta = kRowWarps * kGroups;

// ---------------------------------------------------------------- PTX
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes from global into shared; zero-filled when !full.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x = hi + lo, both TF32 (round to nearest, ties away from zero)
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;
}
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += (ah + al)(bh + bl) without al*bl
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           float b0, float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split_tf32(b0, bh0, bl0);
  split_tf32(b1, bh1, bl1);
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr, uint32_t& r0,
                                                  uint32_t& r1, uint32_t& r2,
                                                  uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

// lo in the low half: the lower k index of an mma A pair
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ------------------------------------------------------------ layout
template <typename T> struct Elem;
template <> struct Elem<float> {
  static constexpr int kPerWord = 1;
  static __device__ __forceinline__ float store(float v) { return v; }
};
template <> struct Elem<__nv_bfloat16> {
  static constexpr int kPerWord = 2;
  static __device__ __forceinline__ __nv_bfloat16 store(float v) {
    return __float2bfloat16_rn(v);
  }
};

// Word w of row s of a tile of RW words a row.
template <int RW>
__device__ __forceinline__ int swz(int s, int w) {
  return s * RW + (w ^ ((s & 7) << 2));
}

// Raw bits of the element pair (2w, 2w+1) of a bf16 row (zero past d), or
// of element w of an f32 row.
template <typename T>
__device__ __forceinline__ uint32_t load_word(const T* row, int w, int d);
template <>
__device__ __forceinline__ uint32_t load_word<float>(const float* row, int w,
                                                     int d) {
  return w < d ? __float_as_uint(__ldg(row + w)) : 0u;
}
template <>
__device__ __forceinline__ uint32_t load_word<__nv_bfloat16>(
    const __nv_bfloat16* row, int w, int d) {
  const uint16_t* r = reinterpret_cast<const uint16_t*>(row);
  const uint32_t lo = 2 * w < d ? r[2 * w] : 0u;
  const uint32_t hi = 2 * w + 1 < d ? r[2 * w + 1] : 0u;
  return lo | hi << 16;
}

// The shared-memory layout of a CTA: a ring of kStages stages, each holding
// kSlots window slots (slot group k takes slots 64k..64k+63 of each) and the
// CTA's mask words of the same slots; the slot groups' partial
// denominators; and for f32 at d > 64, the CTA's query rows as TF32 hi and
// lo parts. After the window, the ring holds the slot groups' partial
// outputs for their sum. Offsets are in 32-bit words.
template <typename T, int DP>
struct Tiles {
  static constexpr int kRW = DP / Elem<T>::kPerWord;  // words a slot row
  // f32 at d > 64 reads its Q fragments from shared memory, and three
  // stages of its 128-float rows would not fit beside them
  static constexpr bool kQShared = sizeof(T) == 4 && DP > 64;
  static constexpr int kStages = kQShared ? 2 : 3;
  static constexpr int kSlots = kSlotTile * kGroups;
  static constexpr int kWRows = kCtaRows / 32;  // mask words of a slot
  static constexpr int kRed = DP / 2 + 2;  // partial o and dsum of a lane
  static constexpr int kWindow = kStages * kSlots * kRW;
  static constexpr int kReduce = (kGroups - 1) * kRowWarps * kRed * 32;
  static constexpr int kRing = kWindow > kReduce ? kWindow : kReduce;
  static constexpr int kMask = kRing;
  static constexpr int kDens = kMask + kStages * kWRows * kSlots;
  static constexpr int kQRows = kDens + kGroups * kCtaRows;
  static constexpr size_t kBytes =
      sizeof(uint32_t) * (kQRows + (kQShared ? 2 * kCtaRows * DP : 0));
};

// ------------------------------------------------------------ kernel
template <typename T, int DP, bool DIV_AFTER, bool INTMASK>
__global__ void __launch_bounds__(kWarpsPerCta * 32)
ab_block_attention_kernel(const T* __restrict__ q,          // [nb, B, d]
                          const T* __restrict__ xg,         // [nb, C, d]
                          const int32_t* __restrict__ mbits,// [nb, B/32, C]
                          T* __restrict__ out,              // [nb, B, d]
                          int B, int C, int d) {
  using L = Tiles<T, DP>;
  constexpr int RW = L::kRW;
  constexpr bool BF16 = sizeof(T) == 2;
  constexpr int KS = DP / (BF16 ? 16 : 8);  // k steps of S = Q X^T
  constexpr int NO = DP / 8;                 // n tiles of O
  constexpr int stages = L::kStages, slots = L::kSlots, wrows = L::kWRows;
  constexpr int cta_rows = kCtaRows;

  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* xs = smem;                          // [stage][slots][RW]
  uint32_t* ms = smem + L::kMask;               // [stage][wrows][slots]
  float* dx = reinterpret_cast<float*>(smem + L::kDens);  // [groups][rows]
  uint32_t* qs = smem + L::kQRows;     // f32, d > 64: [hi, lo][rows][DP]

  const int blk = blockIdx.x;
  const int row0 = blockIdx.y * cta_rows;  // the CTA's first row of B
  const int wrow0 = row0 / 32;
  const T* x_b = xg + (size_t)blk * C * d;
  const int32_t* m_b = mbits + (size_t)blk * (B / 32) * C;
  const int ntiles = (C + slots - 1) / slots;
  const int total = DIV_AFTER ? ntiles : 2 * ntiles;
  const bool vec = (d * (int)sizeof(T)) % 16 == 0 &&
                   (reinterpret_cast<uintptr_t>(xg) & 15u) == 0u;
  const int cpr = vec ? d * (int)sizeof(T) / 16 : 0;  // 16-B chunks a row
  const int pad = RW / 4 - cpr;

  // the pad words d..DP of every stage stay 0 (cp.async never writes them)
  if (vec) {
    for (int i = threadIdx.x; i < stages * slots * pad; i += blockDim.x) {
      uint32_t* p = xs + swz<RW>(i / pad, 4 * (cpr + i % pad));
      p[0] = p[1] = p[2] = p[3] = 0u;
    }
  }
  if constexpr (L::kQShared) {
    for (int i = threadIdx.x; i < cta_rows * DP; i += blockDim.x) {
      const int r = i / DP, f = i - r * DP;
      const bool ok = row0 + r < B && f < d;
      split_tf32(
          ok ? (float)__ldg(q + ((size_t)blk * B + row0 + r) * d + f) : 0.f,
          qs[swz<DP>(r, f)], qs[cta_rows * DP + swz<DP>(r, f)]);
    }
  }

  // window slots (v % ntiles) * slots onwards (and their mask words) into
  // stage st
  auto load = [&](int v, int st) {
    const int c0 = (v % ntiles) * slots;
    uint32_t* xt = xs + (size_t)st * slots * RW;
    if (vec) {
      for (int i = threadIdx.x; i < slots * cpr; i += blockDim.x) {
        const int s = i / cpr, ch = i - s * cpr;
        const bool ok = c0 + s < C;
        const T* src = x_b + (size_t)(ok ? c0 + s : 0) * d +
                       ch * (16 / (int)sizeof(T));
        cp_async16(smem_addr(xt + swz<RW>(s, 4 * ch)), src, ok);
      }
    } else {  // rows not 16-B aligned: plain loads, zeros past d and C
      for (int i = threadIdx.x; i < slots * RW; i += blockDim.x) {
        const int s = i / RW, w = i - s * RW;
        xt[swz<RW>(s, w)] =
            c0 + s < C ? load_word<T>(x_b + (size_t)(c0 + s) * d, w, d) : 0u;
      }
    }
    uint32_t* mt = ms + (size_t)st * wrows * slots;
    for (int i = threadIdx.x; i < wrows * slots; i += blockDim.x) {
      const int wr = i / slots, s = i - wr * slots;
      const bool ok = c0 + s < C && wrow0 + wr < B / 32;
      const int32_t* src =
          m_b + (ok ? (size_t)(wrow0 + wr) * C + c0 + s : 0);
      cp_async4(smem_addr(mt + i), src, ok);
    }
  };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp % kRowWarps, kg = warp / kRowWarps;  // rows, slots
  const int wrow_r = rg * kWarpRows;            // the warp's first CTA row
  const bool active = row0 + wrow_r < B;
  const int sb0 = (wrow_r & 31) + g;            // bit of row g; g+8 is +8
  const size_t orow = (size_t)blk * B + row0 + wrow_r + g;  // out row of g

  // the warp's Q fragments in registers: bf16 [KS][4] pairs, or f32 [KS][4]
  // TF32 hi (qa) and lo (ql) parts
  constexpr int QK = L::kQShared ? 1 : KS;
  constexpr int QL = BF16 || L::kQShared ? 1 : KS;
  uint32_t qa[QK][4] = {}, ql[QL][4] = {};
  if (!L::kQShared && active) {
    const T* q0 = q + orow * d;
    const T* q8 = q0 + 8 * (size_t)d;
#pragma unroll
    for (int ks = 0; ks < QK; ++ks) {
      if constexpr (BF16) {
        const int w = 8 * ks + t;  // the pair of features 16 ks + 2t
        qa[ks][0] = load_word<T>(q0, w, d);
        qa[ks][1] = load_word<T>(q8, w, d);
        qa[ks][2] = load_word<T>(q0, w + 4, d);
        qa[ks][3] = load_word<T>(q8, w + 4, d);
      } else {
        const int f = 8 * ks + t;
        const float v[4] = {f < d ? (float)q0[f] : 0.f,
                            f < d ? (float)q8[f] : 0.f,
                            f + 4 < d ? (float)q0[f + 4] : 0.f,
                            f + 4 < d ? (float)q8[f + 4] : 0.f};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          split_tf32(v[e], qa[ks][e], ql[QL == 1 ? 0 : ks][e]);
      }
    }
  }

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float dsum[2] = {0.f, 0.f};  // rows g and g+8, this lane's slots
  float den[2] = {1.f, 1.f};

  // the next tile: wait for stage v % stages, then refill the stage that
  // the last tile used
  auto next_tile = [&](int v) {
    cp_async_wait<L::kStages - 2>();
    __syncthreads();
    if (v + stages - 1 < total) load(v + stages - 1, (v + stages - 1) % stages);
    cp_async_commit();
  };
  // the warp's 64 slots of stage st and their mask words
  auto tile_x = [&](int st) {
    return xs + ((size_t)st * slots + kg * kSlotTile) * RW;
  };
  auto tile_m = [&](int st) {
    return ms + ((size_t)st * wrows + (wrow_r >> 5)) * slots + kg * kSlotTile;
  };

  // S = Q X^T over the warp's 64 slots
  auto scores = [&](const uint32_t* xt, float (&s)[kNTiles][4]) {
#pragma unroll
    for (int j = 0; j < kNTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t ah[4], al[4];
      if constexpr (!L::kQShared) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ah[e] = qa[ks][e];
          al[e] = ql[QL == 1 ? 0 : ks][e];
        }
      } else {
        const int r = wrow_r + g, f = 8 * ks + t;
        const uint32_t* lo = qs + cta_rows * DP;
        ah[0] = qs[swz<DP>(r, f)];
        ah[1] = qs[swz<DP>(r + 8, f)];
        ah[2] = qs[swz<DP>(r, f + 4)];
        ah[3] = qs[swz<DP>(r + 8, f + 4)];
        al[0] = lo[swz<DP>(r, f)];
        al[1] = lo[swz<DP>(r + 8, f)];
        al[2] = lo[swz<DP>(r, f + 4)];
        al[3] = lo[swz<DP>(r + 8, f + 4)];
      }
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) {
        // B[k][n] = X[slot 8j + g][k]: words 8 ks + t and + 4 of the row
        const int i0 = swz<RW>(8 * j + g, 8 * ks + t);
        const int i1 = swz<RW>(8 * j + g, 8 * ks + t + 4);
        if constexpr (BF16)
          mma_bf16(s[j], ah, xt[i0], xt[i1]);
        else
          mma_3xtf32(s[j], ah, al, __uint_as_float(xt[i0]),
                     __uint_as_float(xt[i1]));
      }
    }
  };

  // mask and exp on the fragment: s[j][e] is row g + 8 (e >> 1), slot
  // 8j + 2t + (e & 1) of the warp's 64
  auto masked_exp = [&](const uint32_t* mt, float s, int j, int e) {
    const uint32_t word = mt[8 * j + 2 * t + (e & 1)];
    const int rb = sb0 + 8 * (e >> 1);
    const float ex = expf(s);
    if (INTMASK)
      return __int_as_float(__float_as_int(ex) &
                            ((int)(word << (31 - rb)) >> 31));
    return ((word >> rb) & 1u) ? ex : 0.f;
  };

  // O += P X over the warp's 64 slots, P the weights in s
  auto values = [&](const uint32_t* xt, const float (&s)[kNTiles][4]) {
    if constexpr (BF16) {
#pragma unroll
      for (int kk = 0; kk < kNTiles / 2; ++kk) {
        const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                               pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                               pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                               pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
        const int sr = 16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int np = 0; np < NO / 2; ++np) {
          uint32_t b0, b1, b2, b3;
          ldmatrix_x4_trans(
              smem_addr(xt + swz<RW>(sr, 8 * np + (lane >> 4) * 4)), b0, b1,
              b2, b3);
          mma_bf16(o[2 * np], a, b0, b1);
          mma_bf16(o[2 * np + 1], a, b2, b3);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) {
        // k order permuted: k = t is slot 2t, k = t + 4 is slot 2t + 1
        uint32_t ah[4], al[4];
        split_tf32(s[j][0], ah[0], al[0]);
        split_tf32(s[j][2], ah[1], al[1]);
        split_tf32(s[j][1], ah[2], al[2]);
        split_tf32(s[j][3], ah[3], al[3]);
        const int sr = 8 * j + 2 * t;
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          const int i0 = swz<RW>(sr, 8 * n + g);
          const int i1 = swz<RW>(sr + 1, 8 * n + g);
          mma_3xtf32(o[n], ah, al, __uint_as_float(xt[i0]),
                     __uint_as_float(xt[i1]));
        }
      }
    }
  };

#pragma unroll 1
  for (int v = 0; v < stages - 1; ++v) {
    if (v < total) load(v, v);
    cp_async_commit();
  }
  float s[kNTiles][4];
  // one sweep: S, e and the denominators (and, DIV_AFTER, O += T(e) X)
#pragma unroll 1
  for (int v = 0; v < ntiles; ++v) {
    next_tile(v);
    if (!active) continue;
    const int st = v % stages;
    scores(tile_x(st), s);
#pragma unroll
    for (int j = 0; j < kNTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = masked_exp(tile_m(st), s[j][e], j, e);
        dsum[e >> 1] += s[j][e];
      }
    if (DIV_AFTER) values(tile_x(st), s);
  }
  if (!DIV_AFTER) {
    // the second sweep: S and e again, O += T(e / den) X
    if (active) {  // this warp's part of its rows' denominators
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float sm = dsum[h];
        sm += __shfl_xor_sync(0xffffffffu, sm, 1);
        sm += __shfl_xor_sync(0xffffffffu, sm, 2);
        if (t == 0) dx[kg * cta_rows + wrow_r + g + 8 * h] = sm;
      }
    }
#pragma unroll 1
    for (int v = ntiles; v < total; ++v) {
      next_tile(v);  // its barrier also publishes dx
      if (!active) continue;
      if (v == ntiles) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float sm = 0.f;
          for (int k = 0; k < kGroups; ++k)
            sm += dx[k * cta_rows + wrow_r + g + 8 * h];
          den[h] = fmaxf(sm, 1e-20f);
        }
      }
      const int st = v % stages;
      scores(tile_x(st), s);
#pragma unroll
      for (int j = 0; j < kNTiles; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = masked_exp(tile_m(st), s[j][e], j, e) / den[e >> 1];
      values(tile_x(st), s);
    }
  }

  // the slot groups' partial sums meet in the ring, now free
  if (kGroups > 1) {
    __syncthreads();
    float* red = reinterpret_cast<float*>(xs);
    float* mine = red + ((size_t)(kg - 1) * kRowWarps + rg) * L::kRed * 32;
    if (active && kg > 0) {
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) mine[(4 * n + e) * 32 + lane] = o[n][e];
      mine[4 * NO * 32 + lane] = dsum[0];
      mine[(4 * NO + 1) * 32 + lane] = dsum[1];
    }
    __syncthreads();
    if (kg > 0) return;
    for (int k = 1; active && k < kGroups; ++k) {
      const float* part = red + ((size_t)(k - 1) * kRowWarps + rg) * L::kRed * 32;
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] += part[(4 * n + e) * 32 + lane];
      dsum[0] += part[4 * NO * 32 + lane];
      dsum[1] += part[(4 * NO + 1) * 32 + lane];
    }
  }
  if (!active) return;

  // the divide (DIV_AFTER), the l2norm over the row's 4 lanes, the store
  if (DIV_AFTER) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float sm = dsum[h];
      sm += __shfl_xor_sync(0xffffffffu, sm, 1);
      sm += __shfl_xor_sync(0xffffffffu, sm, 2);
      den[h] = fmaxf(sm, 1e-20f);
    }
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = o[n][e] / den[e >> 1];
  }
  float ss[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) ss[e >> 1] = fmaf(o[n][e], o[n][e], ss[e >> 1]);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    ss[h] += __shfl_xor_sync(0xffffffffu, ss[h], 1);
    ss[h] += __shfl_xor_sync(0xffffffffu, ss[h], 2);
    ss[h] = fmaxf(sqrtf(ss[h]), 1e-6f);
  }
  T* o0 = out + orow * d;
  T* o8 = o0 + 8 * (size_t)d;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int f = 8 * n + 2 * t;
    if (f < d) {
      o0[f] = Elem<T>::store(o[n][0] / ss[0]);
      o8[f] = Elem<T>::store(o[n][2] / ss[1]);
    }
    if (f + 1 < d) {
      o0[f + 1] = Elem<T>::store(o[n][1] / ss[0]);
      o8[f + 1] = Elem<T>::store(o[n][3] / ss[1]);
    }
  }
}

template <typename T, int DP, bool DIV_AFTER, bool INTMASK>
int launch(const void* q, const void* xg, const int32_t* mbits, void* out,
           int nb, int B, int C, int d, cudaStream_t stream) {
  auto kern = ab_block_attention_kernel<T, DP, DIV_AFTER, INTMASK>;
  constexpr size_t smem = Tiles<T, DP>::kBytes;
  const cudaError_t err =
      reserve_smem(reinterpret_cast<const void*>(kern), smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(nb, (B + kCtaRows - 1) / kCtaRows);
  kern<<<grid, kWarpsPerCta * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(xg), mbits,
      static_cast<T*>(out), B, C, d);
  return (int)cudaGetLastError();
}

template <typename T, int DP>
int launch_flags(int div_after, int intmask, const void* q, const void* xg,
                 const int32_t* mbits, void* out, int nb, int B, int C, int d,
                 cudaStream_t s) {
  if (div_after)
    return intmask ? launch<T, DP, true, true>(q, xg, mbits, out, nb, B, C, d,
                                               s)
                   : launch<T, DP, true, false>(q, xg, mbits, out, nb, B, C,
                                                d, s);
  return intmask ? launch<T, DP, false, true>(q, xg, mbits, out, nb, B, C, d,
                                              s)
                 : launch<T, DP, false, false>(q, xg, mbits, out, nb, B, C, d,
                                               s);
}

template <typename T>
int launch_width(int div_after, int intmask, const void* q, const void* xg,
                 const int32_t* mbits, void* out, int nb, int B, int C, int d,
                 cudaStream_t s) {
  return d <= 64 ? launch_flags<T, 64>(div_after, intmask, q, xg, mbits, out,
                                       nb, B, C, d, s)
                 : launch_flags<T, 128>(div_after, intmask, q, xg, mbits, out,
                                        nb, B, C, d, s);
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the CUDA error code (0 = launched). bf16 = 0
// takes float tensors, 1 __nv_bfloat16. The caller has checked shapes,
// types, B % 32 == 0 and d <= 128.
int aba_launch(const void* q, const void* xg, const int32_t* mbits, void* out,
               int nb, int B, int C, int d, int bf16, int div_after,
               int intmask, void* stream) {
  if (B % 32 != 0 || d < 1 || d > 32 * kMaxF || C < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_width<__nv_bfloat16>(div_after, intmask, q, xg, mbits,
                                            out, nb, B, C, d, s)
              : launch_width<float>(div_after, intmask, q, xg, mbits, out, nb,
                                    B, C, d, s);
}

}  // extern "C"
