// Chunked-fetch block attention for Hopper (sm_90a), plain C interface.
//
// Replaces two Pallas TPU kernels with one:
//   relationalgraphlearning_tpu/ops/pallas_chunk.py::chunk_block_attention
//     (pallas_call at :255, body _kernel :137-212), groups = 2 (d = 64), and
//   tools/probe_chunk_d32.py::chunk_attention_d32
//     (pallas_call at :122, body _kernel :40-92), groups = 4 (d = 32).
//
// What it computes: the math of kernel #1 (block_attention.cuh) over a window
// of ntot = nch*chunk + ct slots per block of B rows. The first nch*chunk
// slots are nch aligned chunks of `chunk` contiguous table rows starting at
// chunk_starts[b, c]; the last ct slots are a tail of single rows named by
// id (sentinel n, clipped to n-1; its mask bits are never set). Keys are
// values (x). The mask [nb, B/32, ntot] is in the slot order that
// pallas_chunk.py::chunk_window builds: within the chunk part, slot
//   s = r * part_w + c * (chunk/g) + j,   part_w = nch*chunk/g,
// holds table row chunk_starts[b, c] + j*g + r (all rows = 0 mod g first,
// then = 1 mod g, ...). The TPU kernels view the table as rows of g*d = 128
// lanes to make their DMAs aligned, and assume their own g; here g is an
// argument, so one kernel serves d = 64 with g = 2 (#4) and d = 32 with
// g = 4 (#7), and no 2*d % 128 constraint applies. Rows with no edge give
// exactly 0; STABLE shifts by the row's max, else the softmax is unshifted.
//
// Design (simple first): the TPU kernel fetches the chunks by DMA one grid
// step ahead. Here a CTA (grid (nb, B/32), 8 warps, 32 query rows) computes
// each slot's table row itself, from chunk_starts and the tail, and copies
// the ntot rows into shared memory with coalesced loads (each chunk row is
// d contiguous floats, and the chunk's rows are contiguous in the table);
// then block_attention.cuh's attend() visits only the set mask bits. At
// d=64, ntot=544 that is 139,264 B of rows plus 17 KB of score rows, above
// the 48 KB default, hence the attribute; the wrapper raises above the
// card's 227 KB.
//
// What bounds it on an H100 SXM: at the relation chain's shapes (n=8192,
// B=256, d=64, ntot=544, K=16) the unique bytes are ~6.9 MB (q 2.1 MB,
// table 2.1 MB, tail 74 KB, mask 557 KB, out 2.1 MB): 2.1 us at 3.35 TB/s,
// while the edges need 4*E*d = 34 MFLOP (0.5 us at 67 TFLOP/s f32): bytes
// bound it. Like kernel #1 it re-stages each block's window once per CTA
// (B/32 = 8 times, ~36 MB from L2), what a faster design cuts first.

#include "block_attention.cuh"

using namespace rgl;

namespace {

template <bool STABLE, int EPI>
__global__ void __launch_bounds__(kWarps * 32)
chunk_block_attention_kernel(const float* __restrict__ q,        // [nb, B, d]
                             const float* __restrict__ x,        // [n, d]
                             const int32_t* __restrict__ starts, // [nb, nch]
                             const int64_t* __restrict__ tail,   // [nb, ct]
                             const int32_t* __restrict__ mbits,  // [nb, B/32, ntot]
                             float* __restrict__ out,            // [nb, B, d]
                             int B, int nch, int chunk, int ct, int g, int d,
                             int n) {
  extern __shared__ float smem[];
  const int ntot = nch * chunk + ct;
  const Window w = carve_window(smem, ntot, d);
  const int blk = blockIdx.x, wrow = blockIdx.y;
  const int hc = chunk / g, part_w = nch * hc;
  const int32_t* st_b = starts + (size_t)blk * nch;
  const int64_t* tail_b = tail + (size_t)blk * ct;
  const int32_t* m_b = mbits + ((size_t)blk * (B / 32) + wrow) * ntot;
  for (int s = threadIdx.x; s < ntot; s += blockDim.x) {
    int64_t id;
    if (s < nch * chunk) {
      const int r = s / part_w, wi = s - r * part_w;
      const int c = wi / hc, j = wi - c * hc;
      id = (int64_t)st_b[c] + (int64_t)j * g + r;
    } else {
      id = tail_b[s - nch * chunk];
    }
    id = id < 0 ? 0 : (id > n - 1 ? n - 1 : id);
    w.ids[s] = (int)id;
    w.ms[s] = (uint32_t)m_b[s];
  }
  __syncthreads();
  stage_rows(w, x, ntot, d);
  __syncthreads();
  attend<true, STABLE, EPI>(w, q, x, out, blk, wrow, B, ntot, d, d);
}

template <bool STABLE, int EPI>
int launch_one(const float* q, const float* x, const int32_t* starts,
               const int64_t* tail, const int32_t* mbits, float* out, int nb,
               int B, int nch, int chunk, int ct, int g, int d, int n,
               size_t smem, cudaStream_t stream) {
  auto kern = chunk_block_attention_kernel<STABLE, EPI>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(nb, B / kRowsPerCta);
  kern<<<grid, kWarps * 32, smem, stream>>>(q, x, starts, tail, mbits, out, B,
                                            nch, chunk, ct, g, d, n);
  return (int)cudaGetLastError();
}

template <bool STABLE>
int launch_epi(int epilogue, const float* q, const float* x,
               const int32_t* starts, const int64_t* tail,
               const int32_t* mbits, float* out, int nb, int B, int nch,
               int chunk, int ct, int g, int d, int n, size_t smem,
               cudaStream_t s) {
  switch (epilogue) {
    case kNone:
      return launch_one<STABLE, kNone>(q, x, starts, tail, mbits, out, nb, B,
                                       nch, chunk, ct, g, d, n, smem, s);
    case kL2Norm:
      return launch_one<STABLE, kL2Norm>(q, x, starts, tail, mbits, out, nb,
                                         B, nch, chunk, ct, g, d, n, smem, s);
    case kRelu:
      return launch_one<STABLE, kRelu>(q, x, starts, tail, mbits, out, nb, B,
                                       nch, chunk, ct, g, d, n, smem, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the CUDA error code (0 = launched). The caller
// has checked shapes, types, B % 32 == 0, chunk % g == 0 and d <= 128.
int cba_launch(const float* q, const float* x, const int32_t* starts,
               const int64_t* tail, const int32_t* mbits, float* out, int nb,
               int B, int nch, int chunk, int ct, int g, int d, int n,
               int stable, int epilogue, void* stream) {
  if (B % kRowsPerCta != 0 || d < 1 || d > 32 * kMaxF || g < 1 ||
      chunk % g != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = window_smem_bytes(nch * chunk + ct, d);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return stable ? launch_epi<true>(epilogue, q, x, starts, tail, mbits, out,
                                   nb, B, nch, chunk, ct, g, d, n, smem, s)
                : launch_epi<false>(epilogue, q, x, starts, tail, mbits, out,
                                    nb, B, nch, chunk, ct, g, d, n, smem, s);
}

}  // extern "C"
