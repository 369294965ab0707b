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
// Design (block_attention.cuh, the body of kernel #1): the TPU kernel
// fetches the chunks by DMA one grid step ahead. Here a CTA (grid
// (nb, B/16), 16 query rows, 8 lanes a row at d <= 32, else 16) computes
// each slot's table row itself, from chunk_starts and the tail, into shared
// memory, with its rows' edge lists; then each row follows its own edges,
// reading their table rows straight from L2 (the table is 2.1 MB).
//
// What bounds it on an H100 SXM: at the relation chain's shapes (n=8192,
// B=256, d=64, ntot=544, K=16) the unique bytes are ~6.9 MB (q 2.1 MB,
// table 2.1 MB, tail 74 KB, mask 557 KB, out 2.1 MB): 2.1 us at 3.35 TB/s,
// while the edges need 4*E*d = 34 MFLOP (0.5 us at 67 TFLOP/s f32): bytes
// bound it. A row's time is a chain of L2 reads (its mask words, then two
// batches of 8 edges at d <= 64); all 8,192 rows are in flight at once.

#include "block_attention.cuh"

using namespace rgl;

namespace {

template <int L, int F4, bool STABLE, int EPI>
__global__ void __launch_bounds__(kRowsPerCta * L, min_ctas(L, F4))
chunk_block_attention_kernel(const float* __restrict__ q,        // [nb, B, d]
                             const float* __restrict__ x,        // [n, d]
                             const int32_t* __restrict__ starts, // [nb, nch]
                             const int64_t* __restrict__ tail,   // [nb, ct]
                             const int32_t* __restrict__ mbits,  // [nb, B/32, ntot]
                             float* __restrict__ out,            // [nb, B, d]
                             int B, int nch, int chunk, int ct, int g, int d,
                             int n) {
  const int blk = blockIdx.x, hc = chunk / g, part_w = nch * hc;
  const int nchunk = nch * chunk;
  const int32_t* st_b = starts + (size_t)blk * nch;
  const int64_t* tail_b = tail + (size_t)blk * ct;
  auto id_of = [=](int s) -> int64_t {
    if (s >= nchunk) return tail_b[s - nchunk];
    const int r = s / part_w, wi = s - r * part_w;
    const int c = wi / hc, j = wi - c * hc;
    return (int64_t)st_b[c] + (int64_t)j * g + r;
  };
  block_rows<L, F4, true, STABLE, EPI>(id_of, q, x, x, mbits, out, B,
                                       nchunk + ct, d, d, n);
}

template <bool STABLE, int EPI>
int launch_shape(int L, int F4, const float* q, const float* x,
                 const int32_t* starts, const int64_t* tail,
                 const int32_t* mbits, float* out, int nb, int B, int nch,
                 int chunk, int ct, int g, int d, int n, size_t smem,
                 cudaStream_t s) {
  if (L == 8)
    return launch_rows(chunk_block_attention_kernel<8, 1, STABLE, EPI>, L, nb,
                       B, smem, s, q, x, starts, tail, mbits, out, B, nch,
                       chunk, ct, g, d, n);
  if (F4 == 1)
    return launch_rows(chunk_block_attention_kernel<16, 1, STABLE, EPI>, L,
                       nb, B, smem, s, q, x, starts, tail, mbits, out, B, nch,
                       chunk, ct, g, d, n);
  return launch_rows(chunk_block_attention_kernel<16, 2, STABLE, EPI>, L, nb,
                     B, smem, s, q, x, starts, tail, mbits, out, B, nch, chunk,
                     ct, g, d, n);
}

template <bool STABLE>
int launch_epi(int epilogue, int L, int F4, const float* q, const float* x,
               const int32_t* starts, const int64_t* tail,
               const int32_t* mbits, float* out, int nb, int B, int nch,
               int chunk, int ct, int g, int d, int n, size_t smem,
               cudaStream_t s) {
  switch (epilogue) {
    case kNone:
      return launch_shape<STABLE, kNone>(L, F4, q, x, starts, tail, mbits,
                                         out, nb, B, nch, chunk, ct, g, d, n,
                                         smem, s);
    case kL2Norm:
      return launch_shape<STABLE, kL2Norm>(L, F4, q, x, starts, tail, mbits,
                                           out, nb, B, nch, chunk, ct, g, d,
                                           n, smem, s);
    case kRelu:
      return launch_shape<STABLE, kRelu>(L, F4, q, x, starts, tail, mbits,
                                         out, nb, B, nch, chunk, ct, g, d, n,
                                         smem, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the CUDA error code (0 = launched). A row
// takes 8 or 16 lanes by its width, as for fba_launch. The caller has
// checked shapes, types, B % 32 == 0, chunk % g == 0 and d <= 128.
int cba_launch(const float* q, const float* x, const int32_t* starts,
               const int64_t* tail, const int32_t* mbits, float* out, int nb,
               int B, int nch, int chunk, int ct, int g, int d, int n,
               int stable, int epilogue, void* stream) {
  int L = 0, F4 = 0;
  if (B % 32 != 0 || nch * chunk + ct < 1 || g < 1 || chunk % g != 0 ||
      !row_shape(d, &L, &F4))
    return (int)cudaErrorInvalidValue;
  const size_t smem = cta_smem_bytes(nch * chunk + ct);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return stable ? launch_epi<true>(epilogue, L, F4, q, x, starts, tail, mbits,
                                   out, nb, B, nch, chunk, ct, g, d, n, smem, s)
                : launch_epi<false>(epilogue, L, F4, q, x, starts, tail, mbits,
                                    out, nb, B, nch, chunk, ct, g, d, n, smem,
                                    s);
}

}  // extern "C"
