// MP-RGL's value estimator, V(s) = value_network(RGL(robot, humans)[0]),
// for every forward of a batched call in one launch; plain C interface
// (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves the planner's six-node
// RGL forwards to XLA, which fuses them. Run eagerly
// (models/rgl.py::RGL.forward and MPRLNetworks.value), one batched call was
// a chain of ~30 kernels (two GEMMs and two ReLUs for each embedding, the
// cat, per GCN layer w_a, the scores, the softmax, H·W, A·(HW) and the ReLU,
// the value MLP's four GEMMs), each writing a (40,500-81,000) x 6 x (32-64)
// float tensor to device memory and reading it back. This kernel was added
// for that launch chain: the planner makes four such calls a decision at
// depth 2.
//
// What bounds it on an H100: operations, and shared memory's bandwidth on
// the way to them. A forward reads 9 robot floats and its humans' 5 each
// and writes one float, but does ~45 k float32 FMAs (~23 k where its
// humans are shared), most in the value network's 100 x 100 layer. The
// design:
// - Float32 FMA on the SMs throughout (no tensor cores: TF32 and bf16 are
//   the benchmark's failing controls). Sums are taken in another order than
//   the eager path's, and the second GCN layer's softmax online; nothing
//   else differs.
// - Every weight the estimator reads, 22.8 k floats (91 KB; 95 KB padded),
//   staged once a block into shared memory from the live parameter tensors
//   (a CUDA graph holding this launch reads them anew at every replay), all
//   of a block's loads in flight at once; one persistent block an SM walks
//   over tiles of up to 128 consecutive forwards.
// - The dense layers run over the tile at once, a product of [in][tile]
//   activations and [in][out] weights in which each thread takes 4
//   forwards x 4-8 outputs: a weight loaded feeds 4 FMAs and an input 4-8.
//   Fed a float4 per 4 FMAs, as in a one-forward-a-thread form, the FMA
//   units wait on shared memory (a warp's float4 load costs 4 of its
//   cycles): that form measured a quarter of the float32 peak. These are
//   the robot's embedding w_r, its rows of X·Wa^T and X·W1^T, and the value
//   network's two wide layers, the last folded into partial sums of V.
// - The relation part a team of four lanes a forward: the scores, the
//   softmaxes, layer 1's rows and layer 2's row 0, each lane holding a
//   quarter of a node's features; its small layers read their input from
//   the team's stash in shared memory in rolled loops. The code a forward
//   runs once is short: instruction fetch, not arithmetic, set the time of
//   a fully unrolled form at batch 1 (23.8 k instructions: the root clip's
//   81 forwards in 81 us on an H100, against 45 us in this form).
// - The humans' part once a group: consecutive forwards that read the same
//   humans (the planner's children share their parent's predicted humans, a
//   stride-0 view) form a group. A tile embeds each group it touches once
//   (w_h, then their rows of X·Wa^T and X·W1^T, and the human-human
//   scores) into shared memory; a forward adds only what depends on its
//   robot. Forwards that share nothing are groups of one.
// - Only what the output reads: the value network reads node 0 of the
//   last GCN layer, so that layer computes one row of its relation matrix
//   and (A_0·H)·W2 in place of A·(H·W2): the same function, one row.
// Nothing intermediate goes to device memory.
//
// Operands are read through their strides over up to kLead leading
// dimensions, so an expanded humans tensor is not copied.

#include <algorithm>
#include <cmath>

#include "common.cuh"

namespace {

constexpr int kThreads = 512;   // threads a block, one block an SM
constexpr int kTeam = 4;        // lanes a forward
constexpr int kTeams = kThreads / kTeam;  // forwards a pass of the block
constexpr int kWarpTeams = 32 / kTeam;    // teams a warp
constexpr int kLead = 4;        // leading dimensions, after merging
constexpr int kMaxHumans = 16;  // bound on N (shared memory: see smem_floats)
constexpr int kRobotDim = 9, kHumanDim = 5, kHidden = 64, kX = 32, kV = 100;
constexpr int kV8 = 104;        // kV padded to the products' blocks of 8
constexpr int kXL = kX / kTeam, kHL = kHidden / kTeam;
constexpr int kRow = 36;        // a node's 32 features, padded: 16-B rows
// A team's stash: the input vector of its next layer, up to kV wide; 101
// floats apart, the 8 teams of a warp read 8 banks.
constexpr int kStash = 101;
constexpr int kParams = 19;

// The weights in shared memory (floats; every offset a multiple of 4), each
// stored [in][out] (transposed from nn.Linear's [out][in]) so that a lane
// reads its outputs' weights of one input as float4s; the value network's
// 100-wide layers padded with zeros to kV8 outputs.
enum : int {
  oWr1 = 0,                           // w_r.layers[0]   9 x 64
  oBr1 = oWr1 + kRobotDim * kHidden,  // its bias
  oWr2 = oBr1 + kHidden,              // w_r.layers[1]   64 x 32
  oBr2 = oWr2 + kHidden * kX,
  oWh1 = oBr2 + kX,                   // w_h.layers[0]   5 x 64
  oBh1 = oWh1 + kHumanDim * kHidden,
  oWh2 = oBh1 + kHidden,              // w_h.layers[1]   64 x 32
  oBh2 = oWh2 + kHidden * kX,
  oWa = oBh2 + kX,                    // w_a             32 x 32
  oG1 = oWa + kX * kX,                // gcn_layers[0]   32 x 32
  oG2 = oG1 + kX * kX,                // gcn_layers[1]   32 x 32
  oV1 = oG2 + kX * kX,                // value_network.layers[0] 32 x 32
  oBv1 = oV1 + kX * kX,
  oV2 = oBv1 + kX,                    // layers[1]       32 x kV8
  oBv2 = oV2 + kX * kV8,
  oV3 = oBv2 + kV8,                   // layers[2]       100 x kV8
  oBv3 = oV3 + kV * kV8,
  oV4 = oBv3 + kV8,                   // layers[3]       kV8
  oBv4 = oV4 + kV8,
  kWeights = oBv4 + 4,
};

// Shared floats of one group of forwards: its humans' rows of X, X·Wa^T and
// X·W1^T, then their scores against each other.
__host__ __device__ constexpr int group_floats(int n) {
  return 3 * n * kRow + (n * n + 3) / 4 * 4;
}

// Shared floats of a block: the weights; a column of 2N + 1 scalars, a
// stash, a column of the robot's node and one of the value network's first
// layer a team (the robot's inputs, its embedding's hidden layer, its rows
// of X·Wa^T and X·W1^T, and the value network's second layer and partial
// sums pass through the stashes and the last column); the groups a tile
// touches.
__host__ __device__ constexpr int smem_floats(int n, int groups) {
  return kWeights + ((2 * n + 1) + kStash + 2 * kX) * kTeams +
         groups * group_floats(n);
}
static_assert(kStash >= kV && kStash >= kHidden && kStash >= 2 * kX,
              "the stashes hold the hidden and the second layers");
static_assert(kV8 / 8 <= kX, "y1 holds the partial sums");

struct Args {
  const float* w[kParams];  // nn.Linear weights and biases, as staged
  const float* robot;       // [..., 9]
  const float* humans;      // [..., N, 5]
  int64_t size[kLead];      // the leading dimensions, outermost first
  int64_t rs[kLead];        // robot's strides over them (elements)
  int64_t hs[kLead];        // humans' strides over them
  int64_t r_feat, h_row, h_feat;  // robot's feature, humans' row and feature
  int64_t n;                // forwards: the product of size
  int64_t group_size;       // consecutive forwards that share their humans
  int64_t tile;             // forwards a tile, at most kTeams
  int64_t tiles;
  int max_groups;           // groups a tile may touch
  int nh;                   // humans a forward, N
  float* out;               // [n]
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <int N>
__device__ __forceinline__ void st(float* p, const float (&x)[N]) {
#pragma unroll
  for (int o = 0; o < N; o += 4)
    *reinterpret_cast<float4*>(p + o) = make_float4(x[o], x[o + 1], x[o + 2],
                                                    x[o + 3]);
}

template <int N>
__device__ __forceinline__ void fill(float (&y)[N], const float* b) {
#pragma unroll
  for (int o = 0; o < N; o += 4) {
    const float4 v = ld4(b + o);
    y[o] = v.x;
    y[o + 1] = v.y;
    y[o + 2] = v.z;
    y[o + 3] = v.w;
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&y)[N]) {
#pragma unroll
  for (int o = 0; o < N; ++o) y[o] = 0.f;
}

template <int N>
__device__ __forceinline__ void relu(float (&y)[N]) {
#pragma unroll
  for (int o = 0; o < N; ++o) y[o] = fmaxf(y[o], 0.f);
}

// y[o] += sum_k x[k] * wt[k * LD + o] for the OUT outputs at wt (one
// thread's, or one lane's share), every input x[k] held by the thread.
template <int IN, int OUT, int LD = OUT>
__device__ __forceinline__ void matvec(const float* wt, const float (&x)[IN],
                                       float (&y)[OUT]) {
#pragma unroll
  for (int k = 0; k < IN; ++k) {
#pragma unroll
    for (int o = 0; o < OUT; o += 4) {
      const float4 w = ld4(wt + k * LD + o);
      y[o] = fmaf(x[k], w.x, y[o]);
      y[o + 1] = fmaf(x[k], w.y, y[o + 1]);
      y[o + 2] = fmaf(x[k], w.z, y[o + 2]);
      y[o + 3] = fmaf(x[k], w.w, y[o + 3]);
    }
  }
}

// The same with the inputs in the team's stash s (each read by the four
// lanes at once), the loop over them rolled: a forward runs this code once,
// so its length, not its count of operations, sets the latency of a small
// call.
template <int IN, int OUT, int LD>
__device__ __forceinline__ void matvec(const float* wt, const float* s,
                                       float (&y)[OUT]) {
#pragma unroll 4
  for (int k = 0; k < IN; ++k) {
    const float xk = s[k];
#pragma unroll
    for (int o = 0; o < OUT; o += 4) {
      const float4 w = ld4(wt + k * LD + o);
      y[o] = fmaf(xk, w.x, y[o]);
      y[o + 1] = fmaf(xk, w.y, y[o + 1]);
      y[o + 2] = fmaf(xk, w.z, y[o + 2]);
      y[o + 3] = fmaf(xk, w.w, y[o + 3]);
    }
  }
}

// Two of them on the same inputs.
template <int IN, int OUT, int LD>
__device__ __forceinline__ void matvec2(const float* wa, const float* wb,
                                        const float* s, float (&ya)[OUT],
                                        float (&yb)[OUT]) {
#pragma unroll 4
  for (int k = 0; k < IN; ++k) {
    const float xk = s[k];
#pragma unroll
    for (int o = 0; o < OUT; o += 4) {
      const float4 a = ld4(wa + k * LD + o), b = ld4(wb + k * LD + o);
      ya[o] = fmaf(xk, a.x, ya[o]);
      ya[o + 1] = fmaf(xk, a.y, ya[o + 1]);
      ya[o + 2] = fmaf(xk, a.z, ya[o + 2]);
      ya[o + 3] = fmaf(xk, a.w, ya[o + 3]);
      yb[o] = fmaf(xk, b.x, yb[o]);
      yb[o + 1] = fmaf(xk, b.y, yb[o + 1]);
      yb[o + 2] = fmaf(xk, b.z, yb[o + 2]);
      yb[o + 3] = fmaf(xk, b.w, yb[o + 3]);
    }
  }
}

// The team's next input vector into its stash: lane l's N values at
// s[l * N]. The warp's lanes all take part.
template <int N>
__device__ __forceinline__ void put(float* s, const float (&x)[N], int lane) {
  __syncwarp();
#pragma unroll
  for (int i = 0; i < N; ++i) s[lane * N + i] = x[i];
  __syncwarp();
}

// The sum of v over the team, on every lane of it.
__device__ __forceinline__ float team_sum(float v) {
#pragma unroll
  for (int o = 1; o < kTeam; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// x · row over the lane's kXL features, row in shared memory
__device__ __forceinline__ float dot(const float (&x)[kXL], const float* row) {
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int k = 0; k < kXL; k += 4) {
    const float4 w = ld4(row + k);
    s0 = fmaf(x[k], w.x, s0);
    s1 = fmaf(x[k + 1], w.y, s1);
    s0 = fmaf(x[k + 2], w.z, s0);
    s1 = fmaf(x[k + 3], w.w, s1);
  }
  return s0 + s1;
}

__device__ __forceinline__ float dot_regs(const float (&x)[kXL],
                                          const float (&y)[kXL]) {
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int k = 0; k < kXL; k += 2) {
    s0 = fmaf(x[k], y[k], s0);
    s1 = fmaf(x[k + 1], y[k + 1], s1);
  }
  return s0 + s1;
}

__device__ __forceinline__ float dot_rows(const float* a, const float* b) {
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
  for (int k = 0; k < kX; k += 4) {
    const float4 u = ld4(a + k), v = ld4(b + k);
    s0 = fmaf(u.x, v.x, s0);
    s1 = fmaf(u.y, v.y, s1);
    s2 = fmaf(u.z, v.z, s2);
    s3 = fmaf(u.w, v.w, s3);
  }
  return (s0 + s1) + (s2 + s3);
}

// y += a * row over the lane's kXL features
__device__ __forceinline__ void axpy(float a, const float* row,
                                     float (&y)[kXL]) {
#pragma unroll
  for (int k = 0; k < kXL; k += 4) {
    const float4 w = ld4(row + k);
    y[k] = fmaf(a, w.x, y[k]);
    y[k + 1] = fmaf(a, w.y, y[k + 1]);
    y[k + 2] = fmaf(a, w.z, y[k + 2]);
    y[k + 3] = fmaf(a, w.w, y[k + 3]);
  }
}

// Element offset of forward f's operand with strides `stride` over the
// leading dimensions.
__device__ __forceinline__ int64_t offset(const Args& a,
                                          const int64_t (&stride)[kLead],
                                          int64_t f) {
  int64_t off = 0;
#pragma unroll
  for (int d = kLead - 1; d >= 0; --d) {
    off += (f % a.size[d]) * stride[d];
    f /= a.size[d];
  }
  return off;
}

// One parameter tensor, nn.Linear's [OUT][IN] (a bias: IN = 1), on its way
// to shared memory: the thread's float4s of it in registers (the read-only
// path), then stored at dst, transposed to [IN][LD] where TRANSPOSE. All of
// a block's loads are issued before its first store.
template <int OUT, int IN, bool TRANSPOSE, int LD = OUT>
struct Staged {
  static constexpr int kN4 = OUT * IN / 4;
  static constexpr int kPer = (kN4 + kThreads - 1) / kThreads;
  static_assert(OUT * IN % 4 == 0, "a piece of whole float4s");
  float4 v[kPer];

  __device__ __forceinline__ void load(const float* src) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int q = threadIdx.x + i * kThreads;
      if (q < kN4) v[i] = __ldg(reinterpret_cast<const float4*>(src) + q);
    }
  }
  __device__ __forceinline__ void store(float* dst) const {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int q = threadIdx.x + i * kThreads;
      if (q >= kN4) continue;
      const float e[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int s = 4 * q + c;  // [s / IN][s % IN] of the source
        dst[TRANSPOSE ? s % IN * LD + s / IN : s] = e[c];
      }
    }
  }
};

__device__ void stage_weights(const Args& a, float* W) {
  Staged<kHidden, kRobotDim, true> wr1;
  Staged<kHidden, 1, false> br1;
  Staged<kX, kHidden, true> wr2;
  Staged<kX, 1, false> br2;
  Staged<kHidden, kHumanDim, true> wh1;
  Staged<kHidden, 1, false> bh1;
  Staged<kX, kHidden, true> wh2;
  Staged<kX, 1, false> bh2;
  Staged<kX, kX, true> wa, g1, g2, v1;
  Staged<kX, 1, false> bv1;
  Staged<kV, kX, true, kV8> v2;
  Staged<kV, 1, false> bv2;
  Staged<kV, kV, true, kV8> v3;
  Staged<kV, 1, false> bv3;
  Staged<1, kV, false> v4;
  wr1.load(a.w[0]);
  br1.load(a.w[1]);
  wr2.load(a.w[2]);
  br2.load(a.w[3]);
  wh1.load(a.w[4]);
  bh1.load(a.w[5]);
  wh2.load(a.w[6]);
  bh2.load(a.w[7]);
  wa.load(a.w[8]);
  g1.load(a.w[9]);
  g2.load(a.w[10]);
  v1.load(a.w[11]);
  bv1.load(a.w[12]);
  v2.load(a.w[13]);
  bv2.load(a.w[14]);
  v3.load(a.w[15]);
  bv3.load(a.w[16]);
  v4.load(a.w[17]);
  const float bv4 = threadIdx.x == 0 ? __ldg(a.w[18]) : 0.f;
  wr1.store(W + oWr1);
  br1.store(W + oBr1);
  wr2.store(W + oWr2);
  br2.store(W + oBr2);
  wh1.store(W + oWh1);
  bh1.store(W + oBh1);
  wh2.store(W + oWh2);
  bh2.store(W + oBh2);
  wa.store(W + oWa);
  g1.store(W + oG1);
  g2.store(W + oG2);
  v1.store(W + oV1);
  bv1.store(W + oBv1);
  v2.store(W + oV2);
  bv2.store(W + oBv2);
  v3.store(W + oV3);
  bv3.store(W + oBv3);
  v4.store(W + oV4);
  if (threadIdx.x == 0) W[oBv4] = bv4;
  // the padding: zero weights and biases, so the padded outputs read 0
  constexpr int kPad = kV8 - kV;
  for (int i = threadIdx.x; i < (kX + kV + 3) * kPad; i += kThreads) {
    const int row = i / kPad, col = kV + i % kPad;
    float* at = row < kX        ? W + oV2 + row * kV8
                : row < kX + kV ? W + oV3 + (row - kX) * kV8
                                : W + (row == kX + kV       ? oBv2
                                       : row == kX + kV + 1 ? oBv3
                                                            : oV4);
    at[col] = 0.f;
  }
}

// One human's rows on a team: x = w_h(h), x·Wa^T and x·W1^T, each lane's
// quarter of them into shared memory (x_out, p_out, q_out: the rows).
__device__ void embed(const float* W, const float* h, int64_t feat,
                      float* x_out, float* p_out, float* q_out, float* s,
                      int lane, bool store) {
  const int xl = lane * kXL;
  float in[kHumanDim];
#pragma unroll
  for (int k = 0; k < kHumanDim; ++k) in[k] = h[k * feat];
  float hid[kHL];
  fill(hid, W + oBh1 + lane * kHL);
  matvec<kHumanDim, kHL, kHidden>(W + oWh1 + lane * kHL, in, hid);
  relu(hid);
  put(s, hid, lane);
  float x[kXL];
  fill(x, W + oBh2 + xl);
  matvec<kHidden, kXL, kX>(W + oWh2 + xl, s, x);
  relu(x);
  put(s, x, lane);
  float p[kXL], q[kXL];
  zero(p);
  zero(q);
  matvec2<kX, kXL, kX>(W + oWa + xl, W + oG1 + xl, s, p, q);
  if (store) {
    st(x_out + xl, x);
    st(p_out + xl, p);
    st(q_out + xl, q);
  }
}

// V(s) of one forward on a team of kTeam lanes, from the robot's node x0
// and its rows p0 = x0·Wa^T, q0 = x0·W1^T up to the value network's first
// layer, each holding a kTeam-th of
// every node's features (lane l: [l * kXL, (l + 1) * kXL)) and of every
// layer's outputs: robot r (feature stride rf) with its group's N humans'
// rows X, P = X·Wa^T, Q = X·W1^T (in shared memory, read at the lane's
// features) and scores S = P·X^T. Scalars (scores, softmax weights) are
// the same on every lane. col: the team's scratch column (entry i at
// col[i * kTeams]; every lane writes the same values); s: its stash;
// y1_col: its column of the value network's first layer, which it fills.
__device__ void forward(const float* W, const float (&x0)[kXL],
                        const float (&p0)[kXL], const float (&q0)[kXL],
                        const float* X, const float* P, const float* Q,
                        const float* S, int nh, float* col, float* s,
                        float* y1_col, int lane) {
  const int xl = lane * kXL;
  // layer 1: the robot's relation row s_0j = p0·x_j to col[j], and the
  // humans' scores against it, s_i0 = p_i·x0, to col[1 + N + i]
  float smax = team_sum(dot_regs(p0, x0));
  col[0] = smax;
  for (int j = 0; j < nh; ++j) {
    const float s = team_sum(dot(p0, X + j * kRow + xl));
    col[(1 + j) * kTeams] = s;
    smax = fmaxf(smax, s);
    col[(1 + nh + j) * kTeams] = team_sum(dot(x0, P + j * kRow + xl));
  }
  // layer 1's row 0: h = relu(softmax(s_0.) · [q0; Q])
  float h[kXL];
  {
    float z = 0.f;
    for (int j = 0; j <= nh; ++j) z += expf(col[j * kTeams] - smax);
    const float a0 = expf(col[0] - smax) / z;
#pragma unroll
    for (int k = 0; k < kXL; ++k) h[k] = a0 * q0[k];
    for (int j = 0; j < nh; ++j)
      axpy(expf(col[(1 + j) * kTeams] - smax) / z, Q + j * kRow + xl, h);
    relu(h);
  }
  // layer 2 reads row 0 of its relation matrix alone: the query
  // q2 = h·Wa^T against every node of layer 1, an online softmax over the
  // nodes, acc = sum_i softmax_i · H1_i
  float q2[kXL];
  zero(q2);
  put(s, h, lane);
  matvec<kX, kXL, kX>(W + oWa + xl, s, q2);
  float acc[kXL];
#pragma unroll
  for (int k = 0; k < kXL; ++k) acc[k] = h[k];
  float m2 = team_sum(dot_regs(q2, h)), z2 = 1.f;
  for (int i = 0; i < nh; ++i) {
    // layer 1's row of human i: its scores against the robot and the humans
    const float c = col[(1 + nh + i) * kTeams];
    const float* s = S + i * nh;
    float mi = c;
    for (int j = 0; j < nh; ++j) mi = fmaxf(mi, s[j]);
    float zi = expf(c - mi);
    for (int j = 0; j < nh; ++j) zi += expf(s[j] - mi);
    float hi[kXL];
    const float a0 = expf(c - mi) / zi;
#pragma unroll
    for (int k = 0; k < kXL; ++k) hi[k] = a0 * q0[k];
    for (int j = 0; j < nh; ++j)
      axpy(expf(s[j] - mi) / zi, Q + j * kRow + xl, hi);
    relu(hi);
    const float t = team_sum(dot_regs(q2, hi));
    const float mn = fmaxf(m2, t), scale = expf(m2 - mn), e = expf(t - mn);
#pragma unroll
    for (int k = 0; k < kXL; ++k) acc[k] = fmaf(e, hi[k], acc[k] * scale);
    z2 = fmaf(z2, scale, e);
    m2 = mn;
  }
#pragma unroll
  for (int k = 0; k < kXL; ++k) acc[k] = acc[k] / z2;
  float g[kXL];
  zero(g);
  put(s, acc, lane);
  matvec<kX, kXL, kX>(W + oG2 + xl, s, g);
  relu(g);
  put(s, g, lane);
  // the value network's first layer, into the forward's column of y1
  float y1[kXL];
  fill(y1, W + oBv1 + xl);
  matvec<kX, kXL, kX>(W + oV1 + xl, s, y1);
  relu(y1);
#pragma unroll
  for (int k = 0; k < kXL; ++k) y1_col[(xl + k) * kTeams] = y1[k];
}

// A dense layer over the tile's forwards at once (the robot's embedding,
// its rows of X·Wa^T and X·W1^T, the value network's wide layers), a
// product of [K][kTeams] inputs (a forward a column) and [K][LD] weights:
// out[o][r] = act(bias[o] + sum_k in[k][r] * wt[k][o]) for o < OUT. Each
// thread takes 4 forwards x TO outputs, so that a weight it loads feeds 4
// FMAs and an input TO: shared memory's bandwidth, not the FMA units,
// bounds the one-forward-a-team form. With V4 (the last layer's weights),
// out[c][r] = sum over the block c of TO outputs of V4[o] * act(...)
// instead: the partial sums of the value, added in order afterwards. Only
// the first `rows` columns (rounded up to 4) are computed; the thread that
// would take block t with shift 0 takes block t + shift.
template <int K, int OUT, int LD, int TO, bool RELU = true>
__device__ __forceinline__ void product(const float* in, const float* wt,
                                        const float* bias, const float* v4,
                                        float* out, int rows, int shift = 0) {
  constexpr int kRowTiles = kTeams / 4, kTiles = kRowTiles * (OUT / TO);
  static_assert(OUT % TO == 0 && TO % 4 == 0, "whole float4s of outputs");
  for (int t = (threadIdx.x + kThreads - shift) % kThreads; t < kTiles;
       t += kThreads) {
    const int r0 = t % kRowTiles * 4, c = t / kRowTiles, o0 = c * TO;
    if (r0 >= rows) continue;
    float acc[4][TO];
#pragma unroll
    for (int j = 0; j < TO; ++j) {
      const float b = bias == nullptr ? 0.f : bias[o0 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][j] = b;
    }
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const float4 x4 = ld4(in + k * kTeams + r0);
      const float x[4] = {x4.x, x4.y, x4.z, x4.w};
      float w[TO];
#pragma unroll
      for (int j = 0; j < TO; j += 4) {
        const float4 w4 = ld4(wt + k * LD + o0 + j);
        w[j] = w4.x;
        w[j + 1] = w4.y;
        w[j + 2] = w4.z;
        w[j + 3] = w4.w;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < TO; ++j) acc[i][j] = fmaf(x[i], w[j], acc[i][j]);
    }
    if (v4 == nullptr) {
#pragma unroll
      for (int j = 0; j < TO; ++j) {
        if (RELU)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaxf(acc[i][j], 0.f);
        *reinterpret_cast<float4*>(out + (o0 + j) * kTeams + r0) =
            make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
      }
    } else {
      float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < TO; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          part[i] = fmaf(v4[o0 + j], fmaxf(acc[i][j], 0.f), part[i]);
      *reinterpret_cast<float4*>(out + c * kTeams + r0) =
          make_float4(part[0], part[1], part[2], part[3]);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    rgl_value_kernel(const Args a) {
  extern __shared__ float4 smem[];
  float* const W = reinterpret_cast<float*>(smem);
  const int nh = a.nh;
  const int team = threadIdx.x / kTeam, lane = threadIdx.x % kTeam;
  float* const col = W + kWeights + team;
  float* const stashes = W + kWeights + (2 * nh + 1) * kTeams;
  float* const stash = stashes + team * kStash;
  float* const y1 = stashes + kStash * kTeams;  // [kX][kTeams]
  float* const x0s = y1 + kX * kTeams;           // [kX][kTeams]
  float* const groups = x0s + kX * kTeams;
  const int gf = group_floats(nh);
  stage_weights(a, W);
  __syncthreads();
  // tile t: forwards [t * a.tile, ...), of the groups g0 ... g0 + ng - 1
  for (int64_t t = blockIdx.x; t < a.tiles; t += gridDim.x) {
    const int64_t f0 = t * a.tile;
    const int nf = (int)min(a.tile, a.n - f0);
    const int64_t g0 = f0 / a.group_size;
    const int ng = (int)((f0 + nf - 1) / a.group_size - g0 + 1);
    // each group's humans, embedded once, a team a human (a team past the
    // last embeds that one again and stores nothing: its warp's lanes take
    // part in every shuffle)
    for (int r0 = 0; r0 < ng * nh; r0 += kTeams) {
      if (r0 + team / kWarpTeams * kWarpTeams >= ng * nh) continue;
      const int r = min(r0 + team, ng * nh - 1), g = r / nh, j = r % nh;
      float* G = groups + g * gf;
      embed(W,
            a.humans + offset(a, a.hs, (g0 + g) * a.group_size) +
                j * a.h_row,
            a.h_feat, G + j * kRow, G + (nh + j) * kRow,
            G + (2 * nh + j) * kRow, stash, lane, r0 + team < ng * nh);
    }
    __syncthreads();
    // their scores against each other: S_ij = p_i·x_j
    for (int e = threadIdx.x; e < ng * nh * nh; e += kThreads) {
      const int g = e / (nh * nh), i = e % (nh * nh) / nh, j = e % nh;
      float* G = groups + g * gf;
      G[3 * nh * kRow + i * nh + j] =
          dot_rows(G + (nh + i) * kRow, G + j * kRow);
    }
    __syncthreads();
    // the robots' inputs [9][kTeams] (in y1; a column past the last
    // forward repeats it), their embedding, and their rows of X·Wa^T and
    // X·W1^T (in the stashes)
    const int rows = (nf + 3) / 4 * 4;  // columns the products compute
    for (int e = threadIdx.x; e < kRobotDim * kTeams; e += kThreads) {
      const int k = e / kTeams, c = e % kTeams;
      if (c < rows)
        y1[e] = a.robot[offset(a, a.rs, f0 + min(c, nf - 1)) + k * a.r_feat];
    }
    __syncthreads();
    product<kRobotDim, kHidden, kHidden, 8>(y1, W + oWr1, W + oBr1, nullptr,
                                            stashes, rows);
    __syncthreads();
    product<kHidden, kX, kX, 8>(stashes, W + oWr2, W + oBr2, nullptr, x0s,
                                rows);
    __syncthreads();
    product<kX, kX, kX, 8, false>(x0s, W + oWa, nullptr, nullptr, stashes,
                                  rows);
    product<kX, kX, kX, 8, false>(x0s, W + oG1, nullptr, nullptr,
                                  stashes + kX * kTeams, rows, kThreads / 2);
    __syncthreads();
    // the tile's forwards, a team each, up to the value network's first
    // layer (a team past the last computes that one again; a warp past the
    // last waits)
    {
      const int c = min(team, nf - 1);
      float x0[kXL], p0[kXL], q0[kXL];
#pragma unroll
      for (int k = 0; k < kXL; ++k) {
        const int at = (lane * kXL + k) * kTeams + c;
        x0[k] = x0s[at];
        p0[k] = stashes[at];
        q0[k] = stashes[kX * kTeams + at];
      }
      __syncthreads();
      if (team / kWarpTeams * kWarpTeams < nf) {
        const int64_t f = f0 + c;
        const float* G = groups + (f / a.group_size - g0) * gf;
        forward(W, x0, p0, q0, G, G + nh * kRow, G + 2 * nh * kRow,
                G + 3 * nh * kRow, nh, col, stash, y1 + team, lane);
      }
    }
    __syncthreads();
    // the wide layers over the tile: y2 = relu(V2·y1 + b2) into the
    // stashes, then the partial sums of V4·relu(V3·y2 + b3) into y1
    product<kX, kV, kV8, 4>(y1, W + oV2, W + oBv2, nullptr, stashes, rows);
    __syncthreads();
    product<kV, kV8, kV8, 8>(stashes, W + oV3, W + oBv3, W + oV4, y1, rows);
    __syncthreads();
    if ((int)threadIdx.x < nf) {
      float v = W[oBv4];
      for (int c = 0; c < kV8 / 8; ++c) v += y1[c * kTeams + threadIdx.x];
      a.out[f0 + threadIdx.x] = v;
    }
    __syncthreads();
  }
}

int g_sms = 0;  // SMs of the card, read by rgl_value_prepare

}  // namespace

extern "C" {

// Let the kernel take the card's largest dynamic shared memory and read the
// card's SM count; once, before any launch (and before any graph capture).
int rgl_value_prepare() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&g_sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    int most = 0;
    err = cudaDeviceGetAttribute(
        &most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          rgl_value_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  }
  return (int)err;
}

// out[n] = V of each forward. w: the 19 parameter tensors (float32,
// contiguous, 16-byte aligned) in stage_weights' order; layout (int64):
// size[kLead], robot strides [kLead], humans strides [kLead], robot's
// feature stride, humans' row and feature strides, n, group_size, tile
// (forwards a tile), tiles, max_groups (groups a tile may touch), N.
// Returns the CUDA error code (0 = launched).
int rgl_value_launch(const void* const* w, const float* robot,
                     const float* humans, const int64_t* layout, float* out,
                     void* stream) {
  Args a;
  for (int p = 0; p < kParams; ++p) a.w[p] = static_cast<const float*>(w[p]);
  a.robot = robot;
  a.humans = humans;
  for (int d = 0; d < kLead; ++d) {
    a.size[d] = layout[d];
    a.rs[d] = layout[kLead + d];
    a.hs[d] = layout[2 * kLead + d];
  }
  const int64_t* rest = layout + 3 * kLead;
  a.r_feat = rest[0];
  a.h_row = rest[1];
  a.h_feat = rest[2];
  a.n = rest[3];
  a.group_size = rest[4];
  a.tile = rest[5];
  a.tiles = rest[6];
  a.max_groups = (int)rest[7];
  a.nh = (int)rest[8];
  a.out = out;
  if (g_sms < 1 || a.n < 1 || a.nh < 1 || a.nh > kMaxHumans ||
      a.group_size < 1 || a.n % a.group_size || a.tile < 1 ||
      a.tile > kTeams || a.tiles != (a.n + a.tile - 1) / a.tile ||
      a.max_groups < std::min((a.tile + a.group_size - 2) / a.group_size + 1,
                              a.n / a.group_size))
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * smem_floats(a.nh, a.max_groups);
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, rgl_value_kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int64_t grid = std::min<int64_t>(a.tiles, (int64_t)g_sms * per_sm);
  rgl_value_kernel<<<(unsigned)grid, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
