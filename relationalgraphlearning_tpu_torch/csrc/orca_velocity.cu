// ORCA's velocity solve, one thread an agent, plain C interface (sm_90a).
//
// Replaces no TPU kernel: the JAX package solves ORCA as masked tensor
// operations (relationalgraphlearning_tpu/envs/orca.py), which XLA fuses;
// run eagerly, the port's transcription of it (envs/orca.py::
// orca_velocity_plain) launched ~460 small kernels a solve. Each agent's
// problem is two-dimensional with M <= 64 half-planes, so one thread holds
// it whole: the agent's M ORCA lines, the 1-D LP of a line against the
// lines before it (linearProgram1), the incremental 2-D LP over the lines
// (linearProgram2) and, only where that fails, linearProgram3, whose
// projected 2-D LP of line i is solved when line i is the most violated
// line, not for every line up front. It depends on i alone, so solving it
// lazily gives the values the plain version's batched solve gives.
//
// What bounds it on an H100: at the crowd's 10,240 agents and M = 10 a
// solve reads ~0.7 MB (each neighbour's position, velocity, radius and
// flag) and does a few thousand float32 operations an agent, tens of MFLOP
// in all: microseconds at the card's 3.35 TB/s and 67 TFLOP/s. Each
// thread's chain is serial and the agents number a few warps an SM, so the
// chain's latency sets the time; the design keeps it short: a line is
// built once into a float4 in local memory (L1), the 1-D LP of a line runs
// only when the 2-D LP reaches it violated, and linearProgram3 only where
// linearProgram2 failed.
//
// The arithmetic is the plain version's, operation by operation, in
// float32: every product, sum, quotient and square root is rounded alone
// (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn: no contraction
// into an FMA, no approximate divide or root), with the same clamps, the
// same comparisons and torch's NaN-propagating min, max and clamp, so the
// kernel gives the plain version's bits on the card.
//
// Operands are read through their strides (a stride-0 neighbour table from
// `expand` is not copied), over up to kLead leading (agent) dimensions. The
// kernel also adds the number of agents that took linearProgram3 into
// *lp3, one atomic a warp.

#include <cmath>

#include "common.cuh"

namespace {

constexpr int kLead = 4;       // leading (agent) dimensions, after merging
constexpr int kThreads = 128;  // threads (agents) a block
constexpr int kOperands = 9;   // p_i v_i r_i pref vmax p_j v_j r_j valid
constexpr int kStrides = kLead + 2;  // leading dims, neighbour, component

struct Args {
  const void* ptr[kOperands];
  // each operand's strides in elements: kLead leading, then the neighbour
  // dimension and the (x, y) component (0 where the operand has none)
  int64_t stride[kOperands][kStrides];
  int64_t size[kLead];  // the leading dimensions, outermost first
  int64_t n;            // agents: the product of size
  int m;                // neighbours (lines) an agent
  float inv_th, inv_dt, nd_sq, safety, eps;
  float* out;                    // [n, 2]
  unsigned long long* lp3;       // agents through linearProgram3
};

enum { kPi, kVi, kRi, kPref, kVmax, kPj, kVj, kRj, kValid };

// ------------------------------------------------------ torch's arithmetic
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float quo(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float root(float a) { return __fsqrt_rn(a); }

__device__ __forceinline__ bool is_nan(float a) { return a != a; }

// torch.clamp(x, min=lo) with a scalar lo
__device__ __forceinline__ float clamp_lo(float x, float lo) {
  return is_nan(x) ? x : fmaxf(x, lo);
}

// torch.minimum / torch.maximum (and amin / amax): NaN wins
__device__ __forceinline__ float min_nan(float a, float b) {
  return is_nan(a) ? a : (is_nan(b) ? b : fminf(a, b));
}
__device__ __forceinline__ float max_nan(float a, float b) {
  return is_nan(a) ? a : (is_nan(b) ? b : fmaxf(a, b));
}

// torch.clamp(x, lo, hi) with tensor bounds: min(max(x, lo), hi)
__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  if (is_nan(x)) return x;
  if (is_nan(lo)) return lo;
  if (is_nan(hi)) return hi;
  return fminf(fmaxf(x, lo), hi);
}

// envs/orca.py's _det(a, b) and _dot(a, b)
__device__ __forceinline__ float det(float ax, float ay, float bx, float by) {
  return sub(mul(ax, by), mul(ay, bx));
}
__device__ __forceinline__ float dot(float ax, float ay, float bx, float by) {
  return add(mul(ax, bx), mul(ay, by));
}

// A line: its point (x, y) and its direction (z, w); its feasible side is
// {v : det(direction, point - v) <= 0}.
__device__ __forceinline__ float penetration(const float4& l, float rx,
                                             float ry) {
  return det(l.z, l.w, sub(l.x, rx), sub(l.y, ry));
}

// ----------------------------------------------------------------- the LPs
// linearProgram1 of line i against the lines j < i whose bit is set in
// `use`, on the disc of radius r (r2 = r * r): the plain version's
// _linear_program1_all for one line. `dir_opt`: optimise along (ox, oy);
// else come closest to it. Returns whether the line is feasible; the
// result goes to (rx, ry).
__device__ bool lp1(const float4* lines, uint64_t use, int i, float r2,
                    float ox, float oy, bool dir_opt, float eps, float& rx,
                    float& ry) {
  const float4 li = lines[i];
  const float dp = dot(li.x, li.y, li.z, li.w);
  const float disc = sub(add(mul(dp, dp), r2), dot(li.x, li.y, li.x, li.y));
  bool feasible = disc >= 0.f;
  const float sq = root(clamp_lo(disc, 0.f));
  float t_left = sub(-dp, sq);
  float t_right = add(-dp, sq);
  float lo = -INFINITY, hi = INFINITY;  // amax / amin over the lines j < i
  for (int j = 0; j < i; ++j) {
    if (!((use >> j) & 1)) continue;
    const float4 lj = lines[j];
    const float denom = det(li.z, li.w, lj.z, lj.w);
    const float numer = det(lj.z, lj.w, sub(li.x, lj.x), sub(li.y, lj.y));
    if (fabsf(denom) <= eps) {  // parallel: infeasible if on the wrong side
      if (numer < 0.f) feasible = false;
      continue;
    }
    const float t = quo(numer, denom);
    if (denom >= 0.f) {
      hi = min_nan(hi, t);
    } else if (denom < 0.f) {
      lo = max_nan(lo, t);
    }
  }
  t_right = min_nan(t_right, hi);
  t_left = max_nan(t_left, lo);
  feasible = feasible && t_left <= t_right;
  float t;
  if (dir_opt) {
    t = dot(ox, oy, li.z, li.w) > 0.f ? t_right : t_left;
  } else {
    t = clamp(dot(li.z, li.w, sub(ox, li.x), sub(oy, li.y)), t_left, t_right);
  }
  rx = add(li.x, mul(t, li.z));
  ry = add(li.y, mul(t, li.w));
  return feasible;
}

// linearProgram2 over the m lines whose bit is set in `use`: the plain
// version's _linear_program2. Returns the line it failed at, m if none;
// (rx, ry) is the result so far.
__device__ int lp2(const float4* lines, uint64_t use, int m, float r,
                   float ox, float oy, bool dir_opt, float eps, float& rx,
                   float& ry) {
  const float r2 = mul(r, r);
  if (dir_opt) {
    rx = mul(ox, r);
    ry = mul(oy, r);
  } else {
    const float speed_sq = dot(ox, oy, ox, oy);
    if (speed_sq > r2) {
      const float s = root(clamp_lo(speed_sq, 1e-20f));
      rx = mul(quo(ox, s), r);
      ry = mul(quo(oy, s), r);
    } else {
      rx = ox;
      ry = oy;
    }
  }
  for (int i = 0; i < m; ++i) {
    if (!((use >> i) & 1) || !(penetration(lines[i], rx, ry) > 0.f)) continue;
    float lx, ly;
    if (!lp1(lines, use, i, r2, ox, oy, dir_opt, eps, lx, ly)) return i;
    rx = lx;
    ry = ly;
  }
  return m;
}

// ORCA's half-plane of agent i (p, v, radius ri) against one neighbour (p,
// v, radius rj): the plain version's orca_lines for one pair. `in_range`:
// the neighbour lies within the neighbour distance (nd_sq its square).
__device__ float4 orca_line(float pix, float piy, float vix, float viy,
                            float ri, float pjx, float pjy, float vjx,
                            float vjy, float rj, float inv_th, float inv_dt,
                            float nd_sq, bool& in_range) {
  const float rpx = sub(pjx, pix), rpy = sub(pjy, piy);  // relative position
  const float rvx = sub(vix, vjx), rvy = sub(viy, vjy);  // relative velocity
  const float dist_sq = dot(rpx, rpy, rpx, rpy);
  in_range = dist_sq < nd_sq;
  const float comb_r = add(ri, rj);
  const float comb_r_sq = mul(comb_r, comb_r);
  float dx, dy, ux, uy;
  if (dist_sq <= comb_r_sq) {
    // colliding: the cut-off circle at the time step
    const float wx = sub(rvx, mul(inv_dt, rpx));
    const float wy = sub(rvy, mul(inv_dt, rpy));
    const float w_len = root(clamp_lo(dot(wx, wy, wx, wy), 1e-20f));
    const float unx = quo(wx, w_len), uny = quo(wy, w_len);
    dx = uny;
    dy = -unx;
    const float s = sub(mul(comb_r, inv_dt), w_len);
    ux = mul(s, unx);
    uy = mul(s, uny);
  } else {
    // the velocity obstacle cut off at the time horizon
    const float wx = sub(rvx, mul(inv_th, rpx));
    const float wy = sub(rvy, mul(inv_th, rpy));
    const float w_len_sq = dot(wx, wy, wx, wy);
    const float dot1 = dot(wx, wy, rpx, rpy);
    if (dot1 < 0.f && mul(dot1, dot1) > mul(comb_r_sq, w_len_sq)) {
      // project on the cut-off circle
      const float w_len = root(clamp_lo(w_len_sq, 1e-20f));
      const float unx = quo(wx, w_len), uny = quo(wy, w_len);
      dx = uny;
      dy = -unx;
      const float s = sub(mul(comb_r, inv_th), w_len);
      ux = mul(s, unx);
      uy = mul(s, uny);
    } else {
      // project on a leg
      const float leg = root(clamp_lo(sub(dist_sq, comb_r_sq), 1e-20f));
      const float dsq = clamp_lo(dist_sq, 1e-20f);
      if (det(rpx, rpy, wx, wy) > 0.f) {  // left leg
        dx = quo(sub(mul(rpx, leg), mul(rpy, comb_r)), dsq);
        dy = quo(add(mul(rpx, comb_r), mul(rpy, leg)), dsq);
      } else {                            // right leg
        dx = quo(-add(mul(rpx, leg), mul(rpy, comb_r)), dsq);
        dy = quo(-add(mul(-rpx, comb_r), mul(rpy, leg)), dsq);
      }
      const float d2 = dot(rvx, rvy, dx, dy);
      ux = sub(mul(d2, dx), rvx);
      uy = sub(mul(d2, dy), rvy);
    }
  }
  return make_float4(add(vix, mul(0.5f, ux)), add(viy, mul(0.5f, uy)), dx,
                     dy);
}

// An operand's element: `lead` its leading offset, j the neighbour, c the
// component.
template <typename T>
__device__ __forceinline__ T at(const Args& a, int op, int64_t lead, int j,
                                int c) {
  return static_cast<const T*>(a.ptr[op])[lead + j * a.stride[op][kLead] +
                                          c * a.stride[op][kLead + 1]];
}

template <int MMAX>
__global__ void __launch_bounds__(kThreads) orca_velocity_kernel(Args a) {
  const int64_t idx = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const bool live = idx < a.n;
  bool took_lp3 = false;
  if (live) {
    int64_t off[kOperands] = {};
    int64_t rest = idx;
#pragma unroll
    for (int d = kLead - 1; d >= 0; --d) {
      const int64_t c = rest % a.size[d];
      rest /= a.size[d];
#pragma unroll
      for (int op = 0; op < kOperands; ++op) off[op] += c * a.stride[op][d];
    }
    const float pix = at<float>(a, kPi, off[kPi], 0, 0);
    const float piy = at<float>(a, kPi, off[kPi], 0, 1);
    const float vix = at<float>(a, kVi, off[kVi], 0, 0);
    const float viy = at<float>(a, kVi, off[kVi], 0, 1);
    const float ri = add(at<float>(a, kRi, off[kRi], 0, 0), a.safety);
    const int m = a.m;

    float4 lines[MMAX];
    uint64_t use = 0;  // line j's bit: the neighbour is valid and in range
    for (int j = 0; j < m; ++j) {
      bool in_range;
      lines[j] = orca_line(
          pix, piy, vix, viy, ri, at<float>(a, kPj, off[kPj], j, 0),
          at<float>(a, kPj, off[kPj], j, 1), at<float>(a, kVj, off[kVj], j, 0),
          at<float>(a, kVj, off[kVj], j, 1),
          add(at<float>(a, kRj, off[kRj], j, 0), a.safety), a.inv_th,
          a.inv_dt, a.nd_sq, in_range);
      if (in_range && at<bool>(a, kValid, off[kValid], j, 0))
        use |= uint64_t(1) << j;
    }

    const float vmax = at<float>(a, kVmax, off[kVmax], 0, 0);
    float rx, ry;
    const int fail = lp2(lines, use, m, vmax,
                         at<float>(a, kPref, off[kPref], 0, 0),
                         at<float>(a, kPref, off[kPref], 0, 1), false, a.eps,
                         rx, ry);
    if (fail < m) {
      // linearProgram3: minimise the largest penetration, from line `fail`
      took_lp3 = true;
      float distance = 0.f;
      for (int i = fail; i < m; ++i) {
        if (!((use >> i) & 1)) continue;
        const float4 li = lines[i];
        if (!(penetration(li, rx, ry) > distance)) continue;
        // line i's projected problem: the lines j < i seen from line i
        float4 proj[MMAX];
        uint64_t proj_use = 0;
        for (int j = 0; j < i; ++j) {
          if (!((use >> j) & 1)) continue;
          const float4 lj = lines[j];
          const float denom = det(li.z, li.w, lj.z, lj.w);
          const bool parallel = fabsf(denom) <= a.eps;
          if (parallel && dot(li.z, li.w, lj.z, lj.w) > 0.f) continue;
          proj_use |= uint64_t(1) << j;
          float px, py;
          if (parallel) {  // opposite directions: halfway between
            px = mul(0.5f, add(li.x, lj.x));
            py = mul(0.5f, add(li.y, lj.y));
          } else {
            const float t = quo(
                det(lj.z, lj.w, sub(li.x, lj.x), sub(li.y, lj.y)), denom);
            px = add(li.x, mul(t, li.z));
            py = add(li.y, mul(t, li.w));
          }
          const float gx = sub(lj.z, li.z), gy = sub(lj.w, li.w);
          const float g = root(clamp_lo(dot(gx, gy, gx, gy), 1e-20f));
          proj[j] = make_float4(px, py, quo(gx, g), quo(gy, g));
        }
        float qx, qy;
        if (lp2(proj, proj_use, i, vmax, -li.w, li.z, true, a.eps, qx, qy) ==
            i) {
          rx = qx;  // else keep the result: the projected LP failed too
          ry = qy;
        }
        distance = penetration(li, rx, ry);
      }
    }
    a.out[2 * idx] = rx;
    a.out[2 * idx + 1] = ry;
  }
  const unsigned slow = __ballot_sync(0xffffffffu, took_lp3);
  if ((threadIdx.x & 31) == 0 && slow)
    atomicAdd(a.lp3, (unsigned long long)__popc(slow));
}

template <int MMAX>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int64_t blocks = (a.n + kThreads - 1) / kThreads;
  orca_velocity_kernel<MMAX><<<(unsigned)blocks, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out[n, 2] = each agent's new velocity. ptrs: the nine operands (float32,
// valid bool); strides: kOperands x kStrides elements; size: kLead leading
// dimensions (outermost first, their product n); 1 <= m <= 64 neighbours;
// lp3: a device int64 that the agents through linearProgram3 are added to.
// Returns the CUDA error code (0 = launched).
int orca_velocity_launch(const void* const* ptrs, const int64_t* strides,
                         const int64_t* size, int64_t n, int m, float inv_th,
                         float inv_dt, float nd_sq, float safety, float eps,
                         float* out, unsigned long long* lp3,
                         void* stream) {
  if (n < 1 || m < 1 || m > 64 || n > (int64_t)kThreads * 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  Args a;
  for (int op = 0; op < kOperands; ++op) {
    a.ptr[op] = ptrs[op];
    for (int s = 0; s < kStrides; ++s)
      a.stride[op][s] = strides[op * kStrides + s];
  }
  for (int d = 0; d < kLead; ++d) a.size[d] = size[d];
  a.n = n;
  a.m = m;
  a.inv_th = inv_th;
  a.inv_dt = inv_dt;
  a.nd_sq = nd_sq;
  a.safety = safety;
  a.eps = eps;
  a.out = out;
  a.lp3 = lp3;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 8) return (int)launch<8>(a, s);
  if (m <= 16) return (int)launch<16>(a, s);
  if (m <= 32) return (int)launch<32>(a, s);
  return (int)launch<64>(a, s);
}

}  // extern "C"
