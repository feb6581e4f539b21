// K7: the whole Levenberg-Marquardt solve of the 2D scan matcher's
// Gauss-Newton refinement, for B lanes in one launch.
//
// Replaces the eager loop of
// hectorgrapher_tpu_torch/mapping/scan_matching/gn_2d.py, _lm_rows_plain,
// which is this kernel's plain twin (the JAX package runs it as a
// jax.lax.while_loop in XLA, gn_2d.py :82-219; no Pallas source). The twin
// launches ~300 kernels an iteration and reads its stop test on the host
// each step; this kernel is one launch a solve and reads nothing back.
//
// Inputs, lane b of B, slot n of N (the twin's names): rows, one plane
// (the occupied-space cost: probabilities) or two (the TSDF cost: tsd and
// weight), (B, N, W * W) f32, the wide rows gathered once at the initial
// pose, lane dx * W + dy; base (B, N, 2) f32, the cell of each row's (0, 0)
// lane; pts (B, N, 2) f32, valid (B, N) bool, scale (B,) f32, min_corner
// (B, 2) f32, res (B,) f32, pose0 (B, 3) f32 (tx, ty, theta), target (B,
// 2) f32; tw2, rw2 the squared translation and rotation weights; the
// iteration limit and the LM constants. Writes pose (B, 3), cost (B,) and
// the iterations each lane ran (B,) int32.
//
// The solve is _lm_rows_plain's, rule for rule: the residual of a point at
// a pose is its cost's value at u = (R p + t - min) / res - 0.5 through
// the Catmull-Rom weights of the lanes at u - base - lane (1 - P for the
// occupied space; the tsd gated by the interpolated weight > 1e-6 for the
// TSDF), times the lane's scale where the point is valid; the cost adds the
// translation and rotation penalties. An iteration builds J^T J and g at
// the current pose (the TSDF's gradient gated by the weight at that pose),
// solves the damped 3x3 by the adjugate (_solve3_sym), evaluates the cost
// at the trial pose, accepts on a decrease, scales lambda by 0.33 or 4
// within its limits and stops the lane once an accepted step decreased the
// cost by at most function_tolerance * cost, or the step's norm is at most
// 1e-7 (|x| + 1e-7), x the pose before the step. The twin carries each
// point's residual and gate from the pose's evaluation; the kernel
// evaluates them again at the current pose, the same operations on the
// same inputs, so the same bits.
//
// Arithmetic: f32 under the library's --fmad=false, every multiply, add,
// subtract and divide a round-to-nearest intrinsic in the twin's op order;
// cosf and sinf where the twin calls torch.cos and torch.sin. A point's
// contraction reads only its 4 x 4 live taps: the Catmull-Rom weight is
// exactly 0 at |d| >= 2, so the twin's other W * W - 16 lanes add exact
// zeros. The sums (a point's 16 taps, the points of a lane) run in a fixed
// order of their own, not torch's: the kernel agrees with the twin to
// rounding, not bit for bit (chip_smoke.py check_k7, phases 5, 6, 20 and
// 22b: the cost within 1e-4 relative, the pose within 1e-4 m and rad where
// both stopped at one iteration; a stop test or accept that rounding
// decides may send a lane down another path). Masked points are skipped;
// they add 0 in the twin.
//
// What bounds it on the H100: latency. A lane is a chain of at most
// num_iterations dependent iterations, each two passes over the lane's
// points with a block reduction after each. At the front end's shape (B =
// 1, N = 2048, ~200-1,300 valid points, 20 iterations) a call reads under
// 0.3 MB of live taps and points (under 0.1 us at 3.35 TB/s) and executes
// a few MFLOP (under 0.2 us at 67 TFLOP/s); it takes ~0.42 ms, ~21 us an
// iteration (chip_smoke.py phase 6).
//
// Design: one block a lane, kThreads threads striding over its N slots.
// Each thread sums its points in slot order, a shuffle tree sums each
// warp, and every thread adds the kWarps warp sums in warp order from
// shared memory: no atomics, and every thread holds the same sums, so each
// computes the lane's solve and update itself (the same bits) and the
// block leaves its loop together. A block reads only its own lane, so a
// lane's result does not depend on B (ROADMAP C31).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

// torch.clamp: NaN stays NaN.
__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }
__device__ __forceinline__ float clamp_max(float x, float hi) { return x > hi ? hi : x; }

// gn_2d._catmull: the Catmull-Rom weight K(d) and K'(d), 0 at |d| >= 2.
__device__ __forceinline__ void catmull(float d, float& k, float& dk) {
  const float t = fabsf(d);
  const float k_near = add(mul(mul(sub(mul(1.5f, t), 2.5f), t), t), 1.0f);
  const float k_far = add(mul(sub(mul(add(mul(-0.5f, t), 2.5f), t), 4.0f), t), 2.0f);
  k = t < 1.0f ? k_near : (t < 2.0f ? k_far : 0.0f);
  const float dk_near = mul(sub(mul(4.5f, t), 5.0f), t);
  const float dk_far = sub(mul(add(mul(-1.5f, t), 5.0f), t), 4.0f);
  const float sign = d > 0.0f ? 1.0f : (d < 0.0f ? -1.0f : 0.0f);  // torch.sign
  dk = mul(sign, t < 1.0f ? dk_near : (t < 2.0f ? dk_far : 0.0f));
}

// The four lanes of one axis whose weight can be nonzero at f = u - base:
// lanes first .. first + 3, first = floor(f) - 1; k = dk = 0 for a lane
// outside the row (0 .. w - 1), and for all four where f lies too far out
// for any (or is NaN).
struct Taps {
  int first;
  float k[4], dk[4];
};

__device__ __forceinline__ void taps(float f, int w, Taps& t) {
  const float fl = floorf(f);
  const bool any = fl >= -2.0f && fl <= static_cast<float>(w);
  t.first = any ? static_cast<int>(fl) - 1 : 0;
  for (int i = 0; i < 4; ++i) {
    const int lane = t.first + i;
    t.k[i] = 0.0f;
    t.dk[i] = 0.0f;
    if (any && lane >= 0 && lane < w) catmull(sub(f, static_cast<float>(lane)), t.k[i], t.dk[i]);
  }
}

// A lane's pose as its points read it: the translation, theta, and cos and
// sin of theta.
struct Pose {
  float tx, ty, th, c, s;
};

__device__ __forceinline__ Pose make_pose(float tx, float ty, float th) {
  return Pose{tx, ty, th, cosf(th), sinf(th)};
}

// What a lane's block reads: its rows, cells, points and flags, and its
// scale, grid corner and resolution.
struct LaneIn {
  const float* prob;  // the first plane's rows of the lane (probability or tsd)
  const float* weight;  // the weight plane's rows, nullptr for one plane
  const float* base;
  const float* pts;
  const uint8_t* valid;
  float scale, mcx, mcy, res;
  int n, w;
};

// The contraction sum over the live taps of plane * (ax[a] * ay[b]), in
// tap order (a outer).
__device__ __forceinline__ float contract(const float* __restrict__ row, int w, const Taps& x, const float* ax,
                                          const Taps& y, const float* ay) {
  float s = 0.0f;
  for (int i = 0; i < 4; ++i) {
    const int a = x.first + i;
    if (a < 0 || a >= w) continue;
    for (int j = 0; j < 4; ++j) {
      const int b = y.first + j;
      if (b < 0 || b >= w) continue;
      s = add(s, mul(__ldg(row + a * w + b), mul(ax[i], ay[j])));
    }
  }
  return s;
}

// Point n's taps at pose p: u = (R p + t - min) / res - 0.5, f = u - base.
__device__ __forceinline__ void point_taps(const LaneIn& in, int n, const Pose& p, float px, float py, Taps& x,
                                           Taps& y) {
  const float wx = add(sub(mul(p.c, px), mul(p.s, py)), p.tx);
  const float wy = add(add(mul(p.s, px), mul(p.c, py)), p.ty);
  const float ux = sub(dvd(sub(wx, in.mcx), in.res), 0.5f);
  const float uy = sub(dvd(sub(wy, in.mcy), in.res), 0.5f);
  taps(sub(ux, __ldg(in.base + 2 * n)), in.w, x);
  taps(sub(uy, __ldg(in.base + 2 * n + 1)), in.w, y);
}

// The cost's value at a point and the TSDF's weight gate (1 for the
// occupied space): _ProbabilityCost.value, _TsdfCost.value.
template <bool kTsdf>
__device__ __forceinline__ float value(const LaneIn& in, const float* row0, const float* row1, const Taps& x,
                                       const Taps& y, float& gate) {
  if (kTsdf) {
    gate = contract(row1, in.w, x, x.k, y, y.k) > 1e-6f ? 1.0f : 0.0f;
    return mul(contract(row0, in.w, x, x.k, y, y.k), gate);
  }
  gate = 1.0f;
  return sub(1.0f, contract(row0, in.w, x, x.k, y, y.k));
}

// The sum of v over the block, in a fixed order, in every thread. Each
// warp's shuffle tree, then the warp sums in warp order from `smem`.
template <int K>
__device__ __forceinline__ void block_sum(float (&v)[K], float (*smem)[kWarps]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int k = 0; k < K; ++k)
    for (int off = 16; off > 0; off >>= 1) v[k] = add(v[k], __shfl_down_sync(0xffffffffu, v[k], off));
  if (lane == 0)
    for (int k = 0; k < K; ++k) smem[k][warp] = v[k];
  __syncthreads();
  for (int k = 0; k < K; ++k) {
    float s = smem[k][0];
    for (int i = 1; i < kWarps; ++i) s = add(s, smem[k][i]);
    v[k] = s;
  }
  __syncthreads();  // before smem is written again
}

// The sum of the squared residuals of the lane's points at pose p.
template <bool kTsdf>
__device__ float residual_sum(const LaneIn& in, const Pose& p, float (*smem)[kWarps]) {
  float acc[1] = {0.0f};
  const int w2 = in.w * in.w;
  for (int n = threadIdx.x; n < in.n; n += kThreads) {
    if (!in.valid[n]) continue;
    const float px = __ldg(in.pts + 2 * n), py = __ldg(in.pts + 2 * n + 1);
    Taps x, y;
    point_taps(in, n, p, px, py, x, y);
    float gate;
    const float r = mul(value<kTsdf>(in, in.prob + static_cast<size_t>(n) * w2,
                                     kTsdf ? in.weight + static_cast<size_t>(n) * w2 : nullptr, x, y, gate),
                        in.scale);
    acc[0] = add(acc[0], mul(r, r));
  }
  block_sum(acc, smem);
  return acc[0];
}

// J^T J's upper triangle (00, 01, 02, 11, 12, 22) and J^T r of the lane's
// points at pose p (normal_equations without the penalties).
template <bool kTsdf>
__device__ void normal_sums(const LaneIn& in, const Pose& p, float (&acc)[9], float (*smem)[kWarps]) {
  for (int k = 0; k < 9; ++k) acc[k] = 0.0f;
  const int w2 = in.w * in.w;
  // dR/dtheta p: rot2(theta + pi / 2, p).
  const float th2 = add(p.th, 1.57079637f);  // f32(pi / 2), as torch adds the Python float
  const float c2 = cosf(th2), s2 = sinf(th2);
  for (int n = threadIdx.x; n < in.n; n += kThreads) {
    if (!in.valid[n]) continue;
    const float px = __ldg(in.pts + 2 * n), py = __ldg(in.pts + 2 * n + 1);
    Taps x, y;
    point_taps(in, n, p, px, py, x, y);
    const float* row0 = in.prob + static_cast<size_t>(n) * w2;
    float gate;
    const float r = mul(value<kTsdf>(in, row0, kTsdf ? in.weight + static_cast<size_t>(n) * w2 : nullptr, x, y,
                                     gate),
                        in.scale);
    // d value / d frac (_ProbabilityCost.grad negates), gated: the scale,
    // times the TSDF's weight gate.
    float dvx = contract(row0, in.w, x, x.dk, y, y.k), dvy = contract(row0, in.w, x, x.k, y, y.dk);
    if (!kTsdf) {
      dvx = -dvx;
      dvy = -dvy;
    }
    const float g = kTsdf ? mul(in.scale, gate) : in.scale;
    dvx = mul(dvx, g);
    dvy = mul(dvy, g);
    const float dpx = sub(mul(c2, px), mul(s2, py)), dpy = add(mul(s2, px), mul(c2, py));
    const float j0 = dvd(dvx, in.res), j1 = dvd(dvy, in.res);
    const float j2 = dvd(add(mul(dvx, dpx), mul(dvy, dpy)), in.res);
    acc[0] = add(acc[0], mul(j0, j0));
    acc[1] = add(acc[1], mul(j0, j1));
    acc[2] = add(acc[2], mul(j0, j2));
    acc[3] = add(acc[3], mul(j1, j1));
    acc[4] = add(acc[4], mul(j1, j2));
    acc[5] = add(acc[5], mul(j2, j2));
    acc[6] = add(acc[6], mul(j0, r));
    acc[7] = add(acc[7], mul(j1, r));
    acc[8] = add(acc[8], mul(j2, r));
  }
  block_sum(acc, smem);
}

// The lane's cost at pose p from its residual sum: 0.5 (sum r^2 + tw2 |t -
// target|^2 + rw2 (theta - theta0)^2), in terms()' op order.
__device__ __forceinline__ float lane_cost(float sum_r2, const Pose& p, float gx, float gy, float th0, float tw2,
                                           float rw2) {
  const float dx = sub(p.tx, gx), dy = sub(p.ty, gy), dth = sub(p.th, th0);
  return mul(0.5f, add(add(sum_r2, mul(tw2, add(mul(dx, dx), mul(dy, dy)))), mul(mul(rw2, dth), dth)));
}

struct Lm {
  float tw2, rw2, init_lambda, min_lambda, max_lambda, function_tolerance;
  int num_iterations;
};

template <bool kTsdf>
__global__ void __launch_bounds__(kThreads)
gn_2d_lm_kernel(const float* __restrict__ prob, const float* __restrict__ weight, const float* __restrict__ base,
                const float* __restrict__ pts, const uint8_t* __restrict__ valid, const float* __restrict__ scale,
                const float* __restrict__ min_corner, const float* __restrict__ res, const float* __restrict__ pose0,
                const float* __restrict__ target, float* __restrict__ pose_out, float* __restrict__ cost_out,
                int* __restrict__ iterations_out, int n, int w, Lm lm) {
  __shared__ float smem[9][kWarps];
  const int b = blockIdx.x;
  const size_t slots = static_cast<size_t>(b) * n, row = slots * w * w;
  const LaneIn in{prob + row, kTsdf ? weight + row : nullptr, base + 2 * slots, pts + 2 * slots, valid + slots,
                  __ldg(scale + b), __ldg(min_corner + 2 * b), __ldg(min_corner + 2 * b + 1), __ldg(res + b), n, w};
  const float gx = __ldg(target + 2 * b), gy = __ldg(target + 2 * b + 1), th0 = __ldg(pose0 + 3 * b + 2);
  Pose p = make_pose(__ldg(pose0 + 3 * b), __ldg(pose0 + 3 * b + 1), th0);
  float cost = lane_cost(residual_sum<kTsdf>(in, p, smem), p, gx, gy, th0, lm.tw2, lm.rw2);
  float lam = lm.init_lambda;
  bool done = false;
  int it = 0;
  for (; it < lm.num_iterations && !done; ++it) {
    float s[9];
    normal_sums<kTsdf>(in, p, s, smem);
    const float dx = sub(p.tx, gx), dy = sub(p.ty, gy), dth = sub(p.th, th0);
    // J^T J + diag(tw2, tw2, rw2), damped: + lam * max(diag, 1e-12) + 1e-12.
    const float d0 = add(s[0], lm.tw2), d1 = add(s[3], lm.tw2), d2 = add(s[5], lm.rw2);
    const float a00 = add(add(d0, mul(lam, clamp_min(d0, 1e-12f))), 1e-12f);
    const float a11 = add(add(d1, mul(lam, clamp_min(d1, 1e-12f))), 1e-12f);
    const float a22 = add(add(d2, mul(lam, clamp_min(d2, 1e-12f))), 1e-12f);
    const float a01 = s[1], a02 = s[2], a12 = s[4];
    const float g0 = add(s[6], mul(lm.tw2, dx)), g1 = add(s[7], mul(lm.tw2, dy)), g2 = add(s[8], mul(lm.rw2, dth));
    // _solve3_sym: the adjugate over the determinant.
    const float c00 = sub(mul(a11, a22), mul(a12, a12));
    const float c01 = sub(mul(a02, a12), mul(a01, a22));
    const float c02 = sub(mul(a01, a12), mul(a02, a11));
    const float c11 = sub(mul(a00, a22), mul(a02, a02));
    const float c12 = sub(mul(a01, a02), mul(a00, a12));
    const float c22 = sub(mul(a00, a11), mul(a01, a01));
    const float det = add(add(mul(a00, c00), mul(a01, c01)), mul(a02, c02));
    const float inv_det = dvd(1.0f, fabsf(det) > 1e-20f ? det : 1e-20f);
    const float x0 = -mul(add(add(mul(c00, g0), mul(c01, g1)), mul(c02, g2)), inv_det);
    const float x1 = -mul(add(add(mul(c01, g0), mul(c11, g1)), mul(c12, g2)), inv_det);
    const float x2 = -mul(add(add(mul(c02, g0), mul(c12, g1)), mul(c22, g2)), inv_det);
    const Pose trial = make_pose(add(p.tx, x0), add(p.ty, x1), add(p.th, x2));
    const float cost_new = lane_cost(residual_sum<kTsdf>(in, trial, smem), trial, gx, gy, th0, lm.tw2, lm.rw2);
    const bool accept = cost_new < cost;
    const float x_norm = sqrtf(add(add(mul(p.tx, p.tx), mul(p.ty, p.ty)), mul(p.th, p.th)));
    const float step = sqrtf(add(add(mul(x0, x0), mul(x1, x1)), mul(x2, x2)));
    done = (accept && sub(cost, cost_new) <= mul(lm.function_tolerance, cost)) ||
           step <= mul(1e-7f, add(x_norm, 1e-7f));
    lam = accept ? clamp_min(mul(lam, 0.33f), lm.min_lambda) : clamp_max(mul(lam, 4.0f), lm.max_lambda);
    if (accept) {
      p = trial;
      cost = cost_new;
    }
  }
  if (threadIdx.x == 0) {
    pose_out[3 * b] = p.tx;
    pose_out[3 * b + 1] = p.ty;
    pose_out[3 * b + 2] = p.th;
    cost_out[b] = cost;
    iterations_out[b] = it;
  }
}

}  // namespace

// B lanes of n point slots each, w x w lanes a wide row: prob (B, n, w w)
// f32 (the tsd plane where `weight` is given), weight (B, n, w w) f32 or
// null (one plane: the occupied-space cost; two: the TSDF cost); base,
// pts (B, n, 2) f32; valid (B, n) bool; scale (B,); min_corner (B, 2); res
// (B,); pose0 (B, 3); target (B, 2) f32. Writes pose (B, 3), cost (B,) f32
// and iterations (B,) int32. Returns the launch's cudaGetLastError().
extern "C" int hg_gn_2d_lm(const float* prob, const float* weight, const float* base, const float* pts,
                           const uint8_t* valid, const float* scale, const float* min_corner, const float* res,
                           const float* pose0, const float* target, float* pose, float* cost, int* iterations,
                           int b, int n, int w, int num_iterations, float tw2, float rw2, float init_lambda,
                           float min_lambda, float max_lambda, float function_tolerance, void* stream) {
  if (b < 1 || n < 1 || w < 4 || num_iterations < 0) return static_cast<int>(cudaErrorInvalidValue);
  const Lm lm{tw2, rw2, init_lambda, min_lambda, max_lambda, function_tolerance, num_iterations};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (weight != nullptr)
    gn_2d_lm_kernel<true><<<b, kThreads, 0, s>>>(prob, weight, base, pts, valid, scale, min_corner, res, pose0,
                                                 target, pose, cost, iterations, n, w, lm);
  else
    gn_2d_lm_kernel<false><<<b, kThreads, 0, s>>>(prob, weight, base, pts, valid, scale, min_corner, res, pose0,
                                                  target, pose, cost, iterations, n, w, lm);
  return static_cast<int>(cudaGetLastError());
}
