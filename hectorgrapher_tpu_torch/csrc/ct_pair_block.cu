// K6: the pair residuals and the cloud poses of a CT window solve's LM
// assembly, with their Jacobians on each block's 18-dim pair tangent.
//
// Replaces the eager forward-mode chains of
// hectorgrapher_tpu_torch/mapping/ct/window_solver.py, pair_residuals_plain
// and cloud_poses_plain (the JAX package takes these Jacobians with
// jax.jacfwd inside an XLA fusion, window_solver.py :488 and :566; no
// Pallas source). The eager twins launch ~1,040 kernels an assembly at
// the front end's shape; this library launches two.
//
// hg_ct_pair_residuals: for each control-point pair (a, b) = (p, p + 1) of
// each window, the 15 residuals r of the live-preintegration IMU term
// (translation, velocity, rotation error, each scaled by its CtWeights
// weight) and the odometry term (the relative translation error and the
// roll, pitch and yaw of the relative rotation error, scaled by the
// pair's odometry weights), each term multiplied by its mask, and J (15 x
// 18), their Jacobian on the pair tangent [dt_a, dtheta_a, dv_a, dt_b,
// dtheta_b, dv_b]: both rotations are retracted at a zero tangent,
// normalize(q * exp(d)), whose tangent at d = 0 is q * [0, e_k / 2] through
// the normalization.
//
// hg_ct_cloud_poses: for each cloud, pose7 = [t, q] between its bracketing
// control points at its factor and dpose7 (7 x 18), the pair pose of
// ct_pose.cuh (K3's per-point pose, shared: the lerp of t, the slerp of
// the rotations retracted at a zero tangent, normalized twice).
//
// Arithmetic. Both entries run f32 under the library's --fmad=false, every
// multiply, add, subtract and divide a round-to-nearest intrinsic. The
// pair residuals follow their eager twin op for op (its sums of four or
// three terms left to right), with atan2f, asinf and __fsqrt_rn where the
// twin calls torch.atan2, torch.arcsin and torch.sqrt / vector_norm. The
// cloud poses are K3's pair pose as it stands (ROADMAP C17): acos, sin and
// cos in f64 rounded once to f32 (acos64, sin64, cos64), the Jacobian's
// quotients products with correctly rounded reciprocals, and the rotations
// retracted without the twin's normalization (a state's rotations are unit
// quaternions, so that changes q by about an ulp). Neither twin is matched
// bit for bit (torch's reductions and library calls round in their own
// ways); chip_smoke.py phase 7 holds each output to its twin within a
// per-entry tolerance, and two launches to the same bits. The masks
// multiply, never branch, so a non-finite input gives a non-finite output
// where the twin's does.
//
// What bounds it on the H100: latency. At the front end's shape (K = C =
// 32: 31 pairs, 32 clouds) a call moves 38 KB (pairs) or 18 KB (clouds),
// 0.011 or 0.005 us at 3.35 TB/s, and executes 0.46 or 0.10 MFLOP; it
// takes ~4 us, one warp's chain of dependent ops (chip_smoke.py phase 7).
//
// Design: one warp per pair or cloud, lane j < 18 one tangent column j.
// Every lane computes the block's values (the same ops on the same
// inputs, so the same bits), then carries its column's tangent through
// the chain: the eager twin's (..., 18, n) tangent tensors, one column a
// lane. Lane j writes column j of every row (18 adjacent floats a row),
// lanes 0-14 the residuals, lanes 0-6 the pose. No lane reads another's
// work and no block sums anything, so a block's result does not depend on
// the batch around it (ROADMAP C31): B windows in one launch give each
// window the bits of a launch for it alone.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ct_pose.cuh"

namespace {

constexpr int kWarps = 4;  // pairs or clouds a block
constexpr int kCols = 18;  // the pair tangent: [dt_a, dtheta_a, dv_a, dt_b, dtheta_b, dv_b]
constexpr int kRes = 15;  // IMU translation, velocity, rotation (3 each); odometry translation, rpy

// 1 where column j is the pair tangent's column `col`, else 0 (a unit
// tangent's entry).
__device__ __forceinline__ float unit(int j, int col) { return j == col ? 1.0f : 0.0f; }

// torch.clamp: NaN stays NaN.
__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }
__device__ __forceinline__ float clamp(float x, float lo, float hi) { return x < lo ? lo : (x > hi ? hi : x); }

// quat_multiply (transform/rigid.py), a * b in its op order.
__device__ __forceinline__ void qmul(const float a[4], const float b[4], float o[4]) {
  o[0] = sub(sub(sub(mul(a[0], b[0]), mul(a[1], b[1])), mul(a[2], b[2])), mul(a[3], b[3]));
  o[1] = sub(add(add(mul(a[0], b[1]), mul(a[1], b[0])), mul(a[2], b[3])), mul(a[3], b[2]));
  o[2] = add(add(sub(mul(a[0], b[2]), mul(a[1], b[3])), mul(a[2], b[0])), mul(a[3], b[1]));
  o[3] = add(sub(add(mul(a[0], b[3]), mul(a[1], b[2])), mul(a[2], b[1])), mul(a[3], b[0]));
}

__device__ __forceinline__ void conj(const float q[4], float o[4]) {
  o[0] = q[0];
  o[1] = -q[1];
  o[2] = -q[2];
  o[3] = -q[3];
}

// Tangent of a product of two moving quaternions (_jmul): ta * b + a * tb.
__device__ __forceinline__ void dqmul(const float a[4], const float ta[4], const float b[4], const float tb[4],
                                      float o[4]) {
  float u[4], v[4];
  qmul(ta, b, u);
  qmul(a, tb, v);
  for (int i = 0; i < 4; ++i) o[i] = add(u[i], v[i]);
}

// _retract_rotation: y = normalize(q * exp(0)) and column j of its tangent,
// the rotation's tangent columns col..col + 2: (tx - y (y . tx)) / |x|, tx
// = q * [0, e / 2] (_jnormalize).
__device__ __forceinline__ void retract(const float q[4], int col, int j, float y[4], float ty[4]) {
  const float one[4] = {1.0f, 0.0f, 0.0f, 0.0f};  // quat_from_axis_angle(0), its Taylor branch
  float x[4];
  qmul(q, one, x);
  const float n = __fsqrt_rn(dot4(x, x));
  for (int i = 0; i < 4; ++i) y[i] = dvd(x[i], n);
  const float half[4] = {0.0f, mul(0.5f, unit(j, col)), mul(0.5f, unit(j, col + 1)), mul(0.5f, unit(j, col + 2))};
  float tx[4];
  qmul(q, half, tx);
  const float s = dot4(y, tx);
  for (int i = 0; i < 4; ++i) ty[i] = dvd(sub(tx[i], mul(y[i], s)), n);
}

// _jrotate: v' = v + 2 (w (u x v) + u x (u x v)) and its tangent.
__device__ __forceinline__ void jrotate(const float q[4], const float tq[4], const float v[3], const float tv[3],
                                        float o[3], float to[3]) {
  const float u[3] = {q[1], q[2], q[3]}, du[3] = {tq[1], tq[2], tq[3]};
  float uv[3], uuv[3], a[3], b[3], duv[3], duuv[3];
  cross3(u, v, uv);
  cross3(du, v, a);
  cross3(u, tv, b);
  for (int i = 0; i < 3; ++i) duv[i] = add(a[i], b[i]);
  cross3(u, uv, uuv);
  cross3(du, uv, a);
  cross3(u, duv, b);
  for (int i = 0; i < 3; ++i) duuv[i] = add(a[i], b[i]);
  for (int i = 0; i < 3; ++i) {
    o[i] = add(v[i], mul(2.0f, add(mul(q[0], uv[i]), uuv[i])));
    to[i] = add(tv[i], mul(2.0f, add(add(mul(tq[0], uv[i]), mul(q[0], duv[i])), duuv[i])));
  }
}

// Tangent of atan2(y, x) (_datan2).
__device__ __forceinline__ float datan2(float y, float ty, float x, float tx) {
  return dvd(sub(mul(x, ty), mul(y, tx)), add(mul(x, x), mul(y, y)));
}

// _rpy_of_quat with its tangent (_jrpy).
__device__ __forceinline__ void jrpy(const float q[4], const float tq[4], float o[3], float to[3]) {
  const float w = q[0], x = q[1], y = q[2], z = q[3];
  const float dw = tq[0], dx = tq[1], dy = tq[2], dz = tq[3];
  const float ry = mul(2.0f, add(mul(w, x), mul(y, z)));
  const float rx = sub(1.0f, mul(2.0f, add(mul(x, x), mul(y, y))));
  const float sp = mul(2.0f, sub(mul(w, y), mul(z, x)));
  const float yy = mul(2.0f, add(mul(w, z), mul(x, y)));
  const float yx = sub(1.0f, mul(2.0f, add(mul(y, y), mul(z, z))));
  o[0] = atan2f(ry, rx);
  o[1] = asinf(clamp(sp, -1.0f, 1.0f));
  o[2] = atan2f(yy, yx);
  to[0] = datan2(ry, mul(2.0f, add(add(add(mul(dw, x), mul(w, dx)), mul(dy, z)), mul(y, dz))), rx,
                 mul(-2.0f, add(mul(mul(2.0f, x), dx), mul(mul(2.0f, y), dy))));
  to[1] = dvd(mul(2.0f, sub(sub(add(mul(dw, y), mul(w, dy)), mul(dz, x)), mul(z, dx))),
              __fsqrt_rn(clamp_min(sub(1.0f, mul(sp, sp)), 1e-30f)));
  to[2] = datan2(yy, mul(2.0f, add(add(add(mul(dw, z), mul(w, dz)), mul(dx, y)), mul(x, dy))), yx,
                 mul(-2.0f, add(mul(mul(2.0f, y), dy), mul(mul(2.0f, z), dz))));
}

// What one pair's residuals read (window_solver.py CtProblem's per-pair
// fields, the two control points' states, CtWeights' three IMU weights).
struct PairIn {
  float ta[3], tb[3], va[3], vb[3], qa[4], qb[4];
  float dt, m_imu, m_odom, wt, wr;  // pair_dt, the masks as 0 / 1, the odometry weights
  float imu_dq[4], odom_dt[3], odom_dq[4];
  float w_t, w_v, w_r;  // translation_weight, velocity_weight, rotation_weight
};

// The pair's residuals r and column j of their Jacobian, in the op order
// of window_solver.py pair_residuals_plain (the preintegration form).
__device__ __forceinline__ void pair_block(const PairIn& in, int j, float r[kRes], float jc[kRes]) {
  float q0[4], tq0[4], q1[4], tq1[4];
  retract(in.qa, 3, j, q0, tq0);
  retract(in.qb, 12, j, q1, tq1);

  // IMU: translation, velocity and rotation errors.
  float c1[4], dc1[4], m1[4], dm1[4], eq[4], deq[4];
  conj(q1, c1);
  conj(tq1, dc1);
  qmul(c1, q0, m1);
  dqmul(c1, dc1, q0, tq0, dm1);
  qmul(m1, in.imu_dq, eq);
  qmul(dm1, in.imu_dq, deq);
  for (int i = 0; i < 3; ++i) {
    const float te = sub(sub(in.tb[i], in.ta[i]), mul(in.dt, in.va[i]));
    const float dte = sub(sub(unit(j, 9 + i), unit(j, i)), mul(in.dt, unit(j, 6 + i)));
    const float ve = sub(in.vb[i], in.va[i]);
    const float dve = sub(unit(j, 15 + i), unit(j, 6 + i));
    r[i] = mul(mul(in.w_t, te), in.m_imu);
    jc[i] = mul(mul(in.w_t, dte), in.m_imu);
    r[3 + i] = mul(mul(in.w_v, ve), in.m_imu);
    jc[3 + i] = mul(mul(in.w_v, dve), in.m_imu);
    r[6 + i] = mul(mul(in.w_r, eq[1 + i]), in.m_imu);
    jc[6 + i] = mul(mul(in.w_r, deq[1 + i]), in.m_imu);
  }

  // Odometry: the relative pose's error against the odometry's.
  float c0[4], dc0[4], rq[4], drq[4];
  conj(q0, c0);
  conj(tq0, dc0);
  qmul(c0, q1, rq);
  dqmul(c0, dc0, q1, tq1, drq);
  float v[3], tv[3], rt[3], drt[3];
  for (int i = 0; i < 3; ++i) {
    v[i] = sub(in.tb[i], in.ta[i]);
    tv[i] = sub(unit(j, 9 + i), unit(j, i));
  }
  jrotate(c0, dc0, v, tv, rt, drt);
  float crq[4], dcrq[4], oq[4], doq[4];
  conj(rq, crq);
  conj(drq, dcrq);
  qmul(crq, in.odom_dq, oq);
  qmul(dcrq, in.odom_dq, doq);
  float ov[3], dov[3], ot[3], dot_[3];
  for (int i = 0; i < 3; ++i) {
    ov[i] = sub(in.odom_dt[i], rt[i]);
    dov[i] = -drt[i];
  }
  jrotate(crq, dcrq, ov, dov, ot, dot_);
  float rpy[3], drpy[3];
  jrpy(oq, doq, rpy, drpy);
  for (int i = 0; i < 3; ++i) {
    r[9 + i] = mul(mul(in.wt, ot[i]), in.m_odom);
    jc[9 + i] = mul(mul(in.wt, dot_[i]), in.m_odom);
    r[12 + i] = mul(mul(in.wr, rpy[i]), in.m_odom);
    jc[12 + i] = mul(mul(in.wr, drpy[i]), in.m_odom);
  }
}

__device__ __forceinline__ void load(const float* __restrict__ p, int n, float* o) {
  for (int i = 0; i < n; ++i) o[i] = __ldg(p + i);
}

// Pair i of n: window b = i / (k - 1), its pair p, control points b k + p
// and b k + p + 1 of t (B k, 3), q (B k, 4), v (B k, 3).
__global__ void __launch_bounds__(32 * kWarps)
ct_pair_residuals_kernel(const float* __restrict__ t, const float* __restrict__ q, const float* __restrict__ v,
                         const float* __restrict__ pair_dt, const uint8_t* __restrict__ pair_mask,
                         const float* __restrict__ imu_dq, const uint8_t* __restrict__ odom_mask,
                         const float* __restrict__ odom_dt, const float* __restrict__ odom_dq,
                         const float* __restrict__ odom_wt, const float* __restrict__ odom_wr,
                         const float* __restrict__ w_t, const float* __restrict__ w_v,
                         const float* __restrict__ w_r, float* __restrict__ r_out, float* __restrict__ J_out, int n,
                         int k) {
  const int i = blockIdx.x * kWarps + (threadIdx.x >> 5), j = threadIdx.x & 31;
  if (i >= n || j >= kCols) return;
  const int a = (i / (k - 1)) * k + i % (k - 1);
  PairIn in;
  load(t + 3 * a, 3, in.ta);
  load(t + 3 * (a + 1), 3, in.tb);
  load(v + 3 * a, 3, in.va);
  load(v + 3 * (a + 1), 3, in.vb);
  load(q + 4 * a, 4, in.qa);
  load(q + 4 * (a + 1), 4, in.qb);
  in.dt = __ldg(pair_dt + i);
  in.m_imu = __ldg(pair_mask + i) ? 1.0f : 0.0f;
  in.m_odom = __ldg(odom_mask + i) ? 1.0f : 0.0f;
  in.wt = __ldg(odom_wt + i);
  in.wr = __ldg(odom_wr + i);
  load(imu_dq + 4 * i, 4, in.imu_dq);
  load(odom_dt + 3 * i, 3, in.odom_dt);
  load(odom_dq + 4 * i, 4, in.odom_dq);
  in.w_t = __ldg(w_t);
  in.w_v = __ldg(w_v);
  in.w_r = __ldg(w_r);
  float r[kRes], jc[kRes];
  pair_block(in, j, r, jc);
  float* J = J_out + static_cast<size_t>(i) * kRes * kCols;
  for (int row = 0; row < kRes; ++row) J[row * kCols + j] = jc[row];
  if (j < kRes) r_out[static_cast<size_t>(i) * kRes + j] = r[j];
}

// Cloud i of n: window b = i / c, its control points b k + prev[i] and
// b k + next[i] (int64 indices where idx64, else int32).
__global__ void __launch_bounds__(32 * kWarps)
ct_cloud_poses_kernel(const float* __restrict__ t, const float* __restrict__ q, const void* __restrict__ prev,
                      const void* __restrict__ next, const float* __restrict__ factor, float* __restrict__ pose7,
                      float* __restrict__ dpose7, int n, int c, int k, int idx64) {
  const int i = blockIdx.x * kWarps + (threadIdx.x >> 5), j = threadIdx.x & 31;
  if (i >= n || j >= kCols) return;
  const int base = (i / c) * k;
  const int pa = idx64 ? static_cast<int>(static_cast<const int64_t*>(prev)[i]) : static_cast<const int*>(prev)[i];
  const int pb = idx64 ? static_cast<int>(static_cast<const int64_t*>(next)[i]) : static_cast<const int*>(next)[i];
  float ca[7], cb[7];
  load(t + 3 * (base + pa), 3, ca);
  load(q + 4 * (base + pa), 4, ca + 3);
  load(t + 3 * (base + pb), 3, cb);
  load(q + 4 * (base + pb), 4, cb + 3);
  const float f = __ldg(factor + i);
  PairTerms P;
  pair_terms(ca, cb, P);
  PointPose o;
  point_pose(P, f, o);
  float* D = dpose7 + static_cast<size_t>(i) * 7 * kCols;
  for (int row = 0; row < 3; ++row) D[row * kCols + j] = add(mul(o.g, unit(j, row)), mul(f, unit(j, 9 + row)));
  float col[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if ((j >= 3 && j < 6) || (j >= 12 && j < 15)) dq_column(P, o, f, j < 6 ? j - 3 : j - 9, col);
  for (int row = 0; row < 4; ++row) D[(3 + row) * kCols + j] = col[row];
  if (j < 3) pose7[static_cast<size_t>(i) * 7 + j] = o.t[j];
  else if (j < 7) pose7[static_cast<size_t>(i) * 7 + j] = o.q[j - 3];
}

int blocks(int n) { return (n + kWarps - 1) / kWarps; }

}  // namespace

// B windows of k control points each: t (B k, 3), q (B k, 4), v (B k, 3)
// f32; per pair (n = B (k - 1) of them, window-major): pair_dt (n,) f32,
// pair_mask (n,) bool, imu_dq (n, 4), odom_mask (n,) bool, odom_dt (n, 3),
// odom_dq (n, 4), odom_wt, odom_wr (n,) f32; w_t, w_v, w_r one f32 each on
// the device (CtWeights' translation, velocity and rotation weights).
// Writes r (n, 15) and J (n, 15, 18) f32. Returns the launch's
// cudaGetLastError().
extern "C" int hg_ct_pair_residuals(const float* t, const float* q, const float* v, const float* pair_dt,
                                    const uint8_t* pair_mask, const float* imu_dq, const uint8_t* odom_mask,
                                    const float* odom_dt, const float* odom_dq, const float* odom_wt,
                                    const float* odom_wr, const float* w_t, const float* w_v, const float* w_r,
                                    float* r, float* J, int n, int k, void* stream) {
  if (n < 1 || k < 2) return static_cast<int>(cudaErrorInvalidValue);
  ct_pair_residuals_kernel<<<blocks(n), 32 * kWarps, 0, static_cast<cudaStream_t>(stream)>>>(
      t, q, v, pair_dt, pair_mask, imu_dq, odom_mask, odom_dt, odom_dq, odom_wt, odom_wr, w_t, w_v, w_r, r, J, n, k);
  return static_cast<int>(cudaGetLastError());
}

// B windows of k control points (t (B k, 3), q (B k, 4) f32) and c clouds
// each (n = B c, window-major): prev, next (n,) int32, or int64 where
// idx64, each window's own control-point indices; factor (n,) f32. Writes
// pose7 (n, 7) and dpose7 (n, 7, 18) f32. Returns the launch's
// cudaGetLastError().
extern "C" int hg_ct_cloud_poses(const float* t, const float* q, const void* prev, const void* next,
                                 const float* factor, float* pose7, float* dpose7, int n, int c, int k, int idx64,
                                 void* stream) {
  if (n < 1 || c < 1 || k < 2) return static_cast<int>(cudaErrorInvalidValue);
  ct_cloud_poses_kernel<<<blocks(n), 32 * kWarps, 0, static_cast<cudaStream_t>(stream)>>>(
      t, q, prev, next, factor, pose7, dpose7, n, c, k, idx64);
  return static_cast<int>(cudaGetLastError());
}
