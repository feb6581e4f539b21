// The f32 arithmetic and the control-point pair pose that kernels K3 and
// K6 share (csrc/ct_scan_block.cu, csrc/ct_pair_block.cu), each built with
// --fmad=false: every multiply, add, subtract and divide a round-to-nearest
// intrinsic, so a value rounds as the plain twins' separate eager ops do.
//
// The pair pose (pair_terms, point_pose, dq_column) is the pose of a point
// or a cloud at factor f between control points a and b ([t, q] each):
// the lerp of the translations, and the slerp of the two rotations
// retracted at a zero tangent, normalized twice, with its Jacobian on the
// six rotation columns of the pair's 18-dim tangent. Its op order is that
// of the plain twin ops/ct_scan_block.py pair_terms and
// point_poses_from_terms; acos, sin and cos run in f64, rounded once to
// f32 (acos64, sin64, cos64), and the Jacobian's quotients are products
// with correctly rounded reciprocals (ROADMAP C17).

#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

__device__ __forceinline__ void cross3(const float a[3], const float b[3], float out[3]) {
  out[0] = sub(mul(a[1], b[2]), mul(a[2], b[1]));
  out[1] = sub(mul(a[2], b[0]), mul(a[0], b[2]));
  out[2] = sub(mul(a[0], b[1]), mul(a[1], b[0]));
}

// f32 of a function evaluated in f64 (the plain twin's rounding, see the
// per-point note of csrc/ct_scan_block.cu).
__device__ __forceinline__ float acos64(float x) { return __double2float_rn(acos(static_cast<double>(x))); }
__device__ __forceinline__ float sin64(float x) { return __double2float_rn(sin(static_cast<double>(x))); }
__device__ __forceinline__ float cos64(float x) { return __double2float_rn(cos(static_cast<double>(x))); }

__device__ __forceinline__ float dot4(const float a[4], const float b[4]) {
  return add(add(add(mul(a[0], b[0]), mul(a[1], b[1])), mul(a[2], b[2])), mul(a[3], b[3]));
}

// t[i] of q * [0, e_k / 2] for k = 0, 1, 2: the tangent of the rotation
// retracted at a zero tangent (quat_multiply(q, quat_from_axis_angle(d)),
// whose Taylor branch moves as [0, d / 2]); column k of the (4 x 3) t.
__device__ __forceinline__ void half_products(const float q[4], float t[4][3]) {
  const float h0 = mul(0.5f, q[0]), h1 = mul(0.5f, q[1]), h2 = mul(0.5f, q[2]), h3 = mul(0.5f, q[3]);
  t[0][0] = -h1; t[1][0] = h0;  t[2][0] = h3;  t[3][0] = -h2;
  t[0][1] = -h2; t[1][1] = -h3; t[2][1] = h0;  t[3][1] = h1;
  t[0][2] = -h3; t[1][2] = h2;  t[2][2] = -h1; t[3][2] = h0;
}

// What a point's pose takes from its control-point pair alone, computed
// once a block (pair_terms).
struct PairTerms {
  float t0[3], dt[3];  // the first translation and the difference of the two
  float a[4], b[4];  // the two rotations, b flipped onto a's hemisphere
  float ta[4][3], tb[4][3];  // their half products (tb flipped with b)
  float dth[6], ds[6];  // d theta and d sin(theta) on the six rotation columns
  float theta, denom;
  float rdenom, rdenom2;  // 1 / denom and 1 / denom^2, each correctly rounded
  int lerp;  // sin(theta) < 1e-6: the weights are the constants 1 - f and f
};

// The pair's terms from control points ca and cb ([t, q] each), in the op
// order of the plain twin (ops/ct_scan_block.py pair_terms).
__device__ void pair_terms(const float* ca, const float* cb, PairTerms& P) {
  for (int i = 0; i < 3; ++i) {
    P.t0[i] = ca[i];
    P.dt[i] = sub(cb[i], ca[i]);
  }
  float a[4] = {ca[3], ca[4], ca[5], ca[6]};
  float b[4] = {cb[3], cb[4], cb[5], cb[6]};
  float ta[4][3], tb[4][3];
  half_products(a, ta);
  half_products(b, tb);
  const float dot = dot4(a, b);
  float tdot[6];
  for (int k = 0; k < 3; ++k) {
    const float ca_k[4] = {ta[0][k], ta[1][k], ta[2][k], ta[3][k]};
    const float cb_k[4] = {tb[0][k], tb[1][k], tb[2][k], tb[3][k]};
    tdot[k] = dot4(b, ca_k);
    tdot[3 + k] = dot4(a, cb_k);
  }
  if (dot < 0.0f) {
    for (int i = 0; i < 4; ++i) {
      b[i] = -b[i];
      for (int k = 0; k < 3; ++k) tb[i][k] = -tb[i][k];
    }
    for (int k = 0; k < 6; ++k) tdot[k] = -tdot[k];
  }
  const float c = fminf(fabsf(dot), 1.0f);  // clip(clip(|dot|, -1, 1), 0, 1)
  const float theta = acos64(c);
  const float s = sin64(theta);
  const bool lerp = s < 1e-6f;
  const float denom = lerp ? 1.0f : s;
  // Tangents: d theta = -d dot / sqrt(1 - c^2) in the slerp branch, 0 in
  // the lerp branch (its weights are constants).
  const float ct = cos64(theta);
  const float root = lerp ? 1.0f : __fsqrt_rn(sub(1.0f, mul(c, c)));
  for (int k = 0; k < 6; ++k) {
    P.dth[k] = lerp ? 0.0f : dvd(-tdot[k], root);
    P.ds[k] = mul(ct, P.dth[k]);
  }
  for (int i = 0; i < 4; ++i) {
    P.a[i] = a[i];
    P.b[i] = b[i];
    for (int k = 0; k < 3; ++k) {
      P.ta[i][k] = ta[i][k];
      P.tb[i][k] = tb[i][k];
    }
  }
  P.theta = theta;
  P.denom = denom;
  P.rdenom = __frcp_rn(denom);
  P.rdenom2 = __frcp_rn(mul(denom, denom));
  P.lerp = lerp;
}

// A point's pose (t, q) and what the columns of its rotation Jacobian take
// from it: the weights and angles, and the two normalizations' inputs.
struct PointPose {
  float t[3], q[4];  // q = x1 / n2
  float x1[4], r1, r2;  // x1 = x / n1, the slerp normalized once; 1 / n1, 1 / n2
  float g, wa, wb, sa, sb, cua, cub;
};

// The pose of a point at factor f on the pair P (in shared memory: every
// thread reads the same words), in the op order of the plain twin
// (ops/ct_scan_block.py point_poses_from_terms): the lerp of t; the slerp
// of the rotations retracted at a zero tangent, normalized twice.
__device__ __forceinline__ void point_pose(const PairTerms& P, float f, PointPose& o) {
  for (int i = 0; i < 3; ++i) o.t[i] = add(P.t0[i], mul(f, P.dt[i]));
  o.g = sub(1.0f, f);
  o.wa = o.g;
  o.wb = f;
  o.sa = o.sb = o.cua = o.cub = 0.0f;
  if (!P.lerp) {  // one branch for the whole block: the pair decides it
    const float ua = mul(o.g, P.theta), ub = mul(f, P.theta);
    o.sa = sin64(ua);
    o.sb = sin64(ub);
    o.cua = cos64(ua);
    o.cub = cos64(ub);
    o.wa = dvd(o.sa, P.denom);
    o.wb = dvd(o.sb, P.denom);
  }
  float x[4];
  for (int i = 0; i < 4; ++i) x[i] = add(mul(o.wa, P.a[i]), mul(o.wb, P.b[i]));
  const float n1 = __fsqrt_rn(dot4(x, x));  // quat_slerp's normalize
  for (int i = 0; i < 4; ++i) o.x1[i] = dvd(x[i], n1);
  const float n2 = __fsqrt_rn(dot4(o.x1, o.x1));  // _quat_of's
  for (int i = 0; i < 4; ++i) o.q[i] = dvd(o.x1[i], n2);
  o.r1 = __frcp_rn(n1);
  o.r2 = __frcp_rn(n2);
}

// Column k of dq, q's Jacobian on the pair tangent's rotation columns
// (first control point's 3, then the second's): the slerp's tangent, then
// through both normalizations (y = x / |x|: tx -> (tx - y (y . tx)) / |x|),
// in the twin's op order. The Jacobian does not pick cells, so its
// quotients are products with the divisor's correctly rounded reciprocal
// (1 / denom and 1 / denom^2 once a pair, 1 / |x| twice a point), where the
// pose and the twin keep their IEEE divisions: 4 reciprocals instead of 72
// divisions a point. One column at a time keeps the code short.
__device__ __forceinline__ void dq_column(const PairTerms& P, const PointPose& o, float f, int k, float col[4]) {
  float dwa = 0.0f, dwb = 0.0f;
  if (!P.lerp) {
    const float dth = P.dth[k], ds = P.ds[k];
    dwa = sub(mul(mul(o.cua, mul(o.g, dth)), P.rdenom), mul(mul(o.sa, ds), P.rdenom2));
    dwb = sub(mul(mul(o.cub, mul(f, dth)), P.rdenom), mul(mul(o.sb, ds), P.rdenom2));
  }
  for (int i = 0; i < 4; ++i) {
    const float own = k < 3 ? mul(o.wa, P.ta[i][k]) : mul(o.wb, P.tb[i][k - 3]);
    col[i] = add(add(mul(dwa, P.a[i]), mul(dwb, P.b[i])), own);
  }
  const float yt1 = dot4(o.x1, col);
  for (int i = 0; i < 4; ++i) col[i] = mul(sub(col[i], mul(o.x1[i], yt1)), o.r1);
  const float yt2 = dot4(o.q, col);
  for (int i = 0; i < 4; ++i) col[i] = mul(sub(col[i], mul(o.q[i], yt2)), o.r2);
}

}  // namespace
