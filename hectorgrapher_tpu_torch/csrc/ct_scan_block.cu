// K3: per-cloud scan-block assembly of the continuous-time window solve.
//
// Replaces the XLA fusion of hectorgrapher_tpu/mapping/ct/window_solver.py
// scan_block (:467-513) plus the per-block einsums of _make_ct_assemble
// (:611-613), over the 3D TSDF stencil of
// hectorgrapher_tpu/mapping/scan_matching/interpolated_grid.py (:332-466).
// It has no Pallas source: on the TPU this is one XLA fusion per LM
// iteration.
//
// For cloud c with interpolated pose (t, q) = pose7[c] and its Jacobian
// dpose7[c] (7 x 18) on the cloud's control-point pair tangent, each point
// p of the hi-res cloud (then of the lo-res cloud, against the lo-res grid)
// gives:
//   world  = R(q) p + t                         (the 15-mul quat_rotate)
//   u      = ((world - min_corner) / res) - 0.5; base = floor(u), f = u - base
//   the 2x2x2 stencil of w and w*tsd, interior cells only (else unknown),
//   blended in x and y per z, then in z, with d/df (_field_and_dfrac);
//   val    = (w*tsd)/w where w > 1e-6 (else 0), d/df by the quotient rule;
//   row7   = [dval/dworld = dval/df / res, dval/dworld . dR(q)p/dq];
//   J      = row7 @ dpose7 * s, r = val * s   (s = scale[c] where masked in)
// and the block sums S = J^T J (18 x 18), g = J^T r, cost = 0.5 sum r^2.
//
// What bounds it on the H100: neither bytes nor flops. At the production
// shape (C = 32 clouds, 256 + 256 points) it reads ~16k points x 16
// scattered grid values (~8 cache lines per point, a few MB) and does
// ~1k flops per point. One launch per LM assembly replaces the plain
// version's ~100 eager ops; the kernel is launch- and latency-bound.
//
// Design: one block per cloud, 256 threads, points in chunks of 256. Each
// thread turns one point into its 18-wide row and residual in shared
// memory; then thread k < 190 owns one of the 171 upper-triangle entries
// of S, the 18 entries of g or the cost, and adds the chunk's products in
// point order. Fixed order, no atomics: the result is deterministic, which
// the LM accept test needs. The world point and the cell floor must pick
// the same cells as the plain version (ROADMAP C0): every multiply, add,
// subtract and divide is a round-to-nearest intrinsic, and the library is
// built with --fmad=false. The rest follows the plain version's order too.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRow = 19;  // 18 Jacobian entries + the residual; odd stride
constexpr int kUpper = 171;  // 18 * 19 / 2

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

__device__ __forceinline__ void cross3(const float a[3], const float b[3], float out[3]) {
  out[0] = sub(mul(a[1], b[2]), mul(a[2], b[1]));
  out[1] = sub(mul(a[2], b[0]), mul(a[0], b[2]));
  out[2] = sub(mul(a[0], b[1]), mul(a[1], b[0]));
}

struct Grid {
  const float* tsd;
  const float* weight;
  int nx, ny, nz;
  float mc[3];  // min_corner and resolution: read from the device by the kernel
  float res;
};

// One field's value and d/df from its stencil values r[(dx, dy)][dz], in
// the plain version's order (interpolated_grid.py _field_and_dfrac).
__device__ void field_and_dfrac(const float r[4][2], float fx, float fy, float fz, float& val,
                                float d[3]) {
  const float gx = sub(1.0f, fx), gy = sub(1.0f, fy), gz = sub(1.0f, fz);
  const float w00 = mul(gx, gy), w01 = mul(gx, fy), w10 = mul(fx, gy), w11 = mul(fx, fy);
  float m[2], mdx[2], mdy[2];
  for (int z = 0; z < 2; ++z) {
    const float r0 = r[0][z], r1 = r[1][z], r2 = r[2][z], r3 = r[3][z];
    m[z] = add(add(add(mul(w00, r0), mul(w01, r1)), mul(w10, r2)), mul(w11, r3));
    mdx[z] = add(mul(gy, sub(r2, r0)), mul(fy, sub(r3, r1)));
    mdy[z] = add(mul(gx, sub(r1, r0)), mul(fx, sub(r3, r2)));
  }
  val = add(mul(m[0], gz), mul(m[1], fz));
  d[0] = add(mul(mdx[0], gz), mul(mdx[1], fz));
  d[1] = add(mul(mdy[0], gz), mul(mdy[1], fz));
  d[2] = sub(m[1], m[0]);
}

// Residual (unscaled) and row7 = [dval/dworld, dval/dq] of one point.
__device__ void point_row7(const Grid& grid, const float q[4], const float t[3], const float p[3],
                           float& val, float row7[7]) {
  // world = p + 2 * (w * (u x p) + u x (u x p)) + t
  const float u[3] = {q[1], q[2], q[3]};
  float uv[3], uuv[3];
  cross3(u, p, uv);
  cross3(u, uv, uuv);
  float f[3];
  bool ok = true;
  float base[3];
  for (int i = 0; i < 3; ++i) {
    const float rot = add(p[i], mul(2.0f, add(mul(q[0], uv[i]), uuv[i])));
    const float world = add(rot, t[i]);
    const float ui = sub(dvd(sub(world, grid.mc[i]), grid.res), 0.5f);
    base[i] = floorf(ui);
    f[i] = sub(ui, base[i]);
  }
  ok = base[0] >= 0.0f && base[0] < static_cast<float>(grid.nx - 1) && base[1] >= 0.0f &&
       base[1] < static_cast<float>(grid.ny - 1) && base[2] >= 0.0f &&
       base[2] < static_cast<float>(grid.nz - 1);
  val = 0.0f;
  for (int k = 0; k < 7; ++k) row7[k] = 0.0f;
  if (!ok) return;  // unknown: w = 0 everywhere, the gate zeroes value and derivative

  const size_t ny = grid.ny, nz = grid.nz;
  const size_t b0 = (static_cast<size_t>(base[0]) * ny + static_cast<size_t>(base[1])) * nz +
                    static_cast<size_t>(base[2]);
  float rw[4][2], rt[4][2];
  for (int c = 0; c < 4; ++c) {
    const size_t idx = b0 + static_cast<size_t>(c >> 1) * ny * nz + static_cast<size_t>(c & 1) * nz;
    for (int z = 0; z < 2; ++z) {
      const float w = __ldg(grid.weight + idx + z);
      rw[c][z] = w;
      rt[c][z] = mul(w, __ldg(grid.tsd + idx + z));
    }
  }
  float w, wtsd, dw[3], dwtsd[3];
  field_and_dfrac(rw, f[0], f[1], f[2], w, dw);
  field_and_dfrac(rt, f[0], f[1], f[2], wtsd, dwtsd);
  if (!(w > 1e-6f)) return;
  const float safe = fmaxf(w, 1e-6f);
  val = dvd(wtsd, safe);
  const float safe2 = mul(safe, safe);
  float dvw[3];
  for (int i = 0; i < 3; ++i) {
    const float dv = dvd(sub(mul(dwtsd[i], safe), mul(wtsd, dw[i])), safe2);
    dvw[i] = dvd(dv, grid.res);
  }

  // D = dR(q)p/dq (3 x 4): column 0 = 2 (w p + v x p); column 1 + i =
  // -2 v_i p + 2 p_i v + 2 (v.p) e_i + 2 w (e_i x p).
  const float vxp[3] = {uv[0], uv[1], uv[2]};
  float D[3][4];
  for (int r = 0; r < 3; ++r) D[r][0] = mul(2.0f, add(mul(q[0], p[r]), vxp[r]));
  const float vdotp = add(add(mul(u[0], p[0]), mul(u[1], p[1])), mul(u[2], p[2]));
  const float two_vdotp = mul(2.0f, vdotp);
  const float two_w = mul(2.0f, q[0]);
  for (int i = 0; i < 3; ++i) {
    const float a = mul(-2.0f, u[i]);
    const float b = mul(2.0f, p[i]);
    float e[3] = {0.0f, 0.0f, 0.0f};
    e[i] = 1.0f;
    float exp_[3];
    cross3(e, p, exp_);
    for (int r = 0; r < 3; ++r) {
      const float er = (r == i) ? two_vdotp : 0.0f;
      D[r][1 + i] = add(add(add(mul(a, p[r]), mul(b, u[r])), er), mul(two_w, exp_[r]));
    }
  }
  row7[0] = dvw[0];
  row7[1] = dvw[1];
  row7[2] = dvw[2];
  for (int j = 0; j < 4; ++j) {
    row7[3 + j] = add(add(mul(dvw[0], D[0][j]), mul(dvw[1], D[1][j])), mul(dvw[2], D[2][j]));
  }
}

__global__ void __launch_bounds__(kThreads)
ct_scan_block_kernel(Grid hi, Grid lo, const float* __restrict__ gparams, const float* __restrict__ hi_pts,
                     const uint8_t* __restrict__ hi_mask, const float* __restrict__ lo_pts,
                     const uint8_t* __restrict__ lo_mask, const float* __restrict__ pose7,
                     const float* __restrict__ dpose7, const float* __restrict__ hi_scale,
                     const float* __restrict__ lo_scale, float* __restrict__ S_out,
                     float* __restrict__ g_out, float* __restrict__ cost_out, int p_hi, int p_lo) {
  __shared__ float rows[kThreads * kRow];
  __shared__ float sh_pose[7];
  __shared__ float sh_dpose[7 * 18];
  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  if (tid < 7) sh_pose[tid] = pose7[c * 7 + tid];
  for (int k = tid; k < 7 * 18; k += kThreads) sh_dpose[k] = dpose7[static_cast<size_t>(c) * 126 + k];
  __syncthreads();
  for (int i = 0; i < 3; ++i) {
    hi.mc[i] = __ldg(gparams + i);
    lo.mc[i] = __ldg(gparams + 4 + i);
  }
  hi.res = __ldg(gparams + 3);
  lo.res = __ldg(gparams + 7);
  const float t[3] = {sh_pose[0], sh_pose[1], sh_pose[2]};
  const float q[4] = {sh_pose[3], sh_pose[4], sh_pose[5], sh_pose[6]};
  const float s_hi = hi_scale[c], s_lo = lo_scale[c];

  // The output this thread owns: upper-triangle entry (oa, ob) of S,
  // g[oa], or the cost.
  int oa = -1, ob = -1;
  if (tid < kUpper) {
    int k = tid, a = 0;
    while (k >= 18 - a) {
      k -= 18 - a;
      ++a;
    }
    oa = a;
    ob = a + k;
  } else if (tid < kUpper + 18) {
    oa = tid - kUpper;
  }
  float acc = 0.0f;

  const int n_pts = p_hi + p_lo;
  for (int start = 0; start < n_pts; start += kThreads) {
    const int n = start + tid;
    float* row = rows + tid * kRow;
    float val = 0.0f, row7[7];
    float s = 0.0f;
    if (n < n_pts) {
      const bool is_hi = n < p_hi;
      const int i = is_hi ? n : n - p_hi;
      const bool m = is_hi ? hi_mask[static_cast<size_t>(c) * p_hi + i] != 0
                           : lo_mask[static_cast<size_t>(c) * p_lo + i] != 0;
      if (m) {
        const float* src = is_hi ? hi_pts + (static_cast<size_t>(c) * p_hi + i) * 3
                                 : lo_pts + (static_cast<size_t>(c) * p_lo + i) * 3;
        const float p[3] = {src[0], src[1], src[2]};
        point_row7(is_hi ? hi : lo, q, t, p, val, row7);
        s = is_hi ? s_hi : s_lo;
      }
    }
    if (s != 0.0f) {
      for (int j = 0; j < 18; ++j) {
        float acc_j = mul(row7[0], sh_dpose[j]);
        for (int k = 1; k < 7; ++k) acc_j = add(acc_j, mul(row7[k], sh_dpose[k * 18 + j]));
        row[j] = mul(acc_j, s);
      }
      row[18] = mul(val, s);
    } else {
      for (int j = 0; j < kRow; ++j) row[j] = 0.0f;
    }
    __syncthreads();
    const int chunk = min(kThreads, n_pts - start);
    if (ob >= 0) {
      for (int k = 0; k < chunk; ++k) acc = add(acc, mul(rows[k * kRow + oa], rows[k * kRow + ob]));
    } else if (oa >= 0) {
      for (int k = 0; k < chunk; ++k) acc = add(acc, mul(rows[k * kRow + oa], rows[k * kRow + 18]));
    } else if (tid == kUpper + 18) {
      for (int k = 0; k < chunk; ++k) acc = add(acc, mul(rows[k * kRow + 18], rows[k * kRow + 18]));
    }
    __syncthreads();
  }

  if (ob >= 0) {
    S_out[(static_cast<size_t>(c) * 18 + oa) * 18 + ob] = acc;
    S_out[(static_cast<size_t>(c) * 18 + ob) * 18 + oa] = acc;
  } else if (oa >= 0) {
    g_out[static_cast<size_t>(c) * 18 + oa] = acc;
  } else if (tid == kUpper + 18) {
    cost_out[c] = mul(0.5f, acc);
  }
}

}  // namespace

// hi_tsd, hi_weight (hnx, hny, hnz) and lo_tsd, lo_weight (lnx, lny, lnz)
// f32; gparams (8,) f32 on the device [hi min_corner (3), hi resolution,
// lo min_corner (3), lo resolution]; hi_pts (C, P_hi, 3) f32, hi_mask
// (C, P_hi) bool, likewise lo; pose7 (C, 7), dpose7 (C, 7, 18), hi_scale,
// lo_scale (C,) f32. Writes S (C, 18, 18), g (C, 18), cost (C,) f32.
// Returns the launch's cudaGetLastError().
extern "C" int hg_ct_scan_block(const float* hi_tsd, const float* hi_weight, const float* lo_tsd,
                                const float* lo_weight, const float* gparams, const float* hi_pts,
                                const uint8_t* hi_mask, const float* lo_pts, const uint8_t* lo_mask,
                                const float* pose7, const float* dpose7, const float* hi_scale,
                                const float* lo_scale, float* S, float* g, float* cost, int c,
                                int p_hi, int p_lo, int hnx, int hny, int hnz, int lnx, int lny,
                                int lnz, void* stream) {
  const Grid hi{hi_tsd, hi_weight, hnx, hny, hnz, {0.0f, 0.0f, 0.0f}, 0.0f};
  const Grid lo{lo_tsd, lo_weight, lnx, lny, lnz, {0.0f, 0.0f, 0.0f}, 0.0f};
  ct_scan_block_kernel<<<c, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      hi, lo, gparams, hi_pts, hi_mask, lo_pts, lo_mask, pose7, dpose7, hi_scale, lo_scale, S, g,
      cost, p_hi, p_lo);
  return static_cast<int>(cudaGetLastError());
}
