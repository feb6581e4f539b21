// K3: per-cloud scan-block assembly of the continuous-time window solve.
//
// Replaces the XLA fusion of hectorgrapher_tpu/mapping/ct/window_solver.py
// scan_block (:467-513) plus the per-block einsums of _make_ct_assemble
// (:611-613), over the 3D stencils of
// hectorgrapher_tpu/mapping/scan_matching/interpolated_grid.py (:332-466):
// the weighted TSDF (TSDF mode) or the occupancy probability (probability
// mode, prob_value_and_dfrac :462-466). It has no Pallas source: on the
// TPU this is one XLA fusion per LM iteration.
//
// For cloud c with interpolated pose (t, q) = pose7[c] and its Jacobian
// dpose7[c] (7 x 18) on the cloud's control-point pair tangent, each point
// p of the hi-res cloud (then of the lo-res cloud, against the lo-res grid)
// gives:
//   world  = R(q) p + t                         (the 15-mul quat_rotate)
//   u      = ((world - min_corner) / res) - 0.5; base = floor(u), f = u - base
//   TSDF mode: the 2x2x2 stencil of w and w*tsd, interior cells only
//   (else unknown), blended in x and y per z, then in z, with d/df
//   (_field_and_dfrac); val = (w*tsd)/w where w > 1e-6 (else 0), d/df by
//   the quotient rule;
//   probability mode: the stencil of the prepared probability field p,
//   interior cells only (else eight MIN_PROBABILITY taps, JAX's pad row),
//   blended the same way; val = 1 - p, d/df = -dp/df;
//   row7   = [dval/dworld = dval/df / res, dval/dworld . dR(q)p/dq];
//   J      = row7 @ dpose7 * s, r = val * s   (s = scale[c] where masked in)
// and the block sums S = J^T J (18 x 18), g = J^T r, cost = 0.5 sum r^2.
//
// What bounds it on the H100: latency. At the front end's shape (C = 32
// clouds, 256 + 256 points, 256^3 / 128^3 grids) it moves ~2 MB (points,
// the distinct 32-byte sectors of the stencil cells, outputs; ~0.6 us at
// 3.35 TB/s) and does ~930 flops a point (~14 MFLOP, ~0.2 us at 67
// TFLOP/s); GN3D calls it with one cloud. Giving each cloud one block
// fills 32 SMs, or one for GN3D, and sums 512 products per output
// serially: ~20 us at either shape.
//
// Design: one thread block cluster of kCluster blocks per cloud, each
// block a contiguous slice of the cloud's points, so the front end
// launches 256 blocks and GN3D 8. In a block, thread p < kChunk turns
// point p into its residual and 7-wide row [dval/dworld, dval/dq]; all
// threads then project the rows onto the 18-dim tangent, one (point,
// column) each, into shared memory; then thread k < 190 owns one of the
// 171 upper-triangle entries of S, the 18 entries of g or the cost, and
// adds its slice's products in point order. Block 0 of the cluster adds
// the blocks' sums in rank order, read from their shared memory through
// the cluster (distributed shared memory): no scratch in device memory,
// no atomics, and a fixed order, so the result is deterministic, which
// the LM accept test needs. A packed GN3D run refines the lanes of one
// constraint round against several submaps in one launch: cloud c then
// reads the grids of slot[c], through a device table of the D distinct
// submaps' volume pointers and their parameters (no stacked copy of the
// volumes, 144 MiB a submap at 256^3 / 128^3), and computes exactly what
// a one-cloud launch against those grids computes. The world point and
// the cell floor must pick
// the same cells as the plain version (ROADMAP C0): every multiply, add,
// subtract and divide is a round-to-nearest intrinsic, and the library is
// built with --fmad=false. The rest follows the plain version's order
// too, except that the sums over points run by slice. Probability mode
// reads one 4-byte field where TSDF mode reads two (the field is built
// once per grid version by prepare_grid_3d, not here: computing exp per
// tap would read 5 bytes a cell and tie the result to the rounding of
// expf); a point outside the interior does not return early but blends
// the pad taps, so its cost matches the JAX package's.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;  // blocks per cloud, one cluster (the portable maximum)
constexpr int kChunk = 64;  // points a block turns into rows at a time
constexpr int kThreads = 192;  // >= kOut and >= kChunk
constexpr int kRow = 19;  // 18 Jacobian entries + the residual; odd stride
constexpr int kRow7 = 9;  // row7, the residual and the scale of a point
constexpr int kUpper = 171;  // 18 * 19 / 2
constexpr int kOut = kUpper + 18 + 1;  // a block's sums: S's upper triangle, g, the cost
constexpr float kMinProbability = 0.1f;  // probability_values.MIN_PROBABILITY: the pad taps

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
  const float* tsd;  // probability mode: the prepared probability field
  const float* weight;  // probability mode: unused
  int nx, ny, nz;
  float mc[3];  // min_corner and resolution: read from the device by the kernel
  float res;
};

// One field's value and d/df from its stencil values r[(dx, dy)][dz], in
// the plain version's order (interpolated_grid.py _field_and_dfrac).
__device__ __forceinline__ void field_and_dfrac(const float r[4][2], float fx, float fy, float fz, float& val,
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
template <bool kProb>
__device__ __forceinline__ void point_row7(const Grid& grid, const float q[4], const float t[3], const float p[3],
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
  if (!kProb && !ok) return;  // unknown: w = 0 everywhere, the gate zeroes value and derivative

  const size_t ny = grid.ny, nz = grid.nz;
  const size_t b0 = ok ? (static_cast<size_t>(base[0]) * ny + static_cast<size_t>(base[1])) * nz +
                             static_cast<size_t>(base[2])
                       : 0;
  float dvw[3];
  if (kProb) {
    float r[4][2];
    for (int c = 0; c < 4; ++c) {
      const size_t idx = b0 + static_cast<size_t>(c >> 1) * ny * nz + static_cast<size_t>(c & 1) * nz;
      for (int z = 0; z < 2; ++z) r[c][z] = ok ? __ldg(grid.tsd + idx + z) : kMinProbability;
    }
    float prob, dp[3];
    field_and_dfrac(r, f[0], f[1], f[2], prob, dp);
    val = sub(1.0f, prob);
    for (int i = 0; i < 3; ++i) dvw[i] = dvd(-dp[i], grid.res);
  } else {
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
    for (int i = 0; i < 3; ++i) {
      const float dv = dvd(sub(mul(dwtsd[i], safe), mul(wtsd, dw[i])), safe2);
      dvw[i] = dvd(dv, grid.res);
    }
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

// kSlotted: the cloud's grids are those of slot[c] (pointers from
// grid_ptrs, parameters from gparams' row); otherwise hi and lo, with
// gparams' one row. kProb: probability mode (each grid's tsd pointer is
// its prepared probability field; weight is not read).
template <bool kSlotted, bool kProb>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
ct_scan_block_kernel(Grid hi, Grid lo, const int64_t* __restrict__ grid_ptrs, const int* __restrict__ slot,
                     const float* __restrict__ gparams, const float* __restrict__ hi_pts,
                     const uint8_t* __restrict__ hi_mask, const float* __restrict__ lo_pts,
                     const uint8_t* __restrict__ lo_mask, const float* __restrict__ pose7,
                     const float* __restrict__ dpose7, const float* __restrict__ hi_scale,
                     const float* __restrict__ lo_scale, float* __restrict__ S_out,
                     float* __restrict__ g_out, float* __restrict__ cost_out, int p_hi, int p_lo) {
  __shared__ float rows[kChunk * kRow];
  __shared__ float row7s[kChunk * kRow7];  // row7, the residual, the scale
  __shared__ float sh_pose[7];
  __shared__ float sh_dpose[7 * 18];
  __shared__ float sums[kOut];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int c = blockIdx.y;
  const int tid = threadIdx.x;
  if (tid < 7) sh_pose[tid] = pose7[c * 7 + tid];
  for (int k = tid; k < 7 * 18; k += kThreads) sh_dpose[k] = dpose7[static_cast<size_t>(c) * 126 + k];
  int s = 0;
  if (kSlotted) {
    s = slot[c];
    hi.tsd = reinterpret_cast<const float*>(grid_ptrs[4 * s]);
    hi.weight = reinterpret_cast<const float*>(grid_ptrs[4 * s + 1]);
    lo.tsd = reinterpret_cast<const float*>(grid_ptrs[4 * s + 2]);
    lo.weight = reinterpret_cast<const float*>(grid_ptrs[4 * s + 3]);
  }
  float gp[8];  // the grids' min corners and resolutions
  for (int k = 0; k < 8; ++k) gp[k] = __ldg(gparams + 8 * s + k);

  // The output this thread owns: upper-triangle entry (oa, ob) of S,
  // g[oa] (ob = 18, the residual column), or the cost (oa = ob = 18).
  int oa = 18, ob = 18;
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

  // This block's slice of the cloud's points, in chunks of kChunk.
  const int n_pts = p_hi + p_lo;
  const int per = (n_pts + kCluster - 1) / kCluster;
  const int begin = min(n_pts, rank * per), end = min(n_pts, begin + per);
  float acc = 0.0f;
  for (int start = begin; start < end; start += kChunk) {
    const int chunk = min(kChunk, end - start);
    // The point's loads go out before the barrier that publishes the pose.
    const int n = start + tid;
    const bool is_hi = n < p_hi;
    const int i = is_hi ? n : n - p_hi;
    bool m = false;
    float p[3] = {0.0f, 0.0f, 0.0f};
    if (tid < chunk) {
      m = is_hi ? hi_mask[static_cast<size_t>(c) * p_hi + i] != 0 : lo_mask[static_cast<size_t>(c) * p_lo + i] != 0;
      const float* src = is_hi ? hi_pts + (static_cast<size_t>(c) * p_hi + i) * 3
                               : lo_pts + (static_cast<size_t>(c) * p_lo + i) * 3;
      if (m) {
        p[0] = src[0];
        p[1] = src[1];
        p[2] = src[2];
      }
    }
    __syncthreads();  // the pose is in shared memory; the last chunk's rows are consumed

    // Each point of the chunk: its 7-wide row, residual and scale.
    if (tid < kChunk) {
      float val = 0.0f, row7[7] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      float s = 0.0f;
      if (m) {
        const float t[3] = {sh_pose[0], sh_pose[1], sh_pose[2]};
        const float q[4] = {sh_pose[3], sh_pose[4], sh_pose[5], sh_pose[6]};
        // The point's grid, field by field, so that it stays in registers.
        const Grid grid{is_hi ? hi.tsd : lo.tsd, is_hi ? hi.weight : lo.weight, is_hi ? hi.nx : lo.nx,
                        is_hi ? hi.ny : lo.ny, is_hi ? hi.nz : lo.nz,
                        {is_hi ? gp[0] : gp[4], is_hi ? gp[1] : gp[5], is_hi ? gp[2] : gp[6]},
                        is_hi ? gp[3] : gp[7]};
        point_row7<kProb>(grid, q, t, p, val, row7);
        s = is_hi ? hi_scale[c] : lo_scale[c];
      }
      float* dst = row7s + tid * kRow7;
      for (int k = 0; k < 7; ++k) dst[k] = row7[k];
      dst[7] = val;
      dst[8] = s;
    }
    __syncthreads();

    // Rows J = row7 @ dpose7 * s and r = val * s, one (point, column) per
    // thread step.
    for (int item = tid; item < kChunk * kRow; item += kThreads) {
      const int pt = item / kRow, j = item - pt * kRow;
      const float* a = row7s + pt * kRow7;
      const float s = a[8];
      float v = 0.0f;
      if (s != 0.0f) {
        if (j < 18) {
          float acc_j = mul(a[0], sh_dpose[j]);
          for (int k = 1; k < 7; ++k) acc_j = add(acc_j, mul(a[k], sh_dpose[k * 18 + j]));
          v = mul(acc_j, s);
        } else {
          v = mul(a[7], s);
        }
      }
      rows[item] = v;
    }
    __syncthreads();

    if (tid < kOut) {
#pragma unroll 8
      for (int k = 0; k < chunk; ++k) acc = add(acc, mul(rows[k * kRow + oa], rows[k * kRow + ob]));
    }
  }

  // Block 0 adds the cluster's sums in rank order, then every block waits
  // until it has read them.
  if (tid < kOut) sums[tid] = acc;
  cluster.sync();
  if (rank == 0 && tid < kOut) {
    float total = 0.0f;
    for (int r = 0; r < kCluster; ++r) total = add(total, cluster.map_shared_rank(sums, r)[tid]);
    if (tid < kUpper) {
      S_out[(static_cast<size_t>(c) * 18 + oa) * 18 + ob] = total;
      S_out[(static_cast<size_t>(c) * 18 + ob) * 18 + oa] = total;
    } else if (tid < kUpper + 18) {
      g_out[static_cast<size_t>(c) * 18 + oa] = total;
    } else {
      cost_out[c] = mul(0.5f, total);
    }
  }
  cluster.sync();
}

// Launch the kernel in the mode `prob` names (host side of both entries).
template <bool kSlotted, typename... Args>
int launch(int prob, int c, void* stream, Args... args) {
  const dim3 grid(kCluster, c);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (prob) {
    ct_scan_block_kernel<kSlotted, true><<<grid, kThreads, 0, s>>>(args...);
  } else {
    ct_scan_block_kernel<kSlotted, false><<<grid, kThreads, 0, s>>>(args...);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// hi_tsd, hi_weight (hnx, hny, hnz) and lo_tsd, lo_weight (lnx, lny, lnz)
// f32, or with prob != 0 the prepared probability fields in hi_tsd and
// lo_tsd (the weights unused, may be null); gparams (8,) f32 on the device
// [hi min_corner (3), hi resolution, lo min_corner (3), lo resolution];
// hi_pts (C, P_hi, 3) f32, hi_mask (C, P_hi) bool, likewise lo; pose7
// (C, 7), dpose7 (C, 7, 18), hi_scale, lo_scale (C,) f32. Writes S (C, 18,
// 18), g (C, 18), cost (C,) f32. Returns the launch's cudaGetLastError().
extern "C" int hg_ct_scan_block(const float* hi_tsd, const float* hi_weight, const float* lo_tsd,
                                const float* lo_weight, const float* gparams, const float* hi_pts,
                                const uint8_t* hi_mask, const float* lo_pts, const uint8_t* lo_mask,
                                const float* pose7, const float* dpose7, const float* hi_scale,
                                const float* lo_scale, float* S, float* g, float* cost, int c, int p_hi, int p_lo,
                                int hnx, int hny, int hnz, int lnx, int lny, int lnz, int prob, void* stream) {
  const Grid hi{hi_tsd, hi_weight, hnx, hny, hnz, {0.0f, 0.0f, 0.0f}, 0.0f};
  const Grid lo{lo_tsd, lo_weight, lnx, lny, lnz, {0.0f, 0.0f, 0.0f}, 0.0f};
  return launch<false>(prob, c, stream, hi, lo, static_cast<const int64_t*>(nullptr), static_cast<const int*>(nullptr),
                       gparams, hi_pts, hi_mask, lo_pts, lo_mask, pose7, dpose7, hi_scale, lo_scale, S, g, cost, p_hi,
                       p_lo);
}

// The slotted form: grid_ptrs (D, 4) int64 device pointers [hi_tsd,
// hi_weight, lo_tsd, lo_weight] of D submaps whose hi volumes are all
// (hnx, hny, hnz) f32 and lo volumes (lnx, lny, lnz) f32 (with prob != 0,
// entries 0 and 2 are the hi and lo probability fields and 1 and 3 are
// unused); gparams (D, 8) f32, one row per submap; slot (C,) int32 in [0,
// D): cloud c's submap. The other arguments and the outputs as
// hg_ct_scan_block's.
extern "C" int hg_ct_scan_block_slots(const int64_t* grid_ptrs, const int* slot, const float* gparams,
                                      const float* hi_pts, const uint8_t* hi_mask, const float* lo_pts,
                                      const uint8_t* lo_mask, const float* pose7, const float* dpose7,
                                      const float* hi_scale, const float* lo_scale, float* S, float* g, float* cost,
                                      int c, int p_hi, int p_lo, int hnx, int hny, int hnz, int lnx, int lny, int lnz,
                                      int prob, void* stream) {
  const Grid hi{nullptr, nullptr, hnx, hny, hnz, {0.0f, 0.0f, 0.0f}, 0.0f};
  const Grid lo{nullptr, nullptr, lnx, lny, lnz, {0.0f, 0.0f, 0.0f}, 0.0f};
  return launch<true>(prob, c, stream, hi, lo, grid_ptrs, slot, gparams, hi_pts, hi_mask, lo_pts, lo_mask, pose7,
                      dpose7, hi_scale, lo_scale, S, g, cost, p_hi, p_lo);
}
