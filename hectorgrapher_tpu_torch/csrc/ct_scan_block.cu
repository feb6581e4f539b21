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
//   the quotient rule. The volumes are f32, f16 or bf16 (the submaps'
//   grid_storage_dtype); a half tap is converted to f32 as it is loaded
//   (__half2float, __bfloat162float, both exact), and everything after
//   is the f32 arithmetic of the f32 mode, as the JAX package upcasts
//   the planes before w * tsd (interpolated_grid.py :298-300);
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
// the pad taps, so its cost matches the JAX package's. Half storage
// halves the stencil's bytes and nothing else: each tap is upcast in a
// register, so no f32 copy of a volume is made anywhere.
//
// Per-point mode (ct_scan_block_points_kernel). Replaces the XLA fusion of
// window_solver.py point_scan_block (:366-462), per-point unwarping: every
// hi- and lo-res point is a scalar block on its own control-point pair
// (p, p + 1) at its own time, and the blocks are summed per pair into K - 1
// pair blocks S (18 x 18), g, cost. The host sorts the points by pair once
// per solve (ops/ct_scan_block.py point_plan: the brackets and factors do
// not move while the state does), so a pair's points are one contiguous
// segment whatever clouds they came from; a cloud may span any number of
// pairs, and a pair that no point reaches is an empty segment whose block
// is zero. The pose comes from the kernel, not the host: per assembly the
// host adds one concatenation of the state (B*K x 7 floats) to the one
// launch, whatever N is. The world point and cell floor must equal the
// plain twin's (ROADMAP C0), so the pose's arithmetic follows the twin's op
// order, every op a round-to-nearest intrinsic, and acos, sin and cos run
// in f64 and are rounded once to f32 on both sides: the twin's torch
// kernels and this library are built with different contraction flags,
// and the f32 library functions could round apart where a double rounded
// to f32 agrees.
//
// What bounds it: latency. At the front end's shape (N = 32 x 480 kept
// points, K - 1 = 31 pairs, ~480 points a pair but 1,483 in the last, whose
// clouds lie past the last valid control point) it moves ~2.1 MB (~0.62 us
// at 3.35 TB/s) and does ~18 MFLOP; a block's time is one point's chain
// (the pair's terms, the pose's f64 sin and cos and IEEE divisions, the
// 16-tap stencil's loads, the Jacobian columns) and then the sum of its
// rows. The design:
// - Tiles of kPtThreads = 128 points, one block a tile, one point a
//   thread: each segment cut in order from its start, so every thread
//   holds a point but in a segment's last tile, and a long segment takes
//   as many blocks as it needs (a fixed cluster of 8 blocks a pair would
//   hold ~62 points a block, and run a longer segment in rounds). An empty
//   segment is one tile of no point, whose block writes the zero block.
//   Block t holds tile t of the segments' tiles in order, found from the
//   segment starts alone: its threads count the tiles of the segments (a
//   run of them a thread) and scan the counts across the block, so the
//   rule lives in the kernel, no table is built or copied, and the real
//   tiles take the grid's first blocks. The grid, segments + m / 128
//   blocks, holds every tile of any plan; the spare blocks exit.
// - Thread 0 computes the pair's terms once a block (pair_terms: the sign
//   flip, the half products, tdot, theta = acos, sin and cos of theta, the
//   tangents of theta and sin theta), while the other threads load their
//   points; a point then takes the sin and cos of its own two angles, the
//   weights and the normalizations (point_pose). The same ops in the same
//   order on the same inputs: the pose's bits do not change. Its Jacobian
//   runs one rotation column at a time (dq_column), its quotients products
//   with correctly rounded reciprocals where the twin divides: the pair
//   blocks agree with the twin's within the per-pair gate, not bit for bit.
// - R^T R over a tile's rows [J (18), r, 0 x 5] on the f64 tensor cores
//   (mma.m8n8k4): warp w takes rows 32 w .. 32 w + 31, four a step, into
//   the six 8 x 8 upper tiles of the 24 x 24 product; S, g and 2 cost are
//   its blocks. The products of f32 values are exact in f64 and the sums
//   are f64 in a fixed order: the warps' in warp order into the tile's
//   scratch row; then the segment's last block to finish (an atomic ticket
//   picks the block, not the order) adds its tiles in tile order, rounds
//   once to f32 and sets the segment's counter back to zero. So a result
//   is the same on every launch, and a window's segments compute the same
//   bits in the slotted form as alone: their tiles are the same.
// - No cluster: blocks are independent until the last one of a segment,
//   so none waits at a cluster barrier, and at 63-69 registers
//   (__launch_bounds__(128, 6), no spills) six blocks share an SM.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ct_pose.cuh"  // mul, add, sub, dvd, cross3 and the pair pose, shared with K6

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

// The kernel's modes, as the host names them (ops/ct_scan_block.py).
constexpr int kModeTsdf = 0;  // TSDF volumes in f32
constexpr int kModeProb = 1;  // prepared f32 probability fields
constexpr int kModeTsdfF16 = 2;  // TSDF volumes in f16
constexpr int kModeTsdfBf16 = 3;  // TSDF volumes in bf16

// A volume tap as f32: exact for every storage type.
__device__ __forceinline__ float tap(const float* p) { return __ldg(p); }
__device__ __forceinline__ float tap(const __half* p) { return __half2float(__ldg(p)); }
__device__ __forceinline__ float tap(const __nv_bfloat16* p) { return __bfloat162float(__ldg(p)); }

struct Grid {
  const void* tsd;  // of the mode's storage type; probability mode: the prepared probability field
  const void* weight;  // probability mode: unused
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

// Residual (unscaled) and row7 = [dval/dworld, dval/dq] of one point; T
// is the volumes' storage type (float in probability mode).
template <bool kProb, typename T>
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
      for (int z = 0; z < 2; ++z) r[c][z] = ok ? tap(static_cast<const T*>(grid.tsd) + idx + z) : kMinProbability;
    }
    float prob, dp[3];
    field_and_dfrac(r, f[0], f[1], f[2], prob, dp);
    val = sub(1.0f, prob);
    for (int i = 0; i < 3; ++i) dvw[i] = dvd(-dp[i], grid.res);
  } else {
    const T* weight = static_cast<const T*>(grid.weight);
    const T* tsd = static_cast<const T*>(grid.tsd);
    float rw[4][2], rt[4][2];
    for (int c = 0; c < 4; ++c) {
      const size_t idx = b0 + static_cast<size_t>(c >> 1) * ny * nz + static_cast<size_t>(c & 1) * nz;
      for (int z = 0; z < 2; ++z) {
        const float w = tap(weight + idx + z);
        rw[c][z] = w;
        rt[c][z] = mul(w, tap(tsd + idx + z));
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
// its prepared probability field; weight is not read). T: the storage
// type of the volumes (float, __half or __nv_bfloat16; float with kProb).
template <bool kSlotted, bool kProb, typename T>
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
    hi.tsd = reinterpret_cast<const void*>(grid_ptrs[4 * s]);
    hi.weight = reinterpret_cast<const void*>(grid_ptrs[4 * s + 1]);
    lo.tsd = reinterpret_cast<const void*>(grid_ptrs[4 * s + 2]);
    lo.weight = reinterpret_cast<const void*>(grid_ptrs[4 * s + 3]);
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
        point_row7<kProb, T>(grid, q, t, p, val, row7);
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

// c += a * b on the f64 tensor cores: one 8 x 8 x 4 step of a warp, A (8 x
// 4, row) one value a lane at [lane / 4][lane % 4], B (4 x 8, col) at
// [lane % 4][lane / 4], C (8 x 8) two values a lane at [lane / 4][2 (lane
// % 4) + v]. Products of f32 values are exact in f64; the sums round in
// f64, in the hardware's fixed order.
__device__ __forceinline__ void mma_f64(double c[2], double a, double b) {
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};\n"
               : "+d"(c[0]), "+d"(c[1])
               : "d"(a), "d"(b));
}

constexpr int kPtThreads = 128;  // points a tile holds, one a thread (ops/ct_scan_block.py POINT_TILE)
constexpr int kPtWarps = kPtThreads / 32;
constexpr int kPtMinBlocks = 6;  // blocks an SM must hold (__launch_bounds__): <= 85 registers
constexpr int kPad = 24;  // a row's 19 entries and 5 zeros: three 8-wide column tiles
constexpr int kTiles = 6;  // the 8 x 8 tiles (I, J), I <= J, of the 24 x 24 R^T R

// Tile (I, J) (I <= J < 3) of the upper triangle, numbered row by row.
__device__ __forceinline__ int tile_of(int i, int j) { return i == 0 ? j : (i == 1 ? 2 + j : 5); }

// The tiles of a segment of n points: an empty one is one tile of no point.
__device__ __forceinline__ int tiles_of(int n) { return n > 0 ? (n + kPtThreads - 1) / kPtThreads : 1; }

// Upper-triangle entry o < kUpper of S as (a, b), a <= b.
__device__ __forceinline__ void upper_entry(int o, int& a, int& b) {
  int r = o;
  a = 0;
  while (r >= 18 - a) {
    r -= 18 - a;
    ++a;
  }
  b = a + r;
}

// Per-point mode. Segment j = b * (k - 1) + p (window b's pair p) is cut
// in order into tiles of kPtThreads points, tile i its points starts[j] +
// kPtThreads i on, never two segments, and an empty segment is one tile
// of no point. Block t holds tile t of all the segments' tiles in order
// (they fit in segments + m / kPtThreads blocks; the spare ones exit). Its
// R^T R goes to scratch[t]
// (kOut f64); the segment's last tile to finish (by an atomic ticket on
// counters[j], which it sets back to 0) adds the segment's tiles in tile
// order and writes S_out[j], g_out[j], cost_out[j]. cp7 (B*k, 7) holds
// every window's control points [t, q]. kSlotted: window b reads the grids
// of slot[b].
template <bool kSlotted, bool kProb, typename T>
__global__ void __launch_bounds__(kPtThreads, kPtMinBlocks)
ct_scan_block_points_kernel(Grid hi, Grid lo, const int64_t* __restrict__ grid_ptrs, const int* __restrict__ slot,
                            const float* __restrict__ gparams, const float* __restrict__ cp7,
                            const float* __restrict__ pts, const float* __restrict__ fac,
                            const float* __restrict__ scl, const uint8_t* __restrict__ is_lo,
                            const int* __restrict__ starts, int* __restrict__ counters,
                            double* __restrict__ scratch, float* __restrict__ S_out, float* __restrict__ g_out,
                            float* __restrict__ cost_out, int k, int segments) {
  __shared__ __align__(16) float rows[kPtThreads * kPad];
  __shared__ __align__(16) double part[kPtWarps][kTiles][64];  // each warp's sums, C's layout (64 = 8 m + n)
  __shared__ PairTerms pair_sh;
  __shared__ int seg_sh[4], warp_tiles[kPtWarps], last;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int block = blockIdx.x;
  // The tiles of the segments before each: thread tid counts those of its
  // run of `per` segments, and a scan over the block adds them up.
  const int per = (segments + kPtThreads - 1) / kPtThreads;
  const int i0 = min(tid * per, segments), i1 = min(i0 + per, segments);
  int own_tiles = 0;
  for (int i = i0; i < i1; ++i) own_tiles += tiles_of(__ldg(starts + i + 1) - __ldg(starts + i));
  int before = own_tiles;  // inclusive scan over the warp, then over the warps
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, before, d);
    if (lane >= d) before += v;
  }
  if (lane == 31) warp_tiles[warp] = before;
  __syncthreads();
  int n_all = 0;
  for (int w = 0; w < kPtWarps; ++w) {
    if (w < warp) before += warp_tiles[w];
    n_all += warp_tiles[w];
  }
  if (block >= n_all) return;  // past every tile: the grid's spare blocks
  before -= own_tiles;
  for (int i = i0; i < i1; ++i) {
    const int s0 = __ldg(starts + i), s1 = __ldg(starts + i + 1), t = tiles_of(s1 - s0);
    if (before <= block && block < before + t) {
      seg_sh[0] = i;
      seg_sh[1] = s0;
      seg_sh[2] = s1;
      seg_sh[3] = before;
    }
    before += t;
  }
  __syncthreads();
  const int j = seg_sh[0], first = seg_sh[3];
  const int n_seg = seg_sh[2] - seg_sh[1];
  const int n_tiles = tiles_of(n_seg);
  const int tile = block - first;
  const int b = j / (k - 1);
  const int pair = j - b * (k - 1);
  if (tid == 0) {
    const float* ca = cp7 + (static_cast<size_t>(b) * k + pair) * 7;
    pair_terms(ca, ca + 7, pair_sh);
  }
  int s = 0;
  if (kSlotted) {
    s = slot[b];
    hi.tsd = reinterpret_cast<const void*>(grid_ptrs[4 * s]);
    hi.weight = reinterpret_cast<const void*>(grid_ptrs[4 * s + 1]);
    lo.tsd = reinterpret_cast<const void*>(grid_ptrs[4 * s + 2]);
    lo.weight = reinterpret_cast<const void*>(grid_ptrs[4 * s + 3]);
  }
  float gp[8];
  for (int i = 0; i < 8; ++i) gp[i] = __ldg(gparams + 8 * s + i);

  // This thread's point (none past the tile's points, or dropped: scale 0).
  const int n = seg_sh[1] + tile * kPtThreads + tid;
  float p[3] = {0.0f, 0.0f, 0.0f}, f = 0.0f, sc = 0.0f;
  bool use_lo = false;
  if (tile * kPtThreads + tid < n_seg) {
    p[0] = pts[static_cast<size_t>(n) * 3];
    p[1] = pts[static_cast<size_t>(n) * 3 + 1];
    p[2] = pts[static_cast<size_t>(n) * 3 + 2];
    f = fac[n];
    sc = scl[n];
    use_lo = is_lo[n] != 0;
  }
  __syncthreads();  // the pair's terms are in shared memory

  float row[kPad];
  for (int i = 0; i < kPad; ++i) row[i] = 0.0f;
  float row7[7];
  PointPose o;
  if (sc != 0.0f) {
    point_pose(pair_sh, f, o);
    const Grid grid{use_lo ? lo.tsd : hi.tsd, use_lo ? lo.weight : hi.weight, use_lo ? lo.nx : hi.nx,
                    use_lo ? lo.ny : hi.ny, use_lo ? lo.nz : hi.nz,
                    {use_lo ? gp[4] : gp[0], use_lo ? gp[5] : gp[1], use_lo ? gp[6] : gp[2]},
                    use_lo ? gp[7] : gp[3]};
    float val;
    point_row7<kProb, T>(grid, o.q, o.t, p, val, row7);
    const float g = sub(1.0f, f);
    for (int i = 0; i < 3; ++i) {
      row[i] = mul(mul(g, row7[i]), sc);
      row[9 + i] = mul(mul(f, row7[i]), sc);
    }
    row[18] = mul(val, sc);
  }
  float* own_row = rows + tid * kPad;
  float4* dst = reinterpret_cast<float4*>(own_row);
  for (int i = 0; i < kPad / 4; ++i) dst[i] = make_float4(row[4 * i], row[4 * i + 1], row[4 * i + 2], row[4 * i + 3]);
  if (sc != 0.0f) {
    // The rotation columns: dval/dq . dq[:, c], one column at a time.
#pragma unroll 1
    for (int c = 0; c < 6; ++c) {
      float col[4];
      dq_column(pair_sh, o, f, c, col);
      float jr = mul(row7[3], col[0]);
      for (int i = 1; i < 4; ++i) jr = add(jr, mul(row7[3 + i], col[i]));
      own_row[(c < 3 ? 3 : 9) + c] = mul(jr, sc);
    }
  }
  __syncthreads();

  // R^T R over the tile's rows: warp w takes rows 32 w .. 32 w + 31, four
  // at a time, into the six upper tiles of its own sums.
  double acc[kTiles][2];
  for (int t = 0; t < kTiles; ++t) acc[t][0] = acc[t][1] = 0.0;
  for (int step = 0; step < 8; ++step) {
    const float* r = rows + (32 * warp + 4 * step + (lane & 3)) * kPad + (lane >> 2);
    const double v0 = r[0], v1 = r[8], v2 = r[16];
    mma_f64(acc[0], v0, v0);
    mma_f64(acc[1], v0, v1);
    mma_f64(acc[2], v0, v2);
    mma_f64(acc[3], v1, v1);
    mma_f64(acc[4], v1, v2);
    mma_f64(acc[5], v2, v2);
  }
  for (int t = 0; t < kTiles; ++t) {
    part[warp][t][2 * lane] = acc[t][0];
    part[warp][t][2 * lane + 1] = acc[t][1];
  }
  __syncthreads();

  // Output o: upper-triangle entry (oa, ob) of S, g[oa] (ob = 18, the
  // residual column) or the cost (oa = ob = 18): the warps' sums in warp
  // order into the tile's scratch row.
  double* own = scratch + static_cast<size_t>(block) * kOut;
  for (int o = tid; o < kOut; o += kPtThreads) {
    int oa = 18, ob = 18;
    if (o < kUpper) {
      upper_entry(o, oa, ob);
    } else if (o < kUpper + 18) {
      oa = o - kUpper;
    }
    const int at = tile_of(oa >> 3, ob >> 3) * 64 + (oa & 7) * 8 + (ob & 7);
    double total = (&part[0][0][0])[at];
    for (int w = 1; w < kPtWarps; ++w) total += (&part[w][0][0])[at];
    own[o] = total;
  }
  // The segment's last tile to finish adds its tiles in tile order: the
  // ticket picks the block, not the order of the sum.
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(counters + j, 1) == n_tiles - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const double* seg = scratch + static_cast<size_t>(first) * kOut;
  for (int o = tid; o < kOut; o += kPtThreads) {
    double total = __ldcg(seg + o);
    for (int t = 1; t < n_tiles; ++t) total += __ldcg(seg + static_cast<size_t>(t) * kOut + o);
    if (o < kUpper) {
      int a, bb;
      upper_entry(o, a, bb);
      const float v = __double2float_rn(total);
      S_out[(static_cast<size_t>(j) * 18 + a) * 18 + bb] = v;
      S_out[(static_cast<size_t>(j) * 18 + bb) * 18 + a] = v;
    } else if (o < kUpper + 18) {
      g_out[static_cast<size_t>(j) * 18 + o - kUpper] = __double2float_rn(total);
    } else {
      cost_out[j] = __double2float_rn(0.5 * total);
    }
  }
  if (tid == 0) counters[j] = 0;  // ready for the plan's next launch
}

// Launch the per-point kernel in `mode` on segments + m / kPtThreads
// blocks (m points in all), given a scratch of that many rows.
template <bool kSlotted, typename... Args>
int launch_points(int mode, int segments, int m, int scratch_rows, void* stream, Args... args) {
  if (segments < 1 || m < 0 || scratch_rows != segments + m / kPtThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(scratch_rows);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kModeTsdf:
      ct_scan_block_points_kernel<kSlotted, false, float><<<grid, kPtThreads, 0, s>>>(args..., segments);
      break;
    case kModeProb:
      ct_scan_block_points_kernel<kSlotted, true, float><<<grid, kPtThreads, 0, s>>>(args..., segments);
      break;
    case kModeTsdfF16:
      ct_scan_block_points_kernel<kSlotted, false, __half><<<grid, kPtThreads, 0, s>>>(args..., segments);
      break;
    case kModeTsdfBf16:
      ct_scan_block_points_kernel<kSlotted, false, __nv_bfloat16><<<grid, kPtThreads, 0, s>>>(args..., segments);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launch the kernel in `mode` (kMode*; host side of both entries).
template <bool kSlotted, typename... Args>
int launch(int mode, int c, void* stream, Args... args) {
  const dim3 grid(kCluster, c);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kModeTsdf:
      ct_scan_block_kernel<kSlotted, false, float><<<grid, kThreads, 0, s>>>(args...);
      break;
    case kModeProb:
      ct_scan_block_kernel<kSlotted, true, float><<<grid, kThreads, 0, s>>>(args...);
      break;
    case kModeTsdfF16:
      ct_scan_block_kernel<kSlotted, false, __half><<<grid, kThreads, 0, s>>>(args...);
      break;
    case kModeTsdfBf16:
      ct_scan_block_kernel<kSlotted, false, __nv_bfloat16><<<grid, kThreads, 0, s>>>(args...);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// hi_tsd, hi_weight (hnx, hny, hnz) and lo_tsd, lo_weight (lnx, lny, lnz)
// in the storage type `mode` names (kModeTsdf f32, kModeTsdfF16 f16,
// kModeTsdfBf16 bf16), or with kModeProb the prepared f32 probability
// fields in hi_tsd and lo_tsd (the weights unused, may be null); gparams (8,) f32 on the device
// [hi min_corner (3), hi resolution, lo min_corner (3), lo resolution];
// hi_pts (C, P_hi, 3) f32, hi_mask (C, P_hi) bool, likewise lo; pose7
// (C, 7), dpose7 (C, 7, 18), hi_scale, lo_scale (C,) f32. Writes S (C, 18,
// 18), g (C, 18), cost (C,) f32. Returns the launch's cudaGetLastError().
extern "C" int hg_ct_scan_block(const void* hi_tsd, const void* hi_weight, const void* lo_tsd,
                                const void* lo_weight, const float* gparams, const float* hi_pts,
                                const uint8_t* hi_mask, const float* lo_pts, const uint8_t* lo_mask,
                                const float* pose7, const float* dpose7, const float* hi_scale,
                                const float* lo_scale, float* S, float* g, float* cost, int c, int p_hi, int p_lo,
                                int hnx, int hny, int hnz, int lnx, int lny, int lnz, int mode, void* stream) {
  const Grid hi{hi_tsd, hi_weight, hnx, hny, hnz, {0.0f, 0.0f, 0.0f}, 0.0f};
  const Grid lo{lo_tsd, lo_weight, lnx, lny, lnz, {0.0f, 0.0f, 0.0f}, 0.0f};
  return launch<false>(mode, c, stream, hi, lo, static_cast<const int64_t*>(nullptr), static_cast<const int*>(nullptr),
                       gparams, hi_pts, hi_mask, lo_pts, lo_mask, pose7, dpose7, hi_scale, lo_scale, S, g, cost, p_hi,
                       p_lo);
}

// The slotted form: grid_ptrs (D, 4) int64 device pointers [hi_tsd,
// hi_weight, lo_tsd, lo_weight] of D submaps whose hi volumes are all
// (hnx, hny, hnz) and lo volumes (lnx, lny, lnz), all in the storage type
// `mode` names (with kModeProb, entries 0 and 2 are the hi and lo
// probability fields and 1 and 3 are unused); gparams (D, 8) f32, one row per submap; slot (C,) int32 in [0,
// D): cloud c's submap. The other arguments and the outputs as
// hg_ct_scan_block's.
extern "C" int hg_ct_scan_block_slots(const int64_t* grid_ptrs, const int* slot, const float* gparams,
                                      const float* hi_pts, const uint8_t* hi_mask, const float* lo_pts,
                                      const uint8_t* lo_mask, const float* pose7, const float* dpose7,
                                      const float* hi_scale, const float* lo_scale, float* S, float* g, float* cost,
                                      int c, int p_hi, int p_lo, int hnx, int hny, int hnz, int lnx, int lny, int lnz,
                                      int mode, void* stream) {
  const Grid hi{nullptr, nullptr, hnx, hny, hnz, {0.0f, 0.0f, 0.0f}, 0.0f};
  const Grid lo{nullptr, nullptr, lnx, lny, lnz, {0.0f, 0.0f, 0.0f}, 0.0f};
  return launch<true>(mode, c, stream, hi, lo, grid_ptrs, slot, gparams, hi_pts, hi_mask, lo_pts, lo_mask, pose7,
                      dpose7, hi_scale, lo_scale, S, g, cost, p_hi, p_lo);
}

// Per-point mode. Grids and gparams as hg_ct_scan_block's; cp7 (B*k, 7)
// f32 control points [t, q] of B windows; the plan sorted by segment
// (window b's pair p is segment b * (k - 1) + p): pts (m, 3), fac, scl (m,)
// f32, is_lo (m,) bool (the point reads the lo-res grid), starts
// (segments + 1,) int32, counters (segments,) int32, zero before the
// launch and after it; scratch (scratch_rows, 190) f64, scratch_rows =
// segments + m / kPtThreads (ops/ct_scan_block.py POINT_TILE; another
// count is refused). Writes S (segments, 18, 18), g (segments, 18), cost
// (segments,) f32.
extern "C" int hg_ct_scan_block_points(const void* hi_tsd, const void* hi_weight, const void* lo_tsd,
                                       const void* lo_weight, const float* gparams, const float* cp7,
                                       const float* pts, const float* fac, const float* scl, const uint8_t* is_lo,
                                       const int* starts, int* counters, double* scratch, float* S, float* g,
                                       float* cost, int segments, int m, int scratch_rows, int k, int hnx, int hny,
                                       int hnz, int lnx, int lny, int lnz, int mode, void* stream) {
  const Grid hi{hi_tsd, hi_weight, hnx, hny, hnz, {0.0f, 0.0f, 0.0f}, 0.0f};
  const Grid lo{lo_tsd, lo_weight, lnx, lny, lnz, {0.0f, 0.0f, 0.0f}, 0.0f};
  return launch_points<false>(mode, segments, m, scratch_rows, stream, hi, lo, static_cast<const int64_t*>(nullptr),
                              static_cast<const int*>(nullptr), gparams, cp7, pts, fac, scl, is_lo, starts, counters,
                              scratch, S, g, cost, k);
}

// The slotted per-point form: window b reads the grids of slot[b] (B,)
// int32, through grid_ptrs (D, 4) and gparams (D, 8) as in
// hg_ct_scan_block_slots; the rest as hg_ct_scan_block_points.
extern "C" int hg_ct_scan_block_points_slots(const int64_t* grid_ptrs, const int* slot, const float* gparams,
                                             const float* cp7, const float* pts, const float* fac, const float* scl,
                                             const uint8_t* is_lo, const int* starts, int* counters, double* scratch,
                                             float* S, float* g, float* cost, int segments, int m, int scratch_rows,
                                             int k, int hnx, int hny, int hnz, int lnx, int lny, int lnz, int mode,
                                             void* stream) {
  const Grid hi{nullptr, nullptr, hnx, hny, hnz, {0.0f, 0.0f, 0.0f}, 0.0f};
  const Grid lo{nullptr, nullptr, lnx, lny, lnz, {0.0f, 0.0f, 0.0f}, 0.0f};
  return launch_points<true>(mode, segments, m, scratch_rows, stream, hi, lo, grid_ptrs, slot, gparams, cp7, pts, fac,
                             scl, is_lo, starts, counters, scratch, S, g, cost, k);
}
