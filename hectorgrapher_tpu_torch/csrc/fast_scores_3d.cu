// K4: decimated-pyramid scoring of the fast 3D correlative matcher.
//
// Replaces score_sum in hectorgrapher_tpu/mapping/scan_matching/
// fast_correlative_3d.py _match_fast_3d_core (:329-436), with the rules of
// its CPU branch (:344-359, :415-424). It has no Pallas source: on the TPU
// score_sum is an XLA gather-reduce over a lax.scan of point chunks.
//
// Output (c, i, j, k), for candidate c with point row t = cand_t[c] and
// offsets ox = off_x[c, i], oy = off_y[c, j], oz = off_z[c, k], is the sum
// over points q in point order of the level's (bound - 0.1) value:
//   ix = bx[t, q] + ox  (likewise iy, iz), span = 2^level
//   x and z count when -span < i < n, at cell max(i, 0) >> level
//   y counts when -span < iy < ny and the point is valid (valid[t, q], or
//     valid[q] when one flag row serves every point row), at lane
//     clip(iy, 0, ny - 1) >> y_shift
//   a point with x or z out contributes the zero row, one with y out or
//   masked nothing: both add exactly 0 (table values are >= 0), and the
//   kernel reads no table row for either.
// A batched constraint round stacks its submaps' level tables, each block
// ending in its own zero row: candidate c reads rows from cand_base[c] on
// (64-bit offsets: a large pack's level 0 passes 2^31 floats).
//
// What bounds it on the H100: latency. At the production shapes (256^3
// grid, ~107 yaws x 5 x 5 x 3 coarse offsets, 256 x 2 x 2 x 2 per
// expansion level, 256 points) a call reads ~0.05-0.4 MB of distinct
// table sectors (well under a microsecond at 3.35 TB/s) and does 0.3-1.2
// M adds. Each output is a sum of 256 gathered values in point order; one
// thread per output, walking its points one dependent gather at a time,
// waits ~256 gather latencies: 36-53 us per call.
//
// Design: one block per candidate and tile of at most kMaxTile of its
// outputs (tiles of equal size), so the coarse call launches 321 blocks
// (107 candidates x 3 tiles of 25) and an expansion 256 (one tile of 8).
// Per chunk of points (all 256 at these shapes) the block stages the
// candidate's point cells and the valid flags in shared memory. Each
// thread then keeps one output's offsets in registers and gathers for
// every (256 / tile)-th point, neighbouring threads on neighbouring
// outputs of one point, with up to kBatch gathers in flight (at these
// shapes all of its points: one round trip), and writes each value (0
// where the point does not count) to shared memory; the 2 x 2 x 2 offsets
// of an expansion candidate read neighbouring cells through one L1. Then
// thread o adds its output's values in point order: the same sum, bit for
// bit, as one thread per output skipping the points that do not count
// (adding 0 leaves a sum of non-negative values unchanged). No atomics,
// deterministic. Point-order sums by warp shuffles would take one shuffle
// per value (~2 M at the coarse shape); the transpose through shared
// memory moves 32 values per instruction.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBatch = 32;  // table gathers a thread issues before it waits
constexpr int kVals = 8192;  // shared floats for the (point, output) values of a chunk
constexpr int kMaxTile = 32;  // outputs per block
constexpr int kMaxChunk = 512;  // points per chunk

__global__ void __launch_bounds__(kThreads)
fast_scores_3d_kernel(const float* __restrict__ table, const int* __restrict__ bx, const int* __restrict__ by,
                      const int* __restrict__ bz, const uint8_t* __restrict__ valid,
                      const int* __restrict__ cand_t, const int64_t* __restrict__ cand_base,
                      const int* __restrict__ off_x, const int* __restrict__ off_y,
                      const int* __restrict__ off_z, float* __restrict__ out, int p, int valid_stride, int nxo,
                      int nyo, int nzo, int nx, int ny, int nz, int level, int y_shift, int nx_l, int ny_l, int tile,
                      int chunk) {
  __shared__ float vals[kVals];  // (point, output) values of the chunk, outputs fastest
  __shared__ int4 cells[kMaxChunk];  // the chunk's point cells and valid flags
  const int c = blockIdx.x;
  const int n_per = nxo * nyo * nzo;
  const int o0 = blockIdx.y * tile;
  const int n_tile = min(tile, n_per - o0);
  if (n_tile <= 0) return;
  const int tid = threadIdx.x;
  const size_t row0 = static_cast<size_t>(cand_t[c]) * p;
  const uint8_t* valid_row = valid + static_cast<size_t>(cand_t[c]) * valid_stride;
  const float* level_table = table + (cand_base != nullptr ? cand_base[c] : 0) * static_cast<int64_t>(ny_l);
  // Thread tid gathers for output o of points q_first, q_first + q_step, ...
  const int q_step = kThreads / n_tile;
  const bool gathers = tid < q_step * n_tile;
  const int o = tid % n_tile, q_first = tid / n_tile;
  const int r = (o0 + o) / nzo;
  const int ox = off_x[c * nxo + r / nyo], oy = off_y[c * nyo + r % nyo], oz = off_z[c * nzo + (o0 + o) % nzo];
  const int span = 1 << level;
  float acc = 0.0f;
  for (int q0 = 0; q0 < p; q0 += chunk) {
    const int n_q = min(chunk, p - q0);
    for (int q = tid; q < n_q; q += kThreads) {
      cells[q] = make_int4(__ldg(bx + row0 + q0 + q), __ldg(by + row0 + q0 + q), __ldg(bz + row0 + q0 + q),
                           valid_row[q0 + q]);
    }
    __syncthreads();
    for (int qb = q_first; gathers && qb < n_q; qb += q_step * kBatch) {
      float v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int q = qb + u * q_step;
        v[u] = 0.0f;
        if (q < n_q) {
          const int4 cell = cells[q];
          const int ix = cell.x + ox, iy = cell.y + oy, iz = cell.z + oz;
          if (cell.w && iy > -span && iy < ny && ix > -span && ix < nx && iz > -span && iz < nz) {
            const int row = (max(iz, 0) >> level) * nx_l + (max(ix, 0) >> level);
            const int lane = min(max(iy, 0), ny - 1) >> y_shift;
            v[u] = __ldg(level_table + static_cast<size_t>(row) * ny_l + lane);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int q = qb + u * q_step;
        if (q < n_q) vals[q * n_tile + o] = v[u];
      }
    }
    __syncthreads();
    if (tid < n_tile) {
#pragma unroll 16
      for (int q = 0; q < n_q; ++q) acc = __fadd_rn(acc, vals[q * n_tile + tid]);
    }
    __syncthreads();
  }
  if (tid < n_tile) out[static_cast<size_t>(c) * n_per + o0 + tid] = acc;
}

}  // namespace

// table (S * (nz_l * nx_l + 1), ny_l) f32, S stacked level blocks; bx, by,
// bz (R, P) int32; valid (R, P) bool (valid_stride P) or (P,) (valid_stride
// 0); cand_t (C,) int32; cand_base (C,) int64 first rows of the candidates'
// blocks, or null for one block; off_x (C, X), off_y (C, Y), off_z (C, Z)
// int32. Writes out (C, X, Y, Z) f32. Returns the launch's
// cudaGetLastError().
extern "C" int hg_fast_scores_3d(const float* table, const int* bx, const int* by, const int* bz,
                                 const uint8_t* valid, const int* cand_t, const int64_t* cand_base,
                                 const int* off_x, const int* off_y, const int* off_z, float* out, int c, int p,
                                 int valid_stride, int nxo, int nyo, int nzo, int nx, int ny, int nz, int level,
                                 int y_shift, int nx_l, int ny_l, void* stream) {
  const int n_per = nxo * nyo * nzo;
  const int tiles = (n_per + kMaxTile - 1) / kMaxTile;
  const int tile = (n_per + tiles - 1) / tiles;
  const int chunk = kVals / tile < kMaxChunk ? kVals / tile : kMaxChunk;
  fast_scores_3d_kernel<<<dim3(c, tiles), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      table, bx, by, bz, valid, cand_t, cand_base, off_x, off_y, off_z, out, p, valid_stride, nxo, nyo, nzo, nx, ny,
      nz, level, y_shift, nx_l, ny_l, tile, chunk);
  return static_cast<int>(cudaGetLastError());
}
