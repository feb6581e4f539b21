// K5: pyramid-level scoring of the fast 2D correlative matcher.
//
// Replaces score_sum in hectorgrapher_tpu/mapping/scan_matching/
// fast_correlative_2d.py _match_fast_2d_core (:249-301), with the rules of
// its CPU branch (:281-299). It has no Pallas source: on the TPU score_sum
// is an XLA gather-reduce (row gathers and a one-hot contraction) over a
// lax.scan of point chunks.
//
// Output (c, i, j), for candidate c with point row t = cand_t[c] and
// offsets ox = off_x[c, i], oy = off_y[c, j], is the sum over points q of
// the level's (prob - 0.1) value:
//   ix = bx[t, q] + ox, iy = by[t, q] + oy, span = 2^level
//   the point counts when -span < ix < nx, -span < iy < ny and it is valid
//     (valid[t, q], or valid[q] when one flag row serves every point row),
//     at row max(ix, 0) and lane clip(iy, 0, ny - 1) of the level;
//   any other point contributes exactly 0 (the reference's zero x-row or
//   its unmatched one-hot lane), and the kernel reads nothing for it.
// The table stacks each submap's levels, depth blocks of nx + 1 rows of ny
// lanes (the last row of a block all zero); candidate c's submap starts at
// row cand_base[c] (0 without row bases), its level at + level * (nx + 1).
//
// What bounds it on the H100: latency. At the production shapes (640^2
// grid, a batched round's ~3,000 point rows x 5 x 5 coarse offsets or
// ~3,000 candidates x 2 x 2 at an expansion level, a full-submap search's
// 1,423 angles x 11 x 11, 2048 point slots) the bound is 8-18 us of bytes,
// most of them the point rows' cells, and under 0.2 G adds; the kernel
// takes 0.01-0.42 ms (1.8-13% of the bound on an H100 80GB HBM3 at 700 W):
// each thread's gathers for its points form a dependent chain, and every
// block reduces kMaxTile outputs whatever its tile.
//
// Design (the simple one): one block per candidate and tile of at most
// kMaxTile of its outputs (tiles of equal size). The block's threads split
// the points, each thread walking its points (tid, tid + 256, ...) and
// keeping one running sum per output of the tile in registers; a point
// that does not count is skipped. Then each output's 256 partial sums are
// reduced in a fixed order: a warp-shuffle tree inside each warp, then the
// eight warp sums in warp order. The order depends on the point count and
// the tile only, never on the schedule or on the other candidates of the
// launch: two launches give the same bits, and a round over row bases the
// same bits as one call a candidate against its own submap's table.
// No atomics.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTile = 16;  // outputs per block

__global__ void __launch_bounds__(kThreads)
fast_scores_2d_kernel(const float* __restrict__ table, const int* __restrict__ bx, const int* __restrict__ by,
                      const uint8_t* __restrict__ valid, const int* __restrict__ cand_t,
                      const int64_t* __restrict__ cand_base, const int* __restrict__ off_x,
                      const int* __restrict__ off_y, float* __restrict__ out, int p, int valid_stride, int nxo,
                      int nyo, int nx, int ny, int level, int tile) {
  __shared__ float warp_sums[kWarps][kMaxTile];
  const int c = blockIdx.x;
  const int n_per = nxo * nyo;
  const int o0 = blockIdx.y * tile;
  const int n_tile = min(tile, n_per - o0);
  if (n_tile <= 0) return;
  const int tid = threadIdx.x;
  const size_t row0 = static_cast<size_t>(cand_t[c]) * p;
  const uint8_t* valid_row = valid + static_cast<size_t>(cand_t[c]) * valid_stride;
  const int64_t level_row = (cand_base != nullptr ? cand_base[c] : 0) + static_cast<int64_t>(level) * (nx + 1);
  const float* level_table = table + level_row * ny;
  int ox[kMaxTile], oy[kMaxTile];
  float acc[kMaxTile];
#pragma unroll
  for (int k = 0; k < kMaxTile; ++k) {
    const int o = o0 + min(k, n_tile - 1);
    ox[k] = off_x[static_cast<size_t>(c) * nxo + o / nyo];
    oy[k] = off_y[static_cast<size_t>(c) * nyo + o % nyo];
    acc[k] = 0.0f;
  }
  const int span = 1 << level;
  for (int q = tid; q < p; q += kThreads) {
    if (!valid_row[q]) continue;
    const int cx = __ldg(bx + row0 + q), cy = __ldg(by + row0 + q);
#pragma unroll
    for (int k = 0; k < kMaxTile; ++k) {
      const int ix = cx + ox[k], iy = cy + oy[k];
      if (k < n_tile && ix > -span && ix < nx && iy > -span && iy < ny) {
        const int lane = min(max(iy, 0), ny - 1);
        acc[k] = __fadd_rn(acc[k], __ldg(level_table + static_cast<int64_t>(max(ix, 0)) * ny + lane));
      }
    }
  }
  const int warp = tid / 32, lane = tid % 32;
#pragma unroll
  for (int k = 0; k < kMaxTile; ++k) {
    float v = acc[k];
#pragma unroll
    for (int d = 16; d > 0; d /= 2) v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, d));
    if (lane == 0) warp_sums[warp][k] = v;
  }
  __syncthreads();
  if (tid < n_tile) {
    float s = warp_sums[0][tid];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s = __fadd_rn(s, warp_sums[w][tid]);
    out[static_cast<size_t>(c) * n_per + o0 + tid] = s;
  }
}

}  // namespace

// table (R, ny) f32, stacked submap blocks of depth * (nx + 1) rows; bx, by
// (T, P) int32; valid (T, P) bool (valid_stride P) or (P,) (valid_stride
// 0); cand_t (C,) int32; cand_base (C,) int64 first rows of the candidates'
// submap blocks, or null for one block; off_x (C, X), off_y (C, Y) int32.
// Writes out (C, X, Y) f32. Returns the launch's cudaGetLastError().
extern "C" int hg_fast_scores_2d(const float* table, const int* bx, const int* by, const uint8_t* valid,
                                 const int* cand_t, const int64_t* cand_base, const int* off_x, const int* off_y,
                                 float* out, int c, int p, int valid_stride, int nxo, int nyo, int nx, int ny,
                                 int level, void* stream) {
  const int n_per = nxo * nyo;
  const int tiles = (n_per + kMaxTile - 1) / kMaxTile;
  const int tile = (n_per + tiles - 1) / tiles;
  fast_scores_2d_kernel<<<dim3(c, tiles), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      table, bx, by, valid, cand_t, cand_base, off_x, off_y, out, p, valid_stride, nxo, nyo, nx, ny, level, tile);
  return static_cast<int>(cudaGetLastError());
}
