// K4: decimated-pyramid scoring of the fast 3D correlative matcher.
//
// Replaces score_sum in hectorgrapher_tpu/mapping/scan_matching/
// fast_correlative_3d.py _match_fast_3d_core (:329-436), with the rules of
// its CPU branch (:344-359, :415-424). It has no Pallas source: on the TPU
// score_sum is an XLA gather-reduce over a lax.scan of point chunks.
//
// Output (c, i, j, k), for candidate c with yaw row t = cand_t[c] and
// offsets ox = off_x[c, i], oy = off_y[c, j], oz = off_z[c, k], is the sum
// over points q in point order of the level's (bound - 0.1) value:
//   ix = bx[t, q] + ox  (likewise iy, iz), span = 2^level
//   x and z count when -span < i < n, at cell max(i, 0) >> level
//   y counts when -span < iy < ny and valid[q], at lane
//     clip(iy, 0, ny - 1) >> y_shift
//   a point with x or z out contributes the zero row, one with y out or
//   masked nothing; both add exactly 0 (table values are >= 0), so the
//   kernel skips them.
//
// What bounds it on the H100: neither bytes nor flops. At the production
// shapes (256^3 grid, ~107 yaws x 5 x 5 x 3 coarse offsets, 2,048 outputs
// per expansion level, 256 points) a launch reads ~2-4 M table values, most
// from L2, and the coarse stage has ~8,000 outputs, the expansions 2,048:
// too few threads to hide gather latency. Each launch replaces the plain
// version's ~20 eager ops per 32-point chunk.
//
// Design: one thread per output, summing over points in point order: no
// atomics, deterministic. The threads of a warp share a candidate, so the
// point cells they read are broadcasts. Splitting points across threads
// with a fixed-order second reduction, or staging a level in shared memory,
// is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
fast_scores_3d_kernel(const float* __restrict__ table, const int* __restrict__ bx, const int* __restrict__ by,
                      const int* __restrict__ bz, const uint8_t* __restrict__ valid,
                      const int* __restrict__ cand_t, const int* __restrict__ off_x,
                      const int* __restrict__ off_y, const int* __restrict__ off_z, float* __restrict__ out,
                      int n_out, int p, int nxo, int nyo, int nzo, int nx, int ny, int nz, int level,
                      int y_shift, int nx_l, int ny_l) {
  const int o = blockIdx.x * kThreads + threadIdx.x;
  if (o >= n_out) return;
  const int k = o % nzo;
  int r = o / nzo;
  const int j = r % nyo;
  r /= nyo;
  const int i = r % nxo;
  const int c = r / nxo;
  const int t = cand_t[c];
  const int ox = off_x[c * nxo + i];
  const int oy = off_y[c * nyo + j];
  const int oz = off_z[c * nzo + k];
  const int span = 1 << level;
  const size_t base = static_cast<size_t>(t) * p;
  float acc = 0.0f;
  for (int q = 0; q < p; ++q) {
    if (!valid[q]) continue;
    const int iy = __ldg(by + base + q) + oy;
    if (iy <= -span || iy >= ny) continue;
    const int ix = __ldg(bx + base + q) + ox;
    const int iz = __ldg(bz + base + q) + oz;
    if (ix <= -span || ix >= nx || iz <= -span || iz >= nz) continue;
    const int row = (max(iz, 0) >> level) * nx_l + (max(ix, 0) >> level);
    const int lane = min(max(iy, 0), ny - 1) >> y_shift;
    acc = __fadd_rn(acc, __ldg(table + static_cast<size_t>(row) * ny_l + lane));
  }
  out[o] = acc;
}

}  // namespace

// table (nz_l * nx_l + 1, ny_l) f32; bx, by, bz (T, P) int32; valid (P,)
// bool; cand_t (C,) int32; off_x (C, X), off_y (C, Y), off_z (C, Z) int32.
// Writes out (C, X, Y, Z) f32. Returns the launch's cudaGetLastError().
extern "C" int hg_fast_scores_3d(const float* table, const int* bx, const int* by, const int* bz,
                                 const uint8_t* valid, const int* cand_t, const int* off_x, const int* off_y,
                                 const int* off_z, float* out, int c, int p, int nxo, int nyo, int nzo, int nx,
                                 int ny, int nz, int level, int y_shift, int nx_l, int ny_l, void* stream) {
  const int n_out = c * nxo * nyo * nzo;
  const int blocks = (n_out + kThreads - 1) / kThreads;
  fast_scores_3d_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      table, bx, by, bz, valid, cand_t, off_x, off_y, off_z, out, n_out, p, nxo, nyo, nzo, nx, ny, nz, level,
      y_shift, nx_l, ny_l);
  return static_cast<int>(cudaGetLastError());
}
