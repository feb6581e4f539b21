// K1: candidate-cell preparation for the batched 2D real-time correlative
// matcher.
//
// Replaces the TPU kernel hectorgrapher_tpu/ops/pallas_prep2d.py
// correlative_prep_2d_batched (kernel body _make_kernel, :31-67). For each
// match b, angle group g and point n it rotates the point by the group
// center angle, adds the translation, subtracts the grid corner, divides by
// the resolution and floors; it writes the wide-patch table row of that
// cell (offset by the margin), or ex*ey when the cell lies outside the
// extended grid. For each angle of the group it writes the cell's delta to
// the group center, clipped to +-half, as dx*gsz+dy.
//
// What bounds it on the H100: output bytes. Per (b, g, n) it reads 8 bytes
// of points and writes 4*(1+gsz) bytes; the arithmetic (a few dozen flops
// per angle) is far below the card's rate. At the batched operating point
// (B=1024, T=40, N=512) that is ~100 MB of int32 written, ~30 us at
// 3.35 TB/s. At the front end's shape (B=1, T=425, N=2048) it is 3.5 MB and
// launch latency dominates.
//
// Design: one thread per (b, g, n), neighbouring threads on neighbouring
// points, so every load and store is coalesced along n. cos/sin of the
// candidate angles come in as inputs (computed outside, as the JAX package
// does) and are read as warp-wide broadcasts. The discretized cells must
// agree with the plain PyTorch version bit for bit: a one-ulp difference in
// c*px - s*py + tx flips a floor at a cell boundary. So each multiply, add,
// subtract and divide is rounded on its own (__fmul_rn, __fadd_rn,
// __fsub_rn, __fdiv_rn: nvcc never contracts them into an FMA), floor is
// floorf, and the library is built with --fmad=false and without
// --use_fast_math.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void cell_of(float c, float s, float px, float py, float tx, float ty,
                                        float minx, float miny, float res, int& ix, int& iy) {
  // ((c*px - s*py + tx) - minx) / res and ((s*px + c*py + ty) - miny) / res,
  // in the JAX source's order of operations.
  const float wx = __fadd_rn(__fsub_rn(__fmul_rn(c, px), __fmul_rn(s, py)), tx);
  const float wy = __fadd_rn(__fadd_rn(__fmul_rn(s, px), __fmul_rn(c, py)), ty);
  ix = static_cast<int>(floorf(__fdiv_rn(__fsub_rn(wx, minx), res)));
  iy = static_cast<int>(floorf(__fdiv_rn(__fsub_rn(wy, miny), res)));
}

__global__ void correlative_prep_2d_kernel(const float* __restrict__ params,
                                           const float* __restrict__ px,
                                           const float* __restrict__ py,
                                           const float* __restrict__ ca,
                                           const float* __restrict__ sa,
                                           int32_t* __restrict__ flat,
                                           int32_t* __restrict__ dlin, int n, int t_pad,
                                           int n_groups, int gsz, int margin, int ex, int ey) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  if (i >= n) return;
  const float* p = params + static_cast<size_t>(b) * 8;
  const float tx = p[0], ty = p[1], minx = p[2], miny = p[3], res = p[4];
  const float x = px[static_cast<size_t>(b) * n + i];
  const float y = py[static_cast<size_t>(b) * n + i];
  const float* cb = ca + static_cast<size_t>(b) * t_pad;
  const float* sb = sa + static_cast<size_t>(b) * t_pad;
  const int half = gsz / 2;

  int cx, cy;
  cell_of(cb[g * gsz + half], sb[g * gsz + half], x, y, tx, ty, minx, miny, res, cx, cy);
  const int cxe = cx + margin;
  const int cye = cy + margin;
  const bool in_ext = cxe >= 0 && cxe < ex && cye >= 0 && cye < ey;
  flat[(static_cast<size_t>(b) * n_groups + g) * n + i] = in_ext ? cxe * ey + cye : ex * ey;

  for (int l = 0; l < gsz; ++l) {
    const int t = g * gsz + l;
    int ix = cx, iy = cy;
    if (l != half) cell_of(cb[t], sb[t], x, y, tx, ty, minx, miny, res, ix, iy);
    const int dx = min(max(ix - cx, -half), half) + half;
    const int dy = min(max(iy - cy, -half), half) + half;
    dlin[(static_cast<size_t>(b) * t_pad + t) * n + i] = dx * gsz + dy;
  }
}

}  // namespace

// params (B, 8) f32 [tx, ty, min_x, min_y, resolution, 0, 0, 0]; px, py (B, N)
// f32; ca, sa (B, T) f32 with T = n_groups * gsz. Writes flat (B, G, N) and
// delta_lin (B, T, N) int32. Returns the launch's cudaGetLastError().
extern "C" int hg_correlative_prep_2d(const float* params, const float* px, const float* py,
                                      const float* ca, const float* sa, int32_t* flat,
                                      int32_t* dlin, int b, int n, int n_groups, int gsz,
                                      int margin, int ex, int ey, void* stream) {
  constexpr int kThreads = 256;
  const dim3 grid((n + kThreads - 1) / kThreads, n_groups, b);
  correlative_prep_2d_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      params, px, py, ca, sa, flat, dlin, n, n_groups * gsz, n_groups, gsz, margin, ex, ey);
  return static_cast<int>(cudaGetLastError());
}
