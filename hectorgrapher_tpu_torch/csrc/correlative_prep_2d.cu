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
// What bounds it on the H100: output bytes, and the instructions that make
// them. Per (b, g, n) it reads 8 bytes of points and writes 4*(1+gsz) bytes.
// At the batched operating point (B=1024, T=40, N=512) that is ~100 MB of
// int32 written, ~31 us at 3.35 TB/s; ten IEEE divisions per (b, g, n) at
// ~20 instructions each would cost about as long in issue slots. At the
// front end's shape (B=1, T=425, N=2048) it is 3.5 MB and the launch sets
// the floor.
//
// Design: one thread per 4 consecutive points, 16-byte loads of px/py and
// 16-byte stores of flat and delta_lin (scalar ones when N is not a
// multiple of 4 or an array is not 16-byte aligned); a block loops over a range of groups, so the match's
// cos/sin of those angles are read into shared memory once, and the
// match's parameters and the reciprocal of its resolution are hoisted out
// of the loop. The discretized cells must agree with the plain PyTorch
// version bit for bit: a one-ulp difference in c*px - s*py + tx flips a
// floor at a cell boundary. So each multiply, add and subtract is rounded on
// its own (__fmul_rn, __fadd_rn, __fsub_rn; the library is built with
// --fmad=false and without --use_fast_math), floor is floorf, and the
// quotient x / res is the correctly rounded one: q0 = x * rn(1/res), then
// Markstein's correction q = q0 + (x - q0*res) * rn(1/res), both steps one
// explicit __fmaf_rn, which for the normal operands here equals the IEEE
// quotient.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxAngles = 6144;  // a block's cos/sin in 48 KB of shared memory

// x / res, correctly rounded, from rcp = rn(1 / res).
__device__ __forceinline__ float quotient(float x, float res, float rcp) {
  const float q0 = __fmul_rn(x, rcp);
  const float r = __fmaf_rn(-q0, res, x);
  return __fmaf_rn(r, rcp, q0);
}

struct Match {
  float tx, ty, minx, miny, res, rcp;
};

__device__ __forceinline__ void cell_of(float c, float s, float px, float py, const Match& m, int& ix, int& iy) {
  // ((c*px - s*py + tx) - minx) / res and ((s*px + c*py + ty) - miny) / res,
  // in the JAX source's order of operations.
  const float wx = __fadd_rn(__fsub_rn(__fmul_rn(c, px), __fmul_rn(s, py)), m.tx);
  const float wy = __fadd_rn(__fadd_rn(__fmul_rn(s, px), __fmul_rn(c, py)), m.ty);
  ix = static_cast<int>(floorf(quotient(__fsub_rn(wx, m.minx), m.res, m.rcp)));
  iy = static_cast<int>(floorf(quotient(__fsub_rn(wy, m.miny), m.res, m.rcp)));
}

// Four consecutive int32 outputs at dst: one 16-byte store when `vec`,
// else the first `cnt` of them one by one.
__device__ __forceinline__ void store4(int32_t* dst, const int v[4], bool vec, int cnt) {
  if (vec) {
    *reinterpret_cast<int4*>(dst) = make_int4(v[0], v[1], v[2], v[3]);
  } else {
    for (int u = 0; u < cnt; ++u) dst[u] = v[u];
  }
}

__global__ void __launch_bounds__(kThreads)
correlative_prep_2d_kernel(const float* __restrict__ params, const float* __restrict__ px,
                           const float* __restrict__ py, const float* __restrict__ ca,
                           const float* __restrict__ sa, int32_t* __restrict__ flat,
                           int32_t* __restrict__ dlin, int n, int n_groups, int gsz, int groups_per_block,
                           int margin, int ex, int ey, bool vec) {
  extern __shared__ float s_cs[];  // cos, then sin, of the block's angles
  const int b = blockIdx.z;
  const int t_pad = n_groups * gsz;
  const int g0 = blockIdx.y * groups_per_block;
  const int g1 = min(n_groups, g0 + groups_per_block);
  const int n_ang = (g1 - g0) * gsz;
  const float* cb = ca + static_cast<size_t>(b) * t_pad + static_cast<size_t>(g0) * gsz;
  const float* sb = sa + static_cast<size_t>(b) * t_pad + static_cast<size_t>(g0) * gsz;
  for (int i = threadIdx.x; i < n_ang; i += blockDim.x) {
    s_cs[i] = cb[i];
    s_cs[n_ang + i] = sb[i];
  }
  const float* p = params + static_cast<size_t>(b) * 8;
  const Match m{p[0], p[1], p[2], p[3], p[4], __frcp_rn(p[4])};
  const int i0 = 4 * (blockIdx.x * blockDim.x + threadIdx.x);
  const int cnt = min(4, n - i0);
  float x[4] = {0.0f, 0.0f, 0.0f, 0.0f}, y[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (cnt > 0) {
    const size_t row = static_cast<size_t>(b) * n + i0;
    if (vec) {
      const float4 a = *reinterpret_cast<const float4*>(px + row);
      const float4 c = *reinterpret_cast<const float4*>(py + row);
      x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
      y[0] = c.x, y[1] = c.y, y[2] = c.z, y[3] = c.w;
    } else {
      for (int u = 0; u < cnt; ++u) {
        x[u] = px[row + u];
        y[u] = py[row + u];
      }
    }
  }
  __syncthreads();
  if (cnt <= 0) return;
  const int half = gsz / 2;
  const int none = ex * ey;

  for (int g = g0; g < g1; ++g) {
    const float* cg = s_cs + (g - g0) * gsz;
    const float* sg = s_cs + n_ang + (g - g0) * gsz;
    int cx[4], cy[4], v[4];
    for (int u = 0; u < 4; ++u) {
      cell_of(cg[half], sg[half], x[u], y[u], m, cx[u], cy[u]);
      const int cxe = cx[u] + margin, cye = cy[u] + margin;
      v[u] = (cxe >= 0 && cxe < ex && cye >= 0 && cye < ey) ? cxe * ey + cye : none;
    }
    store4(flat + (static_cast<size_t>(b) * n_groups + g) * n + i0, v, vec, cnt);
    for (int l = 0; l < gsz; ++l) {
      for (int u = 0; u < 4; ++u) {
        int ix = cx[u], iy = cy[u];
        if (l != half) cell_of(cg[l], sg[l], x[u], y[u], m, ix, iy);
        const int dx = min(max(ix - cx[u], -half), half) + half;
        const int dy = min(max(iy - cy[u], -half), half) + half;
        v[u] = dx * gsz + dy;
      }
      store4(dlin + (static_cast<size_t>(b) * t_pad + static_cast<size_t>(g) * gsz + l) * n + i0, v, vec, cnt);
    }
  }
}

int g_sm_count = 0;

}  // namespace

// params (B, 8) f32 [tx, ty, min_x, min_y, resolution, 0, 0, 0]; px, py (B, N)
// f32; ca, sa (B, T) f32 with T = n_groups * gsz. Writes flat (B, G, N) and
// delta_lin (B, T, N) int32. Returns the launch's CUDA error code.
extern "C" int hg_correlative_prep_2d(const float* params, const float* px, const float* py,
                                      const float* ca, const float* sa, int32_t* flat,
                                      int32_t* dlin, int b, int n, int n_groups, int gsz,
                                      int margin, int ex, int ey, void* stream) {
  if (g_sm_count == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&g_sm_count, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int quads = (n + 3) / 4;
  const int threads = std::min(kThreads, (quads + 31) / 32 * 32);
  const int nx = (quads + threads - 1) / threads;
  // Split the groups over blocks only as far as it takes to give every SM
  // about 8 blocks.
  const long target = 8L * g_sm_count;
  const long base = static_cast<long>(nx) * b;
  const int splits = static_cast<int>(std::min<long>(n_groups, std::max<long>(1, (target + base - 1) / base)));
  const int gpb = std::min((n_groups + splits - 1) / splits, std::max(1, kMaxAngles / gsz));
  const dim3 grid(nx, (n_groups + gpb - 1) / gpb, b);
  const size_t smem = 2 * static_cast<size_t>(gpb) * gsz * sizeof(float);
  // 16-byte loads and stores only where every row starts 16-byte aligned.
  const auto addr = [](const void* p) { return reinterpret_cast<uintptr_t>(p); };
  const bool vec = n % 4 == 0 && ((addr(px) | addr(py) | addr(flat) | addr(dlin)) & 15) == 0;
  correlative_prep_2d_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      params, px, py, ca, sa, flat, dlin, n, n_groups, gsz, gpb, margin, ex, ey, vec);
  return static_cast<int>(cudaGetLastError());
}
