// K2: score assembly for the batched 2D real-time correlative matcher.
//
// Replaces the TPU kernel hectorgrapher_tpu/ops/pallas_corr2d.py
// correlative_scores_2d_batched (kernel body _make_kernel, :37-58) together
// with the row gather its caller does before it (jnp.take(table_p, flat),
// hectorgrapher_tpu/mapping/scan_matching/correlative_2d.py:391-392). The
// TPU kernel builds one-hot weights, takes a bf16 matmul of them with the
// gathered wide-patch rows, and sums 25 lane-rolled buckets. At the lanes
// that matter that is the closed form computed here:
//
//   scores[b, g*gsz+l, ox, oy] =
//       sum_n [valid[b,n] > 0] * table[flat[b,g,n], (ox+jx)*pw + (oy+jy)],
//   (jx, jy) = divmod(delta_lin[b, g*gsz+l, n], gsz),   ox, oy < d = 2k+1.
//
// What bounds it on the H100: scattered 2-byte table reads. Each output
// reads one bf16 per point: B*G*gsz*d^2*N loads, 1.03e9 at the batched
// operating point (B=1024, G=8, gsz=5, d=7, N=512), served from L1/L2: the
// 256^2 grid's table is (266^2+1)*121*2 B = 17 MB and stays in the 50 MB
// L2. Reading rows straight from the table avoids materializing the
// gathered (B, G, N, pw^2) bf16 rows, ~1.07 GB written and read again.
//
// Design: one block per (b, g) and chunk of 256 outputs; each thread owns
// one (l, ox, oy) output and accumulates over all points in f32, in point
// order. Per tile of 256 points the block stages in shared memory the table
// row of each point (-1 when the point is not valid) and, per angle l, the
// lane offset jx*pw + jy of its delta, so the inner loop is one shared-
// memory read pair and one table load. Validity is uniform across the
// block, so the branch does not diverge. No atomics: the sum order is fixed
// and the result deterministic. wgmma/TMA tiling is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 256;
constexpr int kThreads = 256;

__global__ void correlative_scores_2d_kernel(const __nv_bfloat16* __restrict__ table,
                                             const int32_t* __restrict__ flat,
                                             const int32_t* __restrict__ dlin,
                                             const float* __restrict__ valid,
                                             float* __restrict__ out, int n, int t_pad,
                                             int n_groups, int gsz, int pw, int d) {
  extern __shared__ int smem[];
  int* s_row = smem;          // kTile: table row per point, -1 if not valid
  int* s_off = smem + kTile;  // gsz * kTile: lane offset jx*pw + jy per (l, point)

  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int dd = d * d;
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = o < gsz * dd;
  const int l = active ? o / dd : 0;
  const int r = o - l * dd;
  const int lane0 = active ? (r / d) * pw + (r % d) : 0;
  const size_t pw2 = static_cast<size_t>(pw) * pw;

  const int32_t* flat_bg = flat + (static_cast<size_t>(b) * n_groups + g) * n;
  const int32_t* dlin_bg = dlin + (static_cast<size_t>(b) * t_pad + g * gsz) * n;
  const float* valid_b = valid + static_cast<size_t>(b) * n;

  float acc = 0.f;
  for (int start = 0; start < n; start += kTile) {
    const int cnt = min(kTile, n - start);
    for (int i = threadIdx.x; i < cnt; i += blockDim.x) {
      s_row[i] = valid_b[start + i] > 0.f ? flat_bg[start + i] : -1;
    }
    for (int i = threadIdx.x; i < gsz * cnt; i += blockDim.x) {
      const int ll = i / cnt;
      const int k = i - ll * cnt;
      const int j = dlin_bg[static_cast<size_t>(ll) * n + start + k];
      const int jx = j / gsz;
      s_off[ll * kTile + k] = jx * pw + (j - jx * gsz);
    }
    __syncthreads();
    if (active) {
      const int* off = s_off + l * kTile;
#pragma unroll 4
      for (int i = 0; i < cnt; ++i) {
        const int row = s_row[i];
        if (row >= 0) acc += __bfloat162float(table[row * pw2 + off[i] + lane0]);
      }
    }
    __syncthreads();
  }
  if (active) out[(static_cast<size_t>(b) * t_pad + g * gsz + l) * dd + r] = acc;
}

}  // namespace

// table (R, pw*pw) bf16; flat (B, G, N) int32 rows of the table; dlin (B, T, N)
// int32 in [0, gsz^2); valid (B, N) f32; out (B, T, d, d) f32 with
// T = n_groups * gsz. Returns the launch's cudaGetLastError().
extern "C" int hg_correlative_scores_2d(const void* table, const int32_t* flat,
                                        const int32_t* dlin, const float* valid, float* out,
                                        int b, int n, int n_groups, int gsz, int pw, int d,
                                        void* stream) {
  const int n_out = gsz * d * d;
  const dim3 grid((n_out + kThreads - 1) / kThreads, n_groups, b);
  const size_t smem = static_cast<size_t>(1 + gsz) * kTile * sizeof(int);
  correlative_scores_2d_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(table), flat, dlin, valid, out, n, n_groups * gsz,
      n_groups, gsz, pw, d);
  return static_cast<int>(cudaGetLastError());
}
