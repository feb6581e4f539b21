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
// What bounds it on the H100: the gathers' memory requests. At the
// production shapes (640^2 grid, a batched round's ~3,000 point rows x 5 x 5
// coarse offsets or ~3,000 candidates x 2 x 2 at an expansion level, a
// full-submap search's 1,423 angles x 11 x 11; 2048 point slots, at most
// ~1,440 of them holding rays) the bound is 6-13 us of bytes, most of
// them the point rows' cells, and under 0.2 G adds. But each output reads
// one 4-byte cell per valid point from an L2-resident level, and a warp's
// load costs one request per distinct 32-byte sector its lanes touch: the
// coarse stage's offsets lie 32 or 64 cells apart, so no two offsets of a
// point share a sector (the TPU branch's shared row gather saves nothing
// here), and 32 consecutive points of one row touch ~32 sectors. The rate
// of those requests, not the bytes, sets K5's time (PERF.md section 6).
//
// Design: compact, then group the candidates whose gathers meet. A block
// serves G consecutive candidates (in a coarse call, G neighbouring angles
// of one scan, whose cells differ by at most a cell or so). Prologue: the
// row's flags are read four at a time as one 32-bit load, __ballot_sync /
// __popc prefix sums rank each valid point, and its (bx, by) is staged in
// shared memory in point order (CHUNK slots at a time); invalid slots cost
// no further load and no lane, a row with no valid point sums to 0. The
// outputs are cut into tasks of XC x YC (one x-offset row, or the whole
// 2 x 2); W warps take one task each (rounds of W where there are more),
// S warps split each task's points. In a warp, lane l serves candidate
// l % G and takes its points l / G, l / G + 32 / G, ... (interleaved over
// the S warps): one load covers 32 / G consecutive points at G angles, so
// neighbouring angles' lanes share sectors. Each lane keeps exactly XC * YC
// running sums and issues the gathers of U points before it adds them
// (__fadd_rn, in point order); a shuffle tree over the candidate's 32 / G
// lanes, then the S warps' sums in warp order through shared memory, give
// each output. No atomics. Instances (the wrapper picks one from X x Y;
// registers and shared memory from nvcc -Xptxas -v, no spills):
//   2 x 2 (every expansion level): G = 1, S = 4 (128 threads), one 2048-slot
//     chunk; 64 registers, 16.1 KB.
//   5 x 5 (the local coarse stage): G = 4, W = 5, S = 2 (320 threads), U = 4,
//     1024-slot chunks; 64 registers, 32.4 KB, 3 blocks an SM.
//   11 x 11 (the full-submap coarse stage): G = 4, W = 11, S = 1 (352
//     threads), U = 2; 80 registers, 32.0 KB.
//   generic (any other X x Y): G = 4, tasks of 1 x 8 over W = 8 (256
//     threads), U = 2; 72 registers, 32.0 KB. Where a row needs more than one
//     chunk, each round of tasks stages it again.
// G, S, the chunk and the launch bounds were picked by timing variants at
// the main path's shapes (PERF.md section 6): G = 4 halves the coarse
// stage's time against G = 1, and G = 8 leaves too few blocks for one
// search's 239 angles.
// A candidate's summation order depends only on its point row's valid
// pattern and its instance (G, S, the chunk, the task split), never on C,
// on its slot in the block or on the other candidates: two launches give
// the same bits, and a round over row bases the same bits as one call a
// candidate against its own submap's table.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const float* table;
  const int* bx;
  const int* by;
  const uint8_t* valid;
  const int* cand_t;
  const int64_t* cand_base;
  const int* off_x;
  const int* off_y;
  float* out;
  int c, p, valid_stride, nxo, nyo, nx, ny, level;
};

// Bit k set when slot s + k (< end) of the flag row is valid; one 32-bit
// load where the four flags lie whole and aligned.
__device__ __forceinline__ unsigned slot_flags(const uint8_t* row, int s, int end, bool wide) {
  if (wide && s + 4 <= end) {
    const unsigned w = __ldg(reinterpret_cast<const unsigned*>(row + s));
    return ((w & 0xffu) ? 1u : 0u) | ((w & 0xff00u) ? 2u : 0u) | ((w & 0xff0000u) ? 4u : 0u) |
           ((w & 0xff000000u) ? 8u : 0u);
  }
  unsigned f = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (s + k < end && row[s + k]) f |= 1u << k;
  return f;
}

// Stages the valid points of slots [q0, end) of one flag row in point
// order, point j of the row at dst[j * G]. The NW warps that share the row
// (warp w of them) rank the contiguous 128-slot groups [w * g / NW, (w + 1)
// * g / NW) each; counts holds NW ints. Returns the number staged. The
// caller brackets the call with barriers of every warp that uses the stage.
template <int NW, int G>
__device__ int compact_row(const uint8_t* vrow, const int* bxr, const int* byr, int q0, int end, int2* dst,
                           int* counts, int w, int lane) {
  const bool wide = (reinterpret_cast<uintptr_t>(vrow) & 3u) == 0;
  const int groups = (end - q0 + 127) / 128;
  const int g0 = w * groups / NW, g1 = (w + 1) * groups / NW;
  const unsigned lt = (1u << lane) - 1u;
  int base = 0, n = 0;
  if (NW > 1) {
    int mine = 0;
    for (int g = g0; g < g1; ++g) mine += __popc(slot_flags(vrow, q0 + g * 128 + lane * 4, end, wide));
#pragma unroll
    for (int d = 16; d > 0; d /= 2) mine += __shfl_xor_sync(kFull, mine, d);
    if (lane == 0) counts[w] = mine;
    __syncthreads();
    for (int v = 0; v < NW; ++v) {
      base += v < w ? counts[v] : 0;
      n += counts[v];
    }
  }
  for (int g = g0; g < g1; ++g) {
    const int s = q0 + g * 128 + lane * 4;
    const unsigned f = slot_flags(vrow, s, end, wide);
    const int cnt = __popc(f);
    int pre = 0, tot = 0;
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      const unsigned bal = __ballot_sync(kFull, (cnt >> b) & 1);
      pre += __popc(bal & lt) << b;
      tot += __popc(bal) << b;
    }
    int j = base + pre;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if ((f >> k) & 1u) dst[(j++) * G] = make_int2(__ldg(bxr + s + k), __ldg(byr + s + k));
    base += tot;
  }
  return NW > 1 ? n : base;
}

// Instance: tasks of XC x YC outputs spread over W warps; S warps split
// each task's points; G candidates a block, sharing each warp (lane l
// serves candidate l % G and walks its points l / G, l / G + 32 / G, ...,
// interleaved over the S warps); CHUNK slots staged at a time; U points in
// flight a lane; at least MINB blocks an SM.
template <int XC, int YC, int W, int S, int G, int CHUNK, int U, int MINB, bool FULL>
__global__ void __launch_bounds__(32 * W * S, MINB) fast_scores_2d_kernel(Args a) {
  constexpr int NW = W * S, PH = 32 / G, STEP = S * PH;
  static_assert(32 % G == 0, "G divides a warp");
  __shared__ int2 stage[CHUNK * G];  // point j of candidate g at j * G + g
  __shared__ int counts[NW];
  __shared__ int n_all[G];
  __shared__ float part[S > 1 ? S - 1 : 1][W * G * XC * YC];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int w = warp % W, sp = warp / W;
  const int g = lane % G, ph = lane / G;
  const int c0 = blockIdx.x * G;
  const int c = min(c0 + g, a.c - 1);  // a slot past C computes its neighbour's row and writes nothing
  const bool active = c0 + g < a.c;
  const int64_t level_row = (a.cand_base != nullptr ? a.cand_base[c] : 0) + static_cast<int64_t>(a.level) * (a.nx + 1);
  const float* level_table = a.table + level_row * a.ny;
  const int span = 1 << a.level;
  const int nx = a.nx, ny = a.ny, nxo = a.nxo, nyo = a.nyo;
  const int xt = (nxo + XC - 1) / XC, yt = (nyo + YC - 1) / YC, tasks = xt * yt;
  const int rounds = (tasks + W - 1) / W;
  const int chunks = (a.p + CHUNK - 1) / CHUNK;
  int n = 0, n_max = 0;
  for (int r = 0; r < rounds; ++r) {
    if (S > 1 && r > 0) __syncthreads();  // the last round's parts are read
    const int task = r * W + w;
    const bool mine = task < tasks;
    const int i0 = (mine ? task / yt : 0) * XC, j0 = (mine ? task % yt : 0) * YC;
    int ox[XC], oy[YC];
    bool live_x[XC], live_y[YC];
#pragma unroll
    for (int k = 0; k < XC; ++k) {
      live_x[k] = mine && (FULL || i0 + k < nxo);
      ox[k] = live_x[k] ? a.off_x[static_cast<size_t>(c) * nxo + i0 + k] : 0;
    }
#pragma unroll
    for (int k = 0; k < YC; ++k) {
      live_y[k] = mine && (FULL || j0 + k < nyo);
      oy[k] = live_y[k] ? a.off_y[static_cast<size_t>(c) * nyo + j0 + k] : 0;
    }
    float acc[XC][YC];
#pragma unroll
    for (int x = 0; x < XC; ++x)
#pragma unroll
      for (int y = 0; y < YC; ++y) acc[x][y] = 0.0f;
    for (int ch = 0; ch < chunks; ++ch) {
      if (chunks > 1 || r == 0) {
        const int q0 = ch * CHUNK, end = min(q0 + CHUNK, a.p);
        __syncthreads();  // every warp is done with the stage
        if (G == 1) {
          const int t = a.cand_t[c];
          const int m = compact_row<NW, 1>(a.valid + static_cast<size_t>(t) * a.valid_stride,
                                           a.bx + static_cast<size_t>(t) * a.p, a.by + static_cast<size_t>(t) * a.p,
                                           q0, end, stage, counts, warp, lane);
          if (warp == 0 && lane == 0) n_all[0] = m;
        } else {
          for (int k = warp; k < G; k += NW) {
            const int ck = min(c0 + k, a.c - 1), t = a.cand_t[ck];
            const int m = compact_row<1, G>(a.valid + static_cast<size_t>(t) * a.valid_stride,
                                            a.bx + static_cast<size_t>(t) * a.p, a.by + static_cast<size_t>(t) * a.p,
                                            q0, end, stage + k, counts, 0, lane);
            if (lane == 0) n_all[k] = m;
          }
        }
        __syncthreads();
        n = n_all[g];
        n_max = 0;
#pragma unroll
        for (int k = 0; k < G; ++k) n_max = max(n_max, n_all[k]);
      }
      if (!mine) continue;
      for (int base = sp * PH + ph; base - sp * PH - ph < n_max; base += STEP * U) {
        float v[U][XC][YC];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int i = base + u * STEP;
          const int2 cell = i < n ? stage[i * G + g] : make_int2(0, 0);
#pragma unroll
          for (int x = 0; x < XC; ++x) {
            const int ix = cell.x + ox[x];
            const bool row_ok = i < n && (FULL || live_x[x]) && ix > -span && ix < nx;
            const float* row = level_table + static_cast<int64_t>(max(ix, 0)) * ny;
#pragma unroll
            for (int y = 0; y < YC; ++y) {
              const int iy = cell.y + oy[y];
              v[u][x][y] = 0.0f;
              if (row_ok && (FULL || live_y[y]) && iy > -span && iy < ny) v[u][x][y] = __ldg(row + min(max(iy, 0), ny - 1));
            }
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int x = 0; x < XC; ++x)
#pragma unroll
            for (int y = 0; y < YC; ++y) acc[x][y] = __fadd_rn(acc[x][y], v[u][x][y]);
      }
    }
    // Each output: a shuffle tree over the candidate's PH lanes, then the S
    // split warps' sums in warp order.
#pragma unroll
    for (int x = 0; x < XC; ++x)
#pragma unroll
      for (int y = 0; y < YC; ++y) {
#pragma unroll
        for (int d = G; d < 32; d *= 2) acc[x][y] = __fadd_rn(acc[x][y], __shfl_xor_sync(kFull, acc[x][y], d));
        if (S > 1 && sp > 0 && ph == 0) part[sp - 1][((w * G + g) * XC + x) * YC + y] = acc[x][y];
      }
    if (S > 1) __syncthreads();
    if (!mine || sp != 0 || ph != 0 || !active) continue;
    float* out = a.out + static_cast<size_t>(c) * nxo * nyo;
#pragma unroll
    for (int x = 0; x < XC; ++x)
#pragma unroll
      for (int y = 0; y < YC; ++y) {
        float s = acc[x][y];
#pragma unroll
        for (int k = 0; k < S - 1; ++k) s = __fadd_rn(s, part[k][((w * G + g) * XC + x) * YC + y]);
        if (live_x[x] && live_y[y]) out[static_cast<size_t>(i0 + x) * nyo + j0 + y] = s;
      }
  }
}

// A FULL instance's W tasks of XC x YC cover exactly X = XC * W by Y = YC;
// it refuses any other grid.
template <int XC, int YC, int W, int S, int G, int CHUNK, int U, int MINB, bool FULL>
int launch(const Args& a, cudaStream_t stream) {
  if (FULL && (a.nxo != XC * W || a.nyo != YC)) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = static_cast<int>((static_cast<int64_t>(a.c) + G - 1) / G);
  fast_scores_2d_kernel<XC, YC, W, S, G, CHUNK, U, MINB, FULL><<<blocks, 32 * W * S, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// table (R, ny) f32, stacked submap blocks of depth * (nx + 1) rows; bx, by
// (T, P) int32; valid (T, P) bool (valid_stride P) or (P,) (valid_stride
// 0); cand_t (C,) int32; cand_base (C,) int64 first rows of the candidates'
// submap blocks, or null for one block; off_x (C, X), off_y (C, Y) int32.
// instance: 1 for X x Y = 2 x 2, 2 for 5 x 5, 3 for 11 x 11, 0 for any
// shape (ops/fast_scores_2d.py INSTANCES). The caller keeps C, Y and P at
// most 2^31 - 2049 (ops/fast_scores_2d.py launch_config), so the kernel's int indices (a block's last candidate, a
// chunk's end, a task count) stay below 2^31. Writes out (C, X, Y) f32.
// Returns the launch's cudaGetLastError(), or cudaErrorInvalidValue for an
// instance that does not fit X x Y.
extern "C" int hg_fast_scores_2d(const float* table, const int* bx, const int* by, const uint8_t* valid,
                                 const int* cand_t, const int64_t* cand_base, const int* off_x, const int* off_y,
                                 float* out, int c, int p, int valid_stride, int nxo, int nyo, int nx, int ny,
                                 int level, int instance, void* stream) {
  const Args a{table, bx, by, valid, cand_t, cand_base, off_x, off_y, out, c, p, valid_stride, nxo, nyo, nx, ny, level};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c <= 0 || nxo <= 0 || nyo <= 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (instance) {
    case 0:
      return launch<1, 8, 8, 1, 4, 1024, 2, 3, false>(a, s);
    case 1:
      return launch<2, 2, 1, 4, 1, 2048, 4, 4, true>(a, s);
    case 2:
      return launch<1, 5, 5, 2, 4, 1024, 4, 3, true>(a, s);
    case 3:
      return launch<1, 11, 11, 1, 4, 1024, 2, 2, true>(a, s);
    default:
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
