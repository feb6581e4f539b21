// K2: score assembly for the batched 2D real-time correlative matcher.
//
// Replaces the TPU kernel hectorgrapher_tpu/ops/pallas_corr2d.py
// correlative_scores_2d_batched (kernel body _make_kernel, :37-58) together
// with the row gather its caller does before it (jnp.take(table_p, flat),
// hectorgrapher_tpu/mapping/scan_matching/correlative_2d.py:391-392). Like
// the TPU kernel it computes, per (match b, angle group g), a one-hot
// bucket product and then gsz^2 shifted window sums:
//
//   bucket[(l, j), lane] = sum_n [valid[b,n] > 0] [delta_lin[b,g*gsz+l,n] = j]
//                                * table[flat[b,g,n], lane]
//   scores[b, g*gsz+l, ox, oy] = sum_j bucket[(l, j), (ox+jx)*pw + (oy+jy)]
//
// with (jx, jy) = divmod(j, gsz), ox, oy < d = 2k+1, the sum over j in j
// order, and gsz = 5, the port's ANGLE_GROUP (correlative_2d.py). The
// table's rows are `stride` bf16 lanes, pw^2 of them used and the rest
// zero, stride a multiple of 8 so that every row is 16-byte aligned.
//
// What bounds it on the H100: moving the rows. At the batched operating
// point (B=1024, G=8, N=512, 256-byte rows) the valid points name ~1.07 GB
// of rows, gathered from L2 (the 256^2 grid's table is 17 MB), and the
// one-hot product is 128 x 128 x 512 MACs per (b, g), 1.4e11 flop on the
// tensor cores; the bytes that must come from device memory (~34 us) are
// far below either. At the front end's shape (B=1, G=85, N=2048, ~200
// valid points) only 85 (b, g) items exist: latency. One block per item
// measured faster there than splitting an item's points over a cluster.
//
// Design, one block (8 warps) per (b, g):
// - Valid points only: a block-wide prefix sum over `valid` compacts the
//   block's slots into shared memory, in point order: each valid point's
//   table row and its gsz deltas.
// - Rows staged by cp.async: per 64-point tile, each row (a 128-lane chunk
//   of it) is copied in 16-byte pieces, 16 threads a row, so that a warp
//   moves two whole rows per instruction, into a 4-stage ring; three tiles
//   are in flight while one is multiplied. Empty slots of the last tile are
//   zero-filled.
// - One-hot tiles in shared memory: A[(l, j), p] = [delta(l, p) = j], 128
//   rows (l, j) (gsz^3 used) by 64 points, two buffers; each thread owns
//   fixed (point, angle) pairs and clears the 1 it set two tiles earlier.
// - Bucket on the tensor cores: wgmma m64n128k16, bf16 in, f32 sums, two
//   warpgroups of 64 bucket rows, A (K-major) and B (N-major, 128-byte
//   swizzle) straight from shared memory, issued asynchronously while the
//   threads stage the tile after next and build the next one-hot tile.
//   0/1 times bf16 is exact; each bucket entry is an f32 sum of table
//   values, as on the TPU's MXU.
// - Combine in shared memory: the bucket replaces the ring, and one thread
//   per output adds its gsz^2 windows in j order (gsz is a constant, so
//   the window offsets are too). Windows wider than 128 lanes (pw^2 > 128)
//   run chunk by chunk; the lane of window j grows with j, so chunk after
//   chunk is still j order.
// The order of every sum is fixed: no atomics, the same bits on every run.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kRows = 128;  // bucket rows (l, j): gsz^3 <= 128
constexpr int kLanes = 128;  // table lanes per chunk
constexpr int kTileK = 64;  // points per staged tile
constexpr int kStages = 4;
// Tiles in shared memory are in wgmma's canonical layouts. The staged rows
// (B, K = points by N = lanes, N-major) use the 128-byte swizzle: 1 KB
// atoms of 8 points by 64 lanes, point p's 16-byte piece c (lanes 8c..8c+7)
// at (p / 8) * kKBlockB + (c / 8) * 1024 + (p % 8) * 128 + ((c ^ p) % 8) * 16,
// so that the 8 pieces of a row's half land in 8 distinct bank groups. The
// one-hot tile (A, M = rows (l, j) by K = points, K-major) has no swizzle: 8 x
// 8 "core matrices" of 128 contiguous bytes, row r, points 8c..8c+7 at
// c * kKBlockA + (r / 8) * 128 + (r % 8) * 16.
constexpr int kKBlockB = kLanes / 8 * 128;  // bytes per 8 points of staged rows (two atoms)
constexpr int kKBlockA = kRows / 8 * 128;  // bytes per 8 points of a one-hot tile
constexpr int kPitchF = kLanes + 8;  // floats per bucket row
constexpr int kSeg = 1024;  // slots compacted at a time (4 per thread)
constexpr int kGsz = 5;  // angles per group: the port's ANGLE_GROUP
static_assert(kThreads == 4 * kTileK, "each thread stages 4 pieces of a tile");
constexpr int kTileB = kTileK / 8 * kKBlockB;  // one stage of staged rows
constexpr int kTileA = kTileK / 8 * kKBlockA;  // one one-hot tile
constexpr int kStageBytes = kStages * kTileB;
constexpr int kOneHotBytes = 2 * kTileA;
constexpr int kBucketBytes = kRows * kPitchF * 4;
constexpr int kUnionBytes =
    kStageBytes + kOneHotBytes > kBucketBytes ? kStageBytes + kOneHotBytes : kBucketBytes;
// Shared memory: the staging ring and two one-hot tiles, then the bucket
// chunk over them; the compacted points; the scan's warp sums; then the
// block's scores (n_out floats, sized at launch).
constexpr int kOffOneHot = kStageBytes;
constexpr int kOffRow = kUnionBytes;
constexpr int kOffDl = kOffRow + kSeg * 4;
constexpr int kOffWarp = kOffDl + kGsz * kSeg;
constexpr int kOffPart = kOffWarp + 32 * 4;
constexpr int kSmemAlign = 1024;  // the swizzled atoms' alignment
constexpr uint16_t kOne = 0x3f80;  // bf16 1.0

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, or 16 zero bytes when src_bytes is 0.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A shared-memory matrix descriptor of wgmma: start address, leading and
// stride byte offsets (16-byte units) and the swizzle mode (0: none, 1:
// 128 bytes). K-major without swizzle: lbo between core matrices along K,
// sbo along M. N-major with the 128-byte swizzle: lbo between atoms along
// N, sbo between groups of 8 along K.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo, uint64_t swizzle) {
  return static_cast<uint64_t>((smem_addr(p) >> 4) & 0x3fff) | static_cast<uint64_t>((lbo >> 4) & 0x3fff) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3fff) << 32 | swizzle << 62;
}

// d (64 rows x 128 lanes of f32, the warpgroup's fragments) += A B, A
// (64 x 16 bf16, K-major) and B (16 x 128 bf16, N-major) from shared memory.
__device__ __forceinline__ void wgmma_64x128x16(float d[64], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// The warpgroup-wide wgmma steps; each first reconverges the warp, as
// .aligned instructions require.
__device__ __forceinline__ void wgmma_fence() {
  __syncwarp();
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  __syncwarp();
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  __syncwarp();
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Makes this thread's shared-memory writes visible to wgmma's (async) reads.
__device__ __forceinline__ void fence_async_smem() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// Exclusive prefix sum of v over the block; `total` gets the block's sum.
__device__ __forceinline__ int block_scan(int v, int* s_warp, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int kWarps = kThreads / 32;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? s_warp[lane] : 0;
    for (int o = 1; o < kWarps; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kWarps) s_warp[lane] = w;
  }
  __syncthreads();
  const int before = (warp ? s_warp[warp - 1] : 0) + x - v;
  total = s_warp[kWarps - 1];
  __syncthreads();  // s_warp is reused by the next scan
  return before;
}

__global__ void __launch_bounds__(kThreads, 2)
correlative_scores_2d_kernel(const __nv_bfloat16* __restrict__ table, const int32_t* __restrict__ flat,
                             const int32_t* __restrict__ dlin, const float* __restrict__ valid,
                             float* __restrict__ out, int n, int n_groups, int pw, int d, int stride, bool vec) {
  constexpr int gsz = kGsz;
  static_assert(gsz * gsz * gsz <= kRows, "the bucket's one-hot rows (l, j)");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((kSmemAlign - (smem_addr(smem_raw) & (kSmemAlign - 1))) & (kSmemAlign - 1));
  unsigned char* s_stage = smem;
  float* s_bucket = reinterpret_cast<float*>(smem);
  unsigned char* s_onehot = smem + kOffOneHot;  // two one-hot tiles
  int32_t* s_row = reinterpret_cast<int32_t*>(smem + kOffRow);  // compacted points' table rows
  uint8_t* s_dl = smem + kOffDl;  // their deltas, [l][point]
  int* s_warp = reinterpret_cast<int*>(smem + kOffWarp);
  float* s_part = reinterpret_cast<float*>(smem + kOffPart);  // this block's scores

  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int t_pad = n_groups * gsz;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 2, tq = lane & 3;
  const int wg = warp >> 2;  // warpgroup: bucket rows 64 wg .. 64 wg + 63
  constexpr int gsz2 = gsz * gsz;
  const int n_out = gsz * d * d;

  const int n_seg = (n + kSeg - 1) / kSeg;
  const float* valid_b = valid + static_cast<size_t>(b) * n;
  const int32_t* flat_bg = flat + (static_cast<size_t>(b) * n_groups + g) * n;
  const int32_t* dlin_bg = dlin + (static_cast<size_t>(b) * t_pad + static_cast<size_t>(g) * gsz) * n;
  const int n_chunks = (pw * pw + kLanes - 1) / kLanes;

  // Compacts the valid points of slots [s0, s1) into s_row / s_dl, in
  // point order; returns their number. Thread tid takes slots s0 + 4 tid
  // + [0, 4): all its loads are issued before the first is used (16-byte
  // ones when `vec`: N a multiple of 4 and the inputs 16-byte aligned).
  auto compact = [&](int s0, int s1) {
    const int i0 = s0 + 4 * tid;
    float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    int f[4] = {0, 0, 0, 0};
    int dl[gsz][4] = {};
    if (vec && i0 + 3 < s1) {
      const float4 a = *reinterpret_cast<const float4*>(valid_b + i0);
      const int4 r = *reinterpret_cast<const int4*>(flat_bg + i0);
      v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
      f[0] = r.x, f[1] = r.y, f[2] = r.z, f[3] = r.w;
#pragma unroll
      for (int l = 0; l < gsz; ++l) {
        const int4 e = *reinterpret_cast<const int4*>(dlin_bg + static_cast<size_t>(l) * n + i0);
        dl[l][0] = e.x, dl[l][1] = e.y, dl[l][2] = e.z, dl[l][3] = e.w;
      }
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (i0 + u < s1) {
          v[u] = valid_b[i0 + u];
          f[u] = flat_bg[i0 + u];
#pragma unroll
          for (int l = 0; l < gsz; ++l) dl[l][u] = dlin_bg[static_cast<size_t>(l) * n + i0 + u];
        }
      }
    }
    int m = 0;
#pragma unroll
    for (int u = 0; u < 4; ++u) m += (i0 + u < s1 && v[u] > 0.0f) ? 1 : 0;
    int total;
    int pos = block_scan(m, s_warp, total);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (i0 + u < s1 && v[u] > 0.0f) {
        s_row[pos] = f[u];
#pragma unroll
        for (int l = 0; l < gsz; ++l) s_dl[l * kSeg + pos] = static_cast<uint8_t>(dl[l][u]);
        ++pos;
      }
    }
    __syncthreads();
    return total;
  };

  // The one-hot tiles: A[(l, j), p] = 1 where point p of the tile has delta
  // j at angle l. Thread tid owns the (point, angle) pairs tid and tid +
  // 256 of every tile, and remembers where it set the 1 in each of the two
  // tiles (set0: even tiles, set1: odd; -1: nowhere), so that it clears
  // that entry before it sets the next one.
  int set0[2], set1[2], col_off[2], dl_off[2], row0[2];
  bool owns[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int e = tid + h * kThreads, p = e % kTileK, l = e / kTileK;
    owns[h] = e < kTileK * gsz;
    col_off[h] = (p >> 3) * kKBlockA + (p & 7) * 2;
    dl_off[h] = l * kSeg + p;
    row0[h] = l * gsz2;
  }
  int count = 0;
  auto build_onehot = [&](int tile) {
    unsigned char* a = s_onehot + (tile & 1) * kTileA;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!owns[h]) continue;
      const int q = tile * kTileK + (dl_off[h] & (kTileK - 1));
      int set = (tile & 1) ? set1[h] : set0[h];
      if (set >= 0) *reinterpret_cast<uint16_t*>(a + set) = 0;
      set = -1;
      if (q < count) {
        const int row = row0[h] + s_dl[dl_off[h] + tile * kTileK];
        set = col_off[h] + (row >> 3) * 128 + (row & 7) * 16;
        *reinterpret_cast<uint16_t*>(a + set) = kOne;
      }
      if (tile & 1) {
        set1[h] = set;
      } else {
        set0[h] = set;
      }
    }
  };

  for (int o = tid; o < n_out; o += kThreads) s_part[o] = 0.0f;
  __syncthreads();

  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    // The one-hot tiles start at zero (the last chunk's bucket lay over them).
    for (int e = tid; e < kOneHotBytes / 16; e += kThreads)
      reinterpret_cast<int4*>(s_onehot)[e] = make_int4(0, 0, 0, 0);
    set0[0] = set0[1] = set1[0] = set1[1] = -1;
    __syncthreads();
    const int lane0 = chunk * kLanes;
    const int pieces = min(kLanes, stride - lane0) / 8;  // 16-byte pieces of a row in this chunk
    float acc[64];
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] = 0.0f;

    for (int s = 0; s < n_seg; ++s) {
      if (n_seg > 1 || chunk == 0) count = compact(s * kSeg, min(n, (s + 1) * kSeg));
      const int n_tiles = (count + kTileK - 1) / kTileK;
      // Tile `tile`'s rows into its stage: sixteen threads a row, one 16-byte
      // piece each, so that a warp copies two whole rows at a time; thread
      // tid takes rows tid / 16 + 16 i (the empty slots of the last tile
      // are zero-filled). One commit group per call.
      const int cp_piece = tid & 15, cp_row = tid >> 4;
      const int cp_dst = (cp_row >> 3) * kKBlockB + (cp_piece >> 3) * 1024 + (cp_row & 7) * 128 +
                         (((cp_piece ^ cp_row) & 7) << 4);
      auto issue = [&](int tile) {
        if (tile < n_tiles && cp_piece < pieces) {
          const uint32_t dst = smem_addr(s_stage + (tile % kStages) * kTileB + cp_dst);
#pragma unroll
          for (int i = 0; i < kTileK / 16; ++i) {
            const int q = tile * kTileK + cp_row + 16 * i;
            const bool live = q < count;
            const __nv_bfloat16* src =
                table + (live ? static_cast<size_t>(s_row[q]) * stride : 0) + lane0 + cp_piece * 8;
            cp_async16(dst + i * 2 * kKBlockB, src, live ? 16 : 0);
          }
        }
        cp_async_commit();
      };
      for (int i = 0; i < kStages - 1; ++i) issue(i);
      if (n_tiles > 0) build_onehot(0);
      for (int tile = 0; tile < n_tiles; ++tile) {
        wgmma_wait_all();  // the last tile's products have read their stage and one-hot tile
        cp_async_wait<kStages - 2>();
        fence_async_smem();
        __syncthreads();  // the tile's rows and one-hot have landed; the last tile's buffers are free
        // This tile's products run while the threads stage tile + 2 and
        // build the one-hot tile + 1 (other buffers).
        const unsigned char* st = s_stage + (tile % kStages) * kTileB;
        const unsigned char* at = s_onehot + (tile & 1) * kTileA + wg * 8 * 128;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kTileK; kk += 16) {
          wgmma_64x128x16(acc, smem_desc(at + (kk >> 3) * kKBlockA, kKBlockA, 128, 0),
                          smem_desc(st + (kk >> 3) * kKBlockB, 1024, kKBlockB, 1));
        }
        wgmma_commit();
        issue(tile + kStages - 1);
        if (tile + 1 < n_tiles) build_onehot(tile + 1);
      }
      wgmma_wait_all();
      cp_async_wait<0>();
      __syncthreads();  // every warp is done with the ring, the one-hot tiles and the compacted points
    }

    // The block's bucket chunk, over the ring.
    {
      const int r = 64 * wg + 16 * (warp & 3) + grp;
#pragma unroll
      for (int nt = 0; nt < 16; ++nt) {
        const int col = nt * 8 + 2 * tq;
        *reinterpret_cast<float2*>(s_bucket + r * kPitchF + col) = make_float2(acc[4 * nt], acc[4 * nt + 1]);
        *reinterpret_cast<float2*>(s_bucket + (r + 8) * kPitchF + col) = make_float2(acc[4 * nt + 2], acc[4 * nt + 3]);
      }
    }
    __syncthreads();

    // The chunk's share of every score: its gsz^2 windows, in j order (the
    // lane of window j grows with j, so chunk after chunk is j order too).
    for (int o = tid; o < n_out; o += kThreads) {
      const int l = o / (d * d), r = o - l * d * d, ox = r / d;
      const int base = ox * pw + (r - ox * d) - lane0;
      const float* bl = s_bucket + l * gsz2 * kPitchF;
      float w[gsz2];
#pragma unroll
      for (int j = 0; j < gsz2; ++j) {
        const int q = base + (j / gsz) * pw + j % gsz;  // window j's lane
        w[j] = (q >= 0 && q < kLanes) ? bl[j * kPitchF + q] : 0.0f;
      }
      float v = s_part[o];
#pragma unroll
      for (int j = 0; j < gsz2; ++j) {
        const int q = base + (j / gsz) * pw + j % gsz;
        if (q >= 0 && q < kLanes) v += w[j];
      }
      s_part[o] = v;
    }
    __syncthreads();  // the bucket is read before the next chunk's ring and one-hot tiles overwrite it
  }

  float* out_bg = out + (static_cast<size_t>(b) * t_pad + static_cast<size_t>(g) * gsz) * d * d;
  for (int o = tid; o < n_out; o += kThreads) out_bg[o] = s_part[o];
}

int g_smem_set = 0;  // the dynamic shared memory the kernel is set up for

}  // namespace

// table (R, stride) bf16, stride a multiple of 8 and >= pw*pw, 16-byte
// aligned; flat (B, G, N) int32 rows of the table; dlin (B, T, N) int32 in
// [0, gsz^2); valid (B, N) f32; out (B, T, d, d) f32 with T = n_groups *
// gsz and gsz = 5. One block per (b, g). Returns the launch's CUDA error
// code.
extern "C" int hg_correlative_scores_2d(const void* table, const int32_t* flat, const int32_t* dlin,
                                        const float* valid, float* out, int b, int n, int n_groups, int gsz,
                                        int pw, int d, int stride, void* stream) {
  if (gsz != kGsz) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = kOffPart + ((kGsz * d * d * 4 + 15) & ~15) + kSmemAlign;
  if (smem > g_smem_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(correlative_scores_2d_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    g_smem_set = smem;
  }
  // 16-byte loads of the point slots only where every row starts 16-byte aligned.
  const auto addr = [](const void* p) { return reinterpret_cast<uintptr_t>(p); };
  const bool vec = n % 4 == 0 && ((addr(flat) | addr(dlin) | addr(valid)) & 15) == 0;
  correlative_scores_2d_kernel<<<dim3(n_groups, b), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(table), flat, dlin, valid, out, n, n_groups, pw, d, stride, vec);
  return static_cast<int>(cudaGetLastError());
}
