// The exact path's pair emission into the static sort buffer.
//
// Replaces XLA's emission in `emit_and_sort`,
// godotgaussiansplatting_tpu/ops/sort.py (plain XLA there, no Pallas
// kernel): the (P, max_tiles_per_splat) base slot matrix and each dense
// (capacity, width) matrix of the tier ladder and the giant path. Positions
// and keys follow `emit_base_reference` and `emit_dense_reference` in
// ops/sort.py.
//
// Write-once: a group owns the positions [pos0, pos0 + total) of the
// buffer, row r's slots at pos0 + offsets[r] + t for t < counts[r], and
// writes each of them that lies below k_max exactly once: a live slot its
// pair, a hole (a slot that an invalid splat's count reserves)
// `(INVALID_KEY ^ 0x80000000, 0)`. The groups tile
// [0, total) of the whole emission, so the buffer's positions
// [0, min(total, k_max)) are all written and nothing past them is: the
// sort (csrc/sort_pairs.cu) reads only those and writes its output's tail
// itself. Nothing fills the buffer first.
//
// Keys are written as int32 `(tile << 16 | depth16) ^ 0x80000000`: the u32
// key with its top bit flipped, as the buffer has always held it.
//
// What bounds it on Hopper: device-memory bandwidth, the live positions'
// key and value writes (8 B a position) and about 33 B of reads per splat
// (36 B per dense row); there is no arithmetic to speak of.
//
// Design, load-balanced over the output: a CTA takes `rows` consecutive
// rows, whose positions form one contiguous range, and stages the rows'
// offsets, top-left tiles, widths, depths and splat ids in shared memory
// (coalesced reads, one a row). Its 256 threads then walk the range together:
// thread j takes positions p0 + j, p0 + j + 256, ..., finds its row by a
// binary search of the staged offsets (the last row whose offset is at or
// below the position: rows of no count share an offset with the next) and
// writes its slot. Consecutive threads write consecutive positions, so the
// stores coalesce, and no lane idles on a splat of one tile. The grid is
// static (one CTA for each `rows` rows); a CTA whose range is empty or
// starts at or past k_max exits once it has read the offsets, so a CUDA
// graph holds every launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_ROWS = 1024;
// Rows a CTA of the base group takes: its splats hold about 3 pairs each
// at 1080p, so some 3,000 positions a CTA.
constexpr int BASE_ROWS = 1024;
// Positions a CTA of a dense group takes at most: rows of its width.
constexpr int DENSE_POSITIONS = 8192;
constexpr int INVALID_FLIPPED = 0x7FFFFFFF;   // 0xFFFFFFFF ^ 0x80000000

__device__ __forceinline__ int flipped_key(int tile, int depth16) {
  return (int)((((uint32_t)tile << 16) | (uint32_t)depth16) ^ 0x80000000u);
}

// One group: `R` rows, row r's `counts[r]` slots at `*pos0 + offsets[r]`
// (pos0 null: 0). Row r is splat `ids[r]` (ids null: r); with `valid`
// given, a slot of a splat that is not valid is a hole.
__global__ void __launch_bounds__(THREADS)
emit_rows_kernel(const long long* __restrict__ offsets,
                 const int* __restrict__ counts, const int* __restrict__ ids,
                 const uint8_t* __restrict__ valid,
                 const long long* __restrict__ pos0,
                 const int* __restrict__ rect,
                 const int* __restrict__ depth16, int* __restrict__ keys,
                 int* __restrict__ vals, int R, int rows, int gx,
                 long long k_max) {
  __shared__ long long off[MAX_ROWS + 1];
  __shared__ int first_tile[MAX_ROWS];   // the rect's top-left tile
  __shared__ int rect_w[MAX_ROWS];       // its width in tiles; 0: a hole
  __shared__ int depth[MAX_ROWS];
  __shared__ int splat[MAX_ROWS];
  const int r0 = blockIdx.x * rows;
  const int m = min(rows, R - r0);
  const long long start = pos0 ? pos0[0] : 0;
  for (int j = threadIdx.x; j < m; j += THREADS) off[j] = offsets[r0 + j];
  if (threadIdx.x == 0)
    off[m] = offsets[r0 + m - 1] + counts[r0 + m - 1];
  __syncthreads();
  const long long room = k_max - start;    // group positions below k_max
  const long long p1 = off[m] < room ? off[m] : room;
  if (p1 <= off[0]) return;                // no position to write
  for (int j = threadIdx.x; j < m; j += THREADS) {
    const int s = ids ? ids[r0 + j] : r0 + j;
    int w = 0, ft = 0, d = 0;
    if (off[j + 1] > off[j] && off[j] < room
        && (valid == nullptr || valid[s])) {   // a row with live slots
      const int x0 = rect[4 * s + 0], y0 = rect[4 * s + 1];
      w = max(rect[4 * s + 2] - x0, 1);
      ft = y0 * gx + x0;
      d = depth16[s];
    }
    first_tile[j] = ft;
    rect_w[j] = w;
    depth[j] = d;
    splat[j] = s;
  }
  __syncthreads();
  for (long long a = off[0] + threadIdx.x; a < p1; a += THREADS) {
    int lo = 0, hi = m;                    // off[lo] <= a < off[hi]
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (off[mid] <= a) lo = mid; else hi = mid;
    }
    const long long t = a - off[lo];
    const int w = rect_w[lo];
    int key = INVALID_FLIPPED, val = 0;
    if (w > 0) {
      const int tt = (int)t;
      const int ty = tt / w;
      const int tx = tt - ty * w;
      key = flipped_key(first_tile[lo] + ty * gx + tx, depth[lo]);
      val = splat[lo];
    }
    keys[start + a] = key;
    vals[start + a] = val;
  }
}

int launch(const long long* offsets, const int* counts, const int* ids,
           const uint8_t* valid, const long long* pos0, const int* rect,
           const int* depth16, int* keys, int* vals, int R, int rows,
           int gx, long long k_max, cudaStream_t stream) {
  if (R <= 0 || k_max <= 0) return 0;
  rows = rows < 1 ? 1 : (rows > MAX_ROWS ? MAX_ROWS : rows);
  emit_rows_kernel<<<(R + rows - 1) / rows, THREADS, 0, stream>>>(
      offsets, counts, ids, valid, pos0, rect, depth16, keys, vals, R, rows,
      gx, k_max);
  return (int)cudaGetLastError();
}

}  // namespace

// The base group: splat i's nt[i] slots at offsets[i] (its pairs where
// valid[i], holes where not), positions >= k_max dropped.
extern "C" int gs_emit_base(const void* valid, const void* rect,
                            const void* nt, const void* offsets,
                            const void* depth16, void* keys, void* vals,
                            int P, int gx, long long k_max, void* stream) {
  return launch((const long long*)offsets, (const int*)nt, nullptr,
                (const uint8_t*)valid, nullptr, (const int*)rect,
                (const int*)depth16, (int*)keys, (int*)vals, P, BASE_ROWS, gx,
                k_max, (cudaStream_t)stream);
}

// One dense group of C compacted splats: row c's nt_c[c] slots at
// *pos0 + off_c[c], the tiles of splat idx[c]'s rect in row-major order,
// positions >= k_max dropped. width, the group's widest row (nt_c[c] <=
// width: a tier takes splats of at most its width, the giants' width is the
// grid's tile count), sizes the rows a CTA takes.
extern "C" int gs_emit_dense(const void* idx, const void* nt_c,
                             const void* off_c, const void* pos0,
                             const void* rect, const void* depth16,
                             void* keys, void* vals, int C, int width, int gx,
                             long long k_max, void* stream) {
  const int rows = DENSE_POSITIONS / (width > 0 ? width : 1);
  return launch((const long long*)off_c, (const int*)nt_c, (const int*)idx,
                nullptr, (const long long*)pos0, (const int*)rect,
                (const int*)depth16, (int*)keys, (int*)vals, C, rows, gx,
                k_max, (cudaStream_t)stream);
}
