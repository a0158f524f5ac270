// The first level of the fast frame's two-level binning, shared by
// bin_blocks.cu and bin_bigs.cu: for each 8x8-tile supertile, the first C1
// positions (in position order) whose rect covers it, and how many cover it
// in all.
//
// In the plain versions (ops/binning2.py, ops/bigbin.py) this is a stable
// sort of a (NS, n) key per supertile row: the position where the item
// covers the supertile, n otherwise. The sorted row is the covering
// positions in order, then padding, so it is a stable compaction, which
// this computes with ballots and prefix sums, in chunks of CHUNK positions:
//
//   count     each position's supertile range (the supertiles its rect
//             overlaps form a rectangle of the supertile grid) and each
//             (chunk, supertile)'s count of covering positions: `l1_count`
//             here (one CTA a chunk, shared-memory atomics), or the
//             ranking's placing kernel in bin_blocks.cu;
//   scan      each supertile's exclusive prefix of those counts over the
//             chunks, once, in place, and its total; the first level's
//             overflow, max(total - C1, 0) a supertile: `l1_scan`, a CTA
//             a group of 32 supertiles;
//   l1_emit   one CTA a (chunk, batch of 32 supertiles): each covering
//             position of the chunk at its supertile's offset for the chunk
//             (read in O(1)) plus its rank in the chunk (warp ballots and
//             the warps' counts), where that is below C1; each warp stores
//             its kept (position, supertile) pairs 32 at a time.
//
// Counts are chunk-major, (nchunks, NS), so the scan's and the emission's
// reads of a chunk's row coalesce. Only integer arithmetic: the result is
// exact.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace binning {

constexpr int SUPER = 8;            // tiles a supertile edge
constexpr int CHUNK = 512;          // positions an l1_count / l1_emit CTA
constexpr int CHUNK_WARPS = CHUNK / 32;
constexpr int MAX_SUPERTILES = 32 * 32;   // grids up to 255 tiles a side
constexpr int SCAN_THREADS = 1024;  // 32 supertiles x 32 row segments
constexpr unsigned FULL = 0xFFFFFFFFu;
// lo 255 > hi 0: covers no supertile of a grid up to 255 tiles a side
constexpr uint32_t NO_RANGE = 0xFFu;

// Python's floor and ceiling division of signed integers (b > 0).
__device__ __forceinline__ int floordiv(int a, int b) {
  const int q = a / b;
  return (q * b != a && a < 0) ? q - 1 : q;
}
__device__ __forceinline__ int ceildiv(int a, int b) {
  return -floordiv(-a, b);
}

// The supertiles a rect [x0, x1) x [y0, y1) overlaps (y relative to the
// supertile grid's first row): the plain versions' test
//   x0 < 8 sx + 8  &&  x1 > 8 sx   (and so for y)
// holds exactly for floordiv(x0, 8) <= sx <= floordiv(x1 - 1, 8). Packed as
// bytes lo_x | hi_x << 8 | lo_y << 16 | hi_y << 24, clipped to the grid,
// or NO_RANGE.
__device__ __forceinline__ uint32_t supertile_range(int x0, int y0, int x1,
                                                    int y1, int sgx,
                                                    int sgy) {
  const int lx = max(floordiv(x0, SUPER), 0);
  const int hx = min(floordiv(x1 - 1, SUPER), sgx - 1);
  const int ly = max(floordiv(y0, SUPER), 0);
  const int hy = min(floordiv(y1 - 1, SUPER), sgy - 1);
  if (lx > hx || ly > hy) return NO_RANGE;
  return (uint32_t)lx | ((uint32_t)hx << 8) | ((uint32_t)ly << 16)
         | ((uint32_t)hy << 24);
}

__device__ __forceinline__ bool in_range(uint32_t r, int sx, int sy) {
  return sx >= (int)(r & 0xFFu) && sx <= (int)((r >> 8) & 0xFFu)
         && sy >= (int)((r >> 16) & 0xFFu) && sy <= (int)(r >> 24);
}

// Adds one to each supertile count of `row` in the range r.
__device__ __forceinline__ void count_range(uint32_t r, int* row, int sgx) {
  if (r == NO_RANGE) return;
  for (int sy = (int)((r >> 16) & 0xFFu); sy <= (int)(r >> 24); ++sy)
    for (int sx = (int)(r & 0xFFu); sx <= (int)((r >> 8) & 0xFFu); ++sx)
      atomicAdd(&row[sy * sgx + sx], 1);
}

// Src: a functor (p, x0, y0, x1, y1) -> whether position p takes part,
// with its rect in global tile coordinates. The first CTA zeroes the
// overflow word (the grid has at least one CTA).
template <class Src>
__global__ void __launch_bounds__(CHUNK)
l1_count(Src src, uint32_t* __restrict__ srange, int* __restrict__ cnt,
         int* __restrict__ overflow, int n, int nchunks, int sgx, int sgy,
         int row_offset) {
  __shared__ int scnt[MAX_SUPERTILES];
  if (blockIdx.x == 0 && threadIdx.x == 0) *overflow = 0;
  if ((int)blockIdx.x >= nchunks) return;
  const int NS = sgx * sgy;
  for (int i = threadIdx.x; i < NS; i += CHUNK) scnt[i] = 0;
  __syncthreads();
  const int p = blockIdx.x * CHUNK + threadIdx.x;
  if (p < n) {
    int x0, y0, x1, y1;
    uint32_t r = NO_RANGE;
    if (src(p, x0, y0, x1, y1))
      r = supertile_range(x0, y0 - row_offset, x1, y1 - row_offset, sgx,
                          sgy);
    srange[p] = r;
    count_range(r, scnt, sgx);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < NS; i += CHUNK)
    cnt[(size_t)blockIdx.x * NS + i] = scnt[i];
}

// One CTA a group of 32 supertiles (lane = supertile), its 32 warps each a
// segment of the chunk rows: the segment sums, their prefix across the
// warps in shared memory, then each row's exclusive prefix written over its
// count, 8 rows' loads in flight. total[s] is the supertile's covering
// count; the first level drops max(total - C1, 0) of them.
__global__ void __launch_bounds__(SCAN_THREADS)
l1_scan(int* __restrict__ cnt, int* __restrict__ total,
        int* __restrict__ overflow, int nchunks, int NS, int C1) {
  __shared__ int part[32][33];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int s = blockIdx.x * 32 + lane;
  const int seg = (nchunks + 31) / 32;
  const int j0 = warp * seg, j1 = min(j0 + seg, nchunks);
  int sum = 0;
  if (s < NS) {
#pragma unroll 8
    for (int j = j0; j < j1; ++j) sum += cnt[(size_t)j * NS + s];
  }
  part[warp][lane] = sum;
  __syncthreads();
  if (s >= NS) return;
  int run = 0;
  for (int w = 0; w < warp; ++w) run += part[w][lane];
  if (warp == 31) {
    const int t = run + sum;
    total[s] = t;
    if (t > C1) atomicAdd(overflow, t - C1);
  }
  for (int j = j0; j < j1; j += 8) {
    int c[8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      c[u] = j + u < j1 ? cnt[(size_t)(j + u) * NS + s] : 0;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (j + u < j1) cnt[(size_t)(j + u) * NS + s] = run;
      run += c[u];
    }
  }
}

// v from lane src, as 32-bit words (T is a struct of 4-byte fields).
template <class T>
__device__ __forceinline__ T shfl_item(const T& v, int src) {
  static_assert(sizeof(T) % 4 == 0, "an item is whole 32-bit words");
  T out;
  const int* a = reinterpret_cast<const int*>(&v);
  int* b = reinterpret_cast<int*>(&out);
#pragma unroll
  for (int w = 0; w < (int)(sizeof(T) / 4); ++w)
    b[w] = __shfl_sync(FULL, a[w], src);
  return out;
}

// One CTA a (chunk, batch of 32 supertiles). off: (nchunks, NS) exclusive
// offsets (the scan's). Emit: a functor with `Item load(p)`, the
// position's data read once, and `store(item, s, k)`, candidate k of
// supertile s.
//
// Each warp takes a ballot of its positions for each supertile of the
// batch (lane i keeps slot i's), the CTA sums the warps before each warp
// in shared memory, and each warp lists its kept (position, supertile)
// pairs, slot by slot, each slot's in lane order, and stores them 32 at a
// time, one a lane: a lane takes pair q whatever position it came from
// (the position's item by shuffle), so the warp does not diverge over the
// positions' ranges. A CTA whose chunk covers no supertile of the batch
// that still takes candidates (offset below C1) stops at once.
template <class Emit>
__global__ void __launch_bounds__(CHUNK)
l1_emit(Emit emit, const uint32_t* __restrict__ srange,
        const int* __restrict__ off, const int* __restrict__ total, int n,
        int sgx, int NS, int C1) {
  __shared__ unsigned smask[CHUNK_WARPS][32];  // a warp's ballot, batch slot
  __shared__ int soff[32];
  __shared__ int live;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sb = blockIdx.y * 32, nbatch = min(32, NS - sb);
  const int* orow = off + (size_t)blockIdx.x * NS;
  const int p = blockIdx.x * CHUNK + threadIdx.x;
  const uint32_t r = p < n ? srange[p] : NO_RANGE;
  if (warp == 0) {
    // the next chunk's offset, or the total: the chunk covers s where the
    // two differ
    const bool lastc = (int)blockIdx.x == (int)gridDim.x - 1;
    const int o = lane < nbatch ? orow[sb + lane] : C1;
    const int o1 = lane < nbatch ? (lastc ? total[sb + lane]
                                          : orow[NS + sb + lane]) : C1;
    soff[lane] = o;
    const bool any = __any_sync(FULL, o < C1 && o1 > o);
    if (lane == 0) live = any;
  }
  __syncthreads();
  if (!live) return;                   // the same for the CTA
  unsigned mine = 0;
  int sx = sb % sgx, sy = sb / sgx;
  for (int i = 0; i < nbatch; ++i) {
    const unsigned m = __ballot_sync(FULL, in_range(r, sx, sy));
    if (lane == i) mine = m;
    if (++sx == sgx) {
      sx = 0;
      ++sy;
    }
  }
  smask[warp][lane] = mine;
  typename Emit::Item item{};
  if (__any_sync(FULL, mine != 0) && r != NO_RANGE) item = emit.load(p);
  __syncthreads();
  // slot `lane`: the k of this warp's first hit, and how many are kept
  int k0 = 0, kept = 0;
  if (lane < nbatch) {
    k0 = soff[lane];
    for (int w = 0; w < warp; ++w) k0 += __popc(smask[w][lane]);
    kept = max(0, min(__popc(mine), C1 - k0));
  }
  int incl = kept;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += v;
  }
  const int excl = incl - kept;
  const int pairs = __shfl_sync(FULL, incl, 31);
  for (int q0 = 0; q0 < pairs; q0 += 32) {
    const int q = q0 + lane;
    int slot = 0;               // the slots whose pairs all come before q
#pragma unroll
    for (int t = 0; t < 32; ++t) slot += __shfl_sync(FULL, incl, t) <= q;
    slot = min(slot, 31);
    const unsigned m = __shfl_sync(FULL, mine, slot);
    const int first = __shfl_sync(FULL, excl, slot);
    const int k = __shfl_sync(FULL, k0, slot) + q - first;
    int src = 0;
    if (q < pairs) {            // the (q - first)-th set bit of m
      unsigned b = m;
      for (int j = q - first; j > 0; --j) b &= b - 1;
      src = __ffs(b) - 1;
    }
    const typename Emit::Item it = shfl_item(item, src);
    if (q < pairs) emit.store(it, sb + slot, k);
  }
}

// The scan and the emission after a count; cnt (nchunks, NS) becomes the
// offsets, total (NS,). The scan runs for n = 0 too (it writes the totals).
template <class Emit>
void scan_and_emit(Emit emit, const uint32_t* srange, int* cnt, int* total,
                   int* overflow, int n, int sgx, int NS, int C1,
                   cudaStream_t st) {
  const int nchunks = (n + CHUNK - 1) / CHUNK;
  l1_scan<<<(NS + 31) / 32, SCAN_THREADS, 0, st>>>(cnt, total, overflow,
                                                    nchunks, NS, C1);
  if (nchunks > 0 && C1 > 0)
    l1_emit<<<dim3(nchunks, (NS + 31) / 32), CHUNK, 0, st>>>(
        emit, srange, cnt, total, n, sgx, NS, C1);
}

}  // namespace binning
