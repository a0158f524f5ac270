// The first level of the fast frame's two-level binning, shared by
// bin_blocks.cu and bin_bigs.cu: for each 8x8-tile supertile, the first C1
// positions (in position order) whose rect covers it, and how many cover it
// in all.
//
// In the plain versions (ops/binning2.py, ops/bigbin.py) this is a stable
// sort of a (NS, n) key per supertile row: the position where the item
// covers the supertile, n otherwise. The sorted row is the covering
// positions in order, then padding, so it is a stable compaction, which
// this computes with ballots and prefix sums:
//
//   l1_count  one CTA a chunk of CHUNK positions: each position's
//             supertile range (the supertiles its rect overlaps form a
//             rectangle of the supertile grid), and each supertile's count
//             of covering positions in the chunk (shared-memory atomics);
//   l1_emit   one CTA a (chunk, supertile): the covering positions before
//             the chunk (a sum of the counts), then each covering position
//             of the chunk at that offset plus its rank (a warp ballot and
//             the warps' counts), where that is below C1. A CTA whose chunk
//             starts at or past C1 stops at once.
//
// The second level reads a supertile's total from the same counts
// (`row_total`). Only integer arithmetic: the result is exact.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace binning {

constexpr int SUPER = 8;            // tiles a supertile edge
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = THREADS;      // positions an l1_count / l1_emit CTA
constexpr int MAX_SUPERTILES = 32 * 32;   // grids up to 255 tiles a side
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

// The sum of v over the CTA's THREADS threads, returned to every thread.
__device__ __forceinline__ int block_sum(int v) {
  __shared__ int part[WARPS];
  v = __reduce_add_sync(FULL, v);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  int s = 0;
  for (int w = 0; w < WARPS; ++w) s += part[w];
  __syncthreads();
  return s;
}

// The covering positions of supertile row `row` (nchunks counts) before
// chunk `upto`, to every thread.
__device__ __forceinline__ int row_total(const int* __restrict__ row,
                                         int upto) {
  int v = 0;
  for (int i = threadIdx.x; i < upto; i += THREADS) v += row[i];
  return block_sum(v);
}

// Src: a functor (p, x0, y0, x1, y1) -> whether position p takes part,
// with its rect in global tile coordinates.
template <class Src>
__global__ void __launch_bounds__(THREADS)
l1_count(Src src, uint32_t* __restrict__ srange, int* __restrict__ cnt,
         int n, int nchunks, int sgx, int sgy, int row_offset) {
  __shared__ int scnt[MAX_SUPERTILES];
  const int NS = sgx * sgy;
  for (int i = threadIdx.x; i < NS; i += THREADS) scnt[i] = 0;
  __syncthreads();
  const int p = blockIdx.x * CHUNK + threadIdx.x;
  if (p < n) {
    int x0, y0, x1, y1;
    uint32_t r = NO_RANGE;
    if (src(p, x0, y0, x1, y1))
      r = supertile_range(x0, y0 - row_offset, x1, y1 - row_offset, sgx,
                          sgy);
    srange[p] = r;
    if (r != NO_RANGE) {
      for (int sy = (int)((r >> 16) & 0xFFu); sy <= (int)(r >> 24); ++sy)
        for (int sx = (int)(r & 0xFFu); sx <= (int)((r >> 8) & 0xFFu); ++sx)
          atomicAdd(&scnt[sy * sgx + sx], 1);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < NS; i += THREADS)
    cnt[(size_t)i * nchunks + blockIdx.x] = scnt[i];
}

__global__ void __launch_bounds__(THREADS)
l1_emit(const uint32_t* __restrict__ srange, const int* __restrict__ cnt,
        int* __restrict__ cand, int n, int nchunks, int sgx, int C1) {
  __shared__ int wcount[WARPS];
  const int s = blockIdx.y;
  const int chunk = blockIdx.x;
  const int* row = cnt + (size_t)s * nchunks;
  if (row[chunk] == 0) return;                   // the same for every thread
  const int before = row_total(row, chunk);
  if (before >= C1) return;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int p = chunk * CHUNK + threadIdx.x;
  const bool hit = p < n && in_range(srange[p], s % sgx, s / sgx);
  const unsigned m = __ballot_sync(FULL, hit);
  if (lane == 0) wcount[warp] = __popc(m);
  __syncthreads();
  int k = before + __popc(m & ((1u << lane) - 1u));
  for (int w = 0; w < warp; ++w) k += wcount[w];
  if (hit && k < C1) cand[(size_t)s * C1 + k] = p;
}

// Both first-level kernels for n positions; cnt is (NS, nchunks), cand
// (NS, C1), srange (n,).
template <class Src>
cudaError_t first_level(Src src, uint32_t* srange, int* cnt, int* cand,
                        int n, int sgx, int sgy, int C1, int row_offset,
                        cudaStream_t st) {
  const int nchunks = (n + CHUNK - 1) / CHUNK;
  if (nchunks == 0) return cudaSuccess;
  l1_count<<<nchunks, THREADS, 0, st>>>(src, srange, cnt, n, nchunks, sgx,
                                        sgy, row_offset);
  l1_emit<<<dim3(nchunks, sgx * sgy), THREADS, 0, st>>>(srange, cnt, cand, n,
                                                        nchunks, sgx, C1);
  return cudaGetLastError();
}

}  // namespace binning
