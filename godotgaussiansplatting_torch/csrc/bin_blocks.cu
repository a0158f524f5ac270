// The fast frame's block binning: each tile's list of covering blocks in
// depth order, their packed depth ranges, counts and the overflow.
//
// Replaces XLA's sorts in `bin_blocks2`, godotgaussiansplatting_tpu/ops/
// binning2.py:39 (plain XLA there, no Pallas kernel), which the shipped
// frame, v4, quality="fast" and every slab of the sharded fast path run.
// Semantics follow `bin_blocks2_reference` in ops/binning2.py, which the
// tests hold to the JAX function. The global pre-sort of the B (min, max)
// depth keys stays one stable torch.sort (of int32 keys); its order
// `gidx` is this kernel's input, and the kernel reads every block field
// through it: position p in depth order is block gidx[p].
//
// Both of the plain version's row sorts are stable compactions:
//   L1  per 8x8-tile supertile, the first C1 positions whose non-empty rect
//       covers it (bin_l1.cuh: l1_count and l1_emit);
//   L2  per tile of a supertile, the first C2 of those candidates whose rect
//       covers the tile and whose 8x4 coverage-bitmap bit for the tile is
//       set: their block ids and packed (min16 << 16 | max16) ranges, the
//       count clamped to C2, and the valid-splat sum over every covering
//       candidate (not only the first C2).
// The plain version's L2 key packs the block id under the position, and
// its pad is C1 << bid_bits; here the pad is written as the values that
// key masks to: -1 ids and -1 (0xFFFFFFFF) ranges.
//
// Tiles are written in the plain version's `to_tiles` order (row-major over
// the tile grid); the tiles of a padded supertile past the grid's edge are
// written nowhere, but their covers count in the overflow, as in the plain
// version: overflow = sum over supertiles of max(covers - C1, 0) + sum over
// all 64 tiles of each of max(covers - C2, 0), summed with integer atomics
// (the same total in any order) into a word the launcher zeroes.
//
// What bounds it on Hopper: device-memory bandwidth. The block meta is read
// once (rect 16 B, bitmap, depth range and count 16 B a block, gidx 8 B)
// and the (T, C2) id and range lists and the counts written once; at 1080p
// tile 32 that is some 6 MB, a few microseconds. The supertile tests read
// the B 4-byte supertile ranges once per supertile from L2.
//
// Design. The first level splits the block axis in chunks of 256
// (bin_l1.cuh): 40 supertiles at 1080p tile 32 are far fewer than the
// card's 132 SMs. Then `l2_stage`, a thread a kept candidate, stages each
// supertile's candidates once, gathered through gidx: id, packed range,
// count term and the 64-bit mask of the supertile's 8x8 tiles the
// candidate covers (the plain version's per-tile test, with 16 divides a
// candidate, not 2 a tile). `l2_blocks` runs a CTA of 8 warps a
// (supertile, tile row), one warp a tile: the CTA copies the staged rows
// into shared memory (coalesced, a page of PAGE), each warp tests 32 masks
// at once and places the hits with a ballot and __popc.

#include "bin_l1.cuh"

using namespace binning;

namespace {

constexpr int PAGE = 1024;

struct BrickRects {
  const long long* gidx;
  const int* rect;
  // position p in depth order takes part where its block's rect is
  // non-empty
  __device__ bool operator()(int p, int& x0, int& y0, int& x1,
                             int& y1) const {
    const int* r = rect + (size_t)gidx[p] * 4;
    x0 = r[0];
    y0 = r[1];
    x1 = r[2];
    y1 = r[3];
    return x1 > x0 && y1 > y0;
  }
};

// The plain version's per-tile test of a candidate, for the 8x8 tiles of
// the supertile at (tx0, ty0) (ty0 in the rects' rows): its packed rect
// (x0 | y0 << 8 | x1 << 16 | y1 << 24) covers the tile, and the bitmap bit
// of the 8x4 cell the tile falls in is set. Bit 8 ly + lx is tile
// (tx0 + lx, ty0 + ly).
__device__ __forceinline__ unsigned long long tile_mask(uint32_t rect,
                                                        uint32_t bm, int tx0,
                                                        int ty0) {
  const int cx0 = (int)(rect & 0xFFu), cy0 = (int)((rect >> 8) & 0xFFu);
  const int cx1 = (int)((rect >> 16) & 0xFFu), cy1 = (int)(rect >> 24);
  const int sw = max(ceildiv(cx1 - cx0, 8), 1);
  const int sh = max(ceildiv(cy1 - cy0, 4), 1);
  int col[SUPER], row[SUPER];   // the cell's shift, -1 off the rect
#pragma unroll
  for (int i = 0; i < SUPER; ++i) {
    const int tx = tx0 + i, ty = ty0 + i;
    col[i] = (cx0 <= tx && tx < cx1)
                 ? min(max(floordiv(tx - cx0, sw), 0), 7) : -1;
    row[i] = (cy0 <= ty && ty < cy1)
                 ? 8 * min(max(floordiv(ty - cy0, sh), 0), 3) : -1;
  }
  unsigned long long m = 0;
#pragma unroll
  for (int ly = 0; ly < SUPER; ++ly)
#pragma unroll
    for (int lx = 0; lx < SUPER; ++lx)
      if (row[ly] >= 0 && col[lx] >= 0 && ((bm >> (row[ly] + col[lx])) & 1u))
        m |= 1ull << (SUPER * ly + lx);
  return m;
}

// Candidate k of supertile s, position p in depth order, staged at (s, k)
// of the (NS, C1) rows.
struct StageBricks {
  const long long* gidx;
  const int *rect, *bitmap, *min_depth, *max_depth, *num_valid;
  unsigned long long* cmask;
  int *cgid, *cmm, *cnv;
  int C1, sgx, row_offset;
  __device__ void operator()(int s, int k, int p) const {
    const int gid = (int)gidx[p];
    const int* r = rect + (size_t)gid * 4;
    const uint32_t packed = (uint32_t)r[0] | ((uint32_t)r[1] << 8)
                            | ((uint32_t)r[2] << 16) | ((uint32_t)r[3] << 24);
    const size_t i = (size_t)s * C1 + k;
    cmask[i] = tile_mask(packed, (uint32_t)bitmap[gid], (s % sgx) * SUPER,
                         (s / sgx) * SUPER + row_offset);
    cgid[i] = gid;
    cmm[i] = (int)(((uint32_t)min_depth[gid] << 16)
                   | ((uint32_t)max_depth[gid] & 0xFFFFu));
    // the plain version's (id | count << 24) >> 24
    cnv[i] = (int)(((long long)gid | ((long long)num_valid[gid] << 24))
                   >> 24);
  }
};

// A CTA a (piece of THREADS candidates, supertile).
__global__ void __launch_bounds__(THREADS)
l2_stage(const int* __restrict__ cnt, const int* __restrict__ cand,
         StageBricks stage, int nchunks) {
  const int s = blockIdx.y, k = blockIdx.x * THREADS + threadIdx.x;
  const int nc = min(row_total(cnt + (size_t)s * nchunks, nchunks),
                     stage.C1);
  if (k < nc) stage(s, k, cand[(size_t)s * stage.C1 + k]);
}

__global__ void __launch_bounds__(THREADS)
l2_blocks(const int* __restrict__ cnt,
          const unsigned long long* __restrict__ cmask,
          const int* __restrict__ cgid, const int* __restrict__ cmm,
          const int* __restrict__ cnv, int* __restrict__ tb,
          int* __restrict__ nb_out, int* __restrict__ tmm,
          int* __restrict__ ncand_out, int* __restrict__ overflow,
          int nchunks, int gx, int gy, int sgx, int C1, int C2) {
  __shared__ unsigned long long s_mask[PAGE];
  __shared__ int s_gid[PAGE], s_mm[PAGE], s_nv[PAGE];
  const int s = blockIdx.y, ly = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int total = row_total(cnt + (size_t)s * nchunks, nchunks);
  const int nc = min(total, C1);
  if (ly == 0 && threadIdx.x == 0 && total > C1)
    atomicAdd(overflow, total - C1);
  const int tx = (s % sgx) * SUPER + warp;
  const int ty = (s / sgx) * SUPER + ly;        // row of the output grid
  const bool real = tx < gx && ty < gy;
  const size_t tile = (size_t)ty * gx + tx;
  const size_t out = tile * C2;
  const int bit = SUPER * ly + warp;
  const size_t row = (size_t)s * C1;
  int nb = 0;
  long long ncand = 0;
  for (int base = 0; base < nc; base += PAGE) {
    const int n = min(PAGE, nc - base);
    __syncthreads();
#pragma unroll 4
    for (int i = threadIdx.x; i < n; i += THREADS) {
      s_mask[i] = cmask[row + base + i];
      s_gid[i] = cgid[row + base + i];
      s_mm[i] = cmm[row + base + i];
      s_nv[i] = cnv[row + base + i];
    }
    __syncthreads();
    for (int j0 = 0; j0 < n; j0 += 32) {
      const int j = j0 + lane;
      const bool hit = j < n && ((s_mask[j] >> bit) & 1ull);
      const unsigned m = __ballot_sync(FULL, hit);
      if (hit) {
        const int k = nb + __popc(m & ((1u << lane) - 1u));
        if (real && k < C2) {
          tb[out + k] = s_gid[j];
          tmm[out + k] = s_mm[j];
        }
        ncand += s_nv[j];
      }
      nb += __popc(m);
    }
  }
  for (int o = 16; o > 0; o >>= 1) ncand += __shfl_xor_sync(FULL, ncand, o);
  const int kept = min(nb, C2);
  if (lane == 0) {
    if (nb > C2) atomicAdd(overflow, nb - C2);
    if (real) {
      nb_out[tile] = kept;
      ncand_out[tile] = (int)ncand;
    }
  }
  if (real) {
    for (int k = kept + lane; k < C2; k += 32) {
      tb[out + k] = -1;
      tmm[out + k] = -1;
    }
  }
}

}  // namespace

extern "C" int gs_bin_blocks_chunk() { return CHUNK; }

// gidx: (B,) int64 depth order; rect (B, 4), bitmap, min_depth, max_depth,
// num_valid (B,) int32 block meta. Scratch: srange (B,), cnt (NS, nchunks),
// cand (NS, C1) int32, and the staged candidates: cmask (NS, C1) int64,
// cgid, cmm, cnv (NS, C1) int32. Outputs: tb, tmm (T, C2), nb, ncand (T,),
// overflow () int32. Grids up to 255 tiles a side.
extern "C" int gs_bin_blocks(const void* gidx, const void* rect,
                             const void* bitmap, const void* min_depth,
                             const void* max_depth, const void* num_valid,
                             void* srange, void* cnt, void* cand, void* cmask,
                             void* cgid, void* cmm, void* cnv, void* tb,
                             void* nb, void* tmm, void* ncand, void* overflow,
                             int B, int gx, int gy, int C1, int C2,
                             int row_offset, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int sgx = (gx + SUPER - 1) / SUPER, sgy = (gy + SUPER - 1) / SUPER;
  if (gx <= 0 || gy <= 0 || sgx * sgy > MAX_SUPERTILES || B < 0 || C2 > C1)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaMemsetAsync(overflow, 0, sizeof(int), st);
  if (e != cudaSuccess) return (int)e;
  e = first_level(BrickRects{(const long long*)gidx, (const int*)rect},
                  (uint32_t*)srange, (int*)cnt, (int*)cand, B, sgx, sgy, C1,
                  row_offset, st);
  if (e != cudaSuccess) return (int)e;
  const int nchunks = (B + CHUNK - 1) / CHUNK;
  const StageBricks stage{
      (const long long*)gidx, (const int*)rect, (const int*)bitmap,
      (const int*)min_depth, (const int*)max_depth, (const int*)num_valid,
      (unsigned long long*)cmask, (int*)cgid, (int*)cmm, (int*)cnv, C1, sgx,
      row_offset};
  if (C1 > 0)
    l2_stage<<<dim3((C1 + THREADS - 1) / THREADS, sgx * sgy), THREADS, 0,
               st>>>((const int*)cnt, (const int*)cand, stage, nchunks);
  l2_blocks<<<dim3(SUPER, sgx * sgy), THREADS, 0, st>>>(
      (const int*)cnt, (const unsigned long long*)cmask, (const int*)cgid,
      (const int*)cmm, (const int*)cnv, (int*)tb, (int*)nb, (int*)tmm,
      (int*)ncand, (int*)overflow, nchunks, gx, gy, sgx, C1, C2);
  return (int)cudaGetLastError();
}
