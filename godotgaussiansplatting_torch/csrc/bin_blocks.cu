// The fast frame's block binning: each tile's list of covering blocks in
// depth order, their packed depth ranges, counts and the overflow.
//
// Replaces XLA's sorts in `bin_blocks2`, godotgaussiansplatting_tpu/ops/
// binning2.py:39 (plain XLA there, no Pallas kernel), which the shipped
// frame, v4, quality="fast" and every slab of the sharded fast path run.
// Semantics follow `bin_blocks2_reference` in ops/binning2.py, which the
// tests hold to the JAX function.
//
// The plain version's three sorts:
//   order  the global pre-sort of the B (min16 << 16 | max16) depth keys,
//          stable: position p in depth order is block gidx[p]. Here a
//          chunked stable ranking of the int32 keys (the u32 key ^ 2^31,
//          the same order), in two kernels: `rank_sort` sorts each chunk
//          of RANK_CHUNK (key, index) pairs in shared memory (a bitonic
//          network; the index breaks ties, so the order is stable) and
//          writes the chunk's bucket prefix (its keys below each of
//          BUCKETS values of their top bits); `rank_place` gives each key
//          its global position: its rank in its own chunk plus, for every
//          other chunk, the count of keys <= it in a chunk before its own
//          and < it in a chunk after (that chunk's keys of lower buckets,
//          then a search of its run of the key's bucket);
//   L1     per 8x8-tile supertile, the first C1 positions whose non-empty
//          rect covers it (bin_l1.cuh). `rank_place` also counts each
//          (chunk, supertile)'s covering positions, with global atomics
//          into the counts `rank_sort` zeroed; `l1_scan` turns them into
//          offsets once; `l1_emit` places the candidates; `l2_stage`, a
//          thread a kept candidate, stages each once with its 64-bit tile
//          mask;
//   L2     per tile of a supertile, the first C2 of those candidates whose
//          rect covers the tile and whose 8x4 coverage-bitmap bit for the
//          tile is set: their block ids and packed (min16 << 16 | max16)
//          ranges, the count clamped to C2, and the valid-splat sum over
//          every covering candidate (not only the first C2): `l2_blocks`.
// The plain version's L2 key packs the block id under the position, and
// its pad is C1 << bid_bits; here the pad is written as the values that
// key masks to: -1 ids and -1 (0xFFFFFFFF) ranges.
//
// Tiles are written in the plain version's `to_tiles` order (row-major over
// the tile grid); the tiles of a padded supertile past the grid's edge are
// written nowhere, but their covers count in the overflow, as in the plain
// version: overflow = sum over supertiles of max(covers - C1, 0) + sum over
// all 64 tiles of each of max(covers - C2, 0), summed with integer atomics
// (the same total in any order) into a word `rank_sort` zeroes.
//
// What bounds it on Hopper: device-memory bandwidth. The block meta is read
// once (rect 16 B, depth range 8 B a block, bitmap and count of the kept
// candidates) and the (T, C2) id and range lists and the counts written
// once; at 1080p tile 32 that is some 5.4 MB, under 2 microseconds. The
// work between is latency: six dependent launches (rank_sort, rank_place,
// l1_scan, l1_emit, l2_stage, l2_blocks), no memset and no library call.
// Each of them fused with its neighbour measured slower on the card (the
// scan as rank_place's last CTA, the staging in l1_emit or in l2_blocks).
// rank_place costs B * (B / RANK_CHUNK) (key, chunk) pairs (45,440
// bricks: 45 chunks, 2M pairs, two prefix words and a short search each),
// which grows with B squared: a chunk a few thousand keys wide would be
// the next step past a few hundred thousand blocks. Its warps share out a
// CTA's 32 keys' chunks, so a warp's loads touch one or two lines; 8 lanes
// a key, each on other chunks, measured slower (a load then touches as
// many lines as lanes).
//
// `l2_blocks` runs a CTA of 8 warps a (supertile, tile row), one warp a
// tile: the CTA copies the staged rows into shared memory (coalesced, a
// page of PAGE), each warp tests 32 masks at once and places the hits with
// a ballot and __popc, then pads its rows with 16-byte stores.

#include "bin_l1.cuh"

using namespace binning;

namespace {

constexpr int PAGE = 1024;
constexpr int THREADS = 256;
constexpr int RANK_CHUNK = 1024;    // keys a rank_sort CTA, one a thread
constexpr int BUCKET_BITS = 11;     // a chunk's bucket prefix: top bits
constexpr int BUCKETS = 1 << BUCKET_BITS;
constexpr int PLACE_WARPS = 16;     // warps that share a slot's chunks
constexpr int PLACE_THREADS = 32 * PLACE_WARPS;

// The int32 sort key of block i: (min16 << 16 | max16) ^ 2^31, whose signed
// order is the u32 key's.
struct DepthKeys {
  const int *min_depth, *max_depth;
  __device__ int operator()(int i) const {
    return (int)((((uint32_t)min_depth[i] << 16)
                  | ((uint32_t)max_depth[i] & 0xFFFFu)) ^ 0x80000000u);
  }
};

struct GivenKeys {
  const int* keys;
  __device__ int operator()(int i) const { return keys[i]; }
};

// Keeps the smaller or the larger of v and its partner o in a bitonic step.
__device__ __forceinline__ unsigned long long bitonic_pick(
    unsigned long long v, unsigned long long o, int t, int j, int k) {
  const bool up = (t & k) == 0, low = (t & j) == 0;
  return (up == low) ? (v < o ? v : o) : (v < o ? o : v);
}

// Each CTA sorts RANK_CHUNK (key, index) pairs, one a thread, as u64
// ((key ^ 2^31) << 32 | index): pairs are distinct, so the order is the
// stable one. Steps with a partner in the warp shuffle; the others go
// through two alternating shared-memory buffers (one barrier a step). Then
// the chunk's bucket prefix: pre[b] (per chunk, BUCKETS + 1) counts its
// keys whose top BUCKET_BITS bits (of key ^ 2^31) are below b, a search of
// the sorted chunk a bucket. The grid also zeroes `nzero` count words and
// the overflow word (CTA 0), for the kernels after it.
template <class Key>
__global__ void __launch_bounds__(RANK_CHUNK)
rank_sort(Key key, int* __restrict__ skey, int* __restrict__ sidx,
          int* __restrict__ prefix, int n, int* __restrict__ zero,
          int nzero, int* __restrict__ overflow) {
  __shared__ unsigned long long buf[2][RANK_CHUNK];
  __shared__ uint32_t ukey[RANK_CHUNK];
  for (int i = blockIdx.x * RANK_CHUNK + threadIdx.x; i < nzero;
       i += gridDim.x * RANK_CHUNK)
    zero[i] = 0;
  if (overflow != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    *overflow = 0;
  const int t = threadIdx.x, base = blockIdx.x * RANK_CHUNK, i = base + t;
  if (base >= n) return;                          // the same for the CTA
  unsigned long long v =
      i < n ? ((unsigned long long)((uint32_t)key(i) ^ 0x80000000u) << 32)
                  | (uint32_t)i
            : ~0ull;                              // padding sorts last
  int b = 0;
  for (int k = 2; k <= RANK_CHUNK; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      unsigned long long o;
      if (j >= 32) {
        buf[b][t] = v;
        __syncthreads();
        o = buf[b][t ^ j];
        b ^= 1;
      } else {
        o = __shfl_xor_sync(FULL, v, j);
      }
      v = bitonic_pick(v, o, t, j, k);
    }
  }
  const uint32_t uk = (uint32_t)(v >> 32);
  if (i < n) {
    skey[i] = (int)(uk ^ 0x80000000u);
    sidx[i] = (int)(uint32_t)v;
  }
  ukey[t] = uk;
  __syncthreads();
  const int len = min(RANK_CHUNK, n - base);
  int* pre = prefix + (size_t)blockIdx.x * (BUCKETS + 1);
  for (int bk = t; bk <= BUCKETS; bk += RANK_CHUNK) {
    int c = len;
    if (bk < BUCKETS) {
      const uint32_t lim = (uint32_t)bk << (32 - BUCKET_BITS);
      c = 0;
#pragma unroll
      for (int step = RANK_CHUNK; step > 0; step >>= 1)
        if (c + step <= len && ukey[c + step - 1] < lim) c += step;
    }
    pre[bk] = c;
  }
}

// A CTA 32 sorted slots (one chunk's), one a lane, and PLACE_WARPS warps
// that share out the other chunks: a warp's 32 lanes read one chunk
// together with near keys, so a load touches one or two lines. A slot's
// position is its rank in its own chunk plus, for every other chunk, the
// count of keys <= it (a chunk before) or < it (after): the chunk's keys in
// buckets below the slot's (its bucket prefix), and those of its bucket
// that pass (binary lifting over that bucket's run, which is short unless
// keys pile up in a bucket). The warps' counts are summed in shared memory
// and warp 0 hands (position, index) to Place.
template <class Place>
__global__ void __launch_bounds__(PLACE_THREADS)
rank_place(const int* __restrict__ skey, const int* __restrict__ sidx,
           const int* __restrict__ prefix, Place place, int n) {
  __shared__ int part[PLACE_WARPS][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int e = blockIdx.x * 32 + lane;
  const int nr = (n + RANK_CHUNK - 1) / RANK_CHUNK;
  int pos = 0;
  if (e < n) {
    const int k = skey[e], own = e / RANK_CHUNK;
    const int bk = (int)(((uint32_t)k ^ 0x80000000u) >> (32 - BUCKET_BITS));
    for (int ch = warp; ch < nr; ch += PLACE_WARPS) {
      if (ch == own) continue;
      const int* pre = prefix + (size_t)ch * (BUCKETS + 1) + bk;
      const int lo = __ldg(pre), m = __ldg(pre + 1) - lo;
      const int* a = skey + (size_t)ch * RANK_CHUNK + lo;
      const bool le = ch < own;
      int c = 0;
      for (int step = m > 0 ? 1 << (31 - __clz(m)) : 0; step > 0;
           step >>= 1) {
        if (c + step <= m) {
          const int x = __ldg(a + c + step - 1);
          if (x < k || (le && x == k)) c += step;
        }
      }
      pos += lo + c;
    }
  }
  part[warp][lane] = pos;
  __syncthreads();
  if (warp == 0 && e < n) {
    pos = e % RANK_CHUNK;
    for (int w = 0; w < PLACE_WARPS; ++w) pos += part[w][lane];
    place(pos, sidx[e]);
  }
}

// The ranking alone: gidx[position] = index.
struct PlaceIndex {
  int* gidx;
  __device__ void operator()(int pos, int id) const { gidx[pos] = id; }
};

// The ranking of the bricks: gidx, and position pos's supertile range
// (where its block's rect is non-empty) counted in its chunk's row.
struct PlaceBricks {
  int* gidx;
  const int4* rect;
  uint32_t* srange;
  int* cnt;
  int sgx, sgy, row_offset;
  __device__ void operator()(int pos, int id) const {
    gidx[pos] = id;
    const int4 r = rect[id];
    uint32_t sr = NO_RANGE;
    if (r.z > r.x && r.w > r.y)
      sr = supertile_range(r.x, r.y - row_offset, r.z, r.w - row_offset,
                           sgx, sgy);
    srange[pos] = sr;
    count_range(sr, cnt + (size_t)(pos / CHUNK) * sgx * sgy, sgx);
  }
};

// l1_emit's output: candidate k of supertile s is position p.
struct CandPositions {
  struct Item {
    int p;
  };
  int* cand;
  int C1;
  __device__ Item load(int p) const { return Item{p}; }
  __device__ void store(const Item& it, int s, int k) const {
    cand[(size_t)s * C1 + k] = it.p;
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
// of the (NS, C1) rows: its tile mask for the supertile, id, packed depth
// range and count term.
struct StageBricks {
  const int* gidx;
  const int4* rect;
  const int *bitmap, *min_depth, *max_depth, *num_valid;
  unsigned long long* cmask;
  int *cgid, *cmm, *cnv;
  int C1, sgx, row_offset;
  __device__ void operator()(int s, int k, int p) const {
    const int gid = gidx[p];
    const int4 r = rect[gid];
    const uint32_t packed = (uint32_t)r.x | ((uint32_t)r.y << 8)
                            | ((uint32_t)r.z << 16) | ((uint32_t)r.w << 24);
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

// A CTA a (piece of THREADS candidates, supertile): a thread a kept
// candidate.
__global__ void __launch_bounds__(THREADS)
l2_stage(const int* __restrict__ total, const int* __restrict__ cand,
         StageBricks stage) {
  const int s = blockIdx.y, k = blockIdx.x * THREADS + threadIdx.x;
  if (k < min(total[s], stage.C1))
    stage(s, k, cand[(size_t)s * stage.C1 + k]);
}

// One CTA of 8 warps a (supertile, tile row), one warp a tile: the CTA
// copies a page of the staged rows into shared memory, each warp tests 32
// masks at once and places the hits with a ballot and __popc.
__global__ void __launch_bounds__(THREADS)
l2_blocks(const int* __restrict__ total,
          const unsigned long long* __restrict__ cmask,
          const int* __restrict__ cgid, const int* __restrict__ cmm,
          const int* __restrict__ cnv, int* __restrict__ tb,
          int* __restrict__ nb_out, int* __restrict__ tmm,
          int* __restrict__ ncand_out, int* __restrict__ overflow, int gx,
          int gy, int sgx, int C1, int C2) {
  __shared__ unsigned long long s_mask[PAGE];
  __shared__ int s_gid[PAGE], s_mm[PAGE], s_nv[PAGE];
  const int s = blockIdx.y, ly = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nc = min(total[s], C1);
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
  if (!real) return;
  // the pad [kept, C2): scalars up to a multiple of 4, then 16-byte stores
  // where the rows are 16-byte aligned (C2 a multiple of 4)
  const int head = (C2 % 4 == 0) ? min((kept + 3) & ~3, C2) : C2;
  for (int k = kept + lane; k < head; k += 32) {
    tb[out + k] = -1;
    tmm[out + k] = -1;
  }
  const int4 pad = make_int4(-1, -1, -1, -1);
  for (int k = head + 4 * lane; k < C2; k += 128) {
    *reinterpret_cast<int4*>(tb + out + k) = pad;
    *reinterpret_cast<int4*>(tmm + out + k) = pad;
  }
}

}  // namespace

extern "C" int gs_bin_blocks_chunk() { return CHUNK; }

// The stable ranking alone: gidx (n,) int32 = torch.sort(keys,
// stable=True).indices for keys (n,) int32. Scratch: skey, sidx (n,) and
// prefix (gs_bin_rank_prefix_words(n)) int32.
// Words of the ranking's bucket prefixes for n keys.
extern "C" int gs_bin_rank_prefix_words(int n) {
  return (n + RANK_CHUNK - 1) / RANK_CHUNK * (BUCKETS + 1);
}

extern "C" int gs_bin_rank(const void* keys, void* skey, void* sidx,
                           void* prefix, void* gidx, int n, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n < 0) return (int)cudaErrorInvalidValue;
  const int nr = (n + RANK_CHUNK - 1) / RANK_CHUNK;
  if (nr == 0) return (int)cudaSuccess;
  rank_sort<<<nr, RANK_CHUNK, 0, st>>>(GivenKeys{(const int*)keys},
                                       (int*)skey, (int*)sidx, (int*)prefix, n,
                                       nullptr, 0, nullptr);
  rank_place<<<(n + 31) / 32, PLACE_THREADS, 0, st>>>(
      (const int*)skey, (const int*)sidx, (const int*)prefix,
      PlaceIndex{(int*)gidx}, n);
  return (int)cudaGetLastError();
}

// rect (B, 4), bitmap, min_depth, max_depth, num_valid (B,) int32 block
// meta. Scratch: skey, sidx, gidx, srange (B,), prefix
// (gs_bin_rank_prefix_words(B)), cnt (nchunks, NS), total (NS,),
// cand (NS, C1) int32, and the staged candidates: cmask (NS, C1) int64,
// cgid, cmm, cnv (NS, C1) int32.
// Outputs: tb, tmm (T, C2), nb, ncand (T,), overflow () int32. Grids up to
// 255 tiles a side.
extern "C" int gs_bin_blocks(const void* rect, const void* bitmap,
                             const void* min_depth, const void* max_depth,
                             const void* num_valid, void* skey, void* sidx,
                             void* gidx, void* srange, void* prefix, void* cnt,
                             void* total, void* cand, void* cmask,
                             void* cgid, void* cmm, void* cnv, void* tb,
                             void* nb, void* tmm, void* ncand,
                             void* overflow, int B, int gx, int gy, int C1,
                             int C2, int row_offset, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int sgx = (gx + SUPER - 1) / SUPER, sgy = (gy + SUPER - 1) / SUPER;
  const int NS = sgx * sgy;
  if (gx <= 0 || gy <= 0 || NS > MAX_SUPERTILES || B < 0 || C2 > C1)
    return (int)cudaErrorInvalidValue;
  const int nr = (B + RANK_CHUNK - 1) / RANK_CHUNK;
  const int nchunks = (B + CHUNK - 1) / CHUNK;
  rank_sort<<<nr > 0 ? nr : 1, RANK_CHUNK, 0, st>>>(
      DepthKeys{(const int*)min_depth, (const int*)max_depth}, (int*)skey,
      (int*)sidx, (int*)prefix, B, (int*)cnt, nchunks * NS, (int*)overflow);
  if (B > 0)
    rank_place<<<(B + 31) / 32, PLACE_THREADS, 0, st>>>(
        (const int*)skey, (const int*)sidx, (const int*)prefix,
        PlaceBricks{(int*)gidx, (const int4*)rect, (uint32_t*)srange,
                    (int*)cnt, sgx, sgy, row_offset},
        B);
  scan_and_emit(CandPositions{(int*)cand, C1}, (const uint32_t*)srange,
                (int*)cnt, (int*)total, (int*)overflow, B, sgx, NS, C1, st);
  const StageBricks stage{
      (const int*)gidx, (const int4*)rect, (const int*)bitmap,
      (const int*)min_depth, (const int*)max_depth, (const int*)num_valid,
      (unsigned long long*)cmask, (int*)cgid, (int*)cmm, (int*)cnv, C1, sgx,
      row_offset};
  if (C1 > 0)
    l2_stage<<<dim3((C1 + THREADS - 1) / THREADS, NS), THREADS, 0, st>>>(
        (const int*)total, (const int*)cand, stage);
  l2_blocks<<<dim3(SUPER, NS), THREADS, 0, st>>>(
      (const int*)total, (const unsigned long long*)cmask, (const int*)cgid,
      (const int*)cmm, (const int*)cnv, (int*)tb, (int*)nb, (int*)tmm,
      (int*)ncand, (int*)overflow, gx, gy, sgx, C1, C2);
  return (int)cudaGetLastError();
}
