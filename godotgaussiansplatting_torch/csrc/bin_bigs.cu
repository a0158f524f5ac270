// The fast frame's big-lane binning: each tile's front-to-back list of the
// big lanes covering it, gathered into its (16, OB) payload, with its live
// count, its depth-bucket prefix and the overflow.
//
// Replaces XLA's sorts, gather and histogram in `bin_bigs`,
// godotgaussiansplatting_tpu/ops/bigbin.py:55 (plain XLA there, no Pallas
// kernel), which every fast configuration and every slab of the sharded
// fast path run. Semantics follow `bin_bigs_reference` in ops/bigbin.py,
// which the tests hold to the JAX function.
//
// The big-lane table is globally depth-sorted, so lane order is front to
// back, and both of the plain version's row sorts are stable compactions:
//   L1  per 8x8-tile supertile, the first C1 valid lanes whose rect covers
//       it (bin_l1.cuh: l1_count, l1_scan and l1_emit, which stages each
//       kept candidate's lane id and rect);
//   L2  per tile (render GROUP 1), the first OB of those candidates with
//       rect.x0 < tx + 1, tx < rect.x1, rect.y0 <= ty < rect.y1.
// Each kept lane's 16 table rows are copied into the tile's payload column
// (bit for bit); the columns past the kept lanes take the sanitised dead
// column (GATE_OFF, 0 x 8, CULL_FAR, CULL_FAR, 0, DEPTH_INVALID, 0, 0, 0).
// `big_prefix` is the inclusive prefix over 128 buckets of the kept lanes'
// clamp(depth row, 0, 65535) truncated to an integer, >> 9: a per-tile
// histogram in shared memory (the buckets are not assumed to rise with
// lane order), then a warp scan. The clamp is torch's on the card: NaN
// stays NaN, else fminf(fmaxf(x, 0), 65535), so -0.0 becomes +0.0. Lane ids
// are 32-bit: N may pass 65,535 (a sharded frame's gathered big set).
//
// Tiles are written in `to_tiles` order; the tiles of a padded supertile
// past the grid's edge are written nowhere, but their covers count in the
// overflow, as in the plain version: the sum over supertiles of
// max(covers - C1, 0) (l1_scan) and over all 64 tiles of each of
// max(covers - OB, 0), summed with integer atomics into a word l1_count
// zeroes.
//
// What bounds it on Hopper: device-memory bandwidth, chiefly the (T, 16,
// OB) f32 payload written once (16.7 MB at 1080p tile 32 with OB 128), the
// prefix (T, 128) and the lane table's rects and kept rows read.
//
// Design (L2, `l2_bigs`): one CTA of 8 warps a (supertile, tile row), one
// warp a tile. The CTA stages the supertile's candidates (lane id and
// rect, as l1_emit wrote them) in shared memory, a page of PAGE at a time;
// each warp first places its tile's hits (tests 32 at once, a ballot and
// __popc) as a list of kept lane ids in shared memory, with no load in
// that loop; then copies the kept lanes, one a thread, each table row read
// as four 16-byte loads, and counts their buckets; then writes the dead
// columns [kept, OB) of its 16 rows with 16-byte stores (OB a multiple of
// 4, which every configuration the repo runs has; scalar stores
// otherwise).

#include "bin_l1.cuh"

using namespace binning;

namespace {

constexpr int PAGE = 1024;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PW = 16;         // payload rows a lane
constexpr int BUCKETS = 128;   // depth16 >> 9
constexpr float GATE_OFF = -1.0e4f;
constexpr float CULL_FAR = -1.0e6f;
constexpr float DEPTH_INVALID = 3.0e38f;

struct BigRects {
  const int4* rect;
  const unsigned char* valid;
  // lane p takes part where it is valid (an empty rect still counts at L1,
  // as in the plain version)
  __device__ bool operator()(int p, int& x0, int& y0, int& x1,
                             int& y1) const {
    const int4 r = rect[p];
    x0 = r.x;
    y0 = r.y;
    x1 = r.z;
    y1 = r.w;
    return valid[p] != 0;
  }
};

// l1_emit's staging: candidate k of supertile s is lane p, with its rect.
struct StageLanes {
  struct Item {
    int x0, y0, x1, y1, lane;
  };
  const int4* rect;
  int* cand;
  int4* crect;
  int C1;
  __device__ Item load(int p) const {
    const int4 r = rect[p];
    return Item{r.x, r.y, r.z, r.w, p};
  }
  __device__ void store(const Item& it, int s, int k) const {
    const size_t i = (size_t)s * C1 + k;
    cand[i] = it.lane;
    crect[i] = make_int4(it.x0, it.y0, it.x1, it.y1);
  }
};

__device__ __forceinline__ float dead_row(int row) {
  return row == 0 ? GATE_OFF
         : (row == 9 || row == 10) ? CULL_FAR
         : row == 12 ? DEPTH_INVALID : 0.0f;
}

// torch's clamp(x, 0, 65535) on the card, then .to(int64) >> 9.
__device__ __forceinline__ long long depth_bucket(float d) {
  const float c = (d != d) ? d : fminf(fmaxf(d, 0.0f), 65535.0f);
  return ((long long)c) >> 9;
}

// Dynamic shared memory: each warp's kept lane ids, WARPS x OB ints.
__global__ void __launch_bounds__(THREADS)
l2_bigs(const float* __restrict__ table, const int* __restrict__ cand,
        const int4* __restrict__ crect, const int* __restrict__ total,
        float* __restrict__ bigpay, int* __restrict__ nbig_out,
        int* __restrict__ overflow, int* __restrict__ prefix, int gx,
        int gy, int sgx, int C1, int OB, int row_offset) {
  extern __shared__ int s_kept[];
  __shared__ int s_lane[PAGE];
  __shared__ int4 s_rect[PAGE];
  __shared__ __align__(16) int hist[WARPS][BUCKETS];
  const int s = blockIdx.y, ly = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nc = min(total[s], C1);
  const int tx = (s % sgx) * SUPER + warp;
  const int ty_grid = (s / sgx) * SUPER + ly;   // row of the output grid
  const int ty = ty_grid + row_offset;          // row the rects are in
  const bool real = tx < gx && ty_grid < gy;
  const size_t tile = (size_t)ty_grid * gx + tx;
  float* pay = bigpay + tile * PW * OB;
  int* kept_lane = s_kept + warp * OB;
  int* h = hist[warp];
  for (int b = lane; b < BUCKETS; b += 32) h[b] = 0;
  const size_t crow = (size_t)s * C1;
  // 1. place: the tile's covering candidates in order, the first OB kept
  int nb = 0;
  for (int base = 0; base < nc; base += PAGE) {
    const int n = min(PAGE, nc - base);
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += THREADS) {
      s_lane[i] = cand[crow + base + i];
      s_rect[i] = crect[crow + base + i];
    }
    __syncthreads();
    for (int j0 = 0; j0 < n; j0 += 32) {
      const int j = j0 + lane;
      bool hit = false;
      if (j < n) {
        const int4 r = s_rect[j];
        hit = r.x < tx + 1 && tx < r.z && r.y <= ty && ty < r.w;
      }
      const unsigned m = __ballot_sync(FULL, hit);
      if (hit) {
        const int k = nb + __popc(m & ((1u << lane) - 1u));
        if (k < OB) kept_lane[k] = s_lane[j];
      }
      nb += __popc(m);
    }
  }
  const int kept = min(nb, OB);
  if (lane == 0 && nb > OB) atomicAdd(overflow, nb - OB);
  if (!real) return;
  __syncwarp();
  // 2. the kept columns, a lane each: the table row as four 16-byte loads
  for (int k = lane; k < kept; k += 32) {
    const float4* src =
        reinterpret_cast<const float4*>(table + (size_t)kept_lane[k] * PW);
    const float4 q[4] = {src[0], src[1], src[2], src[3]};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      pay[(4 * i) * OB + k] = q[i].x;
      pay[(4 * i + 1) * OB + k] = q[i].y;
      pay[(4 * i + 2) * OB + k] = q[i].z;
      pay[(4 * i + 3) * OB + k] = q[i].w;
    }
    const long long b = depth_bucket(q[3].x);    // row 12
    if (b >= 0 && b < BUCKETS) atomicAdd(&h[b], 1);
  }
  // 3. the dead columns [kept, OB) of each row: scalars up to a multiple of
  // 4, then 16-byte stores where the rows are 16-byte aligned (OB % 4 == 0)
  const int head = (OB % 4 == 0) ? min((kept + 3) & ~3, OB) : OB;
  for (int i = lane; i < PW * (head - kept); i += 32) {
    const int row = i / (head - kept);
    pay[row * OB + kept + i % (head - kept)] = dead_row(row);
  }
  const int n4 = (OB - head) / 4;
#pragma unroll 4
  for (int row = 0; row < PW; ++row) {
    const float d = dead_row(row);
    float4* dst = reinterpret_cast<float4*>(pay + row * OB + head);
    for (int q = lane; q < n4; q += 32) dst[q] = make_float4(d, d, d, d);
  }
  if (lane == 0) nbig_out[tile] = kept;
  __syncwarp();
  // inclusive prefix: lane owns buckets 4 lane .. 4 lane + 3
  const int4 c = *reinterpret_cast<const int4*>(h + 4 * lane);
  const int s1 = c.x, s2 = s1 + c.y, s3 = s2 + c.z, s4 = s3 + c.w;
  int incl = s4;
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += v;
  }
  const int excl = incl - s4;
  *reinterpret_cast<int4*>(prefix + tile * BUCKETS + 4 * lane) =
      make_int4(excl + s1, excl + s2, excl + s3, excl + s4);
}

}  // namespace

extern "C" int gs_bin_bigs_chunk() { return CHUNK; }

// table (N, 16) f32, rect (N, 4) int32, valid (N,) bool: the BigSet.
// Scratch: srange (N,), cnt (nchunks, NS), total (NS,), cand (NS, C1)
// int32, crect (NS, C1, 4) int32. Outputs: bigpay (T, 16, OB) f32, nbig
// (T,), overflow () and prefix (T, 128) int32. Grids up to 255 tiles a
// side.
extern "C" int gs_bin_bigs(const void* table, const void* rect,
                           const void* valid, void* srange, void* cnt,
                           void* total, void* cand, void* crect,
                           void* bigpay, void* nbig, void* overflow,
                           void* prefix, int N, int gx, int gy, int C1,
                           int OB, int row_offset, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int sgx = (gx + SUPER - 1) / SUPER, sgy = (gy + SUPER - 1) / SUPER;
  const int NS = sgx * sgy;
  if (gx <= 0 || gy <= 0 || NS > MAX_SUPERTILES || N < 0 || OB > C1)
    return (int)cudaErrorInvalidValue;
  const int nchunks = (N + CHUNK - 1) / CHUNK;
  l1_count<<<nchunks > 0 ? nchunks : 1, CHUNK, 0, st>>>(
      BigRects{(const int4*)rect, (const unsigned char*)valid},
      (uint32_t*)srange, (int*)cnt, (int*)overflow, N, nchunks, sgx, sgy,
      row_offset);
  scan_and_emit(StageLanes{(const int4*)rect, (int*)cand, (int4*)crect, C1},
                (const uint32_t*)srange, (int*)cnt, (int*)total,
                (int*)overflow, N, sgx, NS, C1, st);
  const size_t smem = (size_t)WARPS * OB * sizeof(int);
  const cudaError_t e = cudaFuncSetAttribute(l2_bigs,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  l2_bigs<<<dim3(SUPER, NS), THREADS, smem, st>>>(
      (const float*)table, (const int*)cand, (const int4*)crect,
      (const int*)total, (float*)bigpay, (int*)nbig, (int*)overflow,
      (int*)prefix, gx, gy, sgx, C1, OB, row_offset);
  return (int)cudaGetLastError();
}
