// The fast frame's brick build: each 128-splat brick's payload, tile rect,
// 8x4 coverage bitmap, depth range and valid count.
//
// Replaces XLA's fusion of `_frame_from_stage1` in
// godotgaussiansplatting_tpu/ops/blocks2.py (plain XLA there, no Pallas
// kernel), which the shipped frame, v4, quality="fast" and the sharded fast
// path all run. Semantics and operation order follow
// `frame_from_stage1_reference` in ops/blocks2.py, which the tests hold to
// the JAX function.
//
// What bounds it on Hopper: device-memory bandwidth. A lane reads its seven
// int32 stage-1 words (28 B) and, for the static bricks, one `taken` byte;
// it writes 32 B of word payload or 64 B of cooked payload. The per-brick
// meta (rect, bitmap, depth range, count: 32 B) is noise, and the
// arithmetic (the anisotropic extents' pow, log and square roots, the rect
// and bitmap integer math) is far below the card's compute rate.
//
// Design: one CTA of 128 threads a brick, one thread a lane, so every word
// row is one coalesced 512 B load or store. The brick's reductions (count,
// rect bounds, depth range) are warp reductions (`__reduce_*_sync`) joined
// across the four warps in shared memory; the bitmap is a
// `__reduce_or_sync` and a shared-memory OR of the four warps' words. The
// cooked branch's centre sums run the plain version's fixed pairwise tree:
// x[i] + x[i + 64], then + 32, 16, 8, 4, 2, 1. Where `taken` is given, a
// taken lane's key reads as 0xFFFFFFFF (invalid), which fuses the static
// bricks' `torch.where(taken, -1, key)` into the load.
//
// Precision: the per-lane arithmetic is torch's own on the card
// (pack_words.cuh, shared with screen_pack.cu and big_set.cu). The kernel
// is held bit-equal to its plain version.

#include "pack_words.cuh"

namespace {

constexpr int S = 128;             // lanes a brick
constexpr int WARPS = S / 32;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int BIGC = 1 << 20;

// Python's floor and ceiling division of signed integers (b > 0).
__device__ __forceinline__ int floordiv(int a, int b) {
  const int q = a / b;
  return (q * b != a && a < 0) ? q - 1 : q;
}
__device__ __forceinline__ int ceildiv(int a, int b) {
  return -floordiv(-a, b);
}

struct Params {
  int B, gx, gy, ts;
};

template <bool COOKED>
__global__ void __launch_bounds__(S)
block_frame_kernel(const uint32_t* __restrict__ key_in,
                   const uint32_t* __restrict__ ix_in,
                   const uint32_t* __restrict__ iy_in,
                   const uint32_t* __restrict__ pc1_in,
                   const uint32_t* __restrict__ pc2_in,
                   const uint32_t* __restrict__ rgb_in,
                   const uint32_t* __restrict__ idx_in,
                   const uint8_t* __restrict__ taken,
                   uint32_t* __restrict__ payload, int* __restrict__ rect_o,
                   int* __restrict__ bitmap_o, int* __restrict__ mind_o,
                   int* __restrict__ maxd_o, int* __restrict__ nv_o,
                   Params p) {
  __shared__ int red[7][WARPS];
  __shared__ uint32_t bits_w[WARPS];
  __shared__ float sx[S], sy[S];
  __shared__ float centre[2];
  const int b = blockIdx.x;
  const int s = threadIdx.x;
  const int warp = s >> 5;
  const size_t i = (size_t)b * S + s;

  uint32_t key = key_in[i];
  if (taken != nullptr && taken[i]) key = INVALID;
  const uint32_t wix = ix_in[i], wiy = iy_in[i];
  const uint32_t w1 = pc1_in[i], w2 = pc2_in[i];
  const uint32_t wrgb = rgb_in[i], widx = idx_in[i];
  const bool valid = key != INVALID;
  const uint32_t depth = key & 0xFFFFu;
  const float ix = __uint_as_float(wix), iy = __uint_as_float(wiy);
  const float ca = half_lo(w1), cb = half_hi(w1);
  const float cc = half_lo(w2), op = half_hi(w2);
  uint32_t rxb, ryb;
  extents(ca, cb, cc, op, rxb, ryb);
  if (!valid) rxb = ryb = 0;   // rx_p, ry_p
  const float rx_p = __uint_as_float(rxb << 16);
  const float ry_p = __uint_as_float(ryb << 16);
  const float ix_p = valid ? ix : CULL_FAR;
  const float iy_p = valid ? iy : CULL_FAR;

  // each lane's tile rect (_tile_rect), then the brick's
  const int4 lr = tile_rect(ix_p, iy_p, rx_p, ry_p, p.gx, p.gy, p.ts);
  int x0 = lr.x, y0 = lr.y, x1 = lr.z, y1 = lr.w;
  if (!valid) {
    x0 = y0 = BIGC;
    x1 = y1 = -BIGC;
  }
  const int v[7] = {x0, y0, -x1, -y1, valid ? (int)depth : 0xFFFF,
                    -(valid ? (int)depth : 0), valid ? 1 : 0};
  if (COOKED) {
    sx[s] = valid ? ix : 0.0f;
    sy[s] = valid ? iy : 0.0f;
  }
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const int r = __reduce_min_sync(FULL, v[k]);
    if ((s & 31) == 0) red[k][warp] = r;
  }
  const int cnt = __reduce_add_sync(FULL, v[6]);
  if ((s & 31) == 0) red[6][warp] = cnt;
  __syncthreads();
  int m[7];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    m[k] = red[k][0];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) m[k] = min(m[k], red[k][w]);
  }
  int nv = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) nv += red[6][w];
  const bool empty = nv == 0;
  const int lox = m[0], loy = m[1];
  const int bx0 = empty ? 0 : lox, by0 = empty ? 0 : loy;
  const int bx1 = empty ? 0 : max(-m[2], lox);
  const int by1 = empty ? 0 : max(-m[3], loy);

  if (COOKED && warp == 0) {
    // the centre sums, in the plain version's pairwise tree
    const int l = s;
    float ax = (sx[l] + sx[l + 64]) + (sx[l + 32] + sx[l + 96]);
    float ay = (sy[l] + sy[l + 64]) + (sy[l + 32] + sy[l + 96]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      ax = ax + __shfl_down_sync(FULL, ax, o);
      ay = ay + __shfl_down_sync(FULL, ay, o);
    }
    if (l == 0) {
      const float nv_safe = (float)max(nv, 1);
      centre[0] = clampf(rintf(ax / nv_safe), 0.0f, 16383.0f);
      centre[1] = clampf(rintf(ay / nv_safe), 0.0f, 16383.0f);
    }
  }

  // the lane's cells of the brick's 8x4 coverage bitmap
  uint32_t bits = 0;
  if (valid) {
    const int sw = max(ceildiv(bx1 - bx0, 8), 1);
    const int sh = max(ceildiv(by1 - by0, 4), 1);
    const int cx0 = min(max(floordiv(x0 - bx0, sw), 0), 7);
    const int cx1 = min(max(ceildiv(x1 - bx0, sw), cx0 + 1), 8);
    const int cy0 = min(max(floordiv(y0 - by0, sh), 0), 3);
    const int cy1 = min(max(ceildiv(y1 - by0, sh), cy0 + 1), 4);
    const uint32_t colmask = (1u << cx1) - (1u << cx0);
#pragma unroll
    for (int yrow = 0; yrow < 4; ++yrow)
      if (cy0 <= yrow && yrow < cy1) bits |= colmask << (8 * yrow);
  }
  const uint32_t wbits = __reduce_or_sync(FULL, bits);
  if ((s & 31) == 0) bits_w[warp] = wbits;

  // the payload
  uint32_t* row = payload + (size_t)b * (COOKED ? 16 : 8) * S + s;
  const uint32_t rpair = rxb | (ryb << 16);
  if (!COOKED) {
    row[0 * S] = key;
    row[1 * S] = wix;
    row[2 * S] = wiy;
    row[3 * S] = w1;
    row[4 * S] = w2;
    row[5 * S] = wrgb;
    row[6 * S] = widx;
    row[7 * S] = rpair;
  }
  __syncthreads();
  if (COOKED) {
    const float bcx = centre[0], bcy = centre[1];
    const float ixr = ix - bcx;
    const float iyr = iy - bcy;
    const float ln_op = cmin(logf(cmax(op, 1e-37f)), -1e-3f);
    const float f0q =
        -0.5f * ((ca * ixr) * ixr + (cc * iyr) * iyr) - (cb * ixr) * iyr;
    float r, g, bl;
    unpack_rgb9e5(wrgb, r, g, bl);
    const uint32_t rank =
        ((depth << 16) | ((widx >> 7) & 0xFFFFu)) ^ 0x80000000u;
    const float f[16] = {
        valid ? f0q + ln_op : GATE_OFF,
        valid ? ca * ixr + cb * iyr : 0.0f,
        valid ? cc * iyr + cb * ixr : 0.0f,
        valid ? -0.5f * ca : 0.0f,
        valid ? -0.5f * cc : 0.0f,
        valid ? -cb : 0.0f,
        valid ? r : 0.0f,
        valid ? g : 0.0f,
        valid ? bl : 0.0f,
        ix_p,
        iy_p,
        __uint_as_float(rpair),
        __uint_as_float(rank),
        __uint_as_float(widx),
        bcx,
        bcy};
#pragma unroll
    for (int k = 0; k < 16; ++k) row[k * S] = __float_as_uint(f[k]);
  }
  if (s == 0) {
    uint32_t bm = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) bm |= bits_w[w];
    reinterpret_cast<int4*>(rect_o)[b] = make_int4(bx0, by0, bx1, by1);
    bitmap_o[b] = (int)bm;
    mind_o[b] = empty ? 0xFFFF : m[4];
    maxd_o[b] = empty ? 0xFFFF : -m[5];
    nv_o[b] = nv;
  }
}

}  // namespace

// words: the seven (B * 128,) int32 stage-1 streams [key, ix, iy, pc1, pc2,
// rgb9e5, idx]; taken: a (B * 128,) bool mask or null; cooked: 0 for the
// (B, 8, 128) int32 word payload, 1 for the (B, 16, 128) f32 cooked one.
extern "C" int gs_block_frame(const void* key, const void* ix, const void* iy,
                              const void* pc1, const void* pc2,
                              const void* rgb9, const void* idx,
                              const void* taken, void* payload, void* rect,
                              void* bitmap, void* min_depth, void* max_depth,
                              void* num_valid, int B, int cooked, int gx,
                              int gy, int ts, void* stream) {
  if (B <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  Params p{B, gx, gy, ts};
#define GS_ARGS                                                             \
  (const uint32_t*)key, (const uint32_t*)ix, (const uint32_t*)iy,          \
      (const uint32_t*)pc1, (const uint32_t*)pc2, (const uint32_t*)rgb9,   \
      (const uint32_t*)idx, (const uint8_t*)taken, (uint32_t*)payload,     \
      (int*)rect, (int*)bitmap, (int*)min_depth, (int*)max_depth,          \
      (int*)num_valid, p
  if (cooked)
    block_frame_kernel<true><<<B, S, 0, st>>>(GS_ARGS);
  else
    block_frame_kernel<false><<<B, S, 0, st>>>(GS_ARGS);
#undef GS_ARGS
  return (int)cudaGetLastError();
}
