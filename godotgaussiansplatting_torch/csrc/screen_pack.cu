// quality="fast"'s per-splat pack: the readable projection's ProjectedSplats
// -> the big-candidate chunk keys, the count of big splats and the stage-1
// words of the screen clustering.
//
// Replaces XLA's fusions of the per-splat packing in `build_block_frame2`,
// godotgaussiansplatting_tpu/ops/blocks2.py:313 (plain XLA there, no
// Pallas kernel), which quality="fast" and the sharded path's readable
// projection run. Semantics and operation order follow
// `screen_pack_reference` in ops/blocks2.py, which the tests hold to the
// JAX function. Per splat i (flat position in the (SB, sb_size) rows):
//   bkey[i]  = (depth16 << 10) | (i % CW) for a valid splat whose
//              anisotropic extent (extents_from_conic) reaches BIG_RADIUS,
//              else 0xFFFFFFFF;
//   key[i]   = ((morton & 0x7FFF) << 16) | depth16 for a valid splat, else
//              0xFFFFFFFF, morton the screen cell's (tile >> cell) Morton
//              code (the key before the big-lane extraction's `taken`);
//   ix, iy   the image position's f32 bits; pc1 = f16(ca) | f16(cb) << 16,
//   pc2 = f16(cc) | f16(opacity) << 16; rgb9 the rgb9e5 colour word;
//   num_big  the count of big splats (BigSet.residual's first term).
//
// What bounds it on Hopper: device-memory bandwidth. A splat reads 41 B
// (valid 1, depth16 4, image_pos 8, conic 12, colour 16) and writes 28 B
// (seven int32 words); its arithmetic (the extents' pow, log and square
// roots, the packing, some 80 operations) is far below the compute rate.
//
// Design: one thread a splat, every load and store coalesced across a warp;
// the big count is a warp reduction and one atomic a warp into a word the
// launcher zeroes on the stream. The arithmetic is torch's own on the card
// (pack_words.cuh): the kernel is held bit-equal to its plain version.

#include "pack_words.cuh"

namespace {

constexpr int THREADS = 256;

struct Params {
  int P, CW, cell, gx, gy, ts;
};

struct Outs {
  uint32_t *bkey, *key, *ix, *iy, *pc1, *pc2, *rgb9;
};

__global__ void __launch_bounds__(THREADS)
screen_pack_kernel(const uint8_t* __restrict__ valid,
                   const int* __restrict__ depth16,
                   const float* __restrict__ ipos,
                   const float* __restrict__ conic,
                   const float* __restrict__ color, Outs o,
                   int* __restrict__ num_big, Params p) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  int big = 0;
  if (i < p.P) {
    const bool v = valid[i] != 0;
    const uint32_t d = (uint32_t)depth16[i];
    const float ix = ipos[2 * (size_t)i], iy = ipos[2 * (size_t)i + 1];
    const float ca = conic[3 * (size_t)i], cb = conic[3 * (size_t)i + 1];
    const float cc = conic[3 * (size_t)i + 2];
    const float r = color[4 * (size_t)i], g = color[4 * (size_t)i + 1];
    const float b = color[4 * (size_t)i + 2], op = color[4 * (size_t)i + 3];

    // the screen cell's Morton code
    const float inv_ts = 1.0f / (float)p.ts;
    const int cx = min(max((int)(ix * inv_ts), 0), p.gx - 1);
    const int cy = min(max((int)(iy * inv_ts), 0), p.gy - 1);
    const uint32_t morton = spread8(((uint32_t)cx >> p.cell) & 0xFFu) |
                            (spread8(((uint32_t)cy >> p.cell) & 0xFFu) << 1);

    // bigness from the anisotropic extents
    uint32_t rxb, ryb;
    extents(ca, cb, cc, op, rxb, ryb);
    const float m = nanmax(__uint_as_float(rxb << 16),
                           __uint_as_float(ryb << 16));
    big = (v && m >= BIG_RADIUS) ? 1 : 0;

    o.bkey[i] = big ? (d << 10) | (uint32_t)(i % p.CW) : INVALID;
    o.key[i] = v ? ((morton & 0x7FFFu) << 16) | d : INVALID;
    o.ix[i] = __float_as_uint(ix);
    o.iy[i] = __float_as_uint(iy);
    o.pc1[i] = f16_bits(ca) | (f16_bits(cb) << 16);
    o.pc2[i] = f16_bits(cc) | (f16_bits(op) << 16);
    o.rgb9[i] = pack_rgb9e5(r, g, b);
  }
  const int n = __reduce_add_sync(0xFFFFFFFFu, big);
  if ((threadIdx.x & 31) == 0 && n) atomicAdd(num_big, n);
}

}  // namespace

// valid (P,) bool, depth16 (P,) int32, image_pos (P, 2), conic (P, 3) and
// color (P, 4) f32; outputs seven (P,) int32 words (bkey read as (P / CW,
// CW)) and num_big, one int32 this launcher zeroes.
extern "C" int gs_screen_pack(const void* valid, const void* depth16,
                              const void* image_pos, const void* conic,
                              const void* color, void* bkey, void* key,
                              void* ix, void* iy, void* pc1, void* pc2,
                              void* rgb9, void* num_big, int P, int CW,
                              int cell, int gx, int gy, int ts,
                              void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (P < 0 || CW <= 0 || cell < 0 || cell > 31 || gx <= 0 || gy <= 0 ||
      ts <= 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaMemsetAsync(num_big, 0, sizeof(int), st);
  if (e != cudaSuccess) return (int)e;
  if (P == 0) return 0;
  Outs o{(uint32_t*)bkey, (uint32_t*)key, (uint32_t*)ix, (uint32_t*)iy,
         (uint32_t*)pc1, (uint32_t*)pc2, (uint32_t*)rgb9};
  screen_pack_kernel<<<(P + THREADS - 1) / THREADS, THREADS, 0, st>>>(
      (const uint8_t*)valid, (const int*)depth16, (const float*)image_pos,
      (const float*)conic, (const float*)color, o, (int*)num_big,
      Params{P, CW, cell, gx, gy, ts});
  return (int)cudaGetLastError();
}
