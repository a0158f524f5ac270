// Per-lane arithmetic of the fast frame's Blocks stage, shared by its
// kernels (block_frame.cu, screen_pack.cu, big_set.cu): torch's own
// semantics on the card for the clamps, minima and maxima, the f16, bf16
// and rgb9e5 packing and unpacking, the anisotropic extents
// (`extents_from_conic`) and a lane's tile rect (`_tile_rect`), all in
// ops/blocks2.py.
//
// Precision: the including sources are built with --fmad=false and without
// fast-math, so every product and sum rounds on its own exactly like the
// plain version's separate torch ops, in the same order; divides and
// square roots are IEEE, log and pow are the library functions torch's
// CUDA kernels call, a divide by the tile size is a product with its f32
// reciprocal (what torch's CUDA division by a Python scalar computes),
// f16 and bf16 rounding is round-to-nearest-even (`__float2half_rn`,
// `__float2bfloat16_rn`: torch's on sm_90), `torch.round` is `rintf` and a
// float's conversion to an integer truncates (NaN gives 0).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t INVALID = 0xFFFFFFFFu;
constexpr float CULL_FAR = -1.0e6f;
constexpr float GATE_OFF = -1.0e4f;
constexpr float DEPTH_INVALID = 3.0e38f;
constexpr float BIG_RADIUS = 32.0f;

// NaN-propagating clamps, minimum and maximum, as torch.clamp /
// torch.minimum / torch.maximum compute them on the card: fmaxf / fminf,
// so that a -0.0 clamped at 0.0 is +0.0.
__device__ __forceinline__ float cmax(float x, float lo) {
  return (x != x) ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float cmin(float x, float hi) {
  return (x != x) ? x : fminf(x, hi);
}
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return cmin(cmax(x, lo), hi);
}
__device__ __forceinline__ float nanmin(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fminf(a, b));
}
__device__ __forceinline__ float nanmax(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fmaxf(a, b));
}

__device__ __forceinline__ float half_lo(uint32_t w) {
  return __half2float(__ushort_as_half((unsigned short)(w & 0xFFFFu)));
}
__device__ __forceinline__ float half_hi(uint32_t w) {
  return __half2float(__ushort_as_half((unsigned short)(w >> 16)));
}
__device__ __forceinline__ uint32_t f16_bits(float x) {
  return (uint32_t)__half_as_ushort(__float2half_rn(x));
}
__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// _pack_rgb9e5: 9-bit mantissas and a shared 5-bit exponent e with
// 2^(e-1) <= max channel < 2^e; the plain version's int64 arithmetic, its
// low 32 bits kept.
__device__ __forceinline__ uint32_t pack_rgb9e5(float r, float g, float b) {
  const float m = nanmax(nanmax(r, g), b);
  const int eb = (int)((__float_as_uint(cmax(m, 1e-12f)) >> 23) & 0xFFu) - 126;
  const int e = min(max(eb, -15), 16);
  const float s = __uint_as_float((uint32_t)(9 - e + 127) << 23);
  auto q = [&](float c) -> long long {
    return (long long)clampf(rintf(c * s), 0.0f, 511.0f);
  };
  return (uint32_t)(q(r) | (q(g) << 9) | (q(b) << 18) |
                    ((long long)(e + 15) << 27));
}

// _unpack_rgb9e5
__device__ __forceinline__ void unpack_rgb9e5(uint32_t w, float& r, float& g,
                                              float& b) {
  const int e = (int)((w >> 27) & 0x1Fu) - 15;
  const float sc = __uint_as_float((uint32_t)(e - 9 + 127) << 23);
  r = (float)(w & 0x1FFu) * sc;
  g = (float)((w >> 9) & 0x1FFu) * sc;
  b = (float)((w >> 18) & 0x1FFu) * sc;
}

// Morton spread of the low 8 bits to the even bit positions (_spread8).
__device__ __forceinline__ uint32_t spread8(uint32_t v) {
  v = (v | (v << 4)) & 0x0F0Fu;
  v = (v | (v << 2)) & 0x3333u;
  v = (v | (v << 1)) & 0x5555u;
  return v;
}

// extents_from_conic: the anisotropic alpha-reach half-widths, bf16-rounded
// (returned as their bf16 bit patterns).
__device__ __forceinline__ void extents(float ca, float cb, float cc,
                                        float op, uint32_t& rx,
                                        uint32_t& ry) {
  const float det = cmax(ca * cc - cb * cb, 1e-20f);
  const float sxx = cmax(cc / det, 0.0f);
  const float syy = cmax(ca / det, 0.0f);
  const float m = 0.5f * (sxx + syy);
  const float inv_det = (1.0f / det) * 1.0f;   // torch: reciprocal(det) * 1
  const float lam = m + sqrtf(cmax(m * m - inv_det, 0.0f));
  const float R = powf(cmax(op, 0.0f), 0.2f) * 2.5f * sqrtf(lam);
  const float vis =
      sqrtf(2.0f * cmax(logf(cmax(op, 1e-8f) * 255.0f), 0.125f));
  rx = bf16_bits(nanmin(R, vis * sqrtf(sxx)));
  ry = bf16_bits(nanmin(R, vis * sqrtf(syy)));
}

// _tile_rect: a lane's tile rect [x0, y0, x1, y1) of centre +- half-widths.
__device__ __forceinline__ int4 tile_rect(float ix, float iy, float rx,
                                          float ry, int gx, int gy, int ts) {
  const float inv_ts = 1.0f / (float)ts;
  const float gxf = (float)gx, gyf = (float)gy;
  return make_int4((int)clampf((ix - rx) * inv_ts, 0.0f, gxf),
                   (int)clampf((iy - ry) * inv_ts, 0.0f, gyf),
                   (int)clampf(ceilf((ix + rx) * inv_ts), 0.0f, gxf),
                   (int)clampf(ceilf((iy + ry) * inv_ts), 0.0f, gyf));
}

}  // namespace
