// The big-lane table of the fast frame's Blocks stage: each taken lane's
// cooked row, tile rect and depth.
//
// Replaces XLA's fusion of `_build_big_set`,
// godotgaussiansplatting_tpu/ops/blocks2.py:269 (plain XLA there, no Pallas
// kernel), and the gathers and unpacking before it, which every fast
// configuration and every slab of the sharded fast path run. Semantics and
// operation order follow `big_set_reference` in ops/blocks2.py, which the
// tests hold to the JAX function. Lane i reads the packed words (key, ix,
// iy, pc1, pc2, rgb9) of splat tk_idx[i] and, valid where tk_ok[i], writes
// its 16-row cooked table row (power features about its rounded centre,
// colour, position, the bf16 half-width pair, depth16 as f32, the source
// index's bits, the centre), its tile rect and its depth16; an invalid
// lane writes the plain version's sentinels (GATE_OFF, CULL_FAR,
// DEPTH_INVALID, a zero rect, depth 0xFFFF).
//
// What bounds it on Hopper: device-memory bandwidth, though a frame holds
// at most some 40,960 lanes: a lane reads its index and flag (9 B) and 24 B
// of words, and writes 84 B (the 64 B row, the 16 B rect, the depth).
//
// Design: one thread a lane; the row is written as four 16-byte stores and
// the rect as one. The arithmetic is torch's own on the card
// (pack_words.cuh): the kernel is held bit-equal to its plain version.

#include "pack_words.cuh"

namespace {

constexpr int THREADS = 128;

struct Words {
  const uint32_t *key, *ix, *iy, *pc1, *pc2, *rgb9;
};

__global__ void __launch_bounds__(THREADS)
big_set_kernel(Words w, const long long* __restrict__ tk_idx,
               const uint8_t* __restrict__ tk_ok, float4* __restrict__ table,
               int4* __restrict__ rect, int* __restrict__ depth16, int N,
               int gx, int gy, int ts) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= N) return;
  const long long src = tk_idx[i];
  const bool valid = tk_ok[i] != 0;
  const uint32_t key = w.key[src];
  const float ix = __uint_as_float(w.ix[src]);
  const float iy = __uint_as_float(w.iy[src]);
  const uint32_t w1 = w.pc1[src], w2 = w.pc2[src];
  const float ca = half_lo(w1), cb = half_hi(w1);
  const float cc = half_lo(w2), op = half_hi(w2);
  float r, g, b;
  unpack_rgb9e5(w.rgb9[src], r, g, b);

  const float bcx = clampf(rintf(ix), 0.0f, 16383.0f);
  const float bcy = clampf(rintf(iy), 0.0f, 16383.0f);
  const float ixr = ix - bcx;
  const float iyr = iy - bcy;
  const float ln_op = cmin(logf(cmax(op, 1e-37f)), -1e-3f);
  const float f0q =
      -0.5f * ((ca * ixr) * ixr + (cc * iyr) * iyr) - (cb * ixr) * iyr;
  uint32_t rxb, ryb;
  extents(ca, cb, cc, op, rxb, ryb);
  if (!valid) rxb = ryb = 0;   // rx_p, ry_p
  const float rx_p = __uint_as_float(rxb << 16);
  const float ry_p = __uint_as_float(ryb << 16);
  const float ix_p = valid ? ix : CULL_FAR;
  const float iy_p = valid ? iy : CULL_FAR;
  const uint32_t d = key & 0xFFFFu;

  float4* row = table + (size_t)i * 4;
  row[0] = make_float4(valid ? f0q + ln_op : GATE_OFF,
                       valid ? ca * ixr + cb * iyr : 0.0f,
                       valid ? cc * iyr + cb * ixr : 0.0f,
                       valid ? -0.5f * ca : 0.0f);
  row[1] = make_float4(valid ? -0.5f * cc : 0.0f, valid ? -cb : 0.0f,
                       valid ? r : 0.0f, valid ? g : 0.0f);
  row[2] = make_float4(valid ? b : 0.0f, ix_p, iy_p,
                       __uint_as_float(rxb | (ryb << 16)));
  row[3] = make_float4(valid ? (float)d : DEPTH_INVALID,
                       __int_as_float((int)src), bcx, bcy);
  rect[i] = valid ? tile_rect(ix_p, iy_p, rx_p, ry_p, gx, gy, ts)
                  : make_int4(0, 0, 0, 0);
  depth16[i] = valid ? (int)d : 0xFFFF;
}

// The launch's floor: the same grid, no work.
__global__ void __launch_bounds__(THREADS) empty_kernel() {}

}  // namespace

// key, ix, iy, pc1, pc2, rgb9: (P,) int32 words; tk_idx (N,) int64 flat
// positions, tk_ok (N,) bool; table (N, 16) f32, rect (N, 4) int32,
// depth16 (N,) int32.
extern "C" int gs_big_set(const void* key, const void* ix, const void* iy,
                          const void* pc1, const void* pc2, const void* rgb9,
                          const void* tk_idx, const void* tk_ok, void* table,
                          void* rect, void* depth16, int N, int gx, int gy,
                          int ts, void* stream) {
  if (N < 0 || ts <= 0) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  Words w{(const uint32_t*)key, (const uint32_t*)ix, (const uint32_t*)iy,
          (const uint32_t*)pc1, (const uint32_t*)pc2, (const uint32_t*)rgb9};
  big_set_kernel<<<(N + THREADS - 1) / THREADS, THREADS, 0,
                   (cudaStream_t)stream>>>(
      w, (const long long*)tk_idx, (const uint8_t*)tk_ok, (float4*)table,
      (int4*)rect, (int*)depth16, N, gx, gy, ts);
  return (int)cudaGetLastError();
}

// An empty kernel of gs_big_set's grid for N lanes: what its launch alone
// costs.
extern "C" int gs_big_set_empty(int N, void* stream) {
  if (N <= 0) return 0;
  empty_kernel<<<(N + THREADS - 1) / THREADS, THREADS, 0,
                 (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
