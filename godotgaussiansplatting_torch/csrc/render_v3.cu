// Batch-exact tile compositing with resident big lanes (v3).
//
// Replaces the TPU kernel `_render_kernel_v3` in
// godotgaussiansplatting_tpu/ops/render_pallas3.py (launched by
// `render_tiles_v3`), both of its payload branches: the (B, 8, 128) u32
// word payload (`gs_render_v3`) and the cooked (B, 16, 128) f32 payload
// (`gs_render_v3_cooked`). Only the lane decode differs between the two; it
// is the template parameter of `render_kernel`. Semantics follow
// `render_tiles_v3_reference` in ops/render_v3.py, which the tests hold to
// the JAX kernel: per tile, chain blocks in batches of U*128 lanes, exact
// order inside a batch by the packed rank (depth16 << 16 | idx >> 7, ties do
// not occlude), lag-1 corrections between overlapping consecutive batches,
// exact or bulk exchange with the tile's resident big lanes (straddle gate
// from the big depth-bucket prefix), batch-level early exit, then the
// present.
//
// What bounds it on Hopper: arithmetic in the per-pixel evaluation. Every
// (pixel, lane) pair costs a six-term power, an exp and a log1p; the bytes
// moved per tile (the tile's blocks' lanes and the big-lane log-alpha maps)
// are small next to that.
//
// Design. The TPU kernel keeps (NPX, U*128) per-pixel, per-lane scratch
// (pending log-alphas, exponents and alphas of two batches) in several MB of
// vector memory, and orders lanes with (NPX, US) @ (US, US) indicator
// matmuls. A Hopper block has at most 227 KB of shared memory, so this
// kernel keeps no per-(pixel, lane) state for chain lanes at all:
//   * one thread block per tile (tiles are independent; blocks walk tiles
//     persistently), one thread per pixel;
//   * a batch's lanes are decoded once into shared memory (power features
//     at the tile origin, colour, rank), inactive lanes dropped, and the rest
//     sorted by rank with a block bitonic sort. The indicator matmul becomes
//     a per-pixel prefix sum along that order that leaves out ties;
//   * a ring of three batch slots stays in shared memory, and every
//     (pixel, lane) alpha is recomputed from the lane data where it is
//     needed: for the batch total, and when the previous batch is emitted,
//     merged against its own predecessor and successor (the two lag-1
//     corrections) and the big lanes (the straddle exchange) — all lists are
//     rank-sorted, so each is one forward merge;
//   * the per-(pixel, big lane) chain mass (the TPU's big_z) is the one
//     state that must persist over a tile's batches; it lives in device
//     memory, sized per resident block (not per tile) and laid out
//     lane-major so a warp's accesses are coalesced. The big log-alpha maps
//     (prepass_big_la, computed outside in torch) are read the same way.
// Early exit is one __syncthreads_or per batch. The per-tile device code is
// in render_tile.cuh, shared with the v4 lockstep kernel (render_v4.cu).
//
// Precision: f32 throughout (no bf16 rounding of alpha, colour or weights),
// built with --fmad=false so every recomputation of a lane's alpha is
// bit-identical to the others.

#include "render_tile.cuh"

namespace {

using namespace gs;

struct Params {
  int TG, gx, T, U, max_batches, OB, early_exit;
};

template <bool COOKED>
__global__ void __launch_bounds__(1024)
render_kernel(const int32_t* __restrict__ rows,
              const void* __restrict__ payload,
              const float* __restrict__ bigpay,
              const float* __restrict__ bigla_t, float* __restrict__ out,
              float* __restrict__ big_z, Params P) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_nact[3];
  const int T = P.T, NPX = T * T, U = P.U, US = U * S, OB = P.OB;
  const int NK = pow2_ceil(US);
  float* slots = (float*)smem;                               // 4 slots
  uint64_t* keys = (uint64_t*)(slots + (size_t)4 * NF * US);  // [NK]
  uint32_t* brank = (uint32_t*)(keys + NK);                   // [MAX_OB]
  float* bd = (float*)(brank + MAX_OB);                       // [MAX_OB]
  float* brgb = bd + MAX_OB;                                  // [3][MAX_OB]
  int* prefix = (int*)(brgb + 3 * MAX_OB);                    // [128]

  const int p = threadIdx.x;
  const float tsz = (float)T;
  const Pix q = pixel_of(p, T);
  const Slot stg = slot_at(slots, 3, US);
  float* bz = big_z + (size_t)blockIdx.x * OB * NPX;

  for (int t = blockIdx.x; t < P.TG; t += gridDim.x) {
    const int32_t* row = rows + (size_t)t * 1024;
    const int nb = row[0], yoff = row[3], nbig = row[4];
    const float ox = (float)((t % P.gx) * T);
    const float oy = (float)((t / P.gx) * T + yoff);
    for (int i = p; i < 128; i += NPX) prefix[i] = row[5 * 128 + i];
    const float* bp = bigpay + (size_t)t * 16 * OB;
    for (int b = p; b < nbig; b += NPX)
      load_big_lane(bp, OB, b, brank, bd, brgb, MAX_OB);
    const TileRefs tr{row,  slots, s_nact, prefix, brank, bd, brgb,
                      MAX_OB, bigla_t + (size_t)t * OB * NPX, bz};
    for (int b = 0; b < nbig; ++b) bz[(size_t)b * NPX + p] = 0.0f;
    __syncthreads();

    PixState ps{};
    TileState ts{};
    int k = 0;
    bool go = true;
    while (go && k * U < nb && k < P.max_batches) {
      const int s = k % 3;
      if (p == 0) s_nact[s] = 0;
      // --- decode the batch's lanes into the staging slot ----------------
      for (int l = p; l < NK; l += NPX) {
        uint64_t sk = NO_KEY;
        if (l < US) {
          const int pos = k * U + l / S;
          if (pos < nb)
            sk = decode_lane<COOKED>(payload, row[128 + pos] & 0x7FFFFF,
                                     l % S, l, ox, oy, tsz, stg, US);
        }
        keys[l] = sk;
      }
      __syncthreads();
      // --- rank sort, then gather the active lanes into ring slot s -------
      bitonic_sort(keys, NK, 1, 1u, p, NPX);
      const Slot cur = slot_at(slots, s, US);
      for (int i = p; i < US; i += NPX)
        gather_sorted(keys, i, NK, US, stg, cur, &s_nact[s]);
      __syncthreads();
      const bool more = composite_batch(tr, k, U, US, NPX, p, q, ps, ts);
      ++k;
      if (P.early_exit) {
        go = __syncthreads_or(more) != 0;
      } else {
        __syncthreads();
      }
    }
    const float bigtot = finish_tile(tr, k, US, NPX, p, q, ps, ts);
    present(tr, k, U, bigtot, ps, out + (size_t)t * 8 * NPX + p, NPX);
    __syncthreads();   // shared tile state is rewritten by the next tile
  }
}

size_t smem_bytes(int U) {
  const int US = U * S;
  const int NK = pow2_ceil(US);
  return sizeof(float) * 4 * NF * US + sizeof(uint64_t) * NK +
         sizeof(float) * 5 * MAX_OB + sizeof(int) * 128;
}

template <bool COOKED>
int launch(const void* rows, const void* payload, const void* bigpay,
           const void* bigla_t, void* out, void* big_z, int TG, int gx,
           int tile_size, int U, int max_batches, int obig, int early_exit,
           int grid, void* stream) {
  if (obig > MAX_OB || U < 1 || U * S > 512) return (int)cudaErrorInvalidValue;
  const int err = allow_smem(render_kernel<COOKED>, smem_bytes(U));
  if (err != 0) return err;
  Params P{TG, gx, tile_size, U, max_batches, obig, early_exit};
  render_kernel<COOKED><<<grid, tile_size * tile_size, smem_bytes(U),
                          (cudaStream_t)stream>>>(
      (const int32_t*)rows, payload, (const float*)bigpay,
      (const float*)bigla_t, (float*)out, (float*)big_z, P);
  return (int)cudaGetLastError();
}

}  // namespace

// Resident thread blocks the whole card holds for this configuration (the
// persistent grid size and the number of big_z scratch slices); < 0 on error.
extern "C" int gs_render_v3_max_blocks(int tile_size, int U, int cooked) {
  const int threads = tile_size * tile_size;
  return cooked ? card_resident_blocks(render_kernel<true>, threads,
                                       smem_bytes(U))
                : card_resident_blocks(render_kernel<false>, threads,
                                       smem_bytes(U));
}

// The (B, 8, 128) u32 word payload.
extern "C" int gs_render_v3(const void* rows, const void* payload,
                            const void* bigpay, const void* bigla_t, void* out,
                            void* big_z, int TG, int gx, int tile_size, int U,
                            int max_batches, int obig, int early_exit,
                            int grid, void* stream) {
  return launch<false>(rows, payload, bigpay, bigla_t, out, big_z, TG, gx,
                       tile_size, U, max_batches, obig, early_exit, grid,
                       stream);
}

// The cooked (B, 16, 128) f32 payload.
extern "C" int gs_render_v3_cooked(const void* rows, const void* payload,
                                   const void* bigpay, const void* bigla_t,
                                   void* out, void* big_z, int TG, int gx,
                                   int tile_size, int U, int max_batches,
                                   int obig, int early_exit, int grid,
                                   void* stream) {
  return launch<true>(rows, payload, bigpay, bigla_t, out, big_z, TG, gx,
                      tile_size, U, max_batches, obig, early_exit, grid,
                      stream);
}
