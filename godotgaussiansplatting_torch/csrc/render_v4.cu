// Lockstep tile compositing (v4) on the cooked (B, 16, 128) f32 payload.
//
// Replaces the TPU kernel `_render_kernel_v4` in
// godotgaussiansplatting_tpu/ops/render_pallas4.py (launched by
// `render_tiles_v4`). Its semantics are v3's, tile for tile, so this file
// holds only the v4 kernel's entry points: the kernel (render_kernel_v4)
// is the v3 kernel's per-tile pipeline of render_tile.cuh with the cooked
// decode, at the v3 kernel's thread shape (tile 32: 4 pixels a thread, 256
// threads; tile 16: 1 pixel), v3's per-tile shared memory and v3's walk of
// persistent CTAs over the row-major tiles, and its output is bit-identical
// to the cooked v3 kernel's. The output is (T4, GT*NPX, 8) f32,
// pixel-major, exactly as the JAX kernel lays it out: tile slot t = t4 * GT
// + g holds tile t, a pixel's 8 channels are two 16-byte stores, and the
// slots of the last group past the last tile are written as empty tiles.
//
// Design. The TPU kernel composites GT tiles per grid step, so that they
// share one grid step's row read, one output write and the MXU's issue. On
// Hopper each tile is already its own CTA, so lockstep leaves nothing here
// but the output layout and the padding. Launching each group as a
// thread-block cluster of GT CTAs was measured and dropped: the card holds
// 62 clusters of 4 (248 CTAs) against 264 CTAs, and nothing crosses the
// cluster to repay it, so it lost 8% at tile 16, GT 4 and 1% at tile 32,
// GT 4 (PERF.md section 6). TMA multicast of the chain blocks that a
// group's tiles fetch at the same batch is what a cluster could share
// (PERF.md section 7).
//
// What bounds it is what bounds the v3 kernel (render_v3.cu): the issue of
// the per-(pixel, lane) evaluations, each a six-term power, an exp and a
// log on the SFU, for the chain lanes past the coverage gate and for the
// resident big lanes, which it evaluates itself. It takes no log-alpha
// maps and keeps no per-(pixel, big lane) chain mass: a (grid, OB, NPX)
// difference array, zero on entry and left zero. At 1080p (tile 32, U=2)
// it takes about 17-18x its operation bound, as cooked v3 does on the same
// inputs.

#include "render_tile.cuh"

using namespace gs;

// Dynamic shared memory of one CTA, in bytes: v3's per-tile layout.
extern "C" int gs_render_v4_smem_bytes(int U, int OB) {
  return (int)smem_bytes(U, OB, true);
}

// The persistent grid and the number of difference-array slices: the
// CTAs the whole card holds at once; < 0 on error.
extern "C" int gs_render_v4_max_blocks(int tile_size, int U, int OB) {
  return max_blocks<true, true>(tile_size, U, OB);
}

// TG tiles into ceil(TG / GT) * GT tile slots, the last group padded with
// empty tiles. dz: (grid, obig, tile_size^2) f32, zero on entry and left
// zero.
extern "C" int gs_render_v4(const void* rows, const void* payload,
                            const void* bigpay, void* out, void* dz, int TG,
                            int GT, int gx, int tile_size, int U,
                            int max_batches, int obig, int early_exit,
                            int grid, void* stream) {
  if (GT < 1 || GT > 4) return (int)cudaErrorInvalidValue;
  return launch<true, true>(rows, payload, bigpay, out, dz, TG,
                            (TG + GT - 1) / GT * GT, gx, tile_size, U,
                            max_batches, obig, early_exit, grid, stream);
}
