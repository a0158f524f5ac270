// Batch-exact tile compositing with resident big lanes (v3).
//
// This file holds the v3 kernel's entry points and its design. The kernel
// (render_kernel), the per-tile pipeline it runs, described below, and the
// launch are render_tile.cuh's, shared with the v4 kernel (render_v4.cu).
// Persistent CTAs walk the row-major tiles, one tile at a time, and write
// the (TG, 8, NPX) channel-major output.
//
// Replaces the TPU kernel `_render_kernel_v3` in
// godotgaussiansplatting_tpu/ops/render_pallas3.py (launched by
// `render_tiles_v3`), both of its payload branches: the (B, 8, 128) u32
// word payload (`gs_render_v3`) and the cooked (B, 16, 128) f32 payload
// (`gs_render_v3_cooked`), together with `prepass_big_la`, the big lanes'
// log-alpha maps, which this kernel computes itself. Only the lane decode
// differs between the two payloads; it is the template parameter COOKED.
// Semantics follow `render_tiles_v3_reference` in ops/render_v3.py, which
// the tests hold to the JAX kernel: per tile, chain blocks in batches of
// U*128 lanes, exact order inside a batch by the packed rank
// (depth16 << 16 | idx >> 7, ties do not occlude), lag-1 corrections
// between overlapping consecutive batches, exact or bulk exchange with the
// tile's resident big lanes (straddle gate from the big depth-bucket
// prefix), batch-level early exit, then the present.
//
// What bounds it on Hopper. Only 8-17% of a processed block's lanes pass
// the tile's coverage gate, so the least time the card could take is small
// (chip_smoke's `render_bound`: about 0.1 ms at 1080p, set by the f32 rate
// on the work this kernel does). The kernel is 14-25x above that. Neither
// bytes nor multiply-adds hold it back, but the instruction issue of the
// per-pixel evaluations: every (pixel, active lane) pair costs a six-term
// power, an exp and a log at each of its 2-4 evaluations (batch total, emit,
// lag-1 merges; item F below shares the total with a merge), and so does
// every (pixel, big lane) in front of, inside or behind the tile's
// batches. Measured at 1080p, word payload, one stage dropped at a time
// (PERF.md section 5). The previous design (one thread a pixel, a bitonic
// sort, log-alpha maps) took 6.3 ms: 5.0 ms of per-pixel composite, 0.3
// ms of passes over the maps and 1.3 ms of decode and sort, plus 3.7-3.9
// ms of prepass_big_la. This one took 2.1 ms: 0.49 ms of
// fetch, decode and rank count, 1.07 ms of chain composite and 0.58 ms of
// big-lane evaluation (cooked, tile 16: 0.75, 1.21 and 1.02 of 3.0 ms);
// 1.78 ms with items F and G. With expf and log1pf in place of part E it
// took 3.8 ms.
//
// Design. The TPU kernel keeps (NPX, U*128) per-pixel, per-lane scratch in
// several MB of vector memory; a Hopper block has at most 227 KB of shared
// memory, so no per-(pixel, lane) state is kept for chain lanes: a ring of
// three batches' active lanes stays in shared memory and every
// (pixel, lane) alpha is recomputed from the lane data where it is needed
// (the batch total; the emit of the previous batch, merged against its
// predecessor, its successor and the big lanes, each a forward merge over a
// rank-sorted list). One thread block (CTA) a tile; CTAs walk the tiles
// persistently.
//   A. One pass over the big lanes, and no log-alpha map. A tile's big
//      lanes are rank-ascending with integer-valued depth, and its chain
//      list is ordered by block min depth, so a batch's min depth never
//      decreases. The big lanes in front of a batch ({b : bd < bmin}) are
//      then a growing prefix: a block-uniform pointer and a per-pixel
//      running sum add each big lane's log-alpha once per pixel per tile.
//      The big lanes behind a batch ({b : bd > bmax}) are a suffix: a batch
//      that does not straddle adds its total once, at the first lane of
//      that suffix, into a per-pixel difference array (device scratch); a
//      straddling batch adds each rank segment of its lanes where the
//      segment ends. `finish_tile` prefix-sums the array, reading only the
//      entries the tile touched and zeroing them for the next tile. The
//      big lanes' features at the tile origin and their coverage gate sit
//      in shared memory, and their log-alphas are evaluated where they are
//      needed (front sum, straddle merge, finish).
//   B. A rank count in place of the sort: a batch's active lanes are
//      compacted with a shared counter, and each one's ring slot is the
//      number of active keys (rank << 32 | lane, unique) smaller than its
//      own: two barriers a batch instead of about 38.
//   C. The next batch's U chain blocks (contiguous, 4 KB words or 8 KB
//      cooked each) are fetched by one thread with cp.async.bulk (1D TMA)
//      on an mbarrier while the current batch composites; the decode reads
//      shared memory. One staging buffer suffices: a batch is decoded into
//      the ring before the next fetch is issued.
//   D. PPT pixels a thread (PPT_TILE16, PPT_TILE32, chosen by measurement,
//      PERF.md section 6): one shared-memory read of a lane's features
//      feeds PPT pixels, and smaller blocks let several tiles share an SM.
//      Tile 32 takes 4 pixels a thread, 256 threads and 2 blocks an SM
//      (128 registers, no stack); tile 16 takes 1 pixel, 2 blocks an SM,
//      as many as the cooked payload's U=4 staging and ring leave room for.
//      Each warp owns a compact block of pixels (32 x 4 at tile 32, in
//      place of the tile's rows w, w + 8, w + 16 and w + 24; the big
//      lanes' walk is faster so, PERF.md section 6).
//   E. exp and log(1 - alpha) on the special function unit (__expf,
//      __logf) in place of expf and log1pf.
//   F. The batch total shares the emit's merge with it. Batch k's total is
//      the sum of its lanes' log-alphas in rank order from 0; the emit of
//      batch k-1, where the two overlap, forms the same sum lane for lane
//      (accC, from 0, over batch k's lanes in rank order) up to the first
//      lane of rank at or above its own last. So batch k runs that emit
//      first, takes its accC over as the total and adds the lanes the
//      merge left: each of those pairs is evaluated once where it was
//      twice, the same floats in the same order, so the total's bits are
//      unchanged. A batch that straddles a big lane sums its rank segments
//      beside the total and does not take the prefix over.
//   G. A log-alpha takes the flush-to-zero forms of the SFU's ex2 and lg2
//      (la_at, log_transmit in render_tile.cuh). Without -ftz, __expf and
//      __logf guard against a subnormal argument or result with a compare
//      and two predicated instructions each, which issue whether they run
//      or not: 6 of the 22 instructions of a log-alpha, and the guards
//      take one predicate register a pixel. lg2's argument, 1 - alpha, is
//      at least 1 - ALPHA_MAX, a normal float, so its .ftz form is the
//      same instruction on the same bits. ex2's result is alpha before the
//      clamp: where fl(power * log2 e) >= -126 both forms run the one SFU
//      instruction on the same argument; below it the guarded form's
//      alpha is about 2^-126 or less and the flushed one 0, and 1 - alpha
//      rounds to 1 for any alpha under 2^-25, so the log-alpha is
//      bit-equal. The emit's alpha, which weights the colour, and its exp
//      of the transmittance keep __expf: their subnormal results can reach
//      an accumulator near 0.
// Tensor cores are not used: the power is a 6-deep product per
// (pixel, lane), the work is bound by exp/log and their issue, not by
// multiply-adds, and the 50 dB / 1e-3 gates against the f32 plain version
// rule out TF32 and bf16 halves.
//
// Precision: f32 throughout (no bf16 rounding of alpha, colour or weights);
// the SFU's exp and log are f32 approximations (125-137 dB against the plain
// version, PERF.md). Built with --fmad=false, so every
// recomputation of a lane's alpha is bit-identical to the others.

#include "render_tile.cuh"

using namespace gs;

// Resident thread blocks the whole card holds for this configuration (the
// persistent grid size and the number of difference-array slices); < 0 on
// error.
extern "C" int gs_render_v3_max_blocks(int tile_size, int U, int cooked,
                                       int obig) {
  return cooked ? max_blocks<true, false>(tile_size, U, obig)
                : max_blocks<false, false>(tile_size, U, obig);
}

// The (B, 8, 128) u32 word payload. dz: (grid, obig, tile_size^2) f32,
// zero on entry and left zero.
extern "C" int gs_render_v3(const void* rows, const void* payload,
                            const void* bigpay, void* out, void* dz, int TG,
                            int gx, int tile_size, int U, int max_batches,
                            int obig, int early_exit, int grid,
                            void* stream) {
  return launch<false, false>(rows, payload, bigpay, out, dz, TG, TG, gx,
                              tile_size, U, max_batches, obig, early_exit,
                              grid, stream);
}

// The cooked (B, 16, 128) f32 payload.
extern "C" int gs_render_v3_cooked(const void* rows, const void* payload,
                                   const void* bigpay, void* out, void* dz,
                                   int TG, int gx, int tile_size, int U,
                                   int max_batches, int obig, int early_exit,
                                   int grid, void* stream) {
  return launch<true, false>(rows, payload, bigpay, out, dz, TG, TG, gx,
                             tile_size, U, max_batches, obig, early_exit,
                             grid, stream);
}
