// Batch-exact tile compositing with resident big lanes (v3).
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
// on the work this kernel does). The kernel is 17-29x above that. Neither
// bytes nor multiply-adds hold it back, but the instruction issue of the
// per-pixel evaluations: every (pixel, active lane) pair costs a six-term
// power, an exp and a log at each of its 2-4 evaluations (batch total, emit,
// lag-1 merges), and so does every (pixel, big lane) in front of, inside or
// behind the tile's batches. Measured at 1080p, word payload, one stage
// dropped at a time (PERF.md section 5). The previous design (one thread a
// pixel, a bitonic sort, log-alpha maps) took 6.3 ms: 5.0 ms of per-pixel
// composite, 0.3 ms of passes over the maps and 1.3 ms of decode and sort,
// plus 3.7-3.9 ms of prepass_big_la. This one takes 2.1 ms: 0.49 ms of
// fetch, decode and rank count, 1.07 ms of chain composite and 0.58 ms of
// big-lane evaluation (cooked, tile 16: 0.75, 1.21 and 1.02 of 3.0 ms).
// With expf and log1pf in place of part E it takes 3.8 ms.
//
// Design. The TPU kernel keeps (NPX, U*128) per-pixel, per-lane scratch in
// several MB of vector memory; a Hopper block has at most 227 KB of shared
// memory, so no per-(pixel, lane) state is kept for chain lanes: a ring of
// three batches' active lanes stays in shared memory and every
// (pixel, lane) alpha is recomputed from the lane data where it is needed
// (the batch total; the emit of the previous batch, merged against its
// predecessor, its successor and the big lanes, each a forward merge over a
// rank-sorted list). One thread block walks tiles persistently.
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
//      (127 registers, no stack); tile 16 takes 1 pixel, 2 blocks an SM,
//      as many as the cooked payload's U=4 staging and ring leave room for.
//   E. exp and log(1 - alpha) on the special function unit (__expf,
//      __logf) in place of expf and log1pf.
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

namespace {

using namespace gs;

// Pixels a thread owns, and the blocks an SM should hold, at each tile size
// (PERF.md section 6 has the measurement that chose them).
constexpr int PPT_TILE16 = 1;
constexpr int PPT_TILE32 = 4;
constexpr int MIN_BLOCKS_TILE16 = 2;
constexpr int MIN_BLOCKS_TILE32 = 2;

struct Params {
  int TG, gx, U, max_batches, OB, early_exit;
};

// --- 1D TMA: cp.async.bulk completing on an mbarrier -----------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// Fetch batch k's chain blocks into buf (one thread calls it).
template <bool COOKED>
__device__ __forceinline__ void fetch_batch(const void* payload,
                                            const int32_t* row, int k, int U,
                                            unsigned char* buf, uint32_t bar) {
  constexpr int BB = Payload<COOKED>::BLOCK_BYTES;
  const int nblk = min(U, row[0] - k * U);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(nblk * BB)
               : "memory");
  for (int u = 0; u < nblk; ++u) {
    const int bid = row[128 + k * U + u] & 0x7FFFFF;
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(buf + u * BB)),
        "l"(block_at<COOKED>(payload, bid)), "r"(BB), "r"(bar)
        : "memory");
  }
}

// --- shared memory ----------------------------------------------------------

// Byte offsets of the dynamic shared memory: the TMA staging buffer (U
// blocks), the ring of 3 lane slots, the compacted sort keys, then the
// resident big lanes' tables (features at the tile origin, colour, depth,
// rank, straddle prefix, coverage flag, touched flag).
struct Layout {
  size_t buf, ring, keys, bigf, brgb, bd, brank, prefix, bon, touched, total;
};

__host__ __device__ inline Layout smem_layout(int U, int OB, int block_bytes) {
  const int US = U * S;
  Layout L;
  size_t o = 0;
  L.buf = o;
  o += (size_t)U * block_bytes;
  L.ring = o;
  o += sizeof(float) * 3 * NF * US;
  L.keys = o;
  o += sizeof(uint64_t) * US;
  L.bigf = o;
  o += sizeof(float) * 6 * OB;
  L.brgb = o;
  o += sizeof(float) * 3 * OB;
  L.bd = o;
  o += sizeof(float) * OB;
  L.brank = o;
  o += sizeof(uint32_t) * OB;
  L.prefix = o;
  o += sizeof(int) * 128;
  L.bon = o;
  o += OB;
  L.touched = o;
  o += OB;
  L.total = o;
  return L;
}

// --- per-(pixel, lane) evaluation --------------------------------------------

struct Feat {
  float f0, f1, f2, f3, f4, f5;
};

// Entry j of a lane table whose six feature rows are `stride` apart.
__device__ __forceinline__ Feat feat_at(const float* f, int stride, int j) {
  return Feat{f[j],              f[stride + j],     f[2 * stride + j],
              f[3 * stride + j], f[4 * stride + j], f[5 * stride + j]};
}

__device__ __forceinline__ float alpha_at(const Feat& f, const Pix& q) {
  const float power = f.f0 + q.x * f.f1 + q.y * f.f2 + q.xx * f.f3 +
                      q.yy * f.f4 + q.xy * f.f5;
  return fminf(__expf(power), ALPHA_MAX);
}

// log(1 - alpha) on the SFU: log1pf costs about as much as the rest of an
// evaluation; alpha <= ALPHA_MAX keeps the argument >= 6e-5.
__device__ __forceinline__ float log_transmit(float alpha) {
  return __logf(1.0f - alpha);
}

__device__ __forceinline__ float la_at(const Feat& f, const Pix& q) {
  return log_transmit(alpha_at(f, q));
}

// A tile's tables, and where this thread's pixels are.
struct Tile {
  const int32_t* row;       // its (8, 128) header rows
  int nbig, US, OB, tid;
  float* ring;              // 3 lane slots
  const int* nact;          // active lanes of each ring slot
  const int* prefix;        // [128] big depth-bucket prefix (straddle gate)
  const float* bigf;        // [6][OB] big features at the tile origin
  const float* brgb;        // [3][OB]
  const float* bd;          // [OB] big depth16 (integer-valued)
  const uint32_t* brank;    // [OB] big rank, non-decreasing
  const unsigned char* bon;  // [OB] big lane covers the tile
  unsigned char* touched;   // [OB] difference-array entry written
  float* dz;                // (OB, NPX) difference array (device scratch)
};

// Per-pixel running state, PPT pixels.
template <int PPT>
struct PixState {
  float acc[PPT][3];
  float tcar[PPT];  // chain mass so far
  float bf[PPT];    // log-alpha of the big lanes in front of the batch
  float T1[PPT], bf1[PPT], tot1[PPT];  // of the batch pending emit (k-1)
  float tot2[PPT];                     // total of batch k-2
};

// Block-uniform part.
struct TileState {
  int pbmin, pbmax;    // depth range of batch k-1
  bool ovl1, strad1;   // batch k-1 overlaps k-2 / straddles a big lane
  int jf, jf1;         // big lanes in front of batch k / k-1
  int fmin;            // the min depth that jf was advanced to
};

// Add v to the difference-array entry of big lane b (b < nbig).
template <int T, int PPT>
__device__ __forceinline__ void add_dz(const Tile& tl, int b,
                                       const float (&v)[PPT]) {
  constexpr int NT = T * T / PPT;
#pragma unroll
  for (int i = 0; i < PPT; ++i)
    tl.dz[(size_t)b * T * T + tl.tid + i * NT] += v[i];
  if (tl.tid == 0) tl.touched[b] = 1;
}

// Emit one batch (slot m) for this thread's pixels. A (the batch before
// it) and C (the batch after it) take part only when useA / useC say that
// their depth ranges overlap this batch's (the lag-1 corrections). With
// strad, the big lanes from jb on are merged by rank, on top of bfb (the
// big lanes before jb); otherwise bfb is part of base.
template <int PPT>
__device__ __forceinline__ void emit_batch(
    const Tile& tl, const Slot m, int nm, const float (&base)[PPT],
    const Slot A, bool useA, int nA, const float (&totA)[PPT], const Slot C,
    bool useC, int nC, bool strad, int jb, const float (&bfb)[PPT],
    const Pix (&q)[PPT], float (&acc)[PPT][3]) {
  const int US = tl.US;
  int ia = 0, ic = 0, ib = jb;
  float accA[PPT], accC[PPT], accB[PPT], run[PPT], grp[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    accA[i] = accC[i] = run[i] = grp[i] = 0.0f;
    accB[i] = strad ? bfb[i] : 0.0f;
  }
  uint32_t grank = nm > 0 ? m.rank[0] : 0u;
  for (int j = 0; j < nm; ++j) {
    const uint32_t r = m.rank[j];
    if (r != grank) {
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        run[i] += grp[i];
        grp[i] = 0.0f;
      }
      grank = r;
    }
    if (useA)
      for (; ia < nA && A.rank[ia] < r; ++ia) {
        const Feat f = feat_at(A.f, US, ia);
#pragma unroll
        for (int i = 0; i < PPT; ++i) accA[i] += la_at(f, q[i]);
      }
    if (useC)
      for (; ic < nC && C.rank[ic] < r; ++ic) {
        const Feat f = feat_at(C.f, US, ic);
#pragma unroll
        for (int i = 0; i < PPT; ++i) accC[i] += la_at(f, q[i]);
      }
    if (strad)
      for (; ib < tl.nbig && tl.brank[ib] < r; ++ib) {
        if (!tl.bon[ib]) continue;
        const Feat f = feat_at(tl.bigf, tl.OB, ib);
#pragma unroll
        for (int i = 0; i < PPT; ++i) accB[i] += la_at(f, q[i]);
      }
    const Feat f = feat_at(m.f, US, j);
    const float cr = m.rgb[j], cg = m.rgb[US + j], cb = m.rgb[2 * US + j];
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      const float alpha = alpha_at(f, q[i]);
      const float la = log_transmit(alpha);
      float z = run[i] + accB[i];
      if (useA) z += accA[i] - totA[i];
      if (useC) z += accC[i];
      const float w = __expf(z + base[i]) * alpha;
      acc[i][0] += w * cr;
      acc[i][1] += w * cg;
      acc[i][2] += w * cb;
      grp[i] += la;
    }
  }
}

// The per-pixel part of batch k of a tile, once its n active lanes are
// rank-sorted in ring slot k % 3: the big lanes in front of it, its total
// mass and its exchange with the big lanes behind it, then the emit of
// batch k-1, whose successor is now known. Returns the early-exit vote:
// whether one of the thread's pixels still sees more than 1/255.
template <int T, int PPT>
__device__ __forceinline__ bool composite_batch(const Tile& tl, int k, int U,
                                                int n, const Pix (&q)[PPT],
                                                PixState<PPT>& ps,
                                                TileState& ts) {
  const int32_t* row = tl.row;
  const int nb = row[0], nbig = tl.nbig, US = tl.US;
  const bool has_big = nbig > 0;
  int bmin = 0x10000, bmax = -1;
  for (int u = 0; u < U; ++u) {
    const int pos = k * U + u;
    if (pos < nb) {
      const uint32_t mm = (uint32_t)row[3 * 128 + pos];
      bmin = min(bmin, (int)((mm >> 16) & 0xFFFF));
      bmax = max(bmax, (int)(mm & 0xFFFF));
    }
  }
  const Slot cur = slot_at(tl.ring, k % 3, US);
  const int b0 = min(max(bmin >> 9, 0), 127), b1 = min(max(bmax >> 9, 0), 127);
  const int n_hi = tl.prefix[b1];
  const int n_lo = b0 > 0 ? tl.prefix[b0 - 1] : 0;
  const bool strad = has_big && bmax >= bmin && (n_hi - n_lo) != 0;
  const bool ovl = k > 0 && bmin <= ts.pbmax && bmax >= ts.pbmin;

  // --- the big lanes in front of the batch: a growing prefix -------------
  if (has_big) {
    if (bmin < ts.fmin) {  // never on binned lists; kept exact regardless
      ts.jf = 0;
#pragma unroll
      for (int i = 0; i < PPT; ++i) ps.bf[i] = 0.0f;
    }
    ts.fmin = bmin;
    const float bminf = (float)bmin;
    for (; ts.jf < nbig && tl.bd[ts.jf] < bminf; ++ts.jf) {
      if (!tl.bon[ts.jf]) continue;
      const Feat f = feat_at(tl.bigf, tl.OB, ts.jf);
#pragma unroll
      for (int i = 0; i < PPT; ++i) ps.bf[i] += la_at(f, q[i]);
    }
  }

  // --- the batch's mass, and what the big lanes behind it see ------------
  float tot[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) tot[i] = 0.0f;
  if (strad) {
    // Lane j counts for every big lane of larger rank: it is added to the
    // entry of the first such lane (b), per rank segment.
    int b = ts.jf;
    bool any = false;
    float seg[PPT];
#pragma unroll
    for (int i = 0; i < PPT; ++i) seg[i] = 0.0f;
    for (int j = 0; j < n; ++j) {
      const uint32_t r = cur.rank[j];
      if (b < nbig && tl.brank[b] <= r) {
        if (any) add_dz<T, PPT>(tl, b, seg);
        any = false;
#pragma unroll
        for (int i = 0; i < PPT; ++i) seg[i] = 0.0f;
        do ++b;
        while (b < nbig && tl.brank[b] <= r);
      }
      const Feat f = feat_at(cur.f, US, j);
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        const float la = la_at(f, q[i]);
        tot[i] += la;
        seg[i] += la;
      }
      any = true;
    }
    if (any && b < nbig) add_dz<T, PPT>(tl, b, seg);
  } else {
    for (int j = 0; j < n; ++j) {
      const Feat f = feat_at(cur.f, US, j);
#pragma unroll
      for (int i = 0; i < PPT; ++i) tot[i] += la_at(f, q[i]);
    }
    if (has_big) {
      int s = ts.jf;
      const float bmaxf = (float)bmax;
      while (s < nbig && tl.bd[s] <= bmaxf) ++s;
      if (s < nbig) add_dz<T, PPT>(tl, s, tot);
    }
  }

  float Tk[PPT];
  bool more = false;
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    Tk[i] = ps.tcar[i];
    ps.tcar[i] += tot[i];
    more |= (ps.tcar[i] + ps.bf[i]) > LOG_MIN_ALPHA;
  }

  if (k > 0) {
    const int sm = (k - 1) % 3, sa = (k + 1) % 3;  // batches k-1 and k-2
    float base[PPT];
#pragma unroll
    for (int i = 0; i < PPT; ++i)
      base[i] = ps.T1[i] + (ts.strad1 ? 0.0f : ps.bf1[i]);
    emit_batch<PPT>(tl, slot_at(tl.ring, sm, US), tl.nact[sm], base,
                    slot_at(tl.ring, sa, US), ts.ovl1, tl.nact[sa], ps.tot2,
                    cur, ovl, n, ts.strad1, ts.jf1, ps.bf1, q, ps.acc);
  }
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    ps.tot2[i] = ps.tot1[i];
    ps.tot1[i] = tot[i];
    ps.T1[i] = Tk[i];
    ps.bf1[i] = ps.bf[i];
  }
  ts.jf1 = ts.jf;
  ts.ovl1 = ovl;
  ts.strad1 = strad;
  ts.pbmin = bmin;
  ts.pbmax = bmax;
  return more;
}

// After a tile's last batch (k batches done): emit that batch, then the
// resident big lanes (intra-big prefix in list order plus the chain mass,
// the prefix sum of the difference array, whose touched entries are
// zeroed again). Writes each pixel's total big mass to bigtot.
template <int T, int PPT>
__device__ __forceinline__ void finish_tile(const Tile& tl, int k,
                                            const Pix (&q)[PPT],
                                            PixState<PPT>& ps,
                                            const TileState& ts,
                                            float (&bigtot)[PPT]) {
  constexpr int NPX = T * T, NT = NPX / PPT;
  const int US = tl.US;
  if (k > 0) {
    const int sm = (k - 1) % 3, sa = (k + 1) % 3;
    const Slot prv = slot_at(tl.ring, sm, US);
    float base[PPT];
#pragma unroll
    for (int i = 0; i < PPT; ++i)
      base[i] = ps.T1[i] + (ts.strad1 ? 0.0f : ps.bf1[i]);
    emit_batch<PPT>(tl, prv, tl.nact[sm], base, slot_at(tl.ring, sa, US),
                    ts.ovl1, tl.nact[sa], ps.tot2, prv, false, 0, ts.strad1,
                    ts.jf1, ps.bf1, q, ps.acc);
  }
  float dsum[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) bigtot[i] = dsum[i] = 0.0f;
  for (int b = 0; b < tl.nbig; ++b) {
    if (tl.touched[b]) {
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        float* d = tl.dz + (size_t)b * NPX + tl.tid + i * NT;
        dsum[i] += *d;
        *d = 0.0f;
      }
    }
    if (!tl.bon[b]) continue;
    const Feat f = feat_at(tl.bigf, tl.OB, b);
    const float cr = tl.brgb[b], cg = tl.brgb[tl.OB + b],
                cb = tl.brgb[2 * tl.OB + b];
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      const float la = la_at(f, q[i]);
      const float z = bigtot[i] + dsum[i];
      const float w = __expf(z) - __expf(z + la);
      ps.acc[i][0] += w * cr;
      ps.acc[i][1] += w * cg;
      ps.acc[i][2] += w * cb;
      bigtot[i] += la;
    }
  }
}

// Resident big lane b of the tile at origin (ox, oy), from its (16, OB) big
// payload: rank, depth and colour (load_big_lane), the power features
// re-centred to the tile origin and the coverage gate, formula for formula
// ops/render_v3.py prepass_big_la. The difference-array flag is cleared.
__device__ __forceinline__ void load_big(const float* bp, int OB, int b,
                                         float ox, float oy, float tsz,
                                         const Tile& tl, float* bigf,
                                         uint32_t* brank, float* bd,
                                         float* brgb, unsigned char* bon) {
  load_big_lane(bp, OB, b, brank, bd, brgb, OB);
  const float f0 = bp[b], f1 = bp[OB + b], f2 = bp[2 * OB + b];
  const float f3 = bp[3 * OB + b], f4 = bp[4 * OB + b], f5 = bp[5 * OB + b];
  const float dx = ox - bp[14 * OB + b];
  const float dy = oy - bp[15 * OB + b];
  bigf[b] = f0 + dx * f1 + dy * f2 + dx * dx * f3 + dy * dy * f4 + dx * dy * f5;
  bigf[OB + b] = f1 + 2.0f * dx * f3 + dy * f5;
  bigf[2 * OB + b] = f2 + 2.0f * dy * f4 + dx * f5;
  bigf[3 * OB + b] = f3;
  bigf[4 * OB + b] = f4;
  bigf[5 * OB + b] = f5;
  const uint32_t rw = __float_as_uint(bp[11 * OB + b]);
  const float rxw = __uint_as_float(rw << 16);
  const float ryw = __uint_as_float(rw & 0xFFFF0000u);
  const float ixr = bp[9 * OB + b], iyr = bp[10 * OB + b];
  bon[b] = (ixr - rxw < ox + tsz) && (ixr + rxw > ox) &&
           (iyr - ryw < oy + tsz) && (iyr + ryw > oy);
  tl.touched[b] = 0;
}

template <bool COOKED, int T, int PPT, int MINB>
__global__ void __launch_bounds__(T * T / PPT, MINB)
render_kernel(const int32_t* __restrict__ rows,
              const void* __restrict__ payload,
              const float* __restrict__ bigpay, float* __restrict__ out,
              float* __restrict__ dz, Params P) {
  constexpr int NPX = T * T, NT = NPX / PPT;
  constexpr int BB = Payload<COOKED>::BLOCK_BYTES;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t s_bar;
  __shared__ int s_cnt, s_nact[3];
  const int U = P.U, US = U * S, OB = P.OB;
  const int tid = threadIdx.x;
  const float tsz = (float)T;
  const Layout L = smem_layout(U, OB, BB);
  unsigned char* buf = smem + L.buf;
  uint64_t* keys = (uint64_t*)(smem + L.keys);
  float* bigf = (float*)(smem + L.bigf);
  float* brgb = (float*)(smem + L.brgb);
  float* bd = (float*)(smem + L.bd);
  uint32_t* brank = (uint32_t*)(smem + L.brank);
  int* prefix = (int*)(smem + L.prefix);
  unsigned char* bon = smem + L.bon;
  Pix q[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) q[i] = pixel_of(tid + i * NT, T);
  const uint32_t bar = smem_u32(&s_bar);
  if (tid == 0) {
    mbar_init(bar);
    s_cnt = 0;
  }
  __syncthreads();
  uint32_t parity = 0;

  for (int t = blockIdx.x; t < P.TG; t += gridDim.x) {
    const int32_t* row = rows + (size_t)t * 1024;
    const int nb = row[0], yoff = row[3], nbig = row[4];
    const int nbatch = min(P.max_batches, (nb + U - 1) / U);
    if (tid == 0 && nbatch > 0) fetch_batch<COOKED>(payload, row, 0, U, buf, bar);
    const float ox = (float)((t % P.gx) * T);
    const float oy = (float)((t / P.gx) * T + yoff);
    const Tile tl{row,   nbig,  US,    OB,    tid,  (float*)(smem + L.ring),
                  s_nact, prefix, bigf, brgb, bd,   brank,
                  bon,   smem + L.touched, dz + (size_t)blockIdx.x * OB * NPX};
    for (int i = tid; i < 128; i += NT) prefix[i] = row[5 * 128 + i];
    const float* bp = bigpay + (size_t)t * 16 * OB;
    for (int b = tid; b < nbig; b += NT)
      load_big(bp, OB, b, ox, oy, tsz, tl, bigf, brank, bd, brgb, bon);
    __syncthreads();

    PixState<PPT> ps;
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      ps.acc[i][0] = ps.acc[i][1] = ps.acc[i][2] = 0.0f;
      ps.tcar[i] = ps.bf[i] = ps.T1[i] = ps.bf1[i] = 0.0f;
      ps.tot1[i] = ps.tot2[i] = 0.0f;
    }
    TileState ts{0, 0, false, false, 0, 0, -1};
    int k = 0;
    bool go = true;
    while (go && k < nbatch) {
      mbar_wait(bar, parity);
      parity ^= 1u;
      // --- the batch's active lanes, compacted ------------------------------
      const int nlanes = min(U, nb - k * U) * S;
      for (int l = tid; l < nlanes; l += NT) {
        const uint64_t key = lane_key<COOKED>(buf + (l / S) * BB, l % S, ox,
                                              oy, tsz);
        if (key != NO_KEY) keys[atomicAdd(&s_cnt, 1)] = key | (uint64_t)l;
      }
      __syncthreads();
      // --- rank count: each active lane's slot in ring slot k % 3 -----------
      const int n = s_cnt;
      const int s = k % 3;
      const Slot cur = slot_at(tl.ring, s, US);
      for (int c = tid; c < n; c += NT) {
        const uint64_t key = keys[c];
        int r = 0;
        for (int c2 = 0; c2 < n; ++c2) r += keys[c2] < key;
        const int l = (int)(key & 0xFFFFFFFFu);
        lane_store<COOKED>(buf + (l / S) * BB, l % S, ox, oy, cur, r, US);
        cur.rank[r] = (uint32_t)(key >> 32);
      }
      if (tid == 0) s_nact[s] = n;
      __syncthreads();
      // --- the next batch's blocks load while this one composites -----------
      if (tid == 0) {
        s_cnt = 0;
        if (k + 1 < nbatch)
          fetch_batch<COOKED>(payload, row, k + 1, U, buf, bar);
      }
      const bool more = composite_batch<T, PPT>(tl, k, U, n, q, ps, ts);
      ++k;
      if (P.early_exit) {
        go = __syncthreads_or(more) != 0;
      } else {
        __syncthreads();
      }
    }
    if (k < nbatch) {  // batch k was fetched but the tile exited early
      mbar_wait(bar, parity);
      parity ^= 1u;
    }
    float bigtot[PPT];
    finish_tile<T, PPT>(tl, k, q, ps, ts, bigtot);
#pragma unroll
    for (int i = 0; i < PPT; ++i)
      present(row, k, U, bigtot[i], ps.acc[i], ps.tcar[i],
              out + (size_t)t * 8 * NPX + tid + i * NT, NPX);
    __syncthreads();  // shared tile state is rewritten by the next tile
  }
}

using Kernel = void (*)(const int32_t*, const void*, const float*, float*,
                        float*, Params);

template <bool COOKED>
Kernel kernel_for(int tile_size, int* threads) {
  if (tile_size == 16) {
    *threads = 256 / PPT_TILE16;
    return render_kernel<COOKED, 16, PPT_TILE16, MIN_BLOCKS_TILE16>;
  }
  if (tile_size == 32) {
    *threads = 1024 / PPT_TILE32;
    return render_kernel<COOKED, 32, PPT_TILE32, MIN_BLOCKS_TILE32>;
  }
  return nullptr;
}

size_t smem_bytes(int U, int OB, bool cooked) {
  return smem_layout(U, OB, cooked ? Payload<true>::BLOCK_BYTES
                                   : Payload<false>::BLOCK_BYTES)
      .total;
}

template <bool COOKED>
int max_blocks(int tile_size, int U, int OB) {
  int threads = 0;
  const Kernel k = kernel_for<COOKED>(tile_size, &threads);
  if (k == nullptr) return -5;
  return card_resident_blocks(k, threads, smem_bytes(U, OB, COOKED));
}

template <bool COOKED>
int launch(const void* rows, const void* payload, const void* bigpay,
           void* out, void* dz, int TG, int gx, int tile_size, int U,
           int max_batches, int obig, int early_exit, int grid,
           void* stream) {
  if (obig > MAX_OB || U < 1 || U * S > 512) return (int)cudaErrorInvalidValue;
  int threads = 0;
  const Kernel k = kernel_for<COOKED>(tile_size, &threads);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  const size_t bytes = smem_bytes(U, obig, COOKED);
  const int err = allow_smem(k, bytes);
  if (err != 0) return err;
  Params P{TG, gx, U, max_batches, obig, early_exit};
  k<<<grid, threads, bytes, (cudaStream_t)stream>>>(
      (const int32_t*)rows, payload, (const float*)bigpay, (float*)out,
      (float*)dz, P);
  return (int)cudaGetLastError();
}

}  // namespace

// Resident thread blocks the whole card holds for this configuration (the
// persistent grid size and the number of difference-array slices); < 0 on
// error.
extern "C" int gs_render_v3_max_blocks(int tile_size, int U, int cooked,
                                       int obig) {
  return cooked ? max_blocks<true>(tile_size, U, obig)
                : max_blocks<false>(tile_size, U, obig);
}

// The (B, 8, 128) u32 word payload. dz: (grid, obig, tile_size^2) f32,
// zero on entry and left zero.
extern "C" int gs_render_v3(const void* rows, const void* payload,
                            const void* bigpay, void* out, void* dz, int TG,
                            int gx, int tile_size, int U, int max_batches,
                            int obig, int early_exit, int grid,
                            void* stream) {
  return launch<false>(rows, payload, bigpay, out, dz, TG, gx, tile_size, U,
                       max_batches, obig, early_exit, grid, stream);
}

// The cooked (B, 16, 128) f32 payload.
extern "C" int gs_render_v3_cooked(const void* rows, const void* payload,
                                   const void* bigpay, void* out, void* dz,
                                   int TG, int gx, int tile_size, int U,
                                   int max_batches, int obig, int early_exit,
                                   int grid, void* stream) {
  return launch<true>(rows, payload, bigpay, out, dz, TG, gx, tile_size, U,
                      max_batches, obig, early_exit, grid, stream);
}
