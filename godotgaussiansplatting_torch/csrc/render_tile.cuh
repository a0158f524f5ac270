// The render kernels, v3 (render_v3.cu's entry points) and v4
// (render_v4.cu's), and their host-side launch.
//
// Both run one per-tile pipeline, one tile a thread block (CTA), with
// persistent CTAs walking the tiles in row-major order (render_tiles): the
// decode of both chain payloads (lane_key, lane_store), the 1D TMA fetch of
// a batch's chain blocks (fetch_batch), the rank count into a ring of three
// batches, the per-pixel composite with its lag-1 and big-lane merges
// (composite_batch, emit_batch, whose merge with the next batch is that
// batch's total), the resident big lanes evaluated in the kernel
// (load_big, finish_tile) and the present. The two kernels differ only in
// their output: v3's is (TG, 8, NPX) channel-major; v4's is the
// JAX v4 kernel's (T4, GT * NPX, 8) pixel-major layout, with the tile list
// padded to T4 * GT slots by empty tiles. The design, and what bounds both
// (the issue of the per-(pixel, lane) exp and log), are in render_v3.cu's
// header. Built with --fmad=false, so every recomputation of a lane's
// log-alpha is bit-identical to the others, and both kernels give
// bit-identical outputs for the same tile.

#pragma once

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gs {

constexpr int S = 128;            // lanes per block
constexpr int MAX_OB = 256;       // resident big lanes per tile (max)
constexpr int NF = 10;            // floats per lane slot entry: 6 F, 3 rgb, rank
constexpr float ALPHA_MAX = 0.99994f;
constexpr float LOG_MIN_ALPHA = -5.54126354515843f;
constexpr uint64_t NO_KEY = ~0ull;  // sort key of a lane that is not active

// Pixels a thread owns, and the blocks an SM should hold, at each tile size
// (PERF.md section 6 has the measurement that chose them).
constexpr int PPT_TILE16 = 1;
constexpr int PPT_TILE32 = 4;
constexpr int MIN_BLOCKS_TILE16 = 2;
constexpr int MIN_BLOCKS_TILE32 = 2;
// Each warp owns a compact block of its 32 * PPT pixels, WARP_COLS wide (the
// tile's width where that is less; PERF.md section 6 has the measurement
// that chose it). Thread tid's pixel i is pixel_base(tid) + i * pixel_step.
constexpr int WARP_COLS = 32;

template <int T>
__host__ __device__ constexpr int warp_cols() {
  return T < WARP_COLS ? T : WARP_COLS;
}

template <int T>
__host__ __device__ constexpr int pixel_step() {
  return 32 / warp_cols<T>() * T;
}

template <int T, int PPT>
__device__ __forceinline__ int pixel_base(int tid) {
  constexpr int WC = warp_cols<T>(), WR = 32 * PPT / WC, BX = T / WC;
  static_assert(WC * WR == 32 * PPT && T % WC == 0, "warp block");
  const int w = tid >> 5, l = tid & 31;
  return ((w / BX) * WR + l / WC) * T + (w % BX) * WC + l % WC;
}

// TG tiles in row-major order (gx a row), U chain blocks a batch, OB
// resident big-lane slots a tile; v4 writes `slots` tile slots (TG rounded
// up to a multiple of GT).
struct Params {
  int TG, gx, U, max_batches, OB, early_exit, slots;
};

struct Slot {
  float* f;        // [6][US] power features f0u..f5 at the tile origin
  float* rgb;      // [3][US]
  uint32_t* rank;  // [US]
};

__device__ __forceinline__ Slot slot_at(float* base, int s, int US) {
  float* b = base + (size_t)s * NF * US;
  return Slot{b, b + 6 * US, (uint32_t*)(b + 9 * US)};
}

struct Pix {
  float x, y, xx, yy, xy;
};

__device__ __forceinline__ Pix pixel_of(int p, int T) {
  Pix q;
  q.x = (float)(p % T);
  q.y = (float)(p / T);
  q.xx = q.x * q.x;
  q.yy = q.y * q.y;
  q.xy = q.x * q.y;
  return q;
}

// The two chain payloads. A chain block's lanes are contiguous: 8 u32 rows
// of S lanes (words) or 16 f32 rows (cooked), BLOCK_BYTES bytes a block.
template <bool COOKED>
struct Payload {
  static constexpr int BLOCK_BYTES = (COOKED ? 16 : 8) * S * 4;
};

template <bool COOKED>
__device__ __forceinline__ const void* block_at(const void* payload,
                                                int bid) {
  return (const unsigned char*)payload +
         (size_t)bid * Payload<COOKED>::BLOCK_BYTES;
}

// Lane ln of the chain block at blk, seen from the tile at origin (ox, oy):
// its sort key (rank << 32), or NO_KEY when the lane is invalid or does not
// cover the tile.
template <bool COOKED>
__device__ __forceinline__ uint64_t lane_key(const void* blk, int ln,
                                             float ox, float oy, float tsz);

// Store lane ln's power features at the tile origin and its colour into
// entry i of slot dst (the rank is the caller's: key >> 32).
template <bool COOKED>
__device__ __forceinline__ void lane_store(const void* blk, int ln, float ox,
                                           float oy, const Slot& dst, int i,
                                           int US);

// The (B, 8, 128) u32 word payload: [key, ix, iy, f16 ca|cb, f16 cc|op,
// rgb9e5, idx, bf16 rx|ry]. The features are built at the tile origin.
template <>
__device__ __forceinline__ uint64_t lane_key<false>(const void* blk, int ln,
                                                    float ox, float oy,
                                                    float tsz) {
  const uint32_t* w = (const uint32_t*)blk;
  const uint32_t key = w[ln];
  if (key == 0xFFFFFFFFu) return NO_KEY;
  const float ixl = __uint_as_float(w[S + ln]) - ox;
  const float iyl = __uint_as_float(w[2 * S + ln]) - oy;
  const uint32_t rw = w[7 * S + ln];
  const float rxw = __uint_as_float(rw << 16);
  const float ryw = __uint_as_float(rw & 0xFFFF0000u);
  const bool covered = (ixl - rxw < tsz) && (ixl + rxw > 0.0f) &&
                       (iyl - ryw < tsz) && (iyl + ryw > 0.0f);
  if (!covered) return NO_KEY;
  const uint32_t idx = w[6 * S + ln];
  const uint32_t rank = ((key & 0xFFFFu) << 16) | ((idx >> 7) & 0xFFFFu);
  return (uint64_t)rank << 32;
}

template <>
__device__ __forceinline__ void lane_store<false>(const void* blk, int ln,
                                                  float ox, float oy,
                                                  const Slot& dst, int i,
                                                  int US) {
  const uint32_t* w = (const uint32_t*)blk;
  const uint32_t p3 = w[3 * S + ln], p4 = w[4 * S + ln];
  const float ca = __half2float(__ushort_as_half((unsigned short)(p3 & 0xFFFF)));
  const float cb = __half2float(__ushort_as_half((unsigned short)(p3 >> 16)));
  const float cc = __half2float(__ushort_as_half((unsigned short)(p4 & 0xFFFF)));
  const float op = __half2float(__ushort_as_half((unsigned short)(p4 >> 16)));
  const float ixl = __uint_as_float(w[S + ln]) - ox;
  const float iyl = __uint_as_float(w[2 * S + ln]) - oy;
  const float ln_op = fminf(logf(fmaxf(op, 1e-37f)), -1e-3f);
  float* f = dst.f;
  f[i] = (-0.5f * (ca * ixl * ixl + cc * iyl * iyl) - cb * ixl * iyl) + ln_op;
  f[US + i] = ca * ixl + cb * iyl;
  f[2 * US + i] = cc * iyl + cb * ixl;
  f[3 * US + i] = -0.5f * ca;
  f[4 * US + i] = -0.5f * cc;
  f[5 * US + i] = -cb;
  const uint32_t c9 = w[5 * S + ln];
  const int e = (int)((c9 >> 27) & 0x1F) - 15;
  const float sc = __int_as_float((e - 9 + 127) << 23);
  dst.rgb[i] = (float)(c9 & 0x1FF) * sc;
  dst.rgb[US + i] = (float)((c9 >> 9) & 0x1FF) * sc;
  dst.rgb[2 * US + i] = (float)((c9 >> 18) & 0x1FF) * sc;
}

// The cooked (B, 16, 128) f32 payload (ops/blocks2.py): the features about
// the block centre (rows 14/15) are re-centred to the tile origin, the
// coverage gate reads absolute ix/iy (rows 9/10) and the bf16 pair in row
// 11, colour is rows 6-8 and the rank is row 12 with its sign bit flipped.
// Invalid lanes carry ix = iy = -1e6 and fail the gate.
template <>
__device__ __forceinline__ uint64_t lane_key<true>(const void* blk, int ln,
                                                   float ox, float oy,
                                                   float tsz) {
  const float* w = (const float*)blk + ln;
  const float ixr = w[9 * S], iyr = w[10 * S];
  const uint32_t rw = __float_as_uint(w[11 * S]);
  const float rxw = __uint_as_float(rw << 16);
  const float ryw = __uint_as_float(rw & 0xFFFF0000u);
  const bool covered = (ixr - rxw < ox + tsz) && (ixr + rxw > ox) &&
                       (iyr - ryw < oy + tsz) && (iyr + ryw > oy);
  if (!covered) return NO_KEY;
  const uint32_t rank = __float_as_uint(w[12 * S]) ^ 0x80000000u;
  return (uint64_t)rank << 32;
}

template <>
__device__ __forceinline__ void lane_store<true>(const void* blk, int ln,
                                                 float ox, float oy,
                                                 const Slot& dst, int i,
                                                 int US) {
  const float* w = (const float*)blk + ln;
  const float f0 = w[0], f1 = w[S], f2 = w[2 * S];
  const float f3 = w[3 * S], f4 = w[4 * S], f5 = w[5 * S];
  const float dx = ox - w[14 * S];
  const float dy = oy - w[15 * S];
  float* f = dst.f;
  f[i] = f0 + dx * f1 + dy * f2 + (dx * dx) * f3 + (dy * dy) * f4 +
         (dx * dy) * f5;
  f[US + i] = f1 + (2.0f * dx) * f3 + dy * f5;
  f[2 * US + i] = f2 + (2.0f * dy) * f4 + dx * f5;
  f[3 * US + i] = f3;
  f[4 * US + i] = f4;
  f[5 * US + i] = f5;
  dst.rgb[i] = w[6 * S];
  dst.rgb[US + i] = w[7 * S];
  dst.rgb[2 * US + i] = w[8 * S];
}

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

__device__ __forceinline__ float power_at(const Feat& f, const Pix& q) {
  return f.f0 + q.x * f.f1 + q.y * f.f2 + q.xx * f.f3 + q.yy * f.f4 +
         q.xy * f.f5;
}

__device__ __forceinline__ float alpha_at(const Feat& f, const Pix& q) {
  return fminf(__expf(power_at(f, q)), ALPHA_MAX);
}

// The special-function instructions of __expf and __logf in their
// flush-to-zero form. The kernels are built without -ftz, so __expf(x) is
// ex2.approx.f32(fl(x * log2 e)) and __logf(x) is fl(lg2.approx.f32(x) *
// ln 2), each with a guard that rescales a subnormal argument or result:
// three instructions on top of the SFU's one. Where the argument and the
// result are normal floats, the .ftz form is the same instruction on the
// same bits (design item G, render_v3.cu).
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float lg2_ftz(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// fl(log2 e) and fl(ln 2), the factors of __expf and __logf.
constexpr float LOG2E_F = 1.44269502162933349609375f;
constexpr float LN2_F = 0.693147182464599609375f;

// log(1 - alpha) on the SFU: log1pf costs about as much as the rest of an
// evaluation; alpha <= ALPHA_MAX keeps the argument >= 6e-5, a normal
// float, so this is __logf(1 - alpha) bit for bit.
__device__ __forceinline__ float log_transmit(float alpha) {
  return lg2_ftz(1.0f - alpha) * LN2_F;
}

// log_transmit(alpha_at(f, q)) bit for bit. The exp may flush: where
// fl(power * log2 e) < -126 __expf's alpha is about 2^-126 or less and the
// flushed one 0, and 1 - alpha rounds to 1 either way.
__device__ __forceinline__ float la_at(const Feat& f, const Pix& q) {
  return log_transmit(fminf(ex2_ftz(power_at(f, q) * LOG2E_F), ALPHA_MAX));
}

// A tile's tables, and where this thread's pixels are.
struct Tile {
  const int32_t* row;       // its (8, 128) header rows
  int nbig, US, OB, tid;
  int px;                   // this thread's first pixel (pixel_base)
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
#pragma unroll
  for (int i = 0; i < PPT; ++i)
    tl.dz[(size_t)b * T * T + tl.px + i * pixel_step<T>()] += v[i];
  if (tl.tid == 0) tl.touched[b] = 1;
}

// Emit one batch (slot m) for this thread's pixels. A (the batch before
// it) and C (the batch after it) take part only when useA / useC say that
// their depth ranges overlap this batch's (the lag-1 corrections). C's
// log-alphas are summed in rank order into accC, which the caller zeroes:
// the prefix of C's total over the lanes it returns the count of (0
// without useC). With strad, the big lanes from jb on are merged by rank,
// on top of bfb (the big lanes before jb); otherwise bfb is part of base.
// The slots are passed by value with flags, not as nullable pointers: a
// pointer to a local Slot would keep it in local memory.
template <int PPT>
__device__ __forceinline__ int emit_batch(
    const Tile& tl, const Slot m, int nm, const float (&base)[PPT],
    const Slot A, bool useA, int nA, const float (&totA)[PPT], const Slot C,
    bool useC, int nC, float (&accC)[PPT], bool strad, int jb,
    const float (&bfb)[PPT], const Pix (&q)[PPT], float (&acc)[PPT][3]) {
  const int US = tl.US;
  int ia = 0, ic = 0, ib = jb;
  float accA[PPT], accB[PPT], run[PPT], grp[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    accA[i] = run[i] = grp[i] = 0.0f;
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
  return ic;
}

// The per-pixel part of batch k of a tile, once its n active lanes are
// rank-sorted in ring slot k % 3: the emit of batch k-1, whose successor is
// now known, then the big lanes in front of batch k, the rest of its total
// mass and its exchange with the big lanes behind it. Returns the
// early-exit vote: whether one of the thread's pixels still sees more than
// 1/255. Nothing of batch k but its overlap with k-1 is decided before the
// emit: a flag live across the emit's loops would hold one of the few
// predicate registers that the loops' exp and log guards interleave on.
template <int T, int PPT>
__device__ __forceinline__ bool composite_batch(const Tile& tl, int k, int U,
                                                int n, const Pix (&q)[PPT],
                                                PixState<PPT>& ps,
                                                TileState& ts) {
  const int32_t* row = tl.row;
  const int nb = row[0], US = tl.US;
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
  const bool ovl = k > 0 && bmin <= ts.pbmax && bmax >= ts.pbmin;

  // --- the emit of batch k-1 ----------------------------------------------
  // Where the two overlap, its merge sums this batch's log-alphas in rank
  // order from 0, as the batch's total does: the total takes that prefix
  // over and goes on from the first lane the merge left (design item F).
  float tot[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) tot[i] = 0.0f;
  int j0 = 0;
  if (k > 0) {
    const int sm = (k - 1) % 3, sa = (k + 1) % 3;  // batches k-1 and k-2
    float base[PPT];
#pragma unroll
    for (int i = 0; i < PPT; ++i)
      base[i] = ps.T1[i] + (ts.strad1 ? 0.0f : ps.bf1[i]);
    j0 = emit_batch<PPT>(tl, slot_at(tl.ring, sm, US), tl.nact[sm], base,
                         slot_at(tl.ring, sa, US), ts.ovl1, tl.nact[sa],
                         ps.tot2, cur, ovl, n, tot, ts.strad1, ts.jf1,
                         ps.bf1, q, ps.acc);
  }

  const int nbig = tl.nbig;
  const bool has_big = nbig > 0;
  const int b0 = min(max(bmin >> 9, 0), 127), b1 = min(max(bmax >> 9, 0), 127);
  const int n_hi = tl.prefix[b1];
  const int n_lo = b0 > 0 ? tl.prefix[b0 - 1] : 0;
  const bool strad = has_big && bmax >= bmin && (n_hi - n_lo) != 0;

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
  if (strad) {
    // Lane j counts for every big lane of larger rank: it is added to the
    // entry of the first such lane (b), per rank segment.
    int b = ts.jf;
    bool any = false;
    float seg[PPT];
#pragma unroll
    for (int i = 0; i < PPT; ++i) tot[i] = seg[i] = 0.0f;
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
    for (int j = j0; j < n; ++j) {
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

  bool more = false;
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    ps.tot2[i] = ps.tot1[i];
    ps.tot1[i] = tot[i];
    ps.T1[i] = ps.tcar[i];
    ps.bf1[i] = ps.bf[i];
    ps.tcar[i] += tot[i];
    more |= (ps.tcar[i] + ps.bf[i]) > LOG_MIN_ALPHA;
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
  constexpr int NPX = T * T;
  const int US = tl.US;
  if (k > 0) {
    const int sm = (k - 1) % 3, sa = (k + 1) % 3;
    const Slot prv = slot_at(tl.ring, sm, US);
    float base[PPT];
#pragma unroll
    for (int i = 0; i < PPT; ++i)
      base[i] = ps.T1[i] + (ts.strad1 ? 0.0f : ps.bf1[i]);
    float none[PPT];  // no batch follows: no merge with one
#pragma unroll
    for (int i = 0; i < PPT; ++i) none[i] = 0.0f;
    emit_batch<PPT>(tl, prv, tl.nact[sm], base, slot_at(tl.ring, sa, US),
                    ts.ovl1, tl.nact[sa], ps.tot2, prv, false, 0, none,
                    ts.strad1, ts.jf1, ps.bf1, q, ps.acc);
  }
  float dsum[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) bigtot[i] = dsum[i] = 0.0f;
  for (int b = 0; b < tl.nbig; ++b) {
    if (tl.touched[b]) {
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        float* d = tl.dz + (size_t)b * NPX + tl.px + i * pixel_step<T>();
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
// payload: rank, depth and colour, the power features re-centred to the
// tile origin and the coverage gate, formula for formula
// ops/render_v3.py prepass_big_la. The difference-array flag is cleared.
__device__ __forceinline__ void load_big(const float* bp, int OB, int b,
                                         float ox, float oy, float tsz,
                                         const Tile& tl, float* bigf,
                                         uint32_t* brank, float* bd,
                                         float* brgb, unsigned char* bon) {
  const float d = bp[12 * OB + b];
  const int idx = __float_as_int(bp[13 * OB + b]);
  const uint32_t di = (uint32_t)(int)fminf(d, 65535.0f);
  brank[b] = (di << 16) | ((uint32_t)(idx >> 7) & 0xFFFFu);
  bd[b] = d;
  for (int c = 0; c < 3; ++c) brgb[c * OB + b] = bp[(6 + c) * OB + b];
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

// The present of a pixel of the tile with header row `row` after k
// batches: t_final = exp(tcar + big mass), the heatmap mix and the
// diagnostics, written to o[c * cstride] for the 8 output channels (as
// two 16-byte stores when they are contiguous: cstride 1, o 32-byte
// aligned).
__device__ __forceinline__ void present(const int32_t* row, int k, int U,
                                        float bigtot, const float acc[3],
                                        float tcar, float* o, int cstride) {
  const int nb = row[0], cand = row[1], hm_i = row[2], nbig = row[4];
  const float t_final = expf(tcar + (nbig > 0 ? bigtot : 0.0f));
  const float mixf = (float)cand * 5e-4f;
  const float hm_f = (float)hm_i * (1.0f / 65536.0f);
  const float cov = (1.0f - t_final) * hm_f;
  const float r = acc[0] + (1.0f * mixf) * cov;
  const float g = acc[1] + (0.2f * mixf) * cov;
  const float b = acc[2] + (1.0f - 0.8f * mixf) * cov;
  const float done = (float)min(k * U, nb);
  if (cstride == 1) {
    float4* o4 = (float4*)o;
    o4[0] = make_float4(r, g, b, 1.0f);
    o4[1] = make_float4(t_final, done, (float)nb, (float)nbig);
    return;
  }
  o[0] = r;
  o[cstride] = g;
  o[2 * cstride] = b;
  o[3 * cstride] = 1.0f;
  o[4 * cstride] = t_final;
  o[5 * cstride] = done;
  o[6 * cstride] = (float)nb;
  o[7 * cstride] = (float)nbig;
}

// --- the kernels -----------------------------------------------------------------

// The header rows of an empty tile (nb = nbig = 0): v4's padded slots.
__device__ const int32_t EMPTY_ROWS[8 * 128] = {};

// The body of both kernels: tile slots t = blockIdx.x, blockIdx.x +
// gridDim.x, ... of the row-major order, one at a time. v3 (V4 false)
// writes tile t's 8 channels channel-major at out[(t * 8 + c) * NPX + p];
// v4 writes them pixel-major at out[(t * NPX + p) * 8 + c] and composites
// the slots past the TG tiles as empty tiles.
template <bool COOKED, bool V4, int T, int PPT>
__device__ __forceinline__ void render_tiles(
    const int32_t* __restrict__ rows, const void* __restrict__ payload,
    const float* __restrict__ bigpay, float* __restrict__ out,
    float* __restrict__ dz, Params P) {
  constexpr int NPX = T * T, NT = NPX / PPT, PSTEP = pixel_step<T>();
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
  const int px = pixel_base<T, PPT>(tid);
  Pix q[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) q[i] = pixel_of(px + i * PSTEP, T);
  const uint32_t bar = smem_u32(&s_bar);
  if (tid == 0) {
    mbar_init(bar);
    s_cnt = 0;
  }
  __syncthreads();
  uint32_t parity = 0;

  for (int t = blockIdx.x; t < (V4 ? P.slots : P.TG); t += gridDim.x) {
    const int32_t* row =
        V4 && t >= P.TG ? EMPTY_ROWS : rows + (size_t)t * 1024;
    const int nb = row[0], yoff = row[3], nbig = row[4];
    const int nbatch = min(P.max_batches, (nb + U - 1) / U);
    if (tid == 0 && nbatch > 0) fetch_batch<COOKED>(payload, row, 0, U, buf, bar);
    const float ox = (float)((t % P.gx) * T);
    const float oy = (float)((t / P.gx) * T + yoff);
    const Tile tl{row,    nbig,   US,   OB,   tid,   px,
                  (float*)(smem + L.ring), s_nact, prefix, bigf, brgb, bd,
                  brank,  bon,    smem + L.touched,
                  dz + (size_t)blockIdx.x * OB * NPX};
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
    for (int i = 0; i < PPT; ++i) {
      if (V4)
        present(row, k, U, bigtot[i], ps.acc[i], ps.tcar[i],
                out + ((size_t)t * NPX + px + i * PSTEP) * 8, 1);
      else
        present(row, k, U, bigtot[i], ps.acc[i], ps.tcar[i],
                out + (size_t)t * 8 * NPX + px + i * PSTEP, NPX);
    }
    __syncthreads();  // shared tile state is rewritten by the next tile
  }
}

// The v3 kernel, on the word (COOKED false) or the cooked payload.
template <bool COOKED, int T, int PPT, int MINB>
__global__ void __launch_bounds__(T * T / PPT, MINB)
render_kernel(const int32_t* __restrict__ rows,
              const void* __restrict__ payload,
              const float* __restrict__ bigpay, float* __restrict__ out,
              float* __restrict__ dz, Params P) {
  render_tiles<COOKED, false, T, PPT>(rows, payload, bigpay, out, dz, P);
}

// The v4 kernel, on the cooked payload.
template <int T, int PPT, int MINB>
__global__ void __launch_bounds__(T * T / PPT, MINB)
render_kernel_v4(const int32_t* __restrict__ rows,
                 const void* __restrict__ payload,
                 const float* __restrict__ bigpay, float* __restrict__ out,
                 float* __restrict__ dz, Params P) {
  render_tiles<true, true, T, PPT>(rows, payload, bigpay, out, dz, P);
}

// --- host side ------------------------------------------------------------------

// Let `kernel` use `smem` bytes of dynamic shared memory.
template <typename K>
inline int allow_smem(K* kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// Dynamic shared memory of one CTA of either kernel.
inline size_t smem_bytes(int U, int OB, bool cooked) {
  return smem_layout(U, OB, cooked ? Payload<true>::BLOCK_BYTES
                                   : Payload<false>::BLOCK_BYTES)
      .total;
}

// Thread blocks of `kernel` the whole card holds at once with `threads`
// threads and `smem` bytes of dynamic shared memory each (the persistent
// grid size); < 0 on error.
template <typename K>
inline int card_resident_blocks(K* kernel, int threads, size_t smem) {
  int dev = 0, sms = 0, per_sm = 0;
  if (allow_smem(kernel, smem) != 0) return -1;
  if (cudaGetDevice(&dev) != cudaSuccess) return -2;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess)
    return -3;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    smem) != cudaSuccess)
    return -4;
  return per_sm * sms;
}

using Kernel = void (*)(const int32_t*, const void*, const float*, float*,
                        float*, Params);

template <bool COOKED, bool V4, int T, int PPT, int MINB>
Kernel instance() {
  if constexpr (V4)
    return render_kernel_v4<T, PPT, MINB>;
  else
    return render_kernel<COOKED, T, PPT, MINB>;
}

// The v3 (or, with V4, the v4) kernel for a tile size, and its threads a
// CTA; nullptr for another tile size.
template <bool COOKED, bool V4>
Kernel kernel_for(int tile_size, int* threads) {
  if (tile_size == 16) {
    *threads = 256 / PPT_TILE16;
    return instance<COOKED, V4, 16, PPT_TILE16, MIN_BLOCKS_TILE16>();
  }
  if (tile_size == 32) {
    *threads = 1024 / PPT_TILE32;
    return instance<COOKED, V4, 32, PPT_TILE32, MIN_BLOCKS_TILE32>();
  }
  return nullptr;
}

// The persistent grid: the CTAs the whole card holds at once; < 0 on error.
template <bool COOKED, bool V4>
int max_blocks(int tile_size, int U, int OB) {
  int threads = 0;
  const Kernel k = kernel_for<COOKED, V4>(tile_size, &threads);
  if (k == nullptr) return -5;
  return card_resident_blocks(k, threads, smem_bytes(U, OB, COOKED));
}

// Launch on `grid` persistent CTAs. dz: (grid, obig, tile_size^2) f32, zero
// on entry and left zero.
template <bool COOKED, bool V4>
int launch(const void* rows, const void* payload, const void* bigpay,
           void* out, void* dz, int TG, int slots, int gx, int tile_size,
           int U, int max_batches, int obig, int early_exit, int grid,
           void* stream) {
  if (obig > MAX_OB || U < 1 || U * S > 512) return (int)cudaErrorInvalidValue;
  int threads = 0;
  const Kernel k = kernel_for<COOKED, V4>(tile_size, &threads);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  const size_t bytes = smem_bytes(U, obig, COOKED);
  const int err = allow_smem(k, bytes);
  if (err != 0) return err;
  Params P{TG, gx, U, max_batches, obig, early_exit, slots};
  k<<<grid, threads, bytes, (cudaStream_t)stream>>>(
      (const int32_t*)rows, payload, (const float*)bigpay, (float*)out,
      (float*)dz, P);
  return (int)cudaGetLastError();
}

}  // namespace gs
