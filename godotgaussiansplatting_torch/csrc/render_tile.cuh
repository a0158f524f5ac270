// Per-tile device code of the render kernels. Shared by render_v3.cu and
// render_v4.cu: the lane slots, the decode of both chain payloads
// (lane_key, lane_store), the resident big lanes' rank, depth and colour,
// and the present. The v4 lockstep kernel's own: the block bitonic rank
// sort and the per-pixel batch composite with its emit merges, which read
// the big lanes' log-alpha maps (the v3 kernel has its own composite, see
// render_v3.cu). Built with --fmad=false, so every recomputation of a
// lane's alpha is bit-identical to the others.

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

__host__ __device__ __forceinline__ int pow2_ceil(int n) {
  int k = 1;
  while (k < n) k <<= 1;
  return k;
}

__device__ __forceinline__ float lane_alpha(const Slot& sl, int US, int j,
                                            const Pix& q) {
  const float* f = sl.f;
  float power = f[j] + q.x * f[US + j] + q.y * f[2 * US + j] +
                q.xx * f[3 * US + j] + q.yy * f[4 * US + j] +
                q.xy * f[5 * US + j];
  return fminf(expf(power), ALPHA_MAX);
}

__device__ __forceinline__ float lane_la(const Slot& sl, int US, int j,
                                         const Pix& q) {
  return log1pf(-lane_alpha(sl, US, j, q));
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

// Decode lane ln of chain block bid into entry l of the staging slot, with
// the power features at the tile origin (ox, oy). Returns the lane's sort
// key (rank << 32 | l), or NO_KEY when the lane is invalid or does not
// cover the tile.
template <bool COOKED>
__device__ __forceinline__ uint64_t decode_lane(const void* payload, int bid,
                                                int ln, int l, float ox,
                                                float oy, float tsz,
                                                const Slot& stg, int US) {
  const void* blk = block_at<COOKED>(payload, bid);
  const uint64_t key = lane_key<COOKED>(blk, ln, ox, oy, tsz);
  if (key == NO_KEY) return NO_KEY;
  lane_store<COOKED>(blk, ln, ox, oy, stg, l, US);
  stg.rank[l] = (uint32_t)(key >> 32);
  return key | (uint64_t)l;
}

// Sort each of nseg consecutive runs of NK keys (NK a power of two)
// ascending; runs whose bit in `live` is clear are left as they are. Every
// thread of the block calls it; it ends with a barrier.
__device__ __forceinline__ void bitonic_sort(uint64_t* keys, int NK, int nseg,
                                             unsigned live, int tid,
                                             int nthr) {
  const int n = NK * nseg;
  const int lg = __ffs(NK) - 1;  // log2(NK): run of key i is i >> lg
  for (int size = 2; size <= NK; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < n; i += nthr) {
        const int j = i ^ stride;
        if (j > i && ((live >> (i >> lg)) & 1u)) {
          const uint64_t a = keys[i], b = keys[j];
          const bool asc = ((i & (NK - 1)) & size) == 0;
          if ((a > b) == asc) {
            keys[i] = b;
            keys[j] = a;
          }
        }
      }
      __syncthreads();
    }
  }
}

// Move sorted entry i from the staging slot into the ring slot; the last
// active entry records the active count in *nact.
__device__ __forceinline__ void gather_sorted(const uint64_t* keys, int i,
                                              int NK, int US,
                                              const Slot& stg,
                                              const Slot& cur, int* nact) {
  const uint64_t key = keys[i];
  if (key == NO_KEY) return;
  const int l = (int)(key & 0xFFFFFFFFu);
  for (int r = 0; r < 6; ++r) cur.f[r * US + i] = stg.f[r * US + l];
  for (int c = 0; c < 3; ++c) cur.rgb[c * US + i] = stg.rgb[c * US + l];
  cur.rank[i] = stg.rank[l];
  if (i + 1 == NK || keys[i + 1] == NO_KEY) *nact = i + 1;
}

// Resident big lane b of a tile's (16, OB) big payload: its rank, depth and
// colour (colour rows obs apart).
__device__ __forceinline__ void load_big_lane(const float* bp, int OB, int b,
                                              uint32_t* brank, float* bd,
                                              float* brgb, int obs) {
  const float d = bp[12 * OB + b];
  const int idx = __float_as_int(bp[13 * OB + b]);
  const uint32_t di = (uint32_t)(int)fminf(d, 65535.0f);
  brank[b] = (di << 16) | ((uint32_t)(idx >> 7) & 0xFFFFu);
  bd[b] = d;
  for (int c = 0; c < 3; ++c) brgb[c * obs + b] = bp[(6 + c) * OB + b];
}

// Emit one batch (slot m) for this thread's pixel. A (the batch before it)
// and C (the batch after it) take part only when useA / useC say that their
// depth ranges overlap this batch's (the lag-1 corrections). The slots are
// passed by value with flags, not as nullable pointers: a pointer to a
// local Slot would keep it in local memory.
__device__ __forceinline__ void emit_batch(
    const Slot m, int nm, float base, const Slot A, bool useA, int nA,
    float totA, const Slot C, bool useC, int nC, bool strad, int nbig,
    const uint32_t* brank, const float* lab, int NPX, int p, int US,
    const Pix& q, float acc[3]) {
  int ia = 0, ic = 0, ib = 0;
  float accA = 0.0f, accC = 0.0f, accB = 0.0f;
  float run = 0.0f, grp = 0.0f;
  uint32_t grank = nm > 0 ? m.rank[0] : 0u;
  for (int i = 0; i < nm; ++i) {
    const uint32_t r = m.rank[i];
    if (r != grank) {
      run += grp;
      grp = 0.0f;
      grank = r;
    }
    if (useA)
      while (ia < nA && A.rank[ia] < r) accA += lane_la(A, US, ia++, q);
    if (useC)
      while (ic < nC && C.rank[ic] < r) accC += lane_la(C, US, ic++, q);
    if (strad)
      while (ib < nbig && brank[ib] < r) accB += lab[(size_t)(ib++) * NPX + p];
    const float alpha = lane_alpha(m, US, i, q);
    const float la = log1pf(-alpha);
    float z = run + accB;
    if (useA) z += accA - totA;
    if (useC) z += accC;
    const float w = expf(z + base) * alpha;
    acc[0] += w * m.rgb[i];
    acc[1] += w * m.rgb[US + i];
    acc[2] += w * m.rgb[2 * US + i];
    grp += la;
  }
}

// A tile's tables in shared memory and device memory.
struct TileRefs {
  const int32_t* row;      // its (8, 128) header rows
  float* slots;            // 4 lane slots: a ring of 3 batches + staging
  const int* nact;         // active lanes of each ring slot
  const int* prefix;       // [128] big depth-bucket prefix (straddle gate)
  const uint32_t* brank;   // resident big lanes: rank, depth, colour
  const float* bd;
  const float* brgb;
  int obs;                 // row stride of brgb
  const float* lab;        // (OB, NPX) big log-alpha maps (device memory)
  float* bz;               // (OB, NPX) chain mass per big lane (scratch)
};

// Per-pixel running state of a tile, and its per-tile (block-uniform) part.
struct PixState {
  float acc[3];
  float tcar, T1, c1, tot1, tot2;
};

struct TileState {
  int pbmin, pbmax;
  bool ovl1, strad1;
};

// The per-pixel part of batch k of a tile, once the batch's active lanes
// are rank-sorted in ring slot k % 3: the batch's total mass with the
// exchange against the resident big lanes (exact by rank when a big lane
// falls in the batch's depth range, else whole-batch), then the emit of
// batch k-1, whose successor is now known. Returns the pixel's early-exit
// vote: whether it still sees more than 1/255 transmittance.
__device__ __forceinline__ bool composite_batch(const TileRefs& tr, int k,
                                                int U, int US, int NPX, int p,
                                                const Pix& q, PixState& ps,
                                                TileState& ts) {
  const int32_t* row = tr.row;
  const int nb = row[0], nbig = row[4];
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
  const Slot cur = slot_at(tr.slots, k % 3, US);
  const int n = tr.nact[k % 3];
  const int b0 = min(max(bmin >> 9, 0), 127), b1 = min(max(bmax >> 9, 0), 127);
  const int n_hi = tr.prefix[b1];
  const int n_lo = b0 > 0 ? tr.prefix[b0 - 1] : 0;
  const bool strad = has_big && bmax >= bmin && (n_hi - n_lo) != 0;
  const bool ovl = k > 0 && bmin <= ts.pbmax && bmax >= ts.pbmin;

  float tot = 0.0f;
  if (strad) {
    int j = 0;
    float run = 0.0f;
    for (int b = 0; b < nbig; ++b) {
      const uint32_t rb = tr.brank[b];
      while (j < n && cur.rank[j] < rb) run += lane_la(cur, US, j++, q);
      tr.bz[(size_t)b * NPX + p] += run;
    }
    while (j < n) run += lane_la(cur, US, j++, q);
    tot = run;
  } else {
    for (int j = 0; j < n; ++j) tot += lane_la(cur, US, j, q);
  }
  float bfront = 0.0f;
  if (has_big) {
    const float bminf = (float)bmin, bmaxf = (float)bmax;
    for (int b = 0; b < nbig; ++b)
      if (tr.bd[b] < bminf) bfront += tr.lab[(size_t)b * NPX + p];
    if (!strad)
      for (int b = 0; b < nbig; ++b)
        if (tr.bd[b] > bmaxf) tr.bz[(size_t)b * NPX + p] += tot;
  }
  const float Tk = ps.tcar;
  const float ck = (has_big && !strad) ? bfront : 0.0f;
  ps.tcar = ps.tcar + tot;
  const bool more = (ps.tcar + bfront) > LOG_MIN_ALPHA;

  if (k > 0) {
    const int sm = (k - 1) % 3, sa = (k + 1) % 3;  // batches k-1 and k-2
    emit_batch(slot_at(tr.slots, sm, US), tr.nact[sm], ps.T1 + ps.c1,
               slot_at(tr.slots, sa, US), ts.ovl1, tr.nact[sa], ps.tot2, cur,
               ovl, n, ts.strad1, nbig, tr.brank, tr.lab, NPX, p, US, q,
               ps.acc);
  }
  ps.tot2 = ps.tot1;
  ps.tot1 = tot;
  ps.T1 = Tk;
  ps.c1 = ck;
  ts.ovl1 = ovl;
  ts.strad1 = strad;
  ts.pbmin = bmin;
  ts.pbmax = bmax;
  return more;
}

// After a tile's last batch (k batches done): emit that batch, then the
// resident big lanes (intra-big prefix in list order plus the chain mass).
// Returns the pixel's total big mass (the prefix after the last big lane).
__device__ __forceinline__ float finish_tile(const TileRefs& tr, int k,
                                             int US, int NPX, int p,
                                             const Pix& q, PixState& ps,
                                             const TileState& ts) {
  const int nbig = tr.row[4];
  if (k > 0) {
    const int sm = (k - 1) % 3, sa = (k + 1) % 3;
    const Slot prv = slot_at(tr.slots, sm, US);
    emit_batch(prv, tr.nact[sm], ps.T1 + ps.c1, slot_at(tr.slots, sa, US),
               ts.ovl1, tr.nact[sa], ps.tot2, prv, false, 0, ts.strad1, nbig,
               tr.brank, tr.lab, NPX, p, US, q, ps.acc);
  }
  float run = 0.0f;
  for (int b = 0; b < nbig; ++b) {
    const float la = tr.lab[(size_t)b * NPX + p];
    const float z = run + tr.bz[(size_t)b * NPX + p];
    const float w = expf(z) - expf(z + la);
    ps.acc[0] += w * tr.brgb[b];
    ps.acc[1] += w * tr.brgb[tr.obs + b];
    ps.acc[2] += w * tr.brgb[2 * tr.obs + b];
    run += la;
  }
  return run;
}

// The present of a pixel of the tile with header row `row` after k
// batches: t_final = exp(tcar + big mass), the heatmap mix and the
// diagnostics, written to o[c * cstride] for the 8 output channels.
__device__ __forceinline__ void present(const int32_t* row, int k, int U,
                                        float bigtot, const float acc[3],
                                        float tcar, float* o, int cstride) {
  const int nb = row[0], cand = row[1], hm_i = row[2], nbig = row[4];
  const float t_final = expf(tcar + (nbig > 0 ? bigtot : 0.0f));
  const float mixf = (float)cand * 5e-4f;
  const float hm_f = (float)hm_i * (1.0f / 65536.0f);
  const float cov = (1.0f - t_final) * hm_f;
  o[0] = acc[0] + (1.0f * mixf) * cov;
  o[cstride] = acc[1] + (0.2f * mixf) * cov;
  o[2 * cstride] = acc[2] + (1.0f - 0.8f * mixf) * cov;
  o[3 * cstride] = 1.0f;
  o[4 * cstride] = t_final;
  o[5 * cstride] = (float)min(k * U, nb);
  o[6 * cstride] = (float)nb;
  o[7 * cstride] = (float)nbig;
}

// Host side: let `kernel` use `smem` bytes of dynamic shared memory.
template <typename K>
inline int allow_smem(K* kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// Host side: thread blocks of `kernel` the whole card holds at once with
// `threads` threads and `smem` bytes of dynamic shared memory each (the
// persistent grid size); < 0 on error.
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

}  // namespace gs
