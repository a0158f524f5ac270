// Batch-exact tile compositing with resident big lanes (v3, word payload).
//
// Replaces the word-payload branch of the TPU kernel `_render_kernel_v3` in
// godotgaussiansplatting_tpu/ops/render_pallas3.py (launched by
// `render_tiles_v3`). Semantics follow `render_tiles_v3_reference` in
// ops/render_v3.py, which the tests hold to the JAX kernel: per tile, chain
// blocks in batches of U*128 lanes, exact order inside a batch by the packed
// rank (depth16 << 16 | idx >> 7, ties do not occlude), lag-1 corrections
// between overlapping consecutive batches, exact or bulk exchange with the
// tile's resident big lanes (straddle gate from the big depth-bucket
// prefix), batch-level early exit, then the present.
//
// What bounds it on Hopper: arithmetic in the per-pixel evaluation. Every
// (pixel, lane) pair costs a six-term power, an exp and a log1p; the bytes
// moved per tile (the tile's blocks' words and the big-lane log-alpha maps)
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
// Early exit is one __syncthreads_or per batch.
//
// Precision: f32 throughout (no bf16 rounding of alpha, colour or weights),
// built with --fmad=false so every recomputation of a lane's alpha is
// bit-identical to the others.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int S = 128;            // lanes per block
constexpr int MAX_OB = 256;       // resident big lanes per tile (max)
constexpr int NF = 10;            // floats per lane slot entry: 6 F, 3 rgb, rank
constexpr float ALPHA_MAX = 0.99994f;
constexpr float LOG_MIN_ALPHA = -5.54126354515843f;

struct Slot {
  float* f;        // [6][US] power features f0u..f5
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

struct Params {
  int TG, gx, T, U, max_batches, OB, early_exit;
};

// Emit one batch (slot m) for this thread's pixel. A (the batch before it)
// and C (the batch after it) are non-null only when their depth ranges
// overlap this batch's (the lag-1 corrections).
__device__ void emit_batch(const Slot& m, int nm, float base, const Slot* A,
                           int nA, float totA, const Slot* C, int nC,
                           bool strad, int nbig, const uint32_t* brank,
                           const float* lab, int NPX, int p, int US,
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
    if (A)
      while (ia < nA && A->rank[ia] < r) accA += lane_la(*A, US, ia++, q);
    if (C)
      while (ic < nC && C->rank[ic] < r) accC += lane_la(*C, US, ic++, q);
    if (strad)
      while (ib < nbig && brank[ib] < r) accB += lab[(size_t)(ib++) * NPX + p];
    const float alpha = lane_alpha(m, US, i, q);
    const float la = log1pf(-alpha);
    float z = run + accB;
    if (A) z += accA - totA;
    if (C) z += accC;
    const float w = expf(z + base) * alpha;
    acc[0] += w * m.rgb[i];
    acc[1] += w * m.rgb[US + i];
    acc[2] += w * m.rgb[2 * US + i];
    grp += la;
  }
}

__global__ void __launch_bounds__(1024)
render_kernel(const int32_t* __restrict__ rows,
              const int32_t* __restrict__ payload,
              const float* __restrict__ bigpay,
              const float* __restrict__ bigla_t, float* __restrict__ out,
              float* __restrict__ big_z, Params P) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_nact[3];
  const int T = P.T, NPX = T * T, U = P.U, US = U * S, OB = P.OB;
  int NK = 1;
  while (NK < US) NK <<= 1;
  float* slots = (float*)smem;                               // 4 slots
  uint64_t* keys = (uint64_t*)(slots + (size_t)4 * NF * US);  // [NK]
  uint32_t* brank = (uint32_t*)(keys + NK);                   // [MAX_OB]
  float* bd = (float*)(brank + MAX_OB);                       // [MAX_OB]
  float* brgb = bd + MAX_OB;                                  // [3][MAX_OB]
  int* prefix = (int*)(brgb + 3 * MAX_OB);                    // [128]

  const int p = threadIdx.x;
  const float tsz = (float)T;
  Pix q;
  q.x = (float)(p % T);
  q.y = (float)(p / T);
  q.xx = q.x * q.x;
  q.yy = q.y * q.y;
  q.xy = q.x * q.y;
  const Slot stg = slot_at(slots, 3, US);
  float* bz = big_z + (size_t)blockIdx.x * OB * NPX;

  for (int t = blockIdx.x; t < P.TG; t += gridDim.x) {
    const int32_t* row = rows + (size_t)t * 1024;
    const int nb = row[0], cand = row[1], hm_i = row[2], yoff = row[3];
    const int nbig = row[4];
    const bool has_big = nbig > 0;
    const float ox = (float)((t % P.gx) * T);
    const float oy = (float)((t / P.gx) * T + yoff);
    for (int i = p; i < 128; i += NPX) prefix[i] = row[5 * 128 + i];
    const float* bp = bigpay + (size_t)t * 16 * OB;
    for (int b = p; b < nbig; b += NPX) {
      const float d = bp[12 * OB + b];
      const int idx = __float_as_int(bp[13 * OB + b]);
      const uint32_t di = (uint32_t)(int)fminf(d, 65535.0f);
      brank[b] = (di << 16) | ((uint32_t)(idx >> 7) & 0xFFFFu);
      bd[b] = d;
      for (int c = 0; c < 3; ++c) brgb[c * MAX_OB + b] = bp[(6 + c) * OB + b];
    }
    const float* lab = bigla_t + (size_t)t * OB * NPX;
    float bigtot = 0.0f;
    for (int b = 0; b < nbig; ++b) {
      bz[(size_t)b * NPX + p] = 0.0f;
      bigtot += lab[(size_t)b * NPX + p];
    }
    __syncthreads();

    float acc[3] = {0.0f, 0.0f, 0.0f};
    float tcar = 0.0f;
    float T1 = 0.0f, c1 = 0.0f, tot1 = 0.0f, tot2 = 0.0f;
    bool ovl1 = false, strad1 = false;
    int pbmin = 0, pbmax = 0;
    int k = 0;
    bool go = true;
    while (go && k * U < nb && k < P.max_batches) {
      const int s = k % 3;
      if (p == 0) s_nact[s] = 0;
      // --- decode the batch's lanes into the staging slot ----------------
      for (int l = p; l < NK; l += NPX) {
        uint64_t sk = ~0ull;
        if (l < US) {
          const int u = l / S, ln = l % S, pos = k * U + u;
          if (pos < nb) {
            const int bid = row[128 + pos] & 0x7FFFFF;
            const uint32_t* w = (const uint32_t*)payload + (size_t)bid * 8 * S;
            const uint32_t key = w[ln];
            if (key != 0xFFFFFFFFu) {
              const uint32_t p3 = w[3 * S + ln], p4 = w[4 * S + ln];
              const float ca = __half2float(__ushort_as_half((unsigned short)(p3 & 0xFFFF)));
              const float cb = __half2float(__ushort_as_half((unsigned short)(p3 >> 16)));
              const float cc = __half2float(__ushort_as_half((unsigned short)(p4 & 0xFFFF)));
              const float op = __half2float(__ushort_as_half((unsigned short)(p4 >> 16)));
              const float ixl = __uint_as_float(w[S + ln]) - ox;
              const float iyl = __uint_as_float(w[2 * S + ln]) - oy;
              const uint32_t rw = w[7 * S + ln];
              const float rxw = __uint_as_float(rw << 16);
              const float ryw = __uint_as_float(rw & 0xFFFF0000u);
              const bool covered = (ixl - rxw < tsz) && (ixl + rxw > 0.0f) &&
                                   (iyl - ryw < tsz) && (iyl + ryw > 0.0f);
              if (covered) {
                const float ln_op = fminf(logf(fmaxf(op, 1e-37f)), -1e-3f);
                float* f = stg.f;
                f[l] = (-0.5f * (ca * ixl * ixl + cc * iyl * iyl) - cb * ixl * iyl) + ln_op;
                f[US + l] = ca * ixl + cb * iyl;
                f[2 * US + l] = cc * iyl + cb * ixl;
                f[3 * US + l] = -0.5f * ca;
                f[4 * US + l] = -0.5f * cc;
                f[5 * US + l] = -cb;
                const uint32_t c9 = w[5 * S + ln];
                const int e = (int)((c9 >> 27) & 0x1F) - 15;
                const float sc = __int_as_float((e - 9 + 127) << 23);
                stg.rgb[l] = (float)(c9 & 0x1FF) * sc;
                stg.rgb[US + l] = (float)((c9 >> 9) & 0x1FF) * sc;
                stg.rgb[2 * US + l] = (float)((c9 >> 18) & 0x1FF) * sc;
                const uint32_t idx = w[6 * S + ln];
                const uint32_t rank = ((key & 0xFFFFu) << 16) | ((idx >> 7) & 0xFFFFu);
                stg.rank[l] = rank;
                sk = ((uint64_t)rank << 32) | (uint64_t)l;
              }
            }
          }
        }
        keys[l] = sk;
      }
      int bmin = 0x10000, bmax = -1;
      for (int u = 0; u < U; ++u) {
        const int pos = k * U + u;
        if (pos < nb) {
          const uint32_t mm = (uint32_t)row[3 * 128 + pos];
          bmin = min(bmin, (int)((mm >> 16) & 0xFFFF));
          bmax = max(bmax, (int)(mm & 0xFFFF));
        }
      }
      __syncthreads();
      // --- block bitonic sort of (rank, lane) keys ------------------------
      for (int size = 2; size <= NK; size <<= 1) {
        for (int stride = size >> 1; stride > 0; stride >>= 1) {
          for (int i = p; i < NK; i += NPX) {
            const int j = i ^ stride;
            if (j > i) {
              const uint64_t a = keys[i], b = keys[j];
              const bool asc = (i & size) == 0;
              if ((a > b) == asc) {
                keys[i] = b;
                keys[j] = a;
              }
            }
          }
          __syncthreads();
        }
      }
      // --- gather the sorted active lanes into ring slot s ----------------
      const Slot cur = slot_at(slots, s, US);
      for (int i = p; i < US; i += NPX) {
        const uint64_t key = keys[i];
        if (key != ~0ull) {
          const int l = (int)(key & 0xFFFFFFFFu);
          for (int r = 0; r < 6; ++r) cur.f[r * US + i] = stg.f[r * US + l];
          for (int c = 0; c < 3; ++c) cur.rgb[c * US + i] = stg.rgb[c * US + l];
          cur.rank[i] = stg.rank[l];
          if (i + 1 == NK || keys[i + 1] == ~0ull) s_nact[s] = i + 1;
        }
      }
      __syncthreads();
      const int n = s_nact[s];

      const int b0 = min(max(bmin >> 9, 0), 127), b1 = min(max(bmax >> 9, 0), 127);
      const int n_hi = prefix[b1];
      const int n_lo = b0 > 0 ? prefix[b0 - 1] : 0;
      const bool strad = has_big && bmax >= bmin && (n_hi - n_lo) != 0;
      const bool ovl = k > 0 && bmin <= pbmax && bmax >= pbmin;

      // --- this batch's total mass; exact chain->big exchange if straddled
      float tot = 0.0f;
      if (strad) {
        int j = 0;
        float run = 0.0f;
        for (int b = 0; b < nbig; ++b) {
          const uint32_t rb = brank[b];
          while (j < n && cur.rank[j] < rb) run += lane_la(cur, US, j++, q);
          bz[(size_t)b * NPX + p] += run;
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
          if (bd[b] < bminf) bfront += lab[(size_t)b * NPX + p];
        if (!strad)
          for (int b = 0; b < nbig; ++b)
            if (bd[b] > bmaxf) bz[(size_t)b * NPX + p] += tot;
      }
      const float Tk = tcar;
      const float ck = (has_big && !strad) ? bfront : 0.0f;
      tcar = tcar + tot;
      const bool more = (tcar + bfront) > LOG_MIN_ALPHA;

      // --- emit the previous batch, now that its successor is known -------
      if (k > 0) {
        const int sm = (k - 1) % 3;
        const Slot prv = slot_at(slots, sm, US);
        const Slot pp = slot_at(slots, (k + 1) % 3, US);  // batch k-2
        emit_batch(prv, s_nact[sm], T1 + c1, ovl1 ? &pp : nullptr,
                   ovl1 ? s_nact[(k + 1) % 3] : 0, tot2, ovl ? &cur : nullptr,
                   n, strad1, nbig, brank, lab, NPX, p, US, q, acc);
      }
      tot2 = tot1;
      tot1 = tot;
      T1 = Tk;
      c1 = ck;
      ovl1 = ovl;
      strad1 = strad;
      pbmin = bmin;
      pbmax = bmax;
      ++k;
      if (P.early_exit) {
        go = __syncthreads_or(more) != 0;
      } else {
        __syncthreads();
      }
    }
    if (k > 0) {
      const int sm = (k - 1) % 3;
      const Slot prv = slot_at(slots, sm, US);
      const Slot pp = slot_at(slots, (k + 1) % 3, US);
      emit_batch(prv, s_nact[sm], T1 + c1, ovl1 ? &pp : nullptr,
                 ovl1 ? s_nact[(k + 1) % 3] : 0, tot2, nullptr, 0, strad1,
                 nbig, brank, lab, NPX, p, US, q, acc);
    }
    // --- resident big lanes: intra-big prefix in list order + chain mass --
    if (has_big) {
      float run = 0.0f;
      for (int b = 0; b < nbig; ++b) {
        const float la = lab[(size_t)b * NPX + p];
        const float z = run + bz[(size_t)b * NPX + p];
        const float w = expf(z) - expf(z + la);
        acc[0] += w * brgb[b];
        acc[1] += w * brgb[MAX_OB + b];
        acc[2] += w * brgb[2 * MAX_OB + b];
        run += la;
      }
    }
    // --- present -----------------------------------------------------------
    const float t_final = expf(tcar + (has_big ? bigtot : 0.0f));
    const float mixf = (float)cand * 5e-4f;
    const float hm_f = (float)hm_i * (1.0f / 65536.0f);
    const float cov = (1.0f - t_final) * hm_f;
    float* o = out + (size_t)t * 8 * NPX + p;
    o[0] = acc[0] + (1.0f * mixf) * cov;
    o[NPX] = acc[1] + (0.2f * mixf) * cov;
    o[2 * NPX] = acc[2] + (1.0f - 0.8f * mixf) * cov;
    o[3 * NPX] = 1.0f;
    o[4 * NPX] = t_final;
    o[5 * NPX] = (float)min(k * U, nb);
    o[6 * NPX] = (float)nb;
    o[7 * NPX] = (float)nbig;
    __syncthreads();   // shared tile state is rewritten by the next tile
  }
}

size_t smem_bytes(int U) {
  const int US = U * S;
  int NK = 1;
  while (NK < US) NK <<= 1;
  return sizeof(float) * 4 * NF * US + sizeof(uint64_t) * NK +
         sizeof(float) * 5 * MAX_OB + sizeof(int) * 128;
}

int configure(int U) {
  return (int)cudaFuncSetAttribute(render_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem_bytes(U));
}

}  // namespace

// Resident thread blocks the whole card holds for this configuration (the
// persistent grid size and the number of big_z scratch slices); < 0 on error.
extern "C" int gs_render_v3_max_blocks(int tile_size, int U) {
  if (configure(U) != 0) return -1;
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -2;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess)
    return -3;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, render_kernel, tile_size * tile_size, smem_bytes(U)) !=
      cudaSuccess)
    return -4;
  return per_sm * sms;
}

extern "C" int gs_render_v3(const void* rows, const void* payload,
                            const void* bigpay, const void* bigla_t, void* out,
                            void* big_z, int TG, int gx, int tile_size, int U,
                            int max_batches, int obig, int early_exit,
                            int grid, void* stream) {
  if (obig > MAX_OB || U < 1 || U * S > 512) return (int)cudaErrorInvalidValue;
  int err = configure(U);
  if (err != 0) return err;
  Params P{TG, gx, tile_size, U, max_batches, obig, early_exit};
  render_kernel<<<grid, tile_size * tile_size, smem_bytes(U),
                  (cudaStream_t)stream>>>(
      (const int32_t*)rows, (const int32_t*)payload, (const float*)bigpay,
      (const float*)bigla_t, (float*)out, (float*)big_z, P);
  return (int)cudaGetLastError();
}
