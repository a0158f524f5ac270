// The exact emission's plan: the base group's capped counts and their
// offsets, each dense group's compacted splats, and the totals.
//
// Replaces the plan that `emit_and_sort`, godotgaussiansplatting_tpu/ops/
// sort.py:77-101 and its `_dense_emit` (:132), computes with cumulative
// sums (plain XLA there, no Pallas kernel), which the port repeated as
// some 70 torch launches a frame. The plain version is
// `emit_plan_reference` in ops/sort.py; the outputs are bit-equal to it.
//
// The closed form. Let max_t be max_tiles_per_splat and nt a splat's
// num_tiles. Dense group g (the tiers in ladder order, then the giants)
// is eligible for the valid splats with lo_g < nt <= hi_g and takes the
// first cap_g of them in splat order. The ladder ascends from lo_0 =
// max_t, so the groups are disjoint ranges of nt above max_t, and a splat
// that a group takes would have had max_t base slots. With A(i) the
// exclusive prefix of min(nt, max_t) and C_g(i) the exclusive count of
// the splats eligible for g,
//   offsets[i] = A(i) - max_t * sum_g min(cap_g, C_g(i));
// splat i is taken by g exactly when it is eligible and C_g(i) < cap_g,
// and then fills slot C_g(i) of the group with off_c = E_g(i), the
// exclusive sum of nt over the splats eligible for g (every eligible
// splat before a taken one is taken). None of these sums depends on its
// prefix, so the plan is one scan of a small vector.
//
// What bounds it on Hopper: device-memory bandwidth. The function reads
// each splat's flag and count once (5 B) and writes its capped count and
// offset once (12 B); the taken splats' slots (16 B each) and the scan's
// own words are small beside them.
//
// Design: two launches, after a memset of the look-back's flag words
// (4 B a tile; no output is filled first).
// - scan_kernel: a CTA takes a tile of TILE splats in order from a ticket
//   counter (tiles taken by block index measured slower), each thread 16
//   consecutive splats (16-byte loads where the inputs are 16-byte
//   aligned). It sums its tile into a Sums vector (A and N = sum nt as
//   int64, and for each group C_g as int32 and E_g as int64: 64 B),
//   publishes it with flag A, looks back over its predecessors a warp at a
//   time, 32 tiles a step, for its exclusive prefix (decoupled look-back),
//   and publishes its inclusive prefix with flag P. The vector is wider
//   than a word, so a tile's sum and its inclusive prefix have words of
//   their own, written before a release store of the flag and read after
//   an acquire load of it. The CTA then writes each taken splat's slot,
//   and its splats' capped counts and offsets through shared memory, so
//   that a warp stores 512 consecutive bytes at a time (stored from
//   registers, 16 B a thread 64 B apart, the kernel ran 1.4x longer).
// - finish_kernel: from the last tile's inclusive prefix, the totals
//   (the base group's, each group's first position, the whole emission's
//   and the pairs the caps drop) and each group's dead slots (idx 0,
//   nt_c 0, off_c the group's sum). Every output element is written once.
// Measured and left out (PERF.md): a reduce-then-scan in two launches
// (each tile's prefix summed from the first launch's tile sums: slower), a
// warp of its own for the look-back, beside the loads (slower), staging
// the loads in shared memory and 128-thread CTAs (no faster).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 16;                  // consecutive splats a thread
constexpr int TILE = THREADS * ITEMS;      // splats a CTA
// groups at most (ops/sort.py EMIT_PLAN_MAX_GROUPS); the repo's ladders: 3
constexpr int MAX_GROUPS = 4;
constexpr int FINISH_THREADS = 256;
constexpr int FINISH_GRID = 264;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr unsigned FLAG_A = 1u;            // the tile's own sums
constexpr unsigned FLAG_P = 2u;            // its inclusive prefix

// The dense groups: eligible where valid and lo < nt <= hi; a group past
// `groups` has lo = hi = INT_MAX and no slot. Group g's slots are
// [start[g], start[g] + cap[g]) of the concatenated outputs.
struct Ladder {
  int lo[MAX_GROUPS], hi[MAX_GROUPS], cap[MAX_GROUPS], start[MAX_GROUPS];
  int groups, max_t, slots;
};

// The sums of a run of splats.
struct alignas(16) Sums {
  long long a;                 // min(nt, max_t)
  long long n;                 // nt
  long long e[MAX_GROUPS];     // nt of the splats eligible for g
  int c[MAX_GROUPS];           // the splats eligible for g
};
static_assert(sizeof(Sums) == 64, "a Sums is four 16-byte words");

union SumsWords {
  Sums s;
  int4 w[4];
};

// A Sums with f applied to each field.
template <class F>
__device__ __forceinline__ Sums each(const Sums& x, F f) {
  Sums y;
  y.a = f(x.a);
  y.n = f(x.n);
#pragma unroll
  for (int g = 0; g < MAX_GROUPS; ++g) {
    y.e[g] = f(x.e[g]);
    y.c[g] = f(x.c[g]);
  }
  return y;
}

__device__ __forceinline__ Sums zero_sums() {
  return each(Sums{}, [](auto) { return 0; });
}

__device__ __forceinline__ void add(Sums& x, const Sums& y) {
  x.a += y.a;
  x.n += y.n;
#pragma unroll
  for (int g = 0; g < MAX_GROUPS; ++g) {
    x.e[g] += y.e[g];
    x.c[g] += y.c[g];
  }
}

__device__ __forceinline__ Sums minus(Sums x, const Sums& y) {
  x.a -= y.a;
  x.n -= y.n;
#pragma unroll
  for (int g = 0; g < MAX_GROUPS; ++g) {
    x.e[g] -= y.e[g];
    x.c[g] -= y.c[g];
  }
  return x;
}

// Inclusive scan over the warp's lanes (the first `width` of them).
__device__ __forceinline__ Sums warp_scan(Sums x, int lane, int width) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    if (d >= width) break;
    const Sums y = each(x, [d](auto v) { return __shfl_up_sync(FULL, v, d); });
    if (lane >= d) add(x, y);
  }
  return x;
}

__device__ __forceinline__ Sums load_l2(const Sums* p) {
  SumsWords u;
  const int4* q = reinterpret_cast<const int4*>(p);
#pragma unroll
  for (int k = 0; k < 4; ++k) u.w[k] = __ldcg(q + k);
  return u.s;
}

__device__ __forceinline__ void store(Sums* p, const Sums& s) {
  SumsWords u;
  u.s = s;
  int4* q = reinterpret_cast<int4*>(p);
#pragma unroll
  for (int k = 0; k < 4; ++k) q[k] = u.w[k];
}

// A flag read with acquire semantics: the words read after it are the
// ones written before its release.
__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// One thread: the sums, then the flag that says they are there (a release
// store; a fence and a relaxed store measured slower).
__device__ __forceinline__ void publish(Sums* words, unsigned* flag,
                                        const Sums& s, unsigned f) {
  store(words, s);
  asm volatile("st.release.gpu.u32 [%0], %1;" :: "l"(flag), "r"(f)
               : "memory");
}

// Warp 0: the sums of the tiles before `tile`. Lane k reads the flag of
// tile last - k; once every tile up to the nearest one with flag P has a
// flag, those tiles' words (the sum where A, the inclusive prefix where
// P) are added up; with no P in the window, the next 32 tiles follow.
// "Tile -1" is a P of nothing.
__device__ Sums look_back(const Sums* agg, const Sums* inc,
                          const unsigned* flags, long long tile, int lane) {
  Sums prefix = zero_sums();
  for (long long last = tile - 1;; last -= 32) {
    const long long j = last - lane;
    unsigned f = j < 0 ? FLAG_P : 0u;
    unsigned pm, upto;
    for (;;) {
      if (f == 0) f = load_acquire(flags + j);
      pm = __ballot_sync(FULL, f == FLAG_P);
      const unsigned zm = __ballot_sync(FULL, f == 0);
      upto = pm ? (pm ^ (pm - 1)) : FULL;   // lanes up to the first P
      if ((zm & upto) == 0) break;
    }
    Sums v = zero_sums();
    if (((upto >> lane) & 1u) && j >= 0)
      v = load_l2(f == FLAG_P ? inc + j : agg + j);
#pragma unroll
    for (int d = 16; d > 0; d >>= 1)
      add(v, each(v, [d](auto x) { return __shfl_xor_sync(FULL, x, d); }));
    add(prefix, v);
    if (pm) return prefix;
  }
}

// The staging buffer's chunk for 16-byte chunk c of a tile's output: eight
// threads of a warp at a time write chunks ITEMS / 4 * t + k (or
// ITEMS / 2 * t + k) and read eight consecutive chunks, each without a
// bank conflict.
__device__ __forceinline__ int swz(int c) { return c ^ ((c >> 3) & 7); }

union Chunk {
  longlong2 l;
  int4 i;
};

// The tile's n capped counts (thread t's ITEMS from t * ITEMS) and their
// offsets (from `off` for the thread's first), staged in shared memory so
// that each warp stores 512 consecutive bytes at a time.
__device__ __forceinline__ void store_tile(int4* stage,
                                           const int (&capped)[ITEMS],
                                           long long off, int* nt_capped,
                                           long long* offsets, int n) {
  const int t = threadIdx.x;
#pragma unroll
  for (int k = 0; k < ITEMS / 4; ++k)
    stage[swz(t * (ITEMS / 4) + k)] =
        make_int4(capped[4 * k], capped[4 * k + 1], capped[4 * k + 2],
                  capped[4 * k + 3]);
  __syncthreads();
  for (int c = t; c < TILE / 4 && 4 * c < n; c += THREADS) {
    const int4 v = stage[swz(c)];
    if (4 * c + 4 <= n) {
      reinterpret_cast<int4*>(nt_capped)[c] = v;
    } else {
      const int w[4] = {v.x, v.y, v.z, v.w};
      for (int u = 0; 4 * c + u < n; ++u) nt_capped[4 * c + u] = w[u];
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < ITEMS / 2; ++k) {
    Chunk ch;
    ch.l.x = off;
    off += capped[2 * k];
    ch.l.y = off;
    off += capped[2 * k + 1];
    stage[swz(t * (ITEMS / 2) + k)] = ch.i;
  }
  __syncthreads();
  for (int c = t; c < TILE / 2 && 2 * c < n; c += THREADS) {
    Chunk ch;
    ch.i = stage[swz(c)];
    if (2 * c + 2 <= n)
      reinterpret_cast<longlong2*>(offsets)[c] = ch.l;
    else
      offsets[2 * c] = ch.l.x;
  }
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
scan_kernel(const uint8_t* __restrict__ valid, const int* __restrict__ nt_in,
            int* __restrict__ nt_capped, long long* __restrict__ offsets,
            int* __restrict__ idx, int* __restrict__ nt_c,
            long long* __restrict__ off_c, Sums* agg, Sums* inc,
            unsigned* flags, unsigned* ticket, long long P, const Ladder L) {
  __shared__ Sums warp_sums[WARPS];   // each warp's sum, then its prefix
  __shared__ Sums tile_prefix;
  __shared__ int4 stage[TILE / 2];    // the tile's outputs, 16 B a chunk
  __shared__ unsigned s_tile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_tile = atomicAdd(ticket, 1u);
  __syncthreads();
  const long long tile = s_tile;
  const long long i0 = tile * TILE + (long long)threadIdx.x * ITEMS;
  int nt[ITEMS];
  unsigned ok = 0;                    // bit j: splat i0 + j is valid
  if (VEC && i0 + ITEMS <= P) {
    const int4* q = reinterpret_cast<const int4*>(nt_in + i0);
#pragma unroll
    for (int k = 0; k < ITEMS / 4; ++k) {
      const int4 w = q[k];
      nt[4 * k] = w.x;
      nt[4 * k + 1] = w.y;
      nt[4 * k + 2] = w.z;
      nt[4 * k + 3] = w.w;
    }
    const uint4 v = *reinterpret_cast<const uint4*>(valid + i0);
    const unsigned vw[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < ITEMS; ++j)
      if ((vw[j >> 2] >> (8 * (j & 3))) & 0xFFu) ok |= 1u << j;
  } else {
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const long long i = i0 + j;
      nt[j] = i < P ? nt_in[i] : 0;
      if (i < P && valid[i]) ok |= 1u << j;
    }
  }
  // the thread's sums (a splat past P counts nothing)
  Sums s = zero_sums();
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    s.a += min(nt[j], L.max_t);
    s.n += nt[j];
    if (((ok >> j) & 1u) && nt[j] > L.lo[0]) {
#pragma unroll
      for (int g = 0; g < MAX_GROUPS; ++g) {
        if (nt[j] > L.lo[g] && nt[j] <= L.hi[g]) {
          s.c[g] += 1;
          s.e[g] += nt[j];
        }
      }
    }
  }
  const Sums x = warp_scan(s, lane, 32);
  if (lane == 31) warp_sums[warp] = x;
  const Sums before = minus(x, s);    // the warp's splats before i0
  __syncthreads();
  if (warp == 0) {
    const Sums w = lane < WARPS ? warp_sums[lane] : zero_sums();
    const Sums wi = warp_scan(w, lane, WARPS);
    const Sums total =
        each(wi, [](auto v) { return __shfl_sync(FULL, v, WARPS - 1); });
    if (lane < WARPS) warp_sums[lane] = minus(wi, w);
    Sums prefix = zero_sums();
    if (tile == 0) {
      if (lane == 0) publish(inc, flags, total, FLAG_P);
    } else {
      if (lane == 0) publish(agg + tile, flags + tile, total, FLAG_A);
      prefix = look_back(agg, inc, flags, tile, lane);
      Sums through = prefix;
      add(through, total);
      if (lane == 0) publish(inc + tile, flags + tile, through, FLAG_P);
    }
    if (lane == 0) tile_prefix = prefix;
  }
  __syncthreads();
  Sums run = tile_prefix;             // the sums of the splats before i0
  add(run, warp_sums[warp]);
  add(run, before);
  long long taken = 0;                // splats before i0 a group took
#pragma unroll
  for (int g = 0; g < MAX_GROUPS; ++g) taken += min(run.c[g], L.cap[g]);
  long long off = run.a - (long long)L.max_t * taken;
  int capped[ITEMS];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    int c = min(nt[j], L.max_t);
    if (((ok >> j) & 1u) && nt[j] > L.lo[0]) {
#pragma unroll
      for (int g = 0; g < MAX_GROUPS; ++g) {
        if (nt[j] > L.lo[g] && nt[j] <= L.hi[g]) {
          const int r = run.c[g];
          if (r < L.cap[g]) {           // taken: slot r of the group
            const int slot = L.start[g] + r;
            idx[slot] = (int)(i0 + j);
            nt_c[slot] = nt[j];
            off_c[slot] = run.e[g];
            c = 0;
          }
          run.c[g] += 1;
          run.e[g] += nt[j];
        }
      }
    }
    capped[j] = c;
  }
  store_tile(stage, capped, off, nt_capped + tile * TILE,
             offsets + tile * TILE, (int)min((long long)TILE, P - tile * TILE));
}

// sums: [base_total, total, overflow, pos0 of each group].
__global__ void __launch_bounds__(FINISH_THREADS)
finish_kernel(const Sums* inc, long long tiles, int* __restrict__ idx,
              int* __restrict__ nt_c, long long* __restrict__ off_c,
              long long* __restrict__ sums, const Ladder L) {
  __shared__ long long gsum[MAX_GROUPS];   // the pairs a group emits
  __shared__ int live[MAX_GROUPS];         // its live slots
  if (threadIdx.x == 0) {
    const Sums t = tiles > 0 ? load_l2(inc + tiles - 1) : zero_sums();
    long long taken = 0;
#pragma unroll
    for (int g = 0; g < MAX_GROUPS; ++g) {
      const int cap = L.cap[g];
      const int n = min(t.c[g], cap);
      live[g] = n;
      taken += n;
      // the cap bites: the taken splats' sum ends at the last slot
      const int last = L.start[g] + cap - 1;
      gsum[g] = n == 0 ? 0
                : t.c[g] <= cap ? t.e[g] : off_c[last] + nt_c[last];
    }
    if (blockIdx.x == 0) {
      long long pos = t.a - (long long)L.max_t * taken;
      sums[0] = pos;
      for (int g = 0; g < L.groups; ++g) {
        sums[3 + g] = pos;
        pos += gsum[g];
      }
      sums[1] = pos;
      sums[2] = t.n - pos;
    }
  }
  __syncthreads();
  for (int s = blockIdx.x * FINISH_THREADS + threadIdx.x; s < L.slots;
       s += gridDim.x * FINISH_THREADS) {
    int g = 0;
    while (g + 1 < L.groups && s >= L.start[g + 1]) ++g;
    if (s - L.start[g] >= live[g]) {
      idx[s] = 0;
      nt_c[s] = 0;
      off_c[s] = gsum[g];
    }
  }
}

long long tiles_of(long long P) { return (P + TILE - 1) / TILE; }

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

// int64 words of the scratch gs_emit_plan takes for P splats: each tile's
// sum and inclusive prefix (8 words each), its flag and the ticket.
extern "C" int gs_emit_plan_scratch_words(long long P) {
  const long long tiles = tiles_of(P);
  return (int)(tiles * 16 + (tiles + 2) / 2);
}

// The plan of P splats: valid (P,) bool, num_tiles (P,) int32 in; out
// nt_capped (P,) int32, offsets (P,) int64, the groups' concatenated
// slots idx, nt_c (S,) int32 and off_c (S,) int64 (S the sum of the
// caps), sums (3 + groups,) int64 ([base_total, total, overflow, pos0 of
// each group]). scratch: gs_emit_plan_scratch_words(P) int64 words.
// ladder: host ints [groups, max_t, then lo, hi, cap of each group]; the
// groups must ascend from max_t (lo_0 >= max_t, lo_g >= hi_(g-1)).
extern "C" int gs_emit_plan(const void* valid, const void* num_tiles,
                            void* nt_capped, void* offsets, void* idx,
                            void* nt_c, void* off_c, void* sums,
                            void* scratch, const void* ladder, long long P,
                            void* stream_) {
  const int* lw = (const int*)ladder;
  Ladder L;
  L.groups = lw[0];
  L.max_t = lw[1];
  if (L.groups < 0 || L.groups > MAX_GROUPS || P < 0 || P > INT_MAX)
    return (int)cudaErrorInvalidValue;
  long long slots = 0;
  for (int g = 0; g < MAX_GROUPS; ++g) {
    const bool used = g < L.groups;
    L.lo[g] = used ? lw[2 + 3 * g] : INT_MAX;
    L.hi[g] = used ? lw[3 + 3 * g] : INT_MAX;
    L.cap[g] = used ? lw[4 + 3 * g] : 0;
    L.start[g] = (int)slots;
    if (L.cap[g] < 0 || (used && L.lo[g] >= L.hi[g])
        || (g == 0 && used && L.lo[0] < L.max_t)
        || (g > 0 && used && L.lo[g] < L.hi[g - 1]))
      return (int)cudaErrorInvalidValue;
    slots += L.cap[g];
  }
  if (slots > INT_MAX || !aligned16(nt_capped) || !aligned16(offsets))
    return (int)cudaErrorInvalidValue;
  L.slots = (int)slots;
  const cudaStream_t stream = (cudaStream_t)stream_;
  const long long tiles = tiles_of(P);
  Sums* agg = (Sums*)scratch;
  Sums* inc = agg + tiles;
  unsigned* flags = (unsigned*)(inc + tiles);
  if (tiles > 0) {
    int err = (int)cudaMemsetAsync(flags, 0, (size_t)(tiles + 1) * 4, stream);
    if (err) return err;
    const int* nt = (const int*)num_tiles;
    const uint8_t* v = (const uint8_t*)valid;
    if (aligned16(nt) && aligned16(v))
      scan_kernel<true><<<(unsigned)tiles, THREADS, 0, stream>>>(
          v, nt, (int*)nt_capped, (long long*)offsets, (int*)idx, (int*)nt_c,
          (long long*)off_c, agg, inc, flags, flags + tiles, P, L);
    else
      scan_kernel<false><<<(unsigned)tiles, THREADS, 0, stream>>>(
          v, nt, (int*)nt_capped, (long long*)offsets, (int*)idx, (int*)nt_c,
          (long long*)off_c, agg, inc, flags, flags + tiles, P, L);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  const long long blocks = (slots + FINISH_THREADS - 1) / FINISH_THREADS;
  finish_kernel<<<(int)(blocks < 1 ? 1 : blocks < FINISH_GRID ? blocks
                                                             : FINISH_GRID),
                  FINISH_THREADS, 0, stream>>>(inc, tiles, (int*)idx,
                                               (int*)nt_c, (long long*)off_c,
                                               (long long*)sums, L);
  return (int)cudaGetLastError();
}
