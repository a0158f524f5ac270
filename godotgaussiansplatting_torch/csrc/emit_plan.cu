// The exact emission's plan: the base group's capped counts and their
// offsets, each dense group's compacted splats, and the totals.
//
// Replaces the plan that `emit_and_sort`, godotgaussiansplatting_tpu/ops/
// sort.py:77-101 and its `_dense_emit` (:132), computes with cumulative
// sums (plain XLA there, no Pallas kernel), which the port repeated as
// some 70 torch launches a frame. The plain version is
// `emit_plan_reference` in ops/sort.py; the outputs are bit-equal to it
// for counts num_tiles >= 0 (a rect's area of tiles).
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
// offset once (12 B): 17 B a splat, 0.0297 ms at 3.35 TB/s for the 1080p
// exact frame's 5.85M splats. A pass this heavy in writes runs slower
// than a copy: widening num_tiles to int64 (4 B read, 8 written a splat)
// reads 2.43 TB/s (PERF.md), which puts a practical floor near 0.04 ms.
//
// Design: a memset of the scratch (its head and every tile's records),
// then two kernels.
// - scan_kernel: a persistent grid, two CTAs an SM, each of 8 worker warps,
//   a sums warp and a scan warp, taking tiles of 4096 splats (16
//   consecutive a worker thread) in ticket order. Named barriers hand each
//   tile from role to role, so that no role waits for a later one's work:
//   * the sums warp takes the tickets and brings each tile's counts and
//     flags into one of three shared-memory buffers by TMA bulk copy
//     (cp.async.bulk on an mbarrier), a tile ahead;
//   * the workers sum their splats and scan them across the warp; the sums
//     warp adds the warps' sums into the tile's (published as its A
//     record) and each warp's exclusive prefix; the scan warp looks back
//     for the tile's prefix and publishes its inclusive one (its P
//     record). Meanwhile the workers sum the next tile, and only then
//     take the prefix and write this tile's outputs: each taken splat's
//     slot, and each warp's run of capped counts and offsets, staged in
//     shared memory in a rotated order (no bank conflict) and sent by two
//     bulk stores (cp.async.bulk.global.shared::cta).
// - The vector is narrowed to the groups the ladder has (G = 0..4, a
//   template argument) and to the bits each field needs: within a tile A,
//   each C_g and each E_g but the last group's are 32-bit (the wrapper
//   refuses a ladder where TILE * max_t or TILE * hi_g reaches 2^31), the
//   last group's E (the giants': no bound) 64-bit; the sum of nt, which
//   only the totals need, is added once a tile to one 64-bit word and left
//   out of the scan. Across tiles A and E are int64, C int32.
// - The records: 16-byte words of three values and a mark (3 words for a
//   tile's sums and 4 for its prefix at G = 3), each written by one store
//   and read by one load, so a reader that finds the mark in every word of
//   a record has all of it. A look-back step (32 tiles, a lane each, both
//   records read at once) is then one round trip. Flag words beside the
//   values (a release store after them, an acquire load before them) took
//   two, and each release stalled its warp for a round trip.
// - finish_kernel: from the last tile's inclusive prefix and the sum of
//   nt, the totals (the base group's, each group's first position, the
//   whole emission's and the pairs the caps drop) and each group's dead
//   slots (idx 0, nt_c 0, off_c the group's sum). Every output element is
//   written once.
// Measured and left out (PERF.md): a reduce-then-scan in two launches,
// 128-thread CTAs, tiles by block index, a CTA that looks back between its
// tile's sums and its outputs (no overlap), flag words with release and
// acquire, one CTA an SM, 8192-splat tiles, two tiles a lane of the
// look-back (the last three are copies in split_plan.py).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;              // worker threads of a CTA
constexpr int WARPS = THREADS / 32;
constexpr int ALL_THREADS = THREADS + 64;  // and the sums and scan warps
constexpr int ITEMS = 16;                  // consecutive splats a thread
constexpr int TILE = THREADS * ITEMS;      // splats a tile
constexpr int WARP_ITEMS = 32 * ITEMS;     // a warp's run of a tile
constexpr int NBUF = 3;                    // input buffers (tiles) a CTA
constexpr int CTAS_PER_SM = 2;             // of the persistent grid, at most
// groups at most (ops/sort.py EMIT_PLAN_MAX_GROUPS); the repo's ladders: 3
constexpr int MAX_GROUPS = 4;
constexpr int FINISH_THREADS = 256;
constexpr int FINISH_GRID = 264;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int MARK = 1;    // the last word of each 16-byte word of a record
// dynamic shared memory: the input buffers (counts and flags, 5 B a
// splat) and the staging of the outputs (12 B a splat)
constexpr int SMEM = TILE * (NBUF * 5 + 12);
static_assert(NBUF >= 3, "buffers for the outputs' tile, the sums' tile "
              "and one in flight");

static_assert(ITEMS == 16 && WARP_ITEMS % 16 == 0, "the rotations' shape");

// The dense groups: eligible where valid and lo < nt <= hi; a group past
// `groups` has lo = hi = INT_MAX and no slot. Group g's slots are
// [start[g], start[g] + cap[g]) of the concatenated outputs.
struct Ladder {
  int lo[MAX_GROUPS], hi[MAX_GROUPS], cap[MAX_GROUPS], start[MAX_GROUPS];
  int groups, max_t, slots;
};

// The sums of every splat: the last tile's inclusive prefix.
struct Totals {
  long long a;
  long long e[MAX_GROUPS];
  int c[MAX_GROUPS];
};

// The head of the scratch, zeroed by the memset with the records after it.
struct Head {
  long long n;          // the sum of nt over every splat
  Totals tot;           // a group past G: 0
  unsigned ticket;
  unsigned pad;
};

// The sums of a run of splats inside a tile: 32-bit but the last group's E.
template <int G>
struct Run {
  int a;                          // min(nt, max_t)
  int c[G > 0 ? G : 1];           // the splats eligible for g
  int e[G > 1 ? G - 1 : 1];       // their nt, each group but the last
  long long el;                   // the last group's nt
};

// The sums of the tiles before one: A and E as int64, C as int32 (< P).
template <int G>
struct Wide {
  long long a;
  int c[G > 0 ? G : 1];
  long long e[G > 0 ? G : 1];
};

// 16-byte words of a tile's published sums and of its inclusive prefix:
// three values and MARK each
__host__ __device__ constexpr int ka(int g) {
  return ((g > 0 ? 2 * g + 2 : 1) + 2) / 3;
}
__host__ __device__ constexpr int kp(int g) { return (3 * g + 2 + 2) / 3; }

template <int G, class F>
__device__ __forceinline__ Run<G> each(const Run<G>& x, F f) {
  Run<G> y{};
  y.a = f(x.a);
#pragma unroll
  for (int g = 0; g < G; ++g) y.c[g] = f(x.c[g]);
#pragma unroll
  for (int g = 0; g + 1 < G; ++g) y.e[g] = f(x.e[g]);
  if constexpr (G > 0) y.el = f(x.el);
  return y;
}

template <int G, class F>
__device__ __forceinline__ Wide<G> each(const Wide<G>& x, F f) {
  Wide<G> y{};
  y.a = f(x.a);
#pragma unroll
  for (int g = 0; g < G; ++g) {
    y.c[g] = f(x.c[g]);
    y.e[g] = f(x.e[g]);
  }
  return y;
}

// x += s * y (s = 1 or -1)
template <int G>
__device__ __forceinline__ void add(Run<G>& x, const Run<G>& y, int s = 1) {
  x.a += s * y.a;
#pragma unroll
  for (int g = 0; g < G; ++g) x.c[g] += s * y.c[g];
#pragma unroll
  for (int g = 0; g + 1 < G; ++g) x.e[g] += s * y.e[g];
  if constexpr (G > 0) x.el += s * y.el;
}

template <int G>
__device__ __forceinline__ void add(Wide<G>& x, const Wide<G>& y) {
  x.a += y.a;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    x.c[g] += y.c[g];
    x.e[g] += y.e[g];
  }
}

// E of group g of a run
template <int G>
__device__ __forceinline__ long long e_of(const Run<G>& x, int g) {
  return g + 1 < G ? (long long)x.e[g + 1 < G ? g : 0] : x.el;
}

template <int G>
__device__ __forceinline__ Wide<G> widen(const Run<G>& x) {
  Wide<G> y{};
  y.a = x.a;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    y.c[g] = x.c[g];
    y.e[g] = e_of(x, g);
  }
  return y;
}

// Inclusive scan over the warp's lanes (the first `width` of them).
template <int G>
__device__ __forceinline__ Run<G> warp_scan(Run<G> x, int lane, int width) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    if (d >= width) break;
    const Run<G> y =
        each(x, [d](auto v) { return __shfl_up_sync(FULL, v, d); });
    if (lane >= d) add(x, y);
  }
  return x;
}

__device__ __forceinline__ long long warp_sum(long long x) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) x += __shfl_xor_sync(FULL, x, d);
  return x;
}

template <int G>
__device__ __forceinline__ Wide<G> warp_sum(Wide<G> x) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    add(x, each(x, [d](auto v) { return __shfl_xor_sync(FULL, v, d); }));
  return x;
}

__device__ __forceinline__ long long join(int lo, int hi) {
  return (long long)(((unsigned long long)(unsigned)hi << 32) | (unsigned)lo);
}

// A 16-byte word to L2 and from it, each one access: a record's words
// are read whole, so a reader that finds MARK in every word of a record
// has it all (the scratch is zeroed first).
__device__ __forceinline__ void store_word(int4* p, int x, int y, int z) {
  asm volatile("st.global.cg.v4.s32 [%0], {%1, %2, %3, %4};" ::"l"(p),
               "r"(x), "r"(y), "r"(z), "r"(MARK)
               : "memory");
}
__device__ __forceinline__ int4 load_word(const int4* p) {
  int4 v;
  asm volatile("ld.global.cg.v4.s32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p)
               : "memory");
  return v;
}

// Values into words three at a time; whether every word was written.
template <int K>
__device__ __forceinline__ void store_words(int4* p, const int (&w)[3 * K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) store_word(p + k, w[3 * k], w[3 * k + 1],
                                         w[3 * k + 2]);
}
template <int K>
__device__ __forceinline__ bool load_words(const int4* p, int (&w)[3 * K]) {
  bool whole = true;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int4 v = load_word(p + k);
    w[3 * k] = v.x;
    w[3 * k + 1] = v.y;
    w[3 * k + 2] = v.z;
    whole &= v.w == MARK;
  }
  return whole;
}

// A tile's sums: a, c[G], e[G - 1], el (two values).
template <int G>
__device__ __forceinline__ void store_run(int4* p, const Run<G>& x) {
  int w[3 * ka(G)] = {};
  w[0] = x.a;
  if constexpr (G > 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) w[1 + g] = x.c[g];
#pragma unroll
    for (int g = 0; g + 1 < G; ++g) w[1 + G + g] = x.e[g];
    w[2 * G] = (int)x.el;
    w[2 * G + 1] = (int)(x.el >> 32);
  }
  store_words<ka(G)>(p, w);
}

template <int G>
__device__ __forceinline__ bool load_run(const int4* p, Wide<G>& y) {
  int w[3 * ka(G)];
  const bool whole = load_words<ka(G)>(p, w);
  y = Wide<G>{};
  y.a = w[0];
  if constexpr (G > 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) y.c[g] = w[1 + g];
#pragma unroll
    for (int g = 0; g + 1 < G; ++g) y.e[g] = w[1 + G + g];
    y.e[G - 1] = join(w[2 * G], w[2 * G + 1]);
  }
  return whole;
}

// A prefix: a (two values), c[G], e[G] (two values each).
template <int G>
__device__ __forceinline__ void store_wide(int4* p, const Wide<G>& x) {
  int w[3 * kp(G)] = {};
  w[0] = (int)x.a;
  w[1] = (int)(x.a >> 32);
#pragma unroll
  for (int g = 0; g < G; ++g) {
    w[2 + g] = x.c[g];
    w[2 + G + 2 * g] = (int)x.e[g];
    w[3 + G + 2 * g] = (int)(x.e[g] >> 32);
  }
  store_words<kp(G)>(p, w);
}

template <int G>
__device__ __forceinline__ bool load_wide(const int4* p, Wide<G>& y) {
  int w[3 * kp(G)];
  const bool whole = load_words<kp(G)>(p, w);
  y.a = join(w[0], w[1]);
#pragma unroll
  for (int g = 0; g < G; ++g) {
    y.c[g] = w[2 + g];
    y.e[g] = join(w[2 + G + 2 * g], w[3 + G + 2 * g]);
  }
  return whole;
}

// The scan warp: the sums of the tiles before `tile`. Lane k reads both
// records of tile last - k, its inclusive prefix and its sums, until one
// of them is whole (P or A); once every tile up to the nearest one with a
// P has one, their values (the prefix where P, else the sums) are added
// up; with no P among the 32, the next 32 tiles follow. "Tile -1" is a P
// of nothing.
template <int G>
__device__ Wide<G> look_back(const int4* agg, const int4* inc, long long tile,
                             int lane) {
  constexpr int NONE = 0, A = 1, PRE = 2;
  Wide<G> prefix{};
  for (long long last = tile - 1;; last -= 32) {
    const long long j = last - lane;
    int f = j < 0 ? PRE : NONE;
    Wide<G> v{};
    unsigned pm, upto;
    for (;;) {
      if (f == NONE) {   // both records' loads in flight together
        Wide<G> p, a;
        const bool whole_p = load_wide<G>(inc + j * kp(G), p);
        const bool whole_a = load_run<G>(agg + j * ka(G), a);
        f = whole_p ? PRE : whole_a ? A : NONE;
        v = whole_p ? p : a;
      }
      pm = __ballot_sync(FULL, f == PRE);
      const unsigned zm = __ballot_sync(FULL, f == NONE);
      upto = pm ? (pm ^ (pm - 1)) : FULL;   // lanes up to the first P
      if ((zm & upto) == 0) break;
    }
    if (!((upto >> lane) & 1u) || j < 0) v = Wide<G>{};
    add(prefix, warp_sum(v));
    if (pm) return prefix;
  }
}

// Rotate chunks of W ints: x's chunk k becomes its chunk (k + D * s) mod N
// (a barrel shifter: selects, no local memory).
template <int N, int W, int D>
__device__ __forceinline__ void rotate(int (&x)[N * W], int s) {
#pragma unroll
  for (int m = 1; m < N; m <<= 1) {
    const bool on = (s & m) != 0;
    int y[N * W];
#pragma unroll
    for (int k = 0; k < N; ++k)
#pragma unroll
      for (int i = 0; i < W; ++i)
        y[k * W + i] = on ? x[((k + D * m) & (N - 1)) * W + i] : x[k * W + i];
#pragma unroll
    for (int k = 0; k < N * W; ++k) x[k] = y[k];
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)));
}

// Thread 0: bring `bytes` (a multiple of 16) from src to dst, counted on bar
// (the caller has armed it with the whole transfer).
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void bar_arm(uint64_t* bar, uint32_t bytes) {
  // the generic-proxy reads of the buffer before this point, ordered
  // before the async proxy's writes
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t phase) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_%=;\n}" ::"r"(smem_addr(bar)),
      "r"(phase)
      : "memory");
}

// One thread: `bytes` (a multiple of 16) from shared src to global dst.
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               ::"l"(dst), "r"(smem_addr(src)), "r"(bytes)
               : "memory");
}

// Named barriers among the worker warps, the sums warp and the scan warp
// (0 is __syncthreads), one of each for even and odd tiles of a CTA: the
// workers' warp sums are in (SUMS: workers and the sums warp), the tile's
// total is in (TOTAL: the sums and the scan warp), its prefix is out
// (PREFIX: the scan warp and the workers).
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}
constexpr int BAR_SUMS = 1, BAR_TOTAL = 3, BAR_PREFIX = 5;   // + parity

// A worker thread's ITEMS splats of a tile from buffer b (or, without the
// bulk copies, from global memory): counts, and bit j set where splat
// j0 + j is valid; a splat past the tile's n counts nothing.
template <bool BULK>
__device__ __forceinline__ void load_items(
    const int4* in_nt, const int4* in_ok, const uint8_t* __restrict__ valid,
    const int* __restrict__ nt_in, long long base, int n, int t,
    int (&nt)[ITEMS], unsigned& ok) {
  const int j0 = t * ITEMS;
  ok = 0;
  if (BULK) {
    // the thread's four 16-byte words, each quarter-warp reading eight
    // different bank groups: slot k holds word (k + s) & 3
    const int s = (t >> 1) & 3;
    const int4* q = in_nt + t * (ITEMS / 4);
#pragma unroll
    for (int k = 0; k < ITEMS / 4; ++k) {
      const int4 v = q[(k + s) & 3];
      nt[4 * k] = v.x;
      nt[4 * k + 1] = v.y;
      nt[4 * k + 2] = v.z;
      nt[4 * k + 3] = v.w;
    }
    rotate<4, 4, -1>(nt, s);
    const int4 v = in_ok[t];
    const unsigned vw[4] = {(unsigned)v.x, (unsigned)v.y, (unsigned)v.z,
                            (unsigned)v.w};
#pragma unroll
    for (int j = 0; j < ITEMS; ++j)
      if ((vw[j >> 2] >> (8 * (j & 3))) & 0xFFu) ok |= 1u << j;
    const int m = n & ~15;             // the splats the bulk copy brought
    if (j0 + ITEMS > m) {
#pragma unroll
      for (int j = 0; j < ITEMS; ++j) {
        const int i = j0 + j;
        if (i >= m) {
          nt[j] = i < n ? nt_in[base + i] : 0;
          ok &= ~(1u << j);
          if (i < n && valid[base + i]) ok |= 1u << j;
        }
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int i = j0 + j;
      nt[j] = i < n ? nt_in[base + i] : 0;
      if (i < n && valid[base + i]) ok |= 1u << j;
    }
  }
}

template <int G, bool BULK>
__global__ void __launch_bounds__(ALL_THREADS, CTAS_PER_SM)
scan_kernel(const uint8_t* __restrict__ valid, const int* __restrict__ nt_in,
            int* __restrict__ nt_capped, long long* __restrict__ offsets,
            int* __restrict__ idx, int* __restrict__ nt_c,
            long long* __restrict__ off_c, Head* head, int4* agg,
            int4* inc, unsigned tiles, long long P,
            const Ladder L) {
  extern __shared__ __align__(128) int4 smem[];
  int4* const in_nt = smem;                      // [NBUF][TILE / 4]
  int4* const in_ok = in_nt + NBUF * (TILE / 4); // [NBUF][TILE / 16]
  int4* const st_cap = in_ok + NBUF * (TILE / 16);   // [TILE / 4]
  int4* const st_off = st_cap + TILE / 4;            // [TILE / 2]
  // by the tile's parity: each warp's sums, then the sums of the tile's
  // splats before it; their nt sums; the sums of the tiles before it
  __shared__ Run<G> warp_run[2][WARPS];
  __shared__ long long warp_n[2][WARPS];
  __shared__ Run<G> tile_total[2];
  __shared__ Wide<G> tile_prefix[2];
  __shared__ unsigned s_tile[NBUF];
  __shared__ __align__(8) uint64_t bars[NBUF];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (t == 0) {
    for (int b = 0; b < NBUF; ++b) bar_init(&bars[b]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == WARPS) {
    // The sums warp: the tickets and the bulk copies of the inputs, then
    // each tile's sums (published as its A record) and the sums of its
    // splats before each warp, as soon as the workers have their warps'
    // sums.
    unsigned pending = 0;              // lane 0: the next ticket
    // lane 0: the CTA's local tile m into buffer m % NBUF (its ticket; the
    // whole 16-byte words of both inputs, the splats past them read by the
    // workers from global memory; a ticket past the end arms the barrier
    // with nothing)
    auto fetch = [&](int m) {
      const int b = m % NBUF;
      const unsigned tile = pending;
      pending = atomicAdd(&head->ticket, 1u);
      s_tile[b] = tile;
      uint32_t whole = 0;              // splats in whole 16-byte words
      const long long base = (long long)tile * TILE;
      if (BULK && tile < tiles)
        whole = (uint32_t)min((long long)TILE, P - base) & ~15u;
      bar_arm(&bars[b], whole * 5);
      if (whole) {
        bulk_load(in_nt + b * (TILE / 4), nt_in + base, whole * 4, &bars[b]);
        bulk_load(in_ok + b * (TILE / 16), valid + base, whole, &bars[b]);
      }
    };
    if (lane == 0) {
      pending = atomicAdd(&head->ticket, 1u);
      for (int m = 0; m + 2 < NBUF; ++m) fetch(m);
    }
#pragma unroll 1
    for (int m = 0;; ++m) {
      const int par = m & 1;
      bar_sync(BAR_SUMS + par, THREADS + 32);
      // every worker is done with local tile m - 2: its buffer is free
      if (lane == 0) fetch(m + NBUF - 2);
      const unsigned tile = s_tile[m % NBUF];
      if (tile >= tiles) {
        bar_arrive(BAR_TOTAL + par, 64);
        break;
      }
      Run<G> w{};
      if (lane < WARPS) w = warp_run[par][lane];
      const Run<G> wi = warp_scan(w, lane, WARPS);
      const Run<G> total =
          each(wi, [](auto v) { return __shfl_sync(FULL, v, WARPS - 1); });
      if (lane < WARPS) {
        Run<G> ex = wi;
        add(ex, w, -1);
        warp_run[par][lane] = ex;
      }
      if (lane == 0) tile_total[par] = total;
      const long long ntile =
          warp_sum(lane < WARPS ? warp_n[par][lane] : 0LL);
      bar_arrive(BAR_TOTAL + par, 64);
      if (lane == 0) {
        atomicAdd((unsigned long long*)&head->n, (unsigned long long)ntile);
        if (tile > 0) store_run(agg + (size_t)tile * ka(G), total);
      }
    }
    return;
  }
  if (warp == WARPS + 1) {
    // The scan warp: each tile's prefix from the look-back, then its
    // inclusive prefix (published with flag P).
#pragma unroll 1
    for (int m = 0;; ++m) {
      const int par = m & 1;
      bar_sync(BAR_TOTAL + par, 64);
      const unsigned tile = s_tile[m % NBUF];
      if (tile >= tiles) break;
      Wide<G> through = widen(tile_total[par]);
      Wide<G> prefix{};
      if (tile > 0) prefix = look_back<G>(agg, inc, tile, lane);
      if (lane == 0) tile_prefix[par] = prefix;
      bar_arrive(BAR_PREFIX + par, THREADS + 32);
      if (lane == 0) {
        add(through, prefix);
        store_wide(inc + (size_t)tile * kp(G), through);
        if (tile + 1 == tiles) {
          head->tot.a = through.a;
#pragma unroll
          for (int g = 0; g < G; ++g) {
            head->tot.c[g] = through.c[g];
            head->tot.e[g] = through.e[g];
          }
        }
      }
    }
    return;
  }

  // The workers: the sums of local tile k, then the outputs of tile k - 1
  // once the scan warp has its prefix, so that the look-back of a tile
  // overlaps the next tile's sums.
  const int j0 = t * ITEMS;            // the thread's first splat of a tile
  const int wbase = warp * WARP_ITEMS;
  Run<G> before_prev{};                // the warp's splats before j0
  unsigned tile_prev = 0;
#pragma unroll 1
  for (int k = 0;; ++k) {
    const int b = k % NBUF;
    bar_wait(&bars[b], (k / NBUF) & 1);
    const unsigned tile = s_tile[b];
    Run<G> before{};
    if (tile < tiles) {
      const long long base = (long long)tile * TILE;
      const int n = (int)min((long long)TILE, P - base);
      int nt[ITEMS];
      unsigned ok;
      load_items<BULK>(in_nt + b * (TILE / 4), in_ok + b * (TILE / 16),
                       valid, nt_in, base, n, t, nt, ok);
      // the thread's sums
      Run<G> s{};
      long long nsum = 0;
#pragma unroll
      for (int j = 0; j < ITEMS; ++j) {
        s.a += min(nt[j], L.max_t);
        nsum += nt[j];
        if constexpr (G > 0) {
          if (((ok >> j) & 1u) && nt[j] > L.lo[0]) {
#pragma unroll
            for (int g = 0; g < G; ++g) {
              if (nt[j] > L.lo[g] && nt[j] <= L.hi[g]) {
                s.c[g] += 1;
                if (g + 1 < G)
                  s.e[g + 1 < G ? g : 0] += nt[j];
                else
                  s.el += nt[j];
              }
            }
          }
        }
      }
      const Run<G> x = warp_scan(s, lane, 32);
      before = x;
      add(before, s, -1);
      nsum = warp_sum(nsum);
      if (lane == 31) warp_run[k & 1][warp] = x;
      if (lane == 0) warp_n[k & 1][warp] = nsum;
    }
    bar_arrive(BAR_SUMS + (k & 1), THREADS + 32);   // a sentinel too
    if (k > 0) {
      // the outputs of tile k - 1
      const int pb = (k - 1) % NBUF, par = (k - 1) & 1;
      const long long base = (long long)tile_prev * TILE;
      const int n = (int)min((long long)TILE, P - base);
      int nt[ITEMS];
      unsigned ok;
      load_items<BULK>(in_nt + pb * (TILE / 4), in_ok + pb * (TILE / 16),
                       valid, nt_in, base, n, t, nt, ok);
      bar_sync(BAR_PREFIX + par, THREADS + 32);
      Run<G> r = warp_run[par][warp];
      add(r, before_prev);
      const Wide<G> pre = tile_prefix[par];
      int cnt[G > 0 ? G : 1];
      long long e[G > 0 ? G : 1];
      long long taken = 0;             // splats before j0 a group took
#pragma unroll
      for (int g = 0; g < G; ++g) {
        cnt[g] = pre.c[g] + r.c[g];
        e[g] = pre.e[g] + e_of(r, g);
        taken += min(cnt[g], L.cap[g]);
      }
      const long long off = pre.a + r.a - (long long)L.max_t * taken;
      int capped[ITEMS], pc[ITEMS];    // pc: the thread's exclusive prefix
      int run = 0;
#pragma unroll
      for (int j = 0; j < ITEMS; ++j) {
        int c = min(nt[j], L.max_t);
        if constexpr (G > 0) {
          if (((ok >> j) & 1u) && nt[j] > L.lo[0]) {
#pragma unroll
            for (int g = 0; g < G; ++g) {
              if (nt[j] > L.lo[g] && nt[j] <= L.hi[g]) {
                if (cnt[g] < L.cap[g]) {   // taken: slot cnt of the group
                  const int slot = L.start[g] + cnt[g];
                  idx[slot] = (int)(base + j0 + j);
                  nt_c[slot] = nt[j];
                  off_c[slot] = e[g];
                  c = 0;
                }
                cnt[g] += 1;
                e[g] += nt[j];
              }
            }
          }
        }
        capped[j] = c;
        pc[j] = run;
        run += c;
      }
      // the warp's run leaves by two bulk stores of whole 16-byte words;
      // the last tile's splats past them are stored here
      const int nw = max(0, min(n - wbase, WARP_ITEMS));
      const int nw4 = nw & ~3, nw2 = nw & ~1;
      if (j0 + ITEMS > wbase + nw2) {
#pragma unroll
        for (int j = 0; j < ITEMS; ++j) {
          const int i = j0 + j;
          if (i < wbase + nw) {
            if (i >= wbase + nw4) nt_capped[base + i] = capped[j];
            if (i >= wbase + nw2) offsets[base + i] = off + pc[j];
          }
        }
      }
      if (lane == 0)   // the staging read by the warp's last bulk stores
        asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
      __syncwarp();
      // staged in splat order, written in a rotated order: a
      // quarter-warp's eight 16-byte stores land in eight bank groups
      const int s4 = (lane >> 1) & 3, s8 = lane & 7;
      rotate<4, 4, 1>(capped, s4);
      int4* const sc = st_cap + wbase / 4 + lane * (ITEMS / 4);
#pragma unroll
      for (int q = 0; q < ITEMS / 4; ++q)
        sc[(q + s4) & 3] = make_int4(capped[4 * q], capped[4 * q + 1],
                                     capped[4 * q + 2], capped[4 * q + 3]);
      rotate<8, 2, 1>(pc, s8);
      longlong2* const so = reinterpret_cast<longlong2*>(st_off) + wbase / 2
                            + lane * (ITEMS / 2);
#pragma unroll
      for (int q = 0; q < ITEMS / 2; ++q)
        so[(q + s8) & 7] =
            make_longlong2(off + pc[2 * q], off + pc[2 * q + 1]);
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      __syncwarp();
      if (lane == 0) {
        if (nw4)
          bulk_store(nt_capped + base + wbase, st_cap + wbase / 4, nw4 * 4);
        if (nw2)
          bulk_store(offsets + base + wbase, st_off + wbase / 2, nw2 * 8);
        asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      }
    }
    if (tile >= tiles) break;
    before_prev = before;
    tile_prev = tile;
  }
  if (lane == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// sums: [base_total, total, overflow, pos0 of each group].
__global__ void __launch_bounds__(FINISH_THREADS)
finish_kernel(const Head* head, int* __restrict__ idx,
              int* __restrict__ nt_c, long long* __restrict__ off_c,
              long long* __restrict__ sums, const Ladder L) {
  __shared__ long long gsum[MAX_GROUPS];   // the pairs a group emits
  __shared__ int live[MAX_GROUPS];         // its live slots
  if (threadIdx.x == 0) {
    const Totals t = head->tot;
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
      sums[2] = head->n - pos;
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

// where the records start, after the head
constexpr size_t RECORDS_AT = (sizeof(Head) + 15) & ~(size_t)15;

struct Args {
  const uint8_t* valid;
  const int* nt;
  int* nt_capped;
  long long* offsets;
  int* idx;
  int* nt_c;
  long long* off_c;
  Head* head;
  int4* agg;
  int4* inc;
  unsigned tiles;
  long long P;
};

template <int G, bool BULK>
int launch_scan(const Args& a, const Ladder& L, cudaStream_t stream) {
  static int per_card = 0;             // the persistent grid's CTAs
  if (per_card == 0) {
    int dev = 0, sms = 0, per = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(scan_kernel<G, BULK>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per, scan_kernel<G, BULK>, ALL_THREADS, SMEM);
    if (e != cudaSuccess) return (int)e;
    per_card = sms * (per < 1 ? 1 : per < CTAS_PER_SM ? per : CTAS_PER_SM);
  }
  const unsigned grid =
      a.tiles < (unsigned)per_card ? a.tiles : (unsigned)per_card;
  scan_kernel<G, BULK><<<grid, ALL_THREADS, SMEM, stream>>>(
      a.valid, a.nt, a.nt_capped, a.offsets, a.idx, a.nt_c, a.off_c, a.head,
      a.agg, a.inc, a.tiles, a.P, L);
  return (int)cudaGetLastError();
}

template <bool BULK>
int launch_groups(const Args& a, const Ladder& L, cudaStream_t stream) {
  switch (L.groups) {
    case 0: return launch_scan<0, BULK>(a, L, stream);
    case 1: return launch_scan<1, BULK>(a, L, stream);
    case 2: return launch_scan<2, BULK>(a, L, stream);
    case 3: return launch_scan<3, BULK>(a, L, stream);
    default: return launch_scan<4, BULK>(a, L, stream);
  }
}

}  // namespace

// Splats a tile (ops/sort.py EMIT_PLAN_TILE).
extern "C" int gs_emit_plan_tile() { return TILE; }

// int64 words of the scratch gs_emit_plan takes for P splats: the head
// (the sum of nt, the totals, the ticket), each tile's flag, sums and
// inclusive prefix.
extern "C" int gs_emit_plan_scratch_words(long long P) {
  const long long tiles = tiles_of(P);
  return (int)((RECORDS_AT + tiles * 16 * (ka(MAX_GROUPS) + kp(MAX_GROUPS)))
               / 8);
}

// The plan of P splats: valid (P,) bool, num_tiles (P,) int32 (counts,
// >= 0) in; out nt_capped (P,) int32, offsets (P,) int64, the groups'
// concatenated slots idx, nt_c (S,) int32 and off_c (S,) int64 (S the sum
// of the caps), sums (3 + groups,) int64 ([base_total, total, overflow,
// pos0 of each group]). scratch: gs_emit_plan_scratch_words(P) int64
// words. ladder: host ints [groups, max_t, then lo, hi, cap of each
// group]; the groups must ascend from max_t (lo_0 >= max_t, lo_g >=
// hi_(g-1)), and TILE * max_t and TILE * hi_g of each group but the last
// stay below 2^31.
extern "C" int gs_emit_plan(const void* valid, const void* num_tiles,
                            void* nt_capped, void* offsets, void* idx,
                            void* nt_c, void* off_c, void* sums,
                            void* scratch, const void* ladder, long long P,
                            void* stream_) {
  const int* lw = (const int*)ladder;
  Ladder L;
  L.groups = lw[0];
  L.max_t = lw[1];
  if (L.groups < 0 || L.groups > MAX_GROUPS || P < 0 || P > INT_MAX
      || (long long)TILE * L.max_t > INT_MAX)
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
        || (g > 0 && used && L.lo[g] < L.hi[g - 1])
        || (g + 1 < L.groups && (long long)TILE * L.hi[g] > INT_MAX))
      return (int)cudaErrorInvalidValue;
    slots += L.cap[g];
  }
  if (slots > INT_MAX || !aligned16(nt_capped) || !aligned16(offsets))
    return (int)cudaErrorInvalidValue;
  L.slots = (int)slots;
  const cudaStream_t stream = (cudaStream_t)stream_;
  const long long tiles = tiles_of(P);
  char* const base = (char*)scratch;
  Head* const head = (Head*)base;
  int4* const agg = (int4*)(base + RECORDS_AT);
  int4* const inc = agg + tiles * ka(L.groups);
  // the head and every record zeroed: no word carries MARK yet
  int err = (int)cudaMemsetAsync(
      head, 0, RECORDS_AT + tiles * 16 * (ka(L.groups) + kp(L.groups)),
      stream);
  if (err) return err;
  if (tiles > 0) {
    const Args a{(const uint8_t*)valid, (const int*)num_tiles,
                 (int*)nt_capped,       (long long*)offsets,
                 (int*)idx,             (int*)nt_c,
                 (long long*)off_c,     head,
                 agg,                   inc,
                 (unsigned)tiles,       P};
    err = aligned16(valid) && aligned16(num_tiles)
              ? launch_groups<true>(a, L, stream)
              : launch_groups<false>(a, L, stream);
    if (err) return err;
  }
  const long long blocks = (slots + FINISH_THREADS - 1) / FINISH_THREADS;
  finish_kernel<<<(int)(blocks < 1 ? 1 : blocks < FINISH_GRID ? blocks
                                                             : FINISH_GRID),
                  FINISH_THREADS, 0, stream>>>(head, (int*)idx, (int*)nt_c,
                                               (long long*)off_c,
                                               (long long*)sums, L);
  return (int)cudaGetLastError();
}
