// The screen clustering's per-superblock stable row sort and its gathers.
//
// Replaces XLA's `lax.sort` of the stage-1 operands along each superblock
// row, godotgaussiansplatting_tpu/ops/blocks2.py:461 (`build_block_frame2`)
// and :687 (the screen branch of `build_block_frame2_words`), plain XLA
// there with no Pallas kernel. Semantics follow `screen_sort_reference` in
// ops/blocks2.py: each (SB, n) row's u32 keys, a key read as 0xFFFFFFFF
// where `taken` is set, sorted stably (ties keep their position), and the
// seven stage-1 words written in that order: the key, the five payload
// words (ix, iy, pc1, pc2, rgb9) gathered from the row, and the source
// position row * n + j (computed, not read).
//
// What bounds it on Hopper: device-memory bandwidth. An element reads its
// key, its taken byte and five payload words (25 B) and writes seven words
// (28 B); the sort itself runs in shared memory.
//
// Design: a persistent grid, one CTA of 1024 threads an SM, each walking
// its share of the rows, so that the loads of one row overlap the work on
// another and no wave is left part full:
// - a row's keys and taken bytes, and each of its payload words, come in as
//   TMA bulk copies (cp.async.bulk, completing on an mbarrier): the next
//   row's keys while this row's payload is gathered, this row's first two
//   payload words while its keys are sorted, and word w + 2 while word w is
//   gathered (two staging buffers);
// - each row is sorted on the bits it has: the smallest and largest live
//   key (not 0xFFFFFFFF) of the row, lo and hi, give the width b =
//   bit_length(hi - lo + 1) of the word key - lo; where fewer bits do, the
//   key's halves (the screen cell h, the depth d) are narrowed apart: the
//   word is (h - hl) << db | (d - dl), db = bit_length(dh - dl), which keeps
//   the order of the keys. The row sorts its words, all ones of b bits for
//   a dead key, in ceil(b / 8) LSD passes of 8-bit digits (`pass`), a pass
//   whose digit every element shares skipped. The keys written are rebuilt
//   from the sorted words, or 0xFFFFFFFF, so they are the row's own
//   whatever width it took;
// - the row is padded to 8192 with all-ones words, which sort after every
//   real one; the payload words go out through the permutation from the
//   staging buffer, a word at a time, so every device-memory access is
//   coalesced.
// Rows whose length or addresses are not multiples of 16 bytes take the
// same steps with plain loads in place of the bulk copies. Shared memory:
// two word buffers (64 KB), two position buffers (32 KB), the count table
// (32 KB) and two staging buffers (64 KB), 192 KB.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_N = 8192;
constexpr int ITEMS = MAX_N / THREADS;   // elements a lane
constexpr int STEPS = MAX_N / WARPS / 32;
constexpr int RADIX = 256;
constexpr int WORDS = 5;                 // payload words gathered
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr uint32_t INVALID = 0xFFFFFFFFu;
constexpr size_t SMEM = 2 * MAX_N * 4 + 2 * MAX_N * 2 +
                        RADIX * WARPS * 4 + 2 * MAX_N * 4;   // 192 KB

static_assert(RADIX * WARPS == THREADS * 8, "8 table entries a thread");

// The stable LSD radix pass of 8-bit digits over the row's words in shared
// memory. Warp w owns the elements [w * SEG, (w + 1) * SEG), SEG = 32 *
// STEPS, 32 at a time. A pass: each warp counts its digits into a
// digit-major, warp-minor table (eight ballots group the lanes of one digit
// and the group's first lane adds its size with a shared-memory reduction,
// nothing waited for); one exclusive scan of that table gives every (digit,
// warp) its first slot; each warp then hands its elements, in order, to the
// caller's store with their slot: the group's first lane moves the (digit,
// warp) cursor by the group's size with one atomic add, and every lane of
// the group reads the old cursor from it by a shuffle and adds the group's
// lanes below it (the groups found while counting, kept in registers). A
// warp's adds to one entry are made in its program order, so the order is
// stable by construction.

// The (digit, warp) entry of the count table: digit-major, warp-minor, the
// warp index swizzled by the digit's low bits, so that the lanes of a warp
// reading the entries of different digits hit different banks.
__device__ __forceinline__ int entry(uint32_t d, int w) {
  return (int)d * WARPS + (w ^ (int)(d & (WARPS - 1)));
}

// The lanes of the warp whose digit equals this lane's: eight ballots, one
// a bit (cheaper than __match_any_sync).
__device__ __forceinline__ unsigned same_digit(uint32_t d) {
  unsigned m = FULL;
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    const bool bit = (d >> b) & 1u;
    const unsigned v = __ballot_sync(FULL, bit);
    m &= bit ? v : ~v;
  }
  return m;
}

// Block-wide exclusive scan of the table in (digit, warp) order, in place,
// 8 entries a thread. `wsum`: WARPS words.
__device__ __forceinline__ void scan(uint32_t* table, uint32_t* wsum) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  uint32_t v[8], s = 0;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int i = t * 8 + c;
    v[c] = table[entry(i / WARPS, i % WARPS)];
    s += v[c];
  }
  uint32_t incl = s;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const uint32_t w0 = wsum[lane];
    uint32_t wi = w0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(FULL, wi, o);
      if (lane >= o) wi += y;
    }
    wsum[lane] = wi - w0;
  }
  __syncthreads();
  uint32_t run = wsum[warp] + incl - s;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int i = t * 8 + c;
    table[entry(i / WARPS, i % WARPS)] = run;
    run += v[c];
  }
  __syncthreads();
}

// One pass over the words `src` by the digit (word >> shift) & 0xFF.
// Returns false, having stored nothing, when every element holds the digit
// of element 0; otherwise calls store(e, slot, word) for every element e,
// slot its place in the stable order, and returns true after a barrier.
// `table`: RADIX * WARPS words.
template <class Store>
__device__ __forceinline__ bool pass(const uint32_t* src, int shift,
                                     uint32_t* table, uint32_t* wsum,
                                     Store store) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int first = warp * STEPS * 32 + lane;
#pragma unroll
  for (int c = 0; c < 8; ++c) table[t * 8 + c] = 0;
  __syncthreads();
  const uint32_t d0 = (src[0] >> shift) & 0xFFu;
  bool same = true;
  unsigned grp[STEPS];   // each element's digit group, kept for the scatter
#pragma unroll
  for (int j = 0; j < STEPS; ++j) {
    const uint32_t d = (src[first + j * 32] >> shift) & 0xFFu;
    same = same && d == d0;
    grp[j] = same_digit(d);
    if (lane == __ffs(grp[j]) - 1)
      atomicAdd(&table[entry(d, warp)], (uint32_t)__popc(grp[j]));
  }
  if (__syncthreads_and(same)) return false;
  scan(table, wsum);
#pragma unroll
  for (int j = 0; j < STEPS; ++j) {
    const int e = first + j * 32;
    const uint32_t k = src[e];
    const uint32_t d = (k >> shift) & 0xFFu;
    const unsigned peers = grp[j];
    const int leader = __ffs(peers) - 1;
    uint32_t slot = 0;
    if (lane == leader)
      slot = atomicAdd(&table[entry(d, warp)], (uint32_t)__popc(peers));
    slot = __shfl_sync(FULL, slot, leader);
    store(e, slot + __popc(peers & below), k);
  }
  __syncthreads();
  return true;
}

// Block-wide minimum and maximum of each thread's (lo[i], hi[i]), i < 3;
// `red`: 6 * WARPS words. Every thread gets the results.
__device__ __forceinline__ void min_max(uint32_t (&lo)[3], uint32_t (&hi)[3],
                                        uint32_t* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    lo[i] = __reduce_min_sync(FULL, lo[i]);
    hi[i] = __reduce_max_sync(FULL, hi[i]);
    if (lane == 0) {
      red[(2 * i) * WARPS + warp] = lo[i];
      red[(2 * i + 1) * WARPS + warp] = hi[i];
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    lo[i] = __reduce_min_sync(FULL, red[(2 * i) * WARPS + lane]);
    hi[i] = __reduce_max_sync(FULL, red[(2 * i + 1) * WARPS + lane]);
  }
  __syncthreads();
}

__device__ __forceinline__ int bit_length(uint32_t x) { return 32 - __clz(x); }

struct Words {
  const uint32_t* w[WORDS];
};

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

__global__ void __launch_bounds__(THREADS, 1)
screen_sort_kernel(const uint32_t* __restrict__ key_in,
                   const uint8_t* __restrict__ taken, Words in,
                   uint32_t* __restrict__ out, int SB, int n, size_t P,
                   bool bulk) {
  extern __shared__ __align__(128) uint32_t smem[];
  uint32_t* const words0 = smem;                          // [2][MAX_N]
  uint16_t* const pos0 = (uint16_t*)(smem + 2 * MAX_N);   // [2][MAX_N]
  uint32_t* const table = smem + 3 * MAX_N;               // [RADIX*WARPS]
  uint32_t* const stage0 = table + RADIX * WARPS;         // [2][MAX_N]
  auto words = [&](int b) { return words0 + b * MAX_N; };
  auto pos = [&](int b) { return pos0 + b * MAX_N; };
  auto stage = [&](int b) { return stage0 + b * MAX_N; };
  __shared__ uint32_t wsum[WARPS];
  __shared__ uint32_t red[6 * WARPS];
  __shared__ __align__(8) uint64_t bars[3];   // keys, stage 0, stage 1
  const int t = threadIdx.x;
  const int G = gridDim.x;
  uint32_t phases = 0;   // bit b: the phase barrier b waits for next

  if (bulk && t == 0) {
    for (int b = 0; b < 3; ++b) bar_init(&bars[b]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // the row's keys into words(b) and taken bytes into pos(b)
  auto fetch_keys = [&](int row, int b) {
    if (bulk && t == 0) {
      bar_arm(&bars[0], (uint32_t)n * 5);
      bulk_load(words(b), key_in + (size_t)row * n, n * 4, &bars[0]);
      bulk_load(pos(b), taken + (size_t)row * n, n, &bars[0]);
    }
  };
  auto fetch_word = [&](int row, int w, int s) {
    if (bulk && t == 0) {
      bar_arm(&bars[1 + s], (uint32_t)n * 4);
      bulk_load(stage(s), in.w[w] + (size_t)row * n, n * 4, &bars[1 + s]);
    }
  };
  // wait for a fetch (with plain loads: make the copy now)
  auto await_word = [&](int row, int w, int s) {
    if (bulk) {
      bar_wait(&bars[1 + s], (phases >> (1 + s)) & 1u);
      phases ^= 2u << s;
    } else {
      const uint32_t* src = in.w[w] + (size_t)row * n;
      for (int e = t; e < n; e += THREADS) stage(s)[e] = src[e];
      __syncthreads();
    }
  };

  int cur = 0;
  if (blockIdx.x < SB) fetch_keys(blockIdx.x, cur);
#pragma unroll 1
  for (int row = blockIdx.x; row < SB; row += G) {
    const size_t base = (size_t)row * n;
    if (bulk) {
      bar_wait(&bars[0], phases & 1u);
      phases ^= 1u;
    }
    // the row's keys, dead ones as INVALID, and the live range of the
    // whole keys and of each half
    uint32_t k[ITEMS];
    uint32_t lo[3] = {INVALID, 0xFFFFu, 0xFFFFu}, hi[3] = {0, 0, 0};
    const uint8_t* tk = (const uint8_t*)pos(cur);
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int e = j * THREADS + t;
      k[j] = INVALID;
      if (e < n) {
        const bool dead = bulk ? tk[e] : taken[base + e];
        if (!dead) k[j] = bulk ? words(cur)[e] : key_in[base + e];
      }
      if (k[j] != INVALID) {
        const uint32_t v[3] = {k[j], k[j] >> 16, k[j] & 0xFFFFu};
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          lo[i] = min(lo[i], v[i]);
          hi[i] = max(hi[i], v[i]);
        }
      }
    }
    min_max(lo, hi, red);   // ends with a barrier
    // the word of a live key: key - lo over b bits, or (h - hl) << db |
    // (d - dl) with its halves narrowed apart where that takes fewer
    const int whole = lo[0] <= hi[0] ? bit_length(hi[0] - lo[0] + 1u) : 0;
    const int db = bit_length(hi[2] - lo[2]);
    const uint32_t top = ((hi[1] - lo[1]) << db) | (hi[2] - lo[2]);
    const int halves = top == INVALID ? 32 : bit_length(top + 1u);
    const bool split = lo[0] <= hi[0] && halves < whole;
    const int bits = split ? halves : whole;
    const uint32_t dead = bits == 32 ? INVALID : (1u << bits) - 1u;
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int e = j * THREADS + t;
      const uint32_t w = split ? ((k[j] >> 16) - lo[1]) << db |
                                     ((k[j] & 0xFFFFu) - lo[2])
                               : k[j] - lo[0];
      words(cur)[e] = k[j] == INVALID ? dead : w;
      pos(cur)[e] = (uint16_t)e;
    }
    fetch_word(row, 0, 0);
    fetch_word(row, 1, 1);
    __syncthreads();

#pragma unroll 1
    for (int shift = 0; shift < bits; shift += 8) {
      const uint16_t* psrc = pos(cur);
      uint32_t* kdst = words(cur ^ 1);
      uint16_t* pdst = pos(cur ^ 1);
      if (pass(words(cur), shift, table, wsum,
               [&](int e, uint32_t slot, uint32_t w) {
                 kdst[slot] = w;
                 pdst[slot] = psrc[e];
               }))
        cur ^= 1;
    }

    // the key and the source position
    const uint32_t* wfin = words(cur);
    const uint16_t* pfin = pos(cur);
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int e = j * THREADS + t;
      if (e < n) {
        const uint32_t w = wfin[e];
        const uint32_t key = split ? ((w >> db) + lo[1]) << 16 |
                                         ((w & ((1u << db) - 1u)) + lo[2])
                                   : w + lo[0];
        out[base + e] = w == dead ? INVALID : key;
        out[6 * P + base + e] = (uint32_t)(base + pfin[e]);
      }
    }
    __syncthreads();   // wfin read: the next row's keys may land there
    if (row + G < SB) fetch_keys(row + G, cur ^ 1);
    // the payload words through the permutation
#pragma unroll 1
    for (int w = 0; w < WORDS; ++w) {
      const int s = w & 1;
      await_word(row, w, s);
      uint32_t* o = out + (size_t)(w + 1) * P + base;
#pragma unroll
      for (int j = 0; j < ITEMS; ++j) {
        const int e = j * THREADS + t;
        if (e < n) o[e] = stage(s)[pfin[e]];
      }
      __syncthreads();
      if (w + 2 < WORDS) fetch_word(row, w + 2, s);
    }
    cur ^= 1;
  }
}

int grid_size(int SB, int* grid) {
  static int per_card = 0;
  if (per_card == 0) {
    int dev = 0, sms = 0, per = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(screen_sort_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)SMEM);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per, screen_sort_kernel, THREADS, SMEM);
    if (e != cudaSuccess) return (int)e;
    per_card = sms * (per > 0 ? per : 1);
  }
  *grid = SB < per_card ? SB : per_card;
  return 0;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

// key, taken ((SB, n) int32 and bool), ix, iy, pc1, pc2, rgb9 ((SB, n)
// int32); out (7, SB, n) int32: key, ix, iy, pc1, pc2, rgb9, source
// position, each row in sorted order. 0 < n <= 8192.
extern "C" int gs_screen_sort(const void* key, const void* taken,
                              const void* ix, const void* iy, const void* pc1,
                              const void* pc2, const void* rgb9, void* out,
                              int SB, int n, void* stream) {
  if (SB < 0 || n <= 0 || n > MAX_N) return (int)cudaErrorInvalidValue;
  if (SB == 0) return 0;
  int grid = 0;
  const int err = grid_size(SB, &grid);
  if (err) return err;
  Words in{{(const uint32_t*)ix, (const uint32_t*)iy, (const uint32_t*)pc1,
            (const uint32_t*)pc2, (const uint32_t*)rgb9}};
  bool bulk = n % 16 == 0 && aligned16(key) && aligned16(taken);
  for (int w = 0; w < WORDS; ++w) bulk = bulk && aligned16(in.w[w]);
  screen_sort_kernel<<<grid, THREADS, SMEM, (cudaStream_t)stream>>>(
      (const uint32_t*)key, (const uint8_t*)taken, in, (uint32_t*)out, SB, n,
      (size_t)SB * n, bulk);
  return (int)cudaGetLastError();
}
