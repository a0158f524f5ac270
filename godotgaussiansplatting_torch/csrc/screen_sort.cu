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
// Design: one CTA of 512 threads a row of n <= 8192 keys, an LSD radix sort
// of (key, position) in four passes of 8-bit digits, stable by
// construction, in shared memory: two (key, position) buffers, each pass
// reading one in element order and scattering into the other. The row is
// padded to 8192 with 0xFFFFFFFF keys, which sort after every real one.
// Warp w owns the elements [w * 512, w * 512 + 512), 32 at a time. A pass:
// each warp counts its digits (eight ballots group the lanes of one digit,
// the group's first lane adds its size: no atomics) into a digit-major,
// warp-minor table (its warp index swizzled against bank conflicts); one
// exclusive scan of that table gives every (digit,
// warp) its first slot; each warp then scatters its elements in order, a
// lane's slot its group's base plus the group's lanes below it (the groups
// found while counting, kept in registers). A pass in
// which every element holds one digit is skipped. The payload words are
// then gathered through the permutation from a copy of the row's word
// staged in the free key buffer, a word at a time, so every device-memory
// load and store is coalesced. Shared memory: two key buffers (64 KB), two
// position buffers (32 KB) and the table (16 KB), 112 KB: two CTAs an SM.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_N = 8192;
constexpr int ITEMS = MAX_N / THREADS;   // elements a lane
constexpr int SEG = MAX_N / WARPS;       // elements a warp
constexpr int RADIX = 256;
constexpr int PASSES = 4;
constexpr int WORDS = 5;                 // payload words gathered
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr uint32_t INVALID = 0xFFFFFFFFu;
constexpr size_t SMEM =
    2 * MAX_N * 4 + RADIX * WARPS * 4 + 2 * MAX_N * 2;   // 112 KB

static_assert(RADIX * WARPS == THREADS * 8, "8 table entries a thread");

struct Words {
  const uint32_t* w[WORDS];
};

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

__global__ void __launch_bounds__(THREADS, 2)
screen_sort_kernel(const uint32_t* __restrict__ key_in,
                   const uint8_t* __restrict__ taken, Words in,
                   uint32_t* __restrict__ out, int n, size_t P) {
  extern __shared__ uint32_t smem[];
  // two (key, position) buffers, a pass reading one and writing the other
  uint32_t* const table = smem + 2 * MAX_N;                // [RADIX * WARPS]
  uint16_t* const pos0 = (uint16_t*)(table + RADIX * WARPS);
  auto keys = [&](int b) { return smem + b * MAX_N; };
  auto pos = [&](int b) { return pos0 + b * MAX_N; };
  __shared__ uint32_t wsum[WARPS];
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const unsigned below = (1u << lane) - 1u;
  const size_t base = (size_t)blockIdx.x * n;

#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int e = j * THREADS + t;
    uint32_t key = INVALID;
    if (e < n && !taken[base + e]) key = key_in[base + e];
    keys(0)[e] = key;
    pos(0)[e] = (uint16_t)e;
  }
  int cur = 0;

#pragma unroll 1
  for (int pass = 0; pass < PASSES; ++pass) {
    const int shift = pass * 8;
    const uint32_t* ksrc = keys(cur);
    const uint16_t* psrc = pos(cur);
#pragma unroll
    for (int c = 0; c < 8; ++c) table[t * 8 + c] = 0;
    __syncthreads();
    // each warp's digit counts, in element order
    const uint32_t d0 = (ksrc[0] >> shift) & 0xFFu;
    bool same = true;
    unsigned grp[ITEMS];   // each element's digit group, kept for the scatter
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const uint32_t d = (ksrc[warp * SEG + j * 32 + lane] >> shift) & 0xFFu;
      same = same && d == d0;
      grp[j] = same_digit(d);
      if (lane == __ffs(grp[j]) - 1)
        table[entry(d, warp)] += __popc(grp[j]);
      __syncwarp();
    }
    // every element one digit: the pass leaves the order as it is
    if (__syncthreads_and(same)) continue;
    // exclusive scan of the (digit, warp) table: 8 entries a thread
    uint32_t v[8], s = 0;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      v[c] = table[entry((t * 8 + c) / WARPS, (t * 8 + c) % WARPS)];
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
      const uint32_t w0 = lane < WARPS ? wsum[lane] : 0;
      uint32_t wi = w0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const uint32_t y = __shfl_up_sync(FULL, wi, o);
        if (lane >= o) wi += y;
      }
      if (lane < WARPS) wsum[lane] = wi - w0;
    }
    __syncthreads();
    uint32_t run = wsum[warp] + incl - s;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      table[entry((t * 8 + c) / WARPS, (t * 8 + c) % WARPS)] = run;
      run += v[c];
    }
    __syncthreads();
    // stable scatter: a warp's elements in order, each digit group's lanes
    // in lane order
    uint32_t* kdst = keys(cur ^ 1);
    uint16_t* pdst = pos(cur ^ 1);
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int e = warp * SEG + j * 32 + lane;
      const uint32_t k = ksrc[e];
      const uint32_t d = (k >> shift) & 0xFFu;
      const unsigned peers = grp[j];
      const uint32_t slot = table[entry(d, warp)];
      const uint32_t dst = slot + __popc(peers & below);
      kdst[dst] = k;
      pdst[dst] = psrc[e];
      __syncwarp();
      if (lane == __ffs(peers) - 1)
        table[entry(d, warp)] = slot + __popc(peers);
      __syncwarp();
    }
    __syncthreads();
    cur ^= 1;
  }

  // the key and the source position
  const uint32_t* kfin = keys(cur);
  const uint16_t* pfin = pos(cur);
#pragma unroll 4
  for (int j = 0; j < ITEMS; ++j) {
    const int e = j * THREADS + t;
    if (e < n) {
      out[base + e] = kfin[e];
      out[6 * P + base + e] = (uint32_t)(base + pfin[e]);
    }
  }
  // the payload words through the permutation, a word at a time, staged in
  // the other key buffer
  uint32_t* stage = keys(cur ^ 1);
#pragma unroll
  for (int w = 0; w < WORDS; ++w) {
    __syncthreads();
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int c = j * THREADS + t;
      if (c < n) stage[c] = in.w[w][base + c];
    }
    __syncthreads();
    uint32_t* o = out + (size_t)(w + 1) * P + base;
#pragma unroll 4
    for (int j = 0; j < ITEMS; ++j) {
      const int e = j * THREADS + t;
      if (e < n) o[e] = stage[pfin[e]];
    }
  }
}

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
  const cudaError_t e = cudaFuncSetAttribute(
      screen_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM);
  if (e != cudaSuccess) return (int)e;
  Words in{{(const uint32_t*)ix, (const uint32_t*)iy, (const uint32_t*)pc1,
            (const uint32_t*)pc2, (const uint32_t*)rgb9}};
  screen_sort_kernel<<<SB, THREADS, SMEM, (cudaStream_t)stream>>>(
      (const uint32_t*)key, (const uint8_t*)taken, in, (uint32_t*)out, n,
      (size_t)SB * n);
  return (int)cudaGetLastError();
}
