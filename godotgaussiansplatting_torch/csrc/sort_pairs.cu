// The exact path's sort: a stable key-value LSD radix sort of the n live
// pairs of the emission's buffer.
//
// Replaces `jax.lax.sort_key_val(keys, vals, is_stable=True)` in
// `emit_and_sort`, godotgaussiansplatting_tpu/ops/sort.py (XLA there, no
// Pallas kernel), and the reference's own 4-pass GPU radix sort
// (radix_sort_{upsweep,spine,downsweep}.glsl), which sizes its dispatch
// by the pair count on the device. The plain version is
// `sort_pairs_reference` in ops/sort.py.
//
// Input: the emission's int32 keys (the u32 key ^ 0x80000000) and int32
// values at [0, n), n = min(*total, k_max) read on the device, so a CUDA
// graph holds the whole sort. Only bits [0, end_bit) of the u32 key are
// sorted. ops/sort.py sets end_bit = min(32, 16 + bit_length(T)) for T
// tiles: a live key `tile << 16 | depth16` has tile < T, so it is at most
// (T << 16) - 1 < 2^end_bit - 1, while a hole's key INVALID_KEY masked to
// end_bit bits is 2^end_bit - 1. Holes therefore still sort after every
// live pair, stably, and the masked sort equals the full 32-bit one.
//
// Output: SortedPairs' keys ((k_max,) int64 holding the u32 key: the last
// pass widens as it stores) and values ((k_max,) int32); [n, k_max) is
// filled with (INVALID_KEY, 0) by the tail kernel. The input buffers
// are the ping-pong partner of one (k_max,) scratch pair, so they are
// overwritten.
//
// What bounds it on Hopper: device-memory bandwidth. The function must read
// the n live keys and values once (8 B a pair) and write the k_max output
// slots once (12 B); the passes move more: the histogram reads the keys
// once (4 B a pair), and each of the ceil(end_bit / BITS) passes reads and
// writes a pair (16 B, 20 B for the last one, whose key is an int64).
//
// Design (onesweep: Adinets and Merrill, 2022):
// - one histogram kernel counts every pass's digits in one read of the
//   keys (1024 threads a CTA, four 16-byte loads in flight a thread), with
//   plain shared-memory atomics (aggregating a warp's equal digits first,
//   by match or by ballots, measured slower on the card, and eight copies
//   of the counts, a lane's its lane % 8, no faster), and zeroes the
//   look-back words of the tiles this sort runs; a tail kernel writes the
//   output's tail in 16-byte stores;
// - then one kernel per pass. A persistent grid takes tiles of TILE keys
//   in order from an atomic counter, so a tile's predecessors have all
//   been taken by running CTAs. Each CTA ranks its tile stably in shared
//   memory: warp w holds the tile's keys [w * 512, (w + 1) * 512), 32
//   consecutive keys a step; `__match_any_sync` finds each key's peers of
//   one digit in the step, and a per-warp counter of each digit gives its
//   rank. It publishes its digit counts (counted first, before the
//   ranking) with a flag (A: this tile's count, P: the inclusive prefix
//   over tiles), looks back over the
//   predecessors' words for its exclusive prefix (decoupled look-back),
//   reorders the tile by digit in shared memory and writes each digit's
//   run to its place, so the stores of a run coalesce. Only the digits a
//   pass has take part in its look-back.
// Measured on the card and left out: reading 2-16 look-back words at once
// (slower), and prefetching the next tile with cp.async (its ticket,
// taken a tile early, delays the look-back of the tiles after it as much
// as the prefetch saves).
// Digits are at most BITS = 8 bits wide, the end_bit bits split evenly over
// ceil(end_bit / 8) passes (8 + 7 + 7 + 7 at end_bit 29): a pass of fewer
// digits has longer runs and less look-back, and measured faster
// (PERF.md). 10-bit digits (3 passes, 1024 digits) measured slower on the
// card: shorter runs a digit and four times the look-back.
// Measured on the card and left out: a two-level sort that groups the
// pairs by tile with two such passes over the tile bits and then sorts
// each tile's segment by depth16 in shared memory; its shared-memory
// passes over segments of some 2,300 pairs cost as much as global passes
// (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BITS = 8;                    // a digit's width
constexpr int D = 1 << BITS;               // digits a pass
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 16;                  // keys a thread holds
constexpr int TILE = THREADS * ITEMS;      // keys a tile
constexpr int MAX_PASSES = 4;
constexpr int HIST_THREADS = 1024;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr unsigned SIGN = 0x80000000u;
constexpr unsigned FLAG_A = 1u << 30;      // the tile's own count
constexpr unsigned FLAG_P = 2u << 30;      // inclusive prefix over tiles
constexpr unsigned VALUE = FLAG_A - 1;

__device__ __forceinline__ long long live_count(const long long* total,
                                                long long k_max) {
  const long long n = *total;
  return n < 0 ? 0 : (n < k_max ? n : k_max);
}

__device__ __forceinline__ unsigned load_relaxed(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_relaxed(unsigned* p, unsigned v) {
  asm volatile("st.relaxed.gpu.u32 [%0], %1;" :: "l"(p), "r"(v) : "memory");
}

// Pass p's digit: bits [shift, shift + width) of the u32 key, the end_bit
// bits split evenly over the passes, the wider digits first.
__host__ __device__ __forceinline__ void digit_bits(int end_bit, int p,
                                                    int* shift, int* width) {
  const int passes = (end_bit + BITS - 1) / BITS;
  const int w = end_bit / passes, wide = end_bit % passes;
  *shift = p * w + (p < wide ? p : wide);
  *width = w + (p < wide ? 1 : 0);
}

// The digit of a pass: bits [shift, shift + width) of the u32 key.
__device__ __forceinline__ unsigned digit_of(unsigned u, int shift,
                                             unsigned mask) {
  return (u >> shift) & mask;
}

// Exclusive prefix over the block of PT values a thread, in thread order;
// `sums` holds WARPS words of shared memory.
template <int PT>
__device__ __forceinline__ void block_exclusive_scan(const unsigned (&v)[PT],
                                                     unsigned (&out)[PT],
                                                     unsigned* sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned s = 0;
#pragma unroll
  for (int k = 0; k < PT; ++k) {
    out[k] = s;
    s += v[k];
  }
  unsigned x = s;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const unsigned w = lane < WARPS ? sums[lane] : 0;
    unsigned z = w;
#pragma unroll
    for (int o = 1; o < WARPS; o <<= 1) {
      const unsigned y = __shfl_up_sync(FULL, z, o);
      if (lane >= o) z += y;
    }
    if (lane < WARPS) sums[lane] = z - w;
  }
  __syncthreads();
  const unsigned prefix = x - s + sums[warp];
#pragma unroll
  for (int k = 0; k < PT; ++k) out[k] += prefix;
  __syncthreads();
}

__global__ void __launch_bounds__(HIST_THREADS)
histogram_kernel(const int* __restrict__ keys,
                 const long long* __restrict__ total, long long k_max,
                 int end_bit, unsigned* __restrict__ hist,
                 unsigned* __restrict__ status, long long tiles_max) {
  __shared__ unsigned h[MAX_PASSES * D];
  const long long n = live_count(total, k_max);
  const int passes = (end_bit + BITS - 1) / BITS;
  for (int i = threadIdx.x; i < passes * D; i += HIST_THREADS) h[i] = 0;
  __syncthreads();
  int shift[MAX_PASSES], width[MAX_PASSES];
#pragma unroll
  for (int p = 0; p < MAX_PASSES; ++p)
    digit_bits(end_bit, p < passes ? p : 0, &shift[p], &width[p]);
  const long long stride = (long long)gridDim.x * HIST_THREADS * 4;
  const bool aligned = ((uintptr_t)keys & 15) == 0;
  // four groups of four consecutive keys a thread, the loads in flight
  // together
  for (long long b = ((long long)blockIdx.x * HIST_THREADS + threadIdx.x) * 4;
       b < n; b += stride * 4) {
    unsigned u[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const long long i0 = b + r * stride;
      if (aligned && i0 + 3 < n) {
        const int4 q = *reinterpret_cast<const int4*>(keys + i0);
        u[r][0] = (unsigned)q.x; u[r][1] = (unsigned)q.y;
        u[r][2] = (unsigned)q.z; u[r][3] = (unsigned)q.w;
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          u[r][q] = i0 + q < n ? (unsigned)keys[i0 + q] : 0u;
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (b + r * stride + q >= n) continue;
        const unsigned key = u[r][q] ^ SIGN;
#pragma unroll
        for (int p = 0; p < MAX_PASSES; ++p)
          if (p < passes)
            atomicAdd(&h[p * D + digit_of(key, shift[p],
                                          (1u << width[p]) - 1)], 1u);
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < passes * D; i += HIST_THREADS)
    if (h[i]) atomicAdd(&hist[i], h[i]);
  // the look-back words of the tiles the passes run
  const long long gid = (long long)blockIdx.x * HIST_THREADS + threadIdx.x;
  const long long words = (n + TILE - 1) / TILE * D;
  for (int p = 0; p < passes; ++p) {
    unsigned* st = status + (long long)p * tiles_max * D;
    for (long long i = gid; i < words;
         i += (long long)gridDim.x * HIST_THREADS)
      st[i] = 0;
  }
}

// The output's tail [n, k_max) as (INVALID_KEY, 0): the slots up to the
// first multiple of 4 one by one, then 16-byte stores, a warp's 32 stores
// on 512 consecutive bytes (keys two a store, values four).
__global__ void __launch_bounds__(THREADS)
tail_kernel(const long long* __restrict__ total, long long k_max,
            long long* __restrict__ out_keys, int* __restrict__ out_vals) {
  const long long n = live_count(total, k_max);
  const long long up = (n + 3) & ~3LL;
  const long long a = up < k_max ? up : k_max;
  const long long gid = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long stride = (long long)gridDim.x * THREADS;
  if (gid < a - n) {
    out_keys[n + gid] = 0xFFFFFFFFLL;
    out_vals[n + gid] = 0;
  }
  const long long body = (k_max - a) & ~3LL;     // slots in whole fours
  const long long end = a + body;
  if ((((uintptr_t)out_keys | (uintptr_t)out_vals) & 15) == 0) {
    longlong2* k2 = reinterpret_cast<longlong2*>(out_keys + a);
    int4* v4 = reinterpret_cast<int4*>(out_vals + a);
    const longlong2 inv = make_longlong2(0xFFFFFFFFLL, 0xFFFFFFFFLL);
    for (long long i = gid; i < body / 2; i += stride) k2[i] = inv;
    for (long long i = gid; i < body / 4; i += stride)
      v4[i] = make_int4(0, 0, 0, 0);
  } else {
    for (long long i = a + gid; i < end; i += stride) {
      out_keys[i] = 0xFFFFFFFFLL;
      out_vals[i] = 0;
    }
  }
  if (gid < k_max - end) {
    out_keys[end + gid] = 0xFFFFFFFFLL;
    out_vals[end + gid] = 0;
  }
}

template <bool LAST>
__global__ void __launch_bounds__(THREADS, 3)
pass_kernel(const int* __restrict__ src_k, const int* __restrict__ src_v,
            int* __restrict__ dst_k, int* __restrict__ dst_v,
            long long* __restrict__ out_k, const unsigned* __restrict__ hist,
            unsigned* status, unsigned* counter,
            const long long* __restrict__ total, long long k_max, int shift,
            int width) {
  constexpr int PT = D / THREADS;          // digits a thread looks after
  static_assert(D % THREADS == 0, "digits must be a multiple of threads");
  __shared__ unsigned wc[WARPS * D];       // [WARPS][D] per-warp counts
  __shared__ unsigned base[D];             // the pass's digit starts
  __shared__ unsigned tstart[D];           // the tile's digit starts
  __shared__ int goff[D];                  // output position - tstart
  __shared__ unsigned sk[TILE];            // the tile's keys by digit
  __shared__ int sv[TILE];                 // their values
  __shared__ unsigned sums[WARPS];
  __shared__ unsigned s_tile;

  const long long n = live_count(total, k_max);
  const long long tiles = (n + TILE - 1) / TILE;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned mask = (1u << width) - 1;
  const unsigned lt = (1u << lane) - 1;

  {  // the pass's digit starts: the exclusive prefix of its histogram
    unsigned v[PT], out[PT];
#pragma unroll
    for (int k = 0; k < PT; ++k) v[k] = hist[threadIdx.x * PT + k];
    block_exclusive_scan<PT>(v, out, sums);
#pragma unroll
    for (int k = 0; k < PT; ++k) base[threadIdx.x * PT + k] = out[k];
  }
  unsigned* mine = wc + warp * D;
  for (;;) {
    if (threadIdx.x == 0) s_tile = atomicAdd(counter, 1u);
    for (int i = threadIdx.x; i < WARPS * D; i += THREADS) wc[i] = 0;
    for (int i = threadIdx.x; i < D; i += THREADS) goff[i] = 0;
    __syncthreads();
    const long long tile = s_tile;
    if (tile >= tiles) break;
    const long long t0 = tile * TILE;
    const int tn = (int)min((long long)TILE, n - t0);
    const int first = warp * (ITEMS * 32) + lane;
    unsigned key[ITEMS], rank[ITEMS];
    int val[ITEMS];
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int idx = first + j * 32;
      key[j] = 0;
      val[j] = 0;
      if (idx < tn) {
        key[j] = (unsigned)src_k[t0 + idx];
        val[j] = src_v[t0 + idx];
      }
    }
    // the tile's digit counts, published before the ranking so that the
    // tiles after this one find them early (goff holds them until the
    // look-back)
#pragma unroll
    for (int j = 0; j < ITEMS; ++j)
      if (first + j * 32 < tn)
        atomicAdd(&goff[digit_of(key[j] ^ SIGN, shift, mask)], 1);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < PT; ++k) {
      const int d = threadIdx.x * PT + k;
      if (d <= (int)mask)
        store_relaxed(&status[tile * D + d],
                      (tile == 0 ? FLAG_P : FLAG_A) | (unsigned)goff[d]);
    }
    // stable ranks within the warp's keys, step by step
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const bool ok = first + j * 32 < tn;
      const unsigned d = ok ? digit_of(key[j] ^ SIGN, shift, mask)
                            : (unsigned)D;
      const unsigned peers = __match_any_sync(FULL, d);
      const unsigned before = ok ? mine[d] : 0u;
      __syncwarp();
      if (ok && lane == __ffs(peers) - 1) mine[d] = before + __popc(peers);
      __syncwarp();
      rank[j] = before + __popc(peers & lt);
    }
    __syncthreads();
    // each digit: the warps' exclusive prefixes and the tile's count
    unsigned cnt[PT], start[PT];
#pragma unroll
    for (int k = 0; k < PT; ++k) {
      const int d = threadIdx.x * PT + k;
      unsigned s = 0;
      for (int w = 0; w < WARPS; ++w) {
        const unsigned c = wc[w * D + d];
        wc[w * D + d] = s;
        s += c;
      }
      cnt[k] = s;
    }
    block_exclusive_scan<PT>(cnt, start, sums);
    // decoupled look-back: the digit's count in the tiles before this one
    // (a digit past the pass's width holds no key: no look-back)
#pragma unroll
    for (int k = 0; k < PT; ++k) {
      const int d = threadIdx.x * PT + k;
      unsigned excl = 0;
      if (tile > 0 && d <= (int)mask) {
        for (long long j = tile - 1;; --j) {
          unsigned w;
          do {
            w = load_relaxed(&status[j * D + d]);
          } while ((w & (FLAG_A | FLAG_P)) == 0);
          excl += w & VALUE;
          if (w & FLAG_P) break;
        }
        store_relaxed(&status[tile * D + d], FLAG_P | (excl + cnt[k]));
      }
      tstart[d] = start[k];
      goff[d] = (int)(base[d] + excl) - (int)start[k];
    }
    __syncthreads();
    // the tile in digit order in shared memory
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      if (first + j * 32 < tn) {
        const unsigned d = digit_of(key[j] ^ SIGN, shift, mask);
        const unsigned lp = tstart[d] + mine[d] + rank[j];
        sk[lp] = key[j];
        sv[lp] = val[j];
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < tn; i += THREADS) {
      const unsigned k = sk[i];
      const unsigned d = digit_of(k ^ SIGN, shift, mask);
      const long long pos = (long long)goff[d] + i;
      if (LAST) {
        out_k[pos] = (long long)(k ^ SIGN);
      } else {
        dst_k[pos] = (int)k;
      }
      dst_v[pos] = sv[i];
    }
    __syncthreads();       // before the next tile clears the counts
  }
}

struct Grids {
  int hist = 0, tail = 0, pass = 0, pass_last = 0;
};

// The persistent grids: every CTA that fits on the card at once.
int grids(Grids* g) {
  static Grids cached;
  static bool ready = false;
  if (!ready) {
    int dev = 0, sms = 0, per = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per, pass_kernel<false>, THREADS, 0);
    if (e == cudaSuccess) cached.pass = sms * (per > 0 ? per : 1);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per, pass_kernel<true>, THREADS, 0);
    if (e == cudaSuccess) cached.pass_last = sms * (per > 0 ? per : 1);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per, histogram_kernel, HIST_THREADS, 0);
    if (e == cudaSuccess) cached.hist = sms * (per > 0 ? per : 1);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, tail_kernel,
                                                        THREADS, 0);
    if (e != cudaSuccess) return (int)e;
    cached.tail = sms * (per > 0 ? per : 1);
    ready = true;
  }
  *g = cached;
  return 0;
}

int passes_of(int end_bit) { return (end_bit + BITS - 1) / BITS; }

}  // namespace

// Radix passes of a sort of the keys' low end_bit bits.
extern "C" int gs_sort_pairs_passes(int end_bit) { return passes_of(end_bit); }

// u32 words of the scratch gs_sort_pairs takes: each pass's D digit counts,
// its tile counter and the look-back words of its tiles (below 2^31 for
// k_max < 2^30).
extern "C" int gs_sort_pairs_scratch_words(long long k_max, int end_bit) {
  const long long tiles = (k_max + TILE - 1) / TILE;
  return (int)(passes_of(end_bit) * (D + 1 + tiles * D));
}

// Sort the live pairs of keys / vals (int32, >= k_max slots, overwritten)
// into out_keys ((k_max,) int64) and out_vals ((k_max,) int32). tmp_keys /
// tmp_vals: (k_max,) int32; scratch: gs_sort_pairs_scratch_words u32
// words; total: () int64 on the device. 1 <= end_bit <= 32; k_max < 2^30.
extern "C" int gs_sort_pairs(void* keys_, void* vals_, void* tmp_keys,
                             void* tmp_vals, void* scratch, const void* total_,
                             void* out_keys, void* out_vals, long long k_max,
                             int end_bit, void* stream_) {
  if (k_max <= 0) return 0;
  if (end_bit < 1 || end_bit > 32 || k_max >= (1LL << 30))
    return (int)cudaErrorInvalidValue;
  int* keys = (int*)keys_;
  int* vals = (int*)vals_;
  const long long* total = (const long long*)total_;
  long long* out_k = (long long*)out_keys;
  int* out_v = (int*)out_vals;
  const cudaStream_t stream = (cudaStream_t)stream_;
  Grids g;
  int err = grids(&g);
  if (err) return err;
  const int passes = passes_of(end_bit);
  const long long tiles_max = (k_max + TILE - 1) / TILE;
  unsigned* hist = (unsigned*)scratch;               // [passes][D]
  unsigned* counters = hist + (long long)passes * D; // [passes]
  unsigned* status = counters + passes;              // [passes][tiles][D]
  err = (int)cudaMemsetAsync(hist, 0, ((size_t)passes * D + passes) * 4,
                             stream);
  if (err) return err;
  const long long hist_grid = (k_max + 16 * HIST_THREADS - 1) /
                              (16 * HIST_THREADS);
  histogram_kernel<<<(int)(hist_grid < g.hist ? hist_grid : g.hist),
                     HIST_THREADS, 0, stream>>>(keys, total, k_max, end_bit,
                                                hist, status, tiles_max);
  err = (int)cudaGetLastError();
  if (err) return err;
  const long long tail_grid = (k_max + 2 * THREADS - 1) / (2 * THREADS);
  tail_kernel<<<(int)(tail_grid < g.tail ? tail_grid : g.tail), THREADS, 0,
                stream>>>(total, k_max, out_k, out_v);
  err = (int)cudaGetLastError();
  if (err) return err;
  const int* sk = keys;
  const int* sv = vals;
  for (int p = 0; p < passes; ++p) {
    int shift, width;
    digit_bits(end_bit, p, &shift, &width);
    unsigned* st = status + (long long)p * tiles_max * D;
    if (p == passes - 1) {
      const long long grid = tiles_max < g.pass_last ? tiles_max : g.pass_last;
      pass_kernel<true><<<(int)grid, THREADS, 0, stream>>>(
          sk, sv, nullptr, out_v, out_k, hist + p * D, st, counters + p,
          total, k_max, shift, width);
    } else {
      int* dk = p % 2 == 0 ? (int*)tmp_keys : keys;
      int* dv = p % 2 == 0 ? (int*)tmp_vals : vals;
      const long long grid = tiles_max < g.pass ? tiles_max : g.pass;
      pass_kernel<false><<<(int)grid, THREADS, 0, stream>>>(
          sk, sv, dk, dv, nullptr, hist + p * D, st, counters + p, total,
          k_max, shift, width);
      sk = dk;
      sv = dv;
    }
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  return 0;
}
