// The big-lane window: each chunk row's KC smallest big-candidate keys.
//
// Replaces XLA's row sort and window in `_select_big_lanes`,
// godotgaussiansplatting_tpu/ops/blocks2.py (plain XLA there, no Pallas
// kernel): `lax.sort` of the (R, CW) u32 chunk keys along the row, the
// first KC of each row, their flat source positions and their global sort
// keys. Semantics follow `big_window_reference` in ops/blocks2.py. The
// global stable sort of the R * KC window stays a torch sort of the int32
// keys this kernel writes.
//
// A chunk key is (depth16 << 10) | column for a big candidate and
// 0xFFFFFFFF otherwise, so the live keys of a row are unique (the column)
// and every dead key is the same value: the sorted row, and so the window,
// does not depend on how the sort breaks ties.
//
// What bounds it on Hopper: device-memory bandwidth, the (R, CW) keys read
// once (4 B a key) and the (R, KC) window's two int32 outputs written once.
//
// Design: one CTA a row. Big candidates are sparse (about two a
// 1024-splat row at 1080p on the 5.8M-splat scene), so the CTA first
// compacts the row's live keys into shared memory (a slot a key from a
// shared counter; the order does not matter, the keys are unique). With at
// most THREADS live keys, each thread takes one and counts the live keys
// below it (ties, which valid input does not hold, broken by slot): that
// count is its place in the window. With more, a bitonic network sorts the
// live keys in shared memory. The window's entries past the live keys are
// dead: `pos_w` 0 and `gk` 0x3FFFFF. Outputs: `pos_w` (the flat position
// row * CW + column) and `gk` (key >> 10, the 22-bit global key).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_CW = 1024;
constexpr int THREADS = 256;
constexpr uint32_t DEAD = 0xFFFFFFFFu;

__global__ void __launch_bounds__(THREADS)
big_window_kernel(const uint32_t* __restrict__ bkey, int* __restrict__ pos_w,
                  int* __restrict__ gk, int CW, int KC) {
  __shared__ uint32_t live[MAX_CW];
  __shared__ int n_live;
  const int row = blockIdx.x;
  const int t = threadIdx.x;
  const uint32_t* in = bkey + (size_t)row * CW;
  int* pos = pos_w + (size_t)row * KC;
  int* key = gk + (size_t)row * KC;
  if (t == 0) n_live = 0;
  __syncthreads();
  for (int j = t; j < CW; j += THREADS) {
    const uint32_t k = in[j];
    if (k != DEAD) live[atomicAdd(&n_live, 1)] = k;
  }
  __syncthreads();
  const int n = n_live;
  const int row0 = row * CW;
  if (n <= THREADS) {
    if (t < n) {
      const uint32_t k = live[t];
      int rank = 0;
      for (int u = 0; u < n; ++u) {
        const uint32_t o = live[u];
        rank += (o < k) || (o == k && u < t);
      }
      if (rank < KC) {
        pos[rank] = row0 + (int)(k & 0x3FFu);
        key[rank] = (int)(k >> 10);
      }
    }
  } else {
    int N = 1;
    while (N < n) N <<= 1;
    for (int j = n + t; j < N; j += THREADS) live[j] = DEAD;
    __syncthreads();
    for (int size = 2; size <= N; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        for (int c = t; c < N / 2; c += THREADS) {
          const int lo = 2 * c - (c & (stride - 1));
          const int hi = lo + stride;
          const uint32_t a = live[lo], b = live[hi];
          if ((a > b) == ((lo & size) == 0)) {
            live[lo] = b;
            live[hi] = a;
          }
        }
        __syncthreads();
      }
    }
    for (int j = t; j < min(n, KC); j += THREADS) {
      const uint32_t k = live[j];
      pos[j] = row0 + (int)(k & 0x3FFu);
      key[j] = (int)(k >> 10);
    }
  }
  for (int j = n + t; j < KC; j += THREADS) {
    pos[j] = 0;
    key[j] = (int)(DEAD >> 10);
  }
}

}  // namespace

// bkey: (R, CW) int32 chunk keys (u32 bit patterns), CW <= 1024; pos_w, gk:
// (R, KC) int32 outputs, KC <= CW.
extern "C" int gs_big_window(const void* bkey, void* pos_w, void* gk, int R,
                             int CW, int KC, void* stream) {
  if (R <= 0 || KC <= 0) return 0;
  if (CW > MAX_CW || KC > CW) return (int)cudaErrorInvalidValue;
  big_window_kernel<<<R, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)bkey, (int*)pos_w, (int*)gk, CW, KC);
  return (int)cudaGetLastError();
}
