// The exact path's pair emission into the static sort buffer.
//
// Replaces XLA's emission in `emit_and_sort`,
// godotgaussiansplatting_tpu/ops/sort.py (plain XLA there, no Pallas
// kernel): the (P, max_tiles_per_splat) base slot matrix and each dense
// (capacity, width) matrix of the tier ladder and the giant path. Positions
// and keys follow `emit_base_reference` and `emit_dense_reference` in
// ops/sort.py. The caller fills the k_max buffers with the invalid key
// (flipped) and 0 first; each live pair is written at its emission
// position, and positions >= k_max are dropped, so a stable sort of the
// buffer equals the JAX package's stable sort of its whole slot matrices.
//
// Keys are written as int32 `(tile << 16 | depth16) ^ 0x80000000`: the u32
// order as a signed order, so that torch sorts them with 32-bit radix
// passes.
//
// What bounds it on Hopper: device-memory bandwidth, the k_max slots' key
// and value writes (8 B a slot) and about 33 B of reads per splat; there is
// no arithmetic to speak of.
//
// Design: the base group runs one warp per 32 splats. Each lane loads one
// splat's count, offset, rect and depth; the warp then takes the 32 splats
// in turn, broadcast by shuffles, and lane t writes slot t (t, t + 32, ...)
// of its row-major rect prefix, so each splat's pairs are one coalesced
// store. A dense group runs a thread per (compacted splat, slot): a block
// row per splat (grid-stride in y), whose blocks past the splat's tile
// count exit at once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xFFFFFFFFu;

__device__ __forceinline__ int flipped_key(int tile, int depth16) {
  return (int)((((uint32_t)tile << 16) | (uint32_t)depth16) ^ 0x80000000u);
}

__global__ void __launch_bounds__(256)
emit_base_kernel(const uint8_t* __restrict__ valid,
                 const int* __restrict__ rect, const int* __restrict__ nt,
                 const long long* __restrict__ offsets,
                 const int* __restrict__ depth16, int* __restrict__ keys,
                 int* __restrict__ vals, int P, int gx, long long k_max) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  int n = 0, w = 1, base = 0, d = 0;
  long long off = 0;
  if (i < P && valid[i]) {
    off = offsets[i];
    const long long room = k_max - off;
    const long long m = (long long)nt[i] < room ? (long long)nt[i] : room;
    n = m > 0 ? (int)m : 0;
    const int x0 = rect[4 * i + 0], y0 = rect[4 * i + 1];
    w = max(rect[4 * i + 2] - x0, 1);
    base = y0 * gx + x0;
    d = depth16[i];
  }
  const int first = i - lane;
  for (int j = 0; j < 32; ++j) {
    const int nj = __shfl_sync(FULL, n, j);
    const int wj = __shfl_sync(FULL, w, j);
    const int bj = __shfl_sync(FULL, base, j);
    const int dj = __shfl_sync(FULL, d, j);
    const long long oj = __shfl_sync(FULL, off, j);
    for (int t = lane; t < nj; t += 32) {
      const int ty = t / wj;
      const int tx = t - ty * wj;
      keys[oj + t] = flipped_key(bj + ty * gx + tx, dj);
      vals[oj + t] = first + j;
    }
  }
}

__global__ void emit_dense_kernel(const int* __restrict__ idx,
                                  const int* __restrict__ nt_c,
                                  const long long* __restrict__ off_c,
                                  const long long* __restrict__ pos0,
                                  const int* __restrict__ rect,
                                  const int* __restrict__ depth16,
                                  int* __restrict__ keys,
                                  int* __restrict__ vals, int C, int width,
                                  int gx, long long k_max) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= width) return;
  const long long p0 = pos0[0];
  for (int c = blockIdx.y; c < C; c += gridDim.y) {
    if (t >= nt_c[c]) continue;
    const long long pos = p0 + off_c[c] + t;
    if (pos >= k_max) continue;
    const int s = idx[c];
    const int x0 = rect[4 * s + 0], y0 = rect[4 * s + 1];
    const int w = max(rect[4 * s + 2] - x0, 1);
    const int ty = t / w;
    const int tx = t - ty * w;
    keys[pos] = flipped_key(y0 * gx + x0 + ty * gx + tx, depth16[s]);
    vals[pos] = s;
  }
}

}  // namespace

// The base group: splat i's live slots t < min(nt[i], k_max - offsets[i])
// (valid splats only) at offsets[i] + t.
extern "C" int gs_emit_base(const void* valid, const void* rect,
                            const void* nt, const void* offsets,
                            const void* depth16, void* keys, void* vals,
                            int P, int gx, long long k_max, void* stream) {
  if (P <= 0) return 0;
  const int threads = 256;
  emit_base_kernel<<<(P + threads - 1) / threads, threads, 0,
                     (cudaStream_t)stream>>>(
      (const uint8_t*)valid, (const int*)rect, (const int*)nt,
      (const long long*)offsets, (const int*)depth16, (int*)keys, (int*)vals,
      P, gx, k_max);
  return (int)cudaGetLastError();
}

// One dense group of C compacted splats: slot t < min(nt_c[c], width) of
// splat idx[c] at *pos0 + off_c[c] + t.
extern "C" int gs_emit_dense(const void* idx, const void* nt_c,
                             const void* off_c, const void* pos0,
                             const void* rect, const void* depth16,
                             void* keys, void* vals, int C, int width, int gx,
                             long long k_max, void* stream) {
  if (C <= 0 || width <= 0) return 0;
  const int threads = width < 256 ? ((width + 31) / 32) * 32 : 256;
  dim3 grid((width + threads - 1) / threads, C < 65535 ? C : 65535);
  emit_dense_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const int*)idx, (const int*)nt_c, (const long long*)off_c,
      (const long long*)pos0, (const int*)rect, (const int*)depth16,
      (int*)keys, (int*)vals, C, width, gx, k_max);
  return (int)cudaGetLastError();
}
