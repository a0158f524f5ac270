// Exact per-tile compositing: the exact path's stage 4.
//
// The JAX package computes this function in plain XLA, with no Pallas
// kernel: `render_tiles` in godotgaussiansplatting_tpu/ops/render.py, one
// lax.map over batches of 16 tiles, each a while loop over 512-slot chunks
// that gathers (16, 512, 256) alphas per chunk. This kernel is the card's
// counterpart, and what the reference renderer itself ran
// (gsplat_render.glsl): one thread block a tile, the tile's sorted splats
// loaded a chunk at a time into shared memory and composited front to back
// per pixel. Semantics follow `render_tiles_reference` in
// ops/render_exact.py, which the tests hold to the JAX function.
//
// Per tile: the list is [start, start + min(end - start, cap_eff)), with
// cap_eff = ceil(C / CH) * CH and CH = min(512, C) (C the tile capacity),
// walked in chunks of CH slots, each loaded in pieces of up to 256 slots:
// the splat ids and their 9 floats (image position, conic, colour and
// opacity) into shared memory, then a barrier. Each pixel composites the
// piece in registers: alpha = a * exp(power), the power of render.py:57-58
// and no clamps (the reference's quirk). With q the transmittance at the
// chunk's start and c the running product of (1 - alpha) inside it, a slot
// is processed while q * c > 1/255 and adds rgb * alpha * q * c; q takes
// the product at the chunk's last processed slot when the chunk ends. That
// is the plain version's chunked prefix product in the same order of
// operations (built with --fmad=false), so the per-pixel decision to
// process a slot matches it. The transmittance never increases (the conic
// is positive definite and the opacity below 1), so the processed slots are
// a prefix, and once no pixel of the tile is above 1/255 the block leaves
// (__syncthreads_or, gsplat_render.glsl:45-48): that changes which chunks
// are loaded, never a pixel. After the walk the heatmap term (the
// untruncated count) is added and the (H, W, 4) image is written directly,
// alpha 1, pixels past the target skipped; pixel (0, 0)'s final
// transmittance goes to tile_t0 and end - start to tile_counts.
//
// Threads. 256 a block, as gsplat_render.glsl; each owns PPT =
// ceil(tile_size^2 / 256) pixels (tile 16: 1, tile 32: 4), so one
// shared-memory read of a splat feeds PPT pixels.
//
// What bounds it. 24 operations, the exp among them, per (pixel, processed
// slot), and per slot a tile loads 40 bytes (the id and 36 bytes of splat
// data, gathered); chip_smoke's `exact_bound` counts both from a frame's
// data. This is the simple, correct kernel; its time and bound are in
// PERF.md section 6.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int PIECE = 256;  // slots loaded into shared memory at once
constexpr float MIN_T = 1.0f / 255.0f;

template <int PPT>
__global__ void __launch_bounds__(THREADS)
render_exact_kernel(const int* __restrict__ values,
                    const int* __restrict__ start, const int* __restrict__ end,
                    const float* __restrict__ image_pos,
                    const float* __restrict__ conic,
                    const float* __restrict__ color,
                    const float* __restrict__ heatmap,
                    float* __restrict__ image, float* __restrict__ tile_t0,
                    int* __restrict__ tile_counts, int gx, int ts, int width,
                    int height, int chunk, int cap_eff, int ox, int oy) {
  __shared__ float s_x[PIECE], s_y[PIECE], s_c0[PIECE], s_c1[PIECE],
      s_c2[PIECE], s_r[PIECE], s_g[PIECE], s_b[PIECE], s_a[PIECE];
  const int tile = blockIdx.x;
  const int tx = tile % gx, ty = tile / gx;
  const int s = start[tile];
  const int n = end[tile] - s;
  const int n_eff = min(max(n, 0), cap_eff);
  const int npx = ts * ts;

  float px[PPT], py[PPT], q[PPT], c[PPT], cp[PPT], acc[PPT][3];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int p = threadIdx.x + k * THREADS;
    px[k] = (float)(tx * ts + ox) + (float)(p % ts);
    py[k] = (float)(ty * ts + oy) + (float)(p / ts);
    // pixels past the tile take no part in the exit vote
    q[k] = p < npx ? 1.0f : 0.0f;
    c[k] = 1.0f;
    cp[k] = 1.0f;
    acc[k][0] = acc[k][1] = acc[k][2] = 0.0f;
  }

  for (int base = 0; base < n_eff; base += chunk) {
    const int chunk_end = min(base + chunk, n_eff);
    bool live = true;
    for (int piece = base; piece < chunk_end && live; piece += PIECE) {
      const int cnt = min(PIECE, chunk_end - piece);
      if ((int)threadIdx.x < cnt) {
        const int id = values[s + piece + threadIdx.x];
        s_x[threadIdx.x] = image_pos[2 * id];
        s_y[threadIdx.x] = image_pos[2 * id + 1];
        s_c0[threadIdx.x] = conic[3 * id];
        s_c1[threadIdx.x] = conic[3 * id + 1];
        s_c2[threadIdx.x] = conic[3 * id + 2];
        s_r[threadIdx.x] = color[4 * id];
        s_g[threadIdx.x] = color[4 * id + 1];
        s_b[threadIdx.x] = color[4 * id + 2];
        s_a[threadIdx.x] = color[4 * id + 3];
      }
      __syncthreads();
      for (int j = 0; j < cnt; ++j) {
        const float x = s_x[j], y = s_y[j];
        const float c0 = s_c0[j], c1 = s_c1[j], c2 = s_c2[j];
        const float r = s_r[j], g = s_g[j], b = s_b[j], a = s_a[j];
#pragma unroll
        for (int k = 0; k < PPT; ++k) {
          const float dx = x - px[k];
          const float dy = y - py[k];
          const float power = -0.5f * (c0 * dx * dx + c2 * dy * dy)
                              - c1 * dx * dy;
          const float alpha = a * expf(power);
          const float t = q[k] * c[k];
          c[k] = c[k] * (1.0f - alpha);
          if (t > MIN_T) {
            const float w = alpha * t;
            acc[k][0] += w * r;
            acc[k][1] += w * g;
            acc[k][2] += w * b;
            cp[k] = c[k];
          }
        }
      }
      int any = 0;
#pragma unroll
      for (int k = 0; k < PPT; ++k) any |= q[k] * c[k] > MIN_T;
      // also the barrier before the next piece overwrites shared memory
      live = __syncthreads_or(any) != 0;
    }
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      q[k] = q[k] * cp[k];
      c[k] = 1.0f;
      cp[k] = 1.0f;
    }
    if (!live) break;
  }

  const float hf = heatmap[0];
  const float mixf = (float)n * 5e-4f;
  const float hm[3] = {0.0f + (1.0f - 0.0f) * mixf, 0.0f + (0.2f - 0.0f) * mixf,
                       1.0f + (0.2f - 1.0f) * mixf};
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int p = threadIdx.x + k * THREADS;
    if (p >= npx) continue;
    if (p == 0) tile_t0[tile] = q[k];
    const int x = tx * ts + p % ts, y = ty * ts + p / ts;
    if (x >= width || y >= height) continue;
    const float cover = (1.0f - q[k]) * hf;
    float4 o;
    o.x = acc[k][0] + hm[0] * cover;
    o.y = acc[k][1] + hm[1] * cover;
    o.z = acc[k][2] + hm[2] * cover;
    o.w = 1.0f;
    reinterpret_cast<float4*>(image)[(size_t)y * width + x] = o;
  }
  if (threadIdx.x == 0) tile_counts[tile] = n;
}

template <int PPT>
cudaError_t launch(const void* values, const void* start, const void* end,
                   const void* image_pos, const void* conic,
                   const void* color, const void* heatmap, void* image,
                   void* tile_t0, void* tile_counts, int T, int gx, int ts,
                   int width, int height, int chunk, int cap_eff, int ox,
                   int oy, cudaStream_t stream) {
  render_exact_kernel<PPT><<<T, THREADS, 0, stream>>>(
      (const int*)values, (const int*)start, (const int*)end,
      (const float*)image_pos, (const float*)conic, (const float*)color,
      (const float*)heatmap, (float*)image, (float*)tile_t0,
      (int*)tile_counts, gx, ts, width, height, chunk, cap_eff, ox, oy);
  return cudaGetLastError();
}

}  // namespace

// values (K,) i32 sorted splat ids; start, end (gx*gy,) i32; image_pos
// (P, 2), conic (P, 3), color (P, 4) f32; heatmap (1,) f32 -> image
// (height, width, 4) f32, tile_t0 (gx*gy,) f32, tile_counts (gx*gy,) i32.
// chunk = min(512, C) and cap_eff = ceil(C / chunk) * chunk for the tile
// capacity C; (ox, oy) shifts the pixel coordinates (not the output).
extern "C" int gs_render_exact(const void* values, const void* start,
                               const void* end, const void* image_pos,
                               const void* conic, const void* color,
                               const void* heatmap, void* image,
                               void* tile_t0, void* tile_counts, int gx,
                               int gy, int tile_size, int width, int height,
                               int chunk, int cap_eff, int ox, int oy,
                               void* stream) {
  const int T = gx * gy;
  const int npx = tile_size * tile_size;
  if (T <= 0) return (int)cudaSuccess;
  if (chunk <= 0 || npx <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (npx <= THREADS)
    return (int)launch<1>(values, start, end, image_pos, conic, color,
                          heatmap, image, tile_t0, tile_counts, T, gx,
                          tile_size, width, height, chunk, cap_eff, ox, oy,
                          st);
  if (npx <= 2 * THREADS)
    return (int)launch<2>(values, start, end, image_pos, conic, color,
                          heatmap, image, tile_t0, tile_counts, T, gx,
                          tile_size, width, height, chunk, cap_eff, ox, oy,
                          st);
  if (npx <= 4 * THREADS)
    return (int)launch<4>(values, start, end, image_pos, conic, color,
                          heatmap, image, tile_t0, tile_counts, T, gx,
                          tile_size, width, height, chunk, cap_eff, ox, oy,
                          st);
  return (int)cudaErrorInvalidValue;
}
