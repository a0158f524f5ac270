// Exact per-tile compositing: the exact path's stage 4.
//
// The JAX package computes this function in plain XLA, with no Pallas
// kernel: `render_tiles` in godotgaussiansplatting_tpu/ops/render.py, one
// lax.map over batches of 16 tiles, each a while loop over 512-slot chunks
// that gathers (16, 512, 256) alphas per chunk. This kernel is the card's
// counterpart, and what the reference renderer itself ran
// (gsplat_render.glsl): one thread block a tile, the tile's sorted splats
// walked front to back per pixel. Semantics follow `render_tiles_reference`
// in ops/render_exact.py, which the tests hold to the JAX function.
//
// The function. Per tile the list is [start, start + min(end - start,
// cap_eff)), with cap_eff = ceil(C / CH) * CH and CH = min(512, C) (C the
// tile capacity), composited in chunks of CH slots: alpha = a * exp(power),
// the power of render.py:57-58 and no clamps (the reference's quirk). With
// q the transmittance at the chunk's start and c the running product of
// (1 - alpha) inside it, a slot is processed while q * c > 1/255 and adds
// rgb * alpha * q * c; at the chunk's end q takes the product at its last
// processed slot. That is the plain version's chunked prefix product in
// the same order of operations (built with --fmad=false, precise expf), so
// every per-pixel decision to process a slot, and tile_t0, match it bit
// for bit. After the walk the heatmap term (the untruncated count) is added
// and the (H, W, 4) image is written directly, alpha 1, pixels past the
// target skipped; pixel (0, 0)'s final transmittance goes to tile_t0 and
// end - start to tile_counts.
//
// What bounds it. 24 operations, the exp among them, per (pixel, processed
// slot), and per slot a tile loads 40 bytes (the id and 36 bytes of splat
// data, gathered); chip_smoke's `exact_bound` counts both from a frame's
// data. At 1080p the bound is set by the operations, but a tile's pixels
// saturate after about 80 of its 2,300 slots on average, at different
// slots, so the kernel is bound by the issue of the evaluations it makes
// beyond the processed ones, and by how many instructions each one takes.
// The design cuts both, and keeps the evaluation's arithmetic:
//
// - A fine exit vote. The list is walked in pieces of PIECE = 32 slots that
//   never straddle a chunk end. At each piece boundary the block votes
//   (__syncthreads_or, gsplat_render.glsl:45-48) and leaves once no pixel
//   has q * c > 1/255. The transmittance never increases (the conic is
//   positive definite and the opacity below 1), so the processed slots are
//   a prefix and a saturated pixel stays so: the vote changes which pieces
//   are loaded, never a pixel.
// - Warps that stop. A warp whose 32 * PPT pixels are all saturated skips a
//   piece's evaluations (__any_sync) and only takes part in the loads and
//   the vote. By the same monotony this is bit-neutral: a saturated pixel's
//   cp and colour no longer change, and its q * c only falls. So a warp
//   evaluates up to the piece where its own last pixel saturates, not the
//   tile's. Each warp owns PPT consecutive runs of 32 pixels (tile 16: two
//   rows; tile 32: four rows), neighbours that tend to saturate together.
// - A ring of packed records loaded ahead. RING = 3 pieces live in shared
//   memory as 48-byte records {x, y, c0, c1}, {r, g, b, a}, {c2, 0, 0, 0},
//   so the inner loop reads a slot with three broadcast loads, two of 16
//   bytes, in place of nine of 4. The first warp gathers piece k + 2, a
//   slot a lane, with cp.async (8 bytes of image_pos, 4 + 4 + 4 of conic,
//   16 of colour at the slot's id, whose own load runs one piece further
//   ahead in a register) while piece k is evaluated; cp.async.wait_group and the
//   vote's barrier are the handshake, so a piece costs one barrier. A slot
//   past the list's or the chunk's end gets a zero record: alpha 0, which
//   leaves c, cp and the colour of every pixel as they are, so the inner
//   loop always runs a whole piece. TMA does not fit: on Hopper it copies
//   boxes of a tensor, and this is an indexed gather of 36 bytes a slot.
//   Nor does a pass that repacks all P splats first: at 5.8M splats it
//   would move about 0.5 GB, more than the kernel's whole bound.
//
// Threads. 256 a block, as gsplat_render.glsl; each owns PPT =
// ceil(tile_size^2 / 256) pixels (tile 16: 1, tile 32: 4), so one
// shared-memory read of a splat feeds PPT pixels. The times, the SASS per
// evaluation and the evaluations the walk makes (which the kernel counts
// when given `evals`) are in PERF.md section 6.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int PIECE = 32;  // slots between two exit votes
constexpr int RING = 3;    // pieces in shared memory: evaluated, landed,
                           // in flight
static_assert(PIECE == 32, "each lane of the loading warp gathers one slot");
constexpr float MIN_T = 1.0f / 255.0f;

// A slot's splat data, as the inner loop reads it.
struct __align__(16) Rec {
  float4 pc;   // x, y, c0, c1
  float4 col;  // r, g, b, a
  float4 c2;   // c2, 0, 0, 0
};

__device__ __forceinline__ unsigned smem(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem(dst)),
               "l"(src), "n"(BYTES)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The walk's pieces: PIECE slots at a time from each chunk's base, the last
// piece of a chunk (or of the list) cut at its end. The walk is over once
// start >= n_eff.
struct Walk {
  int base, start;
  __device__ int end(int chunk, int n_eff) const {
    return min(base + chunk, n_eff);
  }
  __device__ int count(int chunk, int n_eff) const {
    return min(PIECE, end(chunk, n_eff) - start);
  }
  __device__ void next(int chunk, int n_eff) {
    start += PIECE;
    if (start >= end(chunk, n_eff)) {
      base += chunk;
      start = base;
    }
  }
};

// The splat id of slot `lane` of piece `w` of a tile's `list`, 0 past the
// piece's end.
__device__ __forceinline__ int slot_id(const int* __restrict__ list,
                                       const Walk& w, int lane, int chunk,
                                       int n_eff) {
  return lane < w.count(chunk, n_eff) ? list[w.start + lane] : 0;
}

// Lane `lane` of the first warp gathers slot `lane` of a piece into `dst`:
// the record of its splat `id`, or a zero record past the piece's `cnt`
// slots.
__device__ __forceinline__ void gather(Rec* dst, int lane, int cnt, int id,
                                       const float* __restrict__ image_pos,
                                       const float* __restrict__ conic,
                                       const float* __restrict__ color) {
  Rec& rec = dst[lane];
  if (lane < cnt) {
    const float* cn = conic + 3 * (size_t)id;
    cp_async<8>(&rec.pc.x, image_pos + 2 * (size_t)id);
    cp_async<4>(&rec.pc.z, cn);
    cp_async<4>(&rec.pc.w, cn + 1);
    cp_async<16>(&rec.col, color + 4 * (size_t)id);
    cp_async<4>(&rec.c2.x, cn + 2);
  } else {
    const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    rec.pc = z;
    rec.col = z;
    rec.c2 = z;
  }
}

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
                    int height, int chunk, int cap_eff, int ox, int oy,
                    unsigned long long* __restrict__ evals) {
  __shared__ Rec ring[RING][PIECE];
  const int tile = blockIdx.x;
  const int tx = tile % gx, ty = tile / gx;
  const int s = start[tile];
  const int n = end[tile] - s;
  const int n_eff = min(max(n, 0), cap_eff);
  const int npx = ts * ts;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const bool loader = warp == 0;

  // pixel k of this thread: the k-th run of 32 of its warp's PPT runs
  float px[PPT], py[PPT], q[PPT], c[PPT], cp[PPT], acc[PPT][3];
  bool live = false;
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int p = (warp * PPT + k) * 32 + lane;
    px[k] = (float)(tx * ts + ox) + (float)(p % ts);
    py[k] = (float)(ty * ts + oy) + (float)(p / ts);
    // pixels past the tile take no part in the exit vote
    q[k] = p < npx ? 1.0f : 0.0f;
    c[k] = 1.0f;
    cp[k] = 1.0f;
    acc[k][0] = acc[k][1] = acc[k][2] = 0.0f;
    live |= q[k] > MIN_T;
  }

  // The first two pieces, each its own cp.async group, and the ids of the
  // third; then piece k is evaluated while k + 1 lands and k + 2 is sent.
  Walk cur = {0, 0};
  Walk ahead = cur;
  int nid = 0;  // the splat id of this lane's slot of the next gather
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (loader && ahead.start < n_eff) {
      nid = slot_id(values + s, ahead, lane, chunk, n_eff);
      gather(ring[i], lane, ahead.count(chunk, n_eff), nid, image_pos, conic,
             color);
    }
    cp_async_commit();
    ahead.next(chunk, n_eff);
  }
  if (loader && ahead.start < n_eff)
    nid = slot_id(values + s, ahead, lane, chunk, n_eff);

  for (int k = 0; cur.start < n_eff; ++k) {
    cp_async_wait<1>();  // this thread's copies of piece k have landed
    // The exit vote on the state after piece k - 1. The barrier also makes
    // piece k visible to every thread, and frees the ring slot of k - 1.
    if (!__syncthreads_or(live)) break;
    if (loader && ahead.start < n_eff) {
      gather(ring[(k + 2) % RING], lane, ahead.count(chunk, n_eff), nid,
             image_pos, conic, color);
      Walk after = ahead;
      after.next(chunk, n_eff);
      if (after.start < n_eff)
        nid = slot_id(values + s, after, lane, chunk, n_eff);
    }
    cp_async_commit();
    ahead.next(chunk, n_eff);

    if (__any_sync(0xffffffffu, live)) {
      if (evals != nullptr && lane == 0)
        atomicAdd(evals, (unsigned long long)(PIECE * 32 * PPT));
      const Rec* rec = ring[k % RING];
#pragma unroll 4
      for (int j = 0; j < PIECE; ++j) {
        const float4 pc = rec[j].pc;
        const float4 col = rec[j].col;
        const float c2 = rec[j].c2.x;
#pragma unroll
        for (int i = 0; i < PPT; ++i) {
          const float dx = pc.x - px[i];
          const float dy = pc.y - py[i];
          const float power = -0.5f * (pc.z * dx * dx + c2 * dy * dy)
                              - pc.w * dx * dy;
          const float alpha = col.w * expf(power);
          const float t = q[i] * c[i];
          c[i] = c[i] * (1.0f - alpha);
          if (t > MIN_T) {
            const float w = alpha * t;
            acc[i][0] += w * col.x;
            acc[i][1] += w * col.y;
            acc[i][2] += w * col.z;
            cp[i] = c[i];
          }
        }
      }
    }
    if (cur.start + PIECE >= cur.end(chunk, n_eff)) {  // the chunk ends
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        q[i] = q[i] * cp[i];
        c[i] = 1.0f;
        cp[i] = 1.0f;
      }
    }
    live = false;
#pragma unroll
    for (int i = 0; i < PPT; ++i) live |= q[i] * c[i] > MIN_T;
    cur.next(chunk, n_eff);
  }
  cp_async_wait<0>();  // no copy outlives the block
#pragma unroll
  for (int i = 0; i < PPT; ++i) q[i] = q[i] * cp[i];  // a chunk the vote cut

  const float hf = heatmap[0];
  const float mixf = (float)n * 5e-4f;
  const float hm[3] = {0.0f + (1.0f - 0.0f) * mixf, 0.0f + (0.2f - 0.0f) * mixf,
                       1.0f + (0.2f - 1.0f) * mixf};
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int p = (warp * PPT + k) * 32 + lane;
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
                   int oy, void* evals, cudaStream_t stream) {
  render_exact_kernel<PPT><<<T, THREADS, 0, stream>>>(
      (const int*)values, (const int*)start, (const int*)end,
      (const float*)image_pos, (const float*)conic, (const float*)color,
      (const float*)heatmap, (float*)image, (float*)tile_t0,
      (int*)tile_counts, gx, ts, width, height, chunk, cap_eff, ox, oy,
      (unsigned long long*)evals);
  return cudaGetLastError();
}

}  // namespace

// values (K,) i32 sorted splat ids; start, end (gx*gy,) i32; image_pos
// (P, 2) f32, 8-byte aligned; conic (P, 3) f32; color (P, 4) f32, 16-byte
// aligned; heatmap (1,) f32 -> image (height, width, 4) f32, tile_t0
// (gx*gy,) f32, tile_counts (gx*gy,) i32. chunk = min(512, C) and cap_eff =
// ceil(C / chunk) * chunk for the tile capacity C; (ox, oy) shifts the
// pixel coordinates (not the output). With `evals` (a u64 on the card,
// zeroed by the caller) each warp adds the (pixel, slot) evaluations of
// every piece it evaluates, 32 * PPT * PIECE, which
// render_exact.schedule_evaluations models; null in a frame.
extern "C" int gs_render_exact(const void* values, const void* start,
                               const void* end, const void* image_pos,
                               const void* conic, const void* color,
                               const void* heatmap, void* image,
                               void* tile_t0, void* tile_counts, int gx,
                               int gy, int tile_size, int width, int height,
                               int chunk, int cap_eff, int ox, int oy,
                               void* evals, void* stream) {
  const int T = gx * gy;
  const int npx = tile_size * tile_size;
  if (T <= 0) return (int)cudaSuccess;
  if (chunk <= 0 || npx <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (npx <= THREADS)
    return (int)launch<1>(values, start, end, image_pos, conic, color,
                          heatmap, image, tile_t0, tile_counts, T, gx,
                          tile_size, width, height, chunk, cap_eff, ox, oy,
                          evals, st);
  if (npx <= 2 * THREADS)
    return (int)launch<2>(values, start, end, image_pos, conic, color,
                          heatmap, image, tile_t0, tile_counts, T, gx,
                          tile_size, width, height, chunk, cap_eff, ox, oy,
                          evals, st);
  if (npx <= 4 * THREADS)
    return (int)launch<4>(values, start, end, image_pos, conic, color,
                          heatmap, image, tile_t0, tile_counts, T, gx,
                          tile_size, width, height, chunk, cap_eff, ox, oy,
                          evals, st);
  return (int)cudaErrorInvalidValue;
}

// The walk's shape, which render_exact.py reads from here.
extern "C" int gs_render_exact_piece(void) { return PIECE; }
extern "C" int gs_render_exact_threads(void) { return THREADS; }
