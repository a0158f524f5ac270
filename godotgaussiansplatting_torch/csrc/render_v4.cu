// Lockstep tile compositing (v4): GT tiles per thread block, on the cooked
// (B, 16, 128) f32 payload.
//
// Replaces the TPU kernel `_render_kernel_v4` in
// godotgaussiansplatting_tpu/ops/render_pallas4.py (launched by
// `render_tiles_v4`). The semantics are v3's, tile for tile, with the
// composite of render_tile.cuh, which reads the big lanes' log-alpha maps
// (prepass_big_la); the v3 kernel (render_v3.cu) evaluates them itself and
// sums in another order, so the two agree to >= 60 dB, not bit for bit.
// The output is (T4, GT*NPX, 8) f32, pixel-major, exactly as the JAX kernel
// lays it out.
//
// What bounds it on Hopper: the same per-(pixel, lane) arithmetic as v3 (a
// six-term power, an exp and a log1p), plus the fixed costs each batch
// step pays once per thread block: the header and depth-range reads, the
// big-lane loads, the sort's barriers and the exit vote.
//
// Design. The TPU kernel runs GT tiles per grid step to share one MXU issue
// and hide matmul latency; on Hopper the point is to pay a block's fixed
// costs once per group of GT tiles:
//   * one thread block per group of GT tiles (tiles t4*GT .. t4*GT+GT-1 of
//     the row-major tile order, padded with empty tiles), persistent over
//     groups like v3;
//   * batch k of every still-live tile of the group is decoded into shared
//     memory together, the GT tiles' key runs are rank-sorted by one
//     segmented bitonic sort, and their active lanes gathered into each
//     tile's ring slot: one set of barriers per batch step for all GT
//     tiles. Each tile keeps its own early-exit flag (one __syncthreads_or
//     vote per live tile);
//   * at tile 32 each of the 1024 threads owns its pixel in all GT tiles;
//     at tile 16, GT*256 threads own one (tile, pixel) each;
//   * the per-(pixel, big lane) chain mass scratch is GT*OB*NPX f32 per
//     resident block, in device memory.
// Shared memory per block is GT times v3's per-tile tables (the lane ring,
// the sort keys, the big-lane tables sized by OB); a configuration that
// does not fit is refused by the wrapper with the bytes it needs.

#include "render_tile.cuh"

namespace {

using namespace gs;

struct Params {
  int T4, GT, gx, T, U, max_batches, OB, early_exit;
};

// Shared memory of one block: GT lane rings, GT sort-key runs, then the
// per-tile big-lane tables.
struct Smem {
  float* slots;      // [GT][4 * NF * US]
  uint64_t* keys;    // [GT][NK]
  int* prefix;       // [GT][128]
  int* nact;         // [GT][4] (3 ring slots used)
  uint32_t* brank;   // [GT][OB]
  float* bd;         // [GT][OB]
  float* brgb;       // [GT][3][OB]
};

__host__ __device__ size_t smem_bytes(int U, int GT, int OB) {
  const int US = U * S;
  const size_t per_tile = sizeof(float) * 4 * NF * US +
                          sizeof(uint64_t) * pow2_ceil(US) +
                          sizeof(int) * (128 + 4) + sizeof(float) * 5 * OB;
  return per_tile * GT;
}

__device__ __forceinline__ Smem smem_layout(unsigned char* base, int GT,
                                            int US, int NK, int OB) {
  Smem m;
  m.slots = (float*)base;
  m.keys = (uint64_t*)(m.slots + (size_t)GT * 4 * NF * US);
  m.prefix = (int*)(m.keys + (size_t)GT * NK);
  m.nact = m.prefix + GT * 128;
  m.brank = (uint32_t*)(m.nact + GT * 4);
  m.bd = (float*)(m.brank + GT * OB);
  m.brgb = m.bd + GT * OB;
  return m;
}

// Tile g of the group that starts at tile t0: its tables.
__device__ __forceinline__ TileRefs tile_refs(const Smem& m,
                                              const int32_t* rows,
                                              const float* bigla_t,
                                              float* big_z, int g, int t0,
                                              int GT, int US, int OB,
                                              int NPX) {
  const int t = t0 + g;
  return TileRefs{rows + (size_t)t * 1024,
                  m.slots + (size_t)g * 4 * NF * US,
                  m.nact + g * 4,
                  m.prefix + g * 128,
                  m.brank + g * OB,
                  m.bd + g * OB,
                  m.brgb + g * 3 * OB,
                  OB,
                  bigla_t + (size_t)t * OB * NPX,
                  big_z + ((size_t)blockIdx.x * GT + g) * OB * NPX};
}

// TPT: tiles per thread (GT at tile 32, 1 at tile 16).
template <int TPT>
__global__ void __launch_bounds__(1024)
render_kernel_v4(const int32_t* __restrict__ rows,
                 const float* __restrict__ payload,
                 const float* __restrict__ bigpay,
                 const float* __restrict__ bigla_t, float* __restrict__ out,
                 float* __restrict__ big_z, Params P) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int T = P.T, NPX = T * T, U = P.U, US = U * S, OB = P.OB;
  const int GT = P.GT, NK = pow2_ceil(US);
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int p = tid % NPX, g0 = tid / NPX, gstep = nthr / NPX;
  const float tsz = (float)T;
  const Pix q = pixel_of(p, T);
  const Smem m = smem_layout(smem, GT, US, NK, OB);

  for (int grp = blockIdx.x; grp < P.T4; grp += gridDim.x) {
    const int t0 = grp * GT;
    // --- the group's big-lane tables and straddle prefixes --------------
    for (int i = tid; i < GT * 128; i += nthr)
      m.prefix[i] = rows[(size_t)(t0 + i / 128) * 1024 + 5 * 128 + i % 128];
    for (int i = tid; i < GT * OB; i += nthr) {
      const int g = i / OB, b = i % OB;
      if (b < rows[(size_t)(t0 + g) * 1024 + 4])
        load_big_lane(bigpay + (size_t)(t0 + g) * 16 * OB, OB, b,
                      m.brank + g * OB, m.bd + g * OB, m.brgb + g * 3 * OB,
                      OB);
    }
    PixState ps[TPT];
    TileState ts[TPT];
    int kdone[TPT];
#pragma unroll
    for (int j = 0; j < TPT; ++j) {
      const TileRefs tr = tile_refs(m, rows, bigla_t, big_z, g0 + j * gstep,
                                    t0, GT, US, OB, NPX);
      for (int b = 0; b < tr.row[4]; ++b) tr.bz[(size_t)b * NPX + p] = 0.0f;
      ps[j] = PixState{};
      ts[j] = TileState{};
      kdone[j] = 0;
    }
    unsigned go = (1u << GT) - 1u;
    __syncthreads();

    for (int k = 0; k < P.max_batches; ++k) {
      unsigned live = 0;
      for (int g = 0; g < GT; ++g)
        if (((go >> g) & 1u) && k * U < rows[(size_t)(t0 + g) * 1024])
          live |= 1u << g;
      if (!live) break;
      const int s = k % 3;
      if (tid < GT && ((live >> tid) & 1u)) m.nact[tid * 4 + s] = 0;
      // --- decode batch k of every live tile into its staging slot -------
      for (int i = tid; i < GT * NK; i += nthr) {
        const int g = i / NK, l = i % NK;
        if (!((live >> g) & 1u)) continue;
        const int t = t0 + g;
        const int32_t* row = rows + (size_t)t * 1024;
        uint64_t sk = NO_KEY;
        if (l < US) {
          const int pos = k * U + l / S;
          if (pos < row[0]) {
            const float ox = (float)((t % P.gx) * T);
            const float oy = (float)((t / P.gx) * T + row[3]);
            sk = decode_lane<true>(
                payload, row[128 + pos] & 0x7FFFFF, l % S, l, ox, oy, tsz,
                slot_at(m.slots + (size_t)g * 4 * NF * US, 3, US), US);
          }
        }
        m.keys[(size_t)g * NK + l] = sk;
      }
      __syncthreads();
      // --- one segmented rank sort, then each tile's gather --------------
      bitonic_sort(m.keys, NK, GT, live, tid, nthr);
      for (int i = tid; i < GT * US; i += nthr) {
        const int g = i / US, l = i % US;
        if (!((live >> g) & 1u)) continue;
        float* sl = m.slots + (size_t)g * 4 * NF * US;
        gather_sorted(m.keys + (size_t)g * NK, l, NK, US, slot_at(sl, 3, US),
                      slot_at(sl, s, US), &m.nact[g * 4 + s]);
      }
      __syncthreads();
      // --- the per-pixel composite of each live tile this thread owns ----
      unsigned more = 0;
#pragma unroll
      for (int j = 0; j < TPT; ++j) {
        const int g = g0 + j * gstep;
        if ((live >> g) & 1u) {
          const TileRefs tr =
              tile_refs(m, rows, bigla_t, big_z, g, t0, GT, US, OB, NPX);
          if (composite_batch(tr, k, U, US, NPX, p, q, ps[j], ts[j]))
            more |= 1u << g;
          kdone[j] = k + 1;
        }
      }
      // --- each live tile's exit vote -----------------------------------
      if (P.early_exit) {
        for (int g = 0; g < GT; ++g)
          if ((live >> g) & 1u)
            if (!__syncthreads_or((int)((more >> g) & 1u))) go &= ~(1u << g);
      } else {
        __syncthreads();
      }
    }
    // --- every tile: its last emit, its big lanes, the present ------------
#pragma unroll
    for (int j = 0; j < TPT; ++j) {
      const int g = g0 + j * gstep;
      const TileRefs tr =
          tile_refs(m, rows, bigla_t, big_z, g, t0, GT, US, OB, NPX);
      const float bigtot = finish_tile(tr, kdone[j], US, NPX, p, q, ps[j],
                                       ts[j]);
      present(tr.row, kdone[j], U, bigtot, ps[j].acc, ps[j].tcar,
              out + ((size_t)(t0 + g) * NPX + p) * 8, 1);
    }
    __syncthreads();   // shared tile state is rewritten by the next group
  }
}

using KernelV4 = void (*)(const int32_t*, const float*, const float*,
                          const float*, float*, float*, Params);

// The kernel instance and block size for GT tiles of tile_size: each
// thread owns its pixel in GT * tile_size^2 / threads tiles.
KernelV4 kernel_for(int tile_size, int GT, int* threads) {
  const int n = GT * tile_size * tile_size;
  *threads = n < 1024 ? n : 1024;
  switch (n / *threads) {
    case 1: return render_kernel_v4<1>;
    case 2: return render_kernel_v4<2>;
    case 3: return render_kernel_v4<3>;
    case 4: return render_kernel_v4<4>;
  }
  return nullptr;
}

}  // namespace

// Dynamic shared memory one block needs, in bytes.
extern "C" int gs_render_v4_smem_bytes(int U, int GT, int OB) {
  return (int)smem_bytes(U, GT, OB);
}

// The most dynamic shared memory a block of this card may opt in to.
extern "C" int gs_smem_optin() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return -2;
  return bytes;
}

// Resident thread blocks the whole card holds (the persistent grid and the
// number of big_z scratch slices); < 0 on error.
extern "C" int gs_render_v4_max_blocks(int tile_size, int U, int GT, int OB) {
  int threads = 0;
  const KernelV4 k = kernel_for(tile_size, GT, &threads);
  if (k == nullptr) return -5;
  return card_resident_blocks(k, threads, smem_bytes(U, GT, OB));
}

extern "C" int gs_render_v4(const void* rows, const void* payload,
                            const void* bigpay, const void* bigla_t, void* out,
                            void* big_z, int T4, int GT, int gx,
                            int tile_size, int U, int max_batches, int obig,
                            int early_exit, int grid, void* stream) {
  if (obig > MAX_OB || U < 1 || U * S > 512 || GT < 1 || GT > 4)
    return (int)cudaErrorInvalidValue;
  int threads = 0;
  const KernelV4 k = kernel_for(tile_size, GT, &threads);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  const size_t bytes = smem_bytes(U, GT, obig);
  const int err = allow_smem(k, bytes);
  if (err != 0) return err;
  Params P{T4, GT, gx, tile_size, U, max_batches, obig, early_exit};
  k<<<grid, threads, bytes, (cudaStream_t)stream>>>(
      (const int32_t*)rows, (const float*)payload, (const float*)bigpay,
      (const float*)bigla_t, (float*)out, (float*)big_z, P);
  return (int)cudaGetLastError();
}
