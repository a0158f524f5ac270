// Fused per-splat projection for the fast path.
//
// Replaces the TPU kernel `_proj_kernel` in
// godotgaussiansplatting_tpu/ops/projection_pallas.py (launched by
// `project_words`). Semantics and operation order follow
// `project_words_reference` in ops/projection_kernel.py, which the tests
// hold to the JAX kernel.
//
// What bounds it on Hopper: device-memory bandwidth. Each splat reads about
// 140 B (means 12, cov3d 24, opacity and upload time 8, bf16 SH 96) and
// writes 28 B; the arithmetic (~400 flops, a handful of transcendentals)
// is far below the card's compute rate.
//
// Design: one thread per splat, no shared state except the per-chunk
// counts. Reads of the (P, 3)/(P, 6) arrays are contiguous across a warp
// (every byte of each sector is used), and the planar (48, P) bf16 SH is
// read coalesced row by row. Outputs are written in the shapes their
// consumer reads, so nothing is re-laid-out afterwards. The chunk counts
// (big splats, covered tiles) are reduced per warp and added with one
// atomic per warp into a buffer the launcher zeroes on the stream.
// The TPU kernel's integer-only f32->f16 conversion exists only because
// Mosaic lacks an f16 cast; here __float2half_rn does it (RNE, subnormals
// kept).
//
// Precision: built with --fmad=false and without fast-math, so every
// product and sum rounds on its own exactly like the plain version's
// separate torch ops; divides and square roots are IEEE. depth16 and the
// screen cell, which the tests hold bit-exact, follow from that.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float BIG_RADIUS = 32.0f;

__device__ __forceinline__ uint32_t f16_bits(float x) {
  return (uint32_t)__half_as_ushort(__float2half_rn(x));
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// NaN-propagating clamps, as torch.clamp / torch.maximum behave.
__device__ __forceinline__ float cmax(float x, float lo) {
  return (x != x) ? x : (x < lo ? lo : x);
}
__device__ __forceinline__ float cmin(float x, float hi) {
  return (x != x) ? x : (x > hi ? hi : x);
}
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return cmin(cmax(x, lo), hi);
}

__device__ __forceinline__ uint32_t pack_rgb9e5(float r, float g, float b) {
  float m = fmaxf(fmaxf(r, g), b);
  int eb = (int)((__float_as_uint(cmax(m, 1e-12f)) >> 23) & 0xFF) - 126;
  int e = min(max(eb, -15), 16);
  float s = __int_as_float((9 - e + 127) << 23);
  auto q = [&](float c) -> uint32_t {
    return (uint32_t)(int)clampf(rintf(c * s), 0.0f, 511.0f);
  };
  return q(r) | (q(g) << 9) | (q(b) << 18) | ((uint32_t)(e + 15) << 27);
}

__device__ __forceinline__ uint32_t spread8(uint32_t v) {
  v = (v | (v << 4)) & 0x0F0Fu;
  v = (v | (v << 2)) & 0x3333u;
  v = (v | (v << 1)) & 0x5555u;
  return v;
}

struct Params {
  int P, CPK, CW, cell, gx, gy, sh_degree, jq_quirk;
  float w, h, ts;
};

__global__ void __launch_bounds__(256)
project_kernel(const float* __restrict__ uni, const float* __restrict__ means,
               const float* __restrict__ cov, const float* __restrict__ opac,
               const float* __restrict__ utime,
               const __nv_bfloat16* __restrict__ sh,
               uint32_t* __restrict__ key_o, uint32_t* __restrict__ ix_o,
               uint32_t* __restrict__ iy_o, uint32_t* __restrict__ pc1_o,
               uint32_t* __restrict__ pc2_o, uint32_t* __restrict__ rgb9_o,
               uint32_t* __restrict__ bkey_o, int* __restrict__ cnt_o,
               Params p) {
  __shared__ float u[37];
  if (threadIdx.x < 37) u[threadIdx.x] = uni[threadIdx.x];
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in_range = i < p.P;
  int is_big_i = 0, nt_i = 0;
  if (in_range) {
    const float ms = u[31];
    const float spx = means[3 * i + 0] * ms;
    const float spy = means[3 * i + 1] * ms;
    const float spz = means[3 * i + 2] * ms;
    const float vpx = u[0] * spx + u[1] * spy + u[2] * spz + u[9];
    const float vpy = u[3] * spx + u[4] * spy + u[5] * spz + u[10];
    const float vpz = u[6] * spx + u[7] * spy + u[8] * spz + u[11];
    const float clx = u[12] * vpx + u[13] * vpy + u[14] * vpz + u[21];
    const float cly = u[15] * vpx + u[16] * vpy + u[17] * vpz + u[22];
    const float clz = u[18] * vpx + u[19] * vpy + u[20] * vpz + u[23];
    const float clw = u[24] * vpx + u[25] * vpy + u[26] * vpz + u[27];

    const float bound = clw * 1.2f;
    const bool inside = (clx >= -bound) && (clx <= bound) && (cly >= -bound) &&
                        (cly <= bound) && (clz >= 0.0f) && (clz <= clw);

    // load fade-in
    const float st = u[32] - utime[i];
    auto ease = [](float x) {
      float a = 1.0f - x;
      return 1.0f - a * a * a;
    };
    const float tf = ease(clampf(st, 0.0f, 1.0f));
    const float tfl = ease(clampf(st - 0.35f, 0.0f, 1.0f));
    const float sop = opac[i] * tfl * tfl;
    const float sscale = ms * (2.0f - tfl);

    // EWA 2D covariance, with the reference's Jacobian quirk
    const float s2 = sscale * sscale;
    const float xx = cov[6 * i + 0] * s2, xy = cov[6 * i + 1] * s2;
    const float xz = cov[6 * i + 2] * s2, yy = cov[6 * i + 3] * s2;
    const float yz = cov[6 * i + 4] * s2, zz = cov[6 * i + 5] * s2;
    const float z_inv = 1.0f / vpz;
    const float fzx = u[33] * z_inv;
    const float fzy = u[34] * z_inv;
    const float limx = u[35] * 1.3f, limy = u[36] * 1.3f;
    const float mx = clampf(vpx * z_inv, -limx, limx);
    const float my = clampf(vpy * z_inv, -limy, limy);
    const float jq = p.jq_quirk ? fzy : fzx;
    const float njm = -jq * mx;
    const float nfm = -fzy * my;
    const float b0x = u[0] * fzx + u[6] * njm;
    const float b0y = u[1] * fzx + u[7] * njm;
    const float b0z = u[2] * fzx + u[8] * njm;
    const float b1x = u[3] * fzy + u[6] * nfm;
    const float b1y = u[4] * fzy + u[7] * nfm;
    const float b1z = u[5] * fzy + u[8] * nfm;
    const float s0x = xx * b0x + xy * b0y + xz * b0z;
    const float s0y = xy * b0x + yy * b0y + yz * b0z;
    const float s0z = xz * b0x + yz * b0y + zz * b0z;
    const float cov_a = b0x * s0x + b0y * s0y + b0z * s0z + 0.3f;
    const float cov_b = b1x * s0x + b1y * s0y + b1z * s0z;
    const float s1x = xx * b1x + xy * b1y + xz * b1z;
    const float s1y = xy * b1x + yy * b1y + yz * b1z;
    const float s1z = xz * b1x + yz * b1y + zz * b1z;
    const float cov_c = b1x * s1x + b1y * s1y + b1z * s1z + 0.3f;

    const float det = cov_a * cov_c - cov_b * cov_b;
    const bool nonsingular = det != 0.0f;
    const float mid = 0.5f * (cov_a + cov_c);
    const float disc = sqrtf(cmax(mid * mid - det, 0.1f));
    const float lam1 = mid + disc;
    const float lam2 = mid - disc;
    const bool eig_ok = (lam1 >= 0.0f) && (lam2 >= 0.0f);

    // image position with slide-in; direct divides
    const float safe_w = (clw == 0.0f) ? 1.0f : clw;
    const float ndcx = clx / safe_w;
    const float ndcy = cly / safe_w;
    const float ndcz = clz / safe_w;
    const float ix = ((ndcx + 1.0f) * 0.5f - (1.0f - tf)) * (p.w - 1.0f);
    const float iy = ((ndcy + 1.0f) * 0.5f - 0.75f * (1.0f - tf)) * (p.h - 1.0f);

    // radius, square tile rect, tile count
    float radius = expf(0.2f * logf(cmax(sop, 1e-37f))) * 2.5f *
                   sqrtf(fmaxf(lam1, lam2));
    radius = (sop > 0.0f) ? radius : 0.0f;
    const float gxf = (float)p.gx, gyf = (float)p.gy;
    const int lox = (int)clampf((ix - radius) / p.ts, 0.0f, gxf);
    const int loy = (int)clampf((iy - radius) / p.ts, 0.0f, gyf);
    const int hix = (int)clampf(ceilf((ix + radius) / p.ts), 0.0f, gxf);
    const int hiy = (int)clampf(ceilf((iy + radius) / p.ts), 0.0f, gyf);
    int nt = max(hix - lox, 0) * max(hiy - loy, 0);
    const bool valid = inside && nonsingular && eig_ok && (nt > 0);
    nt = valid ? nt : 0;

    // depth16
    const float z3 = ndcz * ndcz * ndcz;
    const uint32_t depth16 = (uint32_t)(int)clampf(z3 * 65535.0f, 0.0f, 65534.0f);

    // SH colour
    const float dx = spx - u[28], dy = spy - u[29], dz = spz - u[30];
    const float inv_n = rsqrtf(cmax(dx * dx + dy * dy + dz * dz, 1e-24f));
    const float x = dx * inv_n, y = dy * inv_n, z = dz * inv_n;
    const float C0 = (float)0.28209479177387814;
    const float C1 = (float)0.4886025119029199;
    const float C20 = (float)1.0925484305920792, C21 = (float)1.0925484305920792;
    const float C22 = (float)0.31539156525252005, C23 = (float)1.0925484305920792;
    const float C24 = (float)0.5462742152960396;
    const float C30 = (float)0.5900435899266435, C31 = (float)2.890611442640554;
    const float C32 = (float)0.4570457994644658, C33 = (float)0.3731763325901154;
    const float C34 = (float)0.4570457994644658, C35 = (float)1.445305721320277;
    const float C36 = (float)0.5900435899266435;
    const int P = p.P;
    float rgb[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      auto co = [&](int k) { return __bfloat162float(sh[(size_t)(3 * k + c) * P + i]); };
      float v = 0.5f + co(0) * C0;
      if (p.sh_degree >= 1) {
        v = v - co(1) * (C1 * y) + co(2) * (C1 * z) - co(3) * (C1 * x);
      }
      const float xx2 = x * x, yy2 = y * y, zz2 = z * z;
      if (p.sh_degree >= 2) {
        v = v + co(4) * (C20 * (x * y)) - co(5) * (C21 * (y * z)) +
            co(6) * (C22 * (2.0f * zz2 - xx2 - yy2)) - co(7) * (C23 * (x * z)) +
            co(8) * (C24 * (xx2 - yy2));
      }
      if (p.sh_degree >= 3) {
        v = v - co(9) * (C30 * y * (3.0f * xx2 - yy2)) +
            co(10) * (C31 * x * (y * z)) -
            co(11) * (C32 * y * (4.0f * zz2 - xx2 - yy2)) +
            co(12) * (C33 * z * (2.0f * zz2 - 3.0f * xx2 - 3.0f * yy2)) -
            co(13) * (C34 * x * (4.0f * zz2 - xx2 - yy2)) +
            co(14) * (C35 * z * (xx2 - yy2)) -
            co(15) * (C36 * x * (xx2 - 3.0f * yy2));
      }
      rgb[c] = cmax(v, 0.0f);
    }

    // conic
    const float safe_det = (det == 0.0f) ? 1.0f : det;
    const float det_inv = 1.0f / safe_det;
    const float ca = cov_c * det_inv;
    const float cb = -cov_b * det_inv;
    const float cc = cov_a * det_inv;

    // packing
    const uint32_t pc1 = f16_bits(ca) | (f16_bits(cb) << 16);
    const uint32_t pc2 = f16_bits(cc) | (f16_bits(sop) << 16);
    const uint32_t rgb9 = pack_rgb9e5(rgb[0], rgb[1], rgb[2]);

    // anisotropic extents (ops/blocks2.extents_from_conic) -> bigness
    const float edet = cmax(ca * cc - cb * cb, 1e-20f);
    const float sxx = cmax(cc / edet, 0.0f);
    const float syy = cmax(ca / edet, 0.0f);
    const float em = 0.5f * (sxx + syy);
    const float lam = em + sqrtf(cmax(em * em - 1.0f / edet, 0.0f));
    const float R = powf(cmax(sop, 0.0f), 0.2f) * 2.5f * sqrtf(lam);
    const float vis = sqrtf(2.0f * cmax(logf(cmax(sop, 1e-8f) * 255.0f), 0.125f));
    const float rx = bf16_round(fminf(R, vis * sqrtf(sxx)));
    const float ry = bf16_round(fminf(R, vis * sqrtf(syy)));
    const bool is_big = (fmaxf(rx, ry) >= BIG_RADIUS) && valid;
    const uint32_t col = (uint32_t)(i % p.CW);
    bkey_o[i] = is_big ? ((depth16 << 10) | col) : 0xFFFFFFFFu;

    // screen-cell Morton
    const uint32_t ctx = (uint32_t)min(max((int)(ix / p.ts), 0), p.gx - 1) >> p.cell;
    const uint32_t cty = (uint32_t)min(max((int)(iy / p.ts), 0), p.gy - 1) >> p.cell;
    const uint32_t morton = (spread8(ctx & 0xFF) | (spread8(cty & 0xFF) << 1)) & 0x7FFFu;

    key_o[i] = valid ? ((morton << 16) | depth16) : 0xFFFFFFFFu;
    ix_o[i] = __float_as_uint(ix);
    iy_o[i] = __float_as_uint(iy);
    pc1_o[i] = pc1;
    pc2_o[i] = pc2;
    rgb9_o[i] = rgb9;
    is_big_i = is_big ? 1 : 0;
    nt_i = nt;
  }
  // per-chunk counts: warp reduce, one atomic per warp (a warp never spans
  // two chunks: CPK is a multiple of 128)
  const unsigned full = 0xFFFFFFFFu;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    is_big_i += __shfl_down_sync(full, is_big_i, off);
    nt_i += __shfl_down_sync(full, nt_i, off);
  }
  const int first = blockIdx.x * blockDim.x + (threadIdx.x & ~31);
  if ((threadIdx.x & 31) == 0 && first < p.P) {
    const int chunk = first / p.CPK;
    if (is_big_i) atomicAdd(&cnt_o[chunk * 128 + 0], is_big_i);
    if (nt_i) atomicAdd(&cnt_o[chunk * 128 + 1], nt_i);
  }
}

}  // namespace

extern "C" int gs_project_words(const void* uni, const void* means,
                                const void* cov, const void* opacity,
                                const void* upload_time, const void* sh,
                                void* key, void* ix, void* iy, void* pc1,
                                void* pc2, void* rgb9, void* bkey, void* cnt,
                                int P, int CPK, int CW, int cell, int gx,
                                int gy, int sh_degree, int jq_quirk, float w,
                                float h, float ts, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int grid = (P / CPK) * 128;
  cudaMemsetAsync(cnt, 0, sizeof(int) * (size_t)grid, s);
  Params p{P, CPK, CW, cell, gx, gy, sh_degree, jq_quirk, w, h, ts};
  const int threads = 256;
  project_kernel<<<(P + threads - 1) / threads, threads, 0, s>>>(
      (const float*)uni, (const float*)means, (const float*)cov,
      (const float*)opacity, (const float*)upload_time,
      (const __nv_bfloat16*)sh, (uint32_t*)key, (uint32_t*)ix, (uint32_t*)iy,
      (uint32_t*)pc1, (uint32_t*)pc2, (uint32_t*)rgb9, (uint32_t*)bkey,
      (int*)cnt, p);
  return (int)cudaGetLastError();
}
