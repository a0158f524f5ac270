// The readable projection: per-splat frustum cull, EWA covariance, tile
// rect, depth key and SH colour, every field of ProjectedSplats.
//
// Replaces XLA's fusion of `project_splats` in
// godotgaussiansplatting_tpu/ops/projection.py (plain XLA there, no Pallas
// kernel): the exact frame's Projection stage, quality="fast"'s readable
// projection and each rank's projection on the sharded exact path.
// Semantics and operation order follow `project_splats_reference` in
// ops/projection.py, which the tests hold to the JAX function.
//
// What bounds it on Hopper: device-memory bandwidth. Each splat reads 236 B
// with f32 SH (means 12, cov3d 24, opacity and upload time 8, SH 192; 140 B
// with bf16 SH) and writes 77 B (valid 1, image_pos 8, conic 12, colour 16,
// depth16 4, rect 16, num_tiles 4, radius 4, pos 12); the arithmetic (~400
// flops, a few divides, square roots and one pow) is far below the card's
// compute rate.
//
// Design: one thread per splat. A splat's SH row is read with 16-byte
// vector loads (12 for f32, 6 for bf16), so a warp reads one contiguous
// span; every output is written in the (P, k) layout its consumer reads.
// The frame's uniforms are staged in shared memory once per block.
//
// Precision: built with --fmad=false and without fast-math, so every
// product and sum rounds on its own exactly like the plain version's
// separate torch ops, in the same order; divides and square roots are
// IEEE, and exp, log and pow are the same library functions torch's CUDA
// kernels call. The kernel is held bit-equal to its plain version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// NaN-propagating clamps and maximum, as torch.clamp / torch.maximum.
__device__ __forceinline__ float cmax(float x, float lo) {
  return (x != x) ? x : (x < lo ? lo : x);
}
__device__ __forceinline__ float cmin(float x, float hi) {
  return (x != x) ? x : (x > hi ? hi : x);
}
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return cmin(cmax(x, lo), hi);
}
__device__ __forceinline__ float nanmax(float a, float b) {
  return (a != a || b != b) ? (a + b) : (a > b ? a : b);
}
__device__ __forceinline__ float ease(float x) {
  const float a = 1.0f - x;
  return 1.0f - a * a * a;
}

__device__ __forceinline__ void load_sh(const float* sh, int i, float* co) {
  const float4* p = reinterpret_cast<const float4*>(sh + (size_t)i * 48);
#pragma unroll
  for (int j = 0; j < 12; ++j) {
    const float4 v = p[j];
    co[4 * j + 0] = v.x;
    co[4 * j + 1] = v.y;
    co[4 * j + 2] = v.z;
    co[4 * j + 3] = v.w;
  }
}

__device__ __forceinline__ void load_sh(const __nv_bfloat16* sh, int i,
                                        float* co) {
  const uint4* p = reinterpret_cast<const uint4*>(sh + (size_t)i * 48);
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    const uint4 v = p[j];
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      co[8 * j + 2 * k + 0] = __uint_as_float(w[k] << 16);
      co[8 * j + 2 * k + 1] = __uint_as_float(w[k] & 0xFFFF0000u);
    }
  }
}

struct Params {
  int P, gx, gy, ts, sh_degree, jq_quirk;
  float w, h;
};

// uniforms in shared memory: view (16, row-major), proj (16), camera_pos
// (3), model_scale, time
constexpr int NU = 37;

template <typename SH>
__global__ void __launch_bounds__(256)
project_readable_kernel(const float* __restrict__ view,
                        const float* __restrict__ proj,
                        const float* __restrict__ cam,
                        const float* __restrict__ mscale,
                        const float* __restrict__ time,
                        const float* __restrict__ means,
                        const float* __restrict__ cov,
                        const float* __restrict__ opac,
                        const float* __restrict__ utime,
                        const SH* __restrict__ sh,
                        uint8_t* __restrict__ valid_o,
                        float* __restrict__ ipos_o,
                        float* __restrict__ conic_o,
                        float* __restrict__ color_o,
                        int* __restrict__ depth_o, int* __restrict__ rect_o,
                        int* __restrict__ nt_o, float* __restrict__ radius_o,
                        float* __restrict__ pos_o, Params p) {
  __shared__ float u[NU];
  if (threadIdx.x < 16) u[threadIdx.x] = view[threadIdx.x];
  else if (threadIdx.x < 32) u[threadIdx.x] = proj[threadIdx.x - 16];
  else if (threadIdx.x < 35) u[threadIdx.x] = cam[threadIdx.x - 32];
  else if (threadIdx.x == 35) u[35] = mscale[0];
  else if (threadIdx.x == 36) u[36] = time[0];
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.P) return;
  const float* V = u;        // view, row-major
  const float* Q = u + 16;   // proj, row-major
  const float ms = u[35];

  // world/view/clip transforms
  const float spx = means[3 * i + 0] * ms;
  const float spy = means[3 * i + 1] * ms;
  const float spz = means[3 * i + 2] * ms;
  const float vpx = V[0] * spx + V[1] * spy + V[2] * spz + V[3];
  const float vpy = V[4] * spx + V[5] * spy + V[6] * spz + V[7];
  const float vpz = V[8] * spx + V[9] * spy + V[10] * spz + V[11];
  const float clx = Q[0] * vpx + Q[1] * vpy + Q[2] * vpz + Q[3];
  const float cly = Q[4] * vpx + Q[5] * vpy + Q[6] * vpz + Q[7];
  const float clz = Q[8] * vpx + Q[9] * vpy + Q[10] * vpz + Q[11];
  const float clw = Q[12] * vpx + Q[13] * vpy + Q[14] * vpz + Q[15];

  // frustum cull with the margin, z in [0, w]
  const float bound = clw * 1.2f;
  const bool inside = (clx >= -bound) && (clx <= bound) && (cly >= -bound) &&
                      (cly <= bound) && (clz >= 0.0f) && (clz <= clw);

  // load fade-in
  const float st = u[36] - utime[i];
  const float tf = ease(clampf(st, 0.0f, 1.0f));
  const float tfl = ease(clampf(st - 0.35f, 0.0f, 1.0f));
  const float sop = opac[i] * tfl * tfl;
  const float sscale = ms * (2.0f - tfl);

  // EWA 2D covariance
  const float s2 = sscale * sscale;
  const float xx = cov[6 * i + 0] * s2, xy = cov[6 * i + 1] * s2;
  const float xz = cov[6 * i + 2] * s2, yy = cov[6 * i + 3] * s2;
  const float yz = cov[6 * i + 4] * s2, zz = cov[6 * i + 5] * s2;
  const float focx = (p.w * 0.5f) * Q[0];
  const float focy = (p.h * 0.5f) * Q[5];
  const float limx = (1.0f / Q[0]) * 1.3f;
  const float limy = (1.0f / Q[5]) * 1.3f;
  const float z_inv = 1.0f / vpz;
  const float fzx = focx * z_inv;
  const float fzy = focy * z_inv;
  const float mx = clampf(vpx * z_inv, -limx, limx);
  const float my = clampf(vpy * z_inv, -limy, limy);
  const float jq = p.jq_quirk ? fzy : fzx;
  const float njm = -jq * mx;
  const float nfm = -fzy * my;
  const float b0x = V[0] * fzx + V[8] * njm;
  const float b0y = V[1] * fzx + V[9] * njm;
  const float b0z = V[2] * fzx + V[10] * njm;
  const float b1x = V[4] * fzy + V[8] * nfm;
  const float b1y = V[5] * fzy + V[9] * nfm;
  const float b1z = V[6] * fzy + V[10] * nfm;
  const float s0x = xx * b0x + xy * b0y + xz * b0z;
  const float s0y = xy * b0x + yy * b0y + yz * b0z;
  const float s0z = xz * b0x + yz * b0y + zz * b0z;
  const float s1x = xx * b1x + xy * b1y + xz * b1z;
  const float s1y = xy * b1x + yy * b1y + yz * b1z;
  const float s1z = xz * b1x + yz * b1y + zz * b1z;
  const float cov_a = b0x * s0x + b0y * s0y + b0z * s0z + 0.3f;
  const float cov_b = b1x * s0x + b1y * s0y + b1z * s0z;
  const float cov_c = b1x * s1x + b1y * s1y + b1z * s1z + 0.3f;
  const float det = cov_a * cov_c - cov_b * cov_b;
  const bool nonsingular = det != 0.0f;
  const float mid = 0.5f * (cov_a + cov_c);
  const float disc = sqrtf(cmax(mid * mid - det, 0.1f));
  const float lam1 = mid + disc;
  const float lam2 = mid - disc;
  const bool eig_ok = (lam1 >= 0.0f) && (lam2 >= 0.0f);

  // image position with the load slide-in
  const float safe_w = (clw == 0.0f) ? 1.0f : clw;
  const float ndcx = clx / safe_w;
  const float ndcy = cly / safe_w;
  const float ndcz = clz / safe_w;
  const float ix = ((ndcx + 1.0f) * 0.5f - (1.0f - tf)) * (p.w - 1.0f);
  const float iy = ((ndcy + 1.0f) * 0.5f - 0.75f * (1.0f - tf)) * (p.h - 1.0f);

  // opacity-biased radius and tile rect
  const float radius =
      powf(cmax(sop, 0.0f), 0.2f) * 2.5f * sqrtf(nanmax(lam1, lam2));
  const float ts = (float)p.ts;
  const float gxf = (float)p.gx, gyf = (float)p.gy;
  const int lox = (int)clampf((ix - radius) / ts, 0.0f, gxf);
  const int loy = (int)clampf((iy - radius) / ts, 0.0f, gyf);
  const int hix = (int)clampf(ceilf((ix + radius) / ts), 0.0f, gxf);
  const int hiy = (int)clampf(ceilf((iy + radius) / ts), 0.0f, gyf);
  const int nt = max(hix - lox, 0) * max(hiy - loy, 0);
  const bool valid = inside && nonsingular && eig_ok && (nt > 0);

  // depth key: ndc.z^3 quantised to 16 bits, 0xFFFF reserved
  const float z3 = ndcz * ndcz * ndcz;
  const int depth16 = min((int)((long long)(z3 * 65535.0f) & 0xFFFF), 0xFFFE);

  // SH colour
  const float dx = spx - u[32], dy = spy - u[33], dz = spz - u[34];
  const float nrm = cmax(sqrtf(dx * dx + dy * dy + dz * dz), 1e-12f);
  const float x = dx / nrm, y = dy / nrm, z = dz / nrm;
  float co[48];
  load_sh(sh, i, co);
  const float C0 = (float)0.28209479177387814;
  const float C1 = (float)0.4886025119029199;
  const float C20 = (float)1.0925484305920792, C21 = (float)1.0925484305920792;
  const float C22 = (float)0.31539156525252005, C23 = (float)1.0925484305920792;
  const float C24 = (float)0.5462742152960396;
  const float C30 = (float)0.5900435899266435, C31 = (float)2.890611442640554;
  const float C32 = (float)0.4570457994644658, C33 = (float)0.3731763325901154;
  const float C34 = (float)0.4570457994644658, C35 = (float)1.445305721320277;
  const float C36 = (float)0.5900435899266435;
  const float xx2 = x * x, yy2 = y * y, zz2 = z * z;
  const float xy2 = x * y, yz2 = y * z, xz2 = x * z;
  float rgb[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float* k = co + c;   // coefficient j of channel c: k[3 * j]
    float v = 0.5f + k[0] * C0;
    if (p.sh_degree >= 1) {
      v = v - k[3] * (C1 * y) + k[6] * (C1 * z) - k[9] * (C1 * x);
    }
    if (p.sh_degree >= 2) {
      v = v + k[12] * (C20 * xy2) - k[15] * (C21 * yz2) +
          k[18] * (C22 * (2.0f * zz2 - xx2 - yy2)) - k[21] * (C23 * xz2) +
          k[24] * (C24 * (xx2 - yy2));
    }
    if (p.sh_degree >= 3) {
      v = v - k[27] * (C30 * y * (3.0f * xx2 - yy2)) +
          k[30] * (C31 * x * yz2) -
          k[33] * (C32 * y * (4.0f * zz2 - xx2 - yy2)) +
          k[36] * (C33 * z * (2.0f * zz2 - 3.0f * xx2 - 3.0f * yy2)) -
          k[39] * (C34 * x * (4.0f * zz2 - xx2 - yy2)) +
          k[42] * (C35 * z * (xx2 - yy2)) -
          k[45] * (C36 * x * (xx2 - 3.0f * yy2));
    }
    rgb[c] = cmax(v, 0.0f);
  }

  // conic = inverse 2D covariance, [c, -b, a] / det
  const float safe_det = (det == 0.0f) ? 1.0f : det;

  valid_o[i] = valid ? 1 : 0;
  reinterpret_cast<float2*>(ipos_o)[i] = make_float2(ix, iy);
  conic_o[3 * i + 0] = cov_c / safe_det;
  conic_o[3 * i + 1] = -cov_b / safe_det;
  conic_o[3 * i + 2] = cov_a / safe_det;
  reinterpret_cast<float4*>(color_o)[i] =
      make_float4(rgb[0], rgb[1], rgb[2], sop);
  depth_o[i] = depth16;
  reinterpret_cast<int4*>(rect_o)[i] = make_int4(lox, loy, hix, hiy);
  nt_o[i] = valid ? nt : 0;
  radius_o[i] = radius;
  pos_o[3 * i + 0] = spx;
  pos_o[3 * i + 1] = spy;
  pos_o[3 * i + 2] = spz;
}

}  // namespace

// sh_bf16: 0 for (P, 16, 3) f32 SH, 1 for (P, 16, 3) bf16.
extern "C" int gs_project_readable(
    const void* view, const void* proj, const void* cam, const void* mscale,
    const void* time, const void* means, const void* cov, const void* opacity,
    const void* upload_time, const void* sh, void* valid, void* image_pos,
    void* conic, void* color, void* depth16, void* rect, void* num_tiles,
    void* radius, void* pos, int P, int sh_bf16, int gx, int gy, int ts,
    int sh_degree, int jq_quirk, float w, float h, void* stream) {
  if (P <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  Params p{P, gx, gy, ts, sh_degree, jq_quirk, w, h};
  const int threads = 256;
  const int blocks = (P + threads - 1) / threads;
#define GS_ARGS(T)                                                         \
  (const float*)view, (const float*)proj, (const float*)cam,               \
      (const float*)mscale, (const float*)time, (const float*)means,       \
      (const float*)cov, (const float*)opacity, (const float*)upload_time, \
      (const T*)sh, (uint8_t*)valid, (float*)image_pos, (float*)conic,     \
      (float*)color, (int*)depth16, (int*)rect, (int*)num_tiles,           \
      (float*)radius, (float*)pos, p
  if (sh_bf16)
    project_readable_kernel<__nv_bfloat16>
        <<<blocks, threads, 0, s>>>(GS_ARGS(__nv_bfloat16));
  else
    project_readable_kernel<float><<<blocks, threads, 0, s>>>(GS_ARGS(float));
#undef GS_ARGS
  return (int)cudaGetLastError();
}
