// Native splat preprocessor: PLY payload -> SoA arrays + covariance.
//
// The port's copy of godotgaussiansplatting_tpu/native/plyio.cpp, the same
// code: the reference does this per-splat swizzle in GDScript across a
// worker pool (ply_file.gd:28-77: exp/sigmoid transforms,
// quaternion->covariance, planar->interleaved SH); here it is C++ with
// std::thread fan-out feeding the host arrays that the loader copies to
// the card, through ctypes.
//
// Built at first use by godotgaussiansplatting_torch/native/__init__.py
// with g++ -O3 -march=native -fPIC -std=c++17 -pthread -shared into
// build/native/ at the repository root.

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

inline float bswap_f32(float v) {
  uint32_t u;
  std::memcpy(&u, &v, 4);
  u = __builtin_bswap32(u);
  std::memcpy(&v, &u, 4);
  return v;
}

struct PropIdx {
  // indices into the per-vertex property row; -1 when absent
  int32_t xyz[3];
  int32_t f_dc[3];
  int32_t f_rest0;   // first of 45 contiguous f_rest (or -1)
  int32_t opacity;
  int32_t scale[3];
  int32_t rot[4];    // stored order rot_0..rot_3 = (w, x, y, z)
};

}  // namespace

extern "C" {

// Swizzle [start, end) vertices of the raw payload into SoA outputs.
//   verts:   n * nprops float32 (host byte order unless big_endian)
//   means:   (n, 3)   cov6: (n, 6)  opacity: (n,)  sh: (n, 16, 3)
// Covariance = R S^2 R^T from exp(scale) and normalized quaternion
// (ply_file.gd:49-59); opacity = sigmoid(logit) (:62); SH planar 15R|15G|15B
// -> coeff-major RGB (:65-69).
void plyio_swizzle_range(const float* verts, int64_t n, int32_t nprops,
                         int32_t big_endian, const PropIdx* idx,
                         float* means, float* cov6, float* opacity, float* sh,
                         int64_t start, int64_t end) {
  const bool bs = big_endian != 0;
  for (int64_t i = start; i < end; ++i) {
    const float* v = verts + i * nprops;
    auto get = [&](int32_t p) -> float {
      float f = v[p];
      return bs ? bswap_f32(f) : f;
    };

    for (int k = 0; k < 3; ++k) means[i * 3 + k] = get(idx->xyz[k]);

    // scales (log -> linear) and quaternion (w,x,y,z stored)
    const float sx = std::exp(get(idx->scale[0]));
    const float sy = std::exp(get(idx->scale[1]));
    const float sz = std::exp(get(idx->scale[2]));
    float qw = get(idx->rot[0]), qx = get(idx->rot[1]);
    float qy = get(idx->rot[2]), qz = get(idx->rot[3]);
    const float qn = std::sqrt(qw * qw + qx * qx + qy * qy + qz * qz);
    if (qn > 1e-12f) {
      qw /= qn; qx /= qn; qy /= qn; qz /= qn;
    }
    // R rows
    const float r00 = 1 - 2 * (qy * qy + qz * qz);
    const float r01 = 2 * (qx * qy - qw * qz);
    const float r02 = 2 * (qx * qz + qw * qy);
    const float r10 = 2 * (qx * qy + qw * qz);
    const float r11 = 1 - 2 * (qx * qx + qz * qz);
    const float r12 = 2 * (qy * qz - qw * qx);
    const float r20 = 2 * (qx * qz - qw * qy);
    const float r21 = 2 * (qy * qz + qw * qx);
    const float r22 = 1 - 2 * (qx * qx + qy * qy);
    const float s2x = sx * sx, s2y = sy * sy, s2z = sz * sz;
    // cov = R S^2 R^T, upper triangle [xx, xy, xz, yy, yz, zz]
    cov6[i * 6 + 0] = r00 * r00 * s2x + r01 * r01 * s2y + r02 * r02 * s2z;
    cov6[i * 6 + 1] = r00 * r10 * s2x + r01 * r11 * s2y + r02 * r12 * s2z;
    cov6[i * 6 + 2] = r00 * r20 * s2x + r01 * r21 * s2y + r02 * r22 * s2z;
    cov6[i * 6 + 3] = r10 * r10 * s2x + r11 * r11 * s2y + r12 * r12 * s2z;
    cov6[i * 6 + 4] = r10 * r20 * s2x + r11 * r21 * s2y + r12 * r22 * s2z;
    cov6[i * 6 + 5] = r20 * r20 * s2x + r21 * r21 * s2y + r22 * r22 * s2z;

    opacity[i] = 1.0f / (1.0f + std::exp(-get(idx->opacity)));

    float* shi = sh + i * 48;
    for (int c = 0; c < 3; ++c) shi[c] = get(idx->f_dc[c]);
    if (idx->f_rest0 >= 0) {
      for (int k = 0; k < 15; ++k) {
        shi[3 + k * 3 + 0] = get(idx->f_rest0 + k);
        shi[3 + k * 3 + 1] = get(idx->f_rest0 + 15 + k);
        shi[3 + k * 3 + 2] = get(idx->f_rest0 + 30 + k);
      }
    } else {
      std::memset(shi + 3, 0, 45 * sizeof(float));
    }
  }
}

// Threaded whole-model swizzle; returns 0 on success.
int32_t plyio_swizzle(const float* verts, int64_t n, int32_t nprops,
                      int32_t big_endian, const PropIdx* idx,
                      float* means, float* cov6, float* opacity, float* sh,
                      int32_t nthreads) {
  if (nthreads <= 1 || n < 4096) {
    plyio_swizzle_range(verts, n, nprops, big_endian, idx, means, cov6,
                        opacity, sh, 0, n);
    return 0;
  }
  std::vector<std::thread> pool;
  const int64_t chunk = (n + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; ++t) {
    const int64_t lo = t * chunk;
    const int64_t hi = std::min<int64_t>(n, lo + chunk);
    if (lo >= hi) break;
    pool.emplace_back(plyio_swizzle_range, verts, n, nprops, big_endian, idx,
                      means, cov6, opacity, sh, lo, hi);
  }
  for (auto& th : pool) th.join();
  return 0;
}

// 3D Morton codes (10 bits/axis) for load-time clustering (ops/blocks.py).
void plyio_morton3(const float* means, int64_t n, uint64_t* codes,
                   int32_t nthreads) {
  float lo[3] = {1e30f, 1e30f, 1e30f}, hi[3] = {-1e30f, -1e30f, -1e30f};
  for (int64_t i = 0; i < n; ++i)
    for (int k = 0; k < 3; ++k) {
      const float v = means[i * 3 + k];
      if (v < lo[k]) lo[k] = v;
      if (v > hi[k]) hi[k] = v;
    }
  float span[3];
  for (int k = 0; k < 3; ++k)
    span[k] = std::max(hi[k] - lo[k], 1e-9f);

  auto spread = [](uint64_t x) {
    x &= 0x3FF;
    x = (x | (x << 16)) & 0x030000FFULL;
    x = (x | (x << 8)) & 0x0300F00FULL;
    x = (x | (x << 4)) & 0x030C30C3ULL;
    x = (x | (x << 2)) & 0x09249249ULL;
    return x;
  };
  auto work = [&](int64_t s, int64_t e) {
    for (int64_t i = s; i < e; ++i) {
      uint64_t q[3];
      for (int k = 0; k < 3; ++k) {
        float t = (means[i * 3 + k] - lo[k]) / span[k] * 1023.0f;
        if (t < 0) t = 0;
        if (t > 1023) t = 1023;
        q[k] = (uint64_t)t;
      }
      codes[i] = spread(q[0]) | (spread(q[1]) << 1) | (spread(q[2]) << 2);
    }
  };
  if (nthreads <= 1 || n < 4096) {
    work(0, n);
    return;
  }
  std::vector<std::thread> pool;
  const int64_t chunk = (n + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; ++t) {
    const int64_t s = t * chunk, e = std::min<int64_t>(n, s + chunk);
    if (s >= e) break;
    pool.emplace_back(work, s, e);
  }
  for (auto& th : pool) th.join();
}

}  // extern "C"
