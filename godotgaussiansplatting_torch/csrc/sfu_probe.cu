// Elementwise rate probe of the card's FMA and special-function pipes.
//
// Replaces the TPU kernel `kern` of benchmarks/vpu_probe.py (:34-49), which
// measured what one evaluation chain of the render kernels costs on the
// TPU's vector unit and whether bf16 evaluation pays. It computes what
// `kern` computes: out = sum over r < REP of body(x + r), in the body's
// dtype and in the order r = 0, 1, ..., over an (R, C) block, and repeats
// the whole block STEPS times (the TPU kernel's grid of STEPS steps that
// all write the same block). One thread owns one element (one
// __nv_bfloat162 pair for the bf16 bodies) and loops STEPS x REP times;
// the REP loop is unrolled, the STEPS loop is not.
//
// The compiler must not remove the work: each step recomputes the same
// values, and ptxas hoists loop-invariant code (an empty asm statement
// does not stop it: it is gone by then). So each step's input is
// x + 0 * (the previous step's sum), one FMA whose value is x (the sums
// are finite) but which ties every step to the one before: nothing is
// hoisted and no step is dead. cuobjdump -sass on the built library shows
// the instructions each body issues per element; sfu_probe.py prints them
// beside the rates and refuses a rate above a pipe's peak.
//
// The library is built, as every kernel of the port, with --fmad=false, so
// a product and a sum never fuse unless the source asks for it with
// __fmaf_rn. The bit-trick bodies spell every operation with its _rn
// intrinsic, so they do not depend on that flag; their plain versions in
// ops/render_v3.py match them bit for bit.
//
// What bounds it: no memory (each thread reads 4 bytes and writes 4), only
// the pipes. Per SM and clock the FP32 pipe retires 128 FFMA/FMUL/FADD and
// the special-function unit (MUFU: ex2, lg2, rcp, ...) 16, so a body that
// issues k MUFU per element cannot beat k / (16 x SMs x clock) seconds per
// element; conversions (F2I, I2F, FRND) run at a quarter rate as well.
// The rates and shares are reported by `python3 -m
// godotgaussiansplatting_torch.sfu_probe` and chip_smoke.py phase 9.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int THREADS = 256;
constexpr int REP = 16;

// The bodies; sfu_probe.BODIES lists the same ids with their plain
// versions. Bodies below FIRST_BF16 are f32, one element a thread; the
// others are bf16, one __nv_bfloat162 pair a thread.
enum Body {
  FMA_F32 = 0,        // __fmaf_rn(v, 1.0001, 0.25)
  FMA_F32_MUL_ADD,    // __fmul_rn then __fadd_rn (what --fmad=false emits)
  EXPF_F32,           // expf (precise)
  EXPF_SFU_F32,       // __expf
  FEXP_F32,           // render_pallas3.fexp, bit for bit
  CHAIN_FEXP_F32,     // vpu_probe's eval chain: fexp, fln_one_minus, fexp
  CHAIN_SFU_F32,      // the render kernels' chain: __expf, __logf, __expf
  POWER6_FMA_F32,     // the six-term power, contracted
  POWER6_MUL_ADD_F32, // the six-term power, uncontracted
  FIRST_BF16,
  FMA_BF16X2 = FIRST_BF16,  // __hfma2(v, 1.0001, 0.25)
  H2EXP_BF16X2,             // h2exp
  EX2_BF16X2,               // ex2.approx.ftz.bf16x2 of v * log2(e)
  CHAIN_BF16X2,             // h2exp, h2log(1 - a), h2exp
  NUM_BODIES
};

// f32 constants, written as the shortest decimals of the f32 values that
// render_pallas3.py's Python floats round to (so both sides hold the same
// bits): _EXP2_C, _LN_C, _LOG2E, _LN2, 4/3, ALPHA_MAX.
constexpr float C0 = 0.99995136f, C1 = 0.69325304f, C2 = 0.24225698f,
                C3 = 0.055029266f;
constexpr float B0 = 0.9999992f, B1 = -0.49946234f, B2 = 0.33293974f,
                B3 = -0.27221653f, B4 = 0.21837367f;
constexpr float LOG2E = 1.442695f, LN2 = 0.6931472f;
constexpr float FOUR_THIRDS = 1.3333334f;
constexpr float ALPHA_MAX = 0.99994f;
// The six power features (constant; the five pixel terms all take the
// element's value, so nothing folds and nothing is shared).
constexpr float F0 = -0.5f, F1 = 0.01f, F2 = -0.02f, F3 = -0.003f,
                F4 = 0.004f, F5 = 0.001f;

// render_pallas3.fexp: clamp to [-87, 80], x * log2(e) = n + f with n
// rounded half to even, 2^f by a cubic, n added to the exponent bits.
__device__ __forceinline__ float fexp_bits(float x) {
  const float y = __fmul_rn(fminf(fmaxf(x, -87.0f), 80.0f), LOG2E);
  const float yn = rintf(y);
  const float f = __fsub_rn(y, yn);
  const float p = __fadd_rn(
      C0, __fmul_rn(f, __fadd_rn(C1, __fmul_rn(f, __fadd_rn(
                                                     C2, __fmul_rn(f, C3))))));
  const uint32_t n = (uint32_t)(int)yn;
  return __uint_as_float(__float_as_uint(p) + (n << 23));
}

// render_pallas3.fln_one_minus: log(1 - a) from the exponent and a
// degree-5 polynomial on the mantissa in [2/3, 4/3).
__device__ __forceinline__ float fln1m_bits(float a) {
  const float u = __fsub_rn(1.0f, a);
  const int bits = __float_as_int(u);
  const int e = (bits >> 23) - 127;
  float m = __int_as_float((bits & 0x7FFFFF) | 0x3F800000);
  const bool adj = m > FOUR_THIRDS;
  m = adj ? __fmul_rn(m, 0.5f) : m;
  const float ef = (float)(e + (adj ? 1 : 0));
  const float t = __fsub_rn(m, 1.0f);
  const float p = __fmul_rn(
      t, __fadd_rn(B0, __fmul_rn(t, __fadd_rn(B1, __fmul_rn(t, __fadd_rn(
          B2, __fmul_rn(t, __fadd_rn(B3, __fmul_rn(t, B4)))))))));
  return __fadd_rn(__fmul_rn(ef, LN2), p);
}

template <int B>
__device__ __forceinline__ float body_f32(float v) {
  if constexpr (B == FMA_F32) return __fmaf_rn(v, 1.0001f, 0.25f);
  if constexpr (B == FMA_F32_MUL_ADD)
    return __fadd_rn(__fmul_rn(v, 1.0001f), 0.25f);
  if constexpr (B == EXPF_F32) return expf(v);
  if constexpr (B == EXPF_SFU_F32) return __expf(v);
  if constexpr (B == FEXP_F32) return fexp_bits(v);
  if constexpr (B == CHAIN_FEXP_F32) {
    const float a = fminf(fexp_bits(v), ALPHA_MAX);
    return __fadd_rn(fexp_bits(__fmul_rn(fln1m_bits(a), 0.5f)), a);
  }
  if constexpr (B == CHAIN_SFU_F32) {  // render_tile.cuh:292-302
    const float a = fminf(__expf(v), ALPHA_MAX);
    const float la = __logf(__fsub_rn(1.0f, a));
    return __fadd_rn(__expf(__fmul_rn(la, 0.5f)), a);
  }
  if constexpr (B == POWER6_FMA_F32)
    return __fmaf_rn(v, F5, __fmaf_rn(v, F4, __fmaf_rn(v, F3, __fmaf_rn(
                                 v, F2, __fmaf_rn(v, F1, F0)))));
  // POWER6_MUL_ADD_F32: f0 + x*f1 + y*f2 + xx*f3 + yy*f4 + xy*f5 in order
  float p = __fadd_rn(F0, __fmul_rn(v, F1));
  p = __fadd_rn(p, __fmul_rn(v, F2));
  p = __fadd_rn(p, __fmul_rn(v, F3));
  p = __fadd_rn(p, __fmul_rn(v, F4));
  return __fadd_rn(p, __fmul_rn(v, F5));
}

__device__ __forceinline__ __nv_bfloat162 bf2(float f) {
  return __float2bfloat162_rn(f);
}

__device__ __forceinline__ __nv_bfloat162 ex2_bf16x2(__nv_bfloat162 v) {
  uint32_t in, out;
  memcpy(&in, &v, 4);
  asm("ex2.approx.ftz.bf16x2 %0, %1;" : "=r"(out) : "r"(in));
  __nv_bfloat162 r;
  memcpy(&r, &out, 4);
  return r;
}

template <int B>
__device__ __forceinline__ __nv_bfloat162 body_bf16x2(__nv_bfloat162 v) {
  if constexpr (B == FMA_BF16X2)
    return __hfma2(v, bf2(1.0001f), bf2(0.25f));
  if constexpr (B == H2EXP_BF16X2) return h2exp(v);
  if constexpr (B == EX2_BF16X2)
    return ex2_bf16x2(__hmul2(v, bf2(LOG2E)));
  // CHAIN_BF16X2: vpu_probe's bf16 chain with log(1 - a) for log1p(-a)
  const __nv_bfloat162 a = __hmin2(h2exp(v), bf2(0.996f));
  const __nv_bfloat162 la = h2log(__hsub2(bf2(1.0f), a));
  return __hadd2(h2exp(__hmul2(la, bf2(0.5f))), a);
}

template <int B>
__global__ void __launch_bounds__(THREADS)
probe_f32(const float* __restrict__ x, float* __restrict__ out, int n,
          int steps) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const float x0 = x[i];
  float acc = 0.0f;
#pragma unroll 1
  for (int s = 0; s < steps; ++s) {
    const float v = __fmaf_rn(acc, 0.0f, x0);  // x0, after the last step
    acc = 0.0f;
#pragma unroll
    for (int r = 0; r < REP; ++r)
      acc = __fadd_rn(acc, body_f32<B>(__fadd_rn(v, (float)r)));
  }
  out[i] = acc;
}

template <int B>
__global__ void __launch_bounds__(THREADS)
probe_bf16x2(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
             int n2, int steps) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n2) return;
  const uint32_t xb = x[i];
  __nv_bfloat162 x0, acc = bf2(0.0f);
  memcpy(&x0, &xb, 4);
#pragma unroll 1
  for (int s = 0; s < steps; ++s) {
    const __nv_bfloat162 v = __hfma2(acc, bf2(0.0f), x0);  // x0, as above
    acc = bf2(0.0f);
#pragma unroll
    for (int r = 0; r < REP; ++r)
      acc = __hadd2(acc, body_bf16x2<B>(__hadd2(v, bf2((float)r))));
  }
  uint32_t ob;
  memcpy(&ob, &acc, 4);
  out[i] = ob;
}

template <int B>
cudaError_t launch(const void* x, void* out, int n, int steps,
                   cudaStream_t st) {
  if constexpr (B < FIRST_BF16) {
    probe_f32<B><<<(n + THREADS - 1) / THREADS, THREADS, 0, st>>>(
        (const float*)x, (float*)out, n, steps);
  } else {
    const int n2 = n / 2;
    probe_bf16x2<B><<<(n2 + THREADS - 1) / THREADS, THREADS, 0, st>>>(
        (const uint32_t*)x, (uint32_t*)out, n2, steps);
  }
  return cudaGetLastError();
}

}  // namespace

// x, out: (R, C) f32 (dtype 0) or bf16 (dtype 1), C even for bf16; body_id
// one of Body, of that dtype; reps must be REP (16). Computes out = sum over
// r < reps of body(x + r), steps times over.
extern "C" int gs_sfu_probe(const void* x, void* out, int body_id, int dtype,
                            int R, int C, int steps, int reps, void* stream) {
  if (body_id < 0 || body_id >= NUM_BODIES || reps != REP || R <= 0 ||
      C <= 0 || steps < 1 || dtype != (body_id >= FIRST_BF16 ? 1 : 0) ||
      (dtype == 1 && C % 2 != 0))
    return (int)cudaErrorInvalidValue;
  const int n = R * C;
  cudaStream_t st = (cudaStream_t)stream;
  switch (body_id) {
    case FMA_F32: return (int)launch<FMA_F32>(x, out, n, steps, st);
    case FMA_F32_MUL_ADD:
      return (int)launch<FMA_F32_MUL_ADD>(x, out, n, steps, st);
    case EXPF_F32: return (int)launch<EXPF_F32>(x, out, n, steps, st);
    case EXPF_SFU_F32: return (int)launch<EXPF_SFU_F32>(x, out, n, steps, st);
    case FEXP_F32: return (int)launch<FEXP_F32>(x, out, n, steps, st);
    case CHAIN_FEXP_F32:
      return (int)launch<CHAIN_FEXP_F32>(x, out, n, steps, st);
    case CHAIN_SFU_F32:
      return (int)launch<CHAIN_SFU_F32>(x, out, n, steps, st);
    case POWER6_FMA_F32:
      return (int)launch<POWER6_FMA_F32>(x, out, n, steps, st);
    case POWER6_MUL_ADD_F32:
      return (int)launch<POWER6_MUL_ADD_F32>(x, out, n, steps, st);
    case FMA_BF16X2: return (int)launch<FMA_BF16X2>(x, out, n, steps, st);
    case H2EXP_BF16X2: return (int)launch<H2EXP_BF16X2>(x, out, n, steps, st);
    case EX2_BF16X2: return (int)launch<EX2_BF16X2>(x, out, n, steps, st);
    case CHAIN_BF16X2: return (int)launch<CHAIN_BF16X2>(x, out, n, steps, st);
  }
  return (int)cudaErrorInvalidValue;
}
