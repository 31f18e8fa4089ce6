// Deterministic float32 math on the card: the chain of
// hesic_tpu_torch/codecs/det_math.py, bit for bit.
//
// Every float operation is a single IEEE-rounded __fmul_rn/__fadd_rn/
// __fsub_rn in det_math's order, and the bit tricks of det_recip/det_exp
// use __float_as_int/__int_as_float.  No expf, erfcf, __frcp_rn or
// fast-math: the point is det_math's bits, not a better erfc.  Files that
// include this header are compiled with -fmad=false (codecs/build.py), so
// nvcc contracts no mul+add around these calls either.

#pragma once

#include <cuda_runtime.h>

namespace {

// float32 constants as exact hex literals (the values np.float32 gives
// the JAX package's decimal constants), so no decimal rounding can differ
constexpr float kP = 0x1.4f740ap-2f;           // 0.3275911
constexpr float kA1 = 0x1.04f20cp-2f;          // 0.254829592
constexpr float kA2 = -0x1.23531cp-2f;         // -0.284496736
constexpr float kA3 = 0x1.6be1c6p+0f;          // 1.421413741
constexpr float kA4 = -0x1.7401c6p+0f;         // -1.453152027
constexpr float kA5 = 0x1.0fb844p+0f;          // 1.061405429
constexpr float kInvSqrt2 = 0x1.6a09e6p-1f;    // 1/sqrt(2)
constexpr float kLog2e = 0x1.715476p+0f;       // log2(e)
constexpr float kLn2Hi = 0x1.63p-1f;           // 355/512
constexpr float kLn2Lo = -0x1.bd0106p-13f;     // ln2 - 355/512
constexpr float kC7 = 0x1.a01a02p-13f;         // 1/5040
constexpr float kC6 = 0x1.6c16c2p-10f;         // 1/720
constexpr float kC5 = 0x1.111112p-7f;          // 1/120
constexpr float kC4 = 0x1.555556p-5f;          // 1/24
constexpr float kC3 = 0x1.555556p-3f;          // 1/6
constexpr float kTiny = 0x1.4484cp-100f;       // 1e-30
constexpr float kScaleMin = 0x1.c28f5cp-4f;    // 0.11, the scale floor
constexpr int kTotal = 1 << 16;

__device__ __forceinline__ float det_recip(float d) {
  float x = __int_as_float(0x7EF311C3 - __float_as_int(d));
#pragma unroll
  for (int i = 0; i < 3; ++i) x = __fmul_rn(x, __fsub_rn(2.0f, __fmul_rn(d, x)));
  return x;
}

__device__ __forceinline__ float det_exp(float v) {
  const float k = floorf(__fadd_rn(__fmul_rn(v, kLog2e), 0.5f));
  const float r = __fsub_rn(__fsub_rn(v, __fmul_rn(k, kLn2Hi)),
                            __fmul_rn(k, kLn2Lo));
  // Taylor 1/n! for n = 7 down to 0, Horner in the order of det_math
  float p = kC7;
  p = __fadd_rn(__fmul_rn(p, r), kC6);
  p = __fadd_rn(__fmul_rn(p, r), kC5);
  p = __fadd_rn(__fmul_rn(p, r), kC4);
  p = __fadd_rn(__fmul_rn(p, r), kC3);
  p = __fadd_rn(__fmul_rn(p, r), 0.5f);
  p = __fadd_rn(__fmul_rn(p, r), 1.0f);
  p = __fadd_rn(__fmul_rn(p, r), 1.0f);
  const int ki = static_cast<int>(k);
  if (ki < -126) return 0.0f;
  const float scale = __int_as_float(
      static_cast<int>(static_cast<unsigned>(ki + 127) << 23));
  return __fmul_rn(p, scale);
}

__device__ __forceinline__ float det_std_cdf(float x) {
  const float z = fminf(__fmul_rn(fabsf(x), kInvSqrt2), 16.0f);
  const float t = det_recip(__fadd_rn(1.0f, __fmul_rn(kP, z)));
  float poly = __fmul_rn(t, kA5);
  poly = __fmul_rn(t, __fadd_rn(kA4, poly));
  poly = __fmul_rn(t, __fadd_rn(kA3, poly));
  poly = __fmul_rn(t, __fadd_rn(kA2, poly));
  poly = __fmul_rn(t, __fadd_rn(kA1, poly));
  const float erfc_z = __fmul_rn(poly, det_exp(__fmul_rn(-z, z)));
  return x >= 0.0f ? __fsub_rn(1.0f, __fmul_rn(0.5f, erfc_z))
                   : __fmul_rn(0.5f, erfc_z);
}

// 65536 / total with the deterministic reciprocal (det_math.det_qscale)
__device__ __forceinline__ float det_qscale(float total) {
  return __fmul_rn(65536.0f, det_recip(fmaxf(total, kTiny)));
}

}  // namespace
