// GMM -> quantized frequency rows, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel hesic_tpu/codecs/pallas_pmf.py::_pmf_kernel
// (gmm_freq_pallas), and the det_steal that follows it there.
//
// For each (pair b, channel m, position p) it takes the K mixture
// components (sigma clamped >= 0.11, mu, w), evaluates the normal CDF at
// the S+1 grid edges e_s = (s - mm - 0.5) + c_m, s = 0..S, S = 2*mm+1,
// sums (cdf_s - cdf_{s-1}) * w over k in ascending order, clamps at 0,
// accumulates the row total in ascending s, and emits
// max(floor(pmf * 65536/total), 1) with the deficit (65536 - row sum)
// added to the first maximal bin.
//
// Bit-exactness: the chain must equal eager PyTorch (codecs/det_math.py)
// bit for bit, because encoder and decoder both rebuild these rows and the
// plain version is the reference on the card.  Every float operation is a
// single IEEE-rounded __fmul_rn/__fadd_rn/__fsub_rn in the same order as
// det_math, the file is compiled with -fmad=false, and the bit tricks of
// det_recip/det_exp use __float_as_int/__int_as_float.  No expf, erfcf,
// __frcp_rn or fast-math: the point is det_math's bits, not a better erfc.
//
// What bounds it on an H100: operations.  Each (b, k, m, p) evaluates
// det_std_cdf at S+1 edges, about 60 un-fused f32 operations each, so the
// main path's B=8, K=5, M=192, S=65, hw=1024 call is ~3.5e10 operations,
// ~1 ms at the card's ~33.5e12 un-fused f32 instructions/s, against
// ~0.12 ms to write its 409 MB of rows.  The design does the minimum of
// that work once: one thread owns one row (b, m, p), keeps the previous
// edge's K CDFs in registers (each edge is evaluated once, not twice),
// and keeps the row's S pmf values in shared memory so the quantization
// pass needs no recompute.  Threads of a block are consecutive positions
// p, so every load and every row store is coalesced.  Owning the whole
// row also lets the integer steal run in-kernel: the rematerialisation
// hazard that pushed it out of the TPU kernel cannot arise here.

#include <stdint.h>

#include "det_math.cuh"

namespace {

// sigma, mu: (B, K, M, hw) f32 (the heads' (B, K*M, h, w) NCHW output);
// w: (B, K, M, hw) when w_spatial else (B, K, M); center: (B, M) int32;
// freq: (B, M, S, hw) int32.  Grid (ceil(hw/T), M, B), T threads, dynamic
// shared memory S*T floats.
template <int K>
__global__ void gmm_freq_kernel(const float* __restrict__ sigma,
                                const float* __restrict__ mu,
                                const float* __restrict__ w,
                                const int32_t* __restrict__ center,
                                int32_t* __restrict__ freq, int M, int hw,
                                int mm, int w_spatial) {
  extern __shared__ float pmf_s[];
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const int m = blockIdx.y;
  const int b = blockIdx.z;
  if (p >= hw) return;
  const int S = 2 * mm + 1;
  const int T = blockDim.x;
  float* my = pmf_s + threadIdx.x;

  float mu_k[K], isc_k[K], w_k[K], prev[K];
  const float cen = static_cast<float>(center[b * M + m]);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int64_t idx = (static_cast<int64_t>(b * K + k) * M + m) * hw + p;
    mu_k[k] = mu[idx];
    isc_k[k] = det_recip(fmaxf(sigma[idx], kScaleMin));
    w_k[k] = w_spatial ? w[idx] : w[(b * K + k) * M + m];
  }
  const float e0 = __fadd_rn(__fsub_rn(static_cast<float>(-mm), 0.5f), cen);
#pragma unroll
  for (int k = 0; k < K; ++k)
    prev[k] = det_std_cdf(__fmul_rn(__fsub_rn(e0, mu_k[k]), isc_k[k]));

  float total = 0.0f;
  for (int s = 1; s <= S; ++s) {
    const float e = __fadd_rn(__fsub_rn(static_cast<float>(s - mm), 0.5f), cen);
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float cur = det_std_cdf(__fmul_rn(__fsub_rn(e, mu_k[k]), isc_k[k]));
      const float d = __fmul_rn(__fsub_rn(cur, prev[k]), w_k[k]);
      acc = k == 0 ? d : __fadd_rn(acc, d);
      prev[k] = cur;
    }
    const float pm = acc > 0.0f ? acc : 0.0f;
    my[(s - 1) * T] = pm;
    total = s == 1 ? pm : __fadd_rn(total, pm);
  }

  const float qscale = det_qscale(total);
  int32_t* row = freq + (static_cast<int64_t>(b) * M + m) * S * hw + p;
  int sum = 0, best = -1, amax = 0;
  for (int s = 0; s < S; ++s) {
    const int f = static_cast<int>(fmaxf(floorf(__fmul_rn(my[s * T], qscale)), 1.0f));
    row[static_cast<int64_t>(s) * hw] = f;
    sum += f;
    if (f > best) {
      best = f;
      amax = s;
    }
  }
  row[static_cast<int64_t>(amax) * hw] = best + (kTotal - sum);
}

constexpr int kThreads = 128;

template <int K>
int launch(const float* sigma, const float* mu, const float* w,
           const int32_t* center, int32_t* freq, int B, int M, int hw, int mm,
           int w_spatial, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * mm + 1) * kThreads;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        gmm_freq_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid((hw + kThreads - 1) / kThreads, M, B);
  gmm_freq_kernel<K><<<grid, kThreads, smem, stream>>>(
      sigma, mu, w, center, freq, M, hw, mm, w_spatial);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 = success); -1 for an
// unsupported mixture count.
int hesic_gmm_freq(const void* sigma, const void* mu, const void* w,
                   const void* center, void* freq, int B, int K, int M, int hw,
                   int mm, int w_spatial, void* stream) {
  const float* s = static_cast<const float*>(sigma);
  const float* u = static_cast<const float*>(mu);
  const float* ww = static_cast<const float*>(w);
  const int32_t* c = static_cast<const int32_t*>(center);
  int32_t* f = static_cast<int32_t*>(freq);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 1: return launch<1>(s, u, ww, c, f, B, M, hw, mm, w_spatial, st);
    case 2: return launch<2>(s, u, ww, c, f, B, M, hw, mm, w_spatial, st);
    case 3: return launch<3>(s, u, ww, c, f, B, M, hw, mm, w_spatial, st);
    case 4: return launch<4>(s, u, ww, c, f, B, M, hw, mm, w_spatial, st);
    case 5: return launch<5>(s, u, ww, c, f, B, M, hw, mm, w_spatial, st);
    case 6: return launch<6>(s, u, ww, c, f, B, M, hw, mm, w_spatial, st);
    case 7: return launch<7>(s, u, ww, c, f, B, M, hw, mm, w_spatial, st);
    case 8: return launch<8>(s, u, ww, c, f, B, M, hw, mm, w_spatial, st);
    default: return -1;
  }
}

}  // extern "C"
