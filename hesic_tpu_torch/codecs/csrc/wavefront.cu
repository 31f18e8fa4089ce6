// The wavefront level scan of the autoregressive codec, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel hesic_tpu/models/pallas_wavefront.py::
// _kernel and _kernel_nopost (ar_wavefront_pallas): the mbt2018/HESIC+
// raster recursion run as a wavefront over levels s = 3i + j.  Every
// mask-A context tap of pixel (i, j) lies at a smaller level, so all
// pixels of a level, of every image of the batch, are independent.
//
// One eye pass (hesic_ar_wavefront) launches two kernels per level:
//   (a) wavefront_params_kernel, direction-free: per row r = b*p_max + p
//       (pixel (i_min[s] + p, s - 3i) of image b), the 12 mask-A taps of
//       y_hat gathered from the NHWC buffer (0 outside the image, never
//       wrapping at the right edge), ctx = taps @ tapk + ctx_bias, then
//       the entropy-parameter MLP on cat(pre, ctx[, post]): two layers
//       with leaky_relu(0.01) and a linear one, giving (scales, means).
//       A block owns kRows rows for the whole chain (rows are independent
//       through it), with the gathered taps and every hidden layer in
//       shared memory; each product is a fixed-order sum, k ascending,
//       one __fmaf_rn per term: no atomics, no split of k.  Encode and
//       decode launch this same function on the same inputs, so the
//       parameters that drive the coder agree bit for bit.
//   (b) wavefront_coder_kernel: one thread per lane (r, mc) and channel
//       group g, channel m = g*Mg + mc.  It builds the PMF row over
//       the residual grid [-mm, mm] (A&S 7.1.26 Phi through det_math at
//       the edges (k - mm) - 0.5 over the scale), quantizes it to 2^16
//       (floor, min 1, deficit to the first maximal bin), then either
//       extracts the teacher interval of round_half_even(y - mean) clipped
//       to the grid (encode) or, for the lane's G groups in order, runs the
//       rANS decode transition with one renormalisation, reading
//       words[lane, count - 1] (decode; escape corrections override the
//       decoded residual).  y_hat = resid + mean
//       is written back for the next levels.  This chain is strict IEEE
//       (det_math.cuh, -fmad=false), so given equal (scales, means) it
//       builds rows bit-equal to the plain twin's.
//
// Layouts (the JAX package's): pre (B, hy, wy, P), post (B, hy, wy, Q) or
// none, y_true/corr/y_hat/resid (B, hy, wy, M), all NHWC; starts/freqs
// (T, L) with slot t = s*G + g and lane l = (b*p_max + p)*Mg + mc; words
// (L, cap); the rANS state and word pointer of each lane persist in
// x_st/p_st across levels.
//
// What bounds it on an H100: operations.  The products are
// 2*(12M*2M + Cin*H1 + H1*H2 + H2*2M) FLOP per pixel (4.6e10 for an eye
// with post at B=11, 32x32, M=192: ~0.7 ms at 67 TFLOP/s f32), plus the
// coder's ~2k un-fused operations per latent.  This first, simple design
// is far from that: a level holds only 121 rows, so the parameter kernel
// runs 61 blocks of 2 rows and each block streams all 8 MB of weights
// from L2 per level; 125 dependent levels cost 250 launches.  Not done
// here (later work): bf16 operands and wgmma, splitting a level's columns
// across a cluster, a persistent kernel with a grid barrier per level, or
// a CUDA graph over the launches.  The TPU kernel's ring buffer, level-major
// gather and one-hot word read were devices of its VMEM and vector unit:
// here y_hat lives whole in device memory (8.7 MB, L2-resident), pixels
// are indexed in place, and the word is a direct load.

#include <stdint.h>

#include "det_math.cuh"

namespace {

constexpr int kRows = 2;             // rows per parameter block
constexpr int kParamThreads = 160;   // x 4 columns: the widest layer, 640
constexpr int kUnroll = 8;           // k steps whose weight loads overlap
constexpr int kCoderThreads = 128;
constexpr int kMaxS = 65;            // grid half-width mm <= 32
constexpr uint32_t kRansL = 1u << 16;
constexpr float kSlope = 0x1.47ae14p-7f;  // 0.01, leaky_relu's slope

// out[r, n] = act(sum_k A[r, k] * W[k, n] + bias[n]) for the block's kRows
// rows (A in shared memory, row stride lda; W (K, N) row-major in device
// memory, N % 4 == 0), k ascending with one fused multiply-add per term;
// the bias is added after the sum, as the JAX program does.  Rows >=
// rows_out are not stored.  A thread owns 4 adjacent columns and reads
// their weights as one float4, kUnroll k at a time, one batch ahead of
// the multiply-adds that use them (register double buffer): every thread
// walks all k of the level's four products, so the time of the whole
// level scan is set by how many weight bytes each thread keeps in flight
// (with one scalar load per k, each thread waited on L2 most of the time).
__device__ void rows_gemm(const float* A, int lda, int K,
                          const float* __restrict__ W, int N,
                          const float* __restrict__ bias, bool leaky,
                          float* out, int ldo, int rows_out) {
  const int nv = N / 4;
  const float4* W4 = reinterpret_cast<const float4*>(W);
  for (int v0 = 0; v0 < nv; v0 += blockDim.x) {
    const int v = v0 + threadIdx.x;
    const bool ok = v < nv;
    float acc[kRows][4];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;
    }
    float4 w[kUnroll], wn[kUnroll];
    auto load = [&](int k0) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        wn[u] = (ok && k0 + u < K)
                    ? __ldg(W4 + static_cast<int64_t>(k0 + u) * nv + v)
                    : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    };
    load(0);
    for (int k0 = 0; k0 < K; k0 += kUnroll) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) w[u] = wn[u];
      if (k0 + kUnroll < K) load(k0 + kUnroll);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (k0 + u >= K) break;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float a = A[r * lda + k0 + u];
          acc[r][0] = __fmaf_rn(a, w[u].x, acc[r][0]);
          acc[r][1] = __fmaf_rn(a, w[u].y, acc[r][1]);
          acc[r][2] = __fmaf_rn(a, w[u].z, acc[r][2]);
          acc[r][3] = __fmaf_rn(a, w[u].w, acc[r][3]);
        }
      }
    }
    if (!ok) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = 4 * v + c;
      const float bq = bias[n];
      for (int r = 0; r < rows_out; ++r) {
        float x = __fadd_rn(acc[r][c], bq);
        if (leaky && x < 0.0f) x = __fmul_rn(x, kSlope);
        out[r * ldo + n] = x;
      }
    }
  }
}

// Row r of level s -> its pixel (b, i, j); false for rows past the level.
__device__ __forceinline__ bool row_pixel(int r, int p_max, int s, int lo,
                                          int cnt, int* b, int* i, int* j) {
  *b = r / p_max;
  const int p = r - *b * p_max;
  *i = lo + p;
  *j = s - 3 * *i;
  return p < cnt;
}

__global__ void __launch_bounds__(kParamThreads) wavefront_params_kernel(
    const float* yhat, const float* __restrict__ pre,
    const float* __restrict__ post, const float* __restrict__ tapk,
    const float* __restrict__ ctxb, const float* __restrict__ w0,
    const float* __restrict__ b0, const float* __restrict__ w1,
    const float* __restrict__ b1, const float* __restrict__ w2,
    const float* __restrict__ b2, float* __restrict__ g, int hy, int wy,
    int M, int P, int Q, int H1, int H2, int p_max, int R, int s, int lo,
    int cnt) {
  extern __shared__ float smem[];
  const int kc = 12 * M;
  const int cin = P + 2 * M + Q;
  float* a_ctx = smem;                 // kRows x 12M gathered taps
  float* feat = a_ctx + kRows * kc;    // kRows x cin: pre | ctx | post
  float* h1 = feat + kRows * cin;      // kRows x H1
  float* h2 = h1 + kRows * H1;         // kRows x H2
  const int r0 = blockIdx.x * kRows;

  for (int idx = threadIdx.x; idx < kRows * kc; idx += blockDim.x) {
    const int rr = idx / kc;
    const int k = idx - rr * kc;
    const int tap = k / M;
    const int c = k - tap * M;
    // ar_device._TAPS order: rows -2 and -1 (dj = -2..2), then (0, -2),
    // (0, -1)
    const int di = tap < 10 ? tap / 5 - 2 : 0;
    const int dj = tap < 10 ? tap % 5 - 2 : tap - 12;
    int b, i, j;
    float v = 0.0f;
    if (r0 + rr < R && row_pixel(r0 + rr, p_max, s, lo, cnt, &b, &i, &j)) {
      const int ii = i + di;
      const int jj = j + dj;
      if (ii >= 0 && jj >= 0 && jj < wy)
        v = yhat[((static_cast<int64_t>(b) * hy + ii) * wy + jj) * M + c];
    }
    a_ctx[idx] = v;
  }
  const int pq = P + Q;
  for (int idx = threadIdx.x; idx < kRows * pq; idx += blockDim.x) {
    const int rr = idx / pq;
    const int k = idx - rr * pq;
    int b, i, j;
    float v = 0.0f;
    if (r0 + rr < R && row_pixel(r0 + rr, p_max, s, lo, cnt, &b, &i, &j)) {
      const int64_t pix = (static_cast<int64_t>(b) * hy + i) * wy + j;
      v = k < P ? pre[pix * P + k] : post[pix * Q + (k - P)];
    }
    feat[rr * cin + (k < P ? k : k + 2 * M)] = v;
  }
  __syncthreads();
  rows_gemm(a_ctx, kc, kc, tapk, 2 * M, ctxb, false, feat + P, cin, kRows);
  __syncthreads();
  rows_gemm(feat, cin, cin, w0, H1, b0, true, h1, H1, kRows);
  __syncthreads();
  rows_gemm(h1, H1, H1, w1, H2, b1, true, h2, H2, kRows);
  __syncthreads();
  const int rows_out = R - r0 < kRows ? R - r0 : kRows;
  rows_gemm(h2, H2, H2, w2, 2 * M, b2, false,
            g + static_cast<int64_t>(r0) * 2 * M, 2 * M, rows_out);
}

// One thread per (lane, group): lanes of a block are kCoderThreads / G
// consecutive lanes, each with its G groups on consecutive threads.  Every
// thread builds its group's row; on encode it writes its teacher interval
// at once; on decode the lane's first thread then walks the G rows in
// order from shared memory (the rANS state chain is sequential per lane).
__global__ void __launch_bounds__(kCoderThreads) wavefront_coder_kernel(
    const float* __restrict__ g, const float* __restrict__ ytrue,
    const int32_t* __restrict__ cmask, const int32_t* __restrict__ cval,
    const int32_t* __restrict__ words, int64_t* __restrict__ x_st,
    int32_t* __restrict__ p_st, int32_t* __restrict__ starts,
    int32_t* __restrict__ freqs, float* __restrict__ yhat,
    int32_t* __restrict__ resid, int teacher, int hy, int wy, int M, int G,
    int mm, int cap, int p_max, int R, int s, int lo, int cnt) {
  __shared__ int rows_s[kCoderThreads][kMaxS];
  __shared__ float mean_s[kCoderThreads];
  const int mg = M / G;
  const int L = R * mg;
  const int gi = threadIdx.x % G;
  const int lane = blockIdx.x * (kCoderThreads / G) + threadIdx.x / G;
  const int r = lane / mg;
  const int mc = lane - r * mg;
  const int m = gi * mg + mc;
  const int S = 2 * mm + 1;
  int b, i, j;
  const bool valid =
      lane < L && row_pixel(r, p_max, s, lo, cnt, &b, &i, &j);
  const int64_t at = ((static_cast<int64_t>(b) * hy + i) * wy + j) * M + m;
  int* fq = rows_s[threadIdx.x];
  float mean = 0.0f;
  if (valid) {
    const float scale = fmaxf(g[static_cast<int64_t>(r) * 2 * M + m],
                              kScaleMin);
    mean = g[static_cast<int64_t>(r) * 2 * M + M + m];
    const float inv = det_recip(scale);
    float pmf[kMaxS];
    float prev = det_std_cdf(
        __fmul_rn(__fsub_rn(static_cast<float>(-mm), 0.5f), inv));
    float total = 0.0f;
    for (int k = 0; k < S; ++k) {
      const float cur = det_std_cdf(
          __fmul_rn(__fsub_rn(static_cast<float>(k + 1 - mm), 0.5f), inv));
      const float pk = fmaxf(__fsub_rn(cur, prev), 0.0f);
      pmf[k] = pk;
      total = k == 0 ? pk : __fadd_rn(total, pk);
      prev = cur;
    }
    const float qs = det_qscale(total);
    int sum = 0, best = -1, amax = 0;
    for (int k = 0; k < S; ++k) {
      const int f = static_cast<int>(fmaxf(floorf(__fmul_rn(pmf[k], qs)),
                                           1.0f));
      fq[k] = f;
      sum += f;
      if (f > best) {
        best = f;
        amax = k;
      }
    }
    fq[amax] += kTotal - sum;
  }

  if (teacher) {
    if (lane >= L) return;
    const int64_t slot = static_cast<int64_t>(s * G + gi) * L + lane;
    if (!valid) {
      starts[slot] = 0;
      freqs[slot] = 0;
      return;
    }
    const int res = static_cast<int>(rintf(__fsub_rn(ytrue[at], mean)));
    const int sym = (res < -mm ? -mm : (res > mm ? mm : res)) + mm;
    int start = 0;
    for (int k = 0; k < sym; ++k) start += fq[k];
    starts[slot] = start;
    freqs[slot] = fq[sym];
    yhat[at] = __fadd_rn(static_cast<float>(res), mean);
    resid[at] = res;
    return;
  }

  mean_s[threadIdx.x] = mean;
  __syncthreads();
  if (!valid || gi != 0) return;
  uint32_t x = static_cast<uint32_t>(x_st[lane]);
  int pw = p_st[lane];
  for (int gg = 0; gg < G; ++gg) {
    const int* row = rows_s[threadIdx.x + gg];
    // symbol = number of inclusive CDF entries <= cf (the last entry is
    // 2^16 > cf, so the bound only guards malformed rows)
    const uint32_t cf = x & 0xFFFFu;
    uint32_t start = 0;
    uint32_t f = static_cast<uint32_t>(row[0]);
    int sym = 0;
    while (sym < S - 1 && start + f <= cf) {
      start += f;
      ++sym;
      f = static_cast<uint32_t>(row[sym]);
    }
    uint32_t xn = f * (x >> 16) + cf - start;
    if (xn < kRansL) {
      int pr = pw - 1;
      pr = pr < 0 ? 0 : (pr > cap - 1 ? cap - 1 : pr);
      const int64_t wi = static_cast<int64_t>(lane) * cap + pr;
      xn = (xn << 16) | static_cast<uint32_t>(words[wi]);
      --pw;
    }
    x = xn;
    const int64_t at_g = at + gg * mg;  // channel gg*mg + mc
    const int res = cmask[at_g] ? cval[at_g] : sym - mm;
    yhat[at_g] = __fadd_rn(static_cast<float>(res), mean_s[threadIdx.x + gg]);
    resid[at_g] = res;
  }
  x_st[lane] = static_cast<int64_t>(x);
  p_st[lane] = pw;
}

}  // namespace

extern "C" {

// One eye pass over every level.  Returns the cudaError_t of the first
// failed launch (0 = success); -1 for an unsupported shape.
int hesic_ar_wavefront(const void* pre, const void* post, const void* ytrue,
                       const void* cmask, const void* cval, const void* words,
                       void* x_st, void* p_st, const void* tapk,
                       const void* ctxb, const void* w0, const void* b0,
                       const void* w1, const void* b1, const void* w2,
                       const void* b2, void* g, void* starts, void* freqs,
                       void* yhat, void* resid, int B, int hy, int wy, int M,
                       int P, int Q, int H1, int H2, int G, int mm, int cap,
                       int p_max, int teacher, void* stream) {
  if (M % G != 0 || kCoderThreads % G != 0 || 2 * mm + 1 > kMaxS ||
      mm < 0 || cap < 1 || M % 2 || H1 % 4 || H2 % 4)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem =
      sizeof(float) * kRows * (12 * M + P + 2 * M + Q + H1 + H2);
  cudaError_t e = cudaFuncSetAttribute(
      wavefront_params_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int R = B * p_max;
  const int L = R * (M / G);
  const int n_levels = 3 * (hy - 1) + (wy - 1) + 1;
  for (int s = 0; s < n_levels; ++s) {
    // ar_device.schedule: i from ceil((s - wy + 1) / 3) to min(hy-1, s/3)
    const int lo = s - (wy - 1) > 0 ? (s - (wy - 1) + 2) / 3 : 0;
    const int hi = s / 3 < hy - 1 ? s / 3 : hy - 1;
    const int cnt = hi - lo + 1;
    wavefront_params_kernel<<<(R + kRows - 1) / kRows, kParamThreads, smem,
                              st>>>(
        static_cast<const float*>(yhat), static_cast<const float*>(pre),
        static_cast<const float*>(post), static_cast<const float*>(tapk),
        static_cast<const float*>(ctxb), static_cast<const float*>(w0),
        static_cast<const float*>(b0), static_cast<const float*>(w1),
        static_cast<const float*>(b1), static_cast<const float*>(w2),
        static_cast<const float*>(b2), static_cast<float*>(g), hy, wy, M, P,
        Q, H1, H2, p_max, R, s, lo, cnt);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    const int lanes_per_block = kCoderThreads / G;
    wavefront_coder_kernel<<<(L + lanes_per_block - 1) / lanes_per_block,
                             kCoderThreads, 0, st>>>(
        static_cast<const float*>(g), static_cast<const float*>(ytrue),
        static_cast<const int32_t*>(cmask), static_cast<const int32_t*>(cval),
        static_cast<const int32_t*>(words), static_cast<int64_t*>(x_st),
        static_cast<int32_t*>(p_st), static_cast<int32_t*>(starts),
        static_cast<int32_t*>(freqs), static_cast<float*>(yhat),
        static_cast<int32_t*>(resid), teacher, hy, wy, M, G, mm, cap, p_max,
        R, s, lo, cnt);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

}  // extern "C"
