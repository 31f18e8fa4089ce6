// The wavefront level scan of the autoregressive codec, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel hesic_tpu/models/pallas_wavefront.py::
// _kernel and _kernel_nopost (ar_wavefront_pallas): the mbt2018/HESIC+
// raster recursion run as a wavefront over levels s = 3i + j.  Every
// mask-A context tap of pixel (i, j) lies at a smaller level, so all
// pixels of a level, of every image of the batch, are independent.
//
// One eye pass launches:
//   (h) hesic_ar_hoist, once: the scan-independent part of the entropy-
//       parameter MLP's first layer for every pixel of the batch,
//       base = pre @ w0[0:P] + post @ w0[P+2M:] + b0  (B*hy*wy, H1);
//   then hesic_ar_wavefront, per level s, five kernels on the level's
//   compacted rows r = b*cnt_s + p (pixel (i_min[s] + p, s - 3i) of image
//   b; R_s = B*cnt_s rows, no padding rows):
//   (1) ctx: the 12 mask-A taps of y_hat gathered from the NHWC buffer (0
//       outside the image, never wrapping at the right edge) times tapk
//       (12M, 2M), K split into chunks of whole taps;
//   (2) layer 0: A = ctx_bias + the ctx chunks' sum, times w0[P:P+2M];
//   (3) layer 1: A = leaky_relu(base[pixel] + the layer-0 chunks' sum),
//       times w1;
//   (4) layer 2: A = leaky_relu(b1 + the layer-1 chunks' sum), times w2,
//       plus b2: g = (scales, means), written to row b*p_max + p;
//   (5) wavefront_coder_kernel: one thread per lane (r, mc) and channel
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
// Stages (h) and (1)-(4) are one tiled SIMT f32 GEMM (stage_body), a
// kernel of its own name per stage: a block of 256 threads owns a
// kBM = 64-row x BN-column output tile and one chunk of K.  Per k-step,
// the copy engine (cp.async.bulk, one copy per row segment, completing on
// an mbarrier) brings A's sources into shared memory: the gathered tap
// rows, the pixel rows, or every chunk of the previous stage plus the
// base rows, which the block then sums in order; cp.async brings W's
// rows.  Four groups of 64 threads each take a quarter of the k-step
// with an 8 x BN/8 register tile per thread.
//
// Determinism, so that encode and decode get bit-equal g: every output is
// a fixed-order sum.  Within a block, each thread group sums its quarter
// of each k-step, k ascending, one __fmaf_rn per term, and the epilogue
// adds the four groups' sums in order 0..3.  The chunks of a stage are
// written to separate scratch slices and summed by the next stage in
// chunk order 0, 1, ..., then the bias (or base) is added.  There are no
// atomics and no reduction whose order depends on scheduling.  The
// partition (tile widths, chunks, k-steps) is fixed by the caller from
// the layer widths alone, never by the direction.  Encode and decode
// launch the same functions on the same inputs.
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
// coder's ~2k un-fused operations per latent.  What bounds this design is
// L2 bandwidth and launches.  A level holds at most 121 rows, so a 64-row
// tile reads each weight element at most twice per level (13 MB at
// M=192; the earlier design read all 8 MB of weights once per 2-row
// block, 0.5 GB).  But narrow column tiles, needed for ~100 blocks per
// launch, each read the whole A operand again, and a K-split stage makes
// the next stage read every chunk: about 100 MB of L2 reads per full
// level, whatever the tile plan.  125 dependent levels cost 625 launches.
// Not done here (later work): bf16 operands and wgmma, clusters sharing
// A tiles, a persistent kernel with a grid barrier per level, or a CUDA
// graph over the launches.  The TPU kernel's ring buffer, level-major
// gather and one-hot word read were devices of its VMEM and vector unit:
// here y_hat lives whole in device memory (8.7 MB, L2-resident), pixels
// are indexed in place, and the word is a direct load.

#include <stdint.h>

#include <initializer_list>

#include "det_math.cuh"

namespace {

constexpr int kBM = 64;              // rows per stage tile
constexpr int kThreads = 256;        // per stage block: kGroups x 64
constexpr int kGroups = 4;           // k-groups of a stage block
// dynamic shared memory a block may take: 227 KB less the row tables
constexpr int kMaxSmem = 226 * 1024;
constexpr int kCoderThreads = 128;
constexpr int kMaxS = 65;            // grid half-width mm <= 32
constexpr uint32_t kRansL = 1u << 16;
constexpr float kSlope = 0x1.47ae14p-7f;  // 0.01, leaky_relu's slope

// The compacted rows of level s: row r -> image b = r / cnt, p = r % cnt,
// pixel (lo + p, s - 3(lo + p)).
struct Level {
  int hy, wy, s, lo, cnt, p_max;
};

__device__ __forceinline__ int64_t level_pixel(const Level& lv, int r,
                                               int* b, int* i, int* j) {
  *b = r / lv.cnt;
  *i = lv.lo + (r - *b * lv.cnt);
  *j = lv.s - 3 * *i;
  return (static_cast<int64_t>(*b) * lv.hy + *i) * lv.wy + *j;
}

// Where a stage's A[r, k] comes from (rows of k in whole float4s).
enum OperandKind { kPixels = 0, kTaps = 1, kChunks = 2 };

struct Operand {
  // kPixels: row r is pixel r; k < split from a (row stride lda), else
  //          from a2 (row stride lda2) at k - split.
  // kTaps:   a is y_hat (B, hy, wy, lda = M); k = tap * M + c.
  // kChunks: sum over c < nsum of a[c * a_chunk + r * lda + k], then
  //          + add[k] (bias) or + add[pixel(r) * lda + k] (add_rows), then
  //          leaky_relu when leaky.
  const float* a;
  const float* a2;
  int lda, lda2, split, nsum;
  int64_t a_chunk;
  const float* add;
  int add_rows, leaky;
};

// Where a stage writes: out[chunk * chunk_stride + row * ldo + n] with
// row = r, or b*p_max + p when scatter; plus bias[n] when bias is set
// (single-chunk stages only).
struct Out {
  float* out;
  int64_t chunk_stride;
  int ldo;
  const float* bias;
  int scatter;
};

__device__ __forceinline__ float4 add4(float4 x, float4 y) {
  return make_float4(__fadd_rn(x.x, y.x), __fadd_rn(x.y, y.y),
                     __fadd_rn(x.z, y.z), __fadd_rn(x.w, y.w));
}

__device__ __forceinline__ float leaky1(float x) {
  return x < 0.0f ? __fmul_rn(x, kSlope) : x;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared without a register round trip; zeros when
// !valid (src is then not read, but must be a mapped address).
__device__ __forceinline__ void cp16(float* dst, const float* src,
                                     bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The tile fill's completion barrier (an mbarrier with one arrival per
// phase, plus the bytes the bulk copies bring).
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int phase) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra.uni DONE;\n"
      "bra.uni LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(phase)
      : "memory");
}

// `bytes` (a multiple of 16) global -> shared by the copy engine (TMA),
// completing on `bar`.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Orders this thread's earlier shared-memory accesses before later bulk
// copies into the same memory.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void lds(float (&dst)[N], const float* src) {
  if constexpr (N == 8) {
    const float4 x = *reinterpret_cast<const float4*>(src);
    const float4 y = *reinterpret_cast<const float4*>(src + 4);
    dst[0] = x.x; dst[1] = x.y; dst[2] = x.z; dst[3] = x.w;
    dst[4] = y.x; dst[5] = y.y; dst[6] = y.z; dst[7] = y.w;
  } else if constexpr (N == 4) {
    const float4 x = *reinterpret_cast<const float4*>(src);
    dst[0] = x.x; dst[1] = x.y; dst[2] = x.z; dst[3] = x.w;
  } else if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(src);
    dst[0] = x.x; dst[1] = x.y;
  } else {
    static_assert(N == 1, "register tile widths are 1, 2, 4 or 8");
    dst[0] = *src;
  }
}

// Calls f(rr, k4) for this thread's share of a kBM x kt tile, in float4
// steps: element idx = rr * (kt / 4) + k4 / 4 for idx = threadIdx.x,
// + kThreads, ...; the indices advance without a division.
template <typename F>
__device__ __forceinline__ void tile_elems(int kt, F&& f) {
  const int kq = kt / 4;
  int rr = threadIdx.x / kq;
  int k4 = 4 * (threadIdx.x - rr * kq);
  const int drr = kThreads / kq;
  const int dk4 = 4 * (kThreads - drr * kq);
  while (rr < kBM) {
    f(rr, k4);
    k4 += dk4;
    rr += drr;
    if (k4 >= kt) {
      k4 -= kt;
      ++rr;
    }
  }
}

__host__ __device__ __forceinline__ int stage_slices(int kind, int nsum,
                                                     int add_rows) {
  return kind == kChunks ? nsum + add_rows : 1;
}

__host__ __device__ __forceinline__ int stage_bias_row(int kind,
                                                       int add_rows, int kt) {
  return kind == kChunks && !add_rows ? kt + 4 : 0;
}

// Dynamic shared memory of a stage launch, in bytes: the k-step's tiles,
// or the k-groups' sums in the epilogue, whichever is larger.
size_t stage_smem(int kind, int nsum, int add_rows, int bn, int kt) {
  const size_t tiles =
      static_cast<size_t>(stage_slices(kind, nsum, add_rows)) * kBM *
          (kt + 4) +
      stage_bias_row(kind, add_rows, kt) + static_cast<size_t>(kt) * bn;
  const size_t sums = static_cast<size_t>(kGroups) * kBM * bn;
  return sizeof(float) * (tiles > sums ? tiles : sums);
}

// C[r, n] = sum over k of the block's chunk [z*kc, min(K, (z+1)*kc)) of
// A[r, k] * W[k, n]; W (K, N) row-major.  Block (x, y, z): columns
// [x*BN, +BN), rows [y*kBM, +kBM), chunk z.  Each k-step of kt columns of
// A (row-major, pitch kt + 4) and rows of W goes through shared memory.
// The block's 256 threads are kGroups k-groups of 64: group g sums the
// g-th quarter of every k-step, k ascending, one __fmaf_rn per term, in
// an 8 x BN/8 register tile per thread (rows ty + 8i: no bank conflicts);
// the epilogue adds the groups' sums in order 0..3.  A fixed order
// throughout.
template <int KIND, int BN>
__device__ __forceinline__ void stage_body(const Operand& op,
                                           const float* __restrict__ W,
                                           int K, int N, int kc, int kt,
                                           const Out& o, int R,
                                           const Level& lv) {
  constexpr int TM = 8;
  constexpr int TN = BN / 8;
  // shared memory: nslice A slices of kBM x lda (the sources of A, summed
  // into slice 0 for kChunks), a bias row Bs (kChunks without add_rows),
  // then W's kt x BN
  extern __shared__ float4 smem4[];
  const int lda = kt + 4;
  const int slice = kBM * lda;
  const int nslice = stage_slices(KIND, op.nsum, op.add_rows);
  float* As = reinterpret_cast<float*>(smem4);
  float* Bs = As + nslice * slice;
  float* Ws = Bs + stage_bias_row(KIND, op.add_rows, kt);
  // row_pix[rr]: the pixel of row r0 + rr (kPixels: r itself), -1 past
  // R; row_tap[rr] (kTaps): the offset in y_hat of the k-step's tap
  // neighbour (k0 % M folded in), -1 where it is zero
  __shared__ int row_pix[kBM];
  __shared__ int row_tap[kBM];
  __shared__ uint64_t bar;
  const int tid = threadIdx.x;
  const int gk = tid / 64;
  const int tx = tid % 8;          // columns tx*TN ..
  const int ty = (tid % 64) / 8;   // rows ty, ty + 8, ..
  const int r0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * BN;
  const int kb = blockIdx.z * kc;
  const int ke = min(K, kb + kc);
  int phase = 0;
  if (tid == 0) mbar_init(&bar);
  if (tid < kBM) {
    const int r = r0 + tid;
    int b, i, j;
    row_pix[tid] = r >= R ? -1
                   : KIND == kPixels
                       ? r
                       : static_cast<int>(level_pixel(lv, r, &b, &i, &j));
  }
  __syncthreads();
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int jn = 0; jn < TN; ++jn) acc[i][jn] = 0.0f;
  }
  for (int k0 = kb; k0 < ke; k0 += kt) {
    const int kn = min(kt, ke - k0);
    if constexpr (KIND == kTaps) {
      // the k-step lies within one tap (M % kt == 0)
      const int m = op.lda;
      const int tap = k0 / m;
      if (tid < kBM) {
        int b, i, j;
        int off = -1;
        if (r0 + tid < R) {
          level_pixel(lv, r0 + tid, &b, &i, &j);
          // ar_device.TAPS order: rows -2 and -1 (dj = -2..2), then
          // (0, -2), (0, -1)
          const int ii = i + (tap < 10 ? tap / 5 - 2 : 0);
          const int jj = j + (tap < 10 ? tap % 5 - 2 : tap - 12);
          if (ii >= 0 && jj >= 0 && jj < lv.wy)
            off = ((b * lv.hy + ii) * lv.wy + jj) * m + k0 - tap * m;
        }
        row_tap[tid] = off;
      }
      __syncthreads();
    }
    // fill: each row segment of each A slice is one bulk copy; a row
    // past R is left as it is (its outputs are never stored); a valid
    // row whose tap lies outside the image is zeroed
    if (tid == 0) {
      int rows = 0;
      for (int rr = 0; rr < kBM; ++rr)
        rows += (KIND == kTaps ? row_tap[rr] : row_pix[rr]) >= 0;
      mbar_expect(&bar, 4u * rows * nslice * kn);
    }
    fence_async_smem();
    __syncthreads();
    for (int t = tid; t < nslice * kBM; t += kThreads) {
      const int c = t / kBM;
      const int rr = t - c * kBM;
      const int r = r0 + rr;
      float* dst = As + c * slice + rr * lda;
      if constexpr (KIND == kPixels) {
        if (row_pix[rr] < 0) continue;
        const int na = max(0, min(kn, op.split - k0));   // from a
        if (na) bulk_copy(dst, op.a + r * op.lda + k0, 4 * na, &bar);
        if (kn > na)
          bulk_copy(dst + na, op.a2 + r * op.lda2 + k0 + na - op.split,
                    4 * (kn - na), &bar);
      } else if constexpr (KIND == kTaps) {
        if (row_tap[rr] >= 0)
          bulk_copy(dst, op.a + row_tap[rr], 4 * kn, &bar);
      } else {
        if (row_pix[rr] < 0) continue;
        bulk_copy(dst,
                  c < op.nsum ? op.a + c * op.a_chunk + r * op.lda + k0
                              : op.add + row_pix[rr] * op.lda + k0,
                  4 * kn, &bar);
      }
    }
    if constexpr (KIND == kTaps) {
      tile_elems(kt, [&](int rr, int k4) {
        if (row_pix[rr] >= 0 && row_tap[rr] < 0)
          *reinterpret_cast<float4*>(As + rr * lda + k4) =
              make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      });
    }
    if (KIND == kChunks && !op.add_rows) {
      for (int k4 = 4 * tid; k4 < kt; k4 += 4 * kThreads)
        cp16(Bs + k4, k4 < kn ? op.add + k0 + k4 : op.add, k4 < kn);
    }
    for (int idx = tid; idx < kt * (BN / 4); idx += kThreads) {
      const int kk = idx / (BN / 4);
      const int n4 = 4 * (idx - kk * (BN / 4));
      const bool ok = kk < kn && n0 + n4 < N;
      cp16(Ws + kk * BN + n4,
           ok ? W + static_cast<int64_t>(k0 + kk) * N + n0 + n4 : W, ok);
    }
    cp_wait_all();
    mbar_wait(&bar, phase);
    phase ^= 1;
    __syncthreads();
    if constexpr (KIND == kChunks) {
      // A = act(chunk 0 + chunk 1 + ... + add), in that order, into
      // slice 0
      tile_elems(kt, [&](int rr, int k4) {
        float4* dst = reinterpret_cast<float4*>(As + rr * lda + k4);
        float4 v = *dst;
        for (int c = 1; c < op.nsum; ++c)
          v = add4(v, dst[c * slice / 4]);
        v = add4(v, op.add_rows ? dst[op.nsum * slice / 4]
                                : *reinterpret_cast<const float4*>(Bs + k4));
        if (op.leaky) {
          v.x = leaky1(v.x);
          v.y = leaky1(v.y);
          v.z = leaky1(v.z);
          v.w = leaky1(v.w);
        }
        *dst = v;
      });
      __syncthreads();
    }
    const int q = kn / kGroups;   // a multiple of 4
    for (int kk = gk * q; kk < (gk + 1) * q; kk += 4) {
      float4 a4[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        a4[i] = *reinterpret_cast<const float4*>(As + (ty + 8 * i) * lda +
                                                 kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float w[TN];
        lds(w, Ws + (kk + u) * BN + tx * TN);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float a = u == 0 ? a4[i].x
                        : u == 1 ? a4[i].y
                        : u == 2 ? a4[i].z : a4[i].w;
#pragma unroll
          for (int jn = 0; jn < TN; ++jn)
            acc[i][jn] = __fmaf_rn(a, w[jn], acc[i][jn]);
        }
      }
    }
    __syncthreads();
  }
  // the k-groups' sums, added in group order
  float* sums = As;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int jn = 0; jn < TN; ++jn)
      sums[(gk * kBM + ty + 8 * i) * BN + tx * TN + jn] = acc[i][jn];
  }
  __syncthreads();
  float* out = o.out + blockIdx.z * o.chunk_stride;
  for (int idx = tid; idx < kBM * BN; idx += kThreads) {
    const int rr = idx / BN;
    const int n = n0 + idx - rr * BN;
    const int r = r0 + rr;
    if (r >= R || n >= N) continue;
    float v = sums[idx];
#pragma unroll
    for (int g = 1; g < kGroups; ++g) v = __fadd_rn(v, sums[g * kBM * BN + idx]);
    if (o.bias) v = __fadd_rn(v, o.bias[n]);
    int64_t row = r;
    if (o.scatter) {
      const int b = r / lv.cnt;
      row = static_cast<int64_t>(b) * lv.p_max + (r - b * lv.cnt);
    }
    out[row * o.ldo + n] = v;
  }
}

// One launch of a stage: its operand kind and tile plan (width bn,
// chunk kc, k-step kt), and the kernel's arguments.
struct Launch {
  int kind, bn;
  Operand op;
  const float* W;
  int K, N, kc, kt;
  Out o;
  int R;
  Level lv;
};

using StageFn = void (*)(Operand, const float*, int, int, int, int, Out,
                         int, Level);

template <int BN>
int launch_as(StageFn fn, const Launch& a, cudaStream_t st) {
  const dim3 grid((a.N + BN - 1) / BN, (a.R + kBM - 1) / kBM,
                  (a.K + a.kc - 1) / a.kc);
  fn<<<grid, kThreads, stage_smem(a.kind, a.op.nsum, a.op.add_rows, BN, a.kt),
       st>>>(
      a.op, a.W, a.K, a.N, a.kc, a.kt, a.o, a.R, a.lv);
  return static_cast<int>(cudaGetLastError());
}

// Each stage is a kernel of its own name (so a profile tells them apart),
// built for the tile widths 8, 16, 32 and 64; launch_<name>(a, ...)
// picks the width, and allow_<name> lets each width take up to kMaxSmem
// of dynamic shared memory.
#define WAVEFRONT_STAGE(name, KIND)                                          \
  template <int BN>                                                          \
  __global__ void __launch_bounds__(kThreads)                                \
      name(Operand op, const float* __restrict__ W, int K, int N, int kc,    \
           int kt, Out o, int R, Level lv) {                                 \
    stage_body<KIND, BN>(op, W, K, N, kc, kt, o, R, lv);                     \
  }                                                                          \
  int launch_##name(const Launch& a, cudaStream_t st) {                      \
    switch (a.bn) {                                                          \
      case 8: return launch_as<8>(name<8>, a, st);                           \
      case 16: return launch_as<16>(name<16>, a, st);                        \
      case 32: return launch_as<32>(name<32>, a, st);                        \
      case 64: return launch_as<64>(name<64>, a, st);                        \
      default: return -1;                                                    \
    }                                                                        \
  }                                                                          \
  int allow_##name() {                                                       \
    const StageFn fns[] = {name<8>, name<16>, name<32>, name<64>};           \
    for (StageFn f : fns) {                                                  \
      const cudaError_t e = cudaFuncSetAttribute(                            \
          reinterpret_cast<const void*>(f),                                  \
          cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);            \
      if (e != cudaSuccess) return static_cast<int>(e);                      \
    }                                                                        \
    return 0;                                                                \
  }

WAVEFRONT_STAGE(wavefront_hoist_kernel, kPixels)
WAVEFRONT_STAGE(wavefront_ctx_kernel, kTaps)
WAVEFRONT_STAGE(wavefront_layer0_kernel, kChunks)
WAVEFRONT_STAGE(wavefront_layer1_kernel, kChunks)
WAVEFRONT_STAGE(wavefront_layer2_kernel, kChunks)

#undef WAVEFRONT_STAGE

// A stage's tile plan is built and fits: a built width, k-steps that
// split into kGroups whole float4s, and shared memory within kMaxSmem.
bool plan_ok(const Launch& a) {
  constexpr int q = 4 * kGroups;
  return (a.bn == 8 || a.bn == 16 || a.bn == 32 || a.bn == 64) &&
         a.kc > 0 && a.kt > 0 && a.kc % q == 0 && a.kt % q == 0 &&
         a.kt <= a.kc && a.K % q == 0 && a.N % 4 == 0 &&
         stage_smem(a.kind, a.op.nsum, a.op.add_rows, a.bn, a.kt) <=
             static_cast<size_t>(kMaxSmem);
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
  // row r = b*p_max + p of the container's lane layout
  const int b = r / p_max;
  const int p = r - b * p_max;
  const int i = lo + p;
  const int j = s - 3 * i;
  const bool valid = lane < L && p < cnt;
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

// base (npix, H1) = [pre | post] @ w0pp + b0 for every pixel: w0pp
// (P + Q, H1) holds w0's pre rows then its post rows, summed in one chunk.
// plan = (tile width, k-step).  Returns the cudaError_t of the launch
// (0 = success); -1 for an unsupported shape or plan.
int hesic_ar_hoist(const void* pre, const void* post, const void* w0pp,
                   const void* b0, void* base, int npix, int P, int Q,
                   int H1, const int* plan, void* stream) {
  const int K = P + Q;
  const Launch a{
      kPixels, plan[0],
      Operand{static_cast<const float*>(pre), static_cast<const float*>(post),
              P, Q, P, 1, 0, nullptr, 0, 0},
      static_cast<const float*>(w0pp), K, H1, K, plan[1],
      Out{static_cast<float*>(base), 0, H1, static_cast<const float*>(b0), 0},
      npix, Level{}};
  if (P % 4 || Q % 4 || !plan_ok(a)) return -1;
  const int e = allow_wavefront_hoist_kernel();
  if (e) return e;
  return launch_wavefront_hoist_kernel(a, static_cast<cudaStream_t>(stream));
}

// One eye pass over every level, given hesic_ar_hoist's base.  w0c is
// w0[P:P+2M] (2M, H1).  plan holds (tile width, chunk, k-step) for the
// ctx, layer-0, layer-1 and layer-2 stages (ctx chunks of whole taps,
// layer 2 in one chunk); the scratch part_ctx, part0 and part1 hold each
// chunk's (B*p_max, N) partial sums.  Returns the cudaError_t of the
// first failed launch (0 = success); -1 for an unsupported shape or plan.
int hesic_ar_wavefront(const void* base, const void* ytrue,
                       const void* cmask, const void* cval, const void* words,
                       void* x_st, void* p_st, const void* tapk,
                       const void* ctxb, const void* w0c, const void* w1,
                       const void* b1, const void* w2, const void* b2,
                       void* part_ctx, void* part0, void* part1, void* g,
                       void* starts, void* freqs, void* yhat, void* resid,
                       int B, int hy, int wy, int M, int H1, int H2, int G,
                       int mm, int cap, int p_max, int teacher,
                       const int* plan, void* stream) {
  if (M % G != 0 || kCoderThreads % G != 0 || 2 * mm + 1 > kMaxS ||
      mm < 0 || cap < 1 || M % 4 || plan[1] % M || M % plan[2] ||
      plan[10] < H2)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int r_max = B * p_max;
  const int L = r_max * (M / G);
  const int n_levels = 3 * (hy - 1) + (wy - 1) + 1;
  float* fpc = static_cast<float*>(part_ctx);
  float* fp0 = static_cast<float*>(part0);
  float* fp1 = static_cast<float*>(part1);
  const int64_t sc = static_cast<int64_t>(r_max) * 2 * M;
  const int64_t s0 = static_cast<int64_t>(r_max) * H1;
  const int64_t s1 = static_cast<int64_t>(r_max) * H2;
  // chunks of stage i's K, which stage i + 1 sums
  const auto chunks = [plan](int i, int K) {
    return (K + plan[3 * i + 1] - 1) / plan[3 * i + 1];
  };
  Launch ctx{kTaps, plan[0],
             Operand{static_cast<const float*>(yhat), nullptr, M, 0, 0, 1, 0,
                     nullptr, 0, 0},
             static_cast<const float*>(tapk), 12 * M, 2 * M, plan[1],
             plan[2], Out{fpc, sc, 2 * M, nullptr, 0}, 0, Level{}};
  Launch l0{kChunks, plan[3],
            Operand{fpc, nullptr, 2 * M, 0, 0, chunks(0, 12 * M), sc,
                    static_cast<const float*>(ctxb), 0, 0},
            static_cast<const float*>(w0c), 2 * M, H1, plan[4], plan[5],
            Out{fp0, s0, H1, nullptr, 0}, 0, Level{}};
  Launch l1{kChunks, plan[6],
            Operand{fp0, nullptr, H1, 0, 0, chunks(1, 2 * M), s0,
                    static_cast<const float*>(base), 1, 1},
            static_cast<const float*>(w1), H1, H2, plan[7], plan[8],
            Out{fp1, s1, H2, nullptr, 0}, 0, Level{}};
  Launch l2{kChunks, plan[9],
            Operand{fp1, nullptr, H2, 0, 0, chunks(2, H1), s1,
                    static_cast<const float*>(b1), 0, 1},
            static_cast<const float*>(w2), H2, 2 * M, plan[10], plan[11],
            Out{static_cast<float*>(g), 0, 2 * M,
                static_cast<const float*>(b2), 1},
            0, Level{}};
  for (const Launch* a : {&ctx, &l0, &l1, &l2})
    if (!plan_ok(*a)) return -1;
  int e;
  if ((e = allow_wavefront_ctx_kernel()) ||
      (e = allow_wavefront_layer0_kernel()) ||
      (e = allow_wavefront_layer1_kernel()) ||
      (e = allow_wavefront_layer2_kernel()))
    return e;
  for (int s = 0; s < n_levels; ++s) {
    // ar_device.schedule: i from ceil((s - wy + 1) / 3) to min(hy-1, s/3)
    const int lo = s - (wy - 1) > 0 ? (s - (wy - 1) + 2) / 3 : 0;
    const int hi = s / 3 < hy - 1 ? s / 3 : hy - 1;
    const int cnt = hi - lo + 1;
    for (Launch* a : {&ctx, &l0, &l1, &l2}) {
      a->R = B * cnt;
      a->lv = Level{hy, wy, s, lo, cnt, p_max};
    }
    if ((e = launch_wavefront_ctx_kernel(ctx, st)) ||
        (e = launch_wavefront_layer0_kernel(l0, st)) ||
        (e = launch_wavefront_layer1_kernel(l1, st)) ||
        (e = launch_wavefront_layer2_kernel(l2, st)))
      return e;
    const int lanes_per_block = kCoderThreads / G;
    wavefront_coder_kernel<<<(L + lanes_per_block - 1) / lanes_per_block,
                             kCoderThreads, 0, st>>>(
        static_cast<const float*>(g), static_cast<const float*>(ytrue),
        static_cast<const int32_t*>(cmask), static_cast<const int32_t*>(cval),
        static_cast<const int32_t*>(words), static_cast<int64_t*>(x_st),
        static_cast<int32_t*>(p_st), static_cast<int32_t*>(starts),
        static_cast<int32_t*>(freqs), static_cast<float*>(yhat),
        static_cast<int32_t*>(resid), teacher, hy, wy, M, G, mm, cap, p_max,
        r_max, s, lo, cnt);
    e = static_cast<int>(cudaGetLastError());
    if (e) return e;
  }
  return 0;
}

}  // extern "C"
