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
//   then hesic_ar_wavefront, per level s, two kernels on the level's
//   compacted rows r = b*cnt_s + p (pixel (i_min[s] + p, s - 3i) of image
//   b; R_s = B*cnt_s rows, no padding rows):
//   (1) wavefront_level_kernel: the whole chain from context to g for a
//       tile of rows, one thread-block cluster a tile.
//       ctx  = ctx_bias + the 12 mask-A taps of y_hat (0 outside the
//              image, never wrapping at the right edge) @ tapk (12M, 2M);
//       h0   = leaky_relu(base[pixel] + ctx @ w0[P:P+2M]);
//       h1   = leaky_relu(b1 + h0 @ w1);
//       g    = b2 + h1 @ w2 = (scales, means), written to row b*p_max + p;
//   (2) wavefront_coder_kernel: one thread per lane (r, mc) and channel
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
// The level kernel.  A cluster of C blocks (256 threads each) owns a tile
// of bm rows; block `rank` owns the units [Q*rank/C, Q*(rank+1)/C) of each
// product's Q = N/u output units of u columns (u, the register tile: 4 or
// 8).  It first loads its share of the tile's taps (the same split of the
// context product's 3M input quads) from y_hat into its shared memory,
// once, while cp.async brings its layer-0 columns of the tile's base rows.
// Each product then runs over k-steps: the block gathers the step's
// columns of its input, every row of the tile, from the blocks that own
// them, through distributed shared memory (cluster.map_shared_rank; into
// registers one step ahead, then into its own buffer), while cp.async
// brings the step's rows of its weight columns from L2.  Its output slice
// stays in its own shared memory, stored column-major (bm floats a column,
// the layout the next product gathers), with a cluster barrier between
// products; only g leaves the chip.  No product writes partial sums to
// device memory.
//
// Determinism, so that encode and decode get bit-equal g: every output is
// summed over its full K in one order, fixed by K alone.  K is cut into
// four k-groups [gK/4, (g+1)K/4); the threads of group g (64 of them) sum
// its k ascending, one __fmaf_rn per term, and the groups' sums are added
// in order 0..3, then the bias (or base row), then leaky_relu.  There are
// no atomics and no reduction whose order depends on scheduling.  The
// tiling (bm, C, the k-step) changes who computes an output, never its
// order of terms, so the caller may pick it per level from the level's
// rows (models/wavefront.py level_plan).  Encode and decode launch the
// same functions on the same inputs.
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
// a block's serial work and its traffic.  Its threads each hold up to 64
// sums (four 4x4 or one 8x8 register tile of one k-group), so each float4
// loaded from shared memory feeds 16 or 32 FMAs; but a k-group's sum is a
// chain of K/4 terms on one thread, and a block's tiles seldom fill its
// four schedulers evenly.  A block reads its weight columns once a level
// (the whole weights once a tile: 6.6 MB at M=192, about 100 MB of L2
// reads for a full level of 704 rows in 15 tiles), and gathers the tile's
// activations once a product (bm * K * (C-1)/C floats of distributed
// shared memory, the costliest byte here: about 15 GB/s an SM, measured).
// level_plan weighs these from the level's rows (a model fitted to 9,500
// launches timed on the card).  125 dependent levels cost 250 launches a
// pass.  Not done here (later work): bf16 operands and wgmma (ruled out:
// the configuration's products are f32), a CUDA graph over the launches.
// The TPU kernel's ring buffer, level-major gather and one-hot word read
// were devices of its VMEM and vector unit: here y_hat lives whole in
// device memory (8.7 MB at B=11), pixels are indexed in place, and
// the word is a direct load.

#include <stdint.h>

#include <algorithm>
#include <initializer_list>

#include <cooperative_groups.h>

#include "det_math.cuh"

namespace cg = cooperative_groups;

namespace {

// the hoisted product (wavefront_hoist_kernel)
constexpr int kBM = 64;              // rows per tile
constexpr int kThreads = 256;        // per block: kGroups x 64
constexpr int kGroups = 4;           // k-groups of a block (both kernels)
// dynamic shared memory a block may take: 227 KB less the row tables
constexpr int kMaxSmem = 226 * 1024;
// the level kernel (wavefront_level_kernel)
constexpr int kLvThreads = 256;
constexpr int kLvGather = 8;         // float4s a thread gathers a k-step
constexpr int kLvMaxCluster = 16;    // non-portable above 8
constexpr int kLvMaxRows = 64;
// dynamic shared memory a block may take: 227 KB less the row tables
// (1.25 KB) and what the runtime reserves
constexpr int kLvMaxSmem = 225 * 1024;
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

// The hoisted product's operand: row r is pixel r; k < split from a (row
// stride lda), else from a2 (row stride lda2) at k - split.
struct Pixels {
  const float* a;
  const float* a2;
  int lda, lda2, split;
};

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

// Dynamic shared memory of a hoisted-product launch, in bytes: the
// k-step's tiles, or the k-groups' sums in the epilogue, whichever is
// larger.
size_t hoist_smem(int bn, int kt) {
  const size_t tiles = static_cast<size_t>(kBM) * (kt + 4) +
                       static_cast<size_t>(kt) * bn;
  const size_t sums = static_cast<size_t>(kGroups) * kBM * bn;
  return sizeof(float) * (tiles > sums ? tiles : sums);
}

// base[r, n] = sum over k < K of A[r, k] * W[k, n] + bias[n]; W (K, N)
// row-major.  Block (x, y): columns [x*BN, +BN), rows [y*kBM, +kBM).  Each
// k-step of kt columns of A (row-major, pitch kt + 4) and rows of W goes
// through shared memory: the copy engine (cp.async.bulk, one copy per row
// segment, completing on an mbarrier) brings A's pixel rows, cp.async W's
// rows.  The block's 256 threads are kGroups k-groups of 64: group g sums
// the g-th quarter of every k-step, k ascending, one __fmaf_rn per term,
// in an 8 x BN/8 register tile per thread (rows ty + 8i: no bank
// conflicts); the epilogue adds the groups' sums in order 0..3.  A fixed
// order throughout.
template <int BN>
__global__ void __launch_bounds__(kThreads)
    wavefront_hoist_kernel(Pixels op, const float* __restrict__ W, int K,
                           int N, int kt, float* __restrict__ out,
                           const float* __restrict__ bias, int R) {
  constexpr int TM = 8;
  constexpr int TN = BN / 8;
  // shared memory: A's kBM x lda, then W's kt x BN
  extern __shared__ float4 smem4[];
  const int lda = kt + 4;
  float* As = reinterpret_cast<float*>(smem4);
  float* Ws = As + kBM * lda;
  // row_ok[rr]: row r0 + rr lies below R
  __shared__ int row_ok[kBM];
  __shared__ uint64_t bar;
  const int tid = threadIdx.x;
  const int gk = tid / 64;
  const int tx = tid % 8;          // columns tx*TN ..
  const int ty = (tid % 64) / 8;   // rows ty, ty + 8, ..
  const int r0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * BN;
  int phase = 0;
  if (tid == 0) mbar_init(&bar);
  if (tid < kBM) row_ok[tid] = r0 + tid < R;
  __syncthreads();
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int jn = 0; jn < TN; ++jn) acc[i][jn] = 0.0f;
  }
  for (int k0 = 0; k0 < K; k0 += kt) {
    const int kn = min(kt, K - k0);
    // fill: each row segment of A is one bulk copy; a row past R is left
    // as it is (its outputs are never stored)
    if (tid == 0) {
      int rows = 0;
      for (int rr = 0; rr < kBM; ++rr) rows += row_ok[rr];
      mbar_expect(&bar, 4u * rows * kn);
    }
    fence_async_smem();
    __syncthreads();
    for (int rr = tid; rr < kBM; rr += kThreads) {
      if (!row_ok[rr]) continue;
      const int r = r0 + rr;
      float* dst = As + rr * lda;
      const int na = max(0, min(kn, op.split - k0));   // from a
      if (na) bulk_copy(dst, op.a + r * op.lda + k0, 4 * na, &bar);
      if (kn > na)
        bulk_copy(dst + na, op.a2 + r * op.lda2 + k0 + na - op.split,
                  4 * (kn - na), &bar);
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
  for (int idx = tid; idx < kBM * BN; idx += kThreads) {
    const int rr = idx / BN;
    const int n = n0 + idx - rr * BN;
    const int r = r0 + rr;
    if (r >= R || n >= N) continue;
    float v = sums[idx];
#pragma unroll
    for (int g = 1; g < kGroups; ++g) v = __fadd_rn(v, sums[g * kBM * BN + idx]);
    out[static_cast<int64_t>(r) * N + n] = __fadd_rn(v, bias[n]);
  }
}

using HoistFn = void (*)(Pixels, const float*, int, int, int, float*,
                         const float*, int);

// the hoisted product's kernel at each built tile width
HoistFn hoist_fn(int bn) {
  switch (bn) {
    case 8: return wavefront_hoist_kernel<8>;
    case 16: return wavefront_hoist_kernel<16>;
    case 32: return wavefront_hoist_kernel<32>;
    case 64: return wavefront_hoist_kernel<64>;
    default: return nullptr;
  }
}

// ---- the level kernel ----

// The first unit of the units [q*rank/c, q*(rank+1)/c) that block `rank`
// of a cluster of c owns of q units.
__host__ __device__ __forceinline__ int slice_lo(int q, int rank, int c) {
  return q * rank / c;
}

// The most columns a block of a cluster of c owns of n columns cut into
// units of u.
int max_cols(int n, int c, int u) { return u * ((n / u + c - 1) / c); }

// The level kernel's dynamic shared memory, in floats: the owner table
// (ints, at 0), then the block's tap share (quads of the context
// product's input), its two output slices o0 (the context product's, then
// layer 1's) and o1 (layer 0's), each bm floats a column, its layer-0
// columns of the base rows (row-major), then the k-step buffers: two of A
// (4 kq columns of bm rows) and, at ws, two of W (4 kq rows of ncmax
// columns), which the k-group partial sums reuse after the last k-step.
// models/wavefront.py level_smem is the same sum.
struct LevelSmem {
  int tap, o0, o1, base, work, ws, ncmax;
  size_t bytes;
};

LevelSmem level_smem(int M, int H1, int H2, int bm, int c, int kq, int u) {
  LevelSmem L;
  const int qmax = std::max({3 * M, M / 2, H1 / 4, H2 / 4});
  L.tap = (qmax + 3) / 4 * 4;
  L.o0 = L.tap + max_cols(12 * M, c, 4) * bm;
  L.o1 = L.o0 + std::max(max_cols(2 * M, c, u), max_cols(H2, c, u)) * bm;
  L.base = L.o1 + max_cols(H1, c, u) * bm;
  L.work = L.base + max_cols(H1, c, u) * bm;
  L.ncmax = std::max({max_cols(2 * M, c, u), max_cols(H1, c, u),
                      max_cols(H2, c, u)});
  L.ws = 2 * 4 * kq * bm;
  const int work = std::max(L.ws + 2 * 4 * kq * L.ncmax, 4 * bm * L.ncmax);
  L.bytes = sizeof(float) * (static_cast<size_t>(L.work) + work);
  return L;
}

// A level plan (bm rows a tile, c blocks a cluster, kq k a group a
// k-step, u x u register tiles) is built and fits: u 4 or 8 dividing bm
// (up to kLvMaxRows) and every product's width, c up to kLvMaxCluster, a
// k-step's gather within kLvGather float4s a thread, every product's
// tiles within the threads' registers (64 sums a thread), and shared
// memory within kLvMaxSmem.  models/wavefront.py level_plan_ok is the
// same test.
bool level_plan_ok(int M, int H1, int H2, int bm, int c, int kq, int u) {
  if ((u != 4 && u != 8) || bm < u || bm > kLvMaxRows || bm % u || c < 1 ||
      c > kLvMaxCluster || kq < 4 || kq % 4 ||
      kq * bm > kLvGather * kLvThreads)
    return false;
  for (int n : {2 * M, H1, H2})
    if (n % u || kGroups * (bm / u) * (max_cols(n, c, u) / u) >
                     kLvThreads * (64 / (u * u)))
      return false;
  return level_smem(M, H1, H2, bm, c, kq, u).bytes <=
         static_cast<size_t>(kLvMaxSmem);
}

// The level kernel's arguments: per product (0 ctx, 1 layer 0, 2 layer 1,
// 3 layer 2) its (K, N) weights w (row-major), bias (none for layer 0,
// which adds base rows), its input's and output's offsets in shared
// memory (out < 0: g); the level, its rows R and the plan; the shared
// memory layout.
struct LevelArgs {
  const float* yhat;
  const float* base;
  float* g;
  const float* w[4];
  const float* bias[4];
  int k[4], n[4], src[4], dst[4];
  Level lv;
  int M, H1, R, bm, kq;
  LevelSmem L;
};

// The k-group of column `col` of a k-step of kn columns a group.
__device__ __forceinline__ int step_group(int col, int kn) {
  return (col >= kn) + (col >= 2 * kn) + (col >= 3 * kn);
}

// One launch per level: cluster blockIdx.x / C owns rows [tile*bm, +bm);
// each thread holds up to 64 / (U*U) U x U tiles of one product's output
// (rows and columns in U/4 runs of 4, half a tile apart, so that the
// lanes of a warp read neighbouring float4s).
template <int U>
__global__ void __launch_bounds__(kLvThreads, 1)
    wavefront_level_kernel(const LevelArgs a) {
  constexpr int kItems = 64 / (U * U);
  constexpr int kRuns = U / 4;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  int* own = reinterpret_cast<int*>(smem4);
  float* As = sm + a.L.work;
  float* Ws = As + a.L.ws;
  float* base_s = sm + a.L.base;
  // each tile row's pixel (-1 past R), its row of g, and (b, i, j)
  __shared__ int row_pix[kLvMaxRows], row_g[kLvMaxRows];
  __shared__ int row_b[kLvMaxRows], row_i[kLvMaxRows], row_j[kLvMaxRows];
  const Level& lv = a.lv;
  const int tid = threadIdx.x;
  const int bm = a.bm;
  const int bmq = bm / 4;
  const int kq = a.kq;
  const int r0 = static_cast<int>(blockIdx.x) / C * bm;
  if (tid < bm) {
    int b = 0, i = 0, j = 0, pix = -1, gr = 0;
    if (r0 + tid < a.R) {
      pix = static_cast<int>(level_pixel(lv, r0 + tid, &b, &i, &j));
      gr = b * lv.p_max + i - lv.lo;
    }
    row_pix[tid] = pix;
    row_g[tid] = gr;
    row_b[tid] = b;
    row_i[tid] = i;
    row_j[tid] = j;
  }
  __syncthreads();

  // this block's layer-0 columns of the tile's base rows, in flight while
  // the context product runs (0 past R)
  {
    const int nu = a.H1 / U;
    const int c0 = U * slice_lo(nu, rank, C);
    const int nc4 = U * (slice_lo(nu, rank + 1, C) - slice_lo(nu, rank, C)) / 4;
    for (int e = tid; e < bm * nc4; e += kLvThreads) {
      const int r = e / nc4;
      const int q = e - r * nc4;
      const int pix = row_pix[r];
      cp16(base_s + 4 * (r * nc4 + q),
           pix >= 0 ? a.base + static_cast<int64_t>(pix) * a.H1 + c0 + 4 * q
                    : a.base,
           pix >= 0);
    }
  }

  // the tile's taps: this block's share, quads [lo, lo + nq) of the
  // context product's 3M input quads (k = tap*M + c), bm floats a column,
  // 0 outside the image and past R; loads in batches of 4
  {
    float* tap = sm + a.L.tap;
    const int q = 3 * a.M;
    const int lo = slice_lo(q, rank, C);
    const int n = (slice_lo(q, rank + 1, C) - lo) * bm;
    for (int e0 = tid; e0 < n; e0 += 4 * kLvThreads) {
      float4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = e0 + u * kLvThreads;
        v[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (e >= n) continue;
        const int ql = e / bm;
        const int r = e - ql * bm;
        const int k = 4 * (lo + ql);
        const int t = k / a.M;
        if (row_pix[r] < 0) continue;
        // ar_device.TAPS order: rows -2 and -1 (dj = -2..2), then
        // (0, -2), (0, -1)
        const int ii = row_i[r] + (t < 10 ? t / 5 - 2 : 0);
        const int jj = row_j[r] + (t < 10 ? t % 5 - 2 : t - 12);
        if (ii >= 0 && jj >= 0 && jj < lv.wy)
          v[u] = *reinterpret_cast<const float4*>(
              a.yhat +
              ((static_cast<int64_t>(row_b[r]) * lv.hy + ii) * lv.wy + jj) *
                  a.M +
              k - t * a.M);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = e0 + u * kLvThreads;
        if (e >= n) continue;
        const int ql = e / bm;
        float* d = tap + 4 * ql * bm + e - ql * bm;
        d[0] = v[u].x;
        d[bm] = v[u].y;
        d[2 * bm] = v[u].z;
        d[3 * bm] = v[u].w;
      }
    }
  }
  cluster.sync();

  // this thread's first element (col, rq) of a k-step's gather grid of
  // 4 kn columns x bmq row quads, rq fastest, and the stride to its next
  const int gcol0 = tid / bmq;
  const int grq0 = tid - gcol0 * bmq;
  const int dcol = kLvThreads / bmq;
  const int drq = kLvThreads - dcol * bmq;

  for (int si = 0; si < 4; ++si) {
    const int K = a.k[si];
    const int N = a.n[si];
    const int kg = K / kGroups;   // k of a group
    const int qk = K / 4;         // quads of the input
    const int uin = si == 0 ? 1 : U / 4;   // quads a unit of the input
    const float* src = sm + a.src[si];
    // the owner of each input quad and its place there
    for (int q = tid; q < qk; q += kLvThreads) {
      const int nu = qk / uin;
      const int v = q / uin;
      const int c = ((v + 1) * C + nu - 1) / nu - 1;
      own[q] = (c << 16) | (q - uin * slice_lo(nu, c, C));
    }
    const int nu = N / U;
    const int n0 = U * slice_lo(nu, rank, C);
    const int nc = U * (slice_lo(nu, rank + 1, C) - slice_lo(nu, rank, C));
    const int trn = bm / U;                // tiles down the rows
    const int tiles = trn * (nc / U);
    const int rh = bm / kRuns;             // a tile's runs: rows apart
    const int ch = nc / kRuns;             //   and columns apart
    // this thread's items i = tid + 256 it: k-group g, tile t (rows
    // fastest), the tile's first row and column, and its sums
    int item_g[kItems], t_row[kItems], t_col[kItems];
    float acc[kItems][U * U];
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      const int i = tid + kLvThreads * it;
      const int g = tiles ? i / tiles : kGroups;
      const int t = i - g * tiles;
      const int tc = tiles ? t / trn : 0;
      item_g[it] = g;
      t_row[it] = 4 * (t - tc * trn);
      t_col[it] = 4 * tc;
#pragma unroll
      for (int e = 0; e < U * U; ++e) acc[it][e] = 0.0f;
    }
    const int nsteps = (kg + kq - 1) / kq;
    float4 gr[kLvGather];
    // k-step `step`: kn k of each group; column col of the step is k =
    // g*kg + step*kq + kk of the input, (g, kk) = step_group
    const auto kn_of = [&](int step) { return min(kq, kg - step * kq); };
    const auto gather_load = [&](int step) {
      const int kn = kn_of(step);
      int col = gcol0, rq = grq0;
#pragma unroll
      for (int i = 0; i < kLvGather; ++i) {
        if (col < 4 * kn) {
          const int g = step_group(col, kn);
          const int k = g * kg + step * kq + col - g * kn;
          const int o = own[k >> 2];
          const float* p = cluster.map_shared_rank(src, o >> 16) +
                           (4 * (o & 0xFFFF) + (k & 3)) * bm + 4 * rq;
          gr[i] = *reinterpret_cast<const float4*>(p);
        }
        col += dcol;
        rq += drq;
        if (rq >= bmq) {
          rq -= bmq;
          ++col;
        }
      }
    };
    const auto gather_store = [&](int step, int buf) {
      const int kn = kn_of(step);
      float* dst = As + buf * 4 * kq * bm;
      int col = gcol0, rq = grq0;
#pragma unroll
      for (int i = 0; i < kLvGather; ++i) {
        if (col < 4 * kn) {
          const int g = step_group(col, kn);
          *reinterpret_cast<float4*>(
              dst + (g * kq + col - g * kn) * bm + 4 * rq) = gr[i];
        }
        col += dcol;
        rq += drq;
        if (rq >= bmq) {
          rq -= bmq;
          ++col;
        }
      }
    };
    const auto load_w = [&](int step, int buf) {
      if (!nc) return;
      const int kn = kn_of(step);
      const int nq = nc / 4;
      float* dst = Ws + buf * 4 * kq * a.L.ncmax;
      const float* W = a.w[si];
      int row = tid / nq;
      int q = tid - row * nq;
      const int drow = kLvThreads / nq;
      const int dq = kLvThreads - drow * nq;
      while (row < 4 * kn) {
        const int g = step_group(row, kn);
        const int kk = row - g * kn;
        const int k = g * kg + step * kq + kk;
        cp16(dst + (g * kq + kk) * nc + 4 * q,
             W + static_cast<int64_t>(k) * N + n0 + 4 * q, true);
        row += drow;
        q += dq;
        if (q >= nq) {
          q -= nq;
          ++row;
        }
      }
    };

    __syncthreads();   // the owner table
    gather_load(0);
    load_w(0, 0);
    gather_store(0, 0);
    cp_wait_all();
    __syncthreads();
    for (int step = 0; step < nsteps; ++step) {
      const int cur = step & 1;
      const bool more = step + 1 < nsteps;
      if (more) {
        gather_load(step + 1);
        load_w(step + 1, cur ^ 1);
      }
      const int kn = kn_of(step);
#pragma unroll
      for (int it = 0; it < kItems; ++it) {
        if (item_g[it] < kGroups) {
          const float* ap = As + (cur * 4 + item_g[it]) * kq * bm + t_row[it];
          const float* wp = Ws + cur * 4 * kq * a.L.ncmax +
                            item_g[it] * kq * nc + t_col[it];
#pragma unroll 2
          for (int kk = 0; kk < kn; ++kk) {
            float x[U], w[U];
#pragma unroll
            for (int h = 0; h < kRuns; ++h) {
              const float4 xv =
                  *reinterpret_cast<const float4*>(ap + kk * bm + h * rh);
              const float4 wv =
                  *reinterpret_cast<const float4*>(wp + kk * nc + h * ch);
              x[4 * h] = xv.x;
              x[4 * h + 1] = xv.y;
              x[4 * h + 2] = xv.z;
              x[4 * h + 3] = xv.w;
              w[4 * h] = wv.x;
              w[4 * h + 1] = wv.y;
              w[4 * h + 2] = wv.z;
              w[4 * h + 3] = wv.w;
            }
#pragma unroll
            for (int i = 0; i < U; ++i) {
#pragma unroll
              for (int j = 0; j < U; ++j)
                acc[it][i * U + j] =
                    __fmaf_rn(x[i], w[j], acc[it][i * U + j]);
            }
          }
        }
      }
      if (more) {
        gather_store(step + 1, cur ^ 1);
        cp_wait_all();
      }
      __syncthreads();
    }

    // the k-groups' sums, column-major (bm floats a column) a group, in
    // the k-step buffers; then each output is their sum in group order
    // 0..3, + the bias (layer 0: the pixel's base row), leaky_relu after
    // layers 0 and 1, into this block's output slice, or g
    float* red = As;
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      if (item_g[it] >= kGroups) continue;
      float* p = red + item_g[it] * nc * bm;
#pragma unroll
      for (int hc = 0; hc < kRuns; ++hc) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float* col = p + (hc * ch + t_col[it] + j) * bm + t_row[it];
#pragma unroll
          for (int h = 0; h < kRuns; ++h) {
            const float* s = acc[it] + 4 * h * U + 4 * hc + j;
            *reinterpret_cast<float4*>(col + h * rh) =
                make_float4(s[0], s[U], s[2 * U], s[3 * U]);
          }
        }
      }
    }
    __syncthreads();
    {
      const int grp = nc * bm;
      float* dst = si < 3 ? sm + a.dst[si] : nullptr;
      int c = tid / bm;
      int r = tid - c * bm;
      const int dc = kLvThreads / bm;
      const int dr = kLvThreads - dc * bm;
      for (int e = tid; e < grp; e += kLvThreads) {
        float v = red[e];
#pragma unroll
        for (int g = 1; g < kGroups; ++g) v = __fadd_rn(v, red[g * grp + e]);
        v = __fadd_rn(v, si == 1 ? base_s[r * nc + c] : a.bias[si][n0 + c]);
        if (si == 1 || si == 2) v = leaky1(v);
        if (dst)
          dst[e] = v;
        else if (row_pix[r] >= 0)
          a.g[static_cast<int64_t>(row_g[r]) * N + n0 + c] = v;
        c += dc;
        r += dr;
        if (r >= bm) {
          r -= bm;
          ++c;
        }
      }
    }
    // the slice is complete for the next product's gathers (after the last
    // product: no block leaves while another still reads its memory)
    cluster.sync();
  }
}

using LevelFn = void (*)(LevelArgs);

// the level kernel at each register tile
LevelFn level_fn(int u) {
  return u == 8 ? wavefront_level_kernel<8> : wavefront_level_kernel<4>;
}

// Lets the level kernel (tile u) take kLvMaxSmem of dynamic shared memory
// and clusters of up to 16 blocks.
int allow_level(int u) {
  const void* f = reinterpret_cast<const void*>(level_fn(u));
  cudaError_t e = cudaFuncSetAttribute(
      f, cudaFuncAttributeMaxDynamicSharedMemorySize, kLvMaxSmem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        f, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return static_cast<int>(e);
}

cudaLaunchConfig_t level_config(int clusters, int c, size_t smem,
                                cudaStream_t st, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * c);
  cfg.blockDim = dim3(kLvThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = c;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
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
  const int bn = plan[0], kt = plan[1];
  const HoistFn fn = hoist_fn(bn);
  if (P % 4 || Q % 4 || !fn || kt <= 0 || kt % 16 || kt > K || K % 16 ||
      H1 % 4 || hoist_smem(bn, kt) > static_cast<size_t>(kMaxSmem))
    return -1;
  cudaError_t e = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(fn),
      cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((H1 + bn - 1) / bn, (npix + kBM - 1) / kBM);
  fn<<<grid, kThreads, hoist_smem(bn, kt),
       static_cast<cudaStream_t>(stream)>>>(
      Pixels{static_cast<const float*>(pre), static_cast<const float*>(post),
             P, Q, P},
      static_cast<const float*>(w0pp), K, H1, kt, static_cast<float*>(base),
      static_cast<const float*>(b0), npix);
  return static_cast<int>(cudaGetLastError());
}

// One eye pass over every level, given hesic_ar_hoist's base.  w0c is
// w0[P:P+2M] (2M, H1).  plan holds (bm, cluster, kq, tile) for each level
// (see level_plan_ok).  Returns the cudaError_t of the first failed launch
// (0 = success); -1 for an unsupported shape or plan (nothing launched).
int hesic_ar_wavefront(const void* base, const void* ytrue,
                       const void* cmask, const void* cval, const void* words,
                       void* x_st, void* p_st, const void* tapk,
                       const void* ctxb, const void* w0c, const void* w1,
                       const void* b1, const void* w2, const void* b2,
                       void* g, void* starts, void* freqs, void* yhat,
                       void* resid, int B, int hy, int wy, int M, int H1,
                       int H2, int G, int mm, int cap, int p_max, int teacher,
                       const int* plan, void* stream) {
  const int n_levels = 3 * (hy - 1) + (wy - 1) + 1;
  if (M % G != 0 || kCoderThreads % G != 0 || 2 * mm + 1 > kMaxS ||
      mm < 0 || cap < 1 || M % 4 || H1 % 4 || H2 % 4)
    return -1;
  for (int s = 0; s < n_levels; ++s)
    if (!level_plan_ok(M, H1, H2, plan[4 * s], plan[4 * s + 1],
                       plan[4 * s + 2], plan[4 * s + 3]))
      return -1;
  int e;
  if ((e = allow_level(4)) || (e = allow_level(8))) return e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int r_max = B * p_max;
  const int L = r_max * (M / G);
  LevelArgs a{};
  a.yhat = static_cast<const float*>(yhat);
  a.base = static_cast<const float*>(base);
  a.g = static_cast<float*>(g);
  const float* w[4] = {static_cast<const float*>(tapk),
                       static_cast<const float*>(w0c),
                       static_cast<const float*>(w1),
                       static_cast<const float*>(w2)};
  const float* bias[4] = {static_cast<const float*>(ctxb), nullptr,
                          static_cast<const float*>(b1),
                          static_cast<const float*>(b2)};
  const int kn[4][2] = {{12 * M, 2 * M}, {2 * M, H1}, {H1, H2}, {H2, 2 * M}};
  a.M = M;
  a.H1 = H1;
  for (int s = 0; s < n_levels; ++s) {
    // ar_device.schedule: i from ceil((s - wy + 1) / 3) to min(hy-1, s/3)
    const int lo = s - (wy - 1) > 0 ? (s - (wy - 1) + 2) / 3 : 0;
    const int hi = s / 3 < hy - 1 ? s / 3 : hy - 1;
    const int cnt = hi - lo + 1;
    const int* p = plan + 4 * s;
    a.lv = Level{hy, wy, s, lo, cnt, p_max};
    a.R = B * cnt;
    a.bm = p[0];
    a.kq = p[2];
    a.L = level_smem(M, H1, H2, p[0], p[1], p[2], p[3]);
    const int src[4] = {a.L.tap, a.L.o0, a.L.o1, a.L.o0};
    const int dst[4] = {a.L.o0, a.L.o1, a.L.o0, -1};
    for (int i = 0; i < 4; ++i) {
      a.w[i] = w[i];
      a.bias[i] = bias[i];
      a.k[i] = kn[i][0];
      a.n[i] = kn[i][1];
      a.src[i] = src[i];
      a.dst[i] = dst[i];
    }
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg =
        level_config((a.R + p[0] - 1) / p[0], p[1], a.L.bytes, st, &attr);
    e = static_cast<int>(cudaLaunchKernelEx(&cfg, level_fn(p[3]), a));
    if (e) return e;
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

// *out = the most clusters of `c` level-kernel blocks (tile u), each with
// `smem` bytes of dynamic shared memory, that the card holds at once
// (cudaOccupancyMaxActiveClusters).  Returns the cudaError_t (0 =
// success).
int hesic_ar_level_clusters(int c, int smem, int u, int* out) {
  const int e = allow_level(u);
  if (e) return e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = level_config(1, c, smem, nullptr, &attr);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(
      out, reinterpret_cast<const void*>(level_fn(u)), &cfg));
}

}  // extern "C"
