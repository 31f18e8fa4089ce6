// GDN and IGDN as one pass, for Hopper (sm_90a):
//
//   xb[c, p]   = bf16(x[c, p] + bias[c])         the preceding conv's bias
//   sq[c, p]   = bf16(xb[c, p] * xb[c, p])
//   norm[i, p] = bf16(bf16(sum_j gamma[i, j] * sq[j, p]) + beta[i])
//   out[i, p]  = bf16(xb[i, p] * bf16(rsqrt(norm[i, p])))   (sqrt: IGDN)
//
// on x, out (B, C, H, W) bf16, both contiguous NCHW or both channels-last
// (NHWC in memory); bias, beta (C,) and gamma (C, C) (out, in) bf16.
// Without a bias the first line is xb = x.
//
// Replaces no TPU kernel: GDN was left to XLA (hesic_tpu/layers/gdn.py).
// Its plain twin, layers/gdn.py's gdn_plain, is the op sequence the port
// ran before: the conv's bias as PyTorch's broadcast add after cuDNN
// (F.conv2d with a bias on the card runs output.add_(bias) as a pass of its
// own), x * x, the channel mix as a 1x1 cuDNN conv (two layout transposes
// and its own beta add), rsqrt or sqrt, and the product: about 30 bytes of
// traffic an element.  This pass reads x once and writes out once.
//
// Arithmetic, the twin's at every rounding point.  Each elementwise step
// computes in f32 and rounds to bf16 (cvt.rn.bf16x2.f32, nearest, ties to
// even), as PyTorch's bf16 elementwise kernels do; __fadd_rn / __fmul_rn
// keep the compiler from contracting them; rsqrtf is the instruction
// PyTorch's rsqrt runs (rsqrt.approx.f32).  PyTorch's sqrt is the IEEE
// one; sqrt.approx.f32 (relative error under 2^-22) rounds to the same
// bf16 for every bf16 input n: a bf16 midpoint m has a 9-bit odd
// significand, so n - m^2 is a nonzero multiple of m's ulp^2 and sqrt(n)
// lies at least 2^-19 (relative) from m.  It spares the IGDN epilogue the
// IEEE root's refinement (IGDN at B=64, 256x256: 1.08 -> 0.90 ms on an
// H100).  Only the channel mix's f32 sum runs in another order than
// cuDNN's, so a result can differ from the twin where that sum's bf16
// rounding flips.  The sum's order is fixed by C alone: no split-K,
// no atomics, and every tile, ragged or not, takes the same instructions,
// so a pixel's result depends on its own column of x and nothing else (not
// on B, H, W or its place in the batch).
//
// What bounds it on an H100: bytes.  The channel mix is 2C FLOP an element
// against 4 bytes (C = 128: 64 FLOP/B, below the card's ~295 FLOP/B
// ridge).  At B=64, C=128, 256x256 the pass reads and writes 2.147 GB:
// 0.641 ms at 3.35 TB/s, its byte bound.
//
// Layouts.  A convolution's output takes its input's layout, and cuDNN
// runs its NHWC engines on channels-last data as it is but wraps them in
// two transposes for NCHW data.  HESIC+'s device codec feeds its synthesis
// stacks channels-last latents, so the pass keeps the layout it is given:
// a channels-last x gives a channels-last out, and the convs after it run
// as they did before the pass existed.
//
// Channel counts: those the port's bf16 models build.  C = 128 and 192
// (N of HESIC, DSIC and HESIC+; HESIC+ at N = 192 in bench.py and the
// smoke test) on tensor cores, C = 3 (HESIC's right-eye GDN and IGDN) on
// CUDA cores; hesic_gdn refuses any other C.  Both paths are templates of
// C, so another width is one more case there.
//   * Tensor cores, C = 16 KT (mma.sync m16n8k16, bf16 in, f32 sums).  A
//     persistent block of C/16 warps; warp w owns output channels
//     [16w, 16w + 16) and holds their rows of gamma in registers for the
//     whole launch.  A tile is kP = 64 pixels by C channels.  NCHW: C
//     channel rows of 64 contiguous pixels of one image, read with stride
//     H*W between rows; the product is gamma (A) times the squares (B, by
//     ldmatrix.trans).  NHWC: 64 pixel rows of C contiguous channels, the
//     batch's pixels in memory order; the product is the squares (A, by
//     ldmatrix) times gamma's transpose (B, the same registers), so that a
//     thread's two results are two adjacent channels of one pixel, one word
//     of the tile, as in NCHW they are two adjacent pixels of one channel.
//     Either way each result is its K products summed in ascending K
//     steps.  Tiles arrive by cp.async (16 bytes a thread, zero-filled
//     past the data) into a ring of kStages tiles in shared memory,
//     kStages - 1 ahead of the one being worked on.  For each tile the
//     block (1) adds the bias in place and writes the squares beside it,
//     (2) runs the K steps, (3) finishes each warp's 16 channels in
//     registers and writes the results over xb, and (4) stores the tile
//     with 16 bytes a thread.  Each 16-byte chunk c of tile row r sits at
//     chunk c ^ (r & 7), so ldmatrix, the epilogue's word accesses and the
//     16-byte copies all hit 32 distinct banks.  Where a copy would not be
//     16-byte aligned (NCHW: H*W no multiple of 8) the copies and stores go
//     element by element, the arithmetic unchanged.
//   * CUDA cores, C below 16: one thread a run of kV pixels, the channel
//     mix as f32 fused multiply-adds in ascending j (each product of two
//     bf16 values is exact in f32).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kP = 64;                  // pixels a tile
constexpr int kStages = 4;              // tiles in the ring
constexpr int kSmallThreads = 256;

__device__ __forceinline__ float bf16_f32(uint16_t v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}

// x rounded to bf16 (nearest, ties to even), as an f32 whose low 16 bits
// are zero: the upper half of cvt.rn.bf16x2.f32's packed result.
__device__ __forceinline__ float round_bf16(float x) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(x), "f"(0.0f));
  return __uint_as_float(r);
}

// lo and hi rounded to bf16 and packed, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

__device__ __forceinline__ float lo_f32(uint32_t w) {
  return __uint_as_float(w << 16);
}

__device__ __forceinline__ float hi_f32(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// bf16(rsqrt(n)) for GDN, bf16(sqrt(n)) for IGDN
template <bool kInverse>
__device__ __forceinline__ float scale_of(float n) {
  float r;
  if (kInverse)
    asm("sqrt.approx.f32 %0, %1;" : "=f"(r) : "f"(n));
  else
    r = rsqrtf(n);
  return round_bf16(r);
}

// the packed bf16 pair w plus its biases b0 (low half) and b1 (high half),
// rounded, and its squares: {xb, sq}
__device__ __forceinline__ uint2 bias_square(uint32_t w, float b0, float b1) {
  const uint32_t xb = pack_bf16(__fadd_rn(lo_f32(w), b0),
                                __fadd_rn(hi_f32(w), b1));
  const float x0 = lo_f32(xb), x1 = hi_f32(xb);
  return make_uint2(xb, pack_bf16(__fmul_rn(x0, x0), __fmul_rn(x1, x1)));
}

// out for one pair: the channel mix's sums s0, s1, their betas b0, b1, the
// pair xb
template <bool kInverse>
__device__ __forceinline__ uint32_t finish(float s0, float s1, float b0,
                                           float b1, uint32_t xb) {
  const float n0 = round_bf16(__fadd_rn(round_bf16(s0), b0));
  const float n1 = round_bf16(__fadd_rn(round_bf16(s1), b1));
  return pack_bf16(__fmul_rn(lo_f32(xb), scale_of<kInverse>(n0)),
                   __fmul_rn(hi_f32(xb), scale_of<kInverse>(n1)));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zeros when bytes == 0 (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr,
                                            uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr,
                                                  uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d += a * b over one 16 x 8 x 16 step, f32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// element `e` (0..7) of a 16-byte chunk
__device__ __forceinline__ uint16_t chunk_elem(const uint4& v, int e) {
  const uint32_t w = e < 2 ? v.x : e < 4 ? v.y : e < 6 ? v.z : v.w;
  return static_cast<uint16_t>(e & 1 ? w >> 16 : w);
}

template <int KT, bool kNhwc>
struct Mma {
  static constexpr int C = 16 * KT;
  static constexpr int kThreads = 32 * KT;
  static constexpr int kTile = C * kP;                     // elements
  // a tile row: NCHW, a channel of kP pixels; NHWC, a pixel of C channels
  static constexpr int kWidth = kNhwc ? C : kP;
  static constexpr int kRowChunks = kWidth / 8;            // 16-byte chunks
  static constexpr int kPerThread = kTile / 8 / kThreads;  // 4 chunks
  static constexpr size_t kSmem =
      (kStages + 1) * kTile * sizeof(uint16_t) + C * sizeof(float);
  static_assert(kRowChunks % 8 == 0, "the swizzle takes 8 chunks a row");
  // a thread's chunks of a tile share one column (NHWC: its 8 channels)
  static_assert(kThreads % kRowChunks == 0, "one column a thread");
};

// The tile's layout: row r of kWidth elements, its 16-byte chunk c at
// chunk c ^ (r & 7).
template <int kWidth>
__device__ __forceinline__ int tile_off(int r, int c) {
  return r * kWidth + ((c ^ (r & 7)) << 3);
}

// Where chunk (r, c) of tile t lies in x or out, and how many of its 8
// elements exist.  NCHW: tile t is image t / tiles, pixels from
// (t % tiles) * kP, row r a channel.  NHWC: tile t is the batch's pixels
// t * kP on, row r a pixel.
template <int KT, bool kNhwc>
__device__ __forceinline__ int64_t chunk_at(int t, int r, int c, int tiles,
                                            int hw, int64_t npix, int* n) {
  using G = Mma<KT, kNhwc>;
  if constexpr (kNhwc) {
    const int64_t pix = static_cast<int64_t>(t) * kP + r;
    *n = pix < npix ? 8 : 0;
    return pix * G::C + c * 8;
  } else {
    const int b = t / tiles, p = (t - b * tiles) * kP + c * 8;
    const int left = hw - p;
    *n = left < 0 ? 0 : left < 8 ? left : 8;
    return (static_cast<int64_t>(b) * G::C + r) * hw + p;
  }
}

template <int KT, bool kNhwc>
__device__ __forceinline__ void load_tile(uint16_t* dst, const uint16_t* x,
                                          int t, int tiles, int hw,
                                          int64_t npix, bool vec) {
  using G = Mma<KT, kNhwc>;
#pragma unroll
  for (int i = 0; i < G::kPerThread; ++i) {
    const int q = threadIdx.x + i * G::kThreads;
    const int r = q / G::kRowChunks, c = q % G::kRowChunks;
    int n;
    const uint16_t* g = x + chunk_at<KT, kNhwc>(t, r, c, tiles, hw, npix, &n);
    uint16_t* d = dst + tile_off<G::kWidth>(r, c);
    if (vec) {
      cp_async16(d, n ? g : x, n ? 16 : 0);
    } else {
      uint32_t e[8];
#pragma unroll
      for (int v = 0; v < 8; ++v) e[v] = v < n ? g[v] : 0u;
      *reinterpret_cast<uint4*>(d) =
          make_uint4(e[0] | (e[1] << 16), e[2] | (e[3] << 16),
                     e[4] | (e[5] << 16), e[6] | (e[7] << 16));
    }
  }
}

template <int KT, bool kNhwc>
__device__ __forceinline__ void store_tile(uint16_t* out,
                                           const uint16_t* tile, int t,
                                           int tiles, int hw, int64_t npix,
                                           bool vec) {
  using G = Mma<KT, kNhwc>;
#pragma unroll
  for (int i = 0; i < G::kPerThread; ++i) {
    const int q = threadIdx.x + i * G::kThreads;
    const int r = q / G::kRowChunks, c = q % G::kRowChunks;
    int n;
    uint16_t* g = out + chunk_at<KT, kNhwc>(t, r, c, tiles, hw, npix, &n);
    const uint4 v =
        *reinterpret_cast<const uint4*>(tile + tile_off<G::kWidth>(r, c));
    if (vec) {
      if (n) *reinterpret_cast<uint4*>(g) = v;
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (e < n) g[e] = chunk_elem(v, e);
    }
  }
}

// The results of warp w's channels over xb in the tile: the sums in acc,
// betas bt.  NCHW: acc[nb] holds channels r0 and r0 + 8 (h = 0, 1) at
// pixels 8 nb + c0 and + 1, betas bt[0], bt[1].  NHWC: acc[2 mb + nb]
// holds pixels 16 mb + (lane >> 2) and + 8 (h) at channels
// 16 w + 8 nb + c0 and + 1, betas bt[2 nb], bt[2 nb + 1].
template <int C, bool kNhwc, bool kInverse>
__device__ __forceinline__ void epilogue(uint16_t* tile,
                                         const float (&acc)[kP / 8][4],
                                         int warp, int lane,
                                         const float (&bt)[4]) {
  const int c0 = (lane & 3) * 2;
#pragma unroll
  for (int f = 0; f < kP / 8; ++f) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint16_t* at;
      float b0, b1;
      if constexpr (kNhwc) {
        const int mb = f >> 1, nb = f & 1;
        const int p = mb * 16 + (lane >> 2) + 8 * h;
        const int ch = warp * 16 + nb * 8 + c0;
        at = tile + tile_off<C>(p, ch >> 3) + c0;
        b0 = bt[2 * nb];
        b1 = bt[2 * nb + 1];
      } else {
        const int row = warp * 16 + (lane >> 2) + 8 * h;
        at = tile + tile_off<kP>(row, f) + c0;
        b0 = b1 = bt[h];
      }
      uint32_t* w = reinterpret_cast<uint32_t*>(at);
      *w = finish<kInverse>(acc[f][2 * h], acc[f][2 * h + 1], b0, b1, *w);
    }
  }
}

template <int KT, bool kNhwc>
__global__ void __launch_bounds__(32 * KT, KT <= 8 ? 16 / KT : 1)
gdn_mma_kernel(const uint16_t* __restrict__ x,
               const uint16_t* __restrict__ bias,
               const uint16_t* __restrict__ beta,
               const uint16_t* __restrict__ gamma,
               uint16_t* __restrict__ out, int n_img, int hw, int inverse,
               int vec_flag) {
  using G = Mma<KT, kNhwc>;
  constexpr int C = G::C;
  extern __shared__ __align__(128) uint16_t smem[];
  uint16_t* ring = smem;                               // [kStages] tiles
  uint16_t* sq = smem + kStages * G::kTile;            // the squares
  float* bias_f = reinterpret_cast<float*>(sq + G::kTile);   // [C]

  const bool vec = vec_flag != 0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t npix = static_cast<int64_t>(n_img) * hw;
  const int tiles = (hw + kP - 1) / kP;                // NCHW: an image's
  const int n_tiles = kNhwc ? static_cast<int>((npix + kP - 1) / kP)
                            : n_img * tiles;

  // adding -0 leaves every x as it is, -0 included.  NCHW: a chunk's
  // bias is its row's; NHWC: the 8 of the thread's column, in registers
  for (int k = threadIdx.x; k < C; k += G::kThreads)
    bias_f[k] = bias ? bf16_f32(bias[k]) : -0.0f;
  float bcol[8];
  if constexpr (kNhwc) {
    const int col = (threadIdx.x % G::kRowChunks) * 8;
#pragma unroll
    for (int e = 0; e < 8; ++e)
      bcol[e] = bias ? bf16_f32(bias[col + e]) : -0.0f;
  }

  // this warp's 16 rows of gamma, every K step: NCHW's A fragments; in
  // NHWC {a[kk][0], a[kk][2]} and {a[kk][1], a[kk][3]} are the B fragments
  // of channels 16 w to 16 w + 7 and 16 w + 8 to 16 w + 15
  const int r0 = warp * 16 + (lane >> 2), c0 = (lane & 3) * 2;
  uint32_t a[KT][4];
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    const uint16_t* g0 = gamma + r0 * C + kk * 16 + c0;
    const uint16_t* g1 = g0 + 8 * C;
    a[kk][0] = *reinterpret_cast<const uint32_t*>(g0);
    a[kk][1] = *reinterpret_cast<const uint32_t*>(g1);
    a[kk][2] = *reinterpret_cast<const uint32_t*>(g0 + 8);
    a[kk][3] = *reinterpret_cast<const uint32_t*>(g1 + 8);
  }
  float bt[4];
  if constexpr (kNhwc) {
    const int ch = warp * 16 + c0;
    bt[0] = bf16_f32(beta[ch]);
    bt[1] = bf16_f32(beta[ch + 1]);
    bt[2] = bf16_f32(beta[ch + 8]);
    bt[3] = bf16_f32(beta[ch + 9]);
  } else {
    bt[0] = bf16_f32(beta[r0]);
    bt[1] = bf16_f32(beta[r0 + 8]);
    bt[2] = bt[3] = 0.f;
  }

  // ldmatrix: lanes 8q..8q+7 address the rows of matrix q, tile rows
  // (q & 1) * 8 + r of a 16-row block, 16-byte chunk (q >> 1) of a pair
  const int lq = lane >> 3, lr = lane & 7;
  const uint32_t sq_lane =
      smem_u32(sq) + 2 * (((lq & 1) * 8 + lr) * G::kWidth);

  const int first = blockIdx.x, step = gridDim.x;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    const int t = first + s * step;
    if (t < n_tiles)
      load_tile<KT, kNhwc>(ring + s * G::kTile, x, t, tiles, hw, npix, vec);
    cp_async_commit();
  }
  int s = 0;
  for (int t = first; t < n_tiles; t += step) {
    // tile t's copies landed; every thread is past the previous tile
    cp_async_wait<kStages - 2>();
    __syncthreads();
    {
      const int tn = t + (kStages - 1) * step;
      const int sn = s == 0 ? kStages - 1 : s - 1;
      if (tn < n_tiles)
        load_tile<KT, kNhwc>(ring + sn * G::kTile, x, tn, tiles, hw, npix,
                             vec);
      cp_async_commit();
    }
    uint16_t* tile = ring + s * G::kTile;

    // (1) xb in place, the squares beside it
#pragma unroll
    for (int i = 0; i < G::kPerThread; ++i) {
      const int q = threadIdx.x + i * G::kThreads;
      const int r = q / G::kRowChunks, c = q % G::kRowChunks;
      const int off = tile_off<G::kWidth>(r, c);
      float b[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) b[e] = kNhwc ? bcol[e] : bias_f[r];
      const uint4 v = *reinterpret_cast<const uint4*>(tile + off);
      const uint2 e0 = bias_square(v.x, b[0], b[1]);
      const uint2 e1 = bias_square(v.y, b[2], b[3]);
      const uint2 e2 = bias_square(v.z, b[4], b[5]);
      const uint2 e3 = bias_square(v.w, b[6], b[7]);
      *reinterpret_cast<uint4*>(tile + off) =
          make_uint4(e0.x, e1.x, e2.x, e3.x);
      *reinterpret_cast<uint4*>(sq + off) = make_uint4(e0.y, e1.y, e2.y, e3.y);
    }
    __syncthreads();

    // (2) the channel mix, K steps in ascending order
    float acc[kP / 8][4];
#pragma unroll
    for (int f = 0; f < kP / 8; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[f][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
#pragma unroll
      for (int blk = 0; blk < kP / 16; ++blk) {
        uint32_t m[4];
        if constexpr (kNhwc) {
          // the squares of pixels 16 blk.. as A, K chunks 2 kk and 2 kk + 1
          ldmatrix_x4(sq_lane + 2 * (blk * 16 * C +
                                     (((kk * 2 + (lq >> 1)) ^ lr) << 3)),
                      m);
          mma_bf16(acc[2 * blk], m, a[kk][0], a[kk][2]);
          mma_bf16(acc[2 * blk + 1], m, a[kk][1], a[kk][3]);
        } else {
          // the squares of K rows 16 kk.. as B, pixel chunks 2 blk, + 1
          ldmatrix_x4_trans(
              sq_lane + 2 * (kk * 16 * kP +
                             (((blk * 2 + (lq >> 1)) ^ lr) << 3)),
              m);
          mma_bf16(acc[2 * blk], a[kk], m[0], m[1]);
          mma_bf16(acc[2 * blk + 1], a[kk], m[2], m[3]);
        }
      }
    }

    // (3) this warp's channels, over xb in place: each word is read and
    // written by one thread, and no other thread touches it
    if (inverse)
      epilogue<C, kNhwc, true>(tile, acc, warp, lane, bt);
    else
      epilogue<C, kNhwc, false>(tile, acc, warp, lane, bt);
    __syncthreads();

    // (4) out
    store_tile<KT, kNhwc>(out, tile, t, tiles, hw, npix, vec);
    s = s == kStages - 1 ? 0 : s + 1;
  }
  cp_async_wait<0>();
}

// C < 16: a thread takes kV pixels through every channel.  NCHW: a run of
// one image's row-major pixels; NHWC: the batch's pixels in memory order,
// kV C contiguous elements.
template <int C>
struct Small {
  static constexpr int kV = C <= 4 ? 8 : 4;
  static constexpr int kWords = kV * C / 2;    // NHWC: a run's bf16 pairs
};

template <int C, bool kInverse, bool kNhwc>
__device__ __forceinline__ void small_pass(
    const uint16_t* x, const float* bias_s, const float* beta_s,
    const float* gamma_s, uint16_t* out, int n_img, int hw, bool vec) {
  constexpr int kV = Small<C>::kV, kWords = Small<C>::kWords;
  const int64_t idx =
      static_cast<int64_t>(blockIdx.x) * kSmallThreads + threadIdx.x;
  int64_t base;     // the run's first element
  int n;            // its pixels that exist
  if constexpr (kNhwc) {
    const int64_t npix = static_cast<int64_t>(n_img) * hw, p = idx * kV;
    if (p >= npix) return;
    base = p * C;
    n = npix - p < kV ? static_cast<int>(npix - p) : kV;
  } else {
    const int runs = (hw + kV - 1) / kV;
    if (idx >= static_cast<int64_t>(n_img) * runs) return;
    const int b = static_cast<int>(idx / runs);
    const int p = static_cast<int>(idx - static_cast<int64_t>(b) * runs) * kV;
    base = static_cast<int64_t>(b) * C * hw + p;
    n = hw - p < kV ? hw - p : kV;
  }

  // w[j][e]: channel j at pixels 2e and 2e + 1 of the run, packed
  uint32_t w[C][kV / 2];
  if constexpr (kNhwc) {
    uint32_t raw[kWords];
    const uint16_t* g = x + base;
    if (vec) {
#pragma unroll
      for (int u = 0; u < kWords / 4; ++u) {
        const uint4 v = reinterpret_cast<const uint4*>(g)[u];
        raw[4 * u] = v.x; raw[4 * u + 1] = v.y;
        raw[4 * u + 2] = v.z; raw[4 * u + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int u = 0; u < kWords; ++u) {
        const uint32_t lo = 2 * u < n * C ? g[2 * u] : 0u;
        const uint32_t hi = 2 * u + 1 < n * C ? g[2 * u + 1] : 0u;
        raw[u] = lo | (hi << 16);
      }
    }
#pragma unroll
    for (int j = 0; j < C; ++j)
#pragma unroll
      for (int e = 0; e < kV / 2; ++e) {
        const int k0 = 2 * e * C + j, k1 = k0 + C;
        const uint32_t lo = (raw[k0 >> 1] >> (16 * (k0 & 1))) & 0xffffu;
        const uint32_t hi = (raw[k1 >> 1] >> (16 * (k1 & 1))) & 0xffffu;
        w[j][e] = lo | (hi << 16);
      }
  } else {
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const uint16_t* g = x + base + static_cast<int64_t>(j) * hw;
      if (vec) {
        if constexpr (kV == 8) {
          const uint4 v = *reinterpret_cast<const uint4*>(g);
          w[j][0] = v.x; w[j][1] = v.y; w[j][2] = v.z; w[j][3] = v.w;
        } else {
          const uint2 v = *reinterpret_cast<const uint2*>(g);
          w[j][0] = v.x; w[j][1] = v.y;
        }
      } else {
#pragma unroll
        for (int e = 0; e < kV / 2; ++e) {
          const uint32_t lo = 2 * e < n ? g[2 * e] : 0u;
          const uint32_t hi = 2 * e + 1 < n ? g[2 * e + 1] : 0u;
          w[j][e] = lo | (hi << 16);
        }
      }
    }
  }

  uint32_t xb[C][kV / 2];
  float sq[C][kV];
#pragma unroll
  for (int j = 0; j < C; ++j)
#pragma unroll
    for (int e = 0; e < kV / 2; ++e) {
      const uint2 r = bias_square(w[j][e], bias_s[j], bias_s[j]);
      xb[j][e] = r.x;
      sq[j][2 * e] = lo_f32(r.y);
      sq[j][2 * e + 1] = hi_f32(r.y);
    }
  uint32_t o[C][kV / 2];
#pragma unroll
  for (int i = 0; i < C; ++i)
#pragma unroll
    for (int e = 0; e < kV / 2; ++e) {
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int j = 0; j < C; ++j) {
        s0 = __fmaf_rn(gamma_s[i * C + j], sq[j][2 * e], s0);
        s1 = __fmaf_rn(gamma_s[i * C + j], sq[j][2 * e + 1], s1);
      }
      o[i][e] = finish<kInverse>(s0, s1, beta_s[i], beta_s[i], xb[i][e]);
    }

  if constexpr (kNhwc) {
    uint32_t raw[kWords];
#pragma unroll
    for (int u = 0; u < kWords; ++u) raw[u] = 0u;
#pragma unroll
    for (int i = 0; i < C; ++i)
#pragma unroll
      for (int e = 0; e < kV / 2; ++e) {
        const int k0 = 2 * e * C + i, k1 = k0 + C;
        raw[k0 >> 1] |= (o[i][e] & 0xffffu) << (16 * (k0 & 1));
        raw[k1 >> 1] |= (o[i][e] >> 16) << (16 * (k1 & 1));
      }
    uint16_t* g = out + base;
    if (vec) {
#pragma unroll
      for (int u = 0; u < kWords / 4; ++u)
        reinterpret_cast<uint4*>(g)[u] = make_uint4(
            raw[4 * u], raw[4 * u + 1], raw[4 * u + 2], raw[4 * u + 3]);
    } else {
#pragma unroll
      for (int u = 0; u < kWords; ++u) {
        if (2 * u < n * C) g[2 * u] = static_cast<uint16_t>(raw[u]);
        if (2 * u + 1 < n * C) g[2 * u + 1] = static_cast<uint16_t>(raw[u] >> 16);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < C; ++i) {
      uint16_t* g = out + base + static_cast<int64_t>(i) * hw;
      if (vec) {
        if constexpr (kV == 8)
          *reinterpret_cast<uint4*>(g) =
              make_uint4(o[i][0], o[i][1], o[i][2], o[i][3]);
        else
          *reinterpret_cast<uint2*>(g) = make_uint2(o[i][0], o[i][1]);
      } else {
#pragma unroll
        for (int e = 0; e < kV / 2; ++e) {
          if (2 * e < n) g[2 * e] = static_cast<uint16_t>(o[i][e]);
          if (2 * e + 1 < n) g[2 * e + 1] = static_cast<uint16_t>(o[i][e] >> 16);
        }
      }
    }
  }
}

template <int C, bool kNhwc>
__global__ void __launch_bounds__(kSmallThreads)
gdn_small_kernel(const uint16_t* __restrict__ x,
                 const uint16_t* __restrict__ bias,
                 const uint16_t* __restrict__ beta,
                 const uint16_t* __restrict__ gamma,
                 uint16_t* __restrict__ out, int n_img, int hw, int inverse,
                 int vec_flag) {
  __shared__ float gamma_s[C * C], beta_s[C], bias_s[C];
  for (int k = threadIdx.x; k < C * C; k += kSmallThreads)
    gamma_s[k] = bf16_f32(gamma[k]);
  for (int k = threadIdx.x; k < C; k += kSmallThreads) {
    beta_s[k] = bf16_f32(beta[k]);
    bias_s[k] = bias ? bf16_f32(bias[k]) : -0.0f;
  }
  __syncthreads();
  if (inverse)
    small_pass<C, true, kNhwc>(x, bias_s, beta_s, gamma_s, out, n_img, hw,
                               vec_flag != 0);
  else
    small_pass<C, false, kNhwc>(x, bias_s, beta_s, gamma_s, out, n_img, hw,
                                vec_flag != 0);
}

// a launch's arguments
struct Args {
  const uint16_t *x, *bias, *beta, *gamma;
  uint16_t* out;
  int n_img, hw, inverse;
  bool nhwc;
  cudaStream_t stream;
};

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// blocks a persistent launch keeps on the card, or a negative cudaError_t
template <int KT, bool kNhwc>
int resident_blocks() {
  static const int blocks = [] {
    using G = Mma<KT, kNhwc>;
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(gdn_mma_kernel<KT, kNhwc>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(G::kSmem));
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, gdn_mma_kernel<KT, kNhwc>, G::kThreads, G::kSmem);
    if (e != cudaSuccess) return -static_cast<int>(e);
    return per_sm * sms;
  }();
  return blocks;
}

template <int KT, bool kNhwc>
int launch_mma(const Args& a) {
  using G = Mma<KT, kNhwc>;
  const int blocks = resident_blocks<KT, kNhwc>();
  if (blocks < 0) return -blocks;
  if (blocks == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int64_t npix = static_cast<int64_t>(a.n_img) * a.hw;
  const int64_t n_tiles =
      kNhwc ? (npix + kP - 1) / kP
            : static_cast<int64_t>(a.n_img) * ((a.hw + kP - 1) / kP);
  const int grid = static_cast<int>(n_tiles < blocks ? n_tiles : blocks);
  // NHWC chunks are 8 channels of one pixel, 16-byte aligned when the
  // tensors are; NCHW chunks are 8 pixels of one channel row
  const int vec = (kNhwc || a.hw % 8 == 0) && aligned(a.x, 16) &&
                  aligned(a.out, 16);
  gdn_mma_kernel<KT, kNhwc><<<grid, G::kThreads, G::kSmem, a.stream>>>(
      a.x, a.bias, a.beta, a.gamma, a.out, a.n_img, a.hw, a.inverse, vec);
  return static_cast<int>(cudaGetLastError());
}

template <int C, bool kNhwc>
int launch_small(const Args& a) {
  constexpr int kV = Small<C>::kV, kWords = Small<C>::kWords;
  const int64_t npix = static_cast<int64_t>(a.n_img) * a.hw;
  const int64_t threads =
      kNhwc ? (npix + kV - 1) / kV
            : static_cast<int64_t>(a.n_img) * ((a.hw + kV - 1) / kV);
  const int64_t grid = (threads + kSmallThreads - 1) / kSmallThreads;
  // NHWC: a run is kV C contiguous elements, as 16-byte words where it is
  // a whole number of them; NCHW: kV elements of each channel row
  const int vec =
      kNhwc ? kWords % 4 == 0 && npix % kV == 0 && aligned(a.x, 16) &&
                  aligned(a.out, 16)
            : a.hw % kV == 0 && aligned(a.x, 2 * kV) && aligned(a.out, 2 * kV);
  gdn_small_kernel<C, kNhwc><<<static_cast<unsigned>(grid), kSmallThreads, 0,
                               a.stream>>>(a.x, a.bias, a.beta, a.gamma,
                                           a.out, a.n_img, a.hw, a.inverse,
                                           vec);
  return static_cast<int>(cudaGetLastError());
}

template <int KT>
int launch_mma_in(const Args& a) {
  return a.nhwc ? launch_mma<KT, true>(a) : launch_mma<KT, false>(a);
}

template <int C>
int launch_small_in(const Args& a) {
  return a.nhwc ? launch_small<C, true>(a) : launch_small<C, false>(a);
}

}  // namespace

extern "C" {

// x, out (B, C, H*W) bf16, NCHW (nhwc == 0) or channels-last (nhwc != 0);
// bias (C,) bf16 or null; beta (C,), gamma (C, C) bf16; inverse != 0 for
// IGDN.  Returns the cudaError_t of the launch (0 = success); -1, having
// launched nothing, for C other than 3, 128 and 192, B < 1, H*W < 1,
// B*H*W >= 2^33, or a gamma that is not 4-byte aligned (its rows are read
// as bf16 pairs).
int hesic_gdn(const void* x, const void* bias, const void* beta,
              const void* gamma, void* out, int B, int C, int HW, int nhwc,
              int inverse, void* stream) {
  if (B < 1 || HW < 1 || static_cast<int64_t>(B) * HW / 4 >= (1ll << 31) ||
      !aligned(gamma, 4))
    return -1;
  const Args a{static_cast<const uint16_t*>(x),
               static_cast<const uint16_t*>(bias),
               static_cast<const uint16_t*>(beta),
               static_cast<const uint16_t*>(gamma),
               static_cast<uint16_t*>(out), B, HW, inverse != 0, nhwc != 0,
               static_cast<cudaStream_t>(stream)};
  switch (C) {
    case 3:
      return launch_small_in<3>(a);
    case 128:
      return launch_mma_in<8>(a);
    case 192:
      return launch_mma_in<12>(a);
    default:
      return -1;
  }
}

}  // extern "C"
