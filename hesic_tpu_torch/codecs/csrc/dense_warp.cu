// DSIC's dense warp, a disparity-weighted horizontal shift-accumulate, for
// Hopper (sm_90a):
//
//   out[b, n, y, x] = sum_{d=0..C-1} cost[b, d, y, x] * h1[b, n, y, x + d],
//
// the term zero where x + d >= W.  h1 and out are (B, N, H, W), cost is
// (B, C, H, W), all of one type, bf16 or f32, contiguous.
//
// Replaces no TPU kernel: the JAX package leaves dense_warp to XLA
// (hesic_tpu/models/dsic.py).  Its plain twin, models/dsic.py's
// dense_warp_plain, is C in-place addcmul_ passes over a zeroed output,
// each reading the output, an offset slice of a padded copy of h1 and a
// cost channel: at DSIC's bench point (B=32, N=128, C=32) about 53 GB of
// traffic at 256x256, ~95 ms a batch over the codec's six calls.
//
// Arithmetic, the twin's exactly.  The running value starts at +0 and
// takes the shifts in ascending d.  On bf16 each shift is
// round_bf16(float(acc) + float(c) * float(h)), as PyTorch's addcmul_
// computes a bf16 tensor: the product of two bf16 values is exact in f32,
// so one fused multiply-add (__fmaf_rn) rounds the sum to f32 once, and
// cvt.rn.bf16x2.f32 rounds that to bf16 (nearest, ties to even), the
// result kept as the f32 it widens to.  A packed bf16 FMA would round the
// exact sum once and can differ from that double rounding, so it is not
// used.  On f32 each shift is the same __fmaf_rn without the bf16
// rounding: the product and the sum rounded to f32 once, as addcmul_'s
// contracted float arithmetic on the card.  Past the right edge the feature window holds zeros,
// as the twin's padded copy does, so those taps add c * 0 as the twin's
// do.
//
// What bounds it on an H100: arithmetic.  The bytes are few (h1 and the
// costs read once, the output written once: 1.21 GB at B=32, N=128,
// 256x256, 0.36 ms at 3.35 TB/s), but every output takes C multiply-adds,
// each followed by its rounding: 8.6 G of each at 256x256, 22.5 G a batch
// over the six calls.  Each running value is a chain of C dependent
// multiply-add and rounding pairs, so the card is kept busy by many
// chains in flight, and the inner loop holds nothing but the chains:
//   * a block stages the costs of its row segment (C x R*4 values, as
//     f32) in shared memory once and reuses them for every channel (the
//     costs do not depend on the channel);
//   * a thread makes 4 neighbouring outputs of the row for two channels
//     at a time: 8 independent chains.  Per channel it loads the feature
//     window h1[x0, x0 + 36) into registers with 8-byte (bf16) or 16-byte
//     (f32) loads, zero past W; the R threads of a row segment load
//     neighbouring addresses, so each load instruction reads one
//     contiguous run;
//   * the shifts are unrolled: the window slides in registers, each
//     feature is widened to f32 once, and each shift is one FFMA and one
//     F2FP (the rounding, whose packed result's upper half is the rounded
//     value as an f32 bit pattern, so nothing is unpacked) per chain;
//   * the outputs go out with one 8-byte or 16-byte store a chain;
//   * registers stay at most 85 a thread (the f32 path spills a few), so
//     three blocks share an SM (24 warps, 192 chains) and hide the loads'
//     latency without prefetching.
// Measured on an H100 at B=32, N=128, C=32, 256x256: 1.58 ms, against
// 2.75 ms for one channel a thread with the costs in registers (148
// registers: 8 warps an SM).  Rounding by an exponent-matched add and
// subtract instead of F2FP was slower (2.64 against 2.07 ms with one
// channel a thread, half the chains so rounded).
//
// A block is 256 threads: groups of R threads (32, or 16 / 8 where W is
// at most 64 / 32) share one row segment of R * 4 columns and split the
// channels between them.  Grid: (row segments, H, B).  No atomics: the
// result does not depend on the launch shape.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCMax = 32;                    // disparities a launch takes
constexpr int kV = 4;                        // outputs a thread makes
constexpr int kChunks = (kCMax + kV - 1 + kV - 1) / kV;   // 9 window chunks
constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 3;              // caps registers at 85
constexpr int kMaxR = 32;                    // threads a row segment, most
constexpr int kPair = 2;                     // channels a thread sums at once

// x rounded to bf16 (nearest, ties to even), as an f32 whose low 16 bits
// are zero: the upper half of cvt.rn.bf16x2.f32's packed result.
__device__ __forceinline__ float round_bf16(float x) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(x), "f"(0.0f));
  return __uint_as_float(r);
}

// bf16 features as raw 16-bit words, four to a chunk (one uint2).
struct Bf16 {
  using E = uint16_t;
  using Chunk = uint2;
  __device__ static Chunk zero() { return make_uint2(0u, 0u); }
  // elements x .. x+3 of `row`, zero at and past W
  __device__ static Chunk load(const E* row, int x, int w, bool vec) {
    if (vec) {
      return x < w ? __ldg(reinterpret_cast<const uint2*>(row + x)) : zero();
    }
    uint32_t e[kV];
#pragma unroll
    for (int k = 0; k < kV; ++k) e[k] = x + k < w ? row[x + k] : 0u;
    return make_uint2(e[0] | (e[1] << 16), e[2] | (e[3] << 16));
  }
  __device__ static float get(const Chunk& c, int k) {
    const uint32_t w = k < 2 ? c.x : c.y;
    return __uint_as_float(k & 1 ? w & 0xffff0000u : w << 16);
  }
  __device__ static float step(float acc, float c, float h) {
    return round_bf16(__fmaf_rn(c, h, acc));
  }
  __device__ static void store(E* row, int x, int w, bool vec,
                               const float* a) {
    uint32_t u[kV];
#pragma unroll
    for (int k = 0; k < kV; ++k) u[k] = __float_as_uint(a[k]);
    if (vec) {
      *reinterpret_cast<uint2*>(row + x) =
          make_uint2(__byte_perm(u[0], u[1], 0x7632),
                     __byte_perm(u[2], u[3], 0x7632));
      return;
    }
#pragma unroll
    for (int k = 0; k < kV; ++k)
      if (x + k < w) row[x + k] = static_cast<E>(u[k] >> 16);
  }
};

struct F32 {
  using E = float;
  using Chunk = float4;
  __device__ static Chunk zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ static Chunk load(const E* row, int x, int w, bool vec) {
    if (vec) {
      return x < w ? __ldg(reinterpret_cast<const float4*>(row + x)) : zero();
    }
    float e[kV];
#pragma unroll
    for (int k = 0; k < kV; ++k) e[k] = x + k < w ? row[x + k] : 0.f;
    return make_float4(e[0], e[1], e[2], e[3]);
  }
  __device__ static float get(const Chunk& c, int k) {
    return k == 0 ? c.x : k == 1 ? c.y : k == 2 ? c.z : c.w;
  }
  __device__ static float step(float acc, float c, float h) {
    return __fmaf_rn(c, h, acc);
  }
  __device__ static void store(E* row, int x, int w, bool vec,
                               const float* a) {
    if (vec) {
      *reinterpret_cast<float4*>(row + x) = make_float4(a[0], a[1], a[2], a[3]);
      return;
    }
#pragma unroll
    for (int k = 0; k < kV; ++k)
      if (x + k < w) row[x + k] = a[k];
  }
};

template <class T>
__device__ __forceinline__ void load_window(typename T::Chunk* win,
                                            const typename T::E* row, int x0,
                                            int w, bool vec) {
#pragma unroll
  for (int i = 0; i < kChunks; ++i) win[i] = T::load(row, x0 + i * kV, w, vec);
}

// r: threads a row segment (32, 16 or 8); vec: W and every pointer allow
// the chunked loads and stores.
template <class T>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
dense_warp_kernel(const typename T::E* __restrict__ h1,
                  const typename T::E* __restrict__ cost,
                  typename T::E* __restrict__ out, int n_ch, int c_dis,
                  int h, int w, int r, int vec_flag) {
  using E = typename T::E;
  using Chunk = typename T::Chunk;
  __shared__ float4 costs[kCMax][kMaxR];   // [d][thread of the segment]
  const bool vec = vec_flag != 0;
  const int groups = kThreads / r;
  const int g = threadIdx.x / r;
  const int lane = threadIdx.x % r;
  const int x0 = (blockIdx.x * r + lane) * kV;
  const int y = blockIdx.y;
  const int b = blockIdx.z;
  const int64_t plane = static_cast<int64_t>(h) * w;

  for (int i = threadIdx.x; i < c_dis * r; i += kThreads) {
    const int d = i / r, l = i % r;
    const Chunk ch = T::load(
        cost + ((static_cast<int64_t>(b) * c_dis + d) * h + y) * w,
        (blockIdx.x * r + l) * kV, w, vec);
    costs[d][l] = make_float4(T::get(ch, 0), T::get(ch, 1), T::get(ch, 2),
                              T::get(ch, 3));
  }
  __syncthreads();
  if (x0 >= w) return;

  const int64_t first = (static_cast<int64_t>(b) * n_ch * h + y) * w;
  const E* hrow = h1 + first;
  E* orow = out + first;
  for (int n = g; n < n_ch; n += kPair * groups) {
    Chunk win[kPair][kChunks];
    float acc[kPair][kV];
#pragma unroll
    for (int k = 0; k < kPair; ++k) {
      if (n + k * groups < n_ch) {
        load_window<T>(win[k], hrow + (n + k * groups) * plane, x0, w, vec);
      } else {
#pragma unroll
        for (int i = 0; i < kChunks; ++i) win[k][i] = T::zero();
      }
#pragma unroll
      for (int v = 0; v < kV; ++v) acc[k][v] = 0.f;
    }
#pragma unroll
    for (int d = 0; d < kCMax; ++d) {
      if (d >= c_dis) break;
      const float4 cv = costs[d][lane];
      const float c[kV] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
      for (int k = 0; k < kPair; ++k)
#pragma unroll
        for (int v = 0; v < kV; ++v) {
          const int j = d + v;
          acc[k][v] = T::step(acc[k][v], c[v], T::get(win[k][j / kV], j % kV));
        }
    }
#pragma unroll
    for (int k = 0; k < kPair; ++k)
      if (n + k * groups < n_ch)
        T::store(orow + (n + k * groups) * plane, x0, w, vec, acc[k]);
  }
}

template <class T>
int launch(const void* h1, const void* cost, void* out, int B, int N, int C,
           int H, int W, cudaStream_t stream) {
  const uintptr_t align = sizeof(typename T::Chunk) - 1;
  const uintptr_t bits = reinterpret_cast<uintptr_t>(h1) |
                         reinterpret_cast<uintptr_t>(cost) |
                         reinterpret_cast<uintptr_t>(out);
  const int vec = W % kV == 0 && (bits & align) == 0;
  const int r = W > 64 ? 32 : W > 32 ? 16 : 8;
  const dim3 grid((W + r * kV - 1) / (r * kV), H, B);
  using E = typename T::E;
  dense_warp_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const E*>(h1), static_cast<const E*>(cost),
      static_cast<E*>(out), N, C, H, W, r, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// h1, out (B, N, H, W) and cost (B, C, H, W), bf16 when bf16 != 0 else
// f32.  Returns the cudaError_t of the launch (0 = success); -1, having
// launched nothing, for sizes outside 1 <= C <= 32, 1 <= H, B <= 65535,
// N, W >= 1.
int hesic_dense_warp(const void* h1, const void* cost, void* out, int B,
                     int N, int C, int H, int W, int bf16, void* stream) {
  if (C < 1 || C > kCMax || B < 1 || B > 65535 || H < 1 || H > 65535 ||
      N < 1 || W < 1)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<Bf16>(h1, cost, out, B, N, C, H, W, st)
              : launch<F32>(h1, cost, out, B, N, C, H, W, st);
}

}  // extern "C"
