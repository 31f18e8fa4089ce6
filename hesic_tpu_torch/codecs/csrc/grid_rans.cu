// Grid rANS encode and decode over frequency rows, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of hesic_tpu/codecs/pallas_rans.py:
//   * hesic_grid_rans_encode <- _enc_kernel/_enc_step via
//     rans_encode_grid_pallas;
//   * hesic_grid_rans_decode <- _dec_kernel/_dec_step via
//     rans_decode_grid_pallas.
//
// Coder: rANS, 32-bit state, 16-bit probability resolution (rows sum to
// 2^16, every bin >= 1), lower bound L = 2^16, u16 renormalization words.
// Layouts (row-major, as the JAX package):
//   freq   (B, M, S, hw) int32   frequency rows, positions minor
//   sym    (M, B, hw)    int32   grid symbols in [0, S)
//   words  (B, CAP, ls)  int32   per-lane u16 words in emission order
//   counts (B, ls) int32, states (B, ls) int64 (u32 values)
// ls = hw / ppl.  Lane l of pair b codes positions j*ls + l, j = 0..ppl-1,
// as micro-steps t = m*ppl + j: the encoder walks t downwards, the decoder
// upwards and reads the lane's words backwards from counts-1.
//
// What bounds these kernels on an H100: by bytes, each reads the
// (B, M, S, hw) rows once (~0.1 ms at 3.35 TB/s for the main path's
// B=8, M=192, S=33..65, hw=1024), and neither does more than a few
// integer operations per byte.  What sets the time of this first,
// simple design is latency: one thread owns one lane (1024 lanes at
// B=8, ls=128), and each thread walks a dependent chain of M*ppl = 1536
// steps, each with a global load of its symbol and up to S row entries.
// The design keeps every global access coalesced (neighbouring threads
// are neighbouring lanes, hence neighbouring addresses) and does the
// division exactly in u32 (x / f): the TPU kernel's f32-reciprocal
// quotient with a +-1 correction exists only because the TPU's vector
// unit has no fast integer divide, and gives the same integers.
// More lanes in flight (splitting a lane's row search across a warp,
// or several pairs per block) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kProbBits = 16;
constexpr uint32_t kRansL = 1u << 16;

__global__ void grid_rans_encode_kernel(const int32_t* __restrict__ freq,
                                        const int32_t* __restrict__ sym,
                                        int32_t* __restrict__ words,
                                        int32_t* __restrict__ counts,
                                        int64_t* __restrict__ states,
                                        int B, int M, int S, int hw, int ppl,
                                        int cap) {
  const int ls = hw / ppl;
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (lane >= ls) return;
  uint32_t x = kRansL;
  int p = 0;
  int32_t* wl = words + static_cast<int64_t>(b) * cap * ls + lane;
  for (int t = M * ppl - 1; t >= 0; --t) {
    const int m = t / ppl;
    const int pos = (t - m * ppl) * ls + lane;
    const int s = sym[(static_cast<int64_t>(m) * B + b) * hw + pos];
    const int32_t* row = freq + (static_cast<int64_t>(b) * M + m) * S * hw
                         + pos;
    uint32_t start = 0;
    for (int k = 0; k < s; ++k) start += static_cast<uint32_t>(row[k * hw]);
    const uint32_t f = static_cast<uint32_t>(row[s * hw]);
    if (x >= (f << kProbBits)) {
      if (p < cap) wl[static_cast<int64_t>(p) * ls] = x & 0xFFFFu;
      ++p;  // counts past `cap` signal overflow to the caller
      x >>= kProbBits;
    }
    const uint32_t q = x / f;
    x = (q << kProbBits) + (x - q * f) + start;
  }
  for (int k = p < cap ? p : cap; k < cap; ++k)
    wl[static_cast<int64_t>(k) * ls] = 0;
  counts[b * ls + lane] = p;
  states[b * ls + lane] = static_cast<int64_t>(x);
}

__global__ void grid_rans_decode_kernel(const int32_t* __restrict__ freq,
                                        const int32_t* __restrict__ words,
                                        const int32_t* __restrict__ counts,
                                        const int64_t* __restrict__ states,
                                        int32_t* __restrict__ syms,
                                        int B, int M, int S, int hw, int ppl,
                                        int cap) {
  const int ls = hw / ppl;
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (lane >= ls) return;
  uint32_t x = static_cast<uint32_t>(states[b * ls + lane]);
  int p = counts[b * ls + lane];
  const int32_t* wl = words + static_cast<int64_t>(b) * cap * ls + lane;
  for (int t = 0; t < M * ppl; ++t) {
    const int m = t / ppl;
    const int pos = (t - m * ppl) * ls + lane;
    const int32_t* row = freq + (static_cast<int64_t>(b) * M + m) * S * hw
                         + pos;
    const uint32_t cf = x & 0xFFFFu;
    // symbol = number of inclusive CDF entries <= cf; the last entry of a
    // valid row is 2^16 > cf, so the bound only guards malformed rows
    uint32_t start = 0;
    uint32_t f = static_cast<uint32_t>(row[0]);
    int s = 0;
    while (s < S - 1 && start + f <= cf) {
      start += f;
      ++s;
      f = static_cast<uint32_t>(row[s * hw]);
    }
    uint32_t xn = f * (x >> kProbBits) + cf - start;
    if (xn < kRansL) {
      int pr = p - 1;
      pr = pr < 0 ? 0 : (pr > cap - 1 ? cap - 1 : pr);
      const uint32_t w = static_cast<uint32_t>(
          wl[static_cast<int64_t>(pr) * ls]);
      xn = (xn << kProbBits) | w;
      --p;
    }
    x = xn;
    syms[(static_cast<int64_t>(m) * B + b) * hw + pos] = s;
  }
}

constexpr int kThreads = 128;

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 = success).
int hesic_grid_rans_encode(const void* freq, const void* sym, void* words,
                           void* counts, void* states, int B, int M, int S,
                           int hw, int ppl, int cap, void* stream) {
  const int ls = hw / ppl;
  dim3 grid((ls + kThreads - 1) / kThreads, B);
  grid_rans_encode_kernel<<<grid, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(freq), static_cast<const int32_t*>(sym),
      static_cast<int32_t*>(words), static_cast<int32_t*>(counts),
      static_cast<int64_t*>(states), B, M, S, hw, ppl, cap);
  return static_cast<int>(cudaGetLastError());
}

int hesic_grid_rans_decode(const void* freq, const void* words,
                           const void* counts, const void* states, void* syms,
                           int B, int M, int S, int hw, int ppl, int cap,
                           void* stream) {
  const int ls = hw / ppl;
  dim3 grid((ls + kThreads - 1) / kThreads, B);
  grid_rans_decode_kernel<<<grid, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(freq), static_cast<const int32_t*>(words),
      static_cast<const int32_t*>(counts),
      static_cast<const int64_t*>(states), static_cast<int32_t*>(syms), B, M,
      S, hw, ppl, cap);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
