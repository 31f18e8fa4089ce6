// Slot-stream rANS encoder of precomputed (start, freq) intervals, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel hesic_tpu/codecs/pallas_rans.py::
// _pairs_enc_kernel (rans_encode_pairs_pallas), the encoder of the
// wavefront autoregressive codec's slot stream.
//
// Coder: rANS, 32-bit state, 16-bit probability resolution, lower bound
// L = 2^16, u16 renormalization words (the port's device_rans format).
// Layouts:
//   starts, freqs  (T, L) int32   interval of slot t, lane l (u32 values)
//   valid          (T, L) uint8   0 = the slot is skipped
//   words          (L, CAP) int32 per-lane u16 words in emission order;
//                  entries past a lane's count are left unwritten
//   counts (L,) int32 true word counts, states (L,) int64 (u32 values)
// Each lane walks its T slots in reverse.  Words past CAP are not written
// but still counted, so counts > CAP tells the caller to retry with a
// larger CAP (the TPU kernel's contract).
//
// What bounds it on an H100: bytes.  It reads the valid byte of every
// (slot, lane), the 8 bytes of (start, freq) of valid ones only, and
// writes each lane's emitted words once (at the HESIC+ point, T = 1000,
// L = 2904: 2.2M valid slots, ~1.3M words per eye with random weights,
// ~25 MB in all, ~8 us at 3.35 TB/s).  This first,
// simple design is latency-bound instead: one thread per lane walks a
// dependent chain of T steps (2904 lanes fill 23 blocks of 128 on 132
// SMs).  Neighbouring threads are neighbouring lanes, so every slot's
// loads are coalesced; the word stores (stride CAP) are not, but there
// is at most one per step.  Division is exact in u32 (x / f): the TPU
// kernel's f32-reciprocal quotient with a +-1 correction exists only
// because the TPU's vector unit has no integer divide, and gives the
// same integers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kProbBits = 16;
constexpr uint32_t kRansL = 1u << 16;

__global__ void pairs_rans_encode_kernel(const int32_t* __restrict__ starts,
                                         const int32_t* __restrict__ freqs,
                                         const uint8_t* __restrict__ valid,
                                         int32_t* __restrict__ words,
                                         int32_t* __restrict__ counts,
                                         int64_t* __restrict__ states, int T,
                                         int L, int cap) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= L) return;
  uint32_t x = kRansL;
  int p = 0;
  int32_t* wl = words + static_cast<int64_t>(lane) * cap;
  for (int t = T - 1; t >= 0; --t) {
    const int64_t at = static_cast<int64_t>(t) * L + lane;
    if (!valid[at]) continue;
    const uint32_t f = static_cast<uint32_t>(freqs[at]);
    if (x >= (f << kProbBits)) {
      if (p < cap) wl[p] = static_cast<int32_t>(x & 0xFFFFu);
      ++p;  // counts past `cap` signal overflow to the caller
      x >>= kProbBits;
    }
    const uint32_t q = x / f;
    x = (q << kProbBits) + (x - q * f) + static_cast<uint32_t>(starts[at]);
  }
  counts[lane] = p;
  states[lane] = static_cast<int64_t>(x);
}

constexpr int kThreads = 128;

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 = success).
int hesic_pairs_rans_encode(const void* starts, const void* freqs,
                            const void* valid, void* words, void* counts,
                            void* states, int T, int L, int cap,
                            void* stream) {
  pairs_rans_encode_kernel<<<(L + kThreads - 1) / kThreads, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(starts), static_cast<const int32_t*>(freqs),
      static_cast<const uint8_t*>(valid), static_cast<int32_t*>(words),
      static_cast<int32_t*>(counts), static_cast<int64_t*>(states), T, L,
      cap);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
