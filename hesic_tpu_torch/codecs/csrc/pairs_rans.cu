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
//   valid          (T, L) uint8   0 = the slot is skipped (its freq may
//                                 be 0)
//   words          (L, CAP) int32 per-lane u16 words in emission order;
//                  entries past a lane's count are left unwritten
//   counts (L,) int32 true word counts, states (L,) int64 (u32 values)
// Each lane walks its T slots in reverse.  Words past CAP are not written
// but still counted (the TPU kernel's contract).  A valid slot emits at
// most one word, so CAP = T always holds every word.
//
// What bounds it on an H100: bytes.  It reads the valid byte of every
// (slot, lane), start and freq of the valid ones, and writes each lane's
// words once (at the HESIC+ point, T = 1000, L = 2904: 2.2M valid slots,
// ~1.3M words per eye with random weights, ~26 MB, ~8 us at 3.35 TB/s).
// What sets its time is each lane's state chain: T dependent steps (all
// 1000 valid in the lanes of a level's first pixel), so a step costs its
// latency.  Nothing the chain reads depends on the state, so the design
// takes everything but the arithmetic off the chain (the structure of
// the grid encoder in grid_rans.cu, fitted to slots):
//   * a block owns a lane group, 8 consecutive lanes (a ragged last group
//     is masked): ceil(L / 8) blocks, 363 at the HESIC+ point;
//   * H helper warps stage the walk K slots at a time (a stage: slots
//     T-1-iK down to T-K-iK) into a ring of D shared-memory stages with
//     cp.async, completing on an mbarrier: the starts and freqs as 8-lane
//     row segments, the valid bytes as the three aligned words around
//     them.  Then they turn each (slot, lane) into an entry (x_max - 1,
//     1/f, f, start): the renorm bound, the exact reciprocal floor((2^32
//     - 1) / f), and an identity entry (start 0, f 2^16, no renorm) for a
//     skipped slot, so the chain never tests validity;
//   * one chain warp (thread l serves lane l) waits once per stage on its
//     full mbarrier, reads the stage's K entries into registers, and
//     walks them: the renorm test, the quotient as umulhi(x, 1/f) plus at
//     most one correction (for 2^32 - 1 = inv*f + rem, x*inv / 2^32 =
//     x/f - x*(1 + rem) / (f * 2^32) and x*(1 + rem) < f * 2^32), and the
//     state x + start + q * (2^16 - f), which is (q << 16) + x - q*f +
//     start.  The TPU kernel's f32-reciprocal quotient with a +-1
//     correction gives the same integers;
//   * words go out through shared memory: an arrival on the empty
//     barrier is a release and would wait for the chain's earlier global
//     stores, so the chain writes each word into a per-lane ring of R
//     words and records each lane's count before and after the stage.
//     The helper that refills the stage (or, for the last D stages, its
//     owner) stores the 4-word chunks completed in it, 16 bytes at a time
//     where CAP allows, skipping words past CAP; the last stage's owner
//     also stores each lane's incomplete last chunk.  A chunk completed
//     in stage j is stored before stage j + D is filled, and the chain
//     writes fewer than D*K + 4 words in between, so R >= D*K + 4 keeps
//     every word in the ring until it is stored.
// Integer arithmetic only, no atomics: the result does not depend on D,
// H or the block count.  K is fixed at 16.  The plan (D, H, stages
// ahead, copy width, R, shared-memory bytes) comes from
// pairs_rans.pairs_plan; the entry point returns -1, launching nothing,
// for a plan outside the limits below.

#include <cuda_runtime.h>
#include <stdint.h>

#include "staging.cuh"

namespace {

constexpr uint32_t kProbBits = 16;
constexpr uint32_t kRansL = 1u << 16;
constexpr int kLg = 8;              // lanes a block owns
constexpr int kK = 16;              // slots a stage holds
constexpr int kValidWords = 3;      // int32 around a slot's 8 valid bytes
constexpr int kMaxSmem = 232448;    // 227 KB, a block's opt-in maximum
constexpr int kMaxThreads = 512;    // up to 15 helper warps

// A stage of K slots, in int32: the entries (K x 8 uint4), the staged
// starts and freqs (K x 8 each), the valid words (K x 3), then each
// lane's word count before and after the stage (8 + 8, the chain's).
constexpr int kStarts = 4 * kLg * kK;
constexpr int kFreqs = kStarts + kLg * kK;
constexpr int kValid = kFreqs + kLg * kK;
constexpr int kP0 = kValid + kValidWords * kK;
constexpr int kP1 = kP0 + kLg;
constexpr int kStageInts = kP1 + kLg;
static_assert(kStageInts % 4 == 0, "stages stay 16-byte aligned");

struct Geometry {
  int T, L, cap, d, helpers, ahead, ring;
  int ns;               // stages: ceil(T / K)
  int l0, nl;           // this block: first lane, lanes (<= kLg)
};

// 4 bytes global -> shared, of which the first `bytes` (0-4) are read
// and the rest zero-filled (src must be a mapped 4-byte aligned address).
__device__ __forceinline__ void cp_async_part(int32_t* dst,
                                              const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// Slot t of walk position s: the walk runs the slots in reverse.
__device__ __forceinline__ int slot_of(const Geometry& g, int s) {
  return g.T - 1 - s;
}

// Stages stage i's K slots (starts, freqs, valid words) into `tile` and
// arrives on `bar` when they have landed; slots before t = 0 and lanes
// past the group's nl are zero-filled (a zero valid byte).
template <int kVec>
__device__ void load_stage(const int32_t* __restrict__ starts,
                           const int32_t* __restrict__ freqs,
                           const uint8_t* __restrict__ valid,
                           const Geometry& g, int i, int32_t* tile,
                           uint64_t* bar, int tid) {
  constexpr int nvec = kLg / kVec;          // copies per row segment
  constexpr int kstep = kWarp / nvec;
  const int lane = (tid % nvec) * kVec;
  for (int k = tid / nvec; k < kK; k += kstep) {
    const int t = slot_of(g, i * kK + k);
    const bool ok = t >= 0 && lane < g.nl;
    const int64_t at = static_cast<int64_t>(t) * g.L + g.l0 + lane;
    cp_async<kVec>(tile + kStarts + k * kLg + lane,
                   ok ? starts + at : starts, ok);
    cp_async<kVec>(tile + kFreqs + k * kLg + lane,
                   ok ? freqs + at : freqs, ok);
  }
  const int64_t total = static_cast<int64_t>(g.T) * g.L;
  for (int j = tid; j < kK * kValidWords; j += kWarp) {
    const int k = j / kValidWords;
    const int t = slot_of(g, i * kK + k);
    const int64_t at = ((static_cast<int64_t>(t) * g.L + g.l0) & ~int64_t{3}) +
                       4 * (j - k * kValidWords);
    const int64_t left = t >= 0 ? total - at : 0;
    const int bytes = static_cast<int>(left < 0 ? 0 : (left > 4 ? 4 : left));
    cp_async_part(tile + kValid + j, bytes ? valid + at : valid, bytes);
  }
  cp_async_arrive(bar);
}

// The staged slots -> the chain's entries (x_max - 1, inv, f, start).
// As the plain twin, a valid slot's freq is taken as at least 1; the
// renorm test x >= f << 16 becomes x > x_max - 1, which never holds for
// f >= 2^16.  A skipped slot gets the identity entry (x_max - 1 =
// 2^32 - 1, f = 2^16, start 0): x stays x.
__device__ void make_entries(int32_t* tile, const Geometry& g, int i,
                             int tid) {
  const int lane = tid % kLg;
  const uint8_t* vb = reinterpret_cast<const uint8_t*>(tile + kValid);
  uint4* entries = reinterpret_cast<uint4*>(tile);
  for (int k = tid / kLg; k < kK; k += kWarp / kLg) {
    const int t = slot_of(g, i * kK + k);
    const int off = static_cast<int>((static_cast<int64_t>(t) * g.L + g.l0) &
                                     3);
    uint4 e = make_uint4(0xFFFFFFFFu, 0xFFFFu, 1u << kProbBits, 0u);
    if (lane < g.nl && vb[kValidWords * 4 * k + off + lane] != 0) {
      uint32_t f = static_cast<uint32_t>(tile[kFreqs + k * kLg + lane]);
      f = f ? f : 1u;
      e.x = f >= (1u << kProbBits) ? 0xFFFFFFFFu : (f << kProbBits) - 1u;
      e.y = 0xFFFFFFFFu / f;
      e.z = f;
      e.w = static_cast<uint32_t>(tile[kStarts + k * kLg + lane]);
    }
    entries[k * kLg + lane] = e;
  }
}

// Stores the words of `tile`'s stage: per lane the 4-word chunks that the
// stage completed, from the lane's word ring, and with `last` the lane's
// incomplete final chunk; words at or past CAP are skipped.
__device__ void flush_words(int32_t* __restrict__ words,
                            const int32_t* tile, const int32_t* wring,
                            const Geometry& g, bool last, int tid) {
  const int lane = tid % kLg;
  if (lane >= g.nl) return;
  const int p0 = tile[kP0 + lane];
  const int p1 = tile[kP1 + lane];
  const int32_t* src = wring + lane * (g.ring + 4);
  int32_t* dst = words + static_cast<int64_t>(g.l0 + lane) * g.cap;
  const int mask = g.ring - 1;
  const bool vec = (g.cap & 3) == 0;
  for (int w = 4 * (p0 / 4 + tid / kLg); w + 4 <= p1 && w < g.cap;
       w += 4 * (kWarp / kLg)) {
    const int4 v = *reinterpret_cast<const int4*>(src + (w & mask));
    if (vec) {
      *reinterpret_cast<int4*>(dst + w) = v;
    } else {
      const int32_t part[4] = {v.x, v.y, v.z, v.w};
      for (int c = 0; c < 4 && w + c < g.cap; ++c) dst[w + c] = part[c];
    }
  }
  if (last && tid < kLg) {
    for (int w = p1 & ~3; w < p1 && w < g.cap; ++w) dst[w] = src[w & mask];
  }
}

// Helper warp h (0-based): stages and prepares the stages i = h, h+H, ...
// each into ring stage i % D, keeping `ahead` of its own stages loading
// ahead.  A stage is refilled once the chain has released the stage D
// before it, whose words the refilling helper stores first; with D >=
// (ahead + 1) * H that stage was made ready earlier, and the D - ahead*H
// stages not loading hold ready stages for the chain.
template <int kVec>
__device__ void helper(const int32_t* __restrict__ starts,
                       const int32_t* __restrict__ freqs,
                       const uint8_t* __restrict__ valid,
                       int32_t* __restrict__ words, const Geometry& g,
                       const Ring& r, const int32_t* wring, int h, int tid) {
  const int own = g.ns > h ? (g.ns - h + g.helpers - 1) / g.helpers : 0;
  auto issue = [&](int q) {
    const int i = h + q * g.helpers;
    const int st = i % g.d;
    const int use = i / g.d;
    if (use > 0) {
      mbar_wait(&r.empty[st], (use - 1) & 1);
      flush_words(words, r.tile(st), wring, g, false, tid);
    }
    load_stage<kVec>(starts, freqs, valid, g, i, r.tile(st), &r.loaded[st],
                     tid);
  };
  for (int q = 0; q < min(g.ahead, own); ++q) issue(q);
  for (int q = 0; q < own; ++q) {
    const int i = h + q * g.helpers;
    const int st = i % g.d;
    mbar_wait(&r.loaded[st], (i / g.d) & 1);
    make_entries(r.tile(st), g, i, tid);
    warp_arrive(&r.full[st], tid);
    if (q + g.ahead < own) issue(q + g.ahead);
  }
  for (int q = 0; q < own; ++q) {     // own stages no later stage refills
    const int i = h + q * g.helpers;
    if (i + g.d < g.ns) continue;
    mbar_wait(&r.empty[i % g.d], (i / g.d) & 1);
    flush_words(words, r.tile(i % g.d), wring, g, i == g.ns - 1, tid);
  }
}

// The chain warp: thread tid serves lane tid (threads past 8 repeat the
// last lane's arithmetic and write nothing).
__device__ void chain(const Geometry& g, const Ring& r, int32_t* wring,
                      int32_t* __restrict__ counts,
                      int64_t* __restrict__ states, int tid) {
  const int lane = min(tid, kLg - 1);
  const bool writer = tid < kLg;
  int32_t* ring = wring + lane * (g.ring + 4);
  const int mask = g.ring - 1;
  uint32_t x = kRansL;
  int p = 0;
  Walk at;
  for (int i = 0; i < g.ns; ++i) {
    int32_t* tile = r.tile(at.st);
    mbar_wait(&r.full[at.st], at.use & 1);
    const uint4* e = reinterpret_cast<const uint4*>(tile) + lane;
    uint4 v[kK];
#pragma unroll
    for (int k = 0; k < kK; ++k) v[k] = e[k * kLg];
    const int p0 = p;
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      const bool need = x > v[k].x;
      if (need && writer) ring[p & mask] = static_cast<int32_t>(x & 0xFFFFu);
      p += need;  // counts past `cap` are kept: the words are not stored
      x = need ? x >> kProbBits : x;
      uint32_t q = __umulhi(x, v[k].y);
      q += x - q * v[k].z >= v[k].z;
      x += v[k].w + q * ((1u << kProbBits) - v[k].z);
    }
    if (writer) {
      tile[kP0 + tid] = p0;
      tile[kP1 + tid] = p;
    }
    warp_arrive(&r.empty[at.st], tid);
    at.next(g.d);
  }
  if (writer && tid < g.nl) {
    counts[g.l0 + tid] = p;
    states[g.l0 + tid] = static_cast<int64_t>(x);
  }
}

template <int kVec>
__global__ void __launch_bounds__(kMaxThreads)
pairs_rans_encode_kernel(const int32_t* __restrict__ starts,
                         const int32_t* __restrict__ freqs,
                         const uint8_t* __restrict__ valid,
                         int32_t* __restrict__ words,
                         int32_t* __restrict__ counts,
                         int64_t* __restrict__ states, int T, int L,
                         int cap, int d, int helpers, int ahead, int ring) {
  extern __shared__ __align__(16) unsigned char smem[];
  Geometry g{T, L, cap, d, helpers, ahead, ring, (T + kK - 1) / kK, 0, 0};
  g.l0 = blockIdx.x * kLg;
  g.nl = min(kLg, L - g.l0);
  const Ring r = make_ring(smem, d, kStageInts);
  int32_t* wring = r.tile(d);       // kLg rings of R + 4 int32
  const int warp = threadIdx.x / kWarp;
  const int tid = threadIdx.x % kWarp;
  if (warp > 0) {
    helper<kVec>(starts, freqs, valid, words, g, r, wring, warp - 1, tid);
  } else {
    chain(g, r, wring, counts, states, tid);
  }
}

// The plan's limits.  The shared-memory bytes it states must cover the
// ring (24 bytes of mbarriers and kStageInts int32 per stage) and the
// 8 word rings of R + 4 int32.
bool plan_ok(int T, int L, int cap, int d, int helpers, int ahead, int vec,
             int ring, int smem) {
  if (T < 1 || L < 1 || cap < 1) return false;
  if (helpers < 1 || (helpers + 1) * kWarp > kMaxThreads) return false;
  if (ahead < 1 || d % 2 || d < (ahead + 1) * helpers) return false;
  if (vec != 1 && (vec != 4 || L % 4)) return false;
  if (ring < d * kK + 4 || (ring & (ring - 1))) return false;
  const int64_t need = static_cast<int64_t>(d) * (24 + 4 * kStageInts) +
                       4 * kLg * (static_cast<int64_t>(ring) + 4);
  return need <= smem && smem <= kMaxSmem;
}

}  // namespace

extern "C" {

// Returns 0 on success, -1 (nothing launched) for arguments outside the
// plan's limits (plan_ok), else the launch's cudaError_t.  Launches
// ceil(L / 8) blocks of (helpers + 1) warps.  `valid` must be 4-byte
// aligned, and with vec = 4 `starts` and `freqs` 16-byte aligned.
int hesic_pairs_rans_encode(const void* starts, const void* freqs,
                            const void* valid, void* words, void* counts,
                            void* states, int T, int L, int cap, int d,
                            int helpers, int ahead, int vec, int ring,
                            int smem, void* stream) {
  if (!plan_ok(T, L, cap, d, helpers, ahead, vec, ring, smem)) return -1;
  auto kernel = vec == 4 ? pairs_rans_encode_kernel<4>
                         : pairs_rans_encode_kernel<1>;
  const int rc = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  if (rc) return rc;
  kernel<<<(L + kLg - 1) / kLg, (helpers + 1) * kWarp, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(starts), static_cast<const int32_t*>(freqs),
      static_cast<const uint8_t*>(valid), static_cast<int32_t*>(words),
      static_cast<int32_t*>(counts), static_cast<int64_t*>(states), T, L,
      cap, d, helpers, ahead, ring);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
