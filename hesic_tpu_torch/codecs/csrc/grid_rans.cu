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
// What bounds these kernels on an H100.  By bytes, each reads the rows'
// first sym+1 entries once (~0.06 ms at 3.35 TB/s for the main path's
// B=8, M=192, S=65, hw=1024); read whole, the (B, M, S, hw) rows are
// 409 MB (0.12 ms).  What sets their time is the state chain: every lane
// walks T = M*ppl = 1536 dependent steps, so a step costs its latency,
// not its throughput.  Nothing the chain reads depends on the state
// except which CDF entry the decoder picks and which word it reads next.
//
// The design takes everything else off the chain:
//   * a block owns a lane group, 8 consecutive lanes of one pair (a ragged
//     last group is masked), so B*ceil(ls/8) blocks spread over the SMs
//     (128 at the main path's B=8, ls=128);
//   * H helper warps stage each step's tile, freq[b, m, 0:S, j*ls + l0 :
//     +8] (S rows of 8 int32 at stride hw, each a 32-byte sector; the
//     encoder also the 8 symbols), into a ring of D shared-memory stages
//     with cp.async, completing on an mbarrier, then turn it into what the
//     chain needs: the decoder's inclusive CDF, the encoder's (start, f,
//     1/f) intervals.  Helper warp h serves the steps h, h+H, h+2H, ...,
//     keeps a few of its own steps loading ahead, and the rest of the ring
//     holds steps ready for the chain.  The decoded symbols go back through
//     the ring: the chain writes them into the stage, and the helper that
//     refills it stores them;
//   * one chain warp walks the steps behind them, waiting on a full
//     mbarrier per stage and releasing it on an empty one, and reads each
//     step's operands one step ahead.  The decoder's search either splits
//     a lane's CDF over 4 threads, each comparing its entries (held in
//     registers) with cf, counted by ballots and __popc, or is a binary
//     search by one thread (rows wider than 65); then one multiply-add and
//     the renorm select, its next word read from a per-thread ring of
//     kWindow words that cp.async keeps filled ahead.  The encoder does
//     the renorm test, the exact quotient x / f as umulhi(x,
//     floor((2^32-1)/f)) plus at most one correction (the reciprocal is
//     the helpers' work), and the add.  The TPU kernel's f32-reciprocal
//     quotient with a +-1 correction exists only because the TPU's vector
//     unit has no fast integer divide; all three give the same integers.
// Integer arithmetic only, no atomics: the result does not depend on D, H
// or the block count.  The plan (D, H, steps ahead, copy width, search,
// shared-memory bytes) comes from grid_rans.rans_plan; an entry point
// returns -1, launching nothing, for a plan outside the limits below.

#include <cuda_runtime.h>
#include <stdint.h>

#include "staging.cuh"

namespace {

constexpr uint32_t kProbBits = 16;
constexpr uint32_t kRansL = 1u << 16;
constexpr int kWindow = 32;         // decoder words in flight per thread
constexpr int kMaxSmem = 232448;    // 227 KB, a block's opt-in maximum
constexpr int kMaxThreads = 512;    // up to 15 helper warps
constexpr unsigned kAll = 0xffffffffu;
// A block's lane group: kLg = 8 lanes of one pair (each staged row segment
// is one 32-byte sector); the helpers and the split search give each lane
// kParts = 4 threads of a warp, thread tid serving lane tid % 8 as part
// tid / 8.
constexpr int kLg = 8;
constexpr int kParts = kWarp / kLg;

struct Geometry {
  int B, M, S, hw, ppl, ls, cap;
  int d, helpers;
  int ahead;            // own steps each helper keeps loading ahead
  int b, l0, nl;        // this block: pair, first lane, lanes (<= kLg)
};

__device__ __forceinline__ Geometry block_geometry(int B, int M, int S,
                                                   int hw, int ppl, int cap,
                                                   int d, int helpers,
                                                   int ahead) {
  Geometry g{B, M, S, hw, ppl, hw / ppl, cap, d, helpers, ahead, 0, 0, 0};
  const int groups = (g.ls + kLg - 1) / kLg;
  g.b = blockIdx.x / groups;
  g.l0 = (blockIdx.x - g.b * groups) * kLg;
  g.nl = min(kLg, g.ls - g.l0);
  return g;
}

// Stages step t's tile (S rows of 8 lanes, then 8 symbols when `sym` is
// given) into `tile` and arrives on `bar` when it has landed.  Lanes past
// the group's nl are zero-filled.
template <int kVec>
__device__ void load_tile(const int32_t* __restrict__ freq,
                          const int32_t* __restrict__ sym,
                          const Geometry& g, int t, int32_t* tile,
                          uint64_t* bar, int tid) {
  const int m = t / g.ppl;
  const int pos = (t - m * g.ppl) * g.ls + g.l0;
  const int32_t* src = freq + (static_cast<int64_t>(g.b) * g.M + m) * g.S *
                                  g.hw + pos;
  // thread tid copies column `lane` of rows tid/nvec, + 32/nvec, ...
  constexpr int nvec = kLg / kVec;          // copies per row
  const int lane = (tid % nvec) * kVec;
  const bool valid = lane < g.nl;
  const int kstep = kWarp / nvec;
  const int64_t src_step = static_cast<int64_t>(kstep) * g.hw;
  const int32_t* from = src + static_cast<int64_t>(tid / nvec) * g.hw + lane;
  int32_t* to = tile + (tid / nvec) * kLg + lane;
  for (int k = tid / nvec; k < g.S; k += kstep) {
    cp_async<kVec>(to, valid ? from : freq, valid);
    from += src_step;
    to += kstep * kLg;
  }
  if (sym != nullptr) {
    const int32_t* ssrc = sym + (static_cast<int64_t>(m) * g.B + g.b) * g.hw +
                          pos;
    if (tid < nvec) {
      const int slane = tid * kVec;
      const bool svalid = slane < g.nl;
      cp_async<kVec>(tile + g.S * kLg + slane, svalid ? ssrc + slane : sym,
                     svalid);
    }
  }
  cp_async_arrive(bar);
}

// In place: each lane's S staged frequencies -> their inclusive CDF.  The
// lane's kParts threads take contiguous segments, then add the segments
// before theirs, gathered by shuffle.  kSeg > 0 (S <= 4 * kSeg): the
// segments are kSeg rows, summed in registers; kSeg = 0: runtime loops.
template <int kSeg>
__device__ void scan_tile(int32_t* tile, const Geometry& g, int tid) {
  const int lane = tid % kLg;
  const int part = tid / kLg;
  const int seg = kSeg > 0 ? kSeg : (g.S + kParts - 1) / kParts;
  const int k0 = min(part * seg, g.S);
  int32_t* col = tile + k0 * kLg + lane;
  uint32_t total = 0;
  uint32_t v[kSeg > 0 ? kSeg : 1];
  if constexpr (kSeg > 0) {
#pragma unroll
    for (int r = 0; r < kSeg; ++r)
      v[r] = k0 + r < g.S ? static_cast<uint32_t>(col[r * kLg]) : 0u;
#pragma unroll
    for (int r = 1; r < kSeg; ++r) v[r] += v[r - 1];
    total = v[kSeg - 1];
  } else {
    for (int k = k0; k < min(k0 + seg, g.S); ++k)
      total += static_cast<uint32_t>(tile[k * kLg + lane]);
  }
  uint32_t incl = total;
#pragma unroll
  for (int dp = 1; dp < kParts; dp <<= 1) {
    const uint32_t u = __shfl_up_sync(kAll, incl, dp * kLg);
    if (part >= dp) incl += u;
  }
  uint32_t run = incl - total;
  if constexpr (kSeg > 0) {
#pragma unroll
    for (int r = 0; r < kSeg; ++r)
      if (k0 + r < g.S) col[r * kLg] = static_cast<int32_t>(v[r] + run);
  } else {
    for (int k = k0; k < min(k0 + seg, g.S); ++k) {
      run += static_cast<uint32_t>(tile[k * kLg + lane]);
      tile[k * kLg + lane] = static_cast<int32_t>(run);
    }
  }
}

// Each lane's interval, written after the staged symbols as (start, f,
// inv) triples: start = the sum of the row below its symbol, f = the
// symbol's entry, inv = floor((2^32 - 1) / f).  With inv the chain's
// exact x / f is umulhi(x, inv) or one more: for 2^32 - 1 = inv*f + rem,
// x*inv / 2^32 = x/f - x*(1 + rem) / (f * 2^32) and x*(1 + rem) < f * 2^32.
// The lane's kParts threads sum the rows k = part + 4r below the symbol:
// kSeg > 0 (S <= 4 * kSeg), r < kSeg in registers; kSeg = 0, a loop.
template <int kSeg>
__device__ void interval_tile(int32_t* tile, const Geometry& g, int tid) {
  const int lane = tid % kLg;
  const int part = tid / kLg;
  const int s = min(max(tile[g.S * kLg + lane], 0), g.S - 1);
  uint32_t sum = 0;
  if constexpr (kSeg > 0) {
    uint32_t v[kSeg];
#pragma unroll
    for (int r = 0; r < kSeg; ++r) {
      const int k = part + kParts * r;
      v[r] = k < s ? static_cast<uint32_t>(tile[k * kLg + lane]) : 0u;
    }
#pragma unroll
    for (int r = 0; r < kSeg; ++r) sum += v[r];
  } else {
    for (int k = part; k < s; k += kParts)
      sum += static_cast<uint32_t>(tile[k * kLg + lane]);
  }
#pragma unroll
  for (int dp = 1; dp < kParts; dp <<= 1)
    sum += __shfl_xor_sync(kAll, sum, dp * kLg);
  if (part == 0) {
    const uint32_t f = static_cast<uint32_t>(tile[s * kLg + lane]);
    uint32_t* iv = reinterpret_cast<uint32_t*>(tile + (g.S + 1) * kLg) +
                   3 * lane;
    iv[0] = sum;
    iv[1] = f;
    iv[2] = f ? 0xFFFFFFFFu / f : 0u;
  }
}

// Helper warp h (0-based): stages and prepares the steps i = h, h+H, ...
// of the walk (step t = i for the decoder, T-1-i for the encoder), each
// into stage i % D, keeping `ahead` of its own steps loading ahead.  A
// stage is refilled once the chain has released the step D before it:
// with D >= (ahead + 1) * H that step was made ready earlier, and the
// D - ahead*H stages not loading hold ready steps for the chain.
// The decoder's chain leaves step i's 8 symbols in its stage, after the
// CDF; a helper stores them to syms[m, b, j*ls + l0 : +nl] once the chain
// has released the stage (a global store before the chain's release
// would hold the chain until the store is done).
__device__ void flush_syms(int32_t* __restrict__ syms, const Geometry& g,
                           const Ring& r, int i, int tid) {
  if (tid >= g.nl) return;
  const int m = i / g.ppl;
  syms[(static_cast<int64_t>(m) * g.B + g.b) * g.hw +
       (i - m * g.ppl) * g.ls + g.l0 + tid] = r.tile(i % g.d)[g.S * kLg + tid];
}

template <int kVec, bool kEncode, int kSeg>
__device__ void helper(const int32_t* __restrict__ freq,
                       const int32_t* __restrict__ sym,
                       int32_t* __restrict__ syms, const Geometry& g,
                       const Ring& r, int h, int tid) {
  const int T = g.M * g.ppl;
  const int ahead = g.ahead;
  const int own = T > h ? (T - h + g.helpers - 1) / g.helpers : 0;
  auto issue = [&](int q) {
    const int i = h + q * g.helpers;
    const int st = i % g.d;
    const int use = i / g.d;
    if (use > 0) {
      mbar_wait(&r.empty[st], (use - 1) & 1);
      if (!kEncode) flush_syms(syms, g, r, i - g.d, tid);
    }
    load_tile<kVec>(freq, kEncode ? sym : nullptr, g,
                    kEncode ? T - 1 - i : i, r.tile(st), &r.loaded[st], tid);
  };
  for (int q = 0; q < min(ahead, own); ++q) issue(q);
  for (int q = 0; q < own; ++q) {
    const int i = h + q * g.helpers;
    const int st = i % g.d;
    mbar_wait(&r.loaded[st], (i / g.d) & 1);
    if (kEncode) {
      interval_tile<kSeg>(r.tile(st), g, tid);
    } else {
      scan_tile<kSeg>(r.tile(st), g, tid);
    }
    warp_arrive(&r.full[st], tid);
    if (q + ahead < own) issue(q + ahead);
  }
  if (kEncode) return;
  for (int q = 0; q < own; ++q) {     // own steps no later step refills
    const int i = h + q * g.helpers;
    if (i + g.d < T) continue;
    mbar_wait(&r.empty[i % g.d], (i / g.d) & 1);
    flush_syms(syms, g, r, i, tid);
  }
}

// Part p of a lane holds the lane's CDF entries k = p + 4r, r < kPer.
template <int kPer>
__device__ __forceinline__ void load_entries(uint32_t (&v)[kPer],
                                             const int32_t* column, int part,
                                             int S) {
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int k = part + kParts * r;
    v[r] = k < S - 1 ? static_cast<uint32_t>(column[k * kLg]) : 0xFFFFFFFFu;
  }
}

// How many of the lane's first S-1 inclusive CDF entries are <= cf.  Each
// ballot gives every thread's comparison of its entry r; the lane's four
// threads sit at bits lane + 8p, so (ballot >> lane) & 0x01010101 holds
// them, and eight entries' bits packed side by side make one __popc.  All
// four threads of the lane get the same count, with no shuffle.
template <int kPer>
__device__ __forceinline__ int count_le(const uint32_t (&v)[kPer],
                                        uint32_t cf, int lane) {
  int s = 0;
#pragma unroll
  for (int r0 = 0; r0 < kPer; r0 += 8) {
    uint32_t bits = 0;
#pragma unroll
    for (int r = r0; r < r0 + 8 && r < kPer; ++r)
      bits |= ((__ballot_sync(kAll, v[r] <= cf) >> lane) & 0x01010101u)
              << (r - r0);
    s += __popc(bits);
  }
  return s;
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// kPer > 0: S - 1 <= 4 * kPer; the helpers scan segments of kPer + 1
// rows.  kSplit: the split search, each step's entries loaded into
// registers while the step before is decoded; else the binary search,
// one thread per lane.
template <int kVec, int kPer, bool kSplit>
__global__ void __launch_bounds__(kMaxThreads)
grid_rans_decode_kernel(const int32_t* __restrict__ freq,
                        const int32_t* __restrict__ words,
                        const int32_t* __restrict__ counts,
                        const int64_t* __restrict__ states,
                        int32_t* __restrict__ syms, int B, int M, int S,
                        int hw, int ppl, int cap, int d, int helpers,
                        int ahead) {
  static_assert(kPer > 0 || !kSplit, "the split search needs kPer");
  extern __shared__ __align__(16) unsigned char smem[];
  const Geometry g = block_geometry(B, M, S, hw, ppl, cap, d, helpers,
                                    ahead);
  const Ring r = make_ring(smem, g.d, (S + 1) * kLg);
  const int warp = threadIdx.x / kWarp;
  const int tid = threadIdx.x % kWarp;
  if (warp > 0) {
    helper<kVec, false, kPer ? kPer + 1 : 0>(freq, nullptr, syms, g, r,
                                             warp - 1, tid);
    return;
  }

  // the chain warp: thread tid serves lane tid % 8 as part tid / 8 (split)
  // or lane tid (binary; threads past 8 idle on the last lane's column)
  const int lane = kSplit ? tid % kLg : min(tid, kLg - 1);
  const int part = kSplit ? tid / kLg : 0;
  const bool live = (kSplit || tid < kLg) && lane < g.nl;
  const int64_t lane_id = static_cast<int64_t>(g.b) * g.ls + g.l0 + lane;
  const int32_t* wl = words + static_cast<int64_t>(g.b) * cap * g.ls + g.l0 +
                      lane;
  // the lane's next kWindow words in flight into this thread's slots of a
  // shared-memory ring: slot q & (kWindow-1) holds the word at clamp(q).
  // Every step fetches the word at p - kWindow (the same word again when
  // p did not move), so the group kWindow steps old, the latest write of
  // the slot of p-1, has landed once all but kWindow-1 groups have; `w`
  // is the word at p-1, read ahead of its renorm.
  int32_t* ring = r.tile(d) + tid;
  auto fetch = [&](int q) {
    const int qc = q < 0 ? 0 : (q > cap - 1 ? cap - 1 : q);
    cp_async<1>(ring + (q & (kWindow - 1)) * kWarp,
                live ? wl + static_cast<int64_t>(qc) * g.ls : words, live);
    cp_async_commit();
  };
  uint32_t x = 0;
  int p = 0;
  if (live) {
    x = static_cast<uint32_t>(states[lane_id]);
    p = counts[lane_id];
  }
  for (int k = 0; k < kWindow; ++k) fetch(p - 1 - k);
  cp_async_wait<kWindow - 1>();
  uint32_t w = static_cast<uint32_t>(ring[((p - 1) & (kWindow - 1)) * kWarp]);

  int top = 1;                     // largest power of two <= S-1
  while (top * 2 <= S - 1) top *= 2;
  const int T = M * ppl;

  uint32_t cur[kSplit ? kPer : 1], nxt[kSplit ? kPer : 1];
  Walk at;
  mbar_wait(&r.full[0], 0);
  if constexpr (kSplit) load_entries(cur, r.tile(0) + lane, part, S);
  for (int i = 0; i < T; ++i) {
    Walk after = at;
    after.next(d);
    if constexpr (kSplit) {
      if (i + 1 < T) {
        mbar_wait(&r.full[after.st], after.use & 1);
        load_entries(nxt, r.tile(after.st) + lane, part, S);
      }
    }
    const int32_t* c = r.tile(at.st) + lane;    // c[k * kLg]: CDF entry k
    const uint32_t cf = x & 0xFFFFu;
    // symbol = number of inclusive CDF entries <= cf among the first S-1;
    // the last entry of a valid row is 2^16 > cf
    int s = 0;
    if constexpr (kSplit) {
      s = count_le(cur, cf, lane);
    } else {
      for (int step = top; step > 0; step >>= 1) {
        const int k = s + step;
        if (k <= S - 1 && static_cast<uint32_t>(c[(k - 1) * kLg]) <= cf) s = k;
      }
    }
    const uint32_t start =
        s > 0 ? static_cast<uint32_t>(c[(s - 1) * kLg]) : 0u;
    const uint32_t f = static_cast<uint32_t>(c[s * kLg]) - start;
    if (kSplit ? part == 0 : tid < kLg) r.tile(at.st)[S * kLg + lane] = s;
    warp_arrive(&r.empty[at.st], tid);
    const uint32_t xn = f * (x >> kProbBits) + cf - start;
    const bool renorm = xn < kRansL;
    x = renorm ? (xn << kProbBits) | w : xn;
    p -= renorm;
    fetch(p - kWindow);
    cp_async_wait<kWindow - 1>();
    w = static_cast<uint32_t>(ring[((p - 1) & (kWindow - 1)) * kWarp]);
    at = after;
    if constexpr (kSplit) {
#pragma unroll
      for (int k = 0; k < kPer; ++k) cur[k] = nxt[k];
    } else if (i + 1 < T) {
      mbar_wait(&r.full[at.st], at.use & 1);
    }
  }
}

// kPer > 0: S - 1 <= 4 * kPer; the helpers sum kPer + 1 rows a thread.
template <int kVec, int kPer>
__global__ void __launch_bounds__(kMaxThreads)
grid_rans_encode_kernel(const int32_t* __restrict__ freq,
                        const int32_t* __restrict__ sym,
                        int32_t* __restrict__ words,
                        int32_t* __restrict__ counts,
                        int64_t* __restrict__ states, int B, int M, int S,
                        int hw, int ppl, int cap, int d, int helpers,
                        int ahead) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Geometry g = block_geometry(B, M, S, hw, ppl, cap, d, helpers,
                                    ahead);
  const Ring r = make_ring(smem, g.d, (S + 4) * kLg);
  const int warp = threadIdx.x / kWarp;
  const int tid = threadIdx.x % kWarp;
  if (warp > 0) {
    helper<kVec, true, kPer ? kPer + 1 : 0>(freq, sym, nullptr, g, r,
                                            warp - 1, tid);
    return;
  }

  // the chain warp: thread tid serves lane tid; each step's interval is
  // read one step ahead
  const bool live = tid < g.nl;
  const int iv_off = (S + 1) * kLg + 3 * min(tid, kLg - 1);
  uint32_t x = kRansL;
  int p = 0;
  int32_t* wl = words + static_cast<int64_t>(g.b) * cap * g.ls + g.l0 + tid;
  const int T = M * ppl;
  Walk at;
  mbar_wait(&r.full[0], 0);
  const uint32_t* iv = reinterpret_cast<const uint32_t*>(r.tile(0) + iv_off);
  uint32_t start = iv[0], f = iv[1], inv = iv[2];
  for (int i = 0; i < T; ++i) {
    Walk after = at;
    after.next(d);
    uint32_t start1 = 0, f1 = 1, inv1 = 0;
    if (i + 1 < T) {
      mbar_wait(&r.full[after.st], after.use & 1);
      iv = reinterpret_cast<const uint32_t*>(r.tile(after.st) + iv_off);
      start1 = iv[0];
      f1 = iv[1];
      inv1 = iv[2];
    }
    const bool need = x >= (f << kProbBits);
    if (need && live && p < cap)
      wl[static_cast<int64_t>(p) * g.ls] = x & 0xFFFFu;
    p += need;  // counts past `cap` signal overflow to the caller
    x = need ? x >> kProbBits : x;
    uint32_t q = __umulhi(x, inv);
    uint32_t rem = x - q * f;
    const bool fix = rem >= f;
    q += fix;
    rem -= fix ? f : 0u;
    x = (q << kProbBits) + rem + start;
    warp_arrive(&r.empty[at.st], tid);
    at = after;
    start = start1;
    f = f1;
    inv = inv1;
  }
  if (!live) return;
  for (int k = p < cap ? p : cap; k < cap; ++k)
    wl[static_cast<int64_t>(k) * g.ls] = 0;
  const int64_t lane_id = static_cast<int64_t>(g.b) * g.ls + g.l0 + tid;
  counts[lane_id] = p;
  states[lane_id] = static_cast<int64_t>(x);
}

// The plan's limits.  The shared-memory bytes it states must cover the
// ring (24 bytes of mbarriers and `stage_ints` int32 per stage) and
// `extra` bytes after it.
bool plan_ok(int B, int M, int S, int hw, int ppl, int cap, int d,
             int helpers, int ahead, int vec, int smem, int stage_ints,
             int extra) {
  if (B < 1 || M < 1 || S < 2 || ppl < 1 || hw % ppl || cap < 0) return false;
  if (helpers < 1 || (helpers + 1) * kWarp > kMaxThreads) return false;
  if (ahead < 1 || d % 2 || d < (ahead + 1) * helpers) return false;
  if (vec != 1 && (vec != 4 || hw % 4 || (hw / ppl) % 4)) return false;
  const int64_t need = static_cast<int64_t>(d) * (24 + 4 * stage_ints) +
                       extra;
  return need <= smem && smem <= kMaxSmem;
}

// per: 0, or 4, 8 or 16 with S - 1 <= 4 * per.
bool per_ok(int per, int S) {
  return per == 0 ||
         ((per == 4 || per == 8 || per == 16) && S - 1 <= kParts * per);
}

template <int kVec>
auto decode_kernel(int per, bool split) {
  switch (per) {
    case 4: return split ? grid_rans_decode_kernel<kVec, 4, true>
                         : grid_rans_decode_kernel<kVec, 4, false>;
    case 8: return split ? grid_rans_decode_kernel<kVec, 8, true>
                         : grid_rans_decode_kernel<kVec, 8, false>;
    case 16: return split ? grid_rans_decode_kernel<kVec, 16, true>
                          : grid_rans_decode_kernel<kVec, 16, false>;
    default: return grid_rans_decode_kernel<kVec, 0, false>;
  }
}

template <int kVec>
auto encode_kernel(int per) {
  switch (per) {
    case 4: return grid_rans_encode_kernel<kVec, 4>;
    case 8: return grid_rans_encode_kernel<kVec, 8>;
    case 16: return grid_rans_encode_kernel<kVec, 16>;
    default: return grid_rans_encode_kernel<kVec, 0>;
  }
}

}  // namespace

extern "C" {

// Returns 0 on success, -1 (nothing launched) for arguments outside the
// plan's limits (plan_ok, per_ok), else the launch's cudaError_t.  Both
// launch B * ceil(ls / 8) blocks of (helpers + 1) warps.
// per: the helpers' rows a thread less one (see per_ok), 0 for loops.
int hesic_grid_rans_encode(const void* freq, const void* sym, void* words,
                           void* counts, void* states, int B, int M, int S,
                           int hw, int ppl, int cap, int d, int helpers,
                           int ahead, int vec, int per, int smem,
                           void* stream) {
  if (!plan_ok(B, M, S, hw, ppl, cap, d, helpers, ahead, vec, smem,
               (S + 4) * kLg, 0) || !per_ok(per, S))
    return -1;
  const int ls = hw / ppl;
  auto kernel = vec == 4 ? encode_kernel<4>(per) : encode_kernel<1>(per);
  const int rc = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  if (rc) return rc;
  kernel<<<B * ((ls + kLg - 1) / kLg), (helpers + 1) * kWarp, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(freq), static_cast<const int32_t*>(sym),
      static_cast<int32_t*>(words), static_cast<int32_t*>(counts),
      static_cast<int64_t*>(states), B, M, S, hw, ppl, cap, d, helpers,
      ahead);
  return static_cast<int>(cudaGetLastError());
}

// per: the split search's CDF entries a thread (see per_ok; the helpers
// scan per + 1 rows a thread), 0 for loops; search: 1 split (needs per),
// 0 binary.  The word ring takes kWindow * 32 int32 after the stages.
int hesic_grid_rans_decode(const void* freq, const void* words,
                           const void* counts, const void* states, void* syms,
                           int B, int M, int S, int hw, int ppl, int cap,
                           int d, int helpers, int ahead, int vec, int per,
                           int search, int smem, void* stream) {
  if (!plan_ok(B, M, S, hw, ppl, cap, d, helpers, ahead, vec, smem,
               (S + 1) * kLg, 4 * kWindow * kWarp) ||
      cap < 1 || !per_ok(per, S) || (search != 0 && search != 1) ||
      (search && !per))
    return -1;
  const int ls = hw / ppl;
  auto kernel = vec == 4 ? decode_kernel<4>(per, search)
                         : decode_kernel<1>(per, search);
  const int rc = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  if (rc) return rc;
  kernel<<<B * ((ls + kLg - 1) / kLg), (helpers + 1) * kWarp, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(freq), static_cast<const int32_t*>(words),
      static_cast<const int32_t*>(counts),
      static_cast<const int64_t*>(states), static_cast<int32_t*>(syms), B, M,
      S, hw, ppl, cap, d, helpers, ahead);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
