// Staging helpers shared by the rANS kernels of grid_rans.cu and
// pairs_rans.cu: mbarriers, cp.async copies into shared memory, and the
// ring of stages through which helper warps feed a chain warp.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
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

// kVec int32 global -> shared without a register round trip; zeros when
// !valid (src is then not read, but must be a mapped address).
template <int kVec>
__device__ __forceinline__ void cp_async(int32_t* dst, const int32_t* src,
                                         bool valid) {
  if constexpr (kVec == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(valid ? 16 : 0)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(valid ? 4 : 0)
                 : "memory");
  }
}

// Arrival by one thread of a converged warp: __syncwarp orders the other
// threads' shared-memory accesses before lane 0's release.
__device__ __forceinline__ void warp_arrive(uint64_t* bar, int tid) {
  __syncwarp();
  if (tid == 0) mbar_arrive(bar);
}

// One arrival on `bar` once every earlier cp.async of this thread landed.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// The shared-memory ring: D stages of `stage` int32 each, after three
// mbarriers per stage (loaded: each of the helper's 32 threads' copies
// landed; full: the stage is ready for the chain; empty: the chain is
// done with it; one warp arrival each).
struct Ring {
  uint64_t* loaded;
  uint64_t* full;
  uint64_t* empty;
  int32_t* stages;
  int stage;
  __device__ int32_t* tile(int st) const { return stages + st * stage; }
};

__device__ __forceinline__ Ring make_ring(unsigned char* smem, int d,
                                          int stage_ints) {
  Ring r;
  r.loaded = reinterpret_cast<uint64_t*>(smem);
  r.full = r.loaded + d;
  r.empty = r.full + d;
  r.stages = reinterpret_cast<int32_t*>(r.empty + d);
  r.stage = stage_ints;
  if (threadIdx.x == 0) {
    for (int st = 0; st < d; ++st) {
      mbar_init(&r.loaded[st], kWarp);
      mbar_init(&r.full[st], 1);
      mbar_init(&r.empty[st], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return r;
}

// The chain's walk over the ring: stage and phase of step i, advanced in
// order.
struct Walk {
  int st = 0, use = 0;
  __device__ void next(int d) {
    if (++st == d) { st = 0; ++use; }
  }
};

}  // namespace
