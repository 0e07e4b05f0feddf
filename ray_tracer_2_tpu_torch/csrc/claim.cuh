// Persistent blocks that refill finished lanes from a pixel cursor: the
// grid, the warp-aggregated pixel claim and the per-launch counters shared
// by csrc/megakernel.cu and csrc/spheres.cu.
//
// Both kernels launch as many blocks as can be resident at once. Each lane
// holds one path; when its pixel's last sample ends it writes the pixel and
// claims the next one from a per-launch cursor. This is the queue claim of
// the TPU kernels (ray_tracer_2_tpu/kernels/pallas_boundary.py :445-454,
// a cumsum rank over the lanes that need a pixel) as one ballot and one
// atomic per warp. Pixel values do not depend on which lane renders them:
// every draw derives from the pixel id (ray_tracer_2_tpu/kernels/
// megakernel.py :1441-1451).
//
// Every intrinsic below is called by all 32 lanes of a warp at once: the
// lane loops of both kernels keep lanes without a path inside the loop until
// the whole warp leaves it. The lane index is threadIdx.x & 31, so with
// one-thread blocks (warps of one lane) the claim still ranks correctly.
#pragma once

#include <cuda_runtime.h>

namespace rt2_claim {

constexpr unsigned kFull = 0xffffffffu;

// Per-launch scratch the wrapper zeroes (kernels/cuda_build.py
// LAUNCH_SCRATCH int64 words): the exact segment count, the pixel cursor
// (the low 32 bits of its word) and a flag that the launch did some
// optional work (set by the first block that did, so it is counted once).
constexpr int kScratchSegments = 0;
constexpr int kScratchCursor = 1;
constexpr int kScratchFlag = 2;
constexpr int kScratchWords = 3;

// Resident blocks of `kernel` on the current device at `threads` threads
// and `smem` dynamic shared-memory bytes, no more than `total` pixels
// need; at least one.
template <typename Kernel>
int persistent_blocks(Kernel kernel, int threads, size_t smem, int total) {
  int dev = 0, sms = 1, per_sm = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                smem);
  int need = (total + threads - 1) / threads;
  int blocks = sms * (per_sm > 0 ? per_sm : 1);
  return blocks < need ? blocks : (need > 0 ? need : 1);
}

// Warp-aggregated claim. Lanes with `need` take consecutive pixel ids from
// `*cursor` in lane order: the lowest needing lane adds the number of
// needing lanes with one atomicAdd and shares the old value; each takes it
// plus its rank among them. A warp's first claim is therefore 32
// consecutive pixels. Returns the id (compare with the pixel total: ids at
// or past it mean the frame is handed out), or kFull for lanes without
// `need`.
__device__ __forceinline__ unsigned claim(unsigned* cursor, bool need) {
  unsigned mask = __ballot_sync(kFull, need);
  if (mask == 0u) return kFull;  // the same answer on every lane
  int lane = threadIdx.x & 31;
  int leader = __ffs((int)mask) - 1;
  unsigned base = 0u;
  if (lane == leader) base = atomicAdd(cursor, (unsigned)__popc(mask));
  base = __shfl_sync(kFull, base, leader);
  return need ? base + (unsigned)__popc(mask & ((1u << lane) - 1u)) : kFull;
}

// Add every thread's `v` into `*dst`: warp reduce, block reduce through
// `s_warp` (one slot per warp), one atomicAdd by thread 0, which gets the
// block's sum back (the other threads 0). Every thread of the block calls
// it, converged.
template <int kThreads>
__device__ __forceinline__ unsigned long long block_add(
    unsigned long long v, unsigned long long* dst,
    unsigned long long* s_warp) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(kFull, v, off);
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = v;
  __syncthreads();
  unsigned long long sum = 0;
  if (threadIdx.x == 0) {
    for (int w = 0; w < kThreads / 32; ++w) sum += s_warp[w];
    if (sum > 0) atomicAdd(dst, sum);
  }
  __syncthreads();  // s_warp is free for the next sum
  return sum;
}

}  // namespace rt2_claim
