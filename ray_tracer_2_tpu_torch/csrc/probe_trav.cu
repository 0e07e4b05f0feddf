// Hopper probes of scripts/probe_trav.py, for one NVIDIA Hopper card (sm_90a).
//
// Replaces the TPU kernels
//   p_launch  (probe_trav.py:54, pallas_call :59)   -> rt2_probe_launch
//   make_trav (probe_trav.py:67, pallas_call :115)  -> rt2_probe_trav
//             with sched=True (p_sched :134)        -> rt2_probe_trav_sched
//   p_leaf    (probe_trav.py:143, pallas_call :175) -> rt2_probe_leaf
// computing what each computes (ray_tracer_2_tpu_torch/probes/trav.py holds
// the plain PyTorch versions).
//
// A lane's (., 128) row of slots, one vreg row on the TPU, is one warp here:
// thread t holds slots 4t..4t+3, and pltpu.roll(x, s, 1) (out[i] = x[i - s],
// as jnp.roll) takes the last s slots of the thread below through
// __shfl_sync (csrc/probe_row.cuh, shared with csrc/probe_packet.cu). So
// each probe walks one row per warp, the warp-cooperative row walk the
// megakernel's redesign would use. Every chain is one dependent row fetch
// per step: the probes are bound by that latency, not by the card's
// 67 TFLOP/s or 3.35 TB/s (their bounds are floors).
//
// Tables: trav's table 0 (R x 128 bf16, 16-32 KB) is staged in shared
// memory (kStaged) or read from global memory where it lies (the form the
// megakernel's wide rows take); trav_sched reads the whole 5 MB of tables
// from global memory (L2-resident after the first touch). leaf keeps its two
// 16 KB halves in shared memory.
//
// Dead work: only slot 0 of the slab result steers the chain, so each kernel
// also returns a checksum of the work on every slot (trav: the hit slots of
// all steps; leaf: the bit patterns of the final `best` row), which nvcc
// cannot drop, and the plain version computes the same.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cooperative_groups.h>
#include <stdint.h>

#include "probe_row.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace rt2_row;

constexpr int kThreads = 256;     // 8 lanes (warps) per block

__device__ __forceinline__ void bf16x4(uint2 raw, float (&v)[4]) {
  v[0] = __uint_as_float(raw.x << 16);
  v[1] = __uint_as_float(raw.x & 0xffff0000u);
  v[2] = __uint_as_float(raw.y << 16);
  v[3] = __uint_as_float(raw.y & 0xffff0000u);
}

// One step of the slab test in slot space (probe_trav.py:88-95): returns
// this thread's hit slots; hit0 is slot 0's hit on every thread.
__device__ __forceinline__ int slab_step(const float (&row)[4],
                                         const float (&iv)[4],
                                         const float (&off)[4], float tbest,
                                         bool& hit0) {
  bool h[4];
  slab_hits(row, iv, off, tbest, h);
  hit0 = __shfl_sync(kFull, (int)h[0], 0) != 0;
  return h[0] + h[1] + h[2] + h[3];
}

__global__ void launch_kernel(const float* __restrict__ x, int n,
                              float* __restrict__ out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = x[i] + 1.0f;
}

// make_trav(sched=False): K dependent steps per lane, always table 0.
template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
trav_kernel(const __nv_bfloat16* __restrict__ tab, int R,
            const float* __restrict__ iv, const float* __restrict__ off,
            const int* __restrict__ idx0, int B, int K,
            float* __restrict__ out, int* __restrict__ idx_out,
            int* __restrict__ hits_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const __nv_bfloat16* t = tab;
  if (kStaged) {
    const int n16 = R * kSlots * 2 / 16;
    uint4* s = reinterpret_cast<uint4*>(smem);
    const uint4* g = reinterpret_cast<const uint4*>(tab);
    for (int i = threadIdx.x; i < n16; i += blockDim.x) s[i] = g[i];
    __syncthreads();
    t = reinterpret_cast<const __nv_bfloat16*>(smem);
  }
  const int lane = lane_id(), warps = blockDim.x / 32;
  for (int b = blockIdx.x * warps + threadIdx.x / 32; b < B;
       b += gridDim.x * warps) {
    float v[4], o[4], row[4];
    load4(iv + (size_t)b * kSlots + lane * 4, v);
    load4(off + (size_t)b * kSlots + lane * 4, o);
    int idx = idx0[b], hits = 0;
    float tbest = 1e9f;
    for (int k = 0; k < K; ++k) {
      bf16x4(*reinterpret_cast<const uint2*>(t + (size_t)idx * kSlots +
                                             lane * 4), row);
      bool hit0;
      hits += slab_step(row, v, o, tbest, hit0);
      float n12 = __shfl_sync(kFull, row[0], 3);   // slot 12
      float n13 = __shfl_sync(kFull, row[1], 3);   // slot 13
      idx = (int)(hit0 ? n12 : n13) % R;
      tbest = tbest * 0.9999f;
    }
    hits = __reduce_add_sync(kFull, hits);
    if (lane == 0) {
      out[b] = (float)idx + tbest;
      idx_out[b] = idx;
      hits_out[b] = hits;
    }
  }
}

// make_trav(sched=True): every step, the histogram of all B lanes' table
// ids picks one table for every lane (argmax, lowest id on a tie). The TPU
// program saw all lanes at once; here the blocks of a cooperative launch
// meet at a grid barrier each step. Each block owns a contiguous share of
// the lanes (their state in idx_out / tid_out / hits_out) and adds its
// share's histogram into one of three global histograms (step k adds into
// hist[k % 3]; block 0 zeroes hist[(k + 1) % 3], which nobody reads or adds
// to until after the next barrier).
__global__ void __launch_bounds__(kThreads)
trav_sched_kernel(const __nv_bfloat16* __restrict__ tabs, int R, int T,
                  const float* __restrict__ iv, const float* __restrict__ off,
                  const int* __restrict__ idx0, const int* __restrict__ tid0,
                  int B, int K, int* __restrict__ hist,
                  float* __restrict__ out, int* __restrict__ idx_out,
                  int* __restrict__ tid_out, int* __restrict__ hits_out) {
  extern __shared__ int s_hist[];          // T counts, then the pick
  int* s_pick = s_hist + T;
  cg::grid_group grid = cg::this_grid();
  const int per = (B + gridDim.x - 1) / gridDim.x;
  const int lo = blockIdx.x * per, hi = min(B, lo + per);
  const int lane = lane_id(), warps = blockDim.x / 32;
  for (int b = lo + threadIdx.x; b < hi; b += blockDim.x) {
    idx_out[b] = idx0[b];
    tid_out[b] = tid0[b];
    hits_out[b] = 0;
  }
  float tbest = 1e9f;
  __syncthreads();
  for (int k = 0; k < K; ++k) {
    int* h = hist + (k % 3) * T;
    for (int i = threadIdx.x; i < T; i += blockDim.x) s_hist[i] = 0;
    if (blockIdx.x == 0)
      for (int i = threadIdx.x; i < T; i += blockDim.x)
        hist[((k + 1) % 3) * T + i] = 0;
    __syncthreads();
    for (int b = lo + threadIdx.x; b < hi; b += blockDim.x)
      atomicAdd(&s_hist[tid_out[b]], 1);
    __syncthreads();
    for (int i = threadIdx.x; i < T; i += blockDim.x)
      if (s_hist[i]) atomicAdd(&h[i], s_hist[i]);
    grid.sync();
    if (threadIdx.x < 32) {                // argmax, lowest id on a tie
      int best = -1, arg = 0;
      for (int i = lane; i < T; i += 32) {
        int c = __ldcg(&h[i]);
        if (c > best) { best = c; arg = i; }
      }
      for (int d = 16; d > 0; d >>= 1) {
        int ob = __shfl_down_sync(kFull, best, d);
        int oa = __shfl_down_sync(kFull, arg, d);
        if (ob > best || (ob == best && oa < arg)) { best = ob; arg = oa; }
      }
      if (lane == 0) *s_pick = arg;
    }
    __syncthreads();
    const __nv_bfloat16* tab = tabs + (size_t)(*s_pick) * R * kSlots;
    for (int b = lo + threadIdx.x / 32; b < hi; b += warps) {
      float v[4], o[4], row[4];
      load4(iv + (size_t)b * kSlots + lane * 4, v);
      load4(off + (size_t)b * kSlots + lane * 4, o);
      const int idx = idx_out[b], tid = tid_out[b];
      bf16x4(*reinterpret_cast<const uint2*>(tab + (size_t)idx * kSlots +
                                             lane * 4), row);
      bool hit0;
      int hits = __reduce_add_sync(kFull, slab_step(row, v, o, tbest, hit0));
      float n12 = __shfl_sync(kFull, row[0], 3);
      float n13 = __shfl_sync(kFull, row[1], 3);
      float n14 = __shfl_sync(kFull, row[2], 3);
      __syncwarp();
      if (lane == 0) {
        idx_out[b] = (int)(hit0 ? n12 : n13) % R;
        tid_out[b] = (tid + ((int)n14 & 3)) % T;
        hits_out[b] += hits;
      }
    }
    tbest = tbest * 0.9999f;
    __syncthreads();
  }
  for (int b = lo + threadIdx.x; b < hi; b += blockDim.x)
    out[b] = (float)idx_out[b] + tbest;
}

// p_leaf: K steps of a split-bf16 row fetch (hi + mid) and six rounds of
// acc = min(acc * iv + row, roll(acc, 3)).
__global__ void __launch_bounds__(kThreads)
leaf_kernel(const __nv_bfloat16* __restrict__ hi,
            const __nv_bfloat16* __restrict__ mid, int R,
            const float* __restrict__ iv, const int* __restrict__ idx0,
            int B, int K, float* __restrict__ out, int* __restrict__ idx_out,
            long long* __restrict__ sum_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* s_hi = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* s_mid = s_hi + R * kSlots;
  {
    const int n16 = R * kSlots * 2 / 16;
    for (int i = threadIdx.x; i < n16; i += blockDim.x) {
      reinterpret_cast<uint4*>(s_hi)[i] = reinterpret_cast<const uint4*>(hi)[i];
      reinterpret_cast<uint4*>(s_mid)[i] =
          reinterpret_cast<const uint4*>(mid)[i];
    }
    __syncthreads();
  }
  const int lane = lane_id(), warps = blockDim.x / 32;
  for (int b = blockIdx.x * warps + threadIdx.x / 32; b < B;
       b += gridDim.x * warps) {
    float v[4], best[4], h[4], m[4], row[4], acc[4], r[4];
    load4(iv + (size_t)b * kSlots + lane * 4, v);
    int idx = idx0[b];
#pragma unroll
    for (int j = 0; j < 4; ++j) best[j] = 1e9f;
    for (int k = 0; k < K; ++k) {
      const size_t at = (size_t)idx * kSlots + lane * 4;
      bf16x4(*reinterpret_cast<const uint2*>(s_hi + at), h);
      bf16x4(*reinterpret_cast<const uint2*>(s_mid + at), m);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        row[j] = h[j] + m[j];
        acc[j] = row[j] * v[j];
      }
#pragma unroll
      for (int round = 0; round < 6; ++round) {
        roll<3>(acc, r);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[j] = fminf(acc[j] * v[j] + row[j], r[j]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) best[j] = fminf(best[j], acc[j]);
      idx = (int)__shfl_sync(kFull, best[0], 0) & 63;
    }
    long long s = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) s += (long long)__float_as_uint(best[j]);
    for (int d = 16; d > 0; d >>= 1) s += __shfl_down_sync(kFull, s, d);
    if (lane == 0) {
      out[b] = best[0] + (float)idx;
      idx_out[b] = idx;
      sum_out[b] = s;
    }
  }
}

template <typename Kernel>
int lane_grid(Kernel kernel, int B, size_t smem) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                smem);
  int want = (B + kThreads / 32 - 1) / (kThreads / 32);
  return max(1, min(want, sms * max(per_sm, 1)));
}

}  // namespace

// Each entry point launches on `stream`, allocates nothing, does not
// synchronise, and returns cudaGetLastError() (0 = launched).
extern "C" int rt2_probe_launch(const float* x, int n, float* out,
                                void* stream) {
  if (n > 0)
    launch_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(x, n,
                                                                      out);
  return (int)cudaGetLastError();
}

extern "C" int rt2_probe_trav(const void* tab, int R, const float* iv,
                              const float* off, const int* idx0, int B, int K,
                              int staged, float* out, int* idx_out,
                              int* hits_out, void* stream) {
  if (R <= 0 || B <= 0 || K < 0) return (int)cudaErrorInvalidValue;
  const __nv_bfloat16* t = static_cast<const __nv_bfloat16*>(tab);
  if (staged) {
    size_t smem = (size_t)R * kSlots * 2;
    cudaFuncSetAttribute(trav_kernel<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    trav_kernel<true><<<lane_grid(trav_kernel<true>, B, smem), kThreads,
                        smem, (cudaStream_t)stream>>>(
        t, R, iv, off, idx0, B, K, out, idx_out, hits_out);
  } else {
    trav_kernel<false><<<lane_grid(trav_kernel<false>, B, 0), kThreads, 0,
                         (cudaStream_t)stream>>>(t, R, iv, off, idx0, B, K,
                                                 out, idx_out, hits_out);
  }
  return (int)cudaGetLastError();
}

// hist: 3 * T ints, zeroed by the caller.
extern "C" int rt2_probe_trav_sched(const void* tabs, int R, int T,
                                    const float* iv, const float* off,
                                    const int* idx0, const int* tid0, int B,
                                    int K, int* hist, float* out,
                                    int* idx_out, int* tid_out,
                                    int* hits_out, void* stream) {
  if (R <= 0 || T <= 0 || B <= 0 || K < 0) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return (int)cudaErrorNotSupported;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  size_t smem = (size_t)(T + 1) * sizeof(int);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, trav_sched_kernel,
                                                kThreads, smem);
  int blocks = min(sms * per_sm, (B + kThreads / 32 - 1) / (kThreads / 32));
  if (blocks <= 0) return (int)cudaErrorInvalidConfiguration;
  const __nv_bfloat16* t = static_cast<const __nv_bfloat16*>(tabs);
  void* args[] = {(void*)&t,    (void*)&R,       (void*)&T,      (void*)&iv,
                  (void*)&off,  (void*)&idx0,    (void*)&tid0,   (void*)&B,
                  (void*)&K,    (void*)&hist,    (void*)&out,    (void*)&idx_out,
                  (void*)&tid_out, (void*)&hits_out};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)trav_sched_kernel, dim3(blocks), dim3(kThreads), args, smem,
      (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" int rt2_probe_leaf(const void* hi, const void* mid, int R,
                              const float* iv, const int* idx0, int B, int K,
                              float* out, int* idx_out, long long* sum_out,
                              void* stream) {
  if (R <= 0 || B <= 0 || K < 0) return (int)cudaErrorInvalidValue;
  size_t smem = (size_t)R * kSlots * 2 * 2;
  cudaFuncSetAttribute(leaf_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  leaf_kernel<<<lane_grid(leaf_kernel, B, smem), kThreads, smem,
                (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(hi),
      static_cast<const __nv_bfloat16*>(mid), R, iv, idx0, B, K, out, idx_out,
      sum_out);
  return (int)cudaGetLastError();
}
