// A (., 128) row of slots spread over one warp, shared by csrc/probe_trav.cu
// and csrc/probe_packet.cu: thread t holds slots 4t..4t+3, and
// pltpu.roll(x, s, 1) (out[i] = x[i - s], as jnp.roll) takes the last s
// slots of the thread below through __shfl_sync. The slab test is the one
// of scripts/probe_trav.py:88-95 and scripts/probe_packet.py:57-63 (rolls
// 3, 1, 2), in the same operation order as the plain versions.
//
// Every function below is called by all 32 lanes of a warp at once.
#pragma once

#include <cuda_runtime.h>

namespace rt2_row {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kSlots = 128;

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

// y = pltpu.roll(x, S, 1) on a row spread over the warp
template <int S>
__device__ __forceinline__ void roll(const float (&x)[4], float (&y)[4]) {
  float prev[4];
  const int src = (lane_id() + 31) & 31;
#pragma unroll
  for (int j = 4 - S; j < 4; ++j) prev[j] = __shfl_sync(kFull, x[j], src);
#pragma unroll
  for (int j = 0; j < 4; ++j) y[j] = j >= S ? x[j - S] : prev[j + 4 - S];
}

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

// The slab test of `row` for one ray (iv, off): hit[j] is this thread's
// slot 4t+j hit, (tf >= tn) & (tn < tbest).
__device__ __forceinline__ void slab_hits(const float (&row)[4],
                                          const float (&iv)[4],
                                          const float (&off)[4], float tbest,
                                          bool (&hit)[4]) {
  float tt[4], r[4], tmin[4], tmax[4], a[4], b[4], tn[4], tf[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) tt[j] = row[j] * iv[j] + off[j];
  roll<3>(tt, r);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    tmin[j] = fminf(tt[j], r[j]);
    tmax[j] = fmaxf(tt[j], r[j]);
  }
  roll<1>(tmin, a);
  roll<2>(tmin, b);
#pragma unroll
  for (int j = 0; j < 4; ++j) tn[j] = fmaxf(fmaxf(tmin[j], a[j]), b[j]);
  roll<1>(tmax, a);
  roll<2>(tmax, b);
#pragma unroll
  for (int j = 0; j < 4; ++j) tf[j] = fminf(fminf(tmax[j], a[j]), b[j]);
#pragma unroll
  for (int j = 0; j < 4; ++j) hit[j] = (tf[j] >= tn[j]) && (tn[j] < tbest);
}

}  // namespace rt2_row
