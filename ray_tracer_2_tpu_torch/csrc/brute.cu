// Streaming brute-force closest hit for one NVIDIA Hopper card (sm_90a).
//
// Replaces the TPU kernel ray_tracer_2_tpu/kernels/pallas_brute.py
// (pallas_brute_intersect :88 -> _kernel :32, pallas_call :94), with its
// contract: rays (B, 8) float32 [o3 d3 pad2] in, (B, 8) float32
// [dst u v det mat tri_local 0 0] out, against a packed (T, 16) triangle
// table [v0 v1 v2 mat cull pad5] of one instance group. A miss gives
// dst = 2^127, tri_local = -1 and zeros.
//
// On the TPU a ray block streamed the whole VMEM-resident table through
// the VPU in 256-triangle chunks as (256 rays x 256 triangles) tiles. Here
// one thread owns one ray and walks the table itself (csrc/brute.cuh);
// the block stages the table in shared memory 256 triangles x 11 floats
// (11 KB) at a time, where every thread of a warp reads the same word at
// once (a broadcast), so the loop is bound by its ~40 floating-point
// operations per triangle, not by memory. Groups of at most 256 triangles
// (every group the renderer sends here) are staged once.
#include <cuda_runtime.h>
#include <stdint.h>

#include "brute.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 256;     // triangles staged at a time
constexpr int kRayCols = 8;
constexpr int kTriCols = 16;
constexpr int kOutCols = 8;

__global__ void __launch_bounds__(kThreads)
brute_kernel(const float* __restrict__ rays, const float* __restrict__ tris,
             int n_tris, int n_rays, float* __restrict__ out) {
  __shared__ float s_tri[kChunk * rt2_brute::kStaged];
  int ray = blockIdx.x * blockDim.x + threadIdx.x;
  bool live = ray < n_rays;
  float o[3] = {0.0f, 0.0f, 0.0f}, d[3] = {0.0f, 0.0f, 0.0f};
  if (live) {
    const float* r = rays + (size_t)ray * kRayCols;
    o[0] = r[0]; o[1] = r[1]; o[2] = r[2];
    d[0] = r[3]; d[1] = r[4]; d[2] = r[5];
  }
  rt2_brute::Hit best;
  best.dst = rt2_brute::kInf;
  best.u = best.v = best.det = 0.0f;
  best.tri = -1;
  best.mat = 0;
  for (int t0 = 0; t0 < n_tris; t0 += kChunk) {
    int n = min(kChunk, n_tris - t0);
    __syncthreads();  // the previous chunk is no longer read
    for (int i = threadIdx.x; i < n * rt2_brute::kStaged; i += blockDim.x) {
      int row = i / rt2_brute::kStaged, col = i % rt2_brute::kStaged;
      s_tri[i] = tris[(size_t)(t0 + row) * kTriCols + col];
    }
    __syncthreads();
    if (!live) continue;
    rt2_brute::Hit h;
    rt2_brute::closest_hit(s_tri, rt2_brute::kStaged, n, o, d, h);
    if (h.dst < best.dst) {  // strict: the earlier chunk keeps a tie
      best = h;
      best.tri = t0 + h.tri;
    }
  }
  if (live) {
    float* w = out + (size_t)ray * kOutCols;
    w[0] = best.dst;
    w[1] = best.u;
    w[2] = best.v;
    w[3] = best.det;
    w[4] = (float)best.mat;
    w[5] = (float)best.tri;
    w[6] = 0.0f;
    w[7] = 0.0f;
  }
}

}  // namespace

// Launch on `stream`; allocates nothing and does not synchronise. Returns
// cudaGetLastError() (0 = launched).
extern "C" int rt2_brute_intersect(const float* rays, const float* tris,
                                   int n_tris, int n_rays, float* out,
                                   void* stream) {
  if (n_tris < 0 || n_rays < 0) return (int)cudaErrorInvalidValue;
  int blocks = (n_rays + kThreads - 1) / kThreads;
  if (blocks > 0)
    brute_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        rays, tris, n_tris, n_rays, out);
  return (int)cudaGetLastError();
}
