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
// a block stages 256 triangles at a time in shared memory as hoisted rows
// (csrc/brute.cuh stage_row: v0, both edges and the normal, 16 KB), and
// every thread holds one ray in registers and walks the staged rows with
// four 16-byte shared-memory loads a row. Compiled without contraction
// (--fmad=false), the loop is bound by instruction throughput: 47 float
// operations per pair, each its own instruction (about 70 with the guarded
// IEEE division, the compares and the selects), so the card's ceiling for
// it is half its float32 peak. The row loads are 4 of those 70
// instructions, which is why a register tile of 2 or 4 rays per thread
// measured slower than one ray (PERF.md section 6 keeps the three times)
// and is not compiled.
// Thread t of a block takes ray base + t: the two 16-byte loads of a ray
// and the two 16-byte stores of its record are coalesced across a warp.
// Tables above one chunk are staged chunk after chunk with the running
// best carried through (a strict `<` in index order, so the lowest index
// keeps a tie); every group the renderer sends is one chunk, so staging is
// not overlapped with the loop.
#include <cuda_runtime.h>
#include <stdint.h>

#include "brute.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 256;  // triangles staged at a time

__global__ void __launch_bounds__(kThreads)
brute_kernel(const float* __restrict__ rays, const float* __restrict__ tris,
             int n_tris, int n_rays, float* __restrict__ out) {
  __shared__ float4 s_row[kChunk * rt2_brute::kRowWords];
  const int ray = blockIdx.x * kThreads + threadIdx.x;
  float4 q0 = make_float4(0.0f, 0.0f, 0.0f, 0.0f), q1 = q0;
  if (ray < n_rays) {  // a lane past the end tests a null ray: no hit
    const float4* src = reinterpret_cast<const float4*>(rays) + 2 * (size_t)ray;
    q0 = __ldg(src);
    q1 = __ldg(src + 1);
  }
  const float o[3] = {q0.x, q0.y, q0.z};
  const float d[3] = {q0.w, q1.x, q1.y};
  rt2_brute::Hit best;
  rt2_brute::no_hit(best);
  for (int t0 = 0; t0 < n_tris; t0 += kChunk) {
    const int n = min(kChunk, n_tris - t0);
    __syncthreads();  // the previous chunk is no longer read
    for (int i = threadIdx.x; i < n; i += kThreads)
      rt2_brute::stage_row(tris + (size_t)(t0 + i) * rt2_brute::kTableCols,
                           s_row + i * rt2_brute::kRowWords);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const float4* row = s_row + j * rt2_brute::kRowWords;
      // the four words copied into registers first: handing row[0..3]
      // straight to test_row compiled to 56 registers in place of 60 and
      // measured 2.5% slower (1.182 against 1.154 ms, H100)
      const float4 a = row[0], b = row[1], c = row[2], nn = row[3];
      rt2_brute::test_row(a, b, c, nn, t0 + j, o, d, best);
    }
  }
  if (ray >= n_rays) return;
  // the material id of the hit row, from the packed table (column 9)
  const float mat = best.tri >= 0
      ? __ldg(tris + (size_t)best.tri * rt2_brute::kTableCols + 9) : 0.0f;
  float4* w = reinterpret_cast<float4*>(out) + 2 * (size_t)ray;
  w[0] = make_float4(best.dst, best.u, best.v, best.det);
  w[1] = make_float4((float)(int)mat, (float)best.tri, 0.0f, 0.0f);
}

}  // namespace

// Launch on `stream`; allocates nothing and does not synchronise. `rays`,
// `tris` and `out` must be 16-byte aligned. Returns cudaGetLastError()
// (0 = launched).
extern "C" int rt2_brute_intersect(const float* rays, const float* tris,
                                   int n_tris, int n_rays, float* out,
                                   void* stream) {
  if (n_tris < 0 || n_rays < 0 ||
      (((uintptr_t)rays | (uintptr_t)tris | (uintptr_t)out) & 15u) != 0u)
    return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return (int)cudaGetLastError();
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  brute_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      rays, tris, n_tris, n_rays, out);
  return (int)cudaGetLastError();
}
