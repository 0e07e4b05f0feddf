// Hopper probe of scripts/probe_packet.py, for one NVIDIA Hopper card
// (sm_90a).
//
// Replaces the TPU kernel run (probe_packet.py:41, pallas_call :89): one
// packet of P rays traverses a synthetic tree with SHARED control flow. A
// depth-48 stack of node ids lives in shared memory; each visit broadcasts
// the node's 128-slot row to every ray, runs the slab test in slot space
// (rolls 3, 1, 2), and an `any` over the packet of slot 0 (near) and slot 6
// (far) drives a branchless double push and a pop; at most K visits.
// ray_tracer_2_tpu_torch/probes/packet.py holds the plain PyTorch version.
//
// The TPU ran one packet on its one core. Here one block is one packet:
// each ray's row is one warp (thread t holds slots 4t..4t+3, rolls through
// __shfl_sync: csrc/probe_row.cuh), the block's warps share the packet's
// rays, and the `any` is __syncthreads_or. The card runs `copies`
// identical packets, one per block (one per SM when launched so), each
// writing its own output, so one launch gives both one packet's latency
// per visit and the card's rate.
// Node rows (N x 128 f32, 8 MB) are read from global memory. Bound by the
// chain of visits, each a barrier and a dependent row fetch, not by the
// card's 67 TFLOP/s or 3.35 TB/s (the bound is a floor). Slot 0 and 6 steer;
// every slot's hit is counted (the checksum) so no slot's work is dropped.
#include <cuda_runtime.h>
#include <stdint.h>

#include "probe_row.cuh"

namespace {

using namespace rt2_row;

constexpr int kDepth = 48;
constexpr int kMaxThreads = 1024;
constexpr int kMaxRays = 1024;

__global__ void __launch_bounds__(kMaxThreads)
packet_kernel(const float* __restrict__ nodes, int N,
              const float* __restrict__ iv, const float* __restrict__ bb,
              int P, int K, float* __restrict__ out,
              int* __restrict__ visits_out, int* __restrict__ hits_out) {
  __shared__ int s_stack[kDepth];
  __shared__ int s_hits[kMaxRays];
  const int lane = lane_id(), warp = threadIdx.x / 32;
  const int warps = blockDim.x / 32;
  for (int p = threadIdx.x; p < P; p += blockDim.x) s_hits[p] = 0;
  if (threadIdx.x == 0) s_stack[0] = 0;
  __syncthreads();
  int sp = 1, visits = 0;
  float tbest = 1e9f;
  while (sp > 0 && visits < K) {
    const int node = s_stack[sp - 1];
    const float* row_p = nodes + (size_t)node * kSlots;
    float row[4];
    load4(row_p + lane * 4, row);
    bool near = false, far = false;
    for (int p = warp; p < P; p += warps) {
      float v[4], o[4];
      bool h[4];
      load4(iv + (size_t)p * kSlots + lane * 4, v);
      load4(bb + (size_t)p * kSlots + lane * 4, o);
      slab_hits(row, v, o, tbest, h);
      if (lane == 0) near |= h[0];     // slot 0
      if (lane == 1) far |= h[2];      // slot 6
      const int n = __reduce_add_sync(kFull, h[0] + h[1] + h[2] + h[3]);
      if (lane == 0) s_hits[p] += n;
    }
    const int any_near = __syncthreads_or(near) ? 1 : 0;
    const int any_far = __syncthreads_or(far) ? 1 : 0;
    const int c_near = max((int)row_p[12] % N, 1);
    const int c_far = max((int)row_p[13] % N, 1);
    if (threadIdx.x == 0) {
      s_stack[sp - 1] = c_far;
      s_stack[sp - 1 + any_far] = c_near;
    }
    sp = min(sp - 1 + any_far + any_near, kDepth - 1);
    tbest = tbest * 0.9995f + 0.001f;
    ++visits;
    __syncthreads();
  }
  float* o = out + (size_t)blockIdx.x * P;
  int* h = hits_out + (size_t)blockIdx.x * P;
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    o[p] = tbest + (float)visits;
    h[p] = s_hits[p];
  }
  if (threadIdx.x == 0) visits_out[blockIdx.x] = visits;
}

}  // namespace

// Launch `copies` identical packets on `stream` (out and hits_out hold
// copies x P, visits_out copies); allocates nothing, does not synchronise,
// returns cudaGetLastError() (0 = launched).
extern "C" int rt2_probe_packet(const float* nodes, int N, const float* iv,
                                const float* b, int P, int K, int copies,
                                float* out, int* visits_out, int* hits_out,
                                void* stream) {
  if (N <= 1 || P <= 0 || P > kMaxRays || K < 0 || copies <= 0)
    return (int)cudaErrorInvalidValue;
  int threads = min(P * 32, kMaxThreads);
  packet_kernel<<<copies, threads, 0, (cudaStream_t)stream>>>(
      nodes, N, iv, b, P, K, out, visits_out, hits_out);
  return (int)cudaGetLastError();
}
