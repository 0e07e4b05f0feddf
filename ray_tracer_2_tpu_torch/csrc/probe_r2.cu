// Hopper probes of the Pallas probes of scripts/probe_r2.py, for one NVIDIA
// Hopper card (sm_90a).
//
// Replaces the TPU kernels
//   pallas_hello          (probe_r2.py:207, pallas_call :216) -> rt2_probe_hello
//   pallas_onehot_loop    (probe_r2.py:224, pallas_call :251) -> rt2_probe_onehot_loop
//   pallas_lane_gather    (probe_r2.py:263, pallas_call :283) -> rt2_probe_lane_gather
//   pallas_sublane_gather (probe_r2.py:294, pallas_call :308) -> rt2_probe_sublane_gather
//   pallas_dyn_dma        (probe_r2.py:319, pallas_call :339) -> rt2_probe_dyn_dma
// computing what each computes (ray_tracer_2_tpu_torch/probes/r2.py holds
// the plain PyTorch versions and the script's XLA probes as PyTorch calls).
//
// What bounds them on this card:
// - hello, sublane_gather and dyn_dma move bytes: they read each input once
//   and write each output once in 16-byte loads and stores (dyn_dma copies
//   one 128 KB block per bin, one block of threads per bin; TMA is for a
//   redesign). Their bound is bytes over 3.35 TB/s; at these sizes the
//   launch dominates.
// - onehot_loop and lane_gather are chains of dependent fetches from a
//   table in shared memory, bound by the latency of each step (their bound,
//   operations over 67 TFLOP/s, is a floor). The TPU fetched a row with a
//   one-hot matrix product; here a lane's 128-column row is one warp (four
//   columns a thread) reading the row straight out of shared memory, and
//   the checksum (the sum of every fetched column) keeps the columns that
//   do not steer the chain from being dropped.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kCols = 128;

__device__ __forceinline__ float elem(const float* t, size_t i) { return t[i]; }
__device__ __forceinline__ float elem(const __nv_bfloat16* t, size_t i) {
  return __bfloat162float(t[i]);
}

__global__ void hello_kernel(const float4* __restrict__ x, int n4,
                             float4* __restrict__ out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n4) {
    float4 v = x[i];
    out[i] = make_float4(v.x * 2.0f, v.y * 2.0f, v.z * 2.0f, v.w * 2.0f);
  }
}

// `steps` dependent fetches idx = int(tab[idx, 0]) % R per lane; the table
// (R x 128, float or bf16) staged in shared memory, one warp per lane.
constexpr int kOnehotThreads = 1024;

template <typename T>
__global__ void __launch_bounds__(kOnehotThreads)
onehot_loop_kernel(const T* __restrict__ tab, int R,
                   const int* __restrict__ idx0, int B, int steps,
                   float* __restrict__ out, int* __restrict__ sum_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_tab = reinterpret_cast<T*>(smem);
  const int n16 = (int)((size_t)R * kCols * sizeof(T) / 16);
  for (int i = threadIdx.x; i < n16; i += blockDim.x)
    reinterpret_cast<uint4*>(s_tab)[i] = reinterpret_cast<const uint4*>(tab)[i];
  __syncthreads();
  const int lane = threadIdx.x & 31, warps = blockDim.x / 32;
  for (int b = blockIdx.x * warps + threadIdx.x / 32; b < B;
       b += gridDim.x * warps) {
    int idx = idx0[b], sum = 0;
    for (int s = 0; s < steps; ++s) {
      const T* row = s_tab + (size_t)idx * kCols + lane * 4;
      float v0 = elem(row, 0);
#pragma unroll
      for (int j = 0; j < 4; ++j) sum += (int)elem(row, j);
      idx = (int)__shfl_sync(kFull, v0, 0) % R;
    }
    sum = __reduce_add_sync(kFull, sum);
    if (lane == 0) {
      out[b] = (float)idx;
      sum_out[b] = sum;
    }
  }
}

// `steps` dependent fetches idx = int(tab[b, idx]) % 128 from each lane's
// private 128-entry table, staged in shared memory; one thread per lane.
constexpr int kLaneThreads = 64;

__global__ void __launch_bounds__(kLaneThreads)
lane_gather_kernel(const float* __restrict__ tab, const int* __restrict__ idx0,
                   int B, int steps, float* __restrict__ out) {
  __shared__ __align__(16) float s_tab[kLaneThreads * kCols];
  const int b0 = blockIdx.x * kLaneThreads;
  const int n = min(kLaneThreads, B - b0);
  const float4* g = reinterpret_cast<const float4*>(tab + (size_t)b0 * kCols);
  for (int i = threadIdx.x; i < n * kCols / 4; i += blockDim.x)
    reinterpret_cast<float4*>(s_tab)[i] = g[i];
  __syncthreads();
  if (threadIdx.x >= n) return;
  const float* t = s_tab + threadIdx.x * kCols;
  int idx = idx0[b0 + threadIdx.x];
  for (int s = 0; s < steps; ++s) idx = (int)t[idx] % kCols;
  out[b0 + threadIdx.x] = (float)idx;
}

// out[i] = tab[idx[i]], one warp per row, 16-byte loads.
__global__ void sublane_gather_kernel(const float4* __restrict__ tab,
                                      const int* __restrict__ idx, int B,
                                      float4* __restrict__ out) {
  const int i = blockIdx.x;
  if (i < B)
    out[(size_t)i * (kCols / 4) + threadIdx.x] =
        tab[(size_t)idx[i] * (kCols / 4) + threadIdx.x];
}

// out block i = 2 * table block bins[i], one block of threads per bin.
__global__ void dyn_dma_kernel(const float4* __restrict__ table,
                               const int* __restrict__ bins, int block4,
                               float4* __restrict__ out) {
  const float4* src = table + (size_t)bins[blockIdx.x] * block4;
  float4* dst = out + (size_t)blockIdx.x * block4;
  for (int i = threadIdx.x; i < block4; i += blockDim.x) {
    float4 v = src[i];
    dst[i] = make_float4(v.x * 2.0f, v.y * 2.0f, v.z * 2.0f, v.w * 2.0f);
  }
}

}  // namespace

// Each entry point launches on `stream`, allocates nothing, does not
// synchronise, and returns cudaGetLastError() (0 = launched).
extern "C" int rt2_probe_hello(const float* x, int n, float* out,
                               void* stream) {
  if (n % 4) return (int)cudaErrorInvalidValue;
  int n4 = n / 4;
  if (n4 > 0)
    hello_kernel<<<(n4 + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
        reinterpret_cast<const float4*>(x), n4, reinterpret_cast<float4*>(out));
  return (int)cudaGetLastError();
}

// bf16: 1 for a bfloat16 table, 0 for float32.
extern "C" int rt2_probe_onehot_loop(const void* tab, int R, int bf16,
                                     const int* idx0, int B, int steps,
                                     float* out, int* sum_out, void* stream) {
  if (R <= 0 || B <= 0 || steps < 0) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int warps = kOnehotThreads / 32;
  const int blocks = max(1, min((B + warps - 1) / warps, sms));
  if (bf16) {
    size_t smem = (size_t)R * kCols * sizeof(__nv_bfloat16);
    cudaFuncSetAttribute(onehot_loop_kernel<__nv_bfloat16>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    onehot_loop_kernel<__nv_bfloat16>
        <<<blocks, kOnehotThreads, smem, (cudaStream_t)stream>>>(
            static_cast<const __nv_bfloat16*>(tab), R, idx0, B, steps, out,
            sum_out);
  } else {
    size_t smem = (size_t)R * kCols * sizeof(float);
    cudaFuncSetAttribute(onehot_loop_kernel<float>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    onehot_loop_kernel<float>
        <<<blocks, kOnehotThreads, smem, (cudaStream_t)stream>>>(
            static_cast<const float*>(tab), R, idx0, B, steps, out, sum_out);
  }
  return (int)cudaGetLastError();
}

extern "C" int rt2_probe_lane_gather(const float* tab, const int* idx0, int B,
                                     int steps, float* out, void* stream) {
  if (B <= 0 || steps < 0) return (int)cudaErrorInvalidValue;
  lane_gather_kernel<<<(B + kLaneThreads - 1) / kLaneThreads, kLaneThreads, 0,
                       (cudaStream_t)stream>>>(tab, idx0, B, steps, out);
  return (int)cudaGetLastError();
}

extern "C" int rt2_probe_sublane_gather(const float* tab, const int* idx,
                                        int B, float* out, void* stream) {
  if (B > 0)
    sublane_gather_kernel<<<B, kCols / 4, 0, (cudaStream_t)stream>>>(
        reinterpret_cast<const float4*>(tab), idx, B,
        reinterpret_cast<float4*>(out));
  return (int)cudaGetLastError();
}

// table: n_blocks x rows x 128 floats; out: n_bins x rows x 128.
extern "C" int rt2_probe_dyn_dma(const float* table, const int* bins,
                                 int n_bins, int rows, float* out,
                                 void* stream) {
  if (rows <= 0) return (int)cudaErrorInvalidValue;
  if (n_bins > 0)
    dyn_dma_kernel<<<n_bins, 256, 0, (cudaStream_t)stream>>>(
        reinterpret_cast<const float4*>(table), bins, rows * kCols / 4,
        reinterpret_cast<float4*>(out));
  return (int)cudaGetLastError();
}
