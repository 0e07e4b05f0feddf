// Hopper probes of scripts/probe_lut.py, for one NVIDIA Hopper card (sm_90a).
//
// Replaces the TPU kernels
//   lane_gather_chain     (probe_lut.py:46,  pallas_call :69)  -> rt2_probe_lane_gather_chain
//   sublane_gather_samey  (probe_lut.py:82,  pallas_call :101) -> rt2_probe_sublane_gather_samey
//   lut1024_chain         (probe_lut.py:135, pallas_call :155) -> rt2_probe_lut1024_chain
//   lut_row_fetch         (probe_lut.py:167, pallas_call :196) -> rt2_probe_lut_row_fetch
//   scalar_treelet_select (probe_lut.py:208, pallas_call :238) -> rt2_probe_scalar_treelet_select
//   mxu_leaf_dense        (probe_lut.py:250, pallas_call :276) -> rt2_probe_mxu_leaf_dense
//   big_body_compile      (probe_lut.py:289, pallas_call :323) -> rt2_probe_big_body
// computing what each computes (ray_tracer_2_tpu_torch/probes/lut.py holds
// the plain PyTorch versions).
//
// The (8, 128) vreg block of the TPU is one block of 1024 threads here,
// thread 128 s + l holding sublane s, lane l. The two-level 1024-entry LUT
// (_lut1024, probe_lut.py:113) is out[s, l] = tab[hi, lo[hi, l]] with
// hi = idx[s, l] >> 7 and lo = idx & 127: the second gather reads the `lo`
// of lane (hi, l), not the lane's own. So every step writes the block's
// indices to shared memory, meets at a barrier, and reads the partner's.
// Tables sit in shared memory (up to 200 KB, dynamic, opted in), except
// scalar_treelet_select's 768 KB, which stays in global memory and is
// staged one 48 KB treelet per step after a block-wide min picks it.
//
// All but mxu_leaf_dense are chains of dependent shared-memory fetches with
// a block barrier per step: bound by that latency, not by 67 TFLOP/s or
// 3.35 TB/s (the bound is a floor). mxu_leaf_dense is SIMT here (fp32 or
// bf16 inputs, fp32 sums in k order, one warp per ray row, the triangle
// block in shared memory); no tensor-core form is written yet. Where
// columns do not steer the chain (mxu's columns 16..T-1, big_body's 48 and
// 49) the kernels also return a checksum over them, which the plain
// versions compute the same way.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kLanes = 128;
constexpr int kBlock = 1024;         // one (8, 128) vreg block
constexpr int kSub = 8;

// _lut1024 fetch of column block `col` (8 x 128 floats) for thread (s, l):
// p = the index of lane (hi, l).
__device__ __forceinline__ float lut_fetch(const float* col, int hi, int p) {
  return col[hi * kLanes + (p & 127)];
}

__global__ void __launch_bounds__(kBlock)
lane_gather_chain_kernel(const float* __restrict__ tab,
                         const int* __restrict__ idx0, int rows, int steps,
                         float* __restrict__ out) {
  __shared__ float s_tab[kBlock];
  const size_t base = (size_t)blockIdx.x * kBlock;
  const int s = threadIdx.x / kLanes;
  const bool live = blockIdx.x * kSub + s < rows;
  s_tab[threadIdx.x] = live ? tab[base + threadIdx.x] : 0.0f;
  __syncthreads();
  if (!live) return;
  const float* t = s_tab + s * kLanes;
  int idx = idx0[base + threadIdx.x];
  for (int k = 0; k < steps; ++k) idx = (int)t[idx] % 128;
  out[base + threadIdx.x] = (float)idx;
}

__global__ void __launch_bounds__(kBlock)
sublane_gather_samey_kernel(const float* __restrict__ tab,
                            const int* __restrict__ idx0, int steps,
                            float* __restrict__ out) {
  __shared__ float s_tab[kBlock];
  s_tab[threadIdx.x] = tab[threadIdx.x];
  __syncthreads();
  const int l = threadIdx.x % kLanes;
  int idx = idx0[threadIdx.x];
  for (int k = 0; k < steps; ++k) idx = (int)s_tab[idx * kLanes + l] % 8;
  out[threadIdx.x] = (float)idx;
}

// kSelect: the sublane level as 8 compare-selects over the lane-gathered
// block (_lut1024_sel), else as the indexed read (_lut1024).
template <bool kSelect>
__global__ void __launch_bounds__(kBlock)
lut1024_chain_kernel(const float* __restrict__ tab,
                     const int* __restrict__ idx0, int steps,
                     float* __restrict__ out) {
  __shared__ float s_tab[kBlock];
  __shared__ float s_g[kBlock];
  __shared__ int s_idx[kBlock];
  s_tab[threadIdx.x] = tab[threadIdx.x];
  __syncthreads();
  const int s = threadIdx.x / kLanes, l = threadIdx.x % kLanes;
  int idx = idx0[threadIdx.x];
  for (int k = 0; k < steps; ++k) {
    const int hi = idx >> 7;
    float v;
    if (kSelect) {
      s_g[threadIdx.x] = s_tab[s * kLanes + (idx & 127)];
      __syncthreads();
      v = 0.0f;
#pragma unroll
      for (int r = 0; r < kSub; ++r) v = hi == r ? s_g[r * kLanes + l] : v;
    } else {
      s_idx[threadIdx.x] = idx;
      __syncthreads();
      v = lut_fetch(s_tab, hi, s_idx[hi * kLanes + l]);
    }
    __syncthreads();
    idx = (int)v % 1024;
  }
  out[threadIdx.x] = (float)idx;
}

__global__ void __launch_bounds__(kBlock)
lut_row_fetch_kernel(const float* __restrict__ tab, int C,
                     const int* __restrict__ idx0, int steps,
                     float* __restrict__ out) {
  extern __shared__ __align__(16) float s_dyn[];
  float* s_tab = s_dyn;                      // C x 8 x 128
  int* s_idx = reinterpret_cast<int*>(s_dyn + (size_t)C * kBlock);
  for (int i = threadIdx.x; i < C * kBlock / 4; i += blockDim.x)
    reinterpret_cast<float4*>(s_tab)[i] =
        reinterpret_cast<const float4*>(tab)[i];
  const int l = threadIdx.x % kLanes;
  int idx = idx0[threadIdx.x];
  for (int k = 0; k < steps; ++k) {
    s_idx[threadIdx.x] = idx;
    __syncthreads();
    const int hi = idx >> 7, p = s_idx[hi * kLanes + l];
    float acc = 0.0f;
    int nxt = 0;
    for (int c = 0; c < C; ++c) {
      float v = lut_fetch(s_tab + (size_t)c * kBlock, hi, p);
      acc = acc + v;
      if (c == 0) nxt = (int)v % 1024;
    }
    __syncthreads();
    idx = (nxt + (int)acc) % 1024;
  }
  out[threadIdx.x] = (float)idx;
}

// Each step: tid = min(idx) >> 10 over the block, stage treelet tid's
// C column blocks from global memory, then two-level fetches.
__global__ void __launch_bounds__(kBlock)
scalar_treelet_select_kernel(const float* __restrict__ tab, int C,
                             int n_treelets, const int* __restrict__ idx0,
                             int steps, float* __restrict__ out) {
  extern __shared__ __align__(16) float s_dyn[];
  float* s_tab = s_dyn;                      // C x 8 x 128 of one treelet
  int* s_loc = reinterpret_cast<int*>(s_dyn + (size_t)C * kBlock);
  int* s_min = s_loc + kBlock;               // 32 warp minima
  const int l = threadIdx.x % kLanes, lane = threadIdx.x & 31;
  const int modulus = n_treelets * 1024;
  int idx = idx0[threadIdx.x];
  for (int k = 0; k < steps; ++k) {
    int m = __reduce_min_sync(kFull, idx);
    if (lane == 0) s_min[threadIdx.x / 32] = m;
    __syncthreads();
    if (threadIdx.x < 32) {
      m = __reduce_min_sync(kFull, s_min[threadIdx.x]);
      if (threadIdx.x == 0) s_min[32] = m;
    }
    __syncthreads();
    const int tid = s_min[32] >> 10;
    const float4* g =
        reinterpret_cast<const float4*>(tab + (size_t)tid * C * kBlock);
    for (int i = threadIdx.x; i < C * kBlock / 4; i += blockDim.x)
      reinterpret_cast<float4*>(s_tab)[i] = g[i];
    const int local = idx & 1023;
    s_loc[threadIdx.x] = local;
    __syncthreads();
    const int hi = local >> 7, p = s_loc[hi * kLanes + l];
    float acc = 0.0f;
    for (int c = 0; c < C; ++c)
      acc = acc + lut_fetch(s_tab + (size_t)c * kBlock, hi, p);
    __syncthreads();
    idx = (idx + (int)acc + 1) % modulus;
  }
  out[threadIdx.x] = (float)idx;
}

// mxu_leaf_dense: acc = (dot(rays + acc, tris))[:, :16] * 0.5, `steps`
// times. One warp per ray row; thread t owns columns t, t + 32, ...; the
// 16 features of the row's next operand go through shared memory.
constexpr int kLeafThreads = 256;
constexpr int kFeat = 16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(kLeafThreads)
mxu_leaf_dense_kernel(const T* __restrict__ rays, const T* __restrict__ tris,
                      int n_rays, int n_tris, int steps,
                      float* __restrict__ out,
                      long long* __restrict__ sum_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_tris = reinterpret_cast<T*>(smem);                 // 16 x n_tris
  float* s_x = reinterpret_cast<float*>(
      smem + (((size_t)kFeat * n_tris * sizeof(T) + 15) / 16) * 16);
  for (int i = threadIdx.x; i < kFeat * n_tris; i += blockDim.x)
    s_tris[i] = tris[i];
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  const int row = blockIdx.x * (kLeafThreads / 32) + warp;
  float* x = s_x + warp * kFeat;
  T ray = from_f<T>(0.0f), acc = from_f<T>(0.0f);
  if (row < n_rays && lane < kFeat) {
    ray = rays[(size_t)row * kFeat + lane];
    x[lane] = to_f(ray);                                  // rays + 0
  }
  __syncthreads();
  if (row >= n_rays) return;
  long long sum = 0;
  for (int k = 0; k < steps; ++k) {
    float p0 = 0.0f;
    for (int j = lane; j < n_tris; j += 32) {
      float p = x[0] * to_f(s_tris[j]);
#pragma unroll
      for (int f = 1; f < kFeat; ++f)
        p = p + x[f] * to_f(s_tris[f * n_tris + j]);
      sum += (long long)__float_as_uint(p);
      if (j == lane) p0 = p;
    }
    __syncwarp();
    if (lane < kFeat) {
      acc = from_f<T>(to_f(from_f<T>(p0)) * 0.5f);
      x[lane] = to_f(from_f<T>(to_f(ray) + to_f(acc)));
    }
    __syncwarp();
  }
  for (int d = 16; d > 0; d >>= 1) sum += __shfl_down_sync(kFull, sum, d);
  if (lane < kFeat) out[(size_t)row * kFeat + lane] = to_f(acc);
  if (lane == 0) sum_out[row] = sum;
}

__global__ void __launch_bounds__(kBlock)
big_body_kernel(const float* __restrict__ tab, int C,
                const int* __restrict__ idx0, int steps,
                float* __restrict__ out, int* __restrict__ idx_out,
                int* __restrict__ sum_out) {
  extern __shared__ __align__(16) float s_dyn[];
  float* s_tab = s_dyn;
  int* s_idx = reinterpret_cast<int*>(s_dyn + (size_t)C * kBlock);
  for (int i = threadIdx.x; i < C * kBlock / 4; i += blockDim.x)
    reinterpret_cast<float4*>(s_tab)[i] =
        reinterpret_cast<const float4*>(tab)[i];
  const int l = threadIdx.x % kLanes;
  int idx = idx0[threadIdx.x], sum = 0;
  float best = 0.0f;
  for (int k = 0; k < steps; ++k) {
    s_idx[threadIdx.x] = idx;
    __syncthreads();
    const int hi = idx >> 7, p = s_idx[hi * kLanes + l];
    float tmin = -3e38f, tmax = 3e38f, c0 = 0.0f;
    for (int c = 0; c + 1 < C; c += 2) {
      float a = lut_fetch(s_tab + (size_t)c * kBlock, hi, p);
      float b = lut_fetch(s_tab + (size_t)(c + 1) * kBlock, hi, p);
      sum += (int)a + (int)b;
      if (c == 0) c0 = a;
      if (c < C - 2) {                        // pairs 0..C-3, as range(0, C-2, 2)
        float t1 = (a - best) * 0.5f, t2 = (b - best) * 0.5f;
        tmin = fmaxf(tmin, fminf(t1, t2));
        tmax = fminf(tmax, fmaxf(t1, t2));
      }
    }
    if (C % 2) sum += (int)lut_fetch(s_tab + (size_t)(C - 1) * kBlock, hi, p);
    __syncthreads();
    const float hit = tmax >= tmin ? 1.0f : 0.0f;
    idx = ((int)c0 + idx) % 1024;
    best = best + hit * 0.25f;
  }
  out[threadIdx.x] = best + (float)idx;
  idx_out[threadIdx.x] = idx;
  sum_out[threadIdx.x] = sum;
}

template <typename Kernel>
cudaError_t opt_in(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace

// Each entry point launches on `stream`, allocates nothing, does not
// synchronise, and returns cudaGetLastError() (0 = launched).
extern "C" int rt2_probe_lane_gather_chain(const float* tab, const int* idx0,
                                           int rows, int steps, float* out,
                                           void* stream) {
  if (rows <= 0 || steps < 0) return (int)cudaErrorInvalidValue;
  lane_gather_chain_kernel<<<(rows + kSub - 1) / kSub, kBlock, 0,
                             (cudaStream_t)stream>>>(tab, idx0, rows, steps,
                                                     out);
  return (int)cudaGetLastError();
}

extern "C" int rt2_probe_sublane_gather_samey(const float* tab,
                                              const int* idx0, int steps,
                                              float* out, void* stream) {
  if (steps < 0) return (int)cudaErrorInvalidValue;
  sublane_gather_samey_kernel<<<1, kBlock, 0, (cudaStream_t)stream>>>(
      tab, idx0, steps, out);
  return (int)cudaGetLastError();
}

extern "C" int rt2_probe_lut1024_chain(const float* tab, const int* idx0,
                                       int steps, int select, float* out,
                                       void* stream) {
  if (steps < 0) return (int)cudaErrorInvalidValue;
  if (select)
    lut1024_chain_kernel<true><<<1, kBlock, 0, (cudaStream_t)stream>>>(
        tab, idx0, steps, out);
  else
    lut1024_chain_kernel<false><<<1, kBlock, 0, (cudaStream_t)stream>>>(
        tab, idx0, steps, out);
  return (int)cudaGetLastError();
}

extern "C" int rt2_probe_lut_row_fetch(const float* tab, int C,
                                       const int* idx0, int steps, float* out,
                                       void* stream) {
  if (C <= 0 || steps < 0) return (int)cudaErrorInvalidValue;
  size_t smem = ((size_t)C + 1) * kBlock * 4;
  cudaError_t err = opt_in(lut_row_fetch_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  lut_row_fetch_kernel<<<1, kBlock, smem, (cudaStream_t)stream>>>(
      tab, C, idx0, steps, out);
  return (int)cudaGetLastError();
}

extern "C" int rt2_probe_scalar_treelet_select(const float* tab, int C,
                                               int n_treelets,
                                               const int* idx0, int steps,
                                               float* out, void* stream) {
  if (C <= 0 || n_treelets <= 0 || steps < 0)
    return (int)cudaErrorInvalidValue;
  size_t smem = ((size_t)C + 1) * kBlock * 4 + 33 * 4;
  cudaError_t err = opt_in(scalar_treelet_select_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  scalar_treelet_select_kernel<<<1, kBlock, smem, (cudaStream_t)stream>>>(
      tab, C, n_treelets, idx0, steps, out);
  return (int)cudaGetLastError();
}

// bf16: 1 for bfloat16 rays and tris, 0 for float32.
extern "C" int rt2_probe_mxu_leaf_dense(const void* rays, const void* tris,
                                        int n_rays, int n_tris, int bf16,
                                        int steps, float* out,
                                        long long* sum_out, void* stream) {
  if (n_rays <= 0 || n_tris < kFeat || steps < 0)
    return (int)cudaErrorInvalidValue;
  const int rows_per_block = kLeafThreads / 32;
  const int blocks = (n_rays + rows_per_block - 1) / rows_per_block;
  const size_t x_bytes = (size_t)rows_per_block * kFeat * sizeof(float);
  if (bf16) {
    size_t smem = (((size_t)kFeat * n_tris * 2 + 15) / 16) * 16 + x_bytes;
    cudaError_t err = opt_in(mxu_leaf_dense_kernel<__nv_bfloat16>, smem);
    if (err != cudaSuccess) return (int)err;
    mxu_leaf_dense_kernel<__nv_bfloat16>
        <<<blocks, kLeafThreads, smem, (cudaStream_t)stream>>>(
            static_cast<const __nv_bfloat16*>(rays),
            static_cast<const __nv_bfloat16*>(tris), n_rays, n_tris, steps,
            out, sum_out);
  } else {
    size_t smem = (((size_t)kFeat * n_tris * 4 + 15) / 16) * 16 + x_bytes;
    cudaError_t err = opt_in(mxu_leaf_dense_kernel<float>, smem);
    if (err != cudaSuccess) return (int)err;
    mxu_leaf_dense_kernel<float>
        <<<blocks, kLeafThreads, smem, (cudaStream_t)stream>>>(
            static_cast<const float*>(rays), static_cast<const float*>(tris),
            n_rays, n_tris, steps, out, sum_out);
  }
  return (int)cudaGetLastError();
}

extern "C" int rt2_probe_big_body(const float* tab, int C, const int* idx0,
                                  int steps, float* out, int* idx_out,
                                  int* sum_out, void* stream) {
  if (C < 2 || steps < 0) return (int)cudaErrorInvalidValue;
  size_t smem = ((size_t)C + 1) * kBlock * 4;
  cudaError_t err = opt_in(big_body_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  big_body_kernel<<<1, kBlock, smem, (cudaStream_t)stream>>>(
      tab, C, idx0, steps, out, idx_out, sum_out);
  return (int)cudaGetLastError();
}
