// Hopper probes of scripts/probe_lut.py, for one NVIDIA Hopper card (sm_90a).
//
// Replaces the TPU kernels
//   lane_gather_chain     (probe_lut.py:46,  pallas_call :69)  -> rt2_probe_lane_gather_chain
//   sublane_gather_samey  (probe_lut.py:82,  pallas_call :101) -> rt2_probe_sublane_gather_samey
//   lut1024_chain         (probe_lut.py:135, pallas_call :155) -> rt2_probe_lut1024_chain
//   lut_row_fetch         (probe_lut.py:167, pallas_call :196) -> rt2_probe_lut_row_fetch
//   scalar_treelet_select (probe_lut.py:208, pallas_call :238) -> rt2_probe_scalar_treelet_select
//   mxu_leaf_dense        (probe_lut.py:250, pallas_call :276) -> rt2_probe_mxu_leaf_dense,
//                                                                 rt2_probe_mxu_leaf_dense_mma
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
// 3.35 TB/s (the bound is a floor). mxu_leaf_dense has three forms (see
// there): a float32 register tile, a bfloat16 SIMT form, both bit-equal to
// the plain version, and a bfloat16 tensor-core form (mma.sync), held to a
// tolerance. Where
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
// dependent steps, rays (B, 16), tris (16, T). Three forms:
//
// * float32, a register tile (mxu_leaf_f32_tile_kernel). float32 products
//   stay outside the tensor cores (TF32 would round the operands). A
//   thread holds the 16 features of kRays = 2 rays in registers and owns 4
//   neighbouring columns, so one 16-byte shared-memory load of
//   tris[f][4j..4j+3] feeds 4 x kRays products and the thread has 4 x kRays
//   independent sums in flight (1 and 4 rays a thread measured slower:
//   PERF.md section 6). Sums run in feature order, a multiply and
//   an add each (--fmad=false): bit-equal to the plain version. The 16
//   columns that steer the chain go through shared memory once a step
//   (double-buffered, one block barrier a step).
// * bfloat16, SIMT (mxu_leaf_dense_kernel): one warp per ray, lane t owns
//   columns t, t + 32, ...; operands widened to float32, sums in feature
//   order: bit-equal to the plain version. Every product term costs two
//   shared-memory loads, which is what bounds it.
// * bfloat16 on the tensor cores (mxu_leaf_mma_kernel): mma.sync
//   m16n8k16, bf16 operands, float32 accumulators. A warp owns 16 rays.
//   The accumulator tiles of columns 0-7 and 8-15 are, lane for lane, the
//   A fragment of the next step (c0, c1 of tile 0 -> a0; c2, c3 -> a1;
//   tile 1 -> a2, a3), so `* 0.5`, the rounding to bf16 and `+ rays` stay
//   in registers; the B fragments of a warp's columns do not change over
//   the steps and are held in registers too, read once from global
//   memory: the loop touches no memory at all. 1024 rays are 64 such
//   warps, so the other T/8 - 2 column tiles of a ray tile are spread over
//   several warps, each of which recomputes the chain's two tiles itself
//   and sums only its own share of the other columns: no warp waits on
//   another. wgmma is not used: its tile is 64 rows of A from shared
//   memory or registers of a whole warpgroup, and the chain's operand is
//   16 x 16 and lives in one warp's accumulators. A tensor core sums the
//   16 products of a term in its own order, so this form is not bit-equal
//   to the plain version (which sums in feature order); in place of the
//   bit checksum it returns, per ray, the float64 sum of every product
//   column of every step (each step's columns summed in float32 scaled by
//   2^-12 so the partial sum cannot overflow before a product does, then
//   widened), and the wrapper holds it to a stated tolerance.
constexpr int kLeafThreads = 256;
constexpr int kFeat = 16;

__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
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

// The float32 register tile. A block of kTileThreads threads is
// kTileThreads / tx ray groups of kRays rays; the `tx` threads of a group
// (a multiple of 32) walk the column groups of 4 columns tx apart.
// `sum_out` must be zeroed: the threads of a group add their shares.
constexpr int kTileThreads = 128;
constexpr int kTileCols = 4;
constexpr int kRays = 2;

__global__ void __launch_bounds__(kTileThreads)
mxu_leaf_f32_tile_kernel(const float* __restrict__ rays,
                         const float* __restrict__ tris, int n_rays,
                         int n_tris, int steps, int tx,
                         float* __restrict__ out,
                         unsigned long long* __restrict__ sum_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int groups = (n_tris + kTileCols - 1) / kTileCols;
  const int block_rays = kTileThreads / tx * kRays;
  float4* s_tris = reinterpret_cast<float4*>(smem);       // 16 x groups
  float* s_x = reinterpret_cast<float*>(s_tris + kFeat * groups);
  for (int i = threadIdx.x; i < kFeat * groups * kTileCols;
       i += kTileThreads) {                               // zero-padded
    const int f = i / (groups * kTileCols), col = i % (groups * kTileCols);
    reinterpret_cast<float*>(s_tris)[i] =
        col < n_tris ? tris[(size_t)f * n_tris + col] : 0.0f;
  }
  const int cx = threadIdx.x % tx, group = threadIdx.x / tx;
  const int ray0 = (blockIdx.x * (kTileThreads / tx) + group) * kRays;
  float x[kRays][kFeat];
  float own_ray[kRays][kTileCols], own_acc[kRays][kTileCols];
  unsigned long long sum[kRays];
#pragma unroll
  for (int r = 0; r < kRays; ++r) {
    sum[r] = 0ull;
#pragma unroll
    for (int f = 0; f < kFeat; ++f)
      x[r][f] = ray0 + r < n_rays ? rays[(size_t)(ray0 + r) * kFeat + f]
                                  : 0.0f;
#pragma unroll
    for (int c = 0; c < kTileCols; ++c) {
      // threads 0..3 of a group own the 16 columns that steer the chain
      own_ray[r][c] = cx < kFeat / kTileCols && ray0 + r < n_rays
          ? rays[(size_t)(ray0 + r) * kFeat + cx * kTileCols + c] : 0.0f;
      own_acc[r][c] = 0.0f;
    }
  }
  __syncthreads();
  for (int k = 0; k < steps; ++k) {
    float* next = s_x + ((size_t)(k & 1) * block_rays + group * kRays) * kFeat;
    for (int cg = cx; cg < groups; cg += tx) {
      float p[kRays][kTileCols];
      const float4 t0 = s_tris[cg];
#pragma unroll
      for (int r = 0; r < kRays; ++r) {
        p[r][0] = x[r][0] * t0.x; p[r][1] = x[r][0] * t0.y;
        p[r][2] = x[r][0] * t0.z; p[r][3] = x[r][0] * t0.w;
      }
#pragma unroll
      for (int f = 1; f < kFeat; ++f) {
        const float4 t = s_tris[f * groups + cg];
#pragma unroll
        for (int r = 0; r < kRays; ++r) {
          p[r][0] = p[r][0] + x[r][f] * t.x;
          p[r][1] = p[r][1] + x[r][f] * t.y;
          p[r][2] = p[r][2] + x[r][f] * t.z;
          p[r][3] = p[r][3] + x[r][f] * t.w;
        }
      }
#pragma unroll
      for (int r = 0; r < kRays; ++r)
#pragma unroll
        for (int c = 0; c < kTileCols; ++c)
          if (cg * kTileCols + c < n_tris)
            sum[r] += (unsigned long long)__float_as_uint(p[r][c]);
      if (cg < kFeat / kTileCols) {
#pragma unroll
        for (int r = 0; r < kRays; ++r)
#pragma unroll
          for (int c = 0; c < kTileCols; ++c) {
            own_acc[r][c] = p[r][c] * 0.5f;
            next[r * kFeat + cg * kTileCols + c] =
                own_ray[r][c] + own_acc[r][c];
          }
      }
    }
    __syncthreads();  // the other buffer is written next: one barrier a step
#pragma unroll
    for (int r = 0; r < kRays; ++r)
#pragma unroll
      for (int q = 0; q < kFeat / 4; ++q) {
        const float4 v = reinterpret_cast<const float4*>(next + r * kFeat)[q];
        x[r][4 * q] = v.x; x[r][4 * q + 1] = v.y;
        x[r][4 * q + 2] = v.z; x[r][4 * q + 3] = v.w;
      }
  }
#pragma unroll
  for (int r = 0; r < kRays; ++r) {
    unsigned long long v = sum[r];
    for (int d = 16; d > 0; d >>= 1) v += __shfl_down_sync(kFull, v, d);
    if (ray0 + r >= n_rays) continue;
    if ((threadIdx.x & 31) == 0) atomicAdd(sum_out + ray0 + r, v);
    if (cx < kFeat / kTileCols)
      reinterpret_cast<float4*>(out + (size_t)(ray0 + r) * kFeat)[cx] =
          make_float4(own_acc[r][0], own_acc[r][1], own_acc[r][2],
                      own_acc[r][3]);
  }
}

// D (16 x 8, float32) = A (16 x 16, bf16, row-major) x B (16 x 8, bf16,
// column-major) + D on the tensor cores.
__device__ __forceinline__ void mma_bf16_16816(float (&c)[4],
                                               const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two float32 values rounded to bf16 and packed, `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

// The B fragment of column tile `tile` (columns 8 tile .. 8 tile + 7) of
// tris (16, n_tris) bf16 for this lane: rows 2t, 2t+1 and 2t+8, 2t+9 of
// column 8 tile + g.
__device__ __forceinline__ void load_b(const unsigned short* tris, int n_tris,
                                       int tile, int g, int t,
                                       uint32_t (&b)[2]) {
  const unsigned short* col = tris + tile * 8 + g;
  b[0] = (uint32_t)__ldg(col + (size_t)(2 * t) * n_tris) |
         ((uint32_t)__ldg(col + (size_t)(2 * t + 1) * n_tris) << 16);
  b[1] = (uint32_t)__ldg(col + (size_t)(2 * t + 8) * n_tris) |
         ((uint32_t)__ldg(col + (size_t)(2 * t + 9) * n_tris) << 16);
}

constexpr int kMmaThreads = 128;
constexpr float kSumScale = 1.0f / 4096.0f;

// kTiles: column tiles (of 8) a warp sums besides the chain's two (2 or 4,
// picked by rt2_probe_mxu_leaf_dense_mma). Warp w
// of the `warps_per_tile` warps of a ray tile takes tiles 2 + w kTiles ..;
// warp 0 also sums the chain's tiles and writes the output. `col_sum` must
// be zeroed. n_tris is a multiple of 8.
template <int kTiles>
__global__ void __launch_bounds__(kMmaThreads)
mxu_leaf_mma_kernel(const unsigned short* __restrict__ rays,
                    const unsigned short* __restrict__ tris, int n_rays,
                    int n_tris, int warps_per_tile, int steps,
                    float* __restrict__ out, double* __restrict__ col_sum) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int gw = blockIdx.x * (kMmaThreads / 32) + threadIdx.x / 32;
  const int ray_tile = gw / warps_per_tile, w = gw % warps_per_tile;
  if (ray_tile * 16 >= n_rays) return;  // the whole warp
  const int n_tiles = n_tris / 8, first = 2 + w * kTiles;
  const int row[2] = {ray_tile * 16 + g, ray_tile * 16 + g + 8};
  // A fragment of the rays: a0 (row g, k 2t..), a1 (row g+8, k 2t..),
  // a2 (row g, k 2t+8..), a3 (row g+8, k 2t+8..)
  uint32_t a_ray[4], x[4];
  float ray[8], acc[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row[i & 1], k0 = 2 * t + 8 * (i >> 1);
    a_ray[i] = r < n_rays
        ? __ldg(reinterpret_cast<const uint32_t*>(rays + (size_t)r * kFeat + k0))
        : 0u;
    x[i] = a_ray[i];                                      // rays + 0
    ray[2 * i] = __uint_as_float(a_ray[i] << 16);
    ray[2 * i + 1] = __uint_as_float(a_ray[i] & 0xffff0000u);
    acc[2 * i] = acc[2 * i + 1] = 0.0f;
  }
  uint32_t b_chain[2][2], b[kTiles][2];
  load_b(tris, n_tris, 0, g, t, b_chain[0]);
  load_b(tris, n_tris, 1, g, t, b_chain[1]);
#pragma unroll
  for (int i = 0; i < kTiles; ++i) {
    b[i][0] = b[i][1] = 0u;
    if (first + i < n_tiles) load_b(tris, n_tris, first + i, g, t, b[i]);
  }
  double sum[2] = {0.0, 0.0};
  for (int k = 0; k < steps; ++k) {
    float c0[4] = {0.0f, 0.0f, 0.0f, 0.0f}, c1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    mma_bf16_16816(c0, x, b_chain[0]);
    mma_bf16_16816(c1, x, b_chain[1]);
    float part[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < kTiles; ++i) {
      if (first + i < n_tiles) {                          // warp-uniform
        float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        mma_bf16_16816(c, x, b[i]);
        part[0] = fmaf(c[0], kSumScale, part[0]);
        part[0] = fmaf(c[1], kSumScale, part[0]);
        part[1] = fmaf(c[2], kSumScale, part[1]);
        part[1] = fmaf(c[3], kSumScale, part[1]);
      }
    }
    if (w == 0) {
      part[0] = fmaf(c0[0], kSumScale, part[0]);
      part[0] = fmaf(c0[1], kSumScale, part[0]);
      part[0] = fmaf(c1[0], kSumScale, part[0]);
      part[0] = fmaf(c1[1], kSumScale, part[0]);
      part[1] = fmaf(c0[2], kSumScale, part[1]);
      part[1] = fmaf(c0[3], kSumScale, part[1]);
      part[1] = fmaf(c1[2], kSumScale, part[1]);
      part[1] = fmaf(c1[3], kSumScale, part[1]);
    }
    sum[0] += (double)part[0];
    sum[1] += (double)part[1];
    // acc = bf16(bf16(p) * 0.5); x = bf16(rays + acc): the accumulators of
    // tiles 0 and 1 become the next A fragment in place
    const float p[8] = {c0[0], c0[1], c0[2], c0[3], c1[0], c1[1], c1[2], c1[3]};
#pragma unroll
    for (int e = 0; e < 8; ++e)
      acc[e] = __bfloat162float(__float2bfloat16_rn(
          __bfloat162float(__float2bfloat16_rn(p[e])) * 0.5f));
#pragma unroll
    for (int i = 0; i < 4; ++i)
      x[i] = pack_bf16(ray[2 * i] + acc[2 * i], ray[2 * i + 1] + acc[2 * i + 1]);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    double v = sum[h];
    v += __shfl_xor_sync(kFull, v, 1);
    v += __shfl_xor_sync(kFull, v, 2);
    if (row[h] >= n_rays) continue;
    if (t == 0) atomicAdd(col_sum + row[h], v * 4096.0);
    if (w == 0) {
      float* o = out + (size_t)row[h] * kFeat + 2 * t;
      o[0] = acc[2 * h];
      o[1] = acc[2 * h + 1];
      o[8] = acc[4 + 2 * h];
      o[9] = acc[4 + 2 * h + 1];
    }
  }
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

cudaError_t launch_f32_tile(const float* rays, const float* tris, int n_rays,
                            int n_tris, int steps, float* out,
                            unsigned long long* sum_out,
                            cudaStream_t stream) {
  const int groups = (n_tris + kTileCols - 1) / kTileCols;
  int tx = 32;  // threads of a ray group: a power of two, 32..128
  while (tx < groups && tx < kTileThreads) tx *= 2;
  const int block_rays = kTileThreads / tx * kRays;
  const int blocks = (n_rays + block_rays - 1) / block_rays;
  const size_t smem = (size_t)kFeat * groups * sizeof(float4) +
                      2 * (size_t)block_rays * kFeat * sizeof(float);
  cudaError_t err = opt_in(mxu_leaf_f32_tile_kernel, smem);
  if (err != cudaSuccess) return err;
  mxu_leaf_f32_tile_kernel<<<blocks, kTileThreads, smem, stream>>>(
      rays, tris, n_rays, n_tris, steps, tx, out, sum_out);
  return cudaGetLastError();
}

template <int kTiles>
cudaError_t launch_mma(const unsigned short* rays, const unsigned short* tris,
                       int n_rays, int n_tris, int steps, float* out,
                       double* col_sum, cudaStream_t stream) {
  const int others = n_tris / 8 - 2;
  const int warps_per_tile = others > 0 ? (others + kTiles - 1) / kTiles : 1;
  const int warps = (n_rays + 15) / 16 * warps_per_tile;
  const int per_block = kMmaThreads / 32;
  mxu_leaf_mma_kernel<kTiles>
      <<<(warps + per_block - 1) / per_block, kMmaThreads, 0, stream>>>(
          rays, tris, n_rays, n_tris, warps_per_tile, steps, out, col_sum);
  return cudaGetLastError();
}

// bf16: 1 for bfloat16 rays and tris (the SIMT form), 0 for float32 (the
// register tile; `sum_out` zeroed).
extern "C" int rt2_probe_mxu_leaf_dense(const void* rays, const void* tris,
                                        int n_rays, int n_tris, int bf16,
                                        int steps, float* out,
                                        long long* sum_out, void* stream) {
  if (n_rays <= 0 || n_tris < kFeat || steps < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (!bf16)
    return (int)launch_f32_tile(
        static_cast<const float*>(rays), static_cast<const float*>(tris),
        n_rays, n_tris, steps, out,
        reinterpret_cast<unsigned long long*>(sum_out), st);
  const int rows_per_block = kLeafThreads / 32;
  const int blocks = (n_rays + rows_per_block - 1) / rows_per_block;
  const size_t x_bytes = (size_t)rows_per_block * kFeat * sizeof(float);
  size_t smem = (((size_t)kFeat * n_tris * 2 + 15) / 16) * 16 + x_bytes;
  cudaError_t err = opt_in(mxu_leaf_dense_kernel<__nv_bfloat16>, smem);
  if (err != cudaSuccess) return (int)err;
  mxu_leaf_dense_kernel<__nv_bfloat16><<<blocks, kLeafThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(rays),
      static_cast<const __nv_bfloat16*>(tris), n_rays, n_tris, steps, out,
      sum_out);
  return (int)cudaGetLastError();
}

// The tensor-core form: bfloat16 rays (n_rays, 16) and tris (16, n_tris),
// n_tris a multiple of 8; `col_sum` (n_rays float64) zeroed. A warp sums 2
// column tiles besides the chain's up to 256 columns and 4 beyond: the
// fastest of 1, 2, 4 and 8 at the probe's sizes, 128 and 512 columns
// (PERF.md section 6); the sizes between were not measured.
extern "C" int rt2_probe_mxu_leaf_dense_mma(const void* rays,
                                            const void* tris, int n_rays,
                                            int n_tris, int steps, float* out,
                                            double* col_sum, void* stream) {
  if (n_rays <= 0 || n_tris < kFeat || n_tris % 8 || steps < 0)
    return (int)cudaErrorInvalidValue;
  const unsigned short* r = static_cast<const unsigned short*>(rays);
  const unsigned short* t = static_cast<const unsigned short*>(tris);
  cudaStream_t st = (cudaStream_t)stream;
  if (n_tris <= 256)
    return (int)launch_mma<2>(r, t, n_rays, n_tris, steps, out, col_sum, st);
  return (int)launch_mma<4>(r, t, n_rays, n_tris, steps, out, col_sum, st);
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
