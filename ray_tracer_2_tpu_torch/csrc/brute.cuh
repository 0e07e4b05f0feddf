// Brute-force closest hit of one ray against every triangle of a small
// instance group: the per-ray loop shared by the standalone kernel
// (csrc/brute.cu) and the segment prepass of the megakernel
// (csrc/megakernel.cu).
//
// Port of the TPU kernel ray_tracer_2_tpu/kernels/pallas_brute.py
// (_kernel :32, pallas_call :94) and of its XLA twin
// ray_tracer_2_tpu/kernels/brute.py brute_force_intersect :39. Semantics:
// Möller–Trumbore with the edges and the geometric normal computed from
// the three vertices, a per-triangle backface cull (glass triangles are
// two-sided), hits beyond EPSILON only; the nearest hit wins and the
// lowest index wins a tie (a strict `<` in index order, which is what
// argmin within a chunk plus a strict `<` across chunks gives). The
// operations follow the plain PyTorch version
// (kernels/brute.py brute_force_intersect_plain, through
// kernels/intersect.py ray_triangle) one for one; compiled with
// --fmad=false, so both round alike.
//
// Table rows hold `stride` floats: v0 (3), v1 (3), v2 (3), the canonical
// material id, the cull flag (1 = cull backfaces), padding.
#pragma once

#include <cuda_runtime.h>

namespace rt2_brute {

constexpr float kInf = 1.7014118e38f;  // 2^127, the reference's INF
constexpr float kEpsilon = 1e-5f;      // ray_tracer.wgsl:131
constexpr float kEpsDet = 1e-8f;       // parallel-ray cut
constexpr int kStaged = 11;            // floats of a row the loop reads

struct Hit {
  float dst, u, v, det;
  int tri;  // index into the table, -1 = no hit
  int mat;  // canonical material id of the hit triangle
};

__device__ __forceinline__ void closest_hit(const float* tris, int stride,
                                            int n, const float o[3],
                                            const float d[3], Hit& h) {
  h.dst = kInf;
  h.u = h.v = h.det = 0.0f;
  h.tri = -1;
  h.mat = 0;
  for (int j = 0; j < n; ++j) {
    const float* t = tris + j * stride;
    float e1x = t[3] - t[0], e1y = t[4] - t[1], e1z = t[5] - t[2];
    float e2x = t[6] - t[0], e2y = t[7] - t[1], e2z = t[8] - t[2];
    float nx = e1y * e2z - e1z * e2y;
    float ny = e1z * e2x - e1x * e2z;
    float nz = e1x * e2y - e1y * e2x;
    float aox = o[0] - t[0], aoy = o[1] - t[1], aoz = o[2] - t[2];
    float daox = aoy * d[2] - aoz * d[1];
    float daoy = aoz * d[0] - aox * d[2];
    float daoz = aox * d[1] - aoy * d[0];
    float det = -((d[0] * nx + d[1] * ny) + d[2] * nz);
    bool keep = t[10] > 0.5f ? (det >= kEpsDet) : (fabsf(det) >= kEpsDet);
    if (!keep) continue;
    float inv = 1.0f / det;
    float dst = ((aox * nx + aoy * ny) + aoz * nz) * inv;
    float u = ((e2x * daox + e2y * daoy) + e2z * daoz) * inv;
    float v = -((e1x * daox + e1y * daoy) + e1z * daoz) * inv;
    float w = (1.0f - u) - v;
    if (dst > kEpsilon && u >= 0.0f && v >= 0.0f && w >= 0.0f &&
        dst < h.dst) {
      h.dst = dst;
      h.u = u;
      h.v = v;
      h.det = det;
      h.tri = j;
      h.mat = (int)t[9];
    }
  }
}

}  // namespace rt2_brute
