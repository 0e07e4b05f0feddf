// Brute-force closest hit of rays against every triangle of a small
// instance group: the staged row and the per-pair test shared by the
// standalone kernel (csrc/brute.cu) and the segment prepass of the
// megakernel (csrc/megakernel.cu).
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
// What bounds the loop on this card is instruction throughput: without
// contraction every float operation is an instruction of its own, so the
// design removes instructions. (1) What depends on the triangle alone
// (both edges and their cross product, 15 of the 62 operations of a pair)
// is computed once when a row is staged (stage_row), with the same
// subtractions and products, so the bits are the plain version's. (2) A
// staged row is four 16-byte words, read with four shared-memory loads
// that every lane of a warp takes as one broadcast, not eleven scalar
// ones. (3) The only branch of a pair is the determinant cut, kept
// because it measured faster than carrying the cut as a predicate into
// the final compare (1.17 against 1.28 ms on 2,073,600 rays x 256
// triangles, H100; PERF.md section 6), although it executes more
// instructions; the update of the running best is five selects.
//
// No sign test ahead of the division is made. u >= 0 holds for u = -0.0,
// and a numerator of the opposite sign to det whose product with 1 / det
// underflows gives exactly that -0.0, so an exact sign early-out has to
// bound the magnitudes too (numerator at least 1e-30, det at most 1e30);
// written that way it gave the same records and measured slower (1.31
// ms): a lane that leaves early saves nothing while another lane of its
// warp goes on.
//
// Packed table rows (kernels/brute.py pack_brute_table) hold 16 floats:
// v0 (3), v1 (3), v2 (3), the canonical material id, the cull flag (1 =
// cull backfaces), padding. Staged rows hold 16 floats as four float4:
// (v0, mat), (e1, cull), (e2, 0), (n, 0).
#pragma once

#include <cuda_runtime.h>

namespace rt2_brute {

constexpr float kInf = 1.7014118e38f;  // 2^127, the reference's INF
constexpr float kEpsilon = 1e-5f;      // ray_tracer.wgsl:131
constexpr float kEpsDet = 1e-8f;       // parallel-ray cut
constexpr int kTableCols = 16;         // floats of a packed table row
constexpr int kRowWords = 4;           // float4 words of a staged row

struct Hit {
  float dst, u, v, det;
  int tri;  // index into the table, -1 = no hit
};

__device__ __forceinline__ void no_hit(Hit& h) {
  h.dst = kInf;
  h.u = h.v = h.det = 0.0f;
  h.tri = -1;
}

// Stage one packed table row (16-byte aligned) as the four words the loop
// reads: the edges and the normal as kernels/intersect.py ray_triangle
// computes them (v1 - v0, v2 - v0, their cross product).
__device__ __forceinline__ void stage_row(const float* __restrict__ packed,
                                          float4* __restrict__ row) {
  const float4* s = reinterpret_cast<const float4*>(packed);
  const float4 q0 = __ldg(s), q1 = __ldg(s + 1), q2 = __ldg(s + 2);
  const float v0x = q0.x, v0y = q0.y, v0z = q0.z;
  const float e1x = q0.w - v0x, e1y = q1.x - v0y, e1z = q1.y - v0z;
  const float e2x = q1.z - v0x, e2y = q1.w - v0y, e2z = q2.x - v0z;
  const float nx = e1y * e2z - e1z * e2y;
  const float ny = e1z * e2x - e1x * e2z;
  const float nz = e1x * e2y - e1y * e2x;
  row[0] = make_float4(v0x, v0y, v0z, q2.y);
  row[1] = make_float4(e1x, e1y, e1z, q2.z);
  row[2] = make_float4(e2x, e2y, e2z, 0.0f);
  row[3] = make_float4(nx, ny, nz, 0.0f);
}

// The material id a staged row carries.
__device__ __forceinline__ int row_material(const float4* row) {
  return (int)row[0].w;
}

// One ray against one staged row (already in registers): `h` becomes this
// pair's hit if it is one and strictly nearer. 47 float operations.
__device__ __forceinline__ void test_row(const float4& a, const float4& b,
                                         const float4& c, const float4& n,
                                         int j, const float o[3],
                                         const float d[3], Hit& h) {
  float aox = o[0] - a.x, aoy = o[1] - a.y, aoz = o[2] - a.z;
  float daox = aoy * d[2] - aoz * d[1];
  float daoy = aoz * d[0] - aox * d[2];
  float daoz = aox * d[1] - aoy * d[0];
  float det = -((d[0] * n.x + d[1] * n.y) + d[2] * n.z);
  bool keep = b.w > 0.5f ? (det >= kEpsDet) : (fabsf(det) >= kEpsDet);
  if (!keep) return;
  float inv = 1.0f / det;
  float dst = ((aox * n.x + aoy * n.y) + aoz * n.z) * inv;
  float u = ((c.x * daox + c.y * daoy) + c.z * daoz) * inv;
  float v = -((b.x * daox + b.y * daoy) + b.z * daoz) * inv;
  float w = (1.0f - u) - v;
  bool hit = (dst > kEpsilon) & (u >= 0.0f) & (v >= 0.0f) & (w >= 0.0f) &
             (dst < h.dst);
  h.dst = hit ? dst : h.dst;
  h.u = hit ? u : h.u;
  h.v = hit ? v : h.v;
  h.det = hit ? det : h.det;
  h.tri = hit ? j : h.tri;
}

// Closest hit of one ray over `n` staged rows (the megakernel's prepass:
// one ray per lane).
__device__ __forceinline__ void closest_hit(const float4* rows, int n,
                                            const float o[3],
                                            const float d[3], Hit& h) {
  no_hit(h);
  for (int j = 0; j < n; ++j) {
    const float4* r = rows + j * kRowWords;
    test_row(r[0], r[1], r[2], r[3], j, o, d, h);
  }
}

}  // namespace rt2_brute
