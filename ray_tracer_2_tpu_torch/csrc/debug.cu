// Debug modes 1-7 for one NVIDIA Hopper card (sm_90a): one unjittered
// primary ray a pixel, its closest hit, a colour per mode.
//
// The reference computes this in XLA (ray_tracer_2_tpu/kernels/trace.py:384
// debug_trace_pixels, through compute_hit :62), apart from its brute-force
// groups, which ran the TPU kernel ray_tracer_2_tpu/kernels/pallas_brute.py
// (pallas_call :94); here the brute-force groups run that kernel's
// counterpart, csrc/brute.cuh `closest_hit`, inside this kernel.
//
// The hit is the megakernel's segment hit, from its own device code
// (csrc/trace.cuh): the dense sphere prepass and the brute-force groups
// (`segment_prepass`), each wide-BVH instance through the row walk
// `traverse<false>` pruned at the best world distance so far, then the
// sphere BVH through `traverse<true>`; the mesh normal and UV as the
// megakernel shades them; mode 1's normal-map texel through `sample_quads`.
// Colours (kernels/trace.py debug_colors, ray_tracer.wgsl:502-573): 1 the
// normal as n / 2 + 1 / 2 or the normal map's texel where the material has
// one, 2 depth / scale, 3 the UV, 4 green past scale / 100 else grey of the
// depth (1-4 black on a miss), 5 child boxes tested / scale, 6 triangles
// tested / scale (red past 1), 7 both, others magenta. The per-ray counts
// are written beside the image: child boxes tested (the sphere BVH's
// included) and triangles tested (each brute-force group's count and the
// triangles of every triangle leaf visited).
//
// One thread a pixel, one launch a frame: a debug frame is one segment a
// pixel, so there is no lane loop to keep full. What bounds it: the same
// dependent row loads as the megakernel's first segment. Written to match
// the plain PyTorch version (kernels/trace.py debug_hit, debug_colors)
// operation for operation, compiled with --fmad=false.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "brute.cuh"

namespace {

#define RT2_TRACE_LEAF_TRIS
#include "trace.cuh"

constexpr int kDebugThreads = 128;
// Resident blocks a SM the forms are held to: 72 registers a thread. Left
// to itself ptxas gives them 64 and spills (the exact-sphere form 36 bytes
// of stores, and, with the slab test of csrc/trace.cuh as it is now, the
// fast-sphere form 12); at 72 none spills (PERF.md, section 6).
constexpr int kDebugMinBlocks = 7;

// The closest hit of the ray (o, d) as the megakernel finds a segment's
// (trace_segment up to its shade), the hit's normal and UV, and the ray's
// counts: child boxes in vis.boxes, leaf triangles in vis.tris, the
// brute-force groups' triangles in `tris`.
template <int kSph>
__device__ __forceinline__ void debug_hit(const Params& p, const float o[3],
                                          const float d[3], SegHit& h,
                                          float normal[3], float uv[2],
                                          Visits& vis, uint32_t& tris) {
  unsigned long long tests = 0;
  const float4* brute = reinterpret_cast<const float4*>(p.brute);
  segment_prepass<true, kSph>(p, p.spheres, p.inst, brute, o, d, h, normal,
                              tests);
  for (int i = 0; i < p.n_inst; ++i) {
    const float* in = p.inst + i * kInstCols;
    if (in[kInBrute] > 0.5f) {
      tris += (uint32_t)in[kInCount];
      continue;
    }
    float om[3], dm[3], wv[3];
    instance_ray(in, o, d, om, dm);
    apply3x3(in + kInM2w, dm, wv);
    float slack = 8e-6f * (1.0f + sqrtf(dot3(o, o)));
    float limit = (h.dst * 1.000004f + slack) / sqrtf(dot3(wv, wv));
    Hit th;
    traverse<false>(p.wide_rows, (int)in[kInRoot], om, dm, limit,
                    p.finite_boxes != 0, th, vis);
    if (th.tri >= 0)
      merge_instance(in, i, o, om, dm, th.dst, th.u, th.v, th.det, th.tri,
                     th.mat, h);
  }
  if constexpr (kSph == kSphBvh) {
    Hit sh;
    traverse<true>(p.wide_rows, sphere_root<kSph>(p), o, d, h.dst,
                   p.finite_boxes != 0, sh, vis);
    if (sh.tri != kSphSent) {
      const float* sp = p.spheres + (size_t)sh.tri * kSphStride;
      float c[4] = {__ldg(sp), __ldg(sp + 1), __ldg(sp + 2), __ldg(sp + 3)};
      float oc[3] = {o[0] - c[0], o[1] - c[1], o[2] - c[2]};
      float a_q = dot3(d, d);
      float b_q = 2.0f * dot3(oc, d);
      float disc = b_q * b_q - (4.0f * a_q) * (dot3(oc, oc) - c[3] * c[3]);
      float sq = sqrtf(nan_max(disc, 0.0f));
      bool inside = nan_max((-b_q - sq) / (2.0f * a_q), 0.0f) == 0.0f;
      sphere_hit(c, (int)__ldg(sp + 4), o, d, sh.dst, inside, h, normal);
    }
  }
  uv[0] = uv[1] = 0.0f;
  if (h.kind >= 0) {  // mesh normal through the hit instance's m2w, its UV
    const float* at = p.tri_attr + (size_t)(h.kind >> 2) * kRow +
                      (h.kind & 3) * 32;
    float wb = (1.0f - h.u) - h.v;
    float nm[3];
    for (int r = 0; r < 3; ++r)
      nm[r] = (__ldg(at + r) * wb + __ldg(at + 3 + r) * h.u) +
              __ldg(at + 6 + r) * h.v;
    normalize3(nm);
    float sg = sign_of(h.det);
    for (int r = 0; r < 3; ++r) nm[r] = nm[r] * sg;
    apply3x3(p.inst + h.flag * kInstCols + kInM2w, nm, normal);
    normalize3(normal);
    for (int r = 0; r < 2; ++r)
      uv[r] = (__ldg(at + 9 + r) * wb + __ldg(at + 11 + r) * h.u) +
              __ldg(at + 13 + r) * h.v;
  } else if (h.kind == -2) {
    sphere_uv(normal, uv);
  }
}

template <int kSph>
__global__ void __launch_bounds__(kDebugThreads, kDebugMinBlocks)
debug_kernel(Params p, TexParams tex, int mode, float scale, int* visits) {
  int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= p.total) return;
  // the camera ray, unjittered (trace.py camera_ray_basis)
  const float* sc = p.scal;
  const float* cam = sc + kScCam;
  int px = pix % p.width;
  int py = p.row_start + pix / p.width;
  float w1 = (float)max(p.width - 1, 1);
  float h1 = (float)max(p.height - 1, 1);
  float u0 = (float)px / w1, u1 = (float)py / h1;
  float lf0 = (u0 - 0.5f) * sc[kScView], lf1 = (u1 - 0.5f) * sc[kScView + 1];
  float o[3], d[3];
  for (int r = 0; r < 3; ++r) {
    float fp = ((lf0 * cam[4 * r] + lf1 * cam[4 * r + 1]) +
                sc[kScView + 2] * cam[4 * r + 2]) + cam[4 * r + 3];
    o[r] = cam[4 * r + 3];
    d[r] = fp - o[r];
  }
  normalize3(d);

  SegHit h;
  float normal[3], uv[2];
  Visits vis = {0u, 0u, 0u, 0u};
  uint32_t tris = 0u;
  debug_hit<kSph>(p, o, d, h, normal, uv, vis, tris);
  tris += vis.tris;

  bool hit = h.kind != -1;
  float c[4] = {1.0f, 0.0f, 1.0f, 1.0f};  // magenta
  if (mode == 1) {
    const float* m = p.mat_rows + (size_t)h.mat * 32;
    if (__ldg(m + 21) == kFlagTexture && __ldg(m + 23) != -1.0f) {
      sample_quads(tex, (int)__ldg(m + 23), uv, c);
    } else {
      for (int r = 0; r < 3; ++r) c[r] = normal[r] * 0.5f + 0.5f;
    }
    c[3] = 1.0f;
  } else if (mode == 2) {
    float g = h.dst / scale;
    c[0] = c[1] = c[2] = g;
    c[3] = 1.0f;
  } else if (mode == 3) {
    c[0] = uv[0];
    c[1] = uv[1];
    c[2] = 0.0f;
    c[3] = 1.0f;
  } else if (mode == 4) {
    bool past = h.dst > scale / 100.0f;
    c[0] = c[2] = past ? 0.0f : h.dst;
    c[1] = past ? 1.0f : h.dst;
    c[3] = 1.0f;
  } else if (mode >= 5 && mode <= 7) {
    float b = (float)vis.boxes / scale;
    float t = (float)tris / scale;
    float g = mode == 5 ? b : t;
    if (mode == 7) {
      c[0] = t;
      c[1] = 0.0f;
      c[2] = b;
    } else if (g > 1.0f) {
      c[0] = 1.0f;
      c[1] = c[2] = 0.0f;
    } else {
      c[0] = c[1] = c[2] = g;
    }
    c[3] = 1.0f;
  }
  if (mode >= 1 && mode <= 4 && !hit) c[0] = c[1] = c[2] = c[3] = 0.0f;
  float* out = p.out + (size_t)pix * 4;
  for (int r = 0; r < 4; ++r) out[r] = c[r];
  visits[2 * pix] = (int)vis.boxes;
  visits[2 * pix + 1] = (int)tris;
}

}  // namespace

// Launch on `stream`; allocates nothing and does not synchronise. The
// tables are the megakernel's, read from global memory: `spheres`,
// `scal`, `inst` as kernels/megakernel.py kernel_tables makes them (the
// fourth sphere column |c|^2 - r^2 for `spheres_mode` kSphFast; radii for
// kSphBvh, with `sphere_root` the sphere BVH's root row; `finite_boxes` as
// rt2_render_persistent takes it), `brute` the
// brute-force rows as stage_row makes them (kernels/brute.py
// stage_brute_rows), `texels` the atlas one int4 a texel and `tex_meta`
// its 64 slot rows. Renders the `rows` image rows from `row_start` of a
// `width` x `height` image: writes rows x width colours to `out` (4 floats
// a pixel) and counts to `visits` (2 ints a pixel: child boxes tested,
// triangles tested). `wide_rows`, `brute` and `texels` must be 16-byte
// aligned. Returns cudaGetLastError() (0 = launched).
extern "C" int rt2_render_debug(
    const float* wide_rows, const float* tri_attr, const float* mat_rows,
    const float* spheres, const float* scal, const float* inst,
    const float* brute, int n_spheres, int n_inst, int n_brute, int width,
    int height, int row_start, int rows, int spheres_mode, int sphere_root,
    int finite_boxes, const int* texels, int n_texels, const float* tex_meta,
    int debug_mode, float debug_scale, float* out, int* visits,
    void* stream) {
  if (n_spheres < 0 || n_inst < 0 || n_brute < 0 || width < 1 ||
      height < 1 || row_start < 0 || rows < 1 || row_start + rows > height ||
      n_texels < 64 ||
      (((uintptr_t)wide_rows | (uintptr_t)brute | (uintptr_t)texels) &
       15u) != 0u)
    return (int)cudaErrorInvalidValue;
  if (spheres_mode == kSphBvh ? (sphere_root < 0 || n_spheres < 1)
                              : n_spheres > kMaxSpheres)
    return (int)cudaErrorInvalidValue;
  Params p = {};
  p.wide_rows = wide_rows;
  p.tri_attr = tri_attr;
  p.mat_rows = mat_rows;
  p.spheres = spheres;
  p.scal = scal;
  p.inst = inst;
  p.brute = brute;
  p.out = out;
  p.sph = spheres_mode == kSphBvh ? sphere_root : n_spheres;
  p.n_inst = n_inst;
  p.n_brute = n_brute;
  p.width = width;
  p.height = height;
  p.row_start = row_start;
  p.total = rows * width;
  p.finite_boxes = finite_boxes;
  TexParams tex;
  tex.texels = reinterpret_cast<const int4*>(texels);
  tex.meta = tex_meta;
  tex.normal_maps = 0;
  int blocks = (p.total + kDebugThreads - 1) / kDebugThreads;
  cudaStream_t s = (cudaStream_t)stream;
  if (spheres_mode == kSphExact)
    debug_kernel<kSphExact><<<blocks, kDebugThreads, 0, s>>>(
        p, tex, debug_mode, debug_scale, visits);
  else if (spheres_mode == kSphFast)
    debug_kernel<kSphFast><<<blocks, kDebugThreads, 0, s>>>(
        p, tex, debug_mode, debug_scale, visits);
  else
    debug_kernel<kSphBvh><<<blocks, kDebugThreads, 0, s>>>(
        p, tex, debug_mode, debug_scale, visits);
  return (int)cudaGetLastError();
}
