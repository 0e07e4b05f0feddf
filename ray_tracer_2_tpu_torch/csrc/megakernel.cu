// Persistent wide-BVH path tracer for one NVIDIA Hopper card (sm_90a).
//
// Replaces the TPU kernel ray_tracer_2_tpu/kernels/pallas_boundary.py
// (make_fused_boundary -> boundary, pallas_call at :775) TOGETHER with the
// XLA traversal loop it sat beside (ray_tracer_2_tpu/kernels/megakernel.py
// traversal_step :389, wide_eval :337, unpack_child_aabbs :304,
// slab_blocked :318, _advance_impl :628) and the XLA boundary's
// segment_prepass :1088 and resolve_and_shade :739, whose brute-force
// groups ran ray_tracer_2_tpu/kernels/pallas_brute.py (its loop here is
// csrc/brute.cuh, shared with csrc/brute.cu). On the TPU the lanes ran in
// lockstep and claimed pixels through cumsum ranks, a completion log and
// an end-of-frame sort; here each lane writes its own pixel, so no log or
// sort exists, and the claim is one ballot and one atomic per warp
// (csrc/claim.cuh).
//
// What bounds it on this card: arithmetic, about 33 operations for each
// child box of a visited wide row and 47 for each triangle of a visited
// leaf; its tables (7.3 MB of wide rows and 10.2 MB of attribute rows for
// 80,000 triangles) fit in L2. What keeps it from that bound: the
// dependent loads of the traversal (each row's address comes from the
// previous row) and divergence, since paths end at different bounces. The
// design answers the second: the grid is as many blocks as can be resident
// (csrc/claim.cuh persistent_blocks), each lane holds one path and traces
// one segment per turn of the warp's loop, and a lane whose pixel is done
// claims the next, so warps stay full until the frame is handed out. The
// per-scene tables that every segment reads whole (the dense spheres, the
// instance table and the brute-force triangles as hoisted rows of 64
// bytes, csrc/brute.cuh) are staged in shared memory once per block when
// together they fit 36 KB, and read from global memory (through L1)
// otherwise, the triangle rows then staged once per scene by the host;
// child boxes and staged triangle rows are read as 16-byte loads. From 64
// dense spheres the prepass takes the shared-term formula (one division a
// ray, csrc/spheres.cu's); a scene with a sphere BVH has no dense prepass
// and walks that tree last, with the same row walk. The kernel counts its
// own work (interior-row, leaf and child-box visits, lane-loop turns and
// active lanes), and the plain version counts the same visits.
// It is written to match the plain PyTorch version
// (kernels/megakernel.py render_plain) operation for operation: compiled
// with --fmad=false, every sum is evaluated in the order the plain version
// writes it, and min/max propagate NaN as torch.minimum/maximum do.
//
// Semantics per pixel (reference kernels/megakernel.py render_persistent,
// XLA boundary; kernels/megakernel.py ineligibility gives the class):
//   seed = pixel_id + |frames| * 719393
//   for each of rpp samples: camera ray, then up to bounces+1 segments of
//   {dense sphere prepass; each brute-force group in instance order, its
//   model-space hit merged by world distance; each wide-BVH instance in
//   order, its traversal pruned at the best world distance so far; the
//   sphere BVH, where the scene has one instead of the dense prepass, in
//   world space, pruned likewise; shade (glass or diffuse/specular) with
//   the hit instance's transform}; every merge is a strict `<`, so an equal
//   distance keeps the earlier hit, except that a sphere of the sphere BVH
//   takes an equal distance (it would have been tested first), the lowest
//   sphere id among equal spheres.
//   out[pixel] = sum / rpp; every started segment counts once.
// With next-event estimation (the NEE forms, render_general_nee; reference
// resolve_and_shade :888-1082 and the boundary :1765-1790): each diffuse
// vertex with room in the bounce budget samples one light of the scene's
// table and adds its contribution if a shadow ray finds it unoccluded,
// either at once against the prepass (mode kNeeInline, scenes without a
// traversal phase) or after a shadow segment of its own (kNeeSegments),
// which counts as a segment and keeps the bounce; the next hit then adds
// no emission.
// With textures (the textured forms, render_general_tex; reference
// resolve_and_shade :796-884, which its fused boundary refuses,
// pallas_boundary.py:84-86,102): a textured material's diffuse colour is
// the bilinear sample of its slot of the texel atlas at the hit's UV (a
// mesh's interpolated, a sphere's from its normal), wherever the colour is
// read, the light sample's contribution included; with normal maps, a mesh
// hit whose material has a normal map shades with the sampled normal
// rotated out of the triangle's tangent frame. The sample is the
// reference's explicit wrap addressing and blend in float32 (sample_quads),
// not a texture unit's fixed-point filter.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "brute.cuh"
#include "claim.cuh"

namespace {

constexpr float kInf = 1.7014118e38f;  // 2^127, the reference's INF
constexpr int kRow = 128;              // floats per wide / attr row
constexpr int kMaxStack = 16;          // resume-stack capacity (>= depth+2)
constexpr int kMaxSpheres = 2047;      // dense prepass capacity
constexpr int kSphSent = 0x3FFFFFFF;   // sphere-BVH id of "no sphere yet"
constexpr int kArity = 32;             // children per wide row
constexpr int kThreads = 128;

// wide-row columns (ray_tracer_2_tpu/accel/wide.py, accel/packed.py)
constexpr int kColMatCull = 0;
constexpr int kColBase = 12;
constexpr int kColK = 13;
constexpr int kColCount = 15;
constexpr int kColFirst = 16;
constexpr int kColAabb = 16;
constexpr int kColGeo = 17;
constexpr int kColSphId = 0;  // sphere leaf rows: the 8 original ids

// scal layout: cam[:3,:4] row-major, view_params, defocus, diverge
constexpr int kScCam = 0;
constexpr int kScView = 12;
constexpr int kScDefocus = 15;
constexpr int kScDiverge = 16;
constexpr int kScal = 17;
// sphere table rows: cx cy cz radius mat; where the dense prepass takes the
// shared-term formula (kSphFast) the fourth is |c|^2 - r^2 instead
constexpr int kSphStride = 5;
// how a scene's spheres are tested (kernels/megakernel.py kernel_tables)
constexpr int kSphExact = 0;  // dense, the reference-order quadratic
constexpr int kSphFast = 1;   // dense, shared terms (>= 64 spheres)
constexpr int kSphBvh = 2;    // the sphere BVH, after the instances
// instance table rows (kernels/megakernel.py kernel_tables): w2m[:3,:4],
// m2w[:3,:4], root row, first triangle, triangle count, material-id delta,
// brute-force flag, first row in the staged brute table
constexpr int kInstCols = 32;
constexpr int kInW2m = 0;
constexpr int kInM2w = 12;
constexpr int kInRoot = 24;
constexpr int kInTriOff = 25;
constexpr int kInCount = 26;
constexpr int kInDelta = 27;
constexpr int kInBrute = 28;
constexpr int kInSlot = 29;
constexpr int kBruteCols = 16;  // packed brute table (kernels/brute.py)
// instance, brute and dense sphere tables share the block's dynamic shared
// memory while together they fit kDynSmemBytes (kernels/megakernel.py
// SMEM_BYTES); a scene past it is read from global memory. What shared
// memory a block takes, the SM cannot give to other blocks: of the 7
// resident blocks the general forms are held to, 6 fit at 36 KB of tables
// (with the 1 KB the system keeps per block, 6 x 37.1 KB of the SM's 228
// KB), 5 at 39 KB, 3 at 64 KB. Measured
// (PERF.md, section 6): staged tables are 1-12% faster than global ones up
// to 32 KB, tie at 39 KB and are 19% and 36% slower at 48 and 64 KB.
constexpr int kDynSmemBytes = 36 * 1024;
constexpr float kFlagGlass = 1.0f;  // material flag of glass

// What the kernel counts, accumulated across launches in int64 words
// (kernels/megakernel.py COUNTS): closest-hit calls of the brute-force
// prepass (one per segment and brute-force group, and per inline shadow
// test and group), launches that made any, interior wide-row visits, leaf
// visits, child boxes tested, turns of a warp's lane loop, lanes holding a
// path summed over those turns, and shadow rays of next-event estimation
// (inline tests and shadow segments; only the NEE forms add to it).
constexpr int kCntBruteCalls = 0;
constexpr int kCntBruteLaunches = 1;
constexpr int kCntRows = 2;
constexpr int kCntLeaves = 3;
constexpr int kCntBoxes = 4;
constexpr int kCntTurns = 5;
constexpr int kCntActive = 6;
constexpr int kCntShadowRays = 7;
constexpr int kCounts = 8;

// Next-event estimation (kernels/megakernel.py nee_mode, light_tables;
// reference resolve_and_shade :888-1082). Light rows: kind (1 sphere), v0
// (a sphere: centre), v1 (a sphere: radius in v1.x), v2, the unit normal,
// radiance.
constexpr int kLightCols = 16;
constexpr int kMaxLights = 64;   // render_scene.py MAX_NEE_LIGHTS
constexpr int kNeeInline = 1;    // the shadow ray tested in the same turn
constexpr int kNeeSegments = 2;  // the shadow ray traced as its own segment
// a lane's NEE bits: its last vertex sampled a light (its next hit adds no
// emission), it is tracing a shadow segment, the path goes on after it
constexpr int kNeeSup = 1;
constexpr int kNeeShadow = 2;
constexpr int kNeeGoesOn = 4;

// Textures (kernels/texture.py, kernels/megakernel.py kernel_tables): the
// texel atlas as one int4 per texel, the reference's quad row unpacked
// (the texel's word, its wrapped x, y and xy neighbours'; a word is R | G
// << 8 | B << 16 | A << 24), and 64 slot rows of offset, height, width, 0.
constexpr float kFlagTexture = 2.0f;  // material flag of a textured one
constexpr float kInv255 = 0.003921569f;  // float32(1/255): see sample_quads
constexpr float kPi = 3.1415926f;         // the reference's pi, not M_PI
constexpr float kInvTwoPi = 0.15915495f;  // float32(1 / float32(2 kPi))
constexpr float kInvPi = 0.3183099f;      // float32(1 / kPi)

struct Params {
  const float* wide_rows;
  const float* tri_attr;
  const float* mat_rows;
  const float* spheres;
  const float* scal;
  const float* inst;
  // the packed brute-force rows, which each block stages; where the tables
  // are read from global memory, the rows the host staged instead
  const float* brute;
  float* out;
  // per launch, zeroed by the wrapper (csrc/claim.cuh kScratch*): segments,
  // the pixel cursor, "this launch ran the brute-force prepass"
  unsigned long long* scratch;
  unsigned long long* counts;  // kCounts words, accumulated
  // sph: the number of dense spheres or, in the sphere-BVH forms (kSphBvh),
  // which run no loop over the spheres, the BVH's root row in wide_rows.
  // Read it through dense_spheres<kSph>() or sphere_root<kSph>() only: each
  // compiles in the forms where the word has that meaning and in no other.
  // (A field more in this struct, even one its form never reads, cost the
  // main path 4%: PERF.md, section 6.)
  int sph, n_inst, n_brute, width, height, row_start, total;
  int bounces, rpp, skybox, antialias;
  uint32_t frame_seed;  // (|frames| * 719393) mod 2^32
};

// What only the NEE forms take, as a kernel parameter of its own: Params
// stays the other forms' (see there).
struct NeeParams {
  const float* lights;  // n_lights rows of kLightCols floats
  const float* cdf;     // the area shares summed, n_lights floats
  int n_lights;
  int mode;             // kNeeInline or kNeeSegments, launch-uniform
  float c_tri;          // total area / (2 pi), float32
  float c_area;         // total area, float32
};

template <int kSph>
__device__ __forceinline__ int dense_spheres(const Params& p) {
  static_assert(kSph != kSphBvh, "a sphere-BVH form has no dense spheres");
  return p.sph;
}
template <int kSph>
__device__ __forceinline__ int sphere_root(const Params& p) {
  static_assert(kSph == kSphBvh, "only a sphere-BVH form has a sphere root");
  return p.sph;
}

// What only the textured forms take, as a kernel parameter of its own
// (Params stays the other forms').
struct TexParams {
  const int4* texels;  // one per texel of the atlas
  const float* meta;   // 64 slot rows: offset, height, width, 0
  int normal_maps;     // 1: mesh hits take their material's normal map
};

// Visits of one segment's traversals (folded into 64-bit sums per lane)
struct Visits {
  uint32_t rows, leaves, boxes;
};

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}
__device__ __forceinline__ float clamp01(float t) {
  return nan_min(nan_max(t, 0.0f), 1.0f);
}
__device__ __forceinline__ float clamp_pm1(float t) {
  return nan_min(nan_max(t, -1.0f), 1.0f);
}
// jnp.sign: -1, +-0 or 1; NaN stays NaN
__device__ __forceinline__ float sign_of(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : x);
}

// ---- RNG (ray_tracer_2_tpu/rng.py; ray_tracer.wgsl:164-206) -------------
__device__ __forceinline__ uint32_t next_u32(uint32_t& seed) {
  seed = seed * 747796405u + 2891336453u;
  uint32_t word = ((seed >> ((seed >> 28u) + 4u)) ^ seed) * 277803737u;
  return (word >> 22u) ^ word;
}
__device__ __forceinline__ float rand01(uint32_t& seed) {
  return __uint2float_rn(next_u32(seed)) / 4294967295.0f;  // = 2^32 in f32
}
__device__ __forceinline__ float rand_normal(uint32_t& seed) {
  float u1 = rand01(seed);
  float u2 = rand01(seed);
  float theta = 6.2831852f * u1;
  float rho = sqrtf(-2.0f * logf(fmaxf(u2, 2.33e-10f)));
  return rho * cosf(theta);
}
__device__ __forceinline__ void rand_direction(uint32_t& seed, float d[3]) {
  float x = rand_normal(seed);
  float y = rand_normal(seed);
  float z = rand_normal(seed);
  float len = sqrtf((x * x + y * y) + z * z);
  d[0] = x / len; d[1] = y / len; d[2] = z / len;
}
__device__ __forceinline__ void rand_hemisphere(const float n[3],
                                                uint32_t& seed, float d[3]) {
  rand_direction(seed, d);
  float s = (n[0] * d[0] + n[1] * d[1]) + n[2] * d[2];
  float f = s >= 0.0f ? 1.0f : -1.0f;
  d[0] = f * d[0]; d[1] = f * d[1]; d[2] = f * d[2];
}
__device__ __forceinline__ void rand_disk(uint32_t& seed, float& a,
                                          float& b) {
  float u1 = rand01(seed);
  float angle = (u1 * 2.0f) * 3.1415926f;
  float r2 = rand01(seed);
  float s = sqrtf(r2);
  a = cosf(angle) * s;
  b = sinf(angle) * s;
}

__device__ __forceinline__ float dot3(const float a[3], const float b[3]) {
  return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2];
}
// jnp.cross
__device__ __forceinline__ void cross3(const float a[3], const float b[3],
                                       float out[3]) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}
__device__ __forceinline__ void normalize3(float v[3]) {
  float len = sqrtf(dot3(v, v));
  v[0] = v[0] / len; v[1] = v[1] / len; v[2] = v[2] / len;
}
// rows r of a row-major [3][4] affine block: (m r0 * x + m r1 * y) + m r2 * z
__device__ __forceinline__ void apply3x3(const float* m, const float v[3],
                                         float out[3]) {
  for (int r = 0; r < 3; ++r)
    out[r] = (m[4 * r] * v[0] + m[4 * r + 1] * v[1]) + m[4 * r + 2] * v[2];
}
// the same plus the translation column: a point through the affine block
__device__ __forceinline__ void apply_point(const float* m, const float v[3],
                                            float out[3]) {
  apply3x3(m, v, out);
  for (int r = 0; r < 3; ++r) out[r] = out[r] + m[4 * r + 3];
}

// f16 bit pattern -> f32 by integer rebias (megakernel.py f16_bits_to_f32)
__device__ __forceinline__ float f16_bits(uint32_t b) {
  uint32_t sign = (b & 0x8000u) << 16;
  uint32_t mag = (b & 0x7FFFu) << 13;
  return __uint_as_float(sign | mag) * __uint_as_float(0x77800000u);
}

// One child box (f16 pairs lo | hi << 16 per axis) against the ray, folded
// into the row's hit mask, nearest child and second-least entry distance.
__device__ __forceinline__ void child_eval(uint32_t ux, uint32_t uy,
                                           uint32_t uz, int c,
                                           const float om[3],
                                           const float inv[3], float limit,
                                           uint32_t& mask, int& c_min,
                                           float& m1, float& m2) {
  float t1x = (f16_bits(ux & 0xFFFFu) - om[0]) * inv[0];
  float t2x = (f16_bits(ux >> 16) - om[0]) * inv[0];
  float t1y = (f16_bits(uy & 0xFFFFu) - om[1]) * inv[1];
  float t2y = (f16_bits(uy >> 16) - om[1]) * inv[1];
  float t1z = (f16_bits(uz & 0xFFFFu) - om[2]) * inv[2];
  float t2z = (f16_bits(uz >> 16) - om[2]) * inv[2];
  float tn = nan_max(nan_max(nan_min(t1x, t2x), nan_min(t1y, t2y)),
                     nan_min(t1z, t2z));
  float tf = nan_min(nan_min(nan_max(t1x, t2x), nan_max(t1y, t2y)),
                     nan_max(t1z, t2z));
  bool hit = (tf >= tn) && (tn < limit) && (tf > 0.0f);
  float dn = hit ? tn : kInf;
  if (hit) mask |= 1u << c;
  if (dn < m1) {
    m2 = m1;
    m1 = dn;
    c_min = c;
  } else {
    m2 = nan_min(m2, dn);
  }
}

// One wide row against the ray: hit mask over its k children, the nearest
// hit child (first index on ties) and the least entry distance over the
// other hit children (megakernel.py wide_eval / slab_blocked). The child
// boxes (x, y and z blocks of 32 words, 64 bytes into the 512-byte row)
// are read four children at a time as 16-byte loads; the children are
// still tested one by one in index order. Returns the children tested.
__device__ __forceinline__ int wide_eval(const float* row, const float om[3],
                                         const float inv[3], float limit,
                                         uint32_t& mask, int& c_min,
                                         float& dn2) {
  int k = min((int)__ldg(row + kColK), kArity);
  mask = 0u;
  float m1 = kInf, m2 = kInf;
  c_min = 0;
  const float4* box = reinterpret_cast<const float4*>(row + kColAabb);
  for (int g = 0; 4 * g < k; ++g) {
    float4 bx = __ldg(box + g);
    float4 by = __ldg(box + kArity / 4 + g);
    float4 bz = __ldg(box + kArity / 2 + g);
    int c = 4 * g;
    child_eval(__float_as_uint(bx.x), __float_as_uint(by.x),
               __float_as_uint(bz.x), c, om, inv, limit, mask, c_min, m1, m2);
    if (c + 1 < k)
      child_eval(__float_as_uint(bx.y), __float_as_uint(by.y),
                 __float_as_uint(bz.y), c + 1, om, inv, limit, mask, c_min,
                 m1, m2);
    if (c + 2 < k)
      child_eval(__float_as_uint(bx.z), __float_as_uint(by.z),
                 __float_as_uint(bz.z), c + 2, om, inv, limit, mask, c_min,
                 m1, m2);
    if (c + 3 < k)
      child_eval(__float_as_uint(bx.w), __float_as_uint(by.w),
                 __float_as_uint(bz.w), c + 3, om, inv, limit, mask, c_min,
                 m1, m2);
  }
  dn2 = m2;
  return k > 0 ? k : 0;
}

struct Hit {
  float dst, u, v, det;
  int tri, mat;
};

// Closest hit of the model-space ray in the instance's wide BVH, pruned at
// `limit` (megakernel.py wide_enter + traversal_step): enter the nearest hit
// child, push the other hits as (base, mask, least entry distance), pop the
// deepest entry still closer than the best hit, lowest child index first.
// With kSpheres the tree is the sphere BVH and the ray the world-space one:
// a leaf holds 8 spheres (megakernel.py traversal_step :481-521), h.tri is
// the winning sphere's id (kSphSent: none) and a sphere wins over the hit
// so far in (distance, id) order.
template <bool kSpheres>
__device__ void traverse(const float* __restrict__ wide_rows, int root,
                         const float om[3], const float dm[3], float limit,
                         Hit& h, Visits& vis) {
  float inv[3] = {1.0f / dm[0], 1.0f / dm[1], 1.0f / dm[2]};
  uint32_t sb[kMaxStack], sm[kMaxStack];
  float sd[kMaxStack];
  int sp = 0;
  h.dst = limit;
  h.tri = kSpheres ? kSphSent : -1;
  h.u = h.v = h.det = 0.0f;
  h.mat = 0;
  int cur = root;
  bool root_visit = true;
  while (cur >= 0) {
    const float* row = wide_rows + (size_t)cur * kRow;
    bool finished;
    if (!root_visit && __ldg(row + kColCount) > 0.5f) {
      ++vis.leaves;
      const float* g = row + kColGeo;
      if constexpr (kSpheres) {
        // leaf: 8 spheres, blocked cx cy cz r^2; an empty slot has
        // r^2 = -1 and cannot hit. The dense test's arithmetic.
        float a_q = (dm[0] * dm[0] + dm[1] * dm[1]) + dm[2] * dm[2];
        for (int j = 0; j < 8; ++j) {
          float ocx = om[0] - __ldg(g + j), ocy = om[1] - __ldg(g + 8 + j),
                ocz = om[2] - __ldg(g + 16 + j);
          float b_q = 2.0f * ((ocx * dm[0] + ocy * dm[1]) + ocz * dm[2]);
          float c_q = ((ocx * ocx + ocy * ocy) + ocz * ocz) -
                      __ldg(g + 24 + j);
          float disc = b_q * b_q - (4.0f * a_q) * c_q;
          float sq = sqrtf(nan_max(disc, 0.0f));
          float dn = nan_max((-b_q - sq) / (2.0f * a_q), 0.0f);
          float df = (-b_q + sq) / (2.0f * a_q);
          float dst = dn == 0.0f ? df : dn;
          float sid = __ldg(row + kColSphId + j);
          if (disc >= 0.0f && df >= 0.001f &&
              (dst < h.dst || (dst == h.dst && sid < (float)h.tri))) {
            h.dst = dst;
            h.tri = (int)sid;
          }
        }
      } else {
        // leaf: 8 triangles, blocked geometry with precomputed edges/normal
        int first = (int)__ldg(row + kColFirst);
        for (int j = 0; j < 8; ++j) {
          float v0x = __ldg(g + j), v0y = __ldg(g + 8 + j),
                v0z = __ldg(g + 16 + j);
          float e1x = __ldg(g + 24 + j), e1y = __ldg(g + 32 + j),
                e1z = __ldg(g + 40 + j);
          float e2x = __ldg(g + 48 + j), e2y = __ldg(g + 56 + j),
                e2z = __ldg(g + 64 + j);
          float nx = __ldg(g + 72 + j), ny = __ldg(g + 80 + j),
                nz = __ldg(g + 88 + j);
          float det = -((dm[0] * nx + dm[1] * ny) + dm[2] * nz);
          int mc = (int)__ldg(row + kColMatCull + j);
          bool cull = (mc & 1) == 1;
          bool keep = cull ? (det >= 1e-8f) : (fabsf(det) >= 1e-8f);
          if (!keep) continue;
          float inv_det = 1.0f / det;
          float aox = om[0] - v0x, aoy = om[1] - v0y, aoz = om[2] - v0z;
          float daox = aoy * dm[2] - aoz * dm[1];
          float daoy = aoz * dm[0] - aox * dm[2];
          float daoz = aox * dm[1] - aoy * dm[0];
          float dst = ((aox * nx + aoy * ny) + aoz * nz) * inv_det;
          float u = ((e2x * daox + e2y * daoy) + e2z * daoz) * inv_det;
          float v = -((e1x * daox + e1y * daoy) + e1z * daoz) * inv_det;
          float w = (1.0f - u) - v;
          if (dst > 1e-5f && u >= 0.0f && v >= 0.0f && w >= 0.0f &&
              dst < h.dst) {
            h.dst = dst;
            h.u = u;
            h.v = v;
            h.det = det;
            h.tri = first + j;
            h.mat = mc >> 1;
          }
        }
      }
      finished = true;
    } else {
      uint32_t mask;
      int c_min;
      float dn2;
      ++vis.rows;
      vis.boxes += wide_eval(row, om, inv, h.dst, mask, c_min, dn2);
      int base = (int)__ldg(row + kColBase);
      if (mask != 0u) {
        uint32_t rem = mask & ~(1u << c_min);
        if (rem != 0u && sp < kMaxStack) {
          sb[sp] = (uint32_t)base;
          sm[sp] = rem;
          sd[sp] = dn2;
          ++sp;
        }
        cur = base + c_min;
        finished = false;
      } else {
        finished = true;
      }
    }
    if (finished) {
      if (root_visit) {  // the whole instance missed: nothing was pushed
        cur = -1;
      } else {
        int pstar = -1;
        for (int j = sp - 1; j >= 0; --j) {
          if (sd[j] < h.dst) {
            pstar = j;
            break;
          }
        }
        if (pstar < 0) {
          cur = -1;
          sp = 0;
        } else {
          uint32_t m = sm[pstar];
          uint32_t prem = m & (m - 1u);
          cur = (int)sb[pstar] + (__ffs((int)m) - 1);
          if (prem != 0u) {
            sm[pstar] = prem;
            sp = pstar + 1;
          } else {
            sp = pstar;
          }
        }
      }
    }
    root_visit = false;
  }
}

// Schlick (ray_tracer.wgsl:208-212); (1 - cos)^5 as x4 * x, x4 = (x x)(x x)
__device__ __forceinline__ float reflectance(float cos_t, float ior) {
  float r0 = (1.0f - ior) / (1.0f + ior);
  r0 = r0 * r0;
  float x = 1.0f - cos_t;
  float x2 = x * x;
  float x4 = x2 * x2;
  return r0 + (1.0f - r0) * (x4 * x);
}

__device__ __forceinline__ float smoothstep(float e0, float e1, float x) {
  float t = clamp01((x - e0) / (e1 - e0));
  return t * t * (3.0f - 2.0f * t);
}

// environment_light (ray_tracer.wgsl:214-221)
__device__ __forceinline__ void environment_light(const float d[3],
                                                  float out[4]) {
  const float hz[4] = {1.0f, 1.0f, 1.0f, 0.0f};
  const float zn[4] = {0.0788092f, 0.36480793f, 0.7264151f, 0.0f};
  const float gr[4] = {0.35f, 0.3f, 0.35f, 0.0f};
  float sky_t = powf(smoothstep(0.0f, 0.4f, d[1]), 0.35f);
  float g2s = smoothstep(-0.01f, 0.0f, d[1]);
  float cs = (d[0] * 0.1f + d[1] * 1.0f) + d[2] * 0.1f;
  float sun = powf(nan_max(cs, 0.0f), 500.0f) * 0.1f;
  float sun_on = g2s >= 1.0f ? sun : sun * 0.0f;
  for (int c = 0; c < 4; ++c) {
    float sky = hz[c] + (zn[c] - hz[c]) * sky_t;
    out[c] = (gr[c] + (sky - gr[c]) * g2s) + sun_on;
  }
}

// A segment's nearest hit so far: kind -1 none, -2 sphere, >= 0 triangle
// id; flag is 1 for a sphere the ray starts inside, the instance id for a
// triangle.
struct SegHit {
  float dst, u, v, det;
  float point[3];
  int kind, mat, flag;
};

// Fold an instance's model-space hit into the segment by world distance
// (megakernel.py segment_prepass :1177-1191, _advance_impl :646-666).
__device__ __forceinline__ void merge_instance(
    const float* in, int i, const float o[3], const float om[3],
    const float dm[3], float dst, float u, float v, float det, int tri,
    int mat, SegHit& s) {
  float lh[3], wh[3], dv[3];
  for (int r = 0; r < 3; ++r) lh[r] = om[r] + dm[r] * dst;
  apply_point(in + kInM2w, lh, wh);
  for (int r = 0; r < 3; ++r) dv[r] = wh[r] - o[r];
  float wd = sqrtf(dot3(dv, dv));
  if (wd < s.dst) {
    s.dst = wd;
    s.kind = tri;
    s.mat = mat + (int)in[kInDelta];
    s.flag = i;
    s.u = u;
    s.v = v;
    s.det = det;
    for (int r = 0; r < 3; ++r) s.point[r] = wh[r];
  }
}

// The model-space ray of an instance: origin through w2m, direction
// through its linear part, normalised.
__device__ __forceinline__ void instance_ray(const float* in,
                                             const float o[3],
                                             const float d[3], float om[3],
                                             float dm[3]) {
  apply_point(in + kInW2m, o, om);
  apply3x3(in + kInW2m, d, dm);
  normalize3(dm);
}

// One lane's path: the pixel it renders (-1: none) in the row window,
// samples started, the pixel's seed and sum, and the current sample's ray,
// transmission, incoming light and bounce.
struct Path {
  float o[3], d[3], trans[4], inc[4], acc[4];
  uint32_t seed;
  int pix, sample, bounce;
};
// ... and in the NEE forms also its NEE bits (kNee*), while a shadow
// segment is traced the path's next ray, the light's contribution if the
// light is unoccluded and the distance to it, and the lane's shadow rays
struct NeePath : Path {
  float so[3], sd[3], sc[3], st;
  int bits;
  unsigned long long shadows;
};

// Start the lane's next sample: the camera ray (megakernel.py camera_ray;
// ray_tracer.wgsl:473-500), drawn from the pixel's seed.
__device__ __forceinline__ void start_sample(const Params& p,
                                             const float* sc, Path& q) {
  const float* cam = sc + kScCam;
  int px = q.pix % p.width;
  int py = p.row_start + q.pix / p.width;
  float w1 = (float)max(p.width - 1, 1);
  float h1 = (float)max(p.height - 1, 1);
  float inv_w = 1.0f / (float)p.width;
  float vp0 = sc[kScView], vp1 = sc[kScView + 1], vp2 = sc[kScView + 2];
  float u0 = (float)px / w1, u1 = (float)py / h1;
  float lf0 = (u0 - 0.5f) * vp0, lf1 = (u1 - 0.5f) * vp1;
  float fp[3];
  for (int r = 0; r < 3; ++r)
    fp[r] = ((lf0 * cam[4 * r] + lf1 * cam[4 * r + 1]) +
             vp2 * cam[4 * r + 2]) + cam[4 * r + 3];
  if (p.antialias) {
    float ju = rand01(q.seed);
    float jv = rand01(q.seed);
    float du = ((ju - 0.5f) * vp0) / w1;
    float dv = ((jv - 0.5f) * vp1) / h1;
    for (int r = 0; r < 3; ++r)
      fp[r] = (fp[r] + cam[4 * r] * du) + cam[4 * r + 1] * dv;
  }
  float a, b;
  rand_disk(q.seed, a, b);
  float dj0 = (a * sc[kScDefocus]) * inv_w;
  float dj1 = (b * sc[kScDefocus]) * inv_w;
  for (int r = 0; r < 3; ++r)
    q.o[r] = (cam[4 * r + 3] + cam[4 * r] * dj0) + cam[4 * r + 1] * dj1;
  rand_disk(q.seed, a, b);
  float vj0 = (a * sc[kScDiverge]) * inv_w;
  float vj1 = (b * sc[kScDiverge]) * inv_w;
  for (int r = 0; r < 3; ++r)
    q.d[r] = ((fp[r] + cam[4 * r] * vj0) + cam[4 * r + 1] * vj1) - q.o[r];
  normalize3(q.d);
  for (int c = 0; c < 4; ++c) {
    q.trans[c] = 1.0f;
    q.inc[c] = 0.0f;
  }
  q.bounce = 0;
  ++q.sample;
}

// Make the sphere of table row `sp` (centre first), hit at `dst`, the
// segment's hit, with its outward or flipped-inside normal.
__device__ __forceinline__ void sphere_hit(const float* sp, int mat,
                                           const float o[3],
                                           const float d[3], float dst,
                                           bool inside, SegHit& h,
                                           float normal[3]) {
  h.dst = dst;
  h.kind = -2;
  h.mat = mat;
  h.flag = inside ? 1 : 0;
  for (int r = 0; r < 3; ++r) h.point[r] = o[r] + d[r] * dst;
  float n[3] = {h.point[0] - sp[0], h.point[1] - sp[1], h.point[2] - sp[2]};
  normalize3(n);
  for (int r = 0; r < 3; ++r) normal[r] = inside ? -n[r] : n[r];
}

// The segment prepass of the ray (o, d) (megakernel.py segment_prepass
// :1088): the dense spheres, then each brute-force group in instance
// order. Starts `h` and `normal` afresh. `tests` counts the brute-force
// closest-hit calls. `s_sph`, `s_inst` and `s_brute` are the tables every
// segment reads whole, in shared or in global memory.
template <bool kGeneral, int kSph>
__device__ __forceinline__ void segment_prepass(
    const Params& p, const float* s_sph, const float* s_inst,
    const float4* s_brute, const float o[3], const float d[3], SegHit& h,
    float normal[3], unsigned long long& tests) {
  h.dst = kInf;
  h.u = h.v = h.det = 0.0f;
  h.kind = -1;
  h.mat = 0;
  h.flag = 0;
  for (int r = 0; r < 3; ++r) h.point[r] = 0.0f;
  for (int r = 0; r < 3; ++r) normal[r] = 0.0f;

  // ---- dense sphere prepass (intersect.closest_sphere): the first index on
  // an equal distance like argmin. The exact branch is the main path's and
  // is kept as it was measured: rewritten to share the fast branch's
  // epilogue it cost that path 6% (PERF.md, section 6).
  if constexpr (kSph == kSphExact) {
    // intersect.ray_sphere: the reference-order quadratic
    int sidx = 0;
    bool s_in = false, s_hit = false;
    float sph_dst = kInf;
    float a_q = dot3(d, d);
    for (int si = 0; si < dense_spheres<kSph>(p); ++si) {
      const float* sp = s_sph + si * kSphStride;
      float oc[3] = {o[0] - sp[0], o[1] - sp[1], o[2] - sp[2]};
      float b_q = 2.0f * dot3(oc, d);
      float c_q = dot3(oc, oc) - sp[3] * sp[3];
      float disc = b_q * b_q - (4.0f * a_q) * c_q;
      float sq = sqrtf(nan_max(disc, 0.0f));
      float dn = nan_max((-b_q - sq) / (2.0f * a_q), 0.0f);
      float df = (-b_q + sq) / (2.0f * a_q);
      bool is_in = dn == 0.0f;
      bool hit = (disc >= 0.0f) && (df >= 0.001f);
      float ds = hit ? (is_in ? df : dn) : kInf;
      if (ds < sph_dst) {
        sph_dst = ds;
        sidx = si;
        s_in = is_in;
        s_hit = hit;
      }
    }
    if (s_hit) {
      const float* sp = s_sph + sidx * kSphStride;
      h.dst = sph_dst;
      h.kind = -2;
      h.mat = (int)sp[4];
      h.flag = s_in ? 1 : 0;
      for (int r = 0; r < 3; ++r) h.point[r] = o[r] + d[r] * sph_dst;
      float n[3] = {h.point[0] - sp[0], h.point[1] - sp[1],
                    h.point[2] - sp[2]};
      normalize3(n);
      for (int r = 0; r < 3; ++r) normal[r] = s_in ? -n[r] : n[r];
    }
  } else if constexpr (kSph == kSphFast) {
    // intersect.ray_sphere_fast: shared terms, one 1/a a ray; the winner is
    // a hit where its distance is under INF
    int sidx = -1;
    bool s_in = false;
    float sph_dst = kInf;
    float a_q = dot3(d, d);
    float inv_a = 1.0f / a_q;
    float oo = dot3(o, o), od = dot3(o, d);
    for (int si = 0; si < dense_spheres<kSph>(p); ++si) {
      const float* sp = s_sph + si * kSphStride;
      float cd = (sp[0] * d[0] + sp[1] * d[1]) + sp[2] * d[2];
      float co = (sp[0] * o[0] + sp[1] * o[1]) + sp[2] * o[2];
      float hq = od - cd;
      float c_q = (oo - 2.0f * co) + sp[3];
      float disc = hq * hq - a_q * c_q;
      float sq = sqrtf(nan_max(disc, 0.0f));
      float dn = nan_max((-hq - sq) * inv_a, 0.0f);
      float df = (-hq + sq) * inv_a;
      bool is_in = dn == 0.0f;
      bool hit = (disc >= 0.0f) && (df >= 0.001f);
      float ds = hit ? (is_in ? df : dn) : kInf;
      if (ds < sph_dst) {
        sph_dst = ds;
        sidx = si;
        s_in = is_in;
      }
    }
    if (sidx >= 0) {
      const float* sp = s_sph + sidx * kSphStride;
      sphere_hit(sp, (int)sp[4], o, d, sph_dst, s_in, h, normal);
    }
  }

  // ---- brute-force groups, in instance order (segment_prepass
  // :1169-1191): the csrc/brute.cuh loop on the staged triangles
  for (int i = 0; kGeneral && i < p.n_inst; ++i) {
    const float* in = s_inst + i * kInstCols;
    if (in[kInBrute] < 0.5f) continue;
    float om[3], dm[3];
    instance_ray(in, o, d, om, dm);
    ++tests;
    rt2_brute::Hit bh;
    const float4* rows = s_brute + (int)in[kInSlot] * rt2_brute::kRowWords;
    rt2_brute::closest_hit(rows, (int)in[kInCount], om, dm, bh);
    if (bh.tri >= 0)
      merge_instance(in, i, o, om, dm, bh.dst, bh.u, bh.v, bh.det,
                     (int)in[kInTriOff] + bh.tri,
                     rt2_brute::row_material(
                         rows + bh.tri * rt2_brute::kRowWords), h);
  }
}

// Floor modulo of i by n > 0 (jnp.mod): -1 wraps to n - 1
__device__ __forceinline__ int wrap(int i, int n) {
  int r = i % n;
  return r < 0 ? r + n : r;
}

// Bilinear sample with repeat wrap of atlas slot `slot` (clamped to >= 0)
// at (u, v) (kernels/texture.py sample_bilinear_quads; reference
// kernels/texture.py:98-133): the slot row's float32 offset, height and
// width, the texel-centred position, one 16-byte load of the quad, the
// bytes of each word times float32(1/255) (what the reference's / 255.0
// compiles to), and the blend in the reference's order.
__device__ __forceinline__ void sample_quads(const TexParams& tex, int slot,
                                             const float uv[2],
                                             float out[4]) {
  const float* m = tex.meta + 4 * max(slot, 0);
  float hf = __ldg(m + 1), wf = __ldg(m + 2);
  int off = (int)__ldg(m), h = (int)hf, w = (int)wf;
  float u = uv[0] - floorf(uv[0]);
  float v = uv[1] - floorf(uv[1]);
  float xf = u * wf - 0.5f;
  float yf = v * hf - 0.5f;
  float x0 = floorf(xf), y0 = floorf(yf);
  float tx = xf - x0, ty = yf - y0;
  int t = off + wrap((int)y0, h) * w + wrap((int)x0, w);
  int4 q = __ldg(tex.texels + t);
  for (int c = 0; c < 4; ++c) {
    float c00 = (float)((q.x >> (8 * c)) & 0xFF) * kInv255;
    float c01 = (float)((q.y >> (8 * c)) & 0xFF) * kInv255;
    float c10 = (float)((q.z >> (8 * c)) & 0xFF) * kInv255;
    float c11 = (float)((q.w >> (8 * c)) & 0xFF) * kInv255;
    float top = c00 * (1.0f - tx) + c01 * tx;
    float bot = c10 * (1.0f - tx) + c11 * tx;
    out[c] = top * (1.0f - ty) + bot * ty;
  }
}

// Spherical UV from a sphere hit's (flipped-inside) unit normal
// (intersect.py sphere_uv; ray_tracer.wgsl:246-251)
__device__ __forceinline__ void sphere_uv(const float n[3], float uv[2]) {
  float theta = acosf(clamp_pm1(-n[1]));
  float phi = atan2f(-n[2], -n[0]) + kPi;
  uv[0] = phi * kInvTwoPi;
  uv[1] = theta * kInvPi;
}

// One light sample from a diffuse vertex (megakernel.py resolve_and_shade
// :924-1000, in its op order): the shadow ray's direction, the distance to
// the light point, the light's contribution if it is unoccluded, and
// whether the sample counts.
struct NeeSample {
  float d[3], t_l, c3[3];
  bool may;    // not inside the picked sphere light (else no sample, and
               // the next hit's emission is kept)
  bool takes;  // above the surface and on the light's front (a triangle)
};

// Three draws; the light picked by area as a count of the cdf entries
// before the last that the draw reaches; a point on a triangle by the sqrt
// warp (cos_l * total_area / (2 pi d^2)), or a direction in the cone a
// sphere subtends ((1 - cos_max) * total_area / (4 pi r^2)). `color` is the
// material's row (kTex: the diffuse colour, a textured one's sample, in
// registers), `trans` the path's before this vertex.
template <bool kTex>
__device__ __forceinline__ void sample_light(const NeeParams& nee,
                                             uint32_t& seed,
                                             const float point[3],
                                             const float normal[3],
                                             const float trans[4],
                                             const float* color,
                                             NeeSample& s) {
  float r_pick = rand01(seed);
  float r1 = rand01(seed);
  float r2 = rand01(seed);
  int li = 0;
  for (int j = 0; j + 1 < nee.n_lights; ++j)
    li += r_pick >= __ldg(nee.cdf + j) ? 1 : 0;
  const float* L = nee.lights + li * kLightCols;
  float geom;
  bool front;
  if (__ldg(L) > 0.5f) {  // sphere: centre in v0, radius in v1.x
    float rad = __ldg(L + 4);
    float cvec[3], w[3], u[3], v[3];
    for (int r = 0; r < 3; ++r) cvec[r] = __ldg(L + 1 + r) - point[r];
    float cd2 = nan_max(dot3(cvec, cvec), 1e-12f);
    float cdist = sqrtf(cd2);
    for (int r = 0; r < 3; ++r) w[r] = cvec[r] / cdist;
    float sin_max = clamp01(rad / cdist);
    float cos_max = sqrtf(nan_max(1.0f - sin_max * sin_max, 0.0f));
    float cos_t = 1.0f - r1 * (1.0f - cos_max);
    float sin_t = sqrtf(nan_max(1.0f - cos_t * cos_t, 0.0f));
    float phi = 6.2831855f * r2;  // float32(2 pi)
    float hx = fabsf(w[0]) > 0.9f ? 0.0f : 1.0f;
    float helper[3] = {hx, 1.0f - hx, 0.0f};
    cross3(helper, w, u);
    normalize3(u);
    cross3(w, u, v);
    float cp = cosf(phi), sp = sinf(phi);
    for (int r = 0; r < 3; ++r)
      s.d[r] = w[r] * cos_t + (u[r] * cp + v[r] * sp) * sin_t;
    normalize3(s.d);
    float h_q = dot3(s.d, cvec);
    float disc = nan_max(h_q * h_q - (cd2 - rad * rad), 0.0f);
    s.t_l = h_q - sqrtf(disc);
    // float32(4 pi)
    geom = ((1.0f - cos_max) * nee.c_area) /
           nan_max((12.566371f * rad) * rad, 1e-12f);
    s.may = cdist > rad * 1.001f;
    front = s.may;
  } else {  // triangle
    float su = sqrtf(r1);
    float a = 1.0f - su, b = su * (1.0f - r2), c = su * r2;
    float dv[3];
    for (int r = 0; r < 3; ++r)
      dv[r] = ((__ldg(L + 1 + r) * a + __ldg(L + 4 + r) * b) +
               __ldg(L + 7 + r) * c) - point[r];
    float d2 = nan_max(dot3(dv, dv), 1e-12f);
    s.t_l = sqrtf(d2);
    for (int r = 0; r < 3; ++r) s.d[r] = dv[r] / s.t_l;
    float cos_l = -((__ldg(L + 10) * s.d[0] + __ldg(L + 11) * s.d[1]) +
                    __ldg(L + 12) * s.d[2]);
    geom = (cos_l * nee.c_tri) / d2;
    s.may = true;
    front = cos_l > 0.0f;
  }
  s.takes = dot3(normal, s.d) > 0.0f && front;
  for (int c = 0; c < 3; ++c) {
    float col;
    if constexpr (kTex)
      col = color[c];
    else
      col = __ldg(color + c);
    s.c3[c] = ((trans[c] * col) * __ldg(L + 13 + c)) * geom;
  }
}

// One segment of the lane's path: {the prepass; each wide-BVH instance;
// the sphere BVH; shade; Russian roulette}. Updates the ray, transmission,
// incoming light and seed; returns whether the path goes on. `tests`
// counts the brute-force closest-hit calls.
//
// With kNee, next-event estimation (megakernel.py resolve_and_shade): a
// diffuse vertex with room in the bounce budget samples a light (three
// draws more on every diffuse or specular vertex) and its next hit adds no
// emission. In mode kNeeInline the shadow ray runs the prepass here and
// the contribution is added at once; in mode kNeeSegments the lane's next
// turn traces the shadow ray as a segment of its own, through every phase,
// and then banks the contribution if the light was unoccluded and takes
// the stashed ray up again, without shading or drawing (the bounce stays
// meanwhile: render_kernel).
//
// With kTex, textures and normal maps (megakernel.py _albedo,
// _normal_mapped; reference resolve_and_shade :796-884).
template <bool kGeneral, bool kGlass, int kSph, bool kNee, bool kTex>
__device__ __forceinline__ bool trace_segment(
    const Params& p, const NeeParams& nee, const TexParams& tex,
    const float* s_sph,
    const float* s_inst, const float4* s_brute,
    std::conditional_t<kNee, NeePath, Path>& q, unsigned long long& tests,
    Visits& vis) {
  float* o = q.o;
  float* d = q.d;
  float* trans = q.trans;
  float* inc = q.inc;
  uint32_t& seed = q.seed;
  SegHit h;
  float normal[3];
  segment_prepass<kGeneral, kSph>(p, s_sph, s_inst, s_brute, o, d, h,
                                  normal, tests);

  // ---- wide-BVH instances, in order: pruning limit seeded from the best
  // world distance so far (start_segments :1257-1268, _advance_impl
  // :685-689), traversal, merge
  for (int i = 0; i < (kGeneral ? p.n_inst : 1); ++i) {
    const float* in = s_inst + i * kInstCols;
    if (kGeneral && in[kInBrute] > 0.5f) continue;
    float om[3], dm[3], wv[3];
    instance_ray(in, o, d, om, dm);
    apply3x3(in + kInM2w, dm, wv);
    float slack = 8e-6f * (1.0f + sqrtf(dot3(o, o)));
    float limit = (h.dst * 1.000004f + slack) / sqrtf(dot3(wv, wv));
    Hit th;
    traverse<false>(p.wide_rows, (int)in[kInRoot], om, dm, limit, th, vis);
    if (th.tri >= 0)
      merge_instance(in, i, o, om, dm, th.dst, th.u, th.v, th.det, th.tri,
                     th.mat, h);
  }

  // ---- the sphere BVH, in world space, entered with the best world
  // distance so far (_advance_impl :714-733). The winner's centre, radius
  // and material come from the sphere table, its inside flag from the
  // dense quadratic (_sphere_merge :592-626).
  if constexpr (kSph == kSphBvh) {
    Hit sh;
    traverse<true>(p.wide_rows, sphere_root<kSph>(p), o, d, h.dst, sh, vis);
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

  if constexpr (kNee) {
    if (q.bits & kNeeShadow) {  // a shadow segment ends: resume the path
      if (h.dst >= q.st * 0.999f)  // float32(1 - 1e-3)
        for (int c = 0; c < 3; ++c) inc[c] = inc[c] + q.sc[c];
      for (int r = 0; r < 3; ++r) {
        o[r] = q.so[r];
        d[r] = q.sd[r];
      }
      bool goes_on = (q.bits & kNeeGoesOn) != 0;
      q.bits = kNeeSup;
      return goes_on;
    }
  }

  // ---- resolve + shade (megakernel.py resolve_and_shade :739;
  // ray_tracer.wgsl:398-471)
  if (h.kind == -1) {
    if (p.skybox) {
      float env[4];
      environment_light(d, env);
      for (int c = 0; c < 4; ++c) inc[c] = inc[c] + trans[c] * env[c];
    }
    return false;
  }
  bool backface;
  [[maybe_unused]] float uv[2] = {0.0f, 0.0f};
  if (h.kind >= 0) {  // mesh normal through the hit instance's m2w
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
    apply3x3(s_inst + (kGeneral ? h.flag : 0) * kInstCols + kInM2w, nm,
             normal);
    normalize3(normal);
    backface = h.det < 0.0f;
    if constexpr (kTex) {  // the interpolated UV
      for (int r = 0; r < 2; ++r)
        uv[r] = (__ldg(at + 9 + r) * wb + __ldg(at + 11 + r) * h.u) +
                __ldg(at + 13 + r) * h.v;
    }
  } else {
    backface = h.flag > 0;
    if constexpr (kTex) sphere_uv(normal, uv);
  }
  const float* m = p.mat_rows + (size_t)h.mat * 32;
  [[maybe_unused]] float albedo[4];
  if constexpr (kTex) {
    // normal map (:805-824): the map decoded as 2 n - 1 in the tangent
    // frame, the instance's tangent made orthogonal to the normal, the
    // bitangent cross(normal, tangent) times the handedness
    if (tex.normal_maps && h.kind >= 0 && __ldg(m + 23) != -1.0f) {
      const float* at = p.tri_attr + (size_t)(h.kind >> 2) * kRow +
                        (h.kind & 3) * 32;
      float texel[4], tm[3], tw[3], bw[3], nt[3];
      sample_quads(tex, (int)__ldg(m + 23), uv, texel);
      for (int r = 0; r < 3; ++r) {
        nt[r] = texel[r] * 2.0f - 1.0f;
        tm[r] = __ldg(at + 15 + r);
      }
      apply3x3(s_inst + (kGeneral ? h.flag : 0) * kInstCols + kInM2w, tm,
               tw);
      normalize3(tw);
      float tn = dot3(tw, normal);
      for (int r = 0; r < 3; ++r) tw[r] = tw[r] - normal[r] * tn;
      normalize3(tw);
      cross3(normal, tw, bw);
      float hand = __ldg(at + 18);
      float np[3];
      for (int r = 0; r < 3; ++r)
        np[r] = (tw[r] * nt[0] + (bw[r] * hand) * nt[1]) +
                normal[r] * nt[2];
      normalize3(np);
      for (int r = 0; r < 3; ++r) normal[r] = np[r];
    }
    // the diffuse colour (:869-884): a textured material's sample
    if (__ldg(m + 21) == kFlagTexture && __ldg(m + 22) != -1.0f) {
      sample_quads(tex, (int)__ldg(m + 22), uv, albedo);
    } else {
      for (int c = 0; c < 4; ++c) albedo[c] = __ldg(m + c);
    }
  }
  float nd[3], no[3];
  [[maybe_unused]] NeeSample ns;
  [[maybe_unused]] bool sup = false, shadow = false;
  if constexpr (kNee) {
    sup = (q.bits & kNeeSup) != 0;
    q.bits = 0;
  }
  if (kGlass && __ldg(m + 21) == kFlagGlass) {  // glass (:826-852)
    if (backface) {
      float ak = __ldg(m + 16);
      for (int c = 0; c < 3; ++c)
        trans[c] = trans[c] * expf(((-h.dst) * __ldg(m + 12 + c)) * ak);
      trans[3] = 1.0f;
    }
    float m_ior = __ldg(m + 20);
    float ior = backface ? m_ior : 1.0f / m_ior;
    float idn = 2.0f * dot3(d, normal);
    float cos_i = dot3(normal, d);
    float k = 1.0f - (ior * ior) * (1.0f - cos_i * cos_i);
    float kr = sqrtf(nan_max(k, 0.0f));
    float neg_d[3] = {-d[0], -d[1], -d[2]};
    float cos_t = nan_min(dot3(neg_d, normal), 1.0f);
    float sin_t = sqrtf(nan_max(1.0f - cos_t * cos_t, 0.0f));
    bool cannot = ior * sin_t > 1.0f;
    bool follow = true;
    if (!cannot) {
      float r_refl = rand01(seed);
      follow = reflectance(cos_t, ior) > r_refl;
    }
    float g[3], dfd[3];
    rand_direction(seed, g);
    for (int r = 0; r < 3; ++r) dfd[r] = normal[r] + g[r];
    normalize3(dfd);
    if (follow) {
      float t_mix = __ldg(m + 19);
      for (int r = 0; r < 3; ++r) {
        float refl = d[r] - idn * normal[r];
        nd[r] = dfd[r] + (refl - dfd[r]) * t_mix;
      }
    } else {
      float t_mix = __ldg(m + 18);
      for (int r = 0; r < 3; ++r) {
        float refr = k < 0.0f
            ? 0.0f : ior * d[r] - (ior * cos_i + kr) * normal[r];
        float a0 = -dfd[r];
        nd[r] = a0 + (refr - a0) * t_mix;
      }
    }
    normalize3(nd);
    float gs = sign_of(dot3(normal, nd));
    for (int r = 0; r < 3; ++r) no[r] = h.point[r] + (1e-4f * normal[r]) * gs;
  } else {  // ---- diffuse / specular
    float r_spec = rand01(seed);
    bool is_spec = __ldg(m + 19) >= r_spec;
    float diffuse[3];
    rand_hemisphere(normal, seed, diffuse);
    float idn = 2.0f * dot3(d, normal);
    float tmix = __ldg(m + 18) * (is_spec ? 1.0f : 0.0f);
    for (int r = 0; r < 3; ++r) {
      float spec = d[r] - idn * normal[r];
      nd[r] = diffuse[r] + (spec - diffuse[r]) * tmix;
    }
    normalize3(nd);
    float emis = __ldg(m + 17);
    [[maybe_unused]] bool sampled = false, lit = false;
    if constexpr (kNee) {
      if constexpr (kTex)
        sample_light<true>(nee, seed, h.point, normal, trans, albedo, ns);
      else
        sample_light<false>(nee, seed, h.point, normal, trans, m, ns);
      sampled = !is_spec && ns.may && q.bounce + 1 <= p.bounces;
      shadow = sampled && ns.takes;
      q.shadows += shadow ? 1 : 0;
      if (shadow && nee.mode == kNeeInline) {
        SegHit sh;
        float sn[3];
        segment_prepass<kGeneral, kSph>(p, s_sph, s_inst, s_brute, h.point,
                                        ns.d, sh, sn, tests);
        lit = sh.dst >= ns.t_l * 0.999f;  // float32(1 - 1e-3)
      }
    }
    for (int c = 0; c < 4; ++c) {
      inc[c] = inc[c] + (sup ? 0.0f : __ldg(m + 4 + c) * emis) * trans[c];
      if constexpr (kTex)
        trans[c] = trans[c] * (is_spec ? __ldg(m + 8 + c) : albedo[c]);
      else
        trans[c] = trans[c] * __ldg(m + (is_spec ? 8 : 0) + c);
    }
    if constexpr (kNee) {
      if (lit)
        for (int c = 0; c < 3; ++c) inc[c] = inc[c] + ns.c3[c];
      if (sampled) q.bits = kNeeSup;
    }
    for (int r = 0; r < 3; ++r) no[r] = h.point[r];
  }
  // ---- Russian roulette from the taken branch's seed
  float pr = fmaxf(fmaxf(trans[0], trans[1]), trans[2]);
  float r_rr = rand01(seed);
  bool survive = r_rr < pr;
  float pdiv = pr > 0.0f ? pr : 1.0f;
  for (int c = 0; c < 4; ++c) trans[c] = trans[c] / pdiv;
  for (int r = 0; r < 3; ++r) {
    o[r] = no[r];
    d[r] = nd[r];
  }
  if constexpr (kNee) {
    if (shadow && nee.mode == kNeeSegments) {  // trace the shadow ray next
      for (int r = 0; r < 3; ++r) {
        q.so[r] = o[r];
        q.sd[r] = d[r];
        q.sc[r] = ns.c3[r];
        o[r] = h.point[r];
        d[r] = ns.d[r];
      }
      q.st = ns.t_l;
      q.bits = kNeeSup | kNeeShadow | (survive ? kNeeGoesOn : 0);
      return true;
    }
  }
  return survive;
}

// The persistent kernel: stage the tables, then turn the warp's lane loop
// until no lane of the warp holds a path and the frame is handed out. At
// the top of each turn a lane without a path writes its pixel if all of its
// samples are done, claims a new pixel (csrc/claim.cuh) if it has none, and
// starts its pixel's next sample; then every lane that holds a path traces
// one segment.
//
// Compiled per scene class, from what the host knows of the scene:
// kGeneral is false for exactly one instance, traversed in its wide BVH
// (the main path), which then compiles without the brute-force prepass and
// the instance loop; kGlass is false when no material is glass, which
// compiles out the glass branch; kSph says how spheres are tested (kSph*);
// kStaged is false when the scene's tables pass kDynSmemBytes and are read
// from global memory instead of being staged; kNee compiles in next-event
// estimation (trace_segment), whose lanes carry NeePath; kTex textures and
// normal maps.
template <bool kGeneral, bool kGlass, int kSph, bool kStaged,
          bool kNee = false, bool kTex = false>
__device__ __forceinline__ void render_kernel(
    const Params& p, const NeeParams& nee = NeeParams(),
    const TexParams& tex = TexParams()) {
  __shared__ float s_scal[kScal];
  __shared__ unsigned long long s_warp[kThreads / 32];
  extern __shared__ __align__(16) float s_dyn[];
  // dynamic shared memory: instance rows, staged triangles, dense spheres
  const float* s_inst = p.inst;
  const float4* s_brute = reinterpret_cast<const float4*>(p.brute);
  const float* s_sph = p.spheres;
  for (int i = threadIdx.x; i < kScal; i += blockDim.x) s_scal[i] = p.scal[i];
  if (kStaged) {
    // the main path's form has one instance and no brute-force triangle:
    // its tables lie at offsets known when it is compiled
    const int n_inst = kGeneral ? p.n_inst : 1;
    const int n_brute = kGeneral ? p.n_brute : 0;
    float* d_inst = s_dyn;
    float4* d_brute = reinterpret_cast<float4*>(s_dyn + n_inst * kInstCols);
    float* d_sph =
        reinterpret_cast<float*>(d_brute + n_brute * rt2_brute::kRowWords);
    for (int i = threadIdx.x; i < n_inst * kInstCols; i += blockDim.x)
      d_inst[i] = p.inst[i];
    for (int i = threadIdx.x; kGeneral && i < n_brute; i += blockDim.x)
      rt2_brute::stage_row(p.brute + (size_t)i * kBruteCols,
                           d_brute + i * rt2_brute::kRowWords);
    if constexpr (kSph != kSphBvh) {
      for (int i = threadIdx.x; i < dense_spheres<kSph>(p) * kSphStride;
           i += blockDim.x)
        d_sph[i] = p.spheres[i];
    }
    s_inst = d_inst;
    s_brute = d_brute;
    s_sph = d_sph;
  }
  __syncthreads();

  unsigned* cursor =
      reinterpret_cast<unsigned*>(p.scratch + rt2_claim::kScratchCursor);
  const bool lead = (threadIdx.x & 31) == 0;
  const float rpp = (float)p.rpp;
  unsigned long long segs = 0, tests = 0, rows = 0, leaves = 0, boxes = 0;
  unsigned long long turns = 0, active = 0;
  std::conditional_t<kNee, NeePath, Path> q;
  if constexpr (kNee) q.shadows = 0;
  q.pix = -1;
  q.sample = 0;
  bool has_path = false, exhausted = false;
  while (true) {
    if (!has_path && q.pix >= 0 && q.sample == p.rpp) {
      float* out = p.out + (size_t)q.pix * 4;
      for (int c = 0; c < 4; ++c) out[c] = q.acc[c] / rpp;
      q.pix = -1;
    }
    bool need = q.pix < 0 && !exhausted;
    unsigned id = rt2_claim::claim(cursor, need);
    if (need) {
      if (id < (unsigned)p.total) {
        q.pix = (int)id;
        int px = q.pix % p.width;
        int py = p.row_start + q.pix / p.width;
        q.seed = (uint32_t)(py * p.width + px) + p.frame_seed;
        q.sample = 0;
        for (int c = 0; c < 4; ++c) q.acc[c] = 0.0f;
      } else {
        exhausted = true;
      }
    }
    if (!has_path && q.pix >= 0) {
      start_sample(p, s_scal, q);
      if constexpr (kNee) q.bits = 0;  // a new path shows every emission
      has_path = true;
    }
    unsigned live = __ballot_sync(rt2_claim::kFull, has_path);
    if (live == 0u) break;  // the same on every lane of the warp
    if (lead) {
      ++turns;
      active += (unsigned)__popc(live);
    }
    if (has_path) {
      ++segs;
      Visits vis = {0u, 0u, 0u};
      bool goes_on = trace_segment<kGeneral, kGlass, kSph, kNee, kTex>(
          p, nee, tex, s_sph, s_inst, s_brute, q, tests, vis);
      rows += vis.rows;
      leaves += vis.leaves;
      boxes += vis.boxes;
      bool pinned = false;  // a shadow segment is next: the bounce stays
      if constexpr (kNee) pinned = (q.bits & kNeeShadow) != 0;
      if (!goes_on || (!pinned && ++q.bounce > p.bounces)) {
        for (int c = 0; c < 4; ++c) q.acc[c] = q.acc[c] + q.inc[c];
        has_path = false;
      }
    }
  }

  // ---- exact counts: warp reduce, block reduce, one atomic each
  rt2_claim::block_add<kThreads>(
      segs, p.scratch + rt2_claim::kScratchSegments, s_warp);
  rt2_claim::block_add<kThreads>(rows, p.counts + kCntRows, s_warp);
  rt2_claim::block_add<kThreads>(leaves, p.counts + kCntLeaves, s_warp);
  rt2_claim::block_add<kThreads>(boxes, p.counts + kCntBoxes, s_warp);
  rt2_claim::block_add<kThreads>(turns, p.counts + kCntTurns, s_warp);
  rt2_claim::block_add<kThreads>(active, p.counts + kCntActive, s_warp);
  if constexpr (kNee)
    rt2_claim::block_add<kThreads>(q.shadows, p.counts + kCntShadowRays,
                                   s_warp);
  if (kGeneral) {
    unsigned long long t = rt2_claim::block_add<kThreads>(
        tests, p.counts + kCntBruteCalls, s_warp);
    // the first block that ran the prepass counts the launch
    if (threadIdx.x == 0 && t > 0 &&
        atomicExch(p.scratch + rt2_claim::kScratchFlag, 1ull) == 0ull)
      atomicAdd(p.counts + kCntBruteLaunches, 1ull);
  }
}

// The entry points of the four forms. Unbounded, the general forms take
// 117 registers (4 resident blocks of 128 threads per SM); held to
// kGeneralMinBlocks (72 registers, spilling) they measured faster on room2
// and instances_scene. The main path's forms measured slower held to 7 or
// 8 blocks, and with a minimum of 1 ptxas gave them 102 registers (4
// blocks) instead of 96 (5 blocks), so they carry no minimum (PERF.md,
// section 5). The general forms beyond the exact dense prepass on staged
// tables (the fast prepass, the sphere BVH, tables in global memory) are
// compiled with the glass branch only: nine kernels. Next-event estimation
// has its own general forms, one for each way spheres are tested and for
// staged or global tables, each with the glass branch, taking NeeParams
// beside Params: fifteen kernels. The textured forms (textures, normal
// maps) are general, with the glass branch, on tables in global memory,
// one for each way spheres are tested, with and without next-event
// estimation, taking NeeParams and TexParams beside Params: twenty-one
// kernels in all.
constexpr int kGeneralMinBlocks = 7;

template <bool kGlass>
__global__ void __launch_bounds__(kThreads) render_single(Params p) {
  render_kernel<false, kGlass, kSphExact, true>(p);
}

template <bool kGlass, int kSph, bool kStaged>
__global__ void __launch_bounds__(kThreads, kGeneralMinBlocks)
render_general(Params p) {
  render_kernel<true, kGlass, kSph, kStaged>(p);
}

template <int kSph, bool kStaged>
__global__ void __launch_bounds__(kThreads, kGeneralMinBlocks)
render_general_nee(Params p, NeeParams nee) {
  render_kernel<true, true, kSph, kStaged, true>(p, nee);
}

template <int kSph, bool kNee>
__global__ void __launch_bounds__(kThreads, kGeneralMinBlocks)
render_general_tex(Params p, NeeParams nee, TexParams tex) {
  render_kernel<true, true, kSph, false, kNee, true>(p, nee, tex);
}

using Kernel = void (*)(Params);
using NeeKernel = void (*)(Params, NeeParams);
using TexKernel = void (*)(Params, NeeParams, TexParams);

// The compiled form for a scene class; nullptr for a class without one.
Kernel pick_kernel(bool general, bool glass, int sph, bool staged) {
  if (sph == kSphExact && staged) {
    if (!general) return glass ? render_single<true> : render_single<false>;
    return glass ? render_general<true, kSphExact, true>
                 : render_general<false, kSphExact, true>;
  }
  if (!general || !glass) return nullptr;
  if (staged)
    return sph == kSphFast ? render_general<true, kSphFast, true>
                           : render_general<true, kSphBvh, true>;
  return sph == kSphExact  ? render_general<true, kSphExact, false>
         : sph == kSphFast ? render_general<true, kSphFast, false>
                           : render_general<true, kSphBvh, false>;
}

// The NEE form for a scene class: always general, with the glass branch.
NeeKernel pick_nee_kernel(int sph, bool staged) {
  if (staged)
    return sph == kSphExact  ? render_general_nee<kSphExact, true>
           : sph == kSphFast ? render_general_nee<kSphFast, true>
                             : render_general_nee<kSphBvh, true>;
  return sph == kSphExact  ? render_general_nee<kSphExact, false>
         : sph == kSphFast ? render_general_nee<kSphFast, false>
                           : render_general_nee<kSphBvh, false>;
}

// The textured form for a scene class: general, glass compiled in, tables
// in global memory.
TexKernel pick_tex_kernel(int sph, bool nee) {
  if (nee)
    return sph == kSphExact  ? render_general_tex<kSphExact, true>
           : sph == kSphFast ? render_general_tex<kSphFast, true>
                             : render_general_tex<kSphBvh, true>;
  return sph == kSphExact  ? render_general_tex<kSphExact, false>
         : sph == kSphFast ? render_general_tex<kSphFast, false>
                           : render_general_tex<kSphBvh, false>;
}

template <typename K, typename... Args>
cudaError_t launch(K kernel, size_t smem, cudaStream_t stream,
                   const Params& p, Args... more) {
  int blocks = rt2_claim::persistent_blocks(kernel, kThreads, smem, p.total);
  kernel<<<blocks, kThreads, smem, stream>>>(p, more...);
  return cudaGetLastError();
}

// Checks the arguments shared by both entry points and fills `p` and the
// dynamic shared memory `smem`; returns cudaErrorInvalidValue where an
// argument is out of range.
cudaError_t make_params(
    const float* wide_rows, const float* tri_attr, const float* mat_rows,
    const float* spheres, const float* scal, const float* inst,
    const float* brute, int n_spheres, int n_inst, int n_brute, int width,
    int height, int row_start, int rows, int bounces, int rpp, int skybox,
    int antialias, int spheres_mode, int staged, int sphere_root,
    unsigned int frame_seed, float* out, unsigned long long* scratch,
    unsigned long long* counts, Params& p, size_t& smem) {
  if (n_spheres < 0 || n_inst < 0 ||
      n_brute < 0 || rpp < 1 || bounces < 0 || width < 1 || rows < 1 ||
      (((uintptr_t)wide_rows | (uintptr_t)brute) & 15u) != 0u)
    return cudaErrorInvalidValue;
  if (spheres_mode == kSphBvh ? (sphere_root < 0 || n_spheres < 1)
                              : n_spheres > kMaxSpheres)
    return cudaErrorInvalidValue;
  smem = 0;
  if (staged) {
    smem = sizeof(float) *
           ((size_t)n_inst * kInstCols +
            (size_t)n_brute * 4 * rt2_brute::kRowWords +
            (spheres_mode == kSphBvh ? 0 : (size_t)n_spheres * kSphStride));
    if (smem > (size_t)kDynSmemBytes) return cudaErrorInvalidValue;
  }
  p.wide_rows = wide_rows;
  p.tri_attr = tri_attr;
  p.mat_rows = mat_rows;
  p.spheres = spheres;
  p.scal = scal;
  p.inst = inst;
  p.brute = brute;
  p.out = out;
  p.scratch = scratch;
  p.counts = counts;
  p.sph = spheres_mode == kSphBvh ? sphere_root : n_spheres;
  p.n_inst = n_inst;
  p.n_brute = n_brute;
  p.width = width;
  p.height = height;
  p.row_start = row_start;
  p.total = rows * width;
  p.bounces = bounces;
  p.rpp = rpp;
  p.skybox = skybox;
  p.antialias = antialias;
  p.frame_seed = frame_seed;
  return cudaSuccess;
}

// The light table's arguments as NeeParams; false where they are out of
// range for `spheres_mode` (kNeeInline has no shadow segments to walk the
// sphere BVH in).
bool make_nee(const float* lights, const float* cdf, int n_lights,
              int nee_mode, float c_tri, float c_area, int spheres_mode,
              NeeParams& nee) {
  nee.lights = lights;
  nee.cdf = cdf;
  nee.n_lights = n_lights;
  nee.mode = nee_mode;
  nee.c_tri = c_tri;
  nee.c_area = c_area;
  return n_lights >= 1 && n_lights <= kMaxLights &&
         (nee_mode == kNeeInline || nee_mode == kNeeSegments) &&
         !(nee_mode == kNeeInline && spheres_mode == kSphBvh);
}

}  // namespace

// Launch on `stream`; allocates nothing and does not synchronise. `general`,
// `glass`, `spheres_mode` and `staged` pick the compiled form (render_kernel
// through render_single or render_general; pick_kernel): `general` == 0
// needs exactly one instance, a wide-BVH one, `glass` == 0 no glass
// material, both need `spheres_mode` == 0 and `staged` == 1.
// `spheres_mode` is kSphExact, kSphFast (the fourth column of `spheres`
// then holds |c|^2 - r^2) or kSphBvh (`sphere_root` is then the sphere
// BVH's root row in `wide_rows`, and `spheres` holds radii). With `staged`
// == 1 the tables must fit kDynSmemBytes and `brute` holds the packed
// brute-force rows (kernels/brute.py pack_brute_table), which each block
// stages; with `staged` == 0 the tables are read from global memory and
// `brute` holds the rows as stage_row makes them (n_brute rows of 16
// floats, kernels/brute.py stage_brute_rows). `scratch` holds
// rt2_claim::kScratchWords zeroed int64 words (the segment count lands in
// word 0), `counts` kCounts words that the launch adds to. `wide_rows`
// and `brute` must be 16-byte aligned. Returns
// cudaGetLastError() (0 = launched).
extern "C" int rt2_render_persistent(
    const float* wide_rows, const float* tri_attr, const float* mat_rows,
    const float* spheres, const float* scal, const float* inst,
    const float* brute, int n_spheres, int n_inst, int n_brute, int width,
    int height, int row_start, int rows, int bounces, int rpp, int skybox,
    int antialias, int general, int glass,
    int spheres_mode, int staged, int sphere_root, unsigned int frame_seed,
    float* out, unsigned long long* scratch, unsigned long long* counts,
    void* stream) {
  Params p;
  size_t smem;
  cudaError_t err = make_params(
      wide_rows, tri_attr, mat_rows, spheres, scal, inst, brute, n_spheres,
      n_inst, n_brute, width, height, row_start, rows, bounces, rpp, skybox,
      antialias, spheres_mode, staged, sphere_root, frame_seed, out, scratch,
      counts, p, smem);
  if (err != cudaSuccess) return (int)err;
  if (!general && (n_inst != 1 || n_brute != 0))
    return (int)cudaErrorInvalidValue;
  Kernel kernel = pick_kernel(general != 0, glass != 0, spheres_mode,
                              staged != 0);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  return (int)launch(kernel, smem, (cudaStream_t)stream, p);
}

// The same with next-event estimation, through the NEE forms (general,
// glass compiled in): `lights` holds `n_lights` (1-64) rows of kLightCols
// floats (kernels/megakernel.py light_tables), `cdf` their area shares
// summed, `nee_mode` kNeeInline (a scene without a traversal phase: no
// wide-BVH instance, no sphere BVH) or kNeeSegments, `c_tri` the total
// light area over 2 pi and `c_area` the total area, both float32. Each
// shadow segment of kNeeSegments counts as a segment.
extern "C" int rt2_render_persistent_nee(
    const float* wide_rows, const float* tri_attr, const float* mat_rows,
    const float* spheres, const float* scal, const float* inst,
    const float* brute, int n_spheres, int n_inst, int n_brute, int width,
    int height, int row_start, int rows, int bounces, int rpp, int skybox,
    int antialias, int spheres_mode, int staged, int sphere_root,
    unsigned int frame_seed, const float* lights, const float* cdf,
    int n_lights, int nee_mode, float c_tri, float c_area, float* out,
    unsigned long long* scratch, unsigned long long* counts, void* stream) {
  Params p;
  size_t smem;
  cudaError_t err = make_params(
      wide_rows, tri_attr, mat_rows, spheres, scal, inst, brute, n_spheres,
      n_inst, n_brute, width, height, row_start, rows, bounces, rpp, skybox,
      antialias, spheres_mode, staged, sphere_root, frame_seed, out, scratch,
      counts, p, smem);
  if (err != cudaSuccess) return (int)err;
  NeeParams nee;
  if (!make_nee(lights, cdf, n_lights, nee_mode, c_tri, c_area, spheres_mode,
                nee))
    return (int)cudaErrorInvalidValue;
  return (int)launch(pick_nee_kernel(spheres_mode, staged != 0), smem,
                     (cudaStream_t)stream, p, nee);
}

// The same through the textured forms (general, glass compiled in, tables
// in global memory: `brute` holds the rows as stage_row makes them), with
// next-event estimation when `nee_mode` is kNeeInline or kNeeSegments (the
// light arguments as rt2_render_persistent_nee takes them) and without it
// when `nee_mode` is 0 (they are then not read). `texels` holds `n_texels`
// int4 texels (TorchScene.tex_quads: a texel's word and its wrapped x, y
// and xy neighbours' in one 16-byte word), 16-byte aligned; `tex_meta` 64 slot rows of 4 floats; `normal_maps` 1 makes mesh
// hits take their material's normal map.
extern "C" int rt2_render_persistent_tex(
    const float* wide_rows, const float* tri_attr, const float* mat_rows,
    const float* spheres, const float* scal, const float* inst,
    const float* brute, int n_spheres, int n_inst, int n_brute, int width,
    int height, int row_start, int rows, int bounces, int rpp, int skybox,
    int antialias, int spheres_mode, int sphere_root,
    unsigned int frame_seed, const float* lights, const float* cdf,
    int n_lights, int nee_mode, float c_tri, float c_area, const int* texels,
    int n_texels, const float* tex_meta, int normal_maps, float* out,
    unsigned long long* scratch, unsigned long long* counts, void* stream) {
  Params p;
  size_t smem;
  cudaError_t err = make_params(
      wide_rows, tri_attr, mat_rows, spheres, scal, inst, brute, n_spheres,
      n_inst, n_brute, width, height, row_start, rows, bounces, rpp, skybox,
      antialias, spheres_mode, 0, sphere_root, frame_seed, out, scratch,
      counts, p, smem);
  if (err != cudaSuccess) return (int)err;
  NeeParams nee;
  if ((!make_nee(lights, cdf, n_lights, nee_mode, c_tri, c_area,
                 spheres_mode, nee) && nee_mode != 0) ||
      n_texels < 64 || ((uintptr_t)texels & 15u) != 0u)
    return (int)cudaErrorInvalidValue;
  TexParams tex;
  tex.texels = reinterpret_cast<const int4*>(texels);
  tex.meta = tex_meta;
  tex.normal_maps = normal_maps;
  return (int)launch(pick_tex_kernel(spheres_mode, nee_mode != 0), smem,
                     (cudaStream_t)stream, p, nee, tex);
}
