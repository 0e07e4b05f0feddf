// Device code shared by the megakernel (csrc/megakernel.cu) and the debug
// kernel (csrc/debug.cu): the constants and parameter blocks, the RNG, the
// vector helpers, the wide-row walk `traverse<>` with its `Visits`, the
// segment hit records, the dense sphere prepass and the brute-force groups
// (`segment_prepass`, through csrc/brute.cuh `closest_hit`), the camera ray
// and the texel sampler (`sample_quads`, `sphere_uv`).
//
// Include it inside an anonymous namespace, after <cuda_runtime.h>,
// <stdint.h>, <type_traits> and "brute.cuh". megakernel.cu includes it at
// the place these lines held before they moved here, so its translation unit
// is the one it was: the main path's form is sensitive to text it never
// runs (PERF.md, section 6), so an edit here is timed against its parent
// (`python3 -m ray_tracer_2_tpu_torch.kernel_times`, which also gives each
// form's SASS digest).
//
// RT2_TRACE_LEAF_TRIS, defined before the include (the debug kernel does),
// gives `Visits` a count of the triangles of every triangle leaf visited
// (the debug modes' "triangle tests"); without it the text is the
// megakernel's.
#pragma once

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
  // 1: no child bound of an interior wide row is infinite, so the child-box
  // loop takes no clamps (kernels/megakernel.py finite_boxes; wide_eval)
  int finite_boxes;
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
#ifdef RT2_TRACE_LEAF_TRIS
  uint32_t tris;  // triangles of the triangle leaves visited
#endif
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

// nan_min / nan_max in one instruction each (PTX min.NaN / max.NaN, sm_80
// and later), for the slab test. Their NaN is PTX's canonical one
// (0x7fffffff), not nan_min's 0x7fc00000: no NaN leaves the slab test
// (child_eval), while shading, where one can reach a pixel, keeps nan_min.
__device__ __forceinline__ float nan_min1(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
__device__ __forceinline__ float nan_max1(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// A child's f16 pair lo | hi << 16 on one axis as the two floats that the
// integer rebias gives (megakernel.py f16_bits_to_f32: sign and magnitude
// shifted into place, times 2^112). The hardware conversion gives the same
// float for every finite pattern, subnormals and +-0 included; the rebias
// reads an infinity as +-65536, the conversion as +-inf. The packer
// (accel/wide.py _round_out_f16) emits an infinity in a tested child only
// as a lo of -inf or a hi of +inf (a bound beyond 65504, rounded outward),
// and never a NaN pattern, so with kClamp the clamps below give lo and hi
// exactly what the rebias gives. Without it the conversion stands alone,
// which is exact where no such infinity is there to clamp: an empty slot's
// lo of +inf and hi of -inf are what the clamps would leave.
template <bool kClamp>
__device__ __forceinline__ void f16_pair(uint32_t u, float& lo, float& hi) {
  asm("{\n\t.reg .f16 l, h;\n\tmov.b32 {l, h}, %2;\n\t"
      "cvt.f32.f16 %0, l;\n\tcvt.f32.f16 %1, h;\n\t}"
      : "=f"(lo), "=f"(hi) : "r"(u));
  if constexpr (kClamp) {
    lo = fmaxf(lo, -65536.0f);
    hi = fminf(hi, 65536.0f);
  }
}

// One child box (f16 pairs lo | hi << 16 per axis) against the ray: whether
// it is hit (never where `valid` is false: a slot at or past the row's k),
// folded into the row's nearest child and second-least entry distance,
// without a branch. A NaN arises only as 0 * inf (a zero direction
// component, the origin on the child's plane); the min/max pass it on, so
// tf >= tn fails and the child is a miss. No NaN leaves: dn is tn only on a
// hit, else kInf. The nearest child changes only on a strictly smaller dn
// (the first index keeps a tie); m1 <= m2 always holds, so the second-least
// entry is min(m2, max(m1, dn)): m1 where dn displaces it, else min(m2,
// dn). The sign of a zero is never read (tn, tf and dn are only compared),
// so which zero a min or max returns does not matter.
template <bool kClamp>
__device__ __forceinline__ bool child_eval(uint32_t ux, uint32_t uy,
                                           uint32_t uz, int c, bool valid,
                                           const float om[3],
                                           const float inv[3], float limit,
                                           int& c_min, float& m1, float& m2) {
  float lx, hx, ly, hy, lz, hz;
  f16_pair<kClamp>(ux, lx, hx);
  f16_pair<kClamp>(uy, ly, hy);
  f16_pair<kClamp>(uz, lz, hz);
  float t1x = (lx - om[0]) * inv[0];
  float t2x = (hx - om[0]) * inv[0];
  float t1y = (ly - om[1]) * inv[1];
  float t2y = (hy - om[1]) * inv[1];
  float t1z = (lz - om[2]) * inv[2];
  float t2z = (hz - om[2]) * inv[2];
  float tn = nan_max1(nan_max1(nan_min1(t1x, t2x), nan_min1(t1y, t2y)),
                      nan_min1(t1z, t2z));
  float tf = nan_min1(nan_min1(nan_max1(t1x, t2x), nan_max1(t1y, t2y)),
                      nan_max1(t1z, t2z));
  bool hit = valid & (tf >= tn) & (tn < limit) & (tf > 0.0f);
  float dn = hit ? tn : kInf;
  c_min = dn < m1 ? c : c_min;
  m2 = fminf(m2, fmaxf(m1, dn));
  m1 = fminf(m1, dn);
  return hit;
}

// One wide row against the ray: hit mask over its k children, the nearest
// hit child (first index on ties) and the least entry distance over the
// other hit children (megakernel.py wide_eval / slab_blocked). The child
// boxes (x, y and z blocks of 32 words, 64 bytes into the 512-byte row)
// are read four children at a time as 16-byte loads; the children are
// tested one by one in index order, and the four hits go into the mask at
// once. A slot at or past k holds an inverted box of infinities, which the
// slab test reads as a box around everything, a hit: its hit is dropped.
// Returns the children tested.
template <bool kClamp>
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
    uint32_t bits =
        child_eval<kClamp>(__float_as_uint(bx.x), __float_as_uint(by.x),
                           __float_as_uint(bz.x), c, true, om, inv, limit,
                           c_min, m1, m2) ? 1u : 0u;
    bits |= child_eval<kClamp>(__float_as_uint(bx.y), __float_as_uint(by.y),
                               __float_as_uint(bz.y), c + 1, c + 1 < k, om,
                               inv, limit, c_min, m1, m2) ? 2u : 0u;
    bits |= child_eval<kClamp>(__float_as_uint(bx.z), __float_as_uint(by.z),
                               __float_as_uint(bz.z), c + 2, c + 2 < k, om,
                               inv, limit, c_min, m1, m2) ? 4u : 0u;
    bits |= child_eval<kClamp>(__float_as_uint(bx.w), __float_as_uint(by.w),
                               __float_as_uint(bz.w), c + 3, c + 3 < k, om,
                               inv, limit, c_min, m1, m2) ? 8u : 0u;
    mask |= bits << c;
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
// so far in (distance, id) order. traverse<> picks the child-box loop.
template <bool kSpheres, bool kClamp>
__device__ void walk(const float* __restrict__ wide_rows, int root,
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
#ifdef RT2_TRACE_LEAF_TRIS
        vis.tris += (uint32_t)__ldg(row + kColCount);
#endif
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
      vis.boxes += wide_eval<kClamp>(row, om, inv, h.dst, mask, c_min, dn2);
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

// walk<> with the child-box loop that `finite` (Params::finite_boxes, the
// same for the whole launch) allows: without the bound clamps where no
// child bound is infinite. A walk of its own for each loop, rather than a
// choice at every row: with the choice inside the row loop the sphere-BVH
// forms measured 9% slower (PERF.md, section 6).
template <bool kSpheres>
__device__ __forceinline__ void traverse(const float* __restrict__ wide_rows,
                                         int root, const float om[3],
                                         const float dm[3], float limit,
                                         bool finite, Hit& h, Visits& vis) {
  if (finite)
    walk<kSpheres, false>(wide_rows, root, om, dm, limit, h, vis);
  else
    walk<kSpheres, true>(wide_rows, root, om, dm, limit, h, vis);
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
