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
// 80,000 triangles) fit in L2. Box tests are about 85% of that work, and
// they are bound by issued instructions, not by memory: a row's 24 box
// loads are followed by a few thousand instructions a lane, and seven
// warps share each scheduler, so L2's latency is covered even where the
// rows do not fit (PERF.md, section 5). So the box test is written for few
// instructions, each exact against the plain version (csrc/trace.cuh
// child_eval): the NaN-propagating min/max are one min.NaN / max.NaN each,
// and the f16 bounds take the hardware conversion, clamped where the plain
// version's integer rebias reads an infinity as 65536 (and not at all on a
// scene whose child bounds are all finite, as is the rule), with no branch
// in a child's test. What keeps it from
// that bound: the dependent loads of the traversal (each row's address
// comes from the previous row) and divergence, since paths end at
// different bounces. The design answers the second: the grid is as many
// blocks as can be resident
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
// The device code up to the segment prepass and the texel sampler (the
// constants, Params, the RNG, the row walk traverse<>, segment_prepass,
// sample_quads) lives in csrc/trace.cuh, which the debug kernel
// (csrc/debug.cu) shares; it is included below, inside the anonymous
// namespace, at the place those lines held.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "brute.cuh"
#include "claim.cuh"

namespace {

#include "trace.cuh"

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
    traverse<false>(p.wide_rows, (int)in[kInRoot], om, dm, limit,
                    p.finite_boxes != 0, th, vis);
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
    int antialias, int finite_boxes, int spheres_mode, int staged,
    int sphere_root, unsigned int frame_seed, float* out,
    unsigned long long* scratch, unsigned long long* counts, Params& p,
    size_t& smem) {
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
  p.finite_boxes = finite_boxes;
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
// and `brute` must be 16-byte aligned. `finite_boxes` 1 says that no
// interior wide row holds an infinite child bound (kernels/megakernel.py
// finite_boxes): the child-box loop then takes no clamps. Returns
// cudaGetLastError() (0 = launched).
extern "C" int rt2_render_persistent(
    const float* wide_rows, const float* tri_attr, const float* mat_rows,
    const float* spheres, const float* scal, const float* inst,
    const float* brute, int n_spheres, int n_inst, int n_brute, int width,
    int height, int row_start, int rows, int bounces, int rpp, int skybox,
    int antialias, int finite_boxes, int general, int glass,
    int spheres_mode, int staged, int sphere_root, unsigned int frame_seed,
    float* out, unsigned long long* scratch, unsigned long long* counts,
    void* stream) {
  Params p;
  size_t smem;
  cudaError_t err = make_params(
      wide_rows, tri_attr, mat_rows, spheres, scal, inst, brute, n_spheres,
      n_inst, n_brute, width, height, row_start, rows, bounces, rpp, skybox,
      antialias, finite_boxes, spheres_mode, staged, sphere_root, frame_seed,
      out, scratch, counts, p, smem);
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
    int antialias, int finite_boxes, int spheres_mode, int staged,
    int sphere_root, unsigned int frame_seed, const float* lights,
    const float* cdf, int n_lights, int nee_mode, float c_tri, float c_area,
    float* out, unsigned long long* scratch, unsigned long long* counts,
    void* stream) {
  Params p;
  size_t smem;
  cudaError_t err = make_params(
      wide_rows, tri_attr, mat_rows, spheres, scal, inst, brute, n_spheres,
      n_inst, n_brute, width, height, row_start, rows, bounces, rpp, skybox,
      antialias, finite_boxes, spheres_mode, staged, sphere_root, frame_seed,
      out, scratch, counts, p, smem);
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
    int antialias, int finite_boxes, int spheres_mode, int sphere_root,
    unsigned int frame_seed, const float* lights, const float* cdf,
    int n_lights, int nee_mode, float c_tri, float c_area, const int* texels,
    int n_texels, const float* tex_meta, int normal_maps, float* out,
    unsigned long long* scratch, unsigned long long* counts, void* stream) {
  Params p;
  size_t smem;
  cudaError_t err = make_params(
      wide_rows, tri_attr, mat_rows, spheres, scal, inst, brute, n_spheres,
      n_inst, n_brute, width, height, row_start, rows, bounces, rpp, skybox,
      antialias, finite_boxes, spheres_mode, 0, sphere_root, frame_seed, out,
      scratch, counts, p, smem);
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
