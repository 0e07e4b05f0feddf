// Persistent wide-BVH path tracer for one NVIDIA Hopper card (sm_90a).
//
// Replaces the TPU kernel ray_tracer_2_tpu/kernels/pallas_boundary.py
// (make_fused_boundary -> boundary, pallas_call at :775) TOGETHER with the
// XLA traversal loop it sat beside (ray_tracer_2_tpu/kernels/megakernel.py
// traversal_step :389, wide_eval :337, unpack_child_aabbs :304,
// slab_blocked :318, _advance_impl :628). On the TPU the lanes ran in
// lockstep, so pixels were handed out through claim cumsums, a completion
// log and an end-of-frame sort; here one thread owns one pixel, walks all
// of its samples and segments itself and writes its own result, so none
// of that machinery exists.
//
// What bounds it on this card: the dependent loads of the traversal (each
// wide row visit is a 512-byte row of `wide_rows` whose address depends on
// the previous row; the hit triangle's attribute row and material row
// follow) and divergence across the warp, whose threads trace paths of
// different lengths. This first form does nothing about either beyond
// reading rows through the read-only cache; it is written to be right and
// to match the plain PyTorch version (kernels/megakernel.py render_plain)
// operation for operation: compiled with --fmad=false, every sum is
// evaluated in the order the plain version writes it, and min/max
// propagate NaN as torch.minimum/maximum do.
//
// Semantics per pixel (reference kernels/megakernel.py render_persistent
// with the fused boundary, scene class pallas_boundary.eligible):
//   seed = pixel_id + |frames| * 719393
//   for each of rpp samples: camera ray, then up to bounces+1 segments of
//   {dense sphere prepass, wide-BVH traversal of the single instance in
//   model space, merge, shade}; the sample's radiance is banked.
//   out[pixel] = sum / rpp; every started segment counts once.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kInf = 1.7014118e38f;  // 2^127, the reference's INF
constexpr int kRow = 128;              // floats per wide / attr row
constexpr int kMaxStack = 16;          // resume-stack capacity (>= depth+2)
constexpr int kMaxSpheres = 32;        // dense prepass capacity
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

// scal layout: cam[:3,:4] row-major, view_params, defocus, diverge,
// w2m[:3,:4], m2w[:3,:4] of the single instance
constexpr int kScCam = 0;
constexpr int kScView = 12;
constexpr int kScDefocus = 15;
constexpr int kScDiverge = 16;
constexpr int kScW2m = 17;
constexpr int kScM2w = 29;
constexpr int kScal = 41;
constexpr int kSphStride = 5;  // cx cy cz radius mat

struct Params {
  const float* wide_rows;
  const float* tri_attr;
  const float* mat_rows;
  const float* spheres;
  const float* scal;
  float* out;
  unsigned long long* segments;
  int n_spheres, root, width, height, row_start, total;
  int bounces, rpp, skybox, antialias;
  uint32_t frame_seed;  // (|frames| * 719393) mod 2^32
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
__device__ __forceinline__ void rand_hemisphere(const float n[3],
                                                uint32_t& seed, float d[3]) {
  float x = rand_normal(seed);
  float y = rand_normal(seed);
  float z = rand_normal(seed);
  float len = sqrtf((x * x + y * y) + z * z);
  x = x / len; y = y / len; z = z / len;
  float s = (n[0] * x + n[1] * y) + n[2] * z;
  float f = s >= 0.0f ? 1.0f : -1.0f;
  d[0] = f * x; d[1] = f * y; d[2] = f * z;
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

// f16 bit pattern -> f32 by integer rebias (megakernel.py f16_bits_to_f32)
__device__ __forceinline__ float f16_bits(uint32_t b) {
  uint32_t sign = (b & 0x8000u) << 16;
  uint32_t mag = (b & 0x7FFFu) << 13;
  return __uint_as_float(sign | mag) * __uint_as_float(0x77800000u);
}

// One wide row against the ray: hit mask over its k children, the nearest
// hit child (first index on ties) and the least entry distance over the
// other hit children (megakernel.py wide_eval / slab_blocked).
__device__ __forceinline__ void wide_eval(const float* row, const float om[3],
                                          const float inv[3], float limit,
                                          uint32_t& mask, int& c_min,
                                          float& dn2) {
  int k = (int)__ldg(row + kColK);
  mask = 0u;
  float m1 = kInf, m2 = kInf;
  c_min = 0;
  for (int c = 0; c < kArity && c < k; ++c) {
    uint32_t ux = __float_as_uint(__ldg(row + kColAabb + c));
    uint32_t uy = __float_as_uint(__ldg(row + kColAabb + kArity + c));
    uint32_t uz = __float_as_uint(__ldg(row + kColAabb + 2 * kArity + c));
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
  dn2 = m2;
}

struct Hit {
  float dst, u, v, det;
  int tri, mat;
};

// Closest hit of the model-space ray in the instance's wide BVH, pruned at
// `limit` (megakernel.py wide_enter + traversal_step): enter the nearest hit
// child, push the other hits as (base, mask, least entry distance), pop the
// deepest entry still closer than the best hit, lowest child index first.
__device__ void traverse(const float* __restrict__ wide_rows, int root,
                         const float om[3], const float dm[3], float limit,
                         Hit& h) {
  float inv[3] = {1.0f / dm[0], 1.0f / dm[1], 1.0f / dm[2]};
  uint32_t sb[kMaxStack], sm[kMaxStack];
  float sd[kMaxStack];
  int sp = 0;
  h.dst = limit;
  h.tri = -1;
  h.u = h.v = h.det = 0.0f;
  h.mat = 0;
  int cur = root;
  bool root_visit = true;
  while (cur >= 0) {
    const float* row = wide_rows + (size_t)cur * kRow;
    bool finished;
    if (!root_visit && __ldg(row + kColCount) > 0.5f) {
      // leaf: 8 triangles, blocked geometry with precomputed edges/normal
      const float* g = row + kColGeo;
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
      finished = true;
    } else {
      uint32_t mask;
      int c_min;
      float dn2;
      wide_eval(row, om, inv, h.dst, mask, c_min, dn2);
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

__global__ void __launch_bounds__(kThreads)
render_kernel(Params p) {
  __shared__ float s_scal[kScal];
  __shared__ float s_sph[kMaxSpheres * kSphStride];
  __shared__ unsigned long long s_warp[kThreads / 32];
  for (int i = threadIdx.x; i < kScal; i += blockDim.x) s_scal[i] = p.scal[i];
  for (int i = threadIdx.x; i < p.n_spheres * kSphStride; i += blockDim.x)
    s_sph[i] = p.spheres[i];
  __syncthreads();

  const float* sc = s_scal;
  const float* cam = sc + kScCam;
  const float* w2m = sc + kScW2m;
  const float* m2w = sc + kScM2w;
  int pid = blockIdx.x * blockDim.x + threadIdx.x;
  unsigned long long segs = 0;

  if (pid < p.total) {
    int px = pid % p.width;
    int py = p.row_start + pid / p.width;
    uint32_t seed = (uint32_t)(py * p.width + px) + p.frame_seed;
    float w1 = (float)max(p.width - 1, 1);
    float h1 = (float)max(p.height - 1, 1);
    float inv_w = 1.0f / (float)p.width;
    float vp0 = sc[kScView], vp1 = sc[kScView + 1], vp2 = sc[kScView + 2];
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};

    for (int s = 0; s < p.rpp; ++s) {
      // ---- camera ray (megakernel.py camera_ray; ray_tracer.wgsl:473-500)
      float u0 = (float)px / w1, u1 = (float)py / h1;
      float lf0 = (u0 - 0.5f) * vp0, lf1 = (u1 - 0.5f) * vp1;
      float fp[3], o[3], d[3];
      for (int r = 0; r < 3; ++r)
        fp[r] = ((lf0 * cam[4 * r] + lf1 * cam[4 * r + 1]) +
                 vp2 * cam[4 * r + 2]) + cam[4 * r + 3];
      if (p.antialias) {
        float ju = rand01(seed);
        float jv = rand01(seed);
        float du = ((ju - 0.5f) * vp0) / w1;
        float dv = ((jv - 0.5f) * vp1) / h1;
        for (int r = 0; r < 3; ++r)
          fp[r] = (fp[r] + cam[4 * r] * du) + cam[4 * r + 1] * dv;
      }
      float a, b;
      rand_disk(seed, a, b);
      float dj0 = (a * sc[kScDefocus]) * inv_w;
      float dj1 = (b * sc[kScDefocus]) * inv_w;
      for (int r = 0; r < 3; ++r)
        o[r] = (cam[4 * r + 3] + cam[4 * r] * dj0) + cam[4 * r + 1] * dj1;
      rand_disk(seed, a, b);
      float vj0 = (a * sc[kScDiverge]) * inv_w;
      float vj1 = (b * sc[kScDiverge]) * inv_w;
      for (int r = 0; r < 3; ++r)
        d[r] = ((fp[r] + cam[4 * r] * vj0) + cam[4 * r + 1] * vj1) - o[r];
      normalize3(d);

      float trans[4] = {1.0f, 1.0f, 1.0f, 1.0f};
      float inc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int bounce = 0; bounce <= p.bounces; ++bounce) {
        ++segs;
        // ---- dense sphere prepass (intersect.ray_sphere, first index on
        // equal distance like argmin)
        float seg_dst = kInf;
        int sidx = 0;
        bool s_in = false, s_hit = false;
        float a_q = dot3(d, d);
        for (int si = 0; si < p.n_spheres; ++si) {
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
          if (ds < seg_dst) {
            seg_dst = ds;
            sidx = si;
            s_in = is_in;
            s_hit = hit;
          }
        }
        int stri = -1, smat = 0;
        float point[3] = {0.0f, 0.0f, 0.0f}, normal[3] = {0.0f, 0.0f, 0.0f};
        if (s_hit) {
          const float* sp = s_sph + sidx * kSphStride;
          stri = -2;
          smat = (int)sp[4];
          for (int r = 0; r < 3; ++r) point[r] = o[r] + d[r] * seg_dst;
          float n[3] = {point[0] - sp[0], point[1] - sp[1], point[2] - sp[2]};
          normalize3(n);
          for (int r = 0; r < 3; ++r) normal[r] = s_in ? -n[r] : n[r];
        } else {
          seg_dst = kInf;
        }

        // ---- the instance: model-space ray, pruning limit seeded from the
        // prepass (megakernel.py start_segments), traversal, merge
        float om[3], dm[3], wv[3];
        apply3x3(w2m, o, om);
        for (int r = 0; r < 3; ++r) om[r] = om[r] + w2m[4 * r + 3];
        apply3x3(w2m, d, dm);
        normalize3(dm);
        apply3x3(m2w, dm, wv);
        float slack0 = 8e-6f * (1.0f + sqrtf(dot3(o, o)));
        float limit0 = (seg_dst * 1.000004f + slack0) / sqrtf(dot3(wv, wv));
        Hit h;
        traverse(p.wide_rows, p.root, om, dm, limit0, h);
        float u = 0.0f, v = 0.0f, det = 0.0f;
        if (h.tri >= 0) {
          float lh[3], wh[3], dv[3];
          for (int r = 0; r < 3; ++r) lh[r] = om[r] + dm[r] * h.dst;
          apply3x3(m2w, lh, wh);
          for (int r = 0; r < 3; ++r) wh[r] = wh[r] + m2w[4 * r + 3];
          for (int r = 0; r < 3; ++r) dv[r] = wh[r] - o[r];
          float wd = sqrtf(dot3(dv, dv));
          if (wd < seg_dst) {
            seg_dst = wd;
            stri = h.tri;
            smat = h.mat;
            u = h.u;
            v = h.v;
            det = h.det;
            for (int r = 0; r < 3; ++r) point[r] = wh[r];
          }
        }

        // ---- resolve + shade (megakernel.py resolve_and_shade, the
        // diffuse/specular branch; ray_tracer.wgsl:398-471)
        if (stri == -1) {
          if (p.skybox) {
            float env[4];
            environment_light(d, env);
            for (int c = 0; c < 4; ++c) inc[c] = inc[c] + trans[c] * env[c];
          }
          break;
        }
        if (stri >= 0) {
          const float* at = p.tri_attr + (size_t)(stri >> 2) * kRow +
                            (stri & 3) * 32;
          float wb = (1.0f - u) - v;
          float nm[3];
          for (int r = 0; r < 3; ++r)
            nm[r] = (__ldg(at + r) * wb + __ldg(at + 3 + r) * u) +
                    __ldg(at + 6 + r) * v;
          normalize3(nm);
          float sg = det > 0.0f ? 1.0f : (det < 0.0f ? -1.0f : 0.0f);
          for (int r = 0; r < 3; ++r) nm[r] = nm[r] * sg;
          apply3x3(m2w, nm, normal);
          normalize3(normal);
        }
        const float* m = p.mat_rows + (size_t)smat * 32;
        float r_spec = rand01(seed);
        bool is_spec = __ldg(m + 19) >= r_spec;
        float diffuse[3];
        rand_hemisphere(normal, seed, diffuse);
        float idn = 2.0f * dot3(d, normal);
        float tmix = __ldg(m + 18) * (is_spec ? 1.0f : 0.0f);
        float nd[3];
        for (int r = 0; r < 3; ++r) {
          float spec = d[r] - idn * normal[r];
          nd[r] = diffuse[r] + (spec - diffuse[r]) * tmix;
        }
        normalize3(nd);
        float emis = __ldg(m + 17);
        for (int c = 0; c < 4; ++c) {
          inc[c] = inc[c] + (__ldg(m + 4 + c) * emis) * trans[c];
          trans[c] = trans[c] * __ldg(m + (is_spec ? 8 : 0) + c);
        }
        float pr = fmaxf(fmaxf(trans[0], trans[1]), trans[2]);
        float r_rr = rand01(seed);
        bool survive = r_rr < pr;
        float pdiv = pr > 0.0f ? pr : 1.0f;
        for (int c = 0; c < 4; ++c) trans[c] = trans[c] / pdiv;
        for (int r = 0; r < 3; ++r) {
          o[r] = point[r];
          d[r] = nd[r];
        }
        if (!survive) break;
      }
      for (int c = 0; c < 4; ++c) acc[c] = acc[c] + inc[c];
    }
    float rpp = (float)p.rpp;
    float* out = p.out + (size_t)pid * 4;
    for (int c = 0; c < 4; ++c) out[c] = acc[c] / rpp;
  }

  // ---- exact segment count: warp reduce, block reduce, one atomic
  for (int off = 16; off > 0; off >>= 1)
    segs += __shfl_down_sync(0xffffffffu, segs, off);
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = segs;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long sum = 0;
    for (int w = 0; w < kThreads / 32; ++w) sum += s_warp[w];
    atomicAdd(p.segments, sum);
  }
}

}  // namespace

// Launch on `stream`; allocates nothing and does not synchronise. Returns
// cudaGetLastError() (0 = launched).
extern "C" int rt2_render_persistent(
    const float* wide_rows, const float* tri_attr, const float* mat_rows,
    const float* spheres, const float* scal, int n_spheres, int root,
    int width, int height, int row_start, int rows, int bounces, int rpp,
    int skybox, int antialias, unsigned int frame_seed, float* out,
    unsigned long long* segments, void* stream) {
  if (n_spheres < 0 || n_spheres > kMaxSpheres) return (int)cudaErrorInvalidValue;
  Params p;
  p.wide_rows = wide_rows;
  p.tri_attr = tri_attr;
  p.mat_rows = mat_rows;
  p.spheres = spheres;
  p.scal = scal;
  p.out = out;
  p.segments = segments;
  p.n_spheres = n_spheres;
  p.root = root;
  p.width = width;
  p.height = height;
  p.row_start = row_start;
  p.total = rows * width;
  p.bounces = bounces;
  p.rpp = rpp;
  p.skybox = skybox;
  p.antialias = antialias;
  p.frame_seed = frame_seed;
  int blocks = (p.total + kThreads - 1) / kThreads;
  if (blocks > 0)
    render_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
