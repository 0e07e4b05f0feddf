// Whole-path tracer of small scenes for one NVIDIA Hopper card (sm_90a).
//
// Replaces the TPU kernel ray_tracer_2_tpu/kernels/pallas_spheres.py
// (render_spheres_pallas -> _make_kernel, pallas_call at :758): scenes of
// spheres plus at most 64 world-baked triangles, no textures (balls, metal,
// random_balls, room). On the TPU every ray of an (8, 128) tile ran in
// lockstep: spheres streamed through sublane chunks, winner fields came out
// of a one-hot MXU product, and a path that ended kept riding its tile as a
// masked no-op until the whole block died. Here one thread owns one pixel,
// runs its rpp x (bounces + 1) segments itself and stops when its path
// ends, so none of that machinery exists.
//
// What bounds it on this card: arithmetic. Every segment tests every
// sphere (485 in random_balls, ~20 flops each) and every triangle, and the
// winner's material row is one 192-byte read. The sphere and triangle
// tables are staged once per block in shared memory, where all threads of
// a warp read the same word at the same time (a broadcast); the field
// table is read through the read-only cache. Divergence across path
// lengths and between the glass and diffuse branches is not addressed in
// this first form, which is written to be right and to match the plain
// PyTorch version (kernels/spheres.py render_spheres_plain) operation for
// operation: compiled with --fmad=false, every sum evaluated in the order
// the plain version writes it, min/max propagating NaN like
// torch.minimum/maximum, normalisation as v * (1 / sqrt(v.v)).
//
// Semantics per pixel (reference kernel, scene class pallas_spheres.eligible):
//   seed = pixel_id + |frames| * 719393
//   for each of rpp samples: two disk draws (defocus, diverge) and the
//   camera ray; up to bounces+1 segments of {closest sphere (lowest id on
//   ties), closest triangle, sphere wins equal distances, sky on a miss,
//   glass or diffuse/specular branch, Russian roulette}.
//   out[pixel] = (sum over samples) * inv_rpp; every started segment counts.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kInf = 1.7014118e38f;  // 2^127, the reference's INF
constexpr int kThreads = 128;
constexpr int kMaxSpheres = 2047;      // kernels/spheres.py MAX_SPHERES
constexpr int kMaxTris = 64;           // kernels/spheres.py MAX_TRIS
constexpr int kSphCols = 8;            // cx cy cz r K pad
constexpr int kSphStaged = 5;          // cx cy cz r K
constexpr int kTriCols = 16;           // v0 e1 e2 gn cull pad
constexpr int kTriStaged = 13;         // v0 e1 e2 gn cull
constexpr int kFieldCols = 48;
constexpr int kFCentre = 32;           // sphere centre (3), radius
constexpr int kFN0 = 36;               // triangle world normals n0 n1 n2
constexpr float kGlass = 1.0f;

// cam layout (kernels/spheres.py camera_vector): cam[:3,:3] row-major,
// origin, view_params, defocus / width, diverge / width, height
constexpr int kCamOrigin = 9;
constexpr int kCamView = 12;
constexpr int kCamDefocus = 15;
constexpr int kCamDiverge = 16;
constexpr int kCamHeight = 17;
constexpr int kCam = 18;

struct Params {
  const float* spheres;
  const float* tris;
  const float* fields;
  const float* cam;
  float* out;
  unsigned long long* segments;
  int n_spheres, n_tris, fast, width, row_start, total, bounces, rpp, skybox;
  uint32_t frame_seed;  // (|frames| * 719393) mod 2^32
  float inv_rpp;        // float32(1 / rpp)
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
// the reference kernel's _norm3: v * (1 / sqrt(v.v))
__device__ __forceinline__ void norm3(float v[3]) {
  float inv = 1.0f / sqrtf(dot3(v, v));
  v[0] = v[0] * inv; v[1] = v[1] * inv; v[2] = v[2] * inv;
}
__device__ __forceinline__ void rand_direction(uint32_t& seed, float d[3]) {
  d[0] = rand_normal(seed);
  d[1] = rand_normal(seed);
  d[2] = rand_normal(seed);
  norm3(d);
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

// environment_light (ray_tracer.wgsl:214-221; the reference kernel's
// env_light sums the sun term as (dx 0.1 + dy 1.0) + dz 0.1, as here)
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
spheres_kernel(Params p) {
  extern __shared__ float s_tab[];  // spheres (S x 5), then tris (T x 13)
  __shared__ float s_cam[kCam];
  __shared__ unsigned long long s_warp[kThreads / 32];
  float* s_sph = s_tab;
  float* s_tri = s_tab + p.n_spheres * kSphStaged;
  for (int i = threadIdx.x; i < p.n_spheres * kSphStaged; i += blockDim.x)
    s_sph[i] = p.spheres[(i / kSphStaged) * kSphCols + i % kSphStaged];
  for (int i = threadIdx.x; i < p.n_tris * kTriStaged; i += blockDim.x)
    s_tri[i] = p.tris[(i / kTriStaged) * kTriCols + i % kTriStaged];
  for (int i = threadIdx.x; i < kCam; i += blockDim.x) s_cam[i] = p.cam[i];
  __syncthreads();

  const float* cam = s_cam;
  int pid = blockIdx.x * blockDim.x + threadIdx.x;
  unsigned long long segs = 0;

  if (pid < p.total) {
    int xi = pid % p.width;
    int yi = p.row_start + pid / p.width;
    uint32_t seed = (uint32_t)yi * (uint32_t)p.width + (uint32_t)xi +
                    p.frame_seed;
    float w1 = fmaxf((float)p.width - 1.0f, 1.0f);
    float h1 = fmaxf(cam[kCamHeight] - 1.0f, 1.0f);
    float lfx = ((float)xi / w1 - 0.5f) * cam[kCamView];
    float lfy = ((float)yi / h1 - 0.5f) * cam[kCamView + 1];
    float f[3];
    for (int r = 0; r < 3; ++r)
      f[r] = ((cam[3 * r] * lfx + cam[3 * r + 1] * lfy) +
              cam[3 * r + 2] * cam[kCamView + 2]) + cam[kCamOrigin + r];
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float inc[4] = {0.0f, 0.0f, 0.0f, 0.0f};

    for (int s = 0; s < p.rpp; ++s) {
      // ---- sample start (wgsl:487-497): defocus disk, then diverge disk
      float o[3], d[3], tr[4], a, b;
      rand_disk(seed, a, b);
      float jx = a * cam[kCamDefocus], jy = b * cam[kCamDefocus];
      for (int r = 0; r < 3; ++r)
        o[r] = (cam[kCamOrigin + r] + cam[3 * r] * jx) + cam[3 * r + 1] * jy;
      rand_disk(seed, a, b);
      float vx = a * cam[kCamDiverge], vy = b * cam[kCamDiverge];
      for (int r = 0; r < 3; ++r)
        d[r] = ((f[r] + cam[3 * r] * vx) + cam[3 * r + 1] * vy) - o[r];
      norm3(d);
      for (int c = 0; c < 4; ++c) {
        acc[c] = acc[c] + inc[c];
        inc[c] = 0.0f;
        tr[c] = 1.0f;
      }

      for (int bounce = 0; bounce <= p.bounces; ++bounce) {
        ++segs;
        // ---- closest sphere, lowest id on equal distance
        float sd = kInf;
        int sid = -1;
        bool sins = false;
        if (p.n_spheres > 0) {
          float aq = dot3(d, d);
          if (p.fast) {  // ray_sphere_fast: shared terms, one 1/a per ray
            float inv_a = 1.0f / aq;
            float oo = dot3(o, o), od = dot3(o, d);
            for (int k = 0; k < p.n_spheres; ++k) {
              const float* sp = s_sph + k * kSphStaged;
              float cd = (sp[0] * d[0] + sp[1] * d[1]) + sp[2] * d[2];
              float co = (sp[0] * o[0] + sp[1] * o[1]) + sp[2] * o[2];
              float h = od - cd;
              float cq = (oo - 2.0f * co) + sp[4];
              float disc = h * h - aq * cq;
              float sq = sqrtf(nan_max(disc, 0.0f));
              float dn = nan_max((-h - sq) * inv_a, 0.0f);
              float df = (-h + sq) * inv_a;
              bool inside = dn == 0.0f;
              bool hit = (disc >= 0.0f) && (df >= 0.001f);
              float dst = hit ? (inside ? df : dn) : kInf;
              if (dst < sd) {
                sd = dst;
                sid = k;
                sins = inside;
              }
            }
          } else {  // ray_sphere: the reference-order quadratic
            for (int k = 0; k < p.n_spheres; ++k) {
              const float* sp = s_sph + k * kSphStaged;
              float oc[3] = {o[0] - sp[0], o[1] - sp[1], o[2] - sp[2]};
              float bq = 2.0f * dot3(oc, d);
              float cq = dot3(oc, oc) - sp[3] * sp[3];
              float disc = bq * bq - (4.0f * aq) * cq;
              float sq = sqrtf(nan_max(disc, 0.0f));
              float dn = nan_max((-bq - sq) / (2.0f * aq), 0.0f);
              float df = (-bq + sq) / (2.0f * aq);
              bool inside = dn == 0.0f;
              bool hit = (disc >= 0.0f) && (df >= 0.001f);
              float dst = hit ? (inside ? df : dn) : kInf;
              if (dst < sd) {
                sd = dst;
                sid = k;
                sins = inside;
              }
            }
          }
        }
        // ---- closest world-baked triangle (Möller–Trumbore with the
        // precomputed geometric normal), lowest id on equal distance
        float td = kInf, tu = 0.0f, tv = 0.0f, tdet = 0.0f;
        int tid = -1;
        for (int t = 0; t < p.n_tris; ++t) {
          const float* g = s_tri + t * kTriStaged;
          float det = -((d[0] * g[9] + d[1] * g[10]) + d[2] * g[11]);
          bool cull = g[12] > 0.5f;
          bool keep = cull ? (det >= 1e-8f) : (fabsf(det) >= 1e-8f);
          float inv = 1.0f / (keep ? det : 1.0f);
          float aox = o[0] - g[0], aoy = o[1] - g[1], aoz = o[2] - g[2];
          float daox = aoy * d[2] - aoz * d[1];
          float daoy = aoz * d[0] - aox * d[2];
          float daoz = aox * d[1] - aoy * d[0];
          float dst = ((aox * g[9] + aoy * g[10]) + aoz * g[11]) * inv;
          float u = ((g[6] * daox + g[7] * daoy) + g[8] * daoz) * inv;
          float v = -((g[3] * daox + g[4] * daoy) + g[5] * daoz) * inv;
          float w = (1.0f - u) - v;
          bool hit = keep && dst > 1e-5f && u >= 0.0f && v >= 0.0f &&
                     w >= 0.0f;
          float dstw = hit ? dst : kInf;
          if (dstw < td) {
            td = dstw;
            tid = t;
            tu = u;
            tv = v;
            tdet = det;
          }
        }
        bool tri_win = td < sd;  // equal distance: the sphere
        float dist = tri_win ? td : sd;

        if (!(dist < kInf)) {  // ---- miss: sky, and the path ends
          if (p.skybox) {
            float env[4];
            environment_light(d, env);
            for (int c = 0; c < 4; ++c) inc[c] = inc[c] + tr[c] * env[c];
          }
          break;
        }
        const float* F = p.fields +
            (size_t)(tri_win ? p.n_spheres + tid : sid) * kFieldCols;
        bool backface = tri_win ? (tdet < 0.0f) : sins;
        float hp[3], n[3];
        for (int r = 0; r < 3; ++r) hp[r] = o[r] + d[r] * dist;
        if (tri_win) {
          float wb = (1.0f - tu) - tv;
          float sg = tdet < 0.0f ? -1.0f : 1.0f;
          for (int r = 0; r < 3; ++r)
            n[r] = ((__ldg(F + kFN0 + r) * wb + __ldg(F + kFN0 + 3 + r) * tu) +
                    __ldg(F + kFN0 + 6 + r) * tv) * sg;
          norm3(n);
        } else {
          for (int r = 0; r < 3; ++r) n[r] = hp[r] - __ldg(F + kFCentre + r);
          norm3(n);
          float flip = backface ? -1.0f : 1.0f;
          for (int r = 0; r < 3; ++r) n[r] = n[r] * flip;
        }
        float m_spec = __ldg(F + 19), m_smooth = __ldg(F + 18);
        float ddn = dot3(d, n);
        float rf[3];
        for (int r = 0; r < 3; ++r) rf[r] = d[r] - (2.0f * ddn) * n[r];
        float ntr[4], nd[3], no[3];

        if (__ldg(F + 21) == kGlass) {  // ---- glass (wgsl:414-436)
          float abs_k = __ldg(F + 16), m_ior = __ldg(F + 20);
          for (int c = 0; c < 3; ++c)
            ntr[c] = backface
                ? tr[c] * expf(((-dist) * __ldg(F + 12 + c)) * abs_k) : tr[c];
          ntr[3] = backface ? 1.0f : tr[3];
          float ior = backface ? m_ior : 1.0f / m_ior;
          float kk = 1.0f - (ior * ior) * (1.0f - ddn * ddn);
          float kr = sqrtf(nan_max(kk, 0.0f));
          float cos_t = nan_min(-ddn, 1.0f);
          float sin_t = sqrtf(nan_max(1.0f - cos_t * cos_t, 0.0f));
          bool cannot = ior * sin_t > 1.0f;
          bool follow = true;
          if (!cannot) {
            float r_refl = rand01(seed);
            follow = reflectance(cos_t, ior) > r_refl;
          }
          float g[3], dfd[3];
          rand_direction(seed, g);
          for (int r = 0; r < 3; ++r) dfd[r] = n[r] + g[r];
          norm3(dfd);
          if (follow) {
            for (int r = 0; r < 3; ++r)
              nd[r] = dfd[r] + (rf[r] - dfd[r]) * m_spec;
          } else {
            for (int r = 0; r < 3; ++r) {
              float rr = kk >= 0.0f
                  ? ior * d[r] - (ior * ddn + kr) * n[r] : 0.0f;
              nd[r] = -dfd[r] + (rr + dfd[r]) * m_smooth;
            }
          }
          norm3(nd);
          float gs = sign_of(dot3(n, nd));
          for (int r = 0; r < 3; ++r) no[r] = hp[r] + (1e-4f * n[r]) * gs;
        } else {  // ---- diffuse / specular (wgsl:437-459)
          float r_spec = rand01(seed);
          bool is_spec = m_spec >= r_spec;
          float u[3];
          rand_direction(seed, u);
          float hemi = sign_of(dot3(n, u));
          if (hemi == 0.0f) hemi = 1.0f;
          float mix = m_smooth * (is_spec ? 1.0f : 0.0f);
          for (int r = 0; r < 3; ++r) {
            float hd = u[r] * hemi;
            nd[r] = hd + (rf[r] - hd) * mix;
          }
          norm3(nd);
          float emis_k = __ldg(F + 17);
          for (int c = 0; c < 4; ++c) {
            inc[c] = inc[c] + (__ldg(F + 4 + c) * emis_k) * tr[c];
            ntr[c] = tr[c] * __ldg(F + (is_spec ? 8 : 0) + c);
          }
          for (int r = 0; r < 3; ++r) no[r] = hp[r];
        }
        // ---- Russian roulette
        float pr = nan_max(ntr[0], nan_max(ntr[1], ntr[2]));
        float r_rr = rand01(seed);
        float pdiv = pr > 0.0f ? pr : 1.0f;
        for (int c = 0; c < 4; ++c) tr[c] = ntr[c] / pdiv;
        for (int r = 0; r < 3; ++r) {
          o[r] = no[r];
          d[r] = nd[r];
        }
        if (!(r_rr < pr)) break;
      }
    }
    float* out = p.out + (size_t)pid * 4;
    for (int c = 0; c < 4; ++c) out[c] = (acc[c] + inc[c]) * p.inv_rpp;
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
extern "C" int rt2_render_spheres(
    const float* spheres, const float* tris, const float* fields,
    const float* cam, int n_spheres, int n_tris, int fast, int width,
    int row_start, int rows, int bounces, int rpp, int skybox,
    unsigned int frame_seed, float inv_rpp, float* out,
    unsigned long long* segments, void* stream) {
  if (n_spheres < 0 || n_spheres > kMaxSpheres || n_tris < 0 ||
      n_tris > kMaxTris || rpp < 1 || bounces < 0)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.spheres = spheres;
  p.tris = tris;
  p.fields = fields;
  p.cam = cam;
  p.out = out;
  p.segments = segments;
  p.n_spheres = n_spheres;
  p.n_tris = n_tris;
  p.fast = fast;
  p.width = width;
  p.row_start = row_start;
  p.total = rows * width;
  p.bounces = bounces;
  p.rpp = rpp;
  p.skybox = skybox;
  p.frame_seed = frame_seed;
  p.inv_rpp = inv_rpp;
  size_t smem = (size_t)(n_spheres * kSphStaged + n_tris * kTriStaged) *
                sizeof(float);
  int blocks = (p.total + kThreads - 1) / kThreads;
  if (blocks > 0)
    spheres_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
