// The diffuse branch's mixture sample of one lane (ray_color,
// main.rs:263-266), shared by the kernels that compute it: mis_sample.cu
// (the sample alone) and vertex.cu (the whole vertex after its closest
// hit).  A cosine-weighted direction about the normal, a light sample (a
// uniform pick over the lights list, then the sphere cone or the rect
// point), a 50/50 pick between the two, and the mixture's pdf
// 0.5 * lights_pdf + 0.5 * cos_pdf (the cosine lobe and its pdf alone
// without lights).  Plain version: raytracer2022_tpu_torch/ops/mis.py
// (mis_sample_plain).
//
// The arithmetic is the plain version's, operation for operation, in the
// same precision: float32 everywhere except the sphere-light hit test,
// which is ops/bvh8.py::sphere_roots's quadratic in double.  Built
// without fast math and with -fmad=false (cuda_build.py): sinf, cosf,
// sqrtf and divisions are IEEE, and an origin inside a light sphere gives
// the NaN pdf that the integrator's pdf test kills.  A division by a
// Python scalar is a product with its float reciprocal, as PyTorch
// computes it on the card.
//
// Layouts: the variates u f32[k, n] (rows 0-1 the cosine lobe, 2 the
// 50/50 pick, 3-4 the picked light's pair, 5 the light pick when
// n_lights > 1; k = 2 without lights); params f32[16, n_prims]; kind
// i32[n_prims]; lights i32[n_lights] (prim ids, each a SPHERE or RECT).
// The lights list is copied once per block into shared memory
// (load_light_table), where every lane reads it.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int SPHERE = 0;  // scene/types.py; every other light of the table is a RECT
constexpr int LIGHT_WORDS = 8;  // kind, then params rows 0-5 (and one spare)
constexpr float PI_F = 3.14159265358979323846f;
constexpr float TWO_PI_F = 6.28318530717958647692f;  // (float)(2.0 * math.pi)
constexpr float INV_PI_F = 1.0f / PI_F;  // x / math.pi on the card
constexpr float T_MIN = 1e-3f;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ float comp(const V3& v, int axis) { return axis == 0 ? v.x : (axis == 1 ? v.y : v.z); }

__device__ __forceinline__ float dot3(const V3& a, const V3& b) { return a.x * b.x + a.y * b.y + a.z * b.z; }

// vecmath.to_unit: a * (1 / sqrt(a . a))
__device__ __forceinline__ V3 unit(const V3& a) {
  const float inv = 1.0f / sqrtf(dot3(a, a));
  return {a.x * inv, a.y * inv, a.z * inv};
}

__device__ __forceinline__ V3 cross(const V3& a, const V3& b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

// vecmath.onb_from_w(n), then onb_local(u, v, w, l)
__device__ __forceinline__ V3 about(const V3& n, const V3& l) {
  const V3 w = unit(n);
  const bool use_y = fabsf(w.x) > 0.9f;
  const V3 a = {use_y ? 0.0f : 1.0f, use_y ? 1.0f : 0.0f, 0.0f};
  const V3 v = unit(cross(w, a));
  const V3 u = cross(w, v);
  return {u.x * l.x + v.x * l.y + w.x * l.z, u.y * l.x + v.y * l.y + w.y * l.z, u.z * l.x + v.z * l.y + w.z * l.z};
}

// sampling.cosine_local
__device__ __forceinline__ V3 cosine_local(float r1, float r2) {
  const float z = sqrtf(1.0f - r2);
  const float phi = TWO_PI_F * r1;
  const float sq = sqrtf(r2);
  return {cosf(phi) * sq, sinf(phi) * sq, z};
}

// lights.light_directions of one light (lt: its row of the table)
__device__ __forceinline__ V3 light_direction(const float* lt, const V3& p, float ua, float ub) {
  if ((int)lt[0] == SPHERE) {
    // sampling.sphere_cone_local in the frame about the center
    const V3 dir = {lt[1] - p.x, lt[2] - p.y, lt[3] - p.z};
    const float r = lt[4];
    const float rel = 1.0f - r * r / dot3(dir, dir);
    const float cos_max = rel > 0.0f ? sqrtf(rel) : 0.0f;
    const float z = 1.0f + ub * (cos_max - 1.0f);
    const float phi = TWO_PI_F * ua;
    const float zz = 1.0f - z * z;
    const float s = zz > 0.0f ? sqrtf(zz) : 0.0f;
    return about(dir, {cosf(phi) * s, sinf(phi) * s, z});
  }
  // the rect's point: (k, a, b), (a, k, b) or (a, b, k) by its constant axis
  const float a = lt[1] + ua * (lt[2] - lt[1]);
  const float b = lt[3] + ub * (lt[4] - lt[3]);
  const float k = lt[5];
  const int ka = (int)lt[6];
  const V3 q = ka == 0 ? V3{k, a, b} : (ka == 1 ? V3{a, k, b} : V3{a, b, k});
  return {q.x - p.x, q.y - p.y, q.z - p.z};
}

// lights_pdf's sphere term: 1 / solid angle where the ray from p along d
// hits the sphere (intersect._sphere_t on bvh8.sphere_roots), else 0
__device__ __forceinline__ float sphere_pdf(const float* lt, const V3& p, const V3& d) {
  const float cx = lt[1], cy = lt[2], cz = lt[3], r = lt[4];
  const double ocx = (double)(p.x - cx), ocy = (double)(p.y - cy), ocz = (double)(p.z - cz);
  const double dx = d.x, dy = d.y, dz = d.z, rr = r;
  const double a = dx * dx + dy * dy + dz * dz;
  const double hb = ocx * dx + ocy * dy + ocz * dz;
  const double cc = ocx * ocx + ocy * ocy + ocz * ocz - rr * rr;
  const double disc = hb * hb - a * cc;
  const bool ok = disc >= 0.0;
  const double sq = sqrt(ok ? disc : 1.0);
  const double as = a == 0.0 ? 1.0 : a;
  const float root1 = (float)((-hb - sq) / as), root2 = (float)((-hb + sq) / as);
  const bool v1 = ok && root1 >= T_MIN && root1 <= INFINITY;
  const bool v2 = ok && root2 >= T_MIN && root2 <= INFINITY;
  const float t = v1 ? root1 : (v2 ? root2 : INFINITY);
  if (!isfinite(t)) return 0.0f;
  const V3 e = {cx - p.x, cy - p.y, cz - p.z};
  const float rel = 1.0f - r * r / dot3(e, e);
  const float cos_max = rel > 0.0f ? sqrtf(rel) : NAN;  // inside the sphere: NaN, as the reference
  return 1.0f / (TWO_PI_F * (1.0f - cos_max));
}

// lights_pdf's rect term: dist^2 / (cos * area) where the ray hits the
// rect (intersect._rect_t) and cos * area > 0, else 0
__device__ __forceinline__ float rect_pdf(const float* lt, const V3& p, const V3& d) {
  const float a0 = lt[1], a1 = lt[2], b0 = lt[3], b1 = lt[4], k = lt[5];
  const int ka = (int)lt[6];
  const int a_axis = ka == 0 ? 1 : 0, b_axis = ka == 2 ? 1 : 2;
  const float dk = comp(d, ka);
  const float t = (k - comp(p, ka)) / (dk == 0.0f ? 1.0f : dk);
  const float av = comp(p, a_axis) + t * comp(d, a_axis);
  const float bv = comp(p, b_axis) + t * comp(d, b_axis);
  const bool valid = dk != 0.0f && t >= T_MIN && t <= INFINITY && av >= a0 && av <= a1 && bv >= b0 && bv <= b1;
  if (!valid || !isfinite(t)) return 0.0f;
  const float area = (a1 - a0) * (b1 - b0);
  const float vlen_sqr = dot3(d, d);
  const float dist_sqr = t * t * vlen_sqr;
  const float cosv = fabsf(dk) / sqrtf(vlen_sqr);
  const float denom = cosv * area;
  return denom > 0.0f ? dist_sqr / denom : 0.0f;
}

// sampling.cos_pdf_value about the unit normal w
__device__ __forceinline__ float cos_pdf(const V3& d, const V3& w) {
  const float c = dot3(unit(d), w);
  return c <= 0.0f ? 0.0f : c * INV_PI_F;
}

// The lights list into a block's shared memory: n_lights rows of
// LIGHT_WORDS floats (kind, params rows 0-5, a spare).  The caller
// synchronises the block before the first lane reads it.
__device__ __forceinline__ void load_light_table(float* table, const float* __restrict__ params, long long n_prims,
                                                 const int* __restrict__ kind, const int* __restrict__ lights,
                                                 int n_lights) {
  for (int j = threadIdx.x; j < n_lights * LIGHT_WORDS; j += blockDim.x) {
    const int l = j / LIGHT_WORDS, c = j % LIGHT_WORDS;
    const long long id = lights[l];
    table[j] = c == 0 ? (float)kind[id] : (c <= 6 ? params[(c - 1) * n_prims + id] : 0.0f);
  }
}

// Lane i's mixture sample at point pt with normal nr, of the variates
// u[r * n + i] -> the direction; its pdf into *pdf.
__device__ __forceinline__ V3 mis_lane(const float* table, int n_lights, const V3& pt, const V3& nr,
                                       const float* __restrict__ u, long long n, long long i, float* pdf) {
  const V3 cos_dir = about(nr, cosine_local(u[i], u[n + i]));
  const V3 w = unit(nr);
  if (n_lights == 0) {
    *pdf = cos_pdf(cos_dir, w);
    return cos_dir;
  }
  V3 d = cos_dir;
  int pick = 0;
  if (n_lights > 1) pick = min(max((int)floorf(u[5 * n + i] * (float)n_lights), 0), n_lights - 1);
  if (u[2 * n + i] < 0.5f) d = light_direction(table + pick * LIGHT_WORDS, pt, u[3 * n + i], u[4 * n + i]);
  // lights_pdf: the sphere lights' terms summed, then the rects', over the list
  float sph = 0.0f, rect = 0.0f;
  for (int l = 0; l < n_lights; ++l) {
    const float* lt = table + l * LIGHT_WORDS;
    if ((int)lt[0] == SPHERE)
      sph += sphere_pdf(lt, pt, d);
    else
      rect += rect_pdf(lt, pt, d);
  }
  const float lights_pdf = (sph + rect) * (1.0f / (float)n_lights);
  *pdf = 0.5f * lights_pdf + 0.5f * cos_pdf(d, w);
  return d;
}

}  // namespace
