// The path vertex after its closest hit, for a whole wavefront in one
// launch (ray_color, main.rs:233-278): per lane the winning primitive's
// texture value (solid, checker, Perlin marble, image, OBJ uv), its
// emission, its material's scatter (lambertian, metal, dielectric,
// diffuse light, isotropic), the diffuse branch's mixture sample
// (mis_sample.cuh, shared with mis_sample.cu), and the update: the
// lane's class (miss, absorb, specular, diffuse, with the pdf test), the
// radiance it adds, its throughput and its next ray.
//
// Replaces no TPU kernel.  The JAX package left this block to XLA, which
// fuses it into a few loops (raytracer2022_tpu/render/integrator.py,
// ops/materials.py, ops/textures.py).  In the port it was a few hundred
// PyTorch operators a vertex (the spans vertex.shading, vertex.sampling
// and vertex.update), each a host dispatch of a small elementwise kernel.
// Wrapper, plain version and launch count:
// raytracer2022_tpu_torch/ops/vertex.py (vertex_tail, vertex_tail_plain,
// LAUNCHES).
//
// What bounds it on an H100: the bytes.  A lane reads its hit record
// (hit, p, normal, front: 26 B), its shading inputs (material kind and
// parameter, texture kind, colour: 24 B), its ray, time, throughput and
// alive flag (29 B) and k + 3 variates, and writes 53 B (radiance, next
// origin, direction, time, throughput, cont); lanes of a textured kind
// read that texture's inputs besides (image: uv, atlas id and size and a
// texel; OBJ uv: its uv pair, the same and a texel; checker: two colours;
// noise: its scale).  At k = 5 that is 164 B a solid lane, 42.8 MB at
// 261,120 lanes, ~13 us at 3.35 TB/s.  The arithmetic is at most a few
// thousand operations a lane (seven Perlin octaves on noise lanes).  The
// design is one thread per lane over a grid-stride loop, loads and stores
// component-leading (p[c * n + i]) so that a warp's accesses coalesce, the
// lights list and, where the scene has noise textures, the Perlin tables
// (perm i32[3, 256], vec f32[3, 256]) copied once per block into shared
// memory, the atlas read from global memory, and nothing written between
// the stages: every intermediate stays in registers.
//
// The arithmetic is the plain version's, operation for operation, in the
// same precision (float32; the sphere light's hit test in double), built
// without fast math and with -fmad=false (cuda_build.py).  Where PyTorch
// computes an operation in a way of its own on the card, the kernel does
// the same: a division by a Python scalar is a product with its float
// reciprocal; clamp, minimum and maximum keep a NaN; a float-to-int cast
// truncates (__float2ll_rz); sign(NaN) is 0; x ** 5 and x ** (1 / 3) are
// powf with a float exponent.
//
// Layouts (n lanes): hit, front, alive, cont u8[n] (torch.bool); p,
// normal, color, odd, even, d, throughput and the outputs' vectors
// f32[3, n]; tex_uv f32[2, n]; the variates f32[k + 3, n] (mis_sample.cuh's
// k rows, then the scatter's three: the ball sample's z, azimuth and
// radius, whose first is also the dielectric's reflect test); the packed
// atlas i32[n_img, atlas_h, atlas_w] (R | G << 8 | B << 16).  A field
// that no texture of the scene reads may be null.

#include "mis_sample.cuh"

// One launch's arguments, copied from the host by value (ops/vertex.py::_Args
// mirrors this layout field for field).  Outside the unnamed namespace, so
// that rt_vertex, which takes it, keeps external linkage.
struct VertexArgs {
  const unsigned char* hit;
  const float* p;
  const float* normal;
  const unsigned char* front;
  const float* u;
  const float* v;
  const float* tex_uv;
  const int* mat_kind;
  const float* mat_param;
  const int* tex_kind;
  const float* color;
  const float* scale;
  const int* img;
  const int* img_h;
  const int* img_w;
  const float* odd;
  const float* even;
  const float* d;
  const float* tm;
  const float* throughput;
  const unsigned char* alive;
  const float* var;
  const int* perlin_perm;
  const float* perlin_vec;
  const int* atlas;
  const float* params;
  const int* kind;
  const int* lights;
  float* radiance;
  unsigned char* cont;
  float* o_out;
  float* d_out;
  float* tm_out;
  float* th_out;
  long long n;
  long long n_prims;
  long long atlas_h;
  long long atlas_w;
  int rows;
  int n_lights;
  int features;
  int sky;
  int spawn;
  float spawn_eps;
  float bg[3];
};

namespace {

constexpr int LAMBERTIAN = 0, METAL = 1, DIELECTRIC = 2, DIFFUSE_LIGHT = 3, ISOTROPIC = 4;  // scene/types.py
constexpr int TEX_CHECKER = 1, TEX_NOISE = 2, TEX_IMAGE = 3, TEX_OBJUV = 4;
constexpr int FEAT_CHECKER = 1, FEAT_NOISE = 2, FEAT_IMAGE = 4, FEAT_OBJUV = 8;  // ops/vertex.py::FEATURES
constexpr int PERLIN = 256;
constexpr int TURB_DEPTH = 7;
constexpr float COLOR_SCALE = (float)(1.0 / 255.999);
constexpr float THIRD = (float)(1.0 / 3.0);

// PyTorch's clamp(min=), clamp(max=), minimum and maximum on the card: a NaN stays
__device__ __forceinline__ float max_nan(float x, float lo) { return isnan(x) ? x : fmaxf(x, lo); }
__device__ __forceinline__ float min_nan(float x, float hi) { return isnan(x) ? x : fminf(x, hi); }
__device__ __forceinline__ float max2_nan(float a, float b) { return (isnan(a) || isnan(b)) ? NAN : fmaxf(a, b); }

__device__ __forceinline__ V3 add3(const V3& a, const V3& b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 sub3(const V3& a, const V3& b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 mul3(const V3& a, const V3& b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }
__device__ __forceinline__ V3 scale3(const V3& a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ V3 neg3(const V3& a) { return {-a.x, -a.y, -a.z}; }

__device__ __forceinline__ V3 load3(const float* __restrict__ x, long long n, long long i) {
  return {x[i], x[n + i], x[2 * n + i]};
}

__device__ __forceinline__ void store3(float* __restrict__ x, long long n, long long i, const V3& v) {
  x[i] = v.x;
  x[n + i] = v.y;
  x[2 * n + i] = v.z;
}

// vecmath.reflect
__device__ __forceinline__ V3 reflect(const V3& v, const V3& n) { return sub3(v, scale3(n, 2.0f * dot3(v, n))); }

// vecmath.refract
__device__ __forceinline__ V3 refract(const V3& uv, const V3& n, float eta) {
  const float cos_theta = min_nan(dot3(neg3(uv), n), 1.0f);
  const V3 perp = scale3(add3(uv, scale3(n, cos_theta)), eta);
  const float par = sqrtf(max_nan(fabsf(1.0f - dot3(perp, perp)), 1e-12f));
  return add3(perp, scale3(neg3(n), par));
}

// sampling.in_unit_ball_local: uniform in the unit ball from (z, azimuth, radius) variates
__device__ __forceinline__ V3 in_unit_ball(float uz, float uphi, float ur) {
  const float z = -1.0f + 2.0f * uz;
  const float phi = TWO_PI_F * uphi;
  const float r = sqrtf(max_nan(1.0f - z * z, 0.0f));
  return scale3(V3{r * cosf(phi), r * sinf(phi), z}, powf(ur, THIRD));
}

// textures._hermite
__device__ __forceinline__ float hermite(float x) { return x * x * (3.0f - 2.0f * x); }

// textures.perlin_noise with the reference's double Hermite smoothing
// (perlin.rs:52-99); perm and vec are the block's copies of the tables
__device__ float perlin_noise(const int* perm, const float* vec, const V3& p) {
  const float fl[3] = {floorf(p.x), floorf(p.y), floorf(p.z)};
  const float pc[3] = {p.x, p.y, p.z};
  float u1[3], u2[3];
  int pa[3][2];
  for (int a = 0; a < 3; ++a) {
    u1[a] = hermite(pc[a] - fl[a]);
    u2[a] = hermite(u1[a]);
    const int ijk = (int)fl[a];
    pa[a][0] = perm[a * PERLIN + (ijk & 255)];
    pa[a][1] = perm[a * PERLIN + ((ijk + 1) & 255)];
  }
  float accum = 0.0f;
  for (int di = 0; di < 2; ++di)
    for (int dj = 0; dj < 2; ++dj)
      for (int dk = 0; dk < 2; ++dk) {
        const int idx = pa[0][di] ^ pa[1][dj] ^ pa[2][dk];
        const float grad_dot = vec[idx] * (u1[0] - (float)di) + vec[PERLIN + idx] * (u1[1] - (float)dj) +
                               vec[2 * PERLIN + idx] * (u1[2] - (float)dk);
        const float wx = di ? u2[0] : 1.0f - u2[0];
        const float wy = dj ? u2[1] : 1.0f - u2[1];
        const float wz = dk ? u2[2] : 1.0f - u2[2];
        accum = accum + grad_dot * wx * wy * wz;
      }
  return accum;
}

// textures.perlin_turb: |sum of TURB_DEPTH halved octaves|
__device__ float perlin_turb(const int* perm, const float* vec, V3 p) {
  float accum = 0.0f, weight = 1.0f;
  for (int o = 0; o < TURB_DEPTH; ++o) {
    accum = accum + perlin_noise(perm, vec, p) * weight;
    weight *= 0.5f;
    p = scale3(p, 2.0f);
  }
  return fabsf(accum);
}

// textures._to_index: truncate toward zero, saturating outside [-1, hi] first
__device__ __forceinline__ long long to_index(float x, int hi) {
  return __float2ll_rz(min_nan(max_nan(x, -1.0f), (float)hi));
}

// textures._image_lookup: the texel (i, j) of atlas image img, clipped into it
__device__ __forceinline__ V3 texel(const VertexArgs& a, int img, int w, int h, long long i, long long j) {
  i = min(max(i, 0LL), (long long)w - 1);
  j = min(max(j, 0LL), (long long)h - 1);
  const int packed = a.atlas[((long long)img * a.atlas_h + j) * a.atlas_w + i];
  return {(float)(packed & 0xFF) * COLOR_SCALE, (float)((packed >> 8) & 0xFF) * COLOR_SCALE,
          (float)((packed >> 16) & 0xFF) * COLOR_SCALE};
}

// textures.eval_texture_shade for lane i at p
__device__ V3 texture_value(const VertexArgs& a, const int* perm, const float* vec, long long i, const V3& p) {
  const long long n = a.n;
  const int tk = a.tex_kind[i];
  if ((a.features & FEAT_NOISE) && tk == TEX_NOISE) {
    // NoiseTexture marble (texture/mod.rs:76-78)
    const float val = 0.5f * (1.0f + sinf(a.scale[i] * p.z + 10.0f * perlin_turb(perm, vec, p)));
    return {val, val, val};
  }
  if ((a.features & FEAT_IMAGE) && tk == TEX_IMAGE) {
    // ImageTexture nearest-neighbour sample (texture/mod.rs:111-138)
    const int w = a.img_w[i], h = a.img_h[i];
    const float uu = min_nan(max_nan(a.u[i], 0.0f), 1.0f), vv = min_nan(max_nan(a.v[i], 0.0f), 1.0f);
    return texel(a, a.img[i], w, h, to_index(uu * (float)w, w), to_index(vv * (float)h, h));
  }
  if ((a.features & FEAT_OBJUV) && tk == TEX_OBJUV) {
    // ObjTexture (texture/mod.rs:167-188): the atlas is stored bottom-up
    const int w = a.img_w[i], h = a.img_h[i];
    const long long ii = to_index(a.tex_uv[i] * (float)w, w);
    const long long j_top = min(max(to_index((1.0f - a.tex_uv[n + i]) * (float)h, h), 0LL), (long long)h - 1);
    return texel(a, a.img[i], w, h, ii, (long long)h - 1 - j_top);
  }
  if ((a.features & FEAT_CHECKER) && tk == TEX_CHECKER) {
    // CheckerTexture sine-product select (texture/mod.rs:52-59)
    const float sines = sinf(10.0f * p.x) * sinf(10.0f * p.y) * sinf(10.0f * p.z);
    return sines < 0.0f ? load3(a.odd, n, i) : load3(a.even, n, i);
  }
  return load3(a.color, n, i);  // TEX_SOLID (texture/mod.rs:26-28)
}

__global__ void vertex_kernel(const VertexArgs a) {
  extern __shared__ float smem[];  // the lights list, then the Perlin tables where the scene reads them
  float* table = smem;
  int* perm = reinterpret_cast<int*>(smem + a.n_lights * LIGHT_WORDS);
  float* vec = smem + a.n_lights * LIGHT_WORDS + 3 * PERLIN;
  load_light_table(table, a.params, a.n_prims, a.kind, a.lights, a.n_lights);
  if (a.features & FEAT_NOISE) {
    for (int j = threadIdx.x; j < 3 * PERLIN; j += blockDim.x) {
      perm[j] = a.perlin_perm[j];
      vec[j] = a.perlin_vec[j];
    }
  }
  __syncthreads();

  const long long n = a.n;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const int k = a.rows - 3;  // the mixture sample's rows; the scatter's three follow
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const bool hit = a.hit[i] != 0, front = a.front[i] != 0, alive = a.alive[i] != 0;
    const V3 p = load3(a.p, n, i);
    const V3 nr = load3(a.normal, n, i);
    const V3 d = load3(a.d, n, i);
    const V3 th = load3(a.throughput, n, i);
    const float tm = a.tm[i];
    const int kind = a.mat_kind[i];
    const float param = a.mat_param[i];

    // texture value and emission (materials.texture_value, emitted)
    const V3 tex = texture_value(a, perm, vec, i, p);
    const bool is_light = kind == DIFFUSE_LIGHT;
    const V3 em = (is_light && front && hit) ? tex : V3{0.0f, 0.0f, 0.0f};

    // scatter (materials.scatter) of the three scatter rows
    const float s0 = a.var[(long long)k * n + i], s1 = a.var[(long long)(k + 1) * n + i],
                s2 = a.var[(long long)(k + 2) * n + i];
    const bool is_metal = kind == METAL, is_diel = kind == DIELECTRIC;
    const V3 unit_d = unit(d);
    const V3 ball = in_unit_ball(s0, s1, s2);
    V3 spec_dir;
    if (is_metal) {
      spec_dir = add3(reflect(unit_d, nr), scale3(ball, param));
    } else if (is_diel) {
      const float ir = param;
      const float ratio = front ? (1.0f / ir) : ir;
      const float cos_theta = min_nan(dot3(neg3(unit_d), nr), 1.0f);
      const float sin_theta = sqrtf(max_nan(1.0f - cos_theta * cos_theta, 0.0f));
      const bool cannot_refract = ratio * sin_theta > 1.0f;
      float r0 = (1.0f - ratio) / (1.0f + ratio);
      r0 = r0 * r0;
      const float reflectance = r0 + (1.0f - r0) * powf(1.0f - cos_theta, 5.0f);
      const bool do_reflect = cannot_refract || reflectance > s0;
      spec_dir = do_reflect ? reflect(unit_d, nr) : refract(unit_d, nr, ratio);
    } else {
      spec_dir = ball;  // isotropic; unread on the other kinds
    }
    const bool has_scatter = !is_light;
    const bool is_specular = is_metal || is_diel || kind == ISOTROPIC;
    const float spec_time = is_metal ? 0.0f : tm;
    const V3 att = is_diel ? V3{1.0f, 1.0f, 1.0f} : tex;

    // the mixture sample (mis_sample.cuh)
    float pdf;
    const V3 new_dir = mis_lane(table, a.n_lights, p, nr, a.var, n, i, &pdf);

    // the update: scattering_pdf_lambertian, the lane's class, radiance, throughput, next ray
    const float cosine = dot3(nr, unit(new_dir));
    const float spdf = cosine < 0.0f ? 0.0f : cosine * INV_PI_F;
    const bool miss = alive && !hit;
    const bool absorb = alive && hit && !has_scatter;
    const bool specular = alive && hit && has_scatter && is_specular;
    const bool diffuse = alive && hit && has_scatter && !is_specular && kind == LAMBERTIAN && pdf > 0.0f;

    V3 bg = {a.bg[0], a.bg[1], a.bg[2]};
    if (a.sky) {
      // the RTiOW sky gradient (integrator._background)
      const float tt = 0.5f * (unit(d).y + 1.0f);
      const float wt = 1.0f - tt;
      bg = {wt + 0.5f * tt, wt + 0.7f * tt, wt + 1.0f * tt};
    }
    const V3 zero = {0.0f, 0.0f, 0.0f};
    const V3 rad = add3(miss ? mul3(th, bg) : zero, (absorb || diffuse) ? mul3(th, em) : zero);

    const float ratio = spdf / (diffuse ? pdf : 1.0f);
    const V3 next_th = specular ? mul3(th, att) : (diffuse ? mul3(th, scale3(att, ratio)) : th);
    const V3 next_d = specular ? spec_dir : new_dir;
    const float next_tm = specular ? spec_time : tm;
    V3 o = p;
    if (a.spawn) {
      // origin offset along the face normal toward the outgoing side
      const float m = max_nan(max2_nan(max2_nan(fabsf(p.x), fabsf(p.y)), fabsf(p.z)), 1.0f);
      const float eps = a.spawn_eps * m;
      const float dn = dot3(nr, next_d);
      const float side = (float)((0.0f < dn) - (dn < 0.0f));
      o = add3(p, scale3(nr, eps * side * (kind != ISOTROPIC ? 1.0f : 0.0f)));
    }

    store3(a.radiance, n, i, rad);
    a.cont[i] = (specular || diffuse) ? 1 : 0;
    store3(a.o_out, n, i, o);
    store3(a.d_out, n, i, next_d);
    a.tm_out[i] = next_tm;
    store3(a.th_out, n, i, next_th);
  }
}

// Bytes of the shared memory a block of the kernel takes for n_lights
// lights and the features (the wrapper's check of MAX_LIGHTS keeps it
// under 48 KiB).
long long smem_bytes(int n_lights, int features) {
  return (long long)n_lights * LIGHT_WORDS * sizeof(float) +
         ((features & FEAT_NOISE) ? 3 * PERLIN * (sizeof(int) + sizeof(float)) : 0);
}

}  // namespace

// Launches the kernel on stream over blocks blocks of 256 threads; returns
// cudaGetLastError() after the launch (0 on success), and the wrapper
// raises on anything else.  rows must be the wrapper's variate rows for
// n_lights; every light a SPHERE or a RECT (the wrapper checks the kinds).
extern "C" int rt_vertex(const VertexArgs* args, int blocks, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const VertexArgs& a = *args;
  const int want = (a.n_lights == 0 ? 2 : (a.n_lights == 1 ? 5 : 6)) + 3;
  if (a.n <= 0 || blocks <= 0 || a.n_lights < 0 || a.rows != want) return (int)cudaErrorInvalidValue;
  const long long smem = smem_bytes(a.n_lights, a.features);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  vertex_kernel<<<blocks, 256, (size_t)smem, stream>>>(a);
  return (int)cudaGetLastError();
}
