// K1: closest hit of each ray in one 8-ary BVH of a single primitive kind.
//
// Replaces the TPU kernel raytracer2022_tpu/ops/bvh8.py::_make_kernel
// (launched by traverse_bvh8 through pl.pallas_call, with the leaf
// formulas of _leaf_test).  Wrapper and plain version:
// raytracer2022_tpu_torch/ops/bvh8.py::traverse_bvh8.
//
// What bounds it on an H100: dependent loads from the tree (each pop reads
// one entry, then 8 boxes or 16 leaf rows, before it knows what to pop
// next) and warp divergence (each thread walks its own stack).  The tree
// is small next to the 50 MB L2 (the 13,056-triangle stand-in mesh has
// 17,152 leaf rows x 24 f32 = 1.6 MB), so the loads hit L2, not HBM.
//
// Design, against the TPU kernel:
//   * one thread per ray with its own stack of MAX_STACK entries in local
//     memory (the TPU walked 128-ray packets with an SMEM stack), the ragged
//     edge masked instead of padded to 1024 rays;
//   * each ray picks the near-first child order of its own sign octant
//     (the TPU used one dominant octant per packet); this only changes the
//     visit order;
//   * the winner is remembered as a leaf-row index and its 24 columns are
//     copied once at the end (the TPU rewrote the row on every update);
//   * min/max in the slab test propagate NaN as jnp.minimum/maximum do: a
//     ray on a box plane with a zero direction component gives 0*inf = NaN
//     and must reject that box (fminf/fmaxf would drop the NaN);
//   * the primitive kind is a template parameter; all five kinds compile.
// Built without fast math and with -fmad=false (cuda_build.py): IEEE
// 1/0 = inf is needed, and the arithmetic is that of the plain version.
//
// Layouts: o, d f32[3, N] component-leading; tm, t_init f32[N] (t_init
// already clamped to FAR); entries, axorder i32[Ng*8]; boxes f32[Ng*8, 8];
// prows f32[Lb*16, 24].  Outputs: t f32[N], best i32[N] (-1 if nothing
// beats t_init), rows f32[24, N] (optional, zeros where best < 0).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int SPHERE = 0;
constexpr int MSPHERE = 1;
constexpr int RECT = 2;
constexpr int TRIANGLE = 3;
constexpr int RING = 4;

constexpr int FANOUT = 8;
constexpr int LEAF = 16;
constexpr int MAX_STACK = 160;
constexpr int SENT = 0x7FFFFFFF;
constexpr int NCOL = 24;
constexpr int COL_PID = 16;
constexpr float FAR = 1e30f;
constexpr float NO_PID = 16777216.0f;  // 2^24, above every prim id
constexpr int THREADS = 128;

__device__ __forceinline__ float nan_min(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

struct Ray {
  float ox, oy, oz, dx, dy, dz, tm;
};

// Candidate t of one leaf row; FAR on a miss.  Same operations, in the same
// order, as leaf_t in ops/bvh8.py.
template <int KIND>
__device__ __forceinline__ float leaf_t(const float* __restrict__ p, const Ray& r,
                                        float t_min, float t_best) {
  if (KIND == SPHERE || KIND == MSPHERE) {
    float cx = p[0], cy = p[1], cz = p[2];
    const float rad = p[3];
    if (KIND == MSPHERE) {
      const float t0 = p[7], t1 = p[8];
      const float denom = t1 - t0;
      const float frac = denom != 0.0f ? (r.tm - t0) / denom : 0.0f;
      cx = cx + (p[4] - cx) * frac;
      cy = cy + (p[5] - cy) * frac;
      cz = cz + (p[6] - cz) * frac;
    }
    // the quadratic in double, roots rounded to float (ops/bvh8.py
    // sphere_roots): a grazing ray cancels in hb*hb - a*cc
    const double ocx = (double)(r.ox - cx), ocy = (double)(r.oy - cy),
                 ocz = (double)(r.oz - cz);
    const double dx = r.dx, dy = r.dy, dz = r.dz, rr = rad;
    const double a = dx * dx + dy * dy + dz * dz;
    const double hb = ocx * dx + ocy * dy + ocz * dz;
    const double cc = ocx * ocx + ocy * ocy + ocz * ocz - rr * rr;
    const double disc = hb * hb - a * cc;
    const bool ok = disc >= 0.0;
    const double sq = sqrt(ok ? disc : 0.0);
    const double as = a == 0.0 ? 1.0 : a;
    const float r1 = (float)((-hb - sq) / as);
    const float r2 = (float)((-hb + sq) / as);
    if (ok && r1 >= t_min && r1 <= t_best) return r1;
    if (ok && r2 >= t_min && r2 <= t_best) return r2;
    return FAR;
  } else if (KIND == RECT) {
    const float a0 = p[0], a1 = p[1], b0 = p[2], b1 = p[3], kk = p[4], ax = p[5];
    const float ok_ = ax == 0.0f ? r.ox : (ax == 1.0f ? r.oy : r.oz);
    const float dk = ax == 0.0f ? r.dx : (ax == 1.0f ? r.dy : r.dz);
    const float t = (kk - ok_) / (dk != 0.0f ? dk : 1.0f);
    const float av = ax == 0.0f ? r.oy + t * r.dy : r.ox + t * r.dx;
    const float bv = ax == 2.0f ? r.oy + t * r.dy : r.oz + t * r.dz;
    const bool valid = dk != 0.0f && t >= t_min && t <= t_best && av >= a0 && av <= a1 &&
                       bv >= b0 && bv <= b1;
    return valid ? t : FAR;
  } else if (KIND == TRIANGLE) {
    const float ax = p[0], ay = p[1], az = p[2];
    const float bx = p[3], by = p[4], bz = p[5];
    const float cx = p[6], cy = p[7], cz = p[8];
    const float abx = bx - ax, aby = by - ay, abz = bz - az;
    const float acx = cx - ax, acy = cy - ay, acz = cz - az;
    float nx = aby * acz - abz * acy;
    float ny = abz * acx - abx * acz;
    float nz = abx * acy - aby * acx;
    const float nlen = sqrtf(nx * nx + ny * ny + nz * nz);
    const float inv = 1.0f / (nlen == 0.0f ? 1.0f : nlen);
    nx = nx * inv;
    ny = ny * inv;
    nz = nz * inv;
    const float denom = r.dx * nx + r.dy * ny + r.dz * nz;
    const float t = ((ax - r.ox) * nx + (ay - r.oy) * ny + (az - r.oz) * nz) /
                    (denom != 0.0f ? denom : 1.0f);
    const float px = r.ox + r.dx * t, py = r.oy + r.dy * t, pz = r.oz + r.dz * t;
    // (u x w) . (u x v) >= 0 for each edge u, as in triangle.rs:51-63
    auto side = [](float ux, float uy, float uz, float wx, float wy, float wz, float vx,
                   float vy, float vz) {
      const float ex = uy * wz - uz * wy, ey = uz * wx - ux * wz, ez = ux * wy - uy * wx;
      const float fx = uy * vz - uz * vy, fy = uz * vx - ux * vz, fz = ux * vy - uy * vx;
      return ex * fx + ey * fy + ez * fz >= 0.0f;
    };
    const bool in0 = side(acx, acy, acz, px - ax, py - ay, pz - az, abx, aby, abz);
    const float bax = ax - bx, bay = ay - by, baz = az - bz;
    const bool in1 = side(bax, bay, baz, px - bx, py - by, pz - bz, cx - bx, cy - by, cz - bz);
    const float cbx = bx - cx, cby = by - cy, cbz = bz - cz;
    const bool in2 = side(cbx, cby, cbz, px - cx, py - cy, pz - cz, ax - cx, ay - cy, az - cz);
    const bool valid =
        denom != 0.0f && nlen != 0.0f && t >= t_min && t <= t_best && in0 && in1 && in2;
    return valid ? t : FAR;
  } else {  // RING
    const float t = -r.oy / (r.dy != 0.0f ? r.dy : 1.0f);
    const float px = r.ox + t * r.dx, pz = r.oz + t * r.dz;
    const float dd = px * px + pz * pz;
    const bool valid = r.dy != 0.0f && t >= t_min && t <= t_best && dd >= p[2] && dd <= p[3];
    return valid ? t : FAR;
  }
}

template <int KIND>
__global__ void __launch_bounds__(THREADS)
bvh8_kernel(float t_min, int n, const int* __restrict__ entries,
            const int* __restrict__ axorder, const float* __restrict__ boxes,
            const float* __restrict__ prows, const float* __restrict__ o,
            const float* __restrict__ d, const float* __restrict__ tm,
            const float* __restrict__ t_init, float* __restrict__ t_out,
            int* __restrict__ best_out, float* __restrict__ rows_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Ray r;
  r.ox = o[i];
  r.oy = o[n + i];
  r.oz = o[2 * n + i];
  r.dx = d[i];
  r.dy = d[n + i];
  r.dz = d[2 * n + i];
  r.tm = tm[i];
  const float idx = 1.0f / r.dx;  // IEEE inf on zero components (aabb.rs:15-32)
  const float idy = 1.0f / r.dy;
  const float idz = 1.0f / r.dz;
  const int oct = (r.dx > 0.0f) + 2 * (r.dy > 0.0f) + 4 * (r.dz > 0.0f);

  float t_best = t_init[i];
  float best_pid = -1.0f;
  int win_row = -1;

  int stack[MAX_STACK];
  int sp = 1;
  stack[0] = 0;
  while (sp > 0) {
    const int e = stack[--sp];
    if (e >= 0) {
      // internal group: 8-wide slab test clamped to [t_min, t_best]
      unsigned bits = 0;
      const float* gb = boxes + (size_t)e * FANOUT * 8;
#pragma unroll
      for (int j = 0; j < FANOUT; ++j) {
        const float* b = gb + j * 8;
        const float t0x = (b[0] - r.ox) * idx, t1x = (b[3] - r.ox) * idx;
        const float t0y = (b[1] - r.oy) * idy, t1y = (b[4] - r.oy) * idy;
        const float t0z = (b[2] - r.oz) * idz, t1z = (b[5] - r.oz) * idz;
        const float tnear = nan_max(nan_max(nan_min(t0x, t1x), nan_min(t0y, t1y)),
                                    nan_max(nan_min(t0z, t1z), t_min));
        const float tfar = nan_min(nan_min(nan_max(t0x, t1x), nan_max(t0y, t1y)),
                                   nan_min(nan_max(t0z, t1z), t_best));
        bits |= (tfar >= tnear ? 1u : 0u) << j;
      }
      // push hit children far-to-near so the nearest pops first
      const int perm = axorder[e * FANOUT + oct];
#pragma unroll
      for (int ordinal = FANOUT - 1; ordinal >= 0; --ordinal) {
        const int jj = (perm >> (3 * ordinal)) & 7;
        const int ent = entries[e * FANOUT + jj];
        if (((bits >> jj) & 1u) && ent != SENT) stack[sp++] = ent;
      }
    } else {
      // leaf: 16 rows; the smallest t wins, exact ties to the smallest
      // prim id; only a strictly smaller t than t_best updates
      const int ptr = -e - 1;
      float tmin_leaf = FAR;
      float sel = NO_PID;
      int sel_row = -1;
      for (int s = 0; s < LEAF; ++s) {
        const float* p = prows + (size_t)(ptr + s) * NCOL;
        const float tj = leaf_t<KIND>(p, r, t_min, t_best);
        const float pid = p[COL_PID];
        if (tj < tmin_leaf || (tj == tmin_leaf && pid < sel)) {
          tmin_leaf = tj;
          sel = pid;
          sel_row = ptr + s;
        }
      }
      if (tmin_leaf < t_best && tmin_leaf < FAR) {
        t_best = tmin_leaf;
        best_pid = sel;
        win_row = sel_row;
      }
    }
  }
  t_out[i] = t_best;
  best_out[i] = win_row >= 0 ? (int)best_pid : -1;
  if (rows_out != nullptr) {
    const float* w = prows + (size_t)(win_row >= 0 ? win_row : 0) * NCOL;
#pragma unroll
    for (int c = 0; c < NCOL; ++c) rows_out[(size_t)c * n + i] = win_row >= 0 ? w[c] : 0.0f;
  }
}

template <int KIND>
void launch(cudaStream_t stream, float t_min, int n, const int* entries, const int* axorder,
            const float* boxes, const float* prows, const float* o, const float* d,
            const float* tm, const float* t_init, float* t_out, int* best_out,
            float* rows_out) {
  const int blocks = (n + THREADS - 1) / THREADS;
  bvh8_kernel<KIND><<<blocks, THREADS, 0, stream>>>(t_min, n, entries, axorder, boxes, prows,
                                                    o, d, tm, t_init, t_out, best_out,
                                                    rows_out);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success); the wrapper
// raises on anything else.  rows_out may be null.
extern "C" int rt_bvh8_traverse(int kind, float t_min, int n, const int* entries,
                                const int* axorder, const float* boxes, const float* prows,
                                const float* o, const float* d, const float* tm,
                                const float* t_init, float* t_out, int* best_out,
                                float* rows_out, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  switch (kind) {
    case SPHERE:
      launch<SPHERE>(stream, t_min, n, entries, axorder, boxes, prows, o, d, tm, t_init, t_out,
                     best_out, rows_out);
      break;
    case MSPHERE:
      launch<MSPHERE>(stream, t_min, n, entries, axorder, boxes, prows, o, d, tm, t_init,
                      t_out, best_out, rows_out);
      break;
    case RECT:
      launch<RECT>(stream, t_min, n, entries, axorder, boxes, prows, o, d, tm, t_init, t_out,
                   best_out, rows_out);
      break;
    case TRIANGLE:
      launch<TRIANGLE>(stream, t_min, n, entries, axorder, boxes, prows, o, d, tm, t_init,
                       t_out, best_out, rows_out);
      break;
    case RING:
      launch<RING>(stream, t_min, n, entries, axorder, boxes, prows, o, d, tm, t_init, t_out,
                   best_out, rows_out);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
