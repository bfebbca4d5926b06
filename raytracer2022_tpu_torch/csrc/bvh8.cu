// K1: closest hit of each ray in one 8-ary BVH of a single primitive kind.
//
// Replaces the TPU kernel raytracer2022_tpu/ops/bvh8.py::_make_kernel
// (launched by traverse_bvh8 through pl.pallas_call, with the leaf
// formulas of _leaf_test).  Wrapper, plain version and reference walk:
// raytracer2022_tpu_torch/ops/bvh8.py.
//
// What bounds it on an H100: not the bytes (a launch of 262,144 rays moves
// ~37 MB, ~11 us at 3.35 TB/s) but issue slots lost to divergence and
// latency.  Each lane walks its own ray; a camera ray of the stand-in mesh
// visits ~1.75 groups and ~0.25 leaves, yet some visit 10 groups and 6
// leaves, and a leaf is 16 rows of ~150 dependent operations each.  With one
// thread per ray (the first port), a warp issues its slowest lane's walk.
// The design (PERF.md gives each step's time):
//   * persistent warps with dynamic ray fetch (Aila and Laine, HPG 2009):
//     the grid holds as many blocks as the SMs keep resident; each lane
//     starts on ray blockIdx*THREADS+tid, and a warp whose idle lanes reach
//     REFILL takes the next rays from a global counter (zeroed by the
//     wrapper), so a long ray no longer idles 31 lanes;
//   * a compact stack: one 32-bit word per visited group, the group id and
//     the ordinal mask of its hit children (bit k = the child at ordinal k
//     of the ray's octant order), popped nearest first.  It holds the
//     tree's own depth (Params::depth, at most MAX_DEPTH = 22, the JAX
//     package's bound, which build_bvh8 and SceneData.from_numpy check) in
//     a per-thread column of shared memory: depth * 2 KB a block, so a
//     shallow tree leaves the rest of the SM's shared memory and L1 to the
//     group arrays and the leaf rows;
//   * each lane visits its own groups (8 slab tests) until it reaches a
//     leaf; then the warp tests the leaves of all its lanes together,
//     LEAF_LANES<KIND> lanes to a leaf, each lane a row (or two) against
//     the owner's ray, and a shuffle reduction picks the winner: 16
//     sequential rows per lane become one or two passes;
//   * the group arrays (boxes, entries, axorder: 320 B a group) are copied
//     once per persistent block into shared memory with bulk asynchronous
//     copies (cp.async.bulk on an mbarrier) when they fit, and read from
//     global memory otherwise (template parameter SH, chosen by the wrapper
//     from rt_bvh8_shared_fits);
//   * leaf rows stay in global memory, read as 16-byte loads through the
//     read-only path; the pid column only on a hit;
//   * the walk writes t, best and the winner's row index; a second small
//     kernel gathers the winner rows column by column (coalesced stores).
// The results are the first port's: the visit order (children near-first
// by the ray's sign octant, a group's slab test clamped to [t_min, t_best]
// when the group is visited), min/max propagating NaN as jnp.minimum and
// jnp.maximum do (a ray on a box plane with a zero direction component
// gives 0*inf = NaN and rejects the box), the smallest t in a leaf winning
// with exact ties to the smallest prim id, and only a strictly smaller t
// than t_best updating.
// Built without fast math and with -fmad=false (cuda_build.py): IEEE
// 1/0 = inf is needed, and the arithmetic is that of the plain version.
//
// Layouts: o, d f32[3, N] component-leading; tm, t_init f32[N] (t_init
// already clamped to FAR); entries, axorder i32[Ng*8]; boxes f32[Ng*8, 8];
// prows f32[Lb*16, 24].  Outputs: t f32[N], best i32[N] (-1 if nothing
// beats t_init); optional rows f32[24, N] (zeros where best < 0, needs the
// scratch win i32[N]) and visits i32[2, N] (groups, leaves visited).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int SPHERE = 0;
constexpr int MSPHERE = 1;
constexpr int RECT = 2;
constexpr int TRIANGLE = 3;
constexpr int RING = 4;

constexpr int FANOUT = 8;
constexpr int LEAF = 16;
// the deepest tree: the JAX package's bound, (FANOUT - 1) * depth + 1 <= 160
// (ops/bvh8.py MAX_STACK, MAX_DEPTH)
constexpr int MAX_DEPTH = (160 - 1) / (FANOUT - 1);
static_assert(MAX_DEPTH == 22, "ops/bvh8.py MAX_DEPTH");
constexpr int SENT = 0x7FFFFFFF;
constexpr int NONE = SENT;  // no node: never a group id (< 2^24) nor a leaf (< 0)
constexpr int NCOL = 24;
constexpr int COL_PID = 16;
constexpr float FAR = 1e30f;
constexpr float NO_PID = 16777216.0f;  // 2^24, above every prim id
constexpr int THREADS = 512;
constexpr int REFILL = 16;  // idle lanes that make a warp fetch new rays
constexpr int STACK_WORD_BYTES = THREADS * 4;  // one stack level of a block
constexpr int GROUP_BYTES = FANOUT * (8 * 4 + 4 + 4);  // boxes, entries, axorder
constexpr unsigned COPY_CHUNK = 32768;                // bytes per bulk copy
constexpr unsigned FULL = 0xffffffffu;

// min/max that return NaN when either input is NaN, as jnp.minimum and
// jnp.maximum do (one sm_80+ instruction each; fminf/fmaxf drop the NaN)
__device__ __forceinline__ float nan_min(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float nan_max(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

struct Ray {
  float ox, oy, oz, dx, dy, dz, tm;
};

// float4 chunks of a leaf row that each kind's formula reads (columns 0-11)
template <int KIND>
constexpr int ROW_CHUNKS = (KIND == SPHERE || KIND == RING) ? 1 : (KIND == RECT ? 2 : 3);

// lanes that test one leaf together (each LEAF / LEAF_LANES rows): 8 for
// triangles, 16 for the other kinds, whose tests (the f64 sphere quadratic)
// run longer per row
template <int KIND>
constexpr int LEAF_LANES = KIND == TRIANGLE ? 8 : 16;

// Candidate t of one leaf row; FAR on a miss.  Same operations, in the same
// order, as leaf_t in ops/bvh8.py.
template <int KIND>
__device__ __forceinline__ float leaf_t(const float* p, const Ray& r, float t_min, float t_best) {
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

// ---------------------------------------------------------------------------
// Hopper bulk copy global -> shared, completed on an mbarrier
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned phase) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(phase)
        : "memory");
  }
}

// bytes and both addresses are multiples of 16
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  for (unsigned off = 0; off < bytes; off += COPY_CHUNK) {
    const unsigned len = bytes - off < COPY_CHUNK ? bytes - off : COPY_CHUNK;
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
            "r"(smem_addr(static_cast<char*>(dst) + off)),
        "l"(static_cast<const char*>(src) + off), "r"(len), "r"(smem_addr(bar))
        : "memory");
  }
}

// ---------------------------------------------------------------------------
// the walk
// ---------------------------------------------------------------------------

struct Params {
  const int* entries;
  const int* axorder;
  const float* boxes;
  const float* prows;
  const float* o;
  const float* d;
  const float* tm;
  const float* t_init;
  float* t_out;
  int* best_out;
  int* win_out;  // winner leaf row, -1 on no hit (null: rows not asked for)
  int* visits;   // (2, n) groups and leaves visited (may be null)
  int* counter;  // rays handed out beyond the first grid's worth (zeroed)
  int n;
  int ng;
  int depth;  // the tree's group levels: the stack's words per thread
  float t_min;
};

struct Tree {
  const int* entries;
  const int* axorder;
  const float* boxes;
};

// group arrays: shared memory (SH) or global memory through the read-only path
template <bool SH>
__device__ __forceinline__ float4 ld4(const float* p) {
  if constexpr (SH) {
    return *reinterpret_cast<const float4*>(p);
  } else {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
}

template <bool SH>
__device__ __forceinline__ int ldi(const int* p) {
  if constexpr (SH) {
    return *p;
  } else {
    return __ldg(p);
  }
}

// slab test of group g's 8 children -> ordinal mask of the hit, non-empty ones
template <bool SH>
__device__ __forceinline__ unsigned visit_group(const Tree& tr, int g, const Ray& r, float idx,
                                                float idy, float idz, int oct, float t_min,
                                                float t_best) {
  unsigned bits = 0;
  const float* gb = tr.boxes + (size_t)g * FANOUT * 8;
#pragma unroll
  for (int j = 0; j < FANOUT; ++j) {
    const float4 lo = ld4<SH>(gb + j * 8);      // bmin x, y, z, bmax x
    const float4 hi = ld4<SH>(gb + j * 8 + 4);  // bmax y, z, pad, pad
    const float t0x = (lo.x - r.ox) * idx, t1x = (lo.w - r.ox) * idx;
    const float t0y = (lo.y - r.oy) * idy, t1y = (hi.x - r.oy) * idy;
    const float t0z = (lo.z - r.oz) * idz, t1z = (hi.y - r.oz) * idz;
    const float tnear = nan_max(nan_max(nan_min(t0x, t1x), nan_min(t0y, t1y)),
                                nan_max(nan_min(t0z, t1z), t_min));
    const float tfar = nan_min(nan_min(nan_max(t0x, t1x), nan_max(t0y, t1y)),
                               nan_min(nan_max(t0z, t1z), t_best));
    const bool hit = tfar >= tnear && ldi<SH>(tr.entries + g * FANOUT + j) != SENT;
    bits |= (hit ? 1u : 0u) << j;
  }
  const int perm = ldi<SH>(tr.axorder + g * FANOUT + oct);
  unsigned m = 0;
#pragma unroll
  for (int k = 0; k < FANOUT; ++k) m |= ((bits >> ((perm >> (3 * k)) & 7)) & 1u) << k;
  return m;
}

// the nearest remaining child of the top stack entry, or NONE
template <bool SH>
__device__ __forceinline__ int pop(unsigned* stack, int& sp, const Tree& tr, int oct) {
  if (sp == 0) return NONE;
  unsigned* top = stack + (sp - 1) * THREADS;
  const unsigned w = *top;
  const unsigned g = w >> 8;
  const unsigned m = w & 0xffu;
  const int k = __ffs(m) - 1;
  const unsigned rest = m & (m - 1u);
  if (rest == 0) {
    --sp;
  } else {
    *top = (g << 8) | rest;
  }
  const int slot = (ldi<SH>(tr.axorder + g * FANOUT + oct) >> (3 * k)) & 7;
  return ldi<SH>(tr.entries + g * FANOUT + slot);
}

// The leaf tests of a warp, LEAF_LANES<KIND> lanes to a leaf: each pass
// takes the 32 / LEAF_LANES<KIND> lowest lanes that hold a leaf; segment k
// of the warp tests the k-th one's 16 rows against its owner's ray and
// t_best, and a reduction over the segment picks the smallest t, exact
// ties to the smallest prim id (the order-free form of the scan over the
// rows).  Only a strictly smaller t than t_best updates the owner.  Called
// by all 32 lanes.
template <int KIND, bool SH>
__device__ __forceinline__ void leaf_passes(const float* __restrict__ prows, const Tree& tr,
                                            unsigned* stack, int& sp, int oct, bool live,
                                            const Ray& r, float t_min, int& node, float& t_best,
                                            float& best_pid, int& win, int& n_leaves) {
  const int lane = threadIdx.x & 31;
  constexpr int LANES = LEAF_LANES<KIND>;
  const int seg = lane / LANES;
  const unsigned below = (1u << lane) - 1u;
  for (;;) {
    const bool mine = live && node < 0;
    const unsigned want = __ballot_sync(FULL, mine);
    if (want == 0) return;
    unsigned w = want;
    int owner = -1;
    for (int k = 0; k <= seg; ++k) {
      owner = w != 0 ? __ffs(w) - 1 : -1;
      w &= w - 1u;
    }
    const int src = owner >= 0 ? owner : lane;
    Ray q;
    q.ox = __shfl_sync(FULL, r.ox, src);
    q.oy = __shfl_sync(FULL, r.oy, src);
    q.oz = __shfl_sync(FULL, r.oz, src);
    q.dx = __shfl_sync(FULL, r.dx, src);
    q.dy = __shfl_sync(FULL, r.dy, src);
    q.dz = __shfl_sync(FULL, r.dz, src);
    q.tm = __shfl_sync(FULL, r.tm, src);
    const float tb = __shfl_sync(FULL, t_best, src);
    const int first = -__shfl_sync(FULL, node, src) - 1 + lane % LANES;
    float tj = FAR, pid = NO_PID;
    int sel = first;
    if (owner >= 0) {
#pragma unroll
      for (int k = 0; k < LEAF / LANES; ++k) {
        const int row = first + k * LANES;
        const float4* qr = reinterpret_cast<const float4*>(prows) + (size_t)row * (NCOL / 4);
        float p[12];
#pragma unroll
        for (int c = 0; c < ROW_CHUNKS<KIND>; ++c) {
          const float4 x = __ldg(qr + c);
          p[4 * c] = x.x;
          p[4 * c + 1] = x.y;
          p[4 * c + 2] = x.z;
          p[4 * c + 3] = x.w;
        }
        const float t = leaf_t<KIND>(p, q, t_min, tb);
        // a row at FAR never updates the result, so its pid is not read
        if (t < FAR) {
          const float pr = __ldg(reinterpret_cast<const float*>(qr) + COL_PID);
          if (t < tj || (t == tj && pr < pid)) {
            tj = t;
            pid = pr;
            sel = row;
          }
        }
      }
    }
#pragma unroll
    for (int off = LANES / 2; off > 0; off >>= 1) {
      const float t2 = __shfl_xor_sync(FULL, tj, off);
      const float p2 = __shfl_xor_sync(FULL, pid, off);
      const int r2 = __shfl_xor_sync(FULL, sel, off);
      if (t2 < tj || (t2 == tj && p2 < pid)) {
        tj = t2;
        pid = p2;
        sel = r2;
      }
    }
    // every lane of a segment now holds its leaf's winner; the owner takes it
    const int rank = __popc(want & below);
    const int from = (rank < 32 / LANES ? rank : 0) * LANES;
    const float tl = __shfl_sync(FULL, tj, from);
    const float pl = __shfl_sync(FULL, pid, from);
    const int rl = __shfl_sync(FULL, sel, from);
    if (mine && rank < 32 / LANES) {
      if (tl < t_best && tl < FAR) {
        t_best = tl;
        best_pid = pl;
        win = rl;
      }
      ++n_leaves;
      node = pop<SH>(stack, sp, tr, oct);
    }
  }
}

template <int KIND, bool SH>
__global__ void __launch_bounds__(THREADS, 1) bvh8_walk(const Params a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint64_t bar;
  unsigned* stack = reinterpret_cast<unsigned*>(smem) + threadIdx.x;  // level k at [k * THREADS]

  Tree tr{a.entries, a.axorder, a.boxes};
  if constexpr (SH) {
    float* sb = reinterpret_cast<float*>(smem + a.depth * STACK_WORD_BYTES);
    int* se = reinterpret_cast<int*>(sb + (size_t)a.ng * FANOUT * 8);
    int* sa = se + a.ng * FANOUT;
    if (threadIdx.x == 0) mbar_init(&bar);
    __syncthreads();
    if (threadIdx.x == 0) {
      const unsigned nb = a.ng * FANOUT * 8 * 4, ne = a.ng * FANOUT * 4;
      mbar_expect_tx(&bar, nb + 2 * ne);
      bulk_copy(sb, a.boxes, nb, &bar);
      bulk_copy(se, a.entries, ne, &bar);
      bulk_copy(sa, a.axorder, ne, &bar);
    }
    mbar_wait(&bar, 0);
    tr = Tree{se, sa, sb};
  }

  const int n = a.n;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const int grid = gridDim.x * THREADS;

  int i = -1;  // this lane's ray, -1 while idle
  Ray r;
  float idx = 0.0f, idy = 0.0f, idz = 0.0f, t_best = FAR, best_pid = -1.0f;
  int oct = 0, node = NONE, sp = 0, win = -1, n_groups = 0, n_leaves = 0;

  int next = blockIdx.x * THREADS + threadIdx.x;  // the ray this lane starts next
  if (next >= n) next = -1;
  bool more = grid < n;  // warp-uniform: rays left behind the counter
  for (;;) {
    if (next >= 0) {
      i = next;
      next = -1;
      r.ox = a.o[i];
      r.oy = a.o[n + i];
      r.oz = a.o[2 * n + i];
      r.dx = a.d[i];
      r.dy = a.d[n + i];
      r.dz = a.d[2 * n + i];
      r.tm = a.tm[i];
      idx = 1.0f / r.dx;  // IEEE inf on zero components (aabb.rs:15-32)
      idy = 1.0f / r.dy;
      idz = 1.0f / r.dz;
      oct = (r.dx > 0.0f) + 2 * (r.dy > 0.0f) + 4 * (r.dz > 0.0f);
      t_best = a.t_init[i];
      best_pid = -1.0f;
      win = -1;
      node = 0;
      sp = 0;
      n_groups = 0;
      n_leaves = 0;
    }
    if (i >= 0) {
      while (node >= 0 && node != NONE) {
        const unsigned m = visit_group<SH>(tr, node, r, idx, idy, idz, oct, a.t_min, t_best);
        ++n_groups;
        if (m != 0) {
          if (sp == a.depth) __trap();  // the tree's depth bounds the stack
          stack[sp * THREADS] = ((unsigned)node << 8) | m;
          ++sp;
        }
        node = pop<SH>(stack, sp, tr, oct);
      }
    }
    leaf_passes<KIND, SH>(a.prows, tr, stack, sp, oct, i >= 0, r, a.t_min, node, t_best, best_pid,
                          win, n_leaves);
    if (i >= 0 && node == NONE) {
      a.t_out[i] = t_best;
      a.best_out[i] = win >= 0 ? (int)best_pid : -1;
      if (a.win_out != nullptr) a.win_out[i] = win;
      if (a.visits != nullptr) {
        a.visits[i] = n_groups;
        a.visits[n + i] = n_leaves;
      }
      i = -1;
    }
    if (more) {
      const unsigned idle = __ballot_sync(FULL, i < 0);
      const int k = __popc(idle);
      if (k >= REFILL) {
        int base = 0;
        if (lane == 0) base = atomicAdd(a.counter, k);
        base = __shfl_sync(FULL, base, 0) + grid;
        if (base + k >= n) more = false;
        const int j = base + __popc(idle & below);
        if (i < 0 && j < n) next = j;
      }
    }
    if (__ballot_sync(FULL, i >= 0 || next >= 0) == 0) break;
  }
}

// winner rows, column-major: one thread per ray, consecutive rays on
// consecutive addresses
__global__ void __launch_bounds__(256) bvh8_rows(int n, const int* __restrict__ win,
                                                 const float* __restrict__ prows,
                                                 float* __restrict__ rows_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int w = win[i];
  const float* src = prows + (size_t)(w >= 0 ? w : 0) * NCOL;
#pragma unroll
  for (int c = 0; c < NCOL; ++c) rows_out[(size_t)c * n + i] = w >= 0 ? __ldg(src + c) : 0.0f;
}

// What a launch asks of the runtime that does not change between launches
// on one device, queried once: the SM count, the opt-in shared-memory limit
// and the largest static shared memory of the shared-memory instantiations;
// per instantiation, the dynamic shared memory set on it and the blocks an
// SM holds at the size last asked for (the main path launches one tree
// hundreds of times).
constexpr int MAX_DEVICES = 64;
constexpr int NKINDS = 5;

struct DeviceInfo {
  bool known = false;
  int sms = 0, optin = 0, static_smem = 0;
};

struct LaunchInfo {
  int smem_set = -1;          // cudaFuncAttributeMaxDynamicSharedMemorySize on the kernel
  int smem = -1, per_sm = 0;  // blocks per SM at dynamic shared memory smem
};

std::mutex g_mutex;  // ctypes calls run without the GIL
DeviceInfo g_device[MAX_DEVICES];
LaunchInfo g_launch[MAX_DEVICES][NKINDS][2];

template <int KIND>
cudaError_t max_static_smem(int* out) {
  cudaFuncAttributes fa;
  const cudaError_t e = cudaFuncGetAttributes(&fa, bvh8_walk<KIND, true>);
  if (e == cudaSuccess && (int)fa.sharedSizeBytes > *out) *out = (int)fa.sharedSizeBytes;
  return e;
}

// the current device and its DeviceInfo; call with g_mutex held
cudaError_t device_info(int* dev, const DeviceInfo** out) {
  cudaError_t e = cudaGetDevice(dev);
  if (e != cudaSuccess) return e;
  if (*dev < 0 || *dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  DeviceInfo& di = g_device[*dev];
  if (!di.known) {
    int s = 0;
    e = cudaDeviceGetAttribute(&di.sms, cudaDevAttrMultiProcessorCount, *dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&di.optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, *dev);
    if (e == cudaSuccess) e = max_static_smem<SPHERE>(&s);
    if (e == cudaSuccess) e = max_static_smem<MSPHERE>(&s);
    if (e == cudaSuccess) e = max_static_smem<RECT>(&s);
    if (e == cudaSuccess) e = max_static_smem<TRIANGLE>(&s);
    if (e == cudaSuccess) e = max_static_smem<RING>(&s);
    if (e != cudaSuccess) return e;
    di.static_smem = s;
    di.known = true;
  }
  *out = &di;
  return cudaSuccess;
}

template <int KIND, bool SH>
cudaError_t launch(const Params& a, float* rows_out, cudaStream_t stream) {
  auto kern = bvh8_walk<KIND, SH>;
  const int smem = a.depth * STACK_WORD_BYTES + (SH ? a.ng * GROUP_BYTES : 0);
  int dev = 0, sms = 0, per_sm = 0;
  {
    std::lock_guard<std::mutex> lock(g_mutex);
    const DeviceInfo* di = nullptr;
    cudaError_t e = device_info(&dev, &di);
    if (e != cudaSuccess) return e;
    LaunchInfo& li = g_launch[dev][KIND][SH];
    if (smem > li.smem_set) {
      e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return e;
      li.smem_set = smem;
    }
    if (smem != li.smem) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&li.per_sm, kern, THREADS, smem);
      if (e != cudaSuccess) return e;
      li.smem = smem;
    }
    sms = di->sms;
    per_sm = li.per_sm;
  }
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int need = (a.n + THREADS - 1) / THREADS;
  const int blocks = sms * per_sm < need ? sms * per_sm : need;
  kern<<<blocks, THREADS, smem, stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess && rows_out != nullptr) {
    bvh8_rows<<<(a.n + 255) / 256, 256, 0, stream>>>(a.n, a.win_out, a.prows, rows_out);
    e = cudaGetLastError();
  }
  return e;
}

template <int KIND>
cudaError_t launch_kind(bool shared, const Params& a, float* rows_out, cudaStream_t stream) {
  return shared ? launch<KIND, true>(a, rows_out, stream)
                : launch<KIND, false>(a, rows_out, stream);
}

}  // namespace

// 1 if a tree of ng groups and depth group levels fits the shared-memory
// instantiation on the current device, 0 if not, -cudaError on a failed
// query.
extern "C" int rt_bvh8_shared_fits(int ng, int depth) {
  std::lock_guard<std::mutex> lock(g_mutex);
  int dev = 0;
  const DeviceInfo* di = nullptr;
  const cudaError_t e = device_info(&dev, &di);
  if (e != cudaSuccess) return -(int)e;
  const long need = (long)depth * STACK_WORD_BYTES + (long)ng * GROUP_BYTES + (long)di->static_smem;
  return need <= di->optin ? 1 : 0;
}

// Launches the walk (and, when rows_out is given, the row gather) on
// stream; returns cudaGetLastError() after the launches (0 on success), and
// the wrapper raises on anything else.  depth is the tree's group levels
// (1 to MAX_DEPTH); rows_out needs win_out; visits may be null; counter is
// one zeroed int.
extern "C" int rt_bvh8_traverse(int kind, int tree_in_shared, float t_min, int n, int ng,
                                int depth, const int* entries, const int* axorder,
                                const float* boxes, const float* prows, const float* o,
                                const float* d, const float* tm, const float* t_init,
                                float* t_out, int* best_out, int* win_out, float* rows_out,
                                int* visits, int* counter, void* stream_ptr) {
  const Params a{entries,  axorder, boxes,  prows,   o, d,  tm,    t_init,
                 t_out,    best_out, win_out, visits, counter, n, ng, depth, t_min};
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bool sh = tree_in_shared != 0;
  if (rows_out != nullptr && win_out == nullptr) return (int)cudaErrorInvalidValue;
  if (depth < 1 || depth > MAX_DEPTH) return (int)cudaErrorInvalidValue;
  switch (kind) {
    case SPHERE:
      return (int)launch_kind<SPHERE>(sh, a, rows_out, stream);
    case MSPHERE:
      return (int)launch_kind<MSPHERE>(sh, a, rows_out, stream);
    case RECT:
      return (int)launch_kind<RECT>(sh, a, rows_out, stream);
    case TRIANGLE:
      return (int)launch_kind<TRIANGLE>(sh, a, rows_out, stream);
    case RING:
      return (int)launch_kind<RING>(sh, a, rows_out, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
