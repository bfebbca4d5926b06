// Host runtime of the PyTorch port: the OBJ parser and the binned-SAH BVH
// builder, called from raytracer2022_tpu_torch/native.py through ctypes.
//
// A copy of the JAX package's native/rt_native.cpp, so that the port builds
// its own library from its own source on the host that runs it.  The
// reference's host-side pieces are its tobj OBJ importer (reference:
// raytracer/src/scene.rs:364-414) and its recursive BVH builder (reference:
// raytracer/src/hittable/bvh/mod.rs:30-81): a data loader (OBJ parse) and a
// graph builder (flattened skip-link BVH with binned-SAH splits).
//
// Build: native.py compiles it with g++ at first use into build/native/.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <vector>
#include <algorithm>
#include <string>

extern "C" {

// ---------------------------------------------------------------------------
// OBJ loader
// ---------------------------------------------------------------------------

struct ObjData {
  std::vector<double> verts;      // 3 * nv
  std::vector<double> uvs;        // 2 * nt
  std::vector<int64_t> faces;     // 3 * nf (position indices, 0-based)
  std::vector<int64_t> face_uvs;  // 3 * nf (texcoord indices, -1 = none)
};

// Parse one whitespace-separated token's leading integer (OBJ "i/j/k" form).
static int64_t resolve_index(const char* tok, int64_t nv) {
  int64_t idx = strtoll(tok, nullptr, 10);
  return idx > 0 ? idx - 1 : nv + idx;
}

// Parse the texcoord index of an OBJ face token ("p/t" or "p/t/n"); -1 when
// the token has no texcoord part ("p" or "p//n").
static int64_t resolve_uv_index(const char* tok, int64_t nt) {
  const char* slash = strchr(tok, '/');
  if (!slash || slash[1] == '\0' || slash[1] == '/') return -1;
  int64_t idx = strtoll(slash + 1, nullptr, 10);
  return idx > 0 ? idx - 1 : nt + idx;
}

void* rt_obj_open(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  ObjData* obj = new ObjData();
  char line[8192];
  std::vector<int64_t> poly;
  while (fgets(line, sizeof line, f)) {
    if (line[0] == 'v' && (line[1] == ' ' || line[1] == '\t')) {
      double x = 0, y = 0, z = 0;
      if (sscanf(line + 2, "%lf %lf %lf", &x, &y, &z) == 3) {
        obj->verts.push_back(x);
        obj->verts.push_back(y);
        obj->verts.push_back(z);
      }
    } else if (line[0] == 'v' && line[1] == 't') {
      double u = 0, v = 0;
      if (sscanf(line + 3, "%lf %lf", &u, &v) >= 1) {
        obj->uvs.push_back(u);
        obj->uvs.push_back(v);
      }
    } else if (line[0] == 'f' && (line[1] == ' ' || line[1] == '\t')) {
      poly.clear();
      std::vector<int64_t> poly_uv;
      int64_t nv = (int64_t)(obj->verts.size() / 3);
      int64_t nt = (int64_t)(obj->uvs.size() / 2);
      char* save = nullptr;
      for (char* tok = strtok_r(line + 2, " \t\r\n", &save); tok;
           tok = strtok_r(nullptr, " \t\r\n", &save)) {
        poly.push_back(resolve_index(tok, nv));
        poly_uv.push_back(resolve_uv_index(tok, nt));
      }
      // fan triangulation, matching tobj's `triangulate` option
      for (size_t k = 1; k + 1 < poly.size(); ++k) {
        obj->faces.push_back(poly[0]);
        obj->faces.push_back(poly[k]);
        obj->faces.push_back(poly[k + 1]);
        obj->face_uvs.push_back(poly_uv[0]);
        obj->face_uvs.push_back(poly_uv[k]);
        obj->face_uvs.push_back(poly_uv[k + 1]);
      }
    }
  }
  fclose(f);
  return obj;
}

void rt_obj_counts(void* h, int64_t* nv, int64_t* nf, int64_t* nt) {
  ObjData* obj = (ObjData*)h;
  *nv = (int64_t)(obj->verts.size() / 3);
  *nf = (int64_t)(obj->faces.size() / 3);
  *nt = (int64_t)(obj->uvs.size() / 2);
}

void rt_obj_fill(void* h, double* verts, int64_t* faces, double* uvs) {
  ObjData* obj = (ObjData*)h;
  memcpy(verts, obj->verts.data(), obj->verts.size() * sizeof(double));
  memcpy(faces, obj->faces.data(), obj->faces.size() * sizeof(int64_t));
  if (uvs && !obj->uvs.empty())
    memcpy(uvs, obj->uvs.data(), obj->uvs.size() * sizeof(double));
}

// Per-corner texcoord indices of the triangulated faces (3 * nf, -1 = the
// corner's token had no vt part) — the channel ObjTexture consumes
// (reference texture/mod.rs:141-189 via tobj single_index).
void rt_obj_fill_face_uvs(void* h, int64_t* face_uvs) {
  ObjData* obj = (ObjData*)h;
  if (face_uvs && !obj->face_uvs.empty())
    memcpy(face_uvs, obj->face_uvs.data(),
           obj->face_uvs.size() * sizeof(int64_t));
}

void rt_obj_close(void* h) { delete (ObjData*)h; }

// ---------------------------------------------------------------------------
// BVH builder: binned SAH (or median split), flattened preorder + skip links
// ---------------------------------------------------------------------------

namespace {

struct BuildItem {
  int32_t first, count;  // window into `order`
  int32_t parent_slot;   // node index whose skip must be patched after pop
};

struct V3 {
  float x, y, z;
};
static inline V3 vmin(V3 a, V3 b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
static inline V3 vmax(V3 a, V3 b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}
static inline float half_area(V3 lo, V3 hi) {
  float dx = std::max(hi.x - lo.x, 0.f), dy = std::max(hi.y - lo.y, 0.f),
        dz = std::max(hi.z - lo.z, 0.f);
  return dx * dy + dy * dz + dz * dx;
}

}  // namespace

// Builds the flattened BVH.  Inputs are P primitive AABBs (row-major [P,3]).
// Outputs (caller-allocated): node arrays at capacity 2P (bmin/bmax row-major
// [cap,3], leaf_start/leaf_count/skip [cap]) and `order` [P].  mode: 0 =
// largest-extent median split (the Python fallback's policy, itself a strict
// improvement on the reference's random-axis split, bvh/mod.rs:35), 1 =
// 16-bin SAH with median fallback.  Returns the node count.
int64_t rt_build_bvh(const float* bmin_in, const float* bmax_in, int64_t n,
                     int64_t leaf_size, int64_t mode, float* nb_min,
                     float* nb_max, int32_t* leaf_start, int32_t* leaf_count,
                     int32_t* skip, int64_t* order) {
  if (n <= 0) return 0;
  std::vector<int32_t> ord(n);
  for (int64_t i = 0; i < n; ++i) ord[i] = (int32_t)i;
  std::vector<V3> cent(n), lo(n), hi(n);
  for (int64_t i = 0; i < n; ++i) {
    lo[i] = {bmin_in[3 * i], bmin_in[3 * i + 1], bmin_in[3 * i + 2]};
    hi[i] = {bmax_in[3 * i], bmax_in[3 * i + 1], bmax_in[3 * i + 2]};
    cent[i] = {(lo[i].x + hi[i].x) * 0.5f, (lo[i].y + hi[i].y) * 0.5f,
               (lo[i].z + hi[i].z) * 0.5f};
  }

  int32_t n_nodes = 0;
  int64_t out_pos = 0;  // write cursor into `order`
  std::vector<BuildItem> stack;
  stack.push_back({0, (int32_t)n, -1});

  constexpr int NBINS = 16;

  while (!stack.empty()) {
    BuildItem it = stack.back();
    stack.pop_back();
    int32_t node = n_nodes++;

    // node bounds
    V3 blo = lo[ord[it.first]], bhi = hi[ord[it.first]];
    V3 clo = cent[ord[it.first]], chi = clo;
    for (int32_t j = it.first + 1; j < it.first + it.count; ++j) {
      blo = vmin(blo, lo[ord[j]]);
      bhi = vmax(bhi, hi[ord[j]]);
      clo = vmin(clo, cent[ord[j]]);
      chi = vmax(chi, cent[ord[j]]);
    }
    nb_min[3 * node] = blo.x;
    nb_min[3 * node + 1] = blo.y;
    nb_min[3 * node + 2] = blo.z;
    nb_max[3 * node] = bhi.x;
    nb_max[3 * node + 1] = bhi.y;
    nb_max[3 * node + 2] = bhi.z;
    leaf_start[node] = 0;
    leaf_count[node] = 0;

    bool make_leaf = it.count <= leaf_size;
    int32_t mid = it.first + it.count / 2;

    if (!make_leaf) {
      // split axis: largest centroid extent
      float ex = chi.x - clo.x, ey = chi.y - clo.y, ez = chi.z - clo.z;
      int axis = ex > ey ? (ex > ez ? 0 : 2) : (ey > ez ? 1 : 2);
      float cmin = axis == 0 ? clo.x : axis == 1 ? clo.y : clo.z;
      float cmax = axis == 0 ? chi.x : axis == 1 ? chi.y : chi.z;
      auto cval = [&](int32_t p) -> float {
        return axis == 0 ? cent[p].x : axis == 1 ? cent[p].y : cent[p].z;
      };

      bool did_sah = false;
      if (mode == 1 && cmax > cmin && it.count > 2 * leaf_size) {
        // binned SAH
        V3 bin_lo[NBINS], bin_hi[NBINS];
        int32_t bin_n[NBINS] = {0};
        for (int b = 0; b < NBINS; ++b) {
          bin_lo[b] = {1e30f, 1e30f, 1e30f};
          bin_hi[b] = {-1e30f, -1e30f, -1e30f};
        }
        float scale = NBINS / (cmax - cmin);
        auto bin_of = [&](int32_t p) {
          int b = (int)((cval(p) - cmin) * scale);
          return std::min(std::max(b, 0), NBINS - 1);
        };
        for (int32_t j = it.first; j < it.first + it.count; ++j) {
          int b = bin_of(ord[j]);
          bin_n[b]++;
          bin_lo[b] = vmin(bin_lo[b], lo[ord[j]]);
          bin_hi[b] = vmax(bin_hi[b], hi[ord[j]]);
        }
        // sweep: best split between bins b and b+1
        float right_area[NBINS];
        int32_t right_cnt[NBINS];
        V3 rlo = {1e30f, 1e30f, 1e30f}, rhi = {-1e30f, -1e30f, -1e30f};
        int32_t rc = 0;
        for (int b = NBINS - 1; b > 0; --b) {
          rlo = vmin(rlo, bin_lo[b]);
          rhi = vmax(rhi, bin_hi[b]);
          rc += bin_n[b];
          right_area[b] = rc ? half_area(rlo, rhi) : 0.f;
          right_cnt[b] = rc;
        }
        float best_cost = 1e30f;
        int best_b = -1;
        V3 llo = {1e30f, 1e30f, 1e30f}, lhi = {-1e30f, -1e30f, -1e30f};
        int32_t lc = 0;
        for (int b = 0; b < NBINS - 1; ++b) {
          llo = vmin(llo, bin_lo[b]);
          lhi = vmax(lhi, bin_hi[b]);
          lc += bin_n[b];
          if (lc == 0 || right_cnt[b + 1] == 0) continue;
          float cost =
              lc * half_area(llo, lhi) + right_cnt[b + 1] * right_area[b + 1];
          if (cost < best_cost) {
            best_cost = cost;
            best_b = b;
          }
        }
        float leaf_cost = (float)it.count * half_area(blo, bhi);
        if (best_b >= 0 && best_cost < leaf_cost) {
          auto* split = std::partition(
              ord.data() + it.first, ord.data() + it.first + it.count,
              [&](int32_t p) { return bin_of(p) <= best_b; });
          int32_t m = (int32_t)(split - ord.data());
          if (m > it.first && m < it.first + it.count) {
            mid = m;
            did_sah = true;
          }
        } else if (it.count <= 2 * leaf_size || best_b < 0) {
          // SAH says a leaf is cheaper and count is small: allow big leaf
          // only within 2*leaf_size to bound the dense leaf loop on device
          make_leaf = it.count <= leaf_size;
        }
      }
      if (!make_leaf && !did_sah) {
        // median split on the chosen axis (nth_element = O(n))
        std::nth_element(ord.data() + it.first, ord.data() + mid,
                         ord.data() + it.first + it.count,
                         [&](int32_t a, int32_t b) { return cval(a) < cval(b); });
      }
    }

    if (make_leaf) {
      leaf_start[node] = (int32_t)out_pos;
      leaf_count[node] = it.count;
      for (int32_t j = it.first; j < it.first + it.count; ++j)
        order[out_pos++] = ord[j];
      skip[node] = 0;  // patched below: preorder => skip = next node index
      // A completed leaf ends a subtree: the skip of this node is the next
      // node allocated, which is exactly n_nodes after all pushes resolve.
    } else {
      // push right first so left is processed next (preorder)
      stack.push_back({mid, (int32_t)(it.first + it.count - mid), node});
      stack.push_back({it.first, (int32_t)(mid - it.first), node});
    }
    skip[node] = 0;
  }

  // Second pass: compute skip links.  In preorder with subtree sizes known
  // from a stack simulation, skip[i] = index just past i's subtree.  We can
  // recover subtree extents by walking nodes in order and using leaf counts:
  // an internal node's subtree ends where its second child's subtree ends.
  // Simplest correct reconstruction: redo a traversal using a stack of
  // "open" internal nodes; a subtree closes when its primitive quota fills.
  {
    // Internal nodes close after both children close; track with a child
    // counter per open internal node.
    struct Open {
      int32_t node;
      int children_left;
    };
    std::vector<Open> st;
    for (int32_t i = 0; i < n_nodes; ++i) {
      // closing happens after we know node i's span; set skip when popped
      if (leaf_count[i] > 0) {
        // leaf: subtree = [i, i+1)
        skip[i] = i + 1;
        // close ancestors whose children are done
        while (!st.empty() && --st.back().children_left == 0) {
          skip[st.back().node] = i + 1;
          st.pop_back();
        }
      } else {
        st.push_back({i, 2});
      }
    }
  }
  return n_nodes;
}

// ---------------------------------------------------------------------------
// Perlin permutation/gradient generation would go here if needed; the Python
// side precomputes those cheaply with NumPy (texture/perlin.rs:17-48).
// ---------------------------------------------------------------------------

}  // extern "C"
