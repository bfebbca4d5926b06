"""Batched ray-primitive intersection (wavefront closest hit), PyTorch.

Counterpart of ``raytracer2022_tpu/ops/intersect.py``:

  * ``candidate_t`` evaluates candidate hit distances for rays x prims on
    the broadcast ``(P, N)`` grid, one formula per homogeneous kind window,
    on object-space rays where prims carry unbaked transforms;
  * ``traverse_clusters`` walks one cluster tree: one slab pass of every
    ray against the cluster boxes, then rounds in which each ray visits its
    next-nearest cluster, on the compacted lanes that can still improve;
  * ``closest_hit`` folds the dense windows first, then every tree (the
    8-ary kernel :func:`ops.bvh8.traverse_bvh8` where the tree has a packet
    tree, the cluster walk otherwise), then the constant media;
  * ``hit_details`` reconstructs the hit record of the winning primitive,
    from the kernel's winner rows when every tree ran the kernel.

The JAX package's one-hot MXU fetches (``ops/tables.py``) are plain
indexing here.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ..scene.types import BOX, MEDIUM, MSPHERE, RECT, RING, SPHERE, TRIANGLE, SceneData
from ..utils.profiling import host_sync, span
from .shade import shade_for_mats
from .vecmath import cross, dot, safe_div, scale, vec3

INF = math.inf
PI = math.pi

# per-kind param-row count used by the closest-hit t formulas
NPARAM_T = {SPHERE: 4, MSPHERE: 9, RECT: 6, TRIANGLE: 9, RING: 4, BOX: 6}

# bound on the elements of one (prims, rays) transient of the eager scans
_SCAN_ELEMS = 16 << 20


@dataclasses.dataclass(frozen=True)
class Hit:
    """SoA hit record (reference HitRecord, hittable/mod.rs:18-57)."""

    hit: torch.Tensor  # bool[N]
    t: torch.Tensor  # f32[N]
    prim: torch.Tensor  # i64[N]
    p: torch.Tensor  # f32[3, N]
    normal: torch.Tensor  # f32[3, N] face normal, opposing the ray
    front: torch.Tensor  # bool[N] (FlipFace applied)
    u: torch.Tensor  # f32[N]
    v: torch.Tensor  # f32[N]
    tex_uv: torch.Tensor  # f32[2, N]
    mat: torch.Tensor  # i64[N]


# --------------------------------------------------------------------------
# per-kind candidate-t formulas (shapes broadcast)
# --------------------------------------------------------------------------


def _sphere_t(center, radius, o, d, t_min, t_max):
    """Quadratic two-root selection (sphere.rs:39-66): a root is accepted
    iff ``t_min <= root <= t_max``.  The quadratic itself runs in f64
    (:func:`ops.bvh8.sphere_roots`, shared with kernel K1)."""
    from .bvh8 import sphere_roots

    root1, root2, ok = sphere_roots(
        o[0] - center[0], o[1] - center[1], o[2] - center[2], d[0], d[1], d[2], radius
    )
    v1 = ok & (root1 >= t_min) & (root1 <= t_max)
    v2 = ok & (root2 >= t_min) & (root2 <= t_max)
    return torch.where(v1, root1, torch.where(v2, root2, INF))


def _msphere_center(p, tm):
    """Center lerped to the ray time (sphere.rs:124-127) as (cx, cy, cz)."""
    frac = safe_div(tm - p[7], p[8] - p[7])
    return (
        p[0] + (p[4] - p[0]) * frac,
        p[1] + (p[5] - p[1]) * frac,
        p[2] + (p[6] - p[2]) * frac,
    )


def _axis_select(v, axis):
    """Component ``axis`` (an integer tensor) of a (3, ...) vector."""
    return torch.where(axis == 0, v[0], torch.where(axis == 1, v[1], v[2]))


def _rect_axes(ka):
    """Constant axis -> the two in-plane axes: XYRect ka=2 -> (x, y);
    XZRect ka=1 -> (x, z); YZRect ka=0 -> (y, z) (aarect.rs:13-260)."""
    a_axis = torch.where(ka == 0, 1, 0)
    b_axis = torch.where(ka == 2, 1, 2)
    return a_axis, b_axis


def _rect_t(p, o, d, t_min, t_max):
    """Axis-rect plane solve + bounds (aarect.rs:47-66 et al.)."""
    ka = p[5].to(torch.int32)
    a0, a1, b0, b1, k = p[0], p[1], p[2], p[3], p[4]
    a_axis, b_axis = _rect_axes(ka)
    ok_ = _axis_select(o, ka)
    dk = _axis_select(d, ka)
    t = safe_div(k - ok_, dk)
    av = _axis_select(o, a_axis) + t * _axis_select(d, a_axis)
    bv = _axis_select(o, b_axis) + t * _axis_select(d, b_axis)
    valid = (
        (dk != 0.0) & (t >= t_min) & (t <= t_max)
        & (av >= a0) & (av <= a1) & (bv >= b0) & (bv <= b1)
    )
    return torch.where(valid, t, INF)


def _tri_t(p, o, d, t_min, t_max):
    """Plane hit + three cross-product sign tests (triangle.rs:33-63)."""

    def sub(ax, ay, az, bx, by, bz):
        return ax - bx, ay - by, az - bz

    def crs(ax, ay, az, bx, by, bz):
        return ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx

    def dt(ax, ay, az, bx, by, bz):
        return ax * bx + ay * by + az * bz

    ax, ay, az = p[0], p[1], p[2]
    bx, by, bz = p[3], p[4], p[5]
    cx, cy, cz = p[6], p[7], p[8]
    ab = sub(bx, by, bz, ax, ay, az)
    ac = sub(cx, cy, cz, ax, ay, az)
    nx, ny, nz = crs(*ab, *ac)
    nlen = torch.sqrt(nx * nx + ny * ny + nz * nz)
    inv = 1.0 / torch.where(nlen == 0.0, 1.0, nlen)
    nx, ny, nz = nx * inv, ny * inv, nz * inv
    denom = dt(d[0], d[1], d[2], nx, ny, nz)
    t = safe_div(dt(ax - o[0], ay - o[1], az - o[2], nx, ny, nz), denom)
    px, py, pz = o[0] + d[0] * t, o[1] + d[1] * t, o[2] + d[2] * t

    ca = sub(ax, ay, az, cx, cy, cz)  # a - c = -(c - a)
    e0 = crs(-ca[0], -ca[1], -ca[2], px - ax, py - ay, pz - az)
    r0 = crs(-ca[0], -ca[1], -ca[2], *ab)
    ba = sub(ax, ay, az, bx, by, bz)
    e1 = crs(*ba, px - bx, py - by, pz - bz)
    r1 = crs(*ba, cx - bx, cy - by, cz - bz)
    cb = sub(bx, by, bz, cx, cy, cz)
    e2 = crs(*cb, px - cx, py - cy, pz - cz)
    r2 = crs(*cb, ax - cx, ay - cy, az - cz)
    inside = (dt(*e0, *r0) >= 0.0) & (dt(*e1, *r1) >= 0.0) & (dt(*e2, *r2) >= 0.0)
    valid = (denom != 0.0) & (nlen != 0.0) & (t >= t_min) & (t <= t_max) & inside
    return torch.where(valid, t, INF)


def _ring_t(p, o, d, t_min, t_max):
    """Flat annulus in plane y=0 (ring.rs:36-52)."""
    t = safe_div(-o[1], d[1])
    px = o[0] + t * d[0]
    pz = o[2] + t * d[2]
    dd = px * px + pz * pz
    valid = (d[1] != 0.0) & (t >= t_min) & (t <= t_max) & (dd >= p[2]) & (dd <= p[3])
    return torch.where(valid, t, INF)


def _box_t(p, o, d, t_min, t_max):
    """Axis-aligned box slab test, equal to the closest hit over the 6 face
    rects the reference builds (boxes.rs:23-66).  d_a == 0 uses IEEE inf;
    torch.minimum/maximum propagate NaN as jnp's do, so a ray lying on a
    face plane misses."""
    inv0 = 1.0 / d[0]
    inv1 = 1.0 / d[1]
    inv2 = 1.0 / d[2]
    a0 = (p[0] - o[0]) * inv0
    b0 = (p[3] - o[0]) * inv0
    a1 = (p[1] - o[1]) * inv1
    b1 = (p[4] - o[1]) * inv1
    a2 = (p[2] - o[2]) * inv2
    b2 = (p[5] - o[2]) * inv2
    near = torch.maximum(
        torch.maximum(torch.minimum(a0, b0), torch.minimum(a1, b1)), torch.minimum(a2, b2)
    )
    far = torch.minimum(
        torch.minimum(torch.maximum(a0, b0), torch.maximum(a1, b1)), torch.maximum(a2, b2)
    )
    t = torch.where(near >= t_min, near, far)
    valid = (far >= near) & (t >= t_min) & (t <= t_max)
    return torch.where(valid, t, INF)


def _shape_of(x):
    return tuple(x.shape) if isinstance(x, torch.Tensor) else ()


def _t_for_kind(k: int, p, o, d, tm, t_min, t_max):
    """Single-kind candidate t (``k`` a Python int)."""
    if k == SPHERE:
        return _sphere_t((p[0], p[1], p[2]), p[3], o, d, t_min, t_max)
    if k == MSPHERE:
        return _sphere_t(_msphere_center(p, tm), p[3], o, d, t_min, t_max)
    if k == RECT:
        return _rect_t(p, o, d, t_min, t_max)
    if k == TRIANGLE:
        return _tri_t(p, o, d, t_min, t_max)
    if k == RING:
        return _ring_t(p, o, d, t_min, t_max)
    if k == BOX:
        return _box_t(p, o, d, t_min, t_max)
    # MEDIUM rows yield +inf here
    shape = torch.broadcast_shapes(o.shape[1:], _shape_of(t_min), _shape_of(t_max))
    return torch.full(shape, INF, dtype=o.dtype, device=o.device)


def _t_switch(kind, p, o, d, tm, t_min, t_max, kinds=None):
    """Masked evaluation selected by integer ``kind``; ``kinds`` lists the
    kinds that can occur."""
    kinds = [k for k in (kinds or (SPHERE, MSPHERE, RECT, TRIANGLE, RING, BOX)) if k != MEDIUM]
    shape = torch.broadcast_shapes(tuple(kind.shape), o.shape[1:])
    t = torch.full(shape, INF, dtype=o.dtype, device=o.device)
    for k in kinds:
        t = torch.where(kind == k, _t_for_kind(k, p, o, d, tm, t_min, t_max), t)
    return t


# --------------------------------------------------------------------------
# world -> object transforms
# --------------------------------------------------------------------------


def _apply_rot(rot, v):
    """rot: (3, 3, ...); v: (3, ...) -> R @ v."""
    return vec3(
        rot[0, 0] * v[0] + rot[0, 1] * v[1] + rot[0, 2] * v[2],
        rot[1, 0] * v[0] + rot[1, 1] * v[1] + rot[1, 2] * v[2],
        rot[2, 0] * v[0] + rot[2, 1] * v[1] + rot[2, 2] * v[2],
    )


def _apply_rot_t(rot, v):
    """rot: (3, 3, ...); v: (3, ...) -> R^T @ v."""
    return vec3(
        rot[0, 0] * v[0] + rot[1, 0] * v[1] + rot[2, 0] * v[2],
        rot[0, 1] * v[0] + rot[1, 1] * v[1] + rot[2, 1] * v[2],
        rot[0, 2] * v[0] + rot[1, 2] * v[1] + rot[2, 2] * v[2],
    )


def _xform_rays(rot, trans, inv_s, o, d):
    """World -> object similarity: o' = R(o - t)/s, d' = R d / s.  The hit
    parameter t is preserved (unlike the reference's Zoom quirk,
    hittable/mod.rs:321-330)."""
    o2 = _apply_rot(rot, o - trans) * inv_s[None]
    d2 = _apply_rot(rot, d) * inv_s[None]
    return o2, d2


# --------------------------------------------------------------------------
# candidate t
# --------------------------------------------------------------------------


def candidate_t(
    scene: SceneData,
    o: torch.Tensor,  # (3, N)
    d: torch.Tensor,
    tm: torch.Tensor,  # (N,)
    t_min,
    t_max,  # scalar or (N,)
    prim_slice: Optional[slice] = None,
    include_inactive: bool = False,
) -> torch.Tensor:
    """Candidate hit t for every (prim, ray) pair -> f32[P_slice, N].

    Where the window is covered by the compiler's homogeneous
    ``kind_ranges`` each sub-window runs exactly one formula; otherwise the
    masked switch over the kinds present.  Inactive rows (medium
    boundaries) are +inf unless ``include_inactive``.
    """
    lo = prim_slice.start if prim_slice is not None else 0
    hi = prim_slice.stop if prim_slice is not None else scene.n_prims
    tmb = tm[None, :]

    windows = [
        (k, max(s, lo), min(e, hi))
        for (k, s, e) in scene.stats.kind_ranges
        if max(s, lo) < min(e, hi)
    ]
    if sum(e - s for _, s, e in windows) != hi - lo:
        windows = None

    def eval_window(sl, kinds):
        p = scene.params[:, sl][:, :, None]  # (16, W, 1)
        ob = o[:, None, :]  # (3, 1, N)
        db = d[:, None, :]
        if scene.any_xform:
            ob, db = _xform_rays(
                scene.xf_rot[:, :, sl, None],
                scene.xf_trans[:, sl, None],
                scene.xf_inv_scale[sl, None],
                ob,
                db,
            )
        if len(kinds) == 1:
            t = _t_for_kind(kinds[0], p, ob, db, tmb, t_min, t_max)
            t = t.expand(sl.stop - sl.start, o.shape[1])
        else:
            t = _t_switch(scene.kind[sl][:, None], p, ob, db, tmb, t_min, t_max, kinds)
        if not include_inactive:
            t = torch.where(scene.active[sl][:, None], t, INF)
        return t

    if windows is None:
        return eval_window(slice(lo, hi), scene.stats.kinds_present or None)
    parts = [eval_window(slice(s, e), (k,)) for k, s, e in windows]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)


def _medium_t(scene: SceneData, med_prim: int, b_start: int, b_count: int, o, d, tm, t_min, gen):
    """Stochastic constant-medium hit t per ray (constantmedium.rs:50-76).

    Entry = closest boundary hit in (-inf, inf); exit = closest boundary hit
    in (entry + 1e-4, inf); then an exponential free flight against the
    density.  ``torch.rand`` draws from [0, 1): ln(0) = -inf gives an
    infinite hit distance, a miss, as the reference's ``rnd.log(E)`` on
    (0, 1) would.
    """
    bsl = slice(b_start, b_start + b_count)
    t_entry = candidate_t(
        scene, o, d, tm, -INF, INF, prim_slice=bsl, include_inactive=True
    ).amin(dim=0)
    t_exit = candidate_t(
        scene, o, d, tm, t_entry + 1e-4, INF, prim_slice=bsl, include_inactive=True
    ).amin(dim=0)
    has_both = torch.isfinite(t_entry) & torch.isfinite(t_exit)

    neg_inv_density = scene.params[0, med_prim]
    rec1 = torch.clamp(torch.where(has_both, t_entry, 0.0), min=t_min)
    rec2 = torch.where(has_both, t_exit, 0.0)
    ok_span = rec1 < rec2
    rec1 = torch.clamp(rec1, min=0.0)
    ray_len = torch.sqrt(dot(d, d))
    dist_inside = (rec2 - rec1) * ray_len
    u = torch.rand(rec1.shape, generator=gen, device=rec1.device)
    hit_distance = neg_inv_density * torch.log(u)
    ok = has_both & ok_span & (hit_distance <= dist_inside)
    t = rec1 + hit_distance / ray_len
    return torch.where(ok, t, INF)


# --------------------------------------------------------------------------
# cluster walk
# --------------------------------------------------------------------------


def traverse_clusters(
    scene: SceneData,
    tree_idx: int,
    o,
    d,
    tm,
    t_min: float,
    t_max,  # scalar or (N,)
    t_init: Optional[torch.Tensor] = None,
):
    """Closest hit over one cluster tree -> (t f32[N], best i64[N]).

    The JAX package visits clusters per 64-lane block, front to back, and
    fetches each cluster's packed columns with a one-hot MXU product.  Here
    every ray visits its own clusters front to back:

      1. one slab pass of all rays against the C cluster boxes gives each
         ray's entry distance per cluster, sorted per ray;
      2. round ``k`` takes the lanes whose ``k``-th nearest cluster starts
         before their closest hit so far, compacts them, gathers each lane's
         cluster columns from ``ClusterTree.pack`` (prim params and, for
         transformed trees, per-prim transforms), tests the cluster's ``m``
         prims in chunks and folds the result.  Slot ``j`` holds prim
         ``start + min(j, count - 1)`` (padding repeats the last prim).

    Rounds end when no lane can improve, after at most C rounds: one host
    synchronisation (the compaction) per round.  ``t_init`` (the closest
    hit so far) prunes; where nothing beats it, ``t`` is ``t_init`` and
    ``best`` is 0, as where nothing is hit at all.
    """
    ct = scene.clusters[tree_idx]
    kind, n_clusters, m, npar, has_xf = scene.stats.trees[tree_idx]
    n = o.shape[1]
    dev = o.device
    t_cap = torch.as_tensor(t_max, dtype=torch.float32, device=dev).expand(n)
    if t_init is None:
        t_best = torch.full((n,), INF, dtype=torch.float32, device=dev)
    else:
        t_best = t_init.clone()
    best = torch.zeros((n,), dtype=torch.int64, device=dev)
    if n == 0:
        return t_best, best

    # 1. entry distance per (cluster, ray) (slab test, aabb.rs:15-32); IEEE
    # inf on zero direction components; NaN (0 * inf) rejects the box
    inv_d = 1.0 / d
    near = far = None
    for a in range(3):
        t0 = (ct.bmin[a][:, None] - o[a][None]) * inv_d[a][None]
        t1 = (ct.bmax[a][:, None] - o[a][None]) * inv_d[a][None]
        lo_a, hi_a = torch.minimum(t0, t1), torch.maximum(t0, t1)
        near = lo_a if near is None else torch.maximum(near, lo_a)
        far = hi_a if far is None else torch.minimum(far, hi_a)
    near = torch.clamp(near, min=t_min)
    far = torch.minimum(far, t_cap[None])
    entry = torch.where(far >= near, near, INF)  # (C, N)
    es, order = torch.sort(entry, dim=0)

    params = ct.pack[2 : 2 + npar * m].view(npar, m, n_clusters)
    if has_xf:
        base = 2 + npar * m
        rot_all = ct.pack[base : base + 9 * m].view(3, 3, m, n_clusters)
        trans_all = ct.pack[base + 9 * m : base + 12 * m].view(3, m, n_clusters)
        inv_s_all = ct.pack[base + 12 * m : base + 13 * m]  # (m, C)

    # 2. rounds: every lane's k-th nearest cluster
    for k in range(n_clusters):
        # es is sorted per lane and t_best only falls: once no lane can
        # improve in round k, none can in a later round
        idx = host_sync(torch.nonzero, es[k] < t_best).squeeze(1)
        n_k = idx.shape[0]
        if n_k == 0:
            break
        c = order[k, idx]
        ol, dl, tml = o[:, idx][:, None], d[:, idx][:, None], tm[idx][None]
        tb = t_best[idx]
        cur_max = torch.minimum(tb, t_cap[idx])[None]
        start = ct.pack[0, c].long()
        count = ct.pack[1, c].long()
        mc = max(1, min(m, _SCAN_ELEMS // (2 * n_k)))
        tw = torch.full((n_k,), INF, dtype=torch.float32, device=dev)
        am = torch.zeros((n_k,), dtype=torch.int64, device=dev)
        for js in range(0, m, mc):
            je = min(js + mc, m)
            p = params[:, js:je][:, :, c]  # (npar, mc, n_k)
            oo, dd = ol, dl
            if has_xf:
                oo, dd = _xform_rays(
                    rot_all[:, :, js:je][:, :, :, c],
                    trans_all[:, js:je][:, :, c],
                    inv_s_all[js:je][:, c],
                    ol,
                    dl,
                )
            t_j = _t_for_kind(kind, p, oo, dd, tml, t_min, cur_max)
            tw_c, am_c = t_j.min(dim=0)
            take = tw_c < tw  # ties keep the lower slot, like an argmin
            tw = torch.where(take, tw_c, tw)
            am = torch.where(take, am_c + js, am)
        upd = tw < tb
        t_best[idx] = torch.where(upd, tw, tb)
        best[idx] = torch.where(upd, start + torch.minimum(am, count - 1), best[idx])
    return t_best, best


# --------------------------------------------------------------------------
# hit details
# --------------------------------------------------------------------------


def _sphere_uv(n):
    """Spherical uv from the outward unit normal (sphere.rs:30-34)."""
    theta = torch.arccos(torch.clamp(-n[1], -1.0 + 1e-7, 1.0 - 1e-7))
    phi = torch.atan2(-n[2], n[0]) + PI
    return phi / (2.0 * PI), theta / PI


def _identity_xform(n: int, device):
    """Identity transforms of ``n`` lanes -> (rot (3,3,N), trans (3,N), inv_s (N,))."""
    eye = torch.eye(3, dtype=torch.float32, device=device)[:, :, None].expand(3, 3, n)
    return (
        eye,
        torch.zeros((3, n), dtype=torch.float32, device=device),
        torch.ones((n,), dtype=torch.float32, device=device),
    )


def hit_details(
    scene: SceneData,
    o,
    d,
    tm,
    t_best,
    best,
    hit_mask,
    win_rows: Optional[torch.Tensor] = None,
):
    """Hit record of the winning primitive -> ``(Hit, Shade)``.

    Without ``win_rows`` the winner's row (and transform) is fetched from
    the scene tables.  ``win_rows`` (f32[NCOL, N], the kernel's winner leaf
    rows) supplies the row of winners inside the tree region, whose
    transforms are the identity (packet trees hold untransformed prims
    only); only dense-tail winners are fetched from the tables.  Normals
    and uvs are computed on object-space rays, then p and the normal go
    back to world space.
    """
    from .bvh8 import COL_FLIP, COL_KIND, COL_MAT

    best = best.long()
    npar = scene.params.shape[0]
    xf = scene.any_xform
    if win_rows is None:
        p = scene.params[:, best]
        kind = scene.kind[best]
        mat = scene.mat_id[best]
        flip = scene.flip[best]
        if xf:
            rot = scene.xf_rot[:, :, best]
            trans = scene.xf_trans[:, best]
            inv_s = scene.xf_inv_scale[best]
    else:
        tail_lo = scene.stats.n_in_bvh
        is_tree = best < tail_lo
        kind_tree = torch.round(win_rows[COL_KIND]).to(torch.int32)
        mat_tree = torch.round(win_rows[COL_MAT]).to(torch.int32)
        flip_tree = win_rows[COL_FLIP] > 0.5
        if tail_lo < scene.n_prims:
            idx_t = torch.clamp(best, min=tail_lo)
            p = torch.where(is_tree[None], win_rows[:npar], scene.params[:, idx_t])
            kind = torch.where(is_tree, kind_tree, scene.kind[idx_t])
            mat = torch.where(is_tree, mat_tree, scene.mat_id[idx_t])
            flip = torch.where(is_tree, flip_tree, scene.flip[idx_t])
            if xf:
                rot_i, trans_i, inv_s_i = _identity_xform(best.shape[0], best.device)
                rot = torch.where(is_tree[None, None], rot_i, scene.xf_rot[:, :, idx_t])
                trans = torch.where(is_tree[None], trans_i, scene.xf_trans[:, idx_t])
                inv_s = torch.where(is_tree, inv_s_i, scene.xf_inv_scale[idx_t])
        else:
            p = win_rows[:npar]
            kind, mat, flip = kind_tree, mat_tree, flip_tree
            if xf:
                rot, trans, inv_s = _identity_xform(best.shape[0], best.device)
    mat = mat.long()
    shade = shade_for_mats(scene, mat)

    if xf:
        oo, od = _xform_rays(rot, trans, inv_s, o, d)
    else:
        oo, od = o, d
    pt = oo + scale(od, t_best)  # object-space hit point

    kinds = scene.stats.kinds_present or (SPHERE, MSPHERE, RECT, TRIANGLE, RING, MEDIUM, BOX)
    zeros = torch.zeros_like(t_best)
    ones = torch.ones_like(t_best)

    outward = vec3(ones, zeros, zeros)
    u = zeros
    v = zeros
    tex_u = zeros
    tex_v = zeros

    if SPHERE in kinds or MSPHERE in kinds:
        # sphere / moving sphere (sphere.rs:58-66, 138-165)
        c_static = vec3(p[0], p[1], p[2])
        if MSPHERE in kinds:
            center = torch.where(
                (kind == MSPHERE)[None], vec3(*_msphere_center(p, tm)), c_static
            )
        else:
            center = c_static
        n_sphere = (pt - center) / torch.where(p[3] == 0.0, 1.0, p[3])[None]
        u_sph, v_sph = _sphere_uv(n_sphere)
        is_sph = kind <= MSPHERE
        outward = torch.where(is_sph[None], n_sphere, outward)
        u = torch.where(is_sph, u_sph, u)
        v = torch.where(is_sph, v_sph, v)

    if RECT in kinds:
        # rect (aarect.rs:58-66 et al.)
        ka = p[5].to(torch.int32)
        a_axis, b_axis = _rect_axes(ka)
        av = _axis_select(pt, a_axis)
        bv = _axis_select(pt, b_axis)
        n_rect = vec3(
            torch.where(ka == 0, ones, zeros),
            torch.where(ka == 1, ones, zeros),
            torch.where(ka == 2, ones, zeros),
        )
        is_rect = kind == RECT
        outward = torch.where(is_rect[None], n_rect, outward)
        u = torch.where(is_rect, safe_div(av - p[0], p[1] - p[0]), u)
        v = torch.where(is_rect, safe_div(bv - p[2], p[3] - p[2]), v)

    if TRIANGLE in kinds:
        # triangle (triangle.rs:51-72): flat normal + (beta, gamma) 2x2 solve
        ta = vec3(p[0], p[1], p[2])
        tb = vec3(p[3], p[4], p[5])
        tc = vec3(p[6], p[7], p[8])
        tcr = cross(tb - ta, tc - ta)
        tlen = torch.sqrt(dot(tcr, tcr))
        n_tri = tcr / torch.where(tlen == 0.0, 1.0, tlen)[None]
        a1 = ta[0] - tb[0]
        b1 = ta[0] - tc[0]
        c1 = ta[0] - pt[0]
        a2 = ta[1] - tb[1]
        b2 = ta[1] - tc[1]
        c2 = ta[1] - pt[1]
        det = a1 * b2 - b1 * a2
        beta = safe_div(c1 * b2 - b1 * c2, det)
        gamma = safe_div(a1 * c2 - a2 * c1, det)
        alpha = 1.0 - beta - gamma
        is_tri = kind == TRIANGLE
        outward = torch.where(is_tri[None], n_tri, outward)
        u = torch.where(is_tri, beta, u)
        v = torch.where(is_tri, gamma, v)
        tex_u = torch.where(is_tri, p[9] * alpha + p[11] * beta + p[13] * gamma, tex_u)
        tex_v = torch.where(is_tri, p[10] * alpha + p[12] * beta + p[14] * gamma, tex_v)

    if RING in kinds:
        # ring (ring.rs:48-51): +y normal, uv left at 0
        outward = torch.where((kind == RING)[None], vec3(zeros, ones, zeros), outward)

    if BOX in kinds:
        # the winning face is the axis whose face-plane t matches t_best;
        # an axis-parallel ray cannot hit that axis' faces
        errs = []
        for a in range(3):
            t_lo = safe_div(p[a] - oo[a], od[a])
            t_hi = safe_div(p[3 + a] - oo[a], od[a])
            err_a = torch.minimum(torch.abs(t_best - t_lo), torch.abs(t_best - t_hi))
            errs.append(torch.where(od[a] == 0.0, INF, err_a))
        ka_box = torch.argmin(torch.stack(errs), dim=0).to(torch.int32)
        a_axis, b_axis = _rect_axes(ka_box)
        lo3 = vec3(p[0], p[1], p[2])
        hi3 = vec3(p[3], p[4], p[5])
        av = _axis_select(pt, a_axis)
        bv = _axis_select(pt, b_axis)
        a0 = _axis_select(lo3, a_axis)
        a1 = _axis_select(hi3, a_axis)
        b0 = _axis_select(lo3, b_axis)
        b1 = _axis_select(hi3, b_axis)
        n_box = vec3(
            torch.where(ka_box == 0, ones, zeros),
            torch.where(ka_box == 1, ones, zeros),
            torch.where(ka_box == 2, ones, zeros),
        )
        is_box = kind == BOX
        outward = torch.where(is_box[None], n_box, outward)
        u = torch.where(is_box, safe_div(av - a0, a1 - a0), u)
        v = torch.where(is_box, safe_div(bv - b0, b1 - b0), v)

    # set_face_normal in the object frame (hittable/mod.rs:49-56); for a
    # similarity transform the sign agrees with the world frame.  Mediums
    # are always front (constantmedium.rs:69-76)
    is_medium = kind == MEDIUM
    front = (dot(od, outward) < 0.0) | is_medium
    face_normal = torch.where(front[None], outward, -outward)

    # back to world space: n_w = R^T n_obj, p_w = R^T (p_obj * s) + trans
    if xf:
        p_world = _apply_rot_t(rot, pt * (1.0 / inv_s)[None]) + trans
        n_world = _apply_rot_t(rot, face_normal)
    else:
        p_world = pt
        n_world = face_normal

    # FlipFace toggles front_face only (hittable/mod.rs:279-284)
    front = front ^ flip

    hit = Hit(
        hit=hit_mask,
        t=t_best,
        prim=best,
        p=p_world,
        normal=n_world,
        front=front,
        u=u,
        v=v,
        tex_uv=torch.stack([tex_u, tex_v], dim=0),
        mat=mat,
    )
    return hit, shade


# --------------------------------------------------------------------------
# unified closest hit
# --------------------------------------------------------------------------


def _dense_window_scan(scene, k, s, e, chunk, o, d, tm, t_min, t_max, t_best, best):
    """Scan a homogeneous window [s, e) in prim chunks of ``chunk`` rows,
    folding each chunk's min into the running (t_best, best): the
    transient stays ``(chunk, N)``.  A later chunk wins only on a strictly
    smaller t, so ties keep the smallest prim id."""
    ob = o[:, None, :]
    db = d[:, None, :]
    tmb = tm[None, :]
    for cs in range(s, e, chunk):
        ce = min(cs + chunk, e)
        p = scene.params[:, cs:ce][:, :, None]
        oo, dd = ob, db
        if scene.any_xform:
            oo, dd = _xform_rays(
                scene.xf_rot[:, :, cs:ce, None],
                scene.xf_trans[:, cs:ce, None],
                scene.xf_inv_scale[cs:ce, None],
                ob,
                db,
            )
        t_w = _t_for_kind(k, p, oo, dd, tmb, t_min, t_max).expand(ce - cs, o.shape[1])
        t_w = torch.where(scene.active[cs:ce][:, None], t_w, INF)
        tw, bw = t_w.min(dim=0)
        take = tw < t_best
        t_best = torch.where(take, tw, t_best)
        best = torch.where(take, bw + cs, best)
    return t_best, best


def _recompute_tree_t(scene: SceneData, o, d, tm, t_min, t_best, best, win_rows):
    """The tree winners' hit distance, recomputed differentiably ->
    ``(t_best, win_rows)`` (the JAX package's closest_hit l. 1028-1080).

    The tree walks search under stop-gradient; this reconnects ``t`` to
    the rays and to ``scene.params`` with one evaluation of each winner's
    own formula (``_t_switch``, on object-space rays for transformed
    prims).  The kernel's winner rows are baked copies of the params, so
    the winners' rows are re-fetched from ``scene.params`` (numerically
    identical) and grafted into ``win_rows``: the normals and uvs of
    :func:`hit_details` then carry geometry gradients too.  Packet trees
    hold untransformed prims only."""
    from .bvh8 import COL_KIND

    tree_lo = scene.stats.n_in_bvh
    oo, od = o, d
    if win_rows is not None:
        npar = scene.params.shape[0]
        is_tree = best < tree_lo
        p_w = scene.params[:, torch.clamp(best, max=tree_lo - 1)]
        kind_w = torch.round(win_rows[COL_KIND]).to(torch.int32)
        win_rows = torch.cat([torch.where(is_tree[None], p_w, win_rows[:npar]), win_rows[npar:]])
    else:
        p_w = scene.params[:, best]
        kind_w = scene.kind[best]
        if scene.any_xform:
            oo, od = _xform_rays(
                scene.xf_rot[:, :, best], scene.xf_trans[:, best], scene.xf_inv_scale[best], o, d
            )
    t_rec = _t_switch(kind_w, p_w, oo, od, tm, t_min, INF, scene.stats.kinds_present)
    sel = (best < tree_lo) & torch.isfinite(t_best) & torch.isfinite(t_rec)
    return torch.where(sel, t_rec, t_best), win_rows


def closest_hit(
    scene: SceneData,
    o,
    d,
    tm,
    t_min: float,
    t_max: float,
    gen: Optional[torch.Generator] = None,
    recompute_t: bool = True,
):
    """Closest hit over the whole scene -> ``(Hit, Shade)``.

    The dense (brute-force) region first: its large occluders tighten
    t_best, which the tree walks then take as their starting bound.  Each
    tree with an 8-ary packet tree runs :func:`traverse_bvh8` (kernel K1
    on the card); every other tree (transformed, or of a kind without a
    packet tree) runs :func:`traverse_clusters`.  The kernel's winner rows
    feed :func:`hit_details` only when every tree ran the kernel; otherwise
    the winners are fetched from the tables.  Constant media come last;
    their free flights draw from ``gen`` (the default generator if None).

    Gradients: both tree walks search on detached rays (K1 has no
    backward), so the card and the CPU's plain walk give one convention;
    with ``recompute_t`` (the default, as in the JAX package) the tree
    winners' ``t`` is recomputed differentiably from ``scene.params``
    (:func:`_recompute_tree_t`).  Forward renders pass False and skip it.
    The dense windows and the media are differentiable as they stand.
    """
    from .bvh8 import traverse_bvh8

    n = o.shape[1]
    t_best = torch.full((n,), INF, dtype=o.dtype, device=o.device)
    best = torch.zeros((n,), dtype=torch.int64, device=o.device)
    brute_lo = scene.stats.n_in_bvh

    ranges = [r for r in scene.stats.kind_ranges if r[2] > brute_lo]
    if not ranges and not scene.clusters and scene.n_prims > 0:
        ranges = [(-1, 0, scene.n_prims)]  # full masked switch
    # bound the (chunk, N) transients: eager PyTorch materializes each one
    chunk = max(32, min(512, _SCAN_ELEMS // max(n, 1)))
    with span("closest_hit.dense"):
        for k, s, e in ranges:
            s = max(s, brute_lo)
            if k == MEDIUM:
                continue
            if e - s <= chunk:
                t_w = candidate_t(scene, o, d, tm, t_min, t_max, prim_slice=slice(s, e))
                tw, bw = t_w.min(dim=0)
                take = tw < t_best
                t_best = torch.where(take, tw, t_best)
                best = torch.where(take, bw + s, best)
            else:
                t_best, best = _dense_window_scan(
                    scene, k, s, e, chunk, o, d, tm, t_min, t_max, t_best, best
                )

    # winner rows only when every tree has a packet tree (JAX l. 979-984)
    want_rows = (
        len(scene.clusters) > 0
        and len(scene.bvh8) == len(scene.clusters)
        and all(t8 is not None for t8 in scene.bvh8)
    )
    win_rows = None
    # the walks search on detached rays; their t re-enters below (recompute)
    o_s, d_s, tm_s = o.detach(), d.detach(), tm.detach()
    for i in range(len(scene.clusters)):
        tree8 = scene.bvh8[i] if i < len(scene.bvh8) else None
        t_init = t_best.detach()
        if tree8 is not None:
            with span("closest_hit.packet_tree"):
                out = traverse_bvh8(
                    tree8, scene.stats.trees[i][0], o_s, d_s, tm_s, float(t_min),
                    t_init=t_init, return_rows=want_rows,
                )
            t_i, b_i = out[0], out[1]
            take = (b_i >= 0) & (t_i < t_best) & (t_i <= t_max)
            if want_rows:
                win_rows = out[2] if win_rows is None else torch.where(take[None], out[2], win_rows)
        else:
            with span("closest_hit.cluster_walk"):
                t_i, b_i = traverse_clusters(scene, i, o_s, d_s, tm_s, t_min, t_max, t_init=t_init)
            take = t_i < t_best
        t_best = torch.where(take, t_i, t_best)
        best = torch.where(take, b_i.long(), best)

    with span("closest_hit.media"):
        for med_prim, b_start, b_count in scene.stats.mediums:
            tmed = _medium_t(scene, med_prim, b_start, b_count, o, d, tm, t_min, gen)
            take = (tmed <= t_max) & (tmed < t_best)
            t_best = torch.where(take, tmed, t_best)
            best = torch.where(take, med_prim, best)

    if scene.clusters and recompute_t:
        t_best, win_rows = _recompute_tree_t(scene, o, d, tm, t_min, t_best, best, win_rows)

    hit_mask = torch.isfinite(t_best)
    safe_t = torch.where(hit_mask, t_best, 1.0)
    with span("closest_hit.hit_details"):
        return hit_details(scene, o, d, tm, safe_t, best, hit_mask, win_rows=win_rows)
