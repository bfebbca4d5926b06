"""A plain path tracer of the book's semantics, the benchmark's reference.

It renders a scene description (``harness/scene.py``'s dictionary, made
from the seed by a configuration) with its own geometry, textures, light
sampling and random numbers, and shares no code with the program under
test.  Semantics (Ray Tracing in One Weekend / The Next Week / The Rest
of Your Life, as Jerx2y/Raytracer-2022 keeps them):

- camera: ``Camera::get_ray``; pixel (x, y) samples u = (x + U)/(W - 1),
  v = (y + U)/(H - 1), row 0 at the bottom of the viewport;
- primitives: spheres (the quadratic in float64 when the tracer runs in
  float32, so that small far spheres keep their silhouettes), axis
  rectangles (one-sided where flipped), rings (annuli in the plane y = 0,
  normal +y) and triangles (flat normal (b - a) x (c - a));
- a hit is accepted in [1e-3, inf); a scattered ray leaves from the hit
  point moved 1e-4 * max(|p|_inf, 1) along the face normal, to the side
  it leaves by;
- materials: lambertian (texture albedo; the 50/50 mixture of the lights
  and the cosine lobe, weight albedo * cos/pi / pdf, a pdf <= 0 or NaN
  ends the path), metal (mirror plus fuzz times a point in the unit ball,
  always scattered), dielectric (Schlick; attenuation 1), diffuse light
  (emits its texture on front faces and ends the path);
- textures: solid colours and images (nearest texel of the sphere's uv,
  rows read from the bottom, u8 / 255.999);
- a path evaluates at most ``depth`` vertices; a miss adds the background.

Everything runs in ``dtype`` (float32 for the reference, a lower
precision for the control), with TF32 off.  Tensors are row-major (N, 3).
With ``requires_grad`` leaves (:class:`Tables`'s ``leaves``) the tracer is
differentiable: the search runs without gradients and the winner's t is
computed again from the leaves' graph.
"""

from __future__ import annotations

import math

import numpy as np
import torch

T_MIN = 1e-3
SPAWN_EPS = 1e-4
LAMBERTIAN, METAL, DIELECTRIC, LIGHT = 0, 1, 2, 3
SPHERE, RECT, RING, TRIANGLE = 0, 1, 2, 3
MAT_KINDS = {"lambertian": LAMBERTIAN, "metal": METAL, "dielectric": DIELECTRIC, "light": LIGHT}
CLUSTER = 32  # triangles per cluster of the mesh's culling boxes
SPHERE_GROUP = 8  # spheres per group of the spheres' culling boxes
CAMERA_LEAVES = ("origin", "lower_left", "horizontal", "vertical", "u", "v", "w", "lens_radius", "time0", "time1")
INF = math.inf

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def rot_y(deg: float) -> np.ndarray:
    """RotateY: x' = cos x + sin z, z' = -sin x + cos z."""
    a = math.radians(deg)
    c, s = math.cos(a), math.sin(a)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])


def mesh_world(mesh: dict) -> np.ndarray:
    """The mesh's triangles (F, 3, 3) in world space: zoomed, rotated about
    y, then translated."""
    v = np.asarray(mesh["verts"], dtype=np.float64) * float(mesh["zoom"])
    v = v @ rot_y(float(mesh["rot_y"])).T + np.asarray(mesh["translate"], dtype=np.float64)
    return v[np.asarray(mesh["faces"])]


def camera(cam: dict) -> dict:
    """``Camera::new``: the ten camera quantities, in float64 numpy."""
    lookfrom = np.asarray(cam["lookfrom"], dtype=np.float64)
    lookat = np.asarray(cam["lookat"], dtype=np.float64)
    vup = np.asarray(cam["vup"], dtype=np.float64)
    h = math.tan(math.radians(cam["vfov"]) / 2.0)
    vh = 2.0 * h
    vw = cam["aspect_ratio"] * vh
    w = lookfrom - lookat
    w = w / np.linalg.norm(w)
    u = np.cross(vup, w)
    u = u / np.linalg.norm(u)
    v = np.cross(w, u)
    fd = cam["focus_dist"]
    horizontal = u * vw * fd
    vertical = v * vh * fd
    return {"origin": lookfrom, "lower_left": lookfrom - horizontal / 2 - vertical / 2 - w * fd,
            "horizontal": horizontal, "vertical": vertical, "u": u, "v": v, "w": w,
            "lens_radius": np.float64(cam["aperture"] / 2.0), "time0": np.float64(cam.get("time0", 0.0)),
            "time1": np.float64(cam.get("time1", 1.0))}


def texture_table(desc: dict) -> tuple:
    """One texture a material, in material order: (colour (3, M), image
    index or -1 (M,)).  A dielectric's texture is white; an image texture's
    colour is black."""
    mats = desc["materials"]
    color = np.zeros((3, len(mats)))
    img = np.full(len(mats), -1, dtype=np.int64)
    for i, m in enumerate(mats):
        if m["kind"] == "dielectric":
            color[:, i] = 1.0
        elif "image" in m:
            img[i] = int(m["image"])
        else:
            color[:, i] = m["color"]
    return color, img


class Tables:
    """The description on ``device`` in ``dtype``; ``leaves`` (a dict of
    ``mat_param``, ``tex_color`` and the camera's ten quantities) replaces
    the description's values, for gradients."""

    def __init__(self, desc: dict, device, dtype=torch.float32, leaves=None):
        self.device = torch.device(device)
        self.dtype = dtype
        self.qdtype = torch.float64 if dtype == torch.float32 else dtype
        self.background = torch.tensor(desc.get("background", (0.0, 0.0, 0.0)), dtype=dtype, device=device)
        f = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64), device=device).to(dtype)  # noqa: E731
        mats = desc["materials"]
        self.mat_kind = torch.tensor([MAT_KINDS[m["kind"]] for m in mats], device=device)
        color, img = texture_table(desc)
        self.tex_img = torch.as_tensor(img, device=device)
        leaves = dict(leaves or {})
        self.mat_param = leaves.get("mat_param", f([m.get("param", 0.0) for m in mats]))
        self.tex_color = leaves.get("tex_color", f(color))
        cam = camera(desc["camera"])
        self.cam = {k: leaves.get(k, f(cam[k])) for k in CAMERA_LEAVES}
        images = desc.get("images", [])
        self.images = [torch.as_tensor(np.ascontiguousarray(im), device=device) for im in images]
        sph = desc.get("spheres")
        self.n_sph = 0 if sph is None else len(sph["radius"])
        if self.n_sph:
            # spheres in groups of SPHERE_GROUP along a Morton curve, each group
            # boxed; ``sph_pos`` maps the description's index to the sorted one
            cen = np.asarray(sph["center"], dtype=np.float64)
            rad = np.asarray(sph["radius"], dtype=np.float64)
            order = np.argsort(_morton(cen), kind="stable")
            self.sph_pos = np.argsort(order)
            cen, rad = _pad(cen[order], SPHERE_GROUP), _pad(rad[order], SPHERE_GROUP)
            self.sph_c = f(cen)
            self.sph_r = f(rad)
            self.sph_cq = torch.as_tensor(cen, device=device).to(self.qdtype)
            self.sph_rq = torch.as_tensor(rad, device=device).to(self.qdtype)
            self.sph_mat = torch.as_tensor(_pad(np.asarray(sph["mat"])[order], SPHERE_GROUP), device=device).long()
            lo = (cen - rad[:, None]).reshape(-1, SPHERE_GROUP, 3)
            hi = (cen + rad[:, None]).reshape(-1, SPHERE_GROUP, 3)
            self.sg_lo, self.sg_hi = f(lo.min(axis=1)), f(hi.max(axis=1))
        rects = desc.get("rects", [])
        self.n_rect = len(rects)
        if rects:
            self.rect = f([[r["axis"], *r["a"], *r["b"], r["k"]] for r in rects])  # (R, 6)
            self.rect_axis = torch.tensor([int(r["axis"]) for r in rects], device=device)
            self.rect_mat = torch.tensor([int(r["mat"]) for r in rects], device=device)
            self.rect_flip = torch.tensor([bool(r.get("flip", False)) for r in rects], device=device)
        rings = desc.get("rings")
        self.n_ring = 0 if rings is None else len(rings["radius"])
        if self.n_ring:
            r = np.asarray(rings["radius"], dtype=np.float64)
            t = np.asarray(rings["thickness"], dtype=np.float64)
            lo, hi = (r - t) ** 2, (r + t) ** 2
            order = np.argsort(lo, kind="stable")
            self.ring_lo = f(lo[order])
            self.ring_hi = f(np.maximum.accumulate(hi[order]))  # some ring at or below reaches this far
            self.ring_mat = torch.as_tensor(np.asarray(rings["mat"])[order], device=device).long()
        mesh = desc.get("mesh")
        self.n_tri = 0
        if mesh is not None:
            tri = mesh_world(mesh)
            cen = tri.mean(axis=1)
            order = np.argsort(_morton(cen), kind="stable")
            tri = tri[order]
            n_cl = -(-len(tri) // CLUSTER)
            pad = n_cl * CLUSTER - len(tri)
            tri_p = np.concatenate([tri, np.repeat(tri[-1:], pad, axis=0)]) if pad else tri
            self.n_tri = len(tri)
            self.tri = f(tri_p)  # (C * CLUSTER, 3, 3)
            blocks = tri_p.reshape(n_cl, CLUSTER * 3, 3)
            self.cl_lo = f(blocks.min(axis=1))
            self.cl_hi = f(blocks.max(axis=1))
            self.mesh_lo, self.mesh_hi = f(tri.reshape(-1, 3).min(axis=0)[None]), f(tri.reshape(-1, 3).max(axis=0)[None])
            self.tri_mat = int(mesh["mat"])
        self.lights = [(SPHERE if k == "sphere" else RECT, int(i)) for k, i in desc.get("lights", [])]

    # ------------------------------------------------------------------ rays
    def camera_rays(self, xs, ys, width: int, height: int, gen):
        """Camera rays through pixels (xs, ys) with jitter and lens samples."""
        c = self.cam
        n = xs.shape[0]
        s = (xs.to(self.dtype) + _rand(gen, (n,), self.dtype)) / (width - 1)
        t = (ys.to(self.dtype) + _rand(gen, (n,), self.dtype)) / (height - 1)
        r = torch.sqrt(_rand(gen, (n,), self.dtype))
        phi = 2.0 * math.pi * _rand(gen, (n,), self.dtype)
        rd0, rd1 = r * torch.cos(phi) * c["lens_radius"], r * torch.sin(phi) * c["lens_radius"]
        offset = c["u"][None] * rd0[:, None] + c["v"][None] * rd1[:, None]
        o = c["origin"][None] + offset
        d = c["lower_left"][None] + c["horizontal"][None] * s[:, None] + c["vertical"][None] * t[:, None] \
            - c["origin"][None] - offset
        _rand(gen, (n,), self.dtype)  # shutter time: no moving geometry here
        return o, d

    # --------------------------------------------------------------- search
    def closest(self, o, d):
        """Closest hit of each ray -> (t, kind, index); kind -1 on a miss."""
        n = o.shape[0]
        best_t = torch.full((n,), INF, dtype=self.dtype, device=self.device)
        best_k = torch.full((n,), -1, dtype=torch.long, device=self.device)
        best_i = torch.zeros((n,), dtype=torch.long, device=self.device)

        def fold(t, k, i):
            nonlocal best_t, best_k, best_i
            better = t < best_t
            best_t = torch.where(better, t, best_t)
            best_k = torch.where(better, torch.full_like(best_k, k), best_k)
            best_i = torch.where(better, i, best_i)

        with torch.no_grad():
            if self.n_sph:
                oq, dq = o.to(self.qdtype), d.to(self.qdtype)

                def sphere_test(r, ids):
                    return _sphere_t(oq[r][:, None], dq[r][:, None], self.sph_cq[ids], self.sph_rq[ids]).to(self.dtype)

                t, i = _clustered(o, d, self.sg_lo, self.sg_hi, best_t, sphere_test, SPHERE_GROUP)
                fold(t, SPHERE, i)
            if self.n_rect:
                t = _rect_t(self.rect[None], self.rect_axis[None], o[:, None], d[:, None])
                tm, im = t.min(dim=1)
                fold(tm, RECT, im)
            if self.n_ring:
                t, idx = self._ring_t(o, d)
                fold(t, RING, idx)
            if self.n_tri:
                t, idx = self._mesh_t(o, d, best_t)
                fold(t, TRIANGLE, idx)
        return best_t, best_k, best_i

    def _ring_t(self, o, d):
        t = -o[:, 1] / d[:, 1]
        px, pz = o[:, 0] + t * d[:, 0], o[:, 2] + t * d[:, 2]
        r2 = px * px + pz * pz
        idx = torch.searchsorted(self.ring_lo.float().contiguous(), r2.float().contiguous(), right=True) - 1
        ok = (d[:, 1] != 0) & (t >= T_MIN) & (idx >= 0)
        idx = idx.clamp(min=0)
        ok = ok & (r2 <= self.ring_hi[idx])
        return torch.where(ok, t, INF), idx

    def _mesh_t(self, o, d, t_cur):
        """Triangles: rays against the mesh's box, those inside against the
        clusters' boxes, then the clusters a ray's box test admits, triangle
        by triangle (Moller-Trumbore)."""
        n = o.shape[0]
        best = torch.full((n,), INF, dtype=self.dtype, device=self.device)
        best_i = torch.zeros((n,), dtype=torch.long, device=self.device)
        sub = _box_hits(o, d, self.mesh_lo, self.mesh_hi, t_cur)[:, 0].nonzero(as_tuple=True)[0]
        if sub.numel():
            os_, ds_ = o[sub], d[sub]

            def tri_test(r, ids):
                return _tri_t(os_[r][:, None], ds_[r][:, None], self.tri[ids])

            t, i = _clustered(os_, ds_, self.cl_lo, self.cl_hi, t_cur[sub], tri_test, CLUSTER)
            best[sub], best_i[sub] = t, i
        return best, best_i.clamp(max=max(self.n_tri - 1, 0))

    # ------------------------------------------------------------ hit record
    def hit_record(self, o, d, t, kind, idx):
        """Point, face normal, front face, material and sphere uv of each
        hit.  ``t`` is recomputed from the (possibly differentiable) rays
        and scene for the winning primitive."""
        n = o.shape[0]
        dev, dt = self.device, self.dtype
        zeros = torch.zeros((n,), dtype=dt, device=dev)
        out_n = torch.zeros((n, 3), dtype=dt, device=dev)
        out_n[:, 0] = 1.0  # a miss keeps a unit normal: every later formula stays finite
        mat = torch.zeros((n,), dtype=torch.long, device=dev)
        flip = torch.zeros((n,), dtype=torch.bool, device=dev)
        t_exact = torch.where(torch.isfinite(t), t, zeros).detach()
        uu, vv = zeros, zeros
        if self.n_sph:
            m = kind == SPHERE
            i = torch.where(m, idx, 0)
            c, r = self.sph_c[i], self.sph_r[i]
            # the sphere's t again, differentiable, on the root the search chose
            oc = o - c
            a = (d * d).sum(1)
            hb = (oc * d).sum(1)
            sq = torch.sqrt(torch.clamp(hb * hb - a * ((oc * oc).sum(1) - r * r), min=0))
            r1, r2 = (-hb - sq) / a, (-hb + sq) / a
            near_root = (t - r1.detach()).abs() <= (t - r2.detach()).abs()
            t_exact = torch.where(m, torch.where(near_root, r1, r2), t_exact)
            nrm = (o + d * t_exact[:, None] - c) / r[:, None]
            out_n = torch.where(m[:, None], nrm, out_n)
            mat = torch.where(m, self.sph_mat[i], mat)
            theta = torch.acos(torch.clamp(-nrm[:, 1], -1 + 1e-7, 1 - 1e-7))
            phi = torch.atan2(-nrm[:, 2], nrm[:, 0]) + math.pi
            uu = torch.where(m, phi / (2 * math.pi), uu)
            vv = torch.where(m, theta / math.pi, vv)
        if self.n_rect:
            m = kind == RECT
            i = torch.where(m, idx, 0)
            ax = self.rect_axis[i]
            k = self.rect[i, 5]
            o_ax = torch.gather(o, 1, ax[:, None])[:, 0]
            d_ax = torch.gather(d, 1, ax[:, None])[:, 0]
            t_r = (k - o_ax) / torch.where(d_ax == 0, torch.ones_like(d_ax), d_ax)
            t_exact = torch.where(m, t_r, t_exact)
            out_n = torch.where(m[:, None], torch.nn.functional.one_hot(ax, 3).to(dt), out_n)
            mat = torch.where(m, self.rect_mat[i], mat)
            flip = flip | (m & self.rect_flip[i])
        if self.n_ring:
            m = kind == RING
            t_g = -o[:, 1] / torch.where(d[:, 1] == 0, torch.ones_like(d[:, 1]), d[:, 1])
            t_exact = torch.where(m, t_g, t_exact)
            out_n = torch.where(m[:, None], torch.tensor([0.0, 1.0, 0.0], dtype=dt, device=dev)[None], out_n)
            mat = torch.where(m, self.ring_mat[torch.where(m, idx, 0)], mat)
        if self.n_tri:
            m = kind == TRIANGLE
            tri = self.tri[torch.where(m, idx, 0)]
            e1, e2 = tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]
            cr = torch.linalg.cross(e1, e2)
            nrm = cr / torch.linalg.vector_norm(cr, dim=1, keepdim=True).clamp(min=1e-30)
            den = (d * nrm).sum(1)
            t_tri = ((tri[:, 0] - o) * nrm).sum(1) / torch.where(den == 0, torch.ones_like(den), den)
            t_exact = torch.where(m, t_tri, t_exact)
            out_n = torch.where(m[:, None], nrm, out_n)
            mat = torch.where(m, torch.full_like(mat, self.tri_mat), mat)
        p = o + d * t_exact[:, None]
        front = (d * out_n).sum(1) < 0
        face = torch.where(front[:, None], out_n, -out_n)
        return p, face, front ^ flip, mat, uu, vv

    def albedo(self, mat, uu, vv):
        """Texture value (N, 3) of each hit's material."""
        col = self.tex_color.t()[mat]
        img = self.tex_img[mat]
        for k, im in enumerate(self.images):
            m = img == k
            if not bool(m.any()):
                continue
            h, w = im.shape[0], im.shape[1]
            i = torch.clamp((torch.clamp(uu, 0, 1) * w).floor().long(), 0, w - 1)
            j = torch.clamp((torch.clamp(vv, 0, 1) * h).floor().long(), 0, h - 1)
            tex = im[h - 1 - j, i].to(self.dtype) * (1.0 / 255.999)
            col = torch.where(m[:, None], tex, col)
        return col

    # --------------------------------------------------------------- lights
    def light_pdf(self, p, v):
        """Mean over the lights of each light's pdf of direction ``v`` from ``p``."""
        total = torch.zeros(p.shape[0], dtype=self.dtype, device=self.device)
        for kind, i in self.lights:
            if kind == SPHERE:
                i = int(self.sph_pos[i])
                c, r = self.sph_c[i], self.sph_r[i]
                t = _sphere_t(p.to(self.qdtype), v.to(self.qdtype), self.sph_cq[i], self.sph_rq[i])
                dist2 = ((c - p) ** 2).sum(1)
                rel = 1 - r * r / dist2
                cos_max = torch.sqrt(torch.where(rel > 0, rel, torch.ones_like(rel)))
                cos_max = torch.where(rel > 0, cos_max, torch.full_like(rel, math.nan))
                pdf = 1.0 / (2 * math.pi * (1 - cos_max))
                total = total + torch.where(torch.isfinite(t), pdf, torch.zeros_like(pdf))
            else:
                row = self.rect[i]
                ax = int(self.rect_axis[i])
                t = _rect_t(row[None], self.rect_axis[i:i + 1][None], p[:, None], v[:, None])[:, 0]
                ok = torch.isfinite(t)
                ts = torch.where(ok, t, torch.zeros_like(t))
                vlen2 = (v * v).sum(1)
                cos = v[:, ax].abs() / torch.sqrt(vlen2)
                area = (row[2] - row[1]) * (row[4] - row[3])
                den = cos * area
                ok = ok & (den > 0)
                pdf = ts * ts * vlen2 / torch.where(den > 0, den, torch.ones_like(den))
                total = total + torch.where(ok, pdf, torch.zeros_like(pdf))
        return total / max(len(self.lights), 1)

    def sample_light(self, p, gen):
        """A direction toward a light picked uniformly, sampled on it."""
        n = p.shape[0]
        pick = torch.randint(0, len(self.lights), (n,), generator=gen, device=self.device)
        out = torch.zeros_like(p)
        r1, r2 = _rand(gen, (n,), self.dtype), _rand(gen, (n,), self.dtype)
        for j, (kind, i) in enumerate(self.lights):
            m = pick == j
            if kind == SPHERE:
                i = int(self.sph_pos[i])
                dirc = self.sph_c[i][None] - p
                dist2 = (dirc * dirc).sum(1)
                rel = 1 - self.sph_r[i] ** 2 / dist2
                cos_max = torch.sqrt(torch.clamp(rel, min=0))
                z = 1 + r2 * (cos_max - 1)
                s = torch.sqrt(torch.clamp(1 - z * z, min=0))
                phi = 2 * math.pi * r1
                local = torch.stack([torch.cos(phi) * s, torch.sin(phi) * s, z], 1)
                dirs = _to_world(dirc, local)
            else:
                row = self.rect[i]
                ax = int(self.rect_axis[i])
                a = row[1] + r1 * (row[2] - row[1])
                b = row[3] + r2 * (row[4] - row[3])
                k = row[5].expand(n)
                pt = {0: (k, a, b), 1: (a, k, b), 2: (a, b, k)}[ax]
                dirs = torch.stack(pt, 1) - p
            out = torch.where(m[:, None], dirs, out)
        return out


def _pad(a: np.ndarray, k: int) -> np.ndarray:
    """``a`` with its last row repeated up to a multiple of ``k`` rows."""
    pad = -len(a) % k
    return np.concatenate([a, np.repeat(a[-1:], pad, axis=0)]) if pad else a


def _box_hits(o, d, lo, hi, t_cur):
    """Slab test of rays against boxes (G, 3) -> bool (N, G): the ray meets
    the box in [T_MIN, t_cur]."""
    inv = 1.0 / torch.where(d == 0, torch.full_like(d, 1e-30), d)
    t0 = (lo[None] - o[:, None]) * inv[:, None]
    t1 = (hi[None] - o[:, None]) * inv[:, None]
    near = torch.minimum(t0, t1).amax(dim=2)
    far = torch.maximum(t0, t1).amin(dim=2)
    return (near <= far) & (far >= T_MIN) & (near <= t_cur[:, None])


def _clustered(o, d, lo, hi, t_cur, test, size: int):
    """Closest hit among primitives stored in groups of ``size`` with boxes
    (lo, hi) -> (t, index): each ray tests the groups whose box it meets
    (``test(rays, ids)`` -> t (P, size) for rays and primitive ids)."""
    n = o.shape[0]
    dev, dt = o.device, o.dtype
    ray, grp = _box_hits(o, d, lo, hi, t_cur).nonzero(as_tuple=True)
    best = torch.full((n,), INF, dtype=dt, device=dev)
    best_i = torch.zeros((n,), dtype=torch.long, device=dev)
    step = max(1, (1 << 21) // size)
    for p0 in range(0, ray.shape[0], step):
        r, g = ray[p0:p0 + step], grp[p0:p0 + step]
        ids = g[:, None] * size + torch.arange(size, device=dev)[None]
        t = test(r, ids)
        tm, im = t.min(dim=1)
        gid = g * size + im
        cur = torch.full((n,), INF, dtype=dt, device=dev).scatter_reduce(0, r, tm, reduce="amin")
        win = (tm == cur[r]) & torch.isfinite(tm)
        pick = torch.zeros((n,), dtype=torch.long, device=dev)
        pick[r[win]] = gid[win]
        better = cur < best
        best = torch.where(better, cur, best)
        best_i = torch.where(better, pick, best_i)
    return best, best_i


def _rand(gen, shape, dtype):
    return torch.rand(shape, generator=gen, device=gen.device).to(dtype)


def _morton(points: np.ndarray) -> np.ndarray:
    """Morton codes of points (10 bits an axis) for spatially coherent clusters."""
    lo, hi = points.min(axis=0), points.max(axis=0)
    q = np.clip(((points - lo) / np.maximum(hi - lo, 1e-30) * 1023).astype(np.int64), 0, 1023)
    code = np.zeros(len(points), dtype=np.int64)
    for bit in range(10):
        for ax in range(3):
            code |= ((q[:, ax] >> bit) & 1) << (3 * bit + ax)
    return code


def _sphere_t(o, d, c, r):
    """Nearer root of the sphere quadratic in [T_MIN, inf), else inf."""
    oc = o - c
    a = (d * d).sum(-1)
    hb = (oc * d).sum(-1)
    cc = (oc * oc).sum(-1) - r * r
    disc = hb * hb - a * cc
    sq = torch.sqrt(torch.clamp(disc, min=0))
    r1 = (-hb - sq) / a
    r2 = (-hb + sq) / a
    ok = disc >= 0
    return torch.where(ok & (r1 >= T_MIN), r1, torch.where(ok & (r2 >= T_MIN), r2, INF))


def _rect_t(row, axis, o, d):
    """Axis rectangle: plane solve and bounds.  ``row`` is (axis, a0, a1,
    b0, b1, k); the in-plane axes are (y, z), (x, z), (x, y)."""
    a_ax = torch.where(axis == 0, 1, 0)
    b_ax = torch.where(axis == 2, 1, 2)
    shape = torch.broadcast_shapes(o.shape[:-1], row.shape[:-1])
    sel = lambda v, ax: torch.gather(v.expand(*shape, 3), -1, ax.expand(shape)[..., None])[..., 0]  # noqa: E731
    ok_ = sel(o, axis)
    dk = sel(d, axis)
    t = (row[..., 5] - ok_) / torch.where(dk == 0, torch.ones_like(dk), dk)
    av = sel(o, a_ax) + t * sel(d, a_ax)
    bv = sel(o, b_ax) + t * sel(d, b_ax)
    ok = (dk != 0) & (t >= T_MIN) & (av >= row[..., 1]) & (av <= row[..., 2]) & (bv >= row[..., 3]) \
        & (bv <= row[..., 4])
    return torch.where(ok, t, INF)


def _tri_t(o, d, tri):
    """Moller-Trumbore against triangles ``tri`` (..., 3, 3)."""
    v0 = tri[..., 0, :]
    e1 = tri[..., 1, :] - v0
    e2 = tri[..., 2, :] - v0
    pv = torch.linalg.cross(d.expand_as(e2), e2)
    det = (e1 * pv).sum(-1)
    inv = 1.0 / torch.where(det == 0, torch.ones_like(det), det)
    tv = o - v0
    u = (tv * pv).sum(-1) * inv
    qv = torch.linalg.cross(tv, e1)
    v = (d * qv).sum(-1) * inv
    t = (e2 * qv).sum(-1) * inv
    ok = (det != 0) & (u >= 0) & (v >= 0) & (u + v <= 1) & (t >= T_MIN)
    return torch.where(ok, t, INF)


def _unit(v):
    return v / torch.linalg.vector_norm(v, dim=1, keepdim=True)


def _to_world(axis, local):
    """``local`` in the orthonormal basis about ``axis`` (w = unit(axis);
    a = y if |w.x| > 0.9 else x; v = unit(w x a); u = w x v)."""
    w = _unit(axis)
    use_y = w[:, 0].abs() > 0.9
    a = torch.zeros_like(w)
    a[:, 0] = (~use_y).to(w.dtype)
    a[:, 1] = use_y.to(w.dtype)
    v = _unit(torch.linalg.cross(w, a))
    u = torch.linalg.cross(w, v)
    return u * local[:, :1] + v * local[:, 1:2] + w * local[:, 2:3]


def _in_ball(gen, n, dtype, device):
    z = 2 * _rand(gen, (n,), dtype) - 1
    phi = 2 * math.pi * _rand(gen, (n,), dtype)
    r = torch.sqrt(torch.clamp(1 - z * z, min=0))
    rad = _rand(gen, (n,), dtype) ** (1.0 / 3.0)
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], 1) * rad[:, None]


def trace(tab: Tables, o, d, gen, depth: int):
    """Radiance (N, 3) of the paths that start with rays (o, d)."""
    n = o.shape[0]
    dev, dt = tab.device, tab.dtype
    radiance = torch.zeros((n, 3), dtype=dt, device=dev)
    lane = torch.arange(n, device=dev)
    thr = torch.ones((n, 3), dtype=dt, device=dev)
    for b in range(depth):
        m = lane.shape[0]
        if m == 0:
            break
        t, kind, idx = tab.closest(o, d)
        hit = kind >= 0
        p, nrm, front, mat, uu, vv = tab.hit_record(o, d, t, kind, idx)
        mk = torch.where(hit, tab.mat_kind[mat], -1)
        alb = tab.albedo(mat, uu, vv)
        add = torch.where((~hit)[:, None], thr * tab.background[None], torch.zeros_like(thr))
        add = add + torch.where((hit & (mk == LIGHT) & front)[:, None], thr * alb, torch.zeros_like(thr))
        radiance = radiance.index_add(0, lane, add)
        if b == depth - 1:
            break
        unit_d = _unit(d)
        # lambertian: 50/50 mixture of the lights and the cosine lobe
        r1, r2 = _rand(gen, (m,), dt), _rand(gen, (m,), dt)
        sq2 = torch.sqrt(r2)
        local = torch.stack([torch.cos(2 * math.pi * r1) * sq2, torch.sin(2 * math.pi * r1) * sq2,
                             torch.sqrt(1 - r2)], 1)
        cos_dir = _to_world(nrm, local)
        if tab.lights:
            light_dir = tab.sample_light(p, gen)
            pick = _rand(gen, (m,), dt) < 0.5
            new_dir = torch.where(pick[:, None], light_dir, cos_dir)
            # lanes that do not scatter diffusely take the normal: a light's own
            # point gives a zero direction, whose NaN gradient would leak
            new_dir = torch.where((hit & (mk == LAMBERTIAN))[:, None], new_dir, nrm)
            cos_n = (_unit(new_dir) * _unit(nrm)).sum(1)
            pdf = 0.5 * tab.light_pdf(p, new_dir) + 0.5 * torch.where(cos_n <= 0, torch.zeros_like(cos_n),
                                                                      cos_n / math.pi)
        else:
            new_dir = cos_dir
            cos_n = (_unit(new_dir) * _unit(nrm)).sum(1)
            pdf = torch.where(cos_n <= 0, torch.zeros_like(cos_n), cos_n / math.pi)
        spdf = (nrm * _unit(new_dir)).sum(1)
        spdf = torch.where(spdf < 0, torch.zeros_like(spdf), spdf / math.pi)
        pdf_ok = pdf > 0
        lamb = hit & (mk == LAMBERTIAN) & pdf_ok
        w_l = alb * (spdf / torch.where(pdf_ok, pdf, torch.ones_like(pdf)))[:, None]
        # metal: mirror plus fuzz
        refl = unit_d - 2 * (unit_d * nrm).sum(1, keepdim=True) * nrm
        param = tab.mat_param[mat]
        metal_dir = refl + _in_ball(gen, m, dt, dev) * param[:, None]
        metal = hit & (mk == METAL)
        # dielectric
        ir = torch.where(mk == DIELECTRIC, param, torch.full_like(param, 1.5))
        ratio = torch.where(front, 1 / ir, ir)
        cos_t = torch.clamp((-unit_d * nrm).sum(1), max=1.0)
        sin_t = torch.sqrt(torch.clamp(1 - cos_t * cos_t, min=0))
        r0 = ((1 - ratio) / (1 + ratio)) ** 2
        schlick = r0 + (1 - r0) * (1 - cos_t) ** 5
        do_refl = (ratio * sin_t > 1) | (schlick > _rand(gen, (m,), dt))
        perp = (unit_d + cos_t[:, None] * nrm) * ratio[:, None]
        par = -torch.sqrt(torch.clamp((1 - (perp * perp).sum(1)).abs(), min=1e-12))[:, None] * nrm
        diel_dir = torch.where(do_refl[:, None], refl, perp + par)
        diel = hit & (mk == DIELECTRIC)
        cont = lamb | metal | diel
        nd = torch.where(lamb[:, None], new_dir, torch.where(metal[:, None], metal_dir, diel_dir))
        thr = torch.where(lamb[:, None], thr * w_l, torch.where(metal[:, None], thr * alb, thr))
        eps = SPAWN_EPS * torch.clamp(p.detach().abs().amax(dim=1), min=1.0)
        side = torch.sign((nrm * nd).sum(1))
        o = p + nrm * (eps * side)[:, None]
        keep = cont.nonzero(as_tuple=True)[0]
        lane, o, d, thr = lane[keep], o[keep], nd[keep], thr[keep]
    return radiance


def render_sums(tab: Tables, width: int, height: int, spp: int, depth: int, seed: int,
                block_lanes: int = 1 << 19):
    """Reference frame: (sum, sum of squares) of ``spp`` samples a pixel,
    float64 (3, H, W) each, in blocks of ``block_lanes`` paths."""
    dev = tab.device
    total = width * height * spp
    s = torch.zeros((3, height * width), dtype=torch.float64, device=dev)
    q = torch.zeros_like(s)
    gen = torch.Generator(device=dev)
    with torch.no_grad():
        for k, l0 in enumerate(range(0, total, block_lanes)):
            gen.manual_seed(int(np.random.SeedSequence([seed, 7, k]).generate_state(1, np.uint64)[0]) >> 1)
            lanes = torch.arange(l0, min(l0 + block_lanes, total), device=dev)
            pix = lanes // spp
            o, d = tab.camera_rays(pix % width, pix // width, width, height, gen)
            rad = trace(tab, o, d, gen, depth).to(torch.float64)
            s.index_add_(1, pix, rad.t())
            q.index_add_(1, pix, (rad * rad).t())
    return s.reshape(3, height, width), q.reshape(3, height, width)
