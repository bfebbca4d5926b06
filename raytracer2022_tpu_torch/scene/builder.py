"""Scene compiler: declarative builders -> flat SoA tensors (PyTorch).

Counterpart of ``raytracer2022_tpu/scene/builder.py``, ported whole: the
same constructors (sphere/rect/box/triangle/ring/medium, the five
materials, the five textures, the Translate/RotateY/Zoom/FlipFace
wrappers) and the same compilation, in host NumPy, so both compilers emit
identical arrays for the same calls.  Only :meth:`SceneBuilder.finalize`
differs: it hands the arrays to PyTorch on the given device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from ..scene.types import (
    BOX,
    DIELECTRIC,
    DIFFUSE_LIGHT,
    ISOTROPIC,
    LAMBERTIAN,
    MEDIUM,
    METAL,
    MSPHERE,
    NPARAM,
    RECT,
    RING,
    SPHERE,
    TEX_CHECKER,
    TEX_IMAGE,
    TEX_NOISE,
    TEX_OBJUV,
    TEX_SOLID,
    TRIANGLE,
    ClusterTree,
    MaterialTable,
    SceneData,
    SceneStats,
    TextureTable,
)
from ..utils.device import DEFAULT_DEVICE, resolve_device
from ..utils.imageio import read_image

POINT_COUNT = 256


def _perlin_tables(rng: np.random.Generator):
    """Perlin gradient + permutation tables (reference texture/perlin.rs:17-48).

    Matches the reference construction exactly: gradients are uniform-in-cube
    vectors *normalized* (so slightly corner-biased, perlin.rs:20-22), and
    each permutation is an inside-out Fisher-Yates identical to
    ``Perlin::permute`` (perlin.rs:40-48).
    """
    randvec = rng.uniform(-1.0, 1.0, size=(POINT_COUNT, 3))
    randvec /= np.linalg.norm(randvec, axis=1, keepdims=True)
    perms = []
    for _ in range(3):
        p = np.arange(POINT_COUNT)
        for i in range(POINT_COUNT - 1, -1, -1):
            target = rng.integers(0, i + 1)
            p[i], p[target] = p[target], p[i]
        perms.append(p)
    return randvec.T.astype(np.float32), np.stack(perms).astype(np.int32)


@dataclass
class _Xform:
    """Object->world similarity: x_w = s * R @ x + t."""

    s: float = 1.0
    rot: np.ndarray = field(default_factory=lambda: np.eye(3))
    t: np.ndarray = field(default_factory=lambda: np.zeros(3))

    def apply_point(self, p: np.ndarray) -> np.ndarray:
        return self.s * (self.rot @ p) + self.t

    def is_identity(self) -> bool:
        return (
            self.s == 1.0
            and np.array_equal(self.rot, np.eye(3))
            and not self.t.any()
        )


def _rot_y(angle_deg: float) -> np.ndarray:
    """Y-rotation matrix matching RotateY's convention (hittable/mod.rs:239-247):
    hit points map object->world by x' = c*x + s*z, z' = -s*x + c*z."""
    r = math.radians(angle_deg)
    c, s = math.cos(r), math.sin(r)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])


class SceneBuilder:
    """Declarative scene construction with reference-equivalent semantics."""

    def __init__(self, time0: float = 0.0, time1: float = 1.0, seed: int = 0):
        self.time0 = time0
        self.time1 = time1
        self.rng = np.random.default_rng(seed)

        # prims
        self.kind: list[int] = []
        self.params: list[np.ndarray] = []
        self.iparams: list[tuple[int, int]] = []
        self.mat_of: list[int] = []
        self.flip_of: list[bool] = []
        self.active_of: list[bool] = []
        self.xform_of: list[_Xform] = []

        # materials
        self.mat_kind: list[int] = []
        self.mat_tex: list[int] = []
        self.mat_param: list[float] = []

        # textures
        self.tex_kind: list[int] = []
        self.tex_color: list[tuple[float, float, float]] = []
        self.tex_sub: list[tuple[int, int]] = []
        self.tex_scale: list[float] = []
        self.tex_img: list[int] = []
        self.images: list[np.ndarray] = []  # u8[H, W, 3], v-flipped rows
        self._image_cache: dict[str, int] = {}

        self.lights: list[int] = []
        self.mediums: list[tuple[int, int, int]] = []

    # ------------------------------------------------------------- textures
    def _add_texture(self, kind, color=(0.0, 0.0, 0.0), sub=(0, 0), scl=0.0, img=0):
        self.tex_kind.append(kind)
        self.tex_color.append(tuple(float(c) for c in color))
        self.tex_sub.append(sub)
        self.tex_scale.append(float(scl))
        self.tex_img.append(img)
        return len(self.tex_kind) - 1

    def solid(self, color) -> int:
        """SolidColor (texture/mod.rs:14-29)."""
        return self._add_texture(TEX_SOLID, color=color)

    def checker(self, odd_color, even_color) -> int:
        """CheckerTexture over two solids (texture/mod.rs:31-60)."""
        odd = self.solid(odd_color)
        even = self.solid(even_color)
        return self._add_texture(TEX_CHECKER, sub=(odd, even))

    def noise(self, scl: float) -> int:
        """NoiseTexture marble (texture/mod.rs:62-79)."""
        return self._add_texture(TEX_NOISE, scl=scl)

    def _load_image(self, source) -> int:
        if isinstance(source, str):
            if source in self._image_cache:
                return self._image_cache[source]
            arr = read_image(source)  # .jpg/.jpeg/.png, decoded as Pillow's convert("RGB")
            img_id = len(self.images)
            # store rows v-flipped, like ImageTexture::new (texture/mod.rs:96-105)
            self.images.append(arr[::-1].copy())
            self._image_cache[source] = img_id
            return img_id
        arr = np.asarray(source, dtype=np.uint8)
        self.images.append(arr[::-1].copy())
        return len(self.images) - 1

    def image(self, source) -> int:
        """ImageTexture from a file path or u8[H,W,3] array (texture/mod.rs:81-139)."""
        return self._add_texture(TEX_IMAGE, img=self._load_image(source))

    def objuv(self, source) -> int:
        """ObjTexture image (texture/mod.rs:141-189); per-triangle uvs are
        supplied via ``triangle(..., uv=...)``."""
        return self._add_texture(TEX_OBJUV, img=self._load_image(source))

    # ------------------------------------------------------------ materials
    def _tex_id(self, albedo) -> int:
        return albedo if isinstance(albedo, (int, np.integer)) else self.solid(albedo)

    def _add_material(self, kind, tex, param=0.0) -> int:
        self.mat_kind.append(kind)
        self.mat_tex.append(tex)
        self.mat_param.append(float(param))
        return len(self.mat_kind) - 1

    def lambertian(self, albedo) -> int:
        """albedo: (r,g,b) or a texture id (material/mod.rs:27-66)."""
        return self._add_material(LAMBERTIAN, self._tex_id(albedo))

    def metal(self, albedo, fuzz: float) -> int:
        """fuzz clamped to <= 1 like Metal::new (material/mod.rs:74-81)."""
        return self._add_material(METAL, self._tex_id(albedo), min(float(fuzz), 1.0))

    def dielectric(self, ir: float) -> int:
        return self._add_material(DIELECTRIC, self.solid((1.0, 1.0, 1.0)), ir)

    def diffuse_light(self, emit) -> int:
        return self._add_material(DIFFUSE_LIGHT, self._tex_id(emit))

    def isotropic(self, albedo) -> int:
        return self._add_material(ISOTROPIC, self._tex_id(albedo))

    # ----------------------------------------------------------- primitives
    def _add_prim(self, kind, params, mat, iparams=(0, 0), active=True) -> int:
        p = np.zeros(NPARAM)
        p[: len(params)] = params
        self.kind.append(kind)
        self.params.append(p)
        self.iparams.append(iparams)
        self.mat_of.append(mat)
        self.flip_of.append(False)
        self.active_of.append(active)
        self.xform_of.append(_Xform())
        return len(self.kind) - 1

    def sphere(self, center, radius, mat) -> int:
        c = np.asarray(center, dtype=float)
        return self._add_prim(SPHERE, [c[0], c[1], c[2], float(radius)], mat)

    def moving_sphere(self, c0, c1, t0, t1, radius, mat) -> int:
        c0 = np.asarray(c0, dtype=float)
        c1 = np.asarray(c1, dtype=float)
        return self._add_prim(
            MSPHERE, [c0[0], c0[1], c0[2], float(radius), c1[0], c1[1], c1[2], t0, t1], mat
        )

    def _rect(self, a0, a1, b0, b1, k, const_axis, mat) -> int:
        return self._add_prim(RECT, [a0, a1, b0, b1, k, float(const_axis)], mat)

    def rect_xy(self, x0, x1, y0, y1, k, mat) -> int:
        """XYRect (aarect.rs:13-94): z = k plane."""
        return self._rect(x0, x1, y0, y1, k, 2, mat)

    def rect_xz(self, x0, x1, z0, z1, k, mat) -> int:
        """XZRect (aarect.rs:96-177): y = k plane."""
        return self._rect(x0, x1, z0, z1, k, 1, mat)

    def rect_yz(self, y0, y1, z0, z1, k, mat) -> int:
        """YZRect (aarect.rs:179-260): x = k plane."""
        return self._rect(y0, y1, z0, z1, k, 0, mat)

    def box(self, p0, p1, mat, as_rects: bool = False) -> list[int]:
        """Boxes (boxes.rs:23-66).  The reference lowers a box to 6 face
        rects in a HittableList; their closest hit IS the box slab test,
        so the compiler emits ONE fused BOX row by default (~6x cheaper to
        test, identical winning-face t/normal/uv — ops/intersect._box_t).
        ``as_rects=True`` keeps the literal 6-rect lowering (parity
        testing / per-face material experiments)."""
        p0 = np.asarray(p0, dtype=float)
        p1 = np.asarray(p1, dtype=float)
        if as_rects:
            return [
                self.rect_xy(p0[0], p1[0], p0[1], p1[1], p1[2], mat),
                self.rect_xy(p0[0], p1[0], p0[1], p1[1], p0[2], mat),
                self.rect_xz(p0[0], p1[0], p0[2], p1[2], p1[1], mat),
                self.rect_xz(p0[0], p1[0], p0[2], p1[2], p0[1], mat),
                self.rect_yz(p0[1], p1[1], p0[2], p1[2], p1[0], mat),
                self.rect_yz(p0[1], p1[1], p0[2], p1[2], p0[0], mat),
            ]
        return [self._add_prim(BOX, [p0[0], p0[1], p0[2], p1[0], p1[1], p1[2]], mat)]

    def triangle(self, a, b, c, mat, uv: Optional[Sequence] = None) -> int:
        """Triangle (triangle.rs:22-35); ``uv`` = ((u1,v1),(u2,v2),(u3,v3))
        per-vertex image coordinates for ObjTexture."""
        a = np.asarray(a, dtype=float)
        b = np.asarray(b, dtype=float)
        c = np.asarray(c, dtype=float)
        params = [*a, *b, *c]
        if uv is not None:
            uv = np.asarray(uv, dtype=float).reshape(3, 2)
            params += [*uv[0], *uv[1], *uv[2], 1.0]
        return self._add_prim(TRIANGLE, params, mat)

    def ring(self, r, t, mat) -> int:
        """Ring annulus in plane y=0 (ring.rs:24-32)."""
        return self._add_prim(RING, [r, t, (r - t) ** 2, (r + t) ** 2], mat)

    def constant_medium(self, boundary_ids: Sequence[int], density: float, albedo) -> int:
        """ConstantMedium (constantmedium.rs:33-48).

        ``boundary_ids`` must be the contiguous, most recently added prims
        (e.g. the ids returned by :meth:`box` or a single sphere); they are
        demoted to inactive shadow rows that only the medium queries.
        """
        ids = sorted(boundary_ids)
        assert ids == list(range(ids[0], ids[0] + len(ids))), "boundary must be contiguous"
        assert len({self.kind[i] for i in ids}) == 1, (
            "medium boundary must be a single primitive kind (the reference "
            "only wraps Boxes or Sphere); mixed kinds would break the "
            "compiler's kind grouping"
        )
        for i in ids:
            self.active_of[i] = False
        mat = self.isotropic(albedo)
        pid = self._add_prim(MEDIUM, [-1.0 / float(density)], mat, iparams=(ids[0], len(ids)))
        self.mediums.append((pid, ids[0], len(ids)))
        return pid

    # ------------------------------------------------------------- wrappers
    def flip_face(self, prim_ids) -> None:
        """FlipFace (hittable/mod.rs:267-292): toggle front_face."""
        for i in np.atleast_1d(prim_ids):
            self.flip_of[int(i)] = not self.flip_of[int(i)]

    def translate(self, prim_ids, offset) -> None:
        """Translate wrapper (hittable/mod.rs:135-175), composed outermost."""
        offset = np.asarray(offset, dtype=float)
        for i in np.atleast_1d(prim_ids):
            self.xform_of[int(i)].t = self.xform_of[int(i)].t + offset

    def rotate_y(self, prim_ids, angle_deg: float) -> None:
        """RotateY wrapper (hittable/mod.rs:177-265), composed outermost."""
        rot = _rot_y(angle_deg)
        for i in np.atleast_1d(prim_ids):
            xf = self.xform_of[int(i)]
            xf.rot = rot @ xf.rot
            xf.t = rot @ xf.t

    def zoom(self, prim_ids, rate: float) -> None:
        """Zoom wrapper as a proper uniform scale (capability of
        hittable/mod.rs:294-331; see SURVEY.md §2 row 15 on the reference's
        origin-only-scaling quirk)."""
        for i in np.atleast_1d(prim_ids):
            xf = self.xform_of[int(i)]
            xf.s *= rate
            xf.t = xf.t * rate

    def add_light(self, prim_id: int) -> None:
        """Register a primitive in the importance-sampled lights list
        (the reference's separate ``lights`` HittableList, scene.rs:193-195)."""
        self.lights.append(int(prim_id))

    # -------------------------------------------------------------- baking
    def _bake_transforms(self) -> None:
        """Fold similarity transforms into sphere/msphere/triangle params."""
        for i, xf in enumerate(self.xform_of):
            if xf.is_identity():
                continue
            k = self.kind[i]
            p = self.params[i]
            if k == SPHERE:
                p[0:3] = xf.apply_point(p[0:3])
                p[3] *= xf.s
                self.xform_of[i] = _Xform()
            elif k == MSPHERE:
                p[0:3] = xf.apply_point(p[0:3])
                p[4:7] = xf.apply_point(p[4:7])
                p[3] *= xf.s
                self.xform_of[i] = _Xform()
            elif k == TRIANGLE:
                p[0:3] = xf.apply_point(p[0:3])
                p[3:6] = xf.apply_point(p[3:6])
                p[6:9] = xf.apply_point(p[6:9])
                self.xform_of[i] = _Xform()
            # RECT/RING/BOX keep the xform (rotation breaks axis
            # alignment); MEDIUM's geometry is its boundary prims.

    # --------------------------------------------------------------- bboxes
    def prim_bbox(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        """Object bbox then transformed via 8 corners (RotateY's method,
        hittable/mod.rs:192-228)."""
        k = self.kind[i]
        p = self.params[i]
        if k == SPHERE:
            c, r = p[0:3], p[3]
            lo, hi = c - r, c + r
        elif k == MSPHERE:
            r = p[3]
            c0 = p[0:3] + (p[4:7] - p[0:3]) * ((self.time0 - p[7]) / (p[8] - p[7]))
            c1 = p[0:3] + (p[4:7] - p[0:3]) * ((self.time1 - p[7]) / (p[8] - p[7]))
            lo = np.minimum(c0 - r, c1 - r)
            hi = np.maximum(c0 + r, c1 + r)
        elif k == RECT:
            ka = int(p[5])
            axes = {0: (1, 2), 1: (0, 2), 2: (0, 1)}[ka]
            lo = np.zeros(3)
            hi = np.zeros(3)
            lo[axes[0]], hi[axes[0]] = p[0], p[1]
            lo[axes[1]], hi[axes[1]] = p[2], p[3]
            lo[ka], hi[ka] = p[4] - 1e-4, p[4] + 1e-4
        elif k == TRIANGLE:
            v = p[0:9].reshape(3, 3)
            lo, hi = v.min(axis=0), v.max(axis=0)
        elif k == RING:
            r = p[0] + p[1]
            lo = np.array([-r, -1e-4, -r])
            hi = np.array([r, 1e-4, r])
        elif k == BOX:
            lo, hi = p[0:3].copy(), p[3:6].copy()
        elif k == MEDIUM:
            b0, cnt = self.iparams[i]
            los, his = zip(*(self.prim_bbox(j) for j in range(b0, b0 + cnt)))
            return np.min(los, axis=0), np.max(his, axis=0)
        else:
            raise ValueError(f"unknown kind {k}")
        xf = self.xform_of[i]
        if xf.is_identity():
            return lo, hi
        corners = np.array(
            [[x, y, z] for x in (lo[0], hi[0]) for y in (lo[1], hi[1]) for z in (lo[2], hi[2])]
        )
        wc = np.stack([xf.apply_point(c) for c in corners])
        return wc.min(axis=0), wc.max(axis=0)

    # ------------------------------------------------------------- finalize
    def finalize(
        self,
        bvh_threshold: int = 512,
        cluster_size: int = 512,
        bvh8_kinds: Optional[tuple] = None,
        device=DEFAULT_DEVICE,
    ) -> SceneData:
        """Compile to flat tensors on ``device`` (default: the card; without
        one it raises, see :func:`utils.device.resolve_device`).

        Kinds with more than ``bvh_threshold`` active prims get a
        :class:`ClusterTree` (host BVH cut into treelets of <=
        ``cluster_size`` prims) and, for the kinds in ``bvh8_kinds``
        (default: TRIANGLE only) without transforms, an 8-ary packet tree;
        everything else lands in dense kind windows.
        """
        from ..ops.bvh8 import build_bvh8
        from ..ops.intersect import NPARAM_T
        from .bvh import build_bvh

        device = resolve_device(device)

        def dev(a):
            return torch.as_tensor(np.ascontiguousarray(a), device=device)

        self._bake_transforms()

        n = len(self.kind)
        kind = np.array(self.kind, dtype=np.int32)
        params = np.stack(self.params).T.astype(np.float32)  # (16, P)
        mat_id = np.array(self.mat_of, dtype=np.int32)
        flip = np.array(self.flip_of, dtype=bool)
        active = np.array(self.active_of, dtype=bool)
        xf_rot = np.stack([xf.rot.T for xf in self.xform_of], axis=-1).astype(np.float32)
        xf_inv_scale = np.array([1.0 / xf.s for xf in self.xform_of], dtype=np.float32)
        xf_trans = np.stack([xf.t for xf in self.xform_of], axis=-1).astype(np.float32)
        any_xform = not all(xf.is_identity() for xf in self.xform_of)
        lights = np.array(self.lights, dtype=np.int32)

        # --- primitive ordering: one homogeneous cluster tree per active
        # kind above the threshold, the rest in a dense tail grouped by kind
        cluster_meta = []  # (kind, windows (C,2), cbmin, cbmax, pb_lo, pb_hi)
        tree_perm_parts = []
        for k in sorted(set(int(x) for x in kind)):
            if k == MEDIUM:
                continue
            ids = np.nonzero(active & (kind == k))[0]
            if len(ids) <= bvh_threshold:
                continue
            bboxes = [self.prim_bbox(int(i)) for i in ids]
            nodes, order = build_bvh(
                np.stack([b[0] for b in bboxes]),
                np.stack([b[1] for b in bboxes]),
                leaf_size=cluster_size,
            )
            lo = sum(len(p) for p in tree_perm_parts)
            leaf = nodes["leaf_count"] > 0
            pb_lo = np.stack([bboxes[j][0] for j in order])
            pb_hi = np.stack([bboxes[j][1] for j in order])
            cluster_meta.append(
                (
                    k,
                    np.stack(
                        [nodes["leaf_start"][leaf] + lo, nodes["leaf_count"][leaf]], axis=1
                    ),
                    nodes["bmin"][:, leaf],
                    nodes["bmax"][:, leaf],
                    pb_lo,
                    pb_hi,
                )
            )
            tree_perm_parts.append(ids[order])
        n_in_bvh = sum(len(p) for p in tree_perm_parts)
        in_tree = np.zeros(n, dtype=bool)
        for p in tree_perm_parts:
            in_tree[p] = True
        loose_ids = np.nonzero(~in_tree)[0]
        loose_ids = loose_ids[np.argsort(kind[loose_ids], kind="stable")]
        perm = np.concatenate(tree_perm_parts + [loose_ids]) if tree_perm_parts else loose_ids

        inv = np.empty(n, dtype=np.int64)
        inv[perm] = np.arange(n)
        kind = kind[perm]
        params = params[:, perm]
        mat_id = mat_id[perm]
        flip = flip[perm]
        active = active[perm]
        xf_rot = xf_rot[:, :, perm]
        xf_inv_scale = xf_inv_scale[perm]
        xf_trans = xf_trans[:, perm]
        lights = inv[lights].astype(np.int32) if len(lights) else lights
        mediums = tuple((int(inv[pid]), int(inv[b0]), cnt) for pid, b0, cnt in self.mediums)

        # --- per-cluster packed columns (types.ClusterTree) and packet trees
        identity_xf = np.array([xf.is_identity() for xf in self.xform_of])[perm]
        cluster_trees = []
        bvh8_trees = []
        trees = []
        for k, windows, cbmin, cbmax, pb_lo, pb_hi in cluster_meta:
            starts = windows[:, 0]
            counts = windows[:, 1]
            m = cluster_size
            npar = NPARAM_T[k]
            has_xf = bool(not identity_xf[starts[0] : starts[-1] + counts[-1]].all())
            packet_kinds = (TRIANGLE,) if bvh8_kinds is None else bvh8_kinds
            if has_xf or k not in packet_kinds:
                bvh8_trees.append(None)
            else:
                lo8 = int(starts[0])
                gids = np.arange(lo8, lo8 + len(pb_lo))
                bvh8_trees.append(
                    build_bvh8(k, params, mat_id, flip, gids, pb_lo, pb_hi, device=device)
                )
            # slot j of cluster c = prim start_c + min(j, count_c - 1)
            pid = starts[:, None] + np.minimum(np.arange(m)[None, :], counts[:, None] - 1)
            rows = [
                starts[None].astype(np.float32),
                counts[None].astype(np.float32),
                params[:npar, pid].transpose(0, 2, 1).reshape(npar * m, -1),
            ]
            if has_xf:
                rows.append(xf_rot.reshape(9, n)[:, pid].transpose(0, 2, 1).reshape(9 * m, -1))
                rows.append(xf_trans[:, pid].transpose(0, 2, 1).reshape(3 * m, -1))
                rows.append(xf_inv_scale[pid].T)
            cluster_trees.append(
                ClusterTree(
                    bmin=dev(cbmin.astype(np.float32)),
                    bmax=dev(cbmax.astype(np.float32)),
                    pack=dev(np.concatenate(rows, axis=0)),
                )
            )
            trees.append((k, len(starts), m, npar, has_xf))

        # homogeneous kind windows over the brute-forced region
        kind_ranges = []
        i = n_in_bvh
        while i < n:
            j = i
            while j < n and kind[j] == kind[i]:
                j += 1
            kind_ranges.append((int(kind[i]), i, j))
            i = j
        kinds_present = tuple(sorted(set(int(k) for k in kind)))

        # --- texture atlas (u32-packed: R | G<<8 | B<<16)
        if self.images:
            hmax = max(im.shape[0] for im in self.images)
            wmax = max(im.shape[1] for im in self.images)
            atlas = np.zeros((len(self.images), hmax, wmax), dtype=np.uint32)
            sizes = np.zeros((2, len(self.images)), dtype=np.int32)
            for i, im in enumerate(self.images):
                im32 = im.astype(np.uint32)
                atlas[i, : im.shape[0], : im.shape[1]] = (
                    im32[:, :, 0] | (im32[:, :, 1] << 8) | (im32[:, :, 2] << 16)
                )
                sizes[:, i] = im.shape[:2]
        else:
            atlas = np.zeros((1, 1, 1), dtype=np.uint32)
            sizes = np.ones((2, 1), dtype=np.int32)

        # drawn for every scene, noise or not, so the rng stream and the
        # arrays match the JAX compiler's
        perlin_vec, perlin_perm = _perlin_tables(self.rng)

        features = set()
        used_kinds = set(self.tex_kind)
        if TEX_CHECKER in used_kinds:
            features.add("checker")
        if TEX_NOISE in used_kinds:
            features.add("noise")
        if TEX_IMAGE in used_kinds:
            features.add("image")
        if TEX_OBJUV in used_kinds:
            features.add("objuv")

        textures = TextureTable(
            kind=dev(np.array(self.tex_kind, dtype=np.int32)),
            color=dev(np.array(self.tex_color, dtype=np.float32).T.reshape(3, -1)),
            sub=dev(np.array(self.tex_sub, dtype=np.int32).T.reshape(2, -1)),
            scale=dev(np.array(self.tex_scale, dtype=np.float32)),
            img=dev(np.array(self.tex_img, dtype=np.int32)),
            atlas=dev(atlas),
            atlas_size=dev(sizes),
            perlin_vec=dev(perlin_vec),
            perlin_perm=dev(perlin_perm),
        )
        materials = MaterialTable(
            kind=dev(np.array(self.mat_kind, dtype=np.int32)),
            tex=dev(np.array(self.mat_tex, dtype=np.int32)),
            param=dev(np.array(self.mat_param, dtype=np.float32)),
        )

        # static world bounds (finite active geometry)
        blos = [m[4].min(axis=0) for m in cluster_meta]
        bhis = [m[5].max(axis=0) for m in cluster_meta]
        for g in range(n_in_bvh, n):
            if active[g] and kind[g] != MEDIUM:
                lo_, hi_ = self.prim_bbox(int(perm[g]))
                blos.append(lo_)
                bhis.append(hi_)
        if blos:
            wlo = np.min(blos, axis=0)
            whi = np.max(bhis, axis=0)
        else:
            wlo, whi = np.zeros(3), np.ones(3)

        stats = SceneStats(
            mediums=mediums,
            world_bounds=(tuple(float(x) for x in wlo), tuple(float(x) for x in whi)),
            features=frozenset(features),
            light_ids=tuple(int(i) for i in lights),
            light_kinds=tuple(int(kind[i]) for i in lights),
            light_axes=tuple(int(params[5, i]) for i in lights),
            n_in_bvh=n_in_bvh,
            trees=tuple(trees),
            time0=self.time0,
            time1=self.time1,
            kind_ranges=tuple(kind_ranges),
            kinds_present=kinds_present,
        )

        return SceneData(
            kind=dev(kind),
            params=dev(params),
            mat_id=dev(mat_id),
            flip=dev(flip),
            active=dev(active),
            xf_rot=dev(xf_rot),
            xf_inv_scale=dev(xf_inv_scale),
            xf_trans=dev(xf_trans),
            materials=materials,
            textures=textures,
            lights=dev(lights),
            clusters=tuple(cluster_trees),
            bvh8=tuple(bvh8_trees),
            any_xform=any_xform,
            any_medium=bool(mediums),
            stats=stats,
        )
