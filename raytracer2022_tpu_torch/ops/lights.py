"""Light importance sampling over the lights list (PyTorch).

Counterpart of ``raytracer2022_tpu/ops/lights.py``: the reference's
``HittablePdf`` over the lights ``HittableList`` (pdf.rs:56-77,
hittable/mod.rs:121-132) for sphere and rect lights.

  * ``lights_pdf``: one dense ``(L, N)`` evaluation per light kind, then a
    mean over L (sphere solid-angle pdf sphere.rs:75-83, rect area pdf
    aarect.rs:74-83).
  * ``light_directions``: a uniform light pick per ray, then the picked
    kind's sampler (sphere cone sphere.rs:85-90, rect point
    aarect.rs:85-93), of variates the caller drew beforehand.
    ``ops/mis.py`` draws one block a vertex, on every device and with or
    without gradients; its kernel samples the lights itself for card
    tensors that want no gradient, and its plain version calls this
    everywhere else.

Light ids are static (``SceneStats``), so light rows are taken by slicing
with Python ints: no index tensor is copied to the device per call.
"""

from __future__ import annotations

import math

import torch

from ..scene.types import RECT, SPHERE
from .intersect import _rect_t, _sphere_t
from .sampling import sphere_cone_local
from .vecmath import length_sqr, masked_sqrt, onb_from_w, onb_local, vec3

PI = math.pi


def _light_params(scene, ids) -> torch.Tensor:
    """(16, G) param rows of static prim ids."""
    return torch.cat([scene.params[:, i : i + 1] for i in ids], dim=1)


def lights_pdf(scene, p, v, tm):
    """HittableList::pdf_value (hittable/mod.rs:121-128): mean over lights."""
    stats = scene.stats
    n_lights = len(stats.light_ids)
    total = torch.zeros(p.shape[1:], dtype=p.dtype, device=p.device)
    sph = [i for i, k in zip(stats.light_ids, stats.light_kinds) if k == SPHERE]
    rect = [i for i, k in zip(stats.light_ids, stats.light_kinds) if k == RECT]
    pb = p[:, None, :]  # (3, 1, N)
    vb = v[:, None, :]

    if sph:
        prm = _light_params(scene, sph)[:, :, None]  # (16, Gs, 1)
        # Sphere::pdf_value (sphere.rs:75-83): requires an actual hit
        t = _sphere_t((prm[0], prm[1], prm[2]), prm[3], pb, vb, 1e-3, math.inf)
        dx = prm[0] - pb[0]
        dy = prm[1] - pb[1]
        dz = prm[2] - pb[2]
        dist_sqr = dx * dx + dy * dy + dz * dz
        rel = 1.0 - prm[3] * prm[3] / dist_sqr
        # origin inside the sphere: NaN pdf, as in the reference (the
        # integrator kills such samples), with a NaN-free backward
        cos_max = torch.where(rel > 0.0, masked_sqrt(rel, rel > 0.0), math.nan)
        solid_angle = 2.0 * PI * (1.0 - cos_max)
        total = total + torch.where(torch.isfinite(t), 1.0 / solid_angle, 0.0).sum(dim=0)

    if rect:
        prm = _light_params(scene, rect)[:, :, None]  # (16, Gr, 1)
        # XZRect::pdf_value et al. (aarect.rs:74-83): dist^2 / (cos * area)
        t = _rect_t(prm, pb, vb, 1e-3, math.inf)  # (Gr, N)
        ok = torch.isfinite(t)
        t_safe = torch.where(ok, t, 0.0)
        area = (prm[1, :, 0] - prm[0, :, 0]) * (prm[3, :, 0] - prm[2, :, 0])  # (Gr,)
        vlen_sqr = length_sqr(v)[None]
        dist_sqr = t_safe * t_safe * vlen_sqr
        ka = prm[5].to(torch.int32)
        vk = torch.where(ka == 0, vb[0], torch.where(ka == 1, vb[1], vb[2]))
        cos = torch.abs(vk) / torch.sqrt(vlen_sqr)
        # cos == 0 (direction in the light's plane): pdf 0, the sample dies
        denom = cos * area[:, None]
        ok = ok & (denom > 0.0)
        total = total + torch.where(
            ok, dist_sqr / torch.where(denom > 0.0, denom, 1.0), 0.0
        ).sum(dim=0)

    return total / float(max(n_lights, 1))


def light_directions(scene, p, pick, sphere_u, rect_u):
    """HittableList::random (hittable/mod.rs:129-132) of its variates: the
    light ``pick`` i64[N] (None for a single light), then the picked
    light's sample from ``sphere_u`` or ``rect_u``, pairs of U[0, 1) f32[N]
    (None where no light of that kind is in the list).  Returns a (3, N)
    direction."""
    stats = scene.stats
    ids = stats.light_ids
    n = p.shape[1]
    lp_all = _light_params(scene, ids)  # (16, L)
    if pick is None:
        prm = lp_all  # (16, 1) broadcasts over rays
        kind = scene.kind[ids[0] : ids[0] + 1]
    else:
        prm = lp_all[:, pick]
        kind = torch.cat([scene.kind[i : i + 1] for i in ids])[pick]

    # Hittable default direction (1,0,0) (hittable/mod.rs:66)
    out = vec3(torch.ones_like(p[0]), torch.zeros_like(p[0]), torch.zeros_like(p[0]))
    if SPHERE in stats.light_kinds:
        # Sphere::random (sphere.rs:85-90): cone sample toward the center
        direction = prm[0:3] - p
        u, v, w = onb_from_w(direction)
        local = sphere_cone_local(*sphere_u, prm[3].expand(n), length_sqr(direction))
        out = torch.where((kind == SPHERE)[None], onb_local(u, v, w, local), out)
    if RECT in stats.light_kinds:
        # XZRect::random et al. (aarect.rs:85-93, 168-176, 251-259)
        ua, ub = rect_u
        a = prm[0] + ua * (prm[1] - prm[0])
        b = prm[2] + ub * (prm[3] - prm[2])
        kv = prm[4].expand(n)
        ka = prm[5].to(torch.int32)
        point = torch.where(
            ka == 0,
            vec3(kv, a, b),  # YZ: (k, a, b)
            torch.where(ka == 1, vec3(a, kv, b), vec3(a, b, kv)),  # XZ / XY
        )
        out = torch.where((kind == RECT)[None], point - p, out)
    return out
