"""Scene descriptions and their compile by the program.

A configuration (``configs/<name>.py``) makes a description from the seed:
a plain dictionary of numpy arrays and numbers that the program and the
plain reference (``reference/tracer.py``) both read.

- ``materials``: a list of ``{"kind": "lambertian" | "metal" |
  "dielectric" | "light", "color": (r, g, b)}`` or ``{"kind":
  "lambertian", "image": i}``, with ``"param"`` (a metal's fuzz, a
  dielectric's index); one texture a material, in this order;
- ``images``: u8 (H, W, 3) arrays, rows top-down;
- ``spheres``: ``{"center": (K, 3), "radius": (K,), "mat": (K,)}``;
- ``rects``: a list of ``{"axis": 0 (yz) | 1 (xz) | 2 (xy), "a": (lo,
  hi), "b": (lo, hi), "k": plane, "mat": m, "flip": bool}``;
- ``rings``: ``{"radius": (R,), "thickness": (R,), "mat": (R,)}``,
  annuli in the plane y = 0;
- ``mesh``: ``{"verts": (V, 3), "faces": (F, 3), "mat": m, "zoom": s,
  "rot_y": degrees, "translate": (3,)}`` in model space;
- ``lights``: ``[("sphere" | "rect", index), ...]``;
- ``camera``: ``Camera::new``'s arguments; ``background``: (r, g, b).
"""

from __future__ import annotations

import time

import numpy as np


def build_port_scene(desc: dict, device):
    """The program's scene and camera of ``desc`` through its public
    ``SceneBuilder`` and ``make_camera`` -> (scene, camera, seconds), the
    seconds ending in a synchronisation of ``device``."""
    import torch

    from raytracer2022_tpu_torch import SceneBuilder, make_camera

    t0 = time.perf_counter()
    b = SceneBuilder(seed=0)
    mats = []
    for m in desc["materials"]:
        albedo = b.image(desc["images"][m["image"]]) if "image" in m else tuple(m.get("color", (1.0, 1.0, 1.0)))
        kind = m["kind"]
        if kind == "lambertian":
            mats.append(b.lambertian(albedo))
        elif kind == "metal":
            mats.append(b.metal(albedo, m["param"]))
        elif kind == "dielectric":
            mats.append(b.dielectric(m["param"]))
        elif kind == "light":
            mats.append(b.diffuse_light(albedo))
        else:
            raise ValueError(f"unknown material kind {kind!r}")
    prims = {"sphere": [], "rect": []}
    sph = desc.get("spheres")
    if sph is not None:
        for c, r, m in zip(np.asarray(sph["center"]), np.asarray(sph["radius"]), np.asarray(sph["mat"])):
            prims["sphere"].append(b.sphere(c, float(r), mats[int(m)]))
    for r in desc.get("rects", []):
        add = (b.rect_yz, b.rect_xz, b.rect_xy)[int(r["axis"])]
        pid = add(*r["a"], *r["b"], r["k"], mats[int(r["mat"])])
        if r.get("flip"):
            b.flip_face(pid)
        prims["rect"].append(pid)
    rings = desc.get("rings")
    if rings is not None:
        for rad, th, m in zip(np.asarray(rings["radius"]), np.asarray(rings["thickness"]), np.asarray(rings["mat"])):
            b.ring(float(rad), float(th), mats[int(m)])
    mesh = desc.get("mesh")
    if mesh is not None:
        v = np.asarray(mesh["verts"], dtype=np.float64)
        mat = mats[int(mesh["mat"])]
        ids = [b.triangle(v[i], v[j], v[k], mat) for i, j, k in np.asarray(mesh["faces"])]
        b.zoom(ids, float(mesh["zoom"]))
        b.rotate_y(ids, float(mesh["rot_y"]))
        b.translate(ids, tuple(float(x) for x in mesh["translate"]))
    for kind, i in desc.get("lights", []):
        b.add_light(prims[kind][int(i)])
    scene = b.finalize(device=device)
    cam = make_camera(**desc["camera"], device=device)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return scene, cam, time.perf_counter() - t0


def torus(rng: np.random.Generator, nu: int, nv: int, radii=(0.35, 0.15), tilt_deg: float = 35.0):
    """A closed torus of ``2 * nu * nv`` triangles, about one unit across,
    tilted about x, its radii and tilt varied by a few percent from
    ``rng`` -> (verts (nu * nv, 3), faces (2 * nu * nv, 3))."""
    big, small = (r * rng.uniform(0.95, 1.05) for r in radii)
    a = np.radians(tilt_deg * rng.uniform(0.9, 1.1))
    phi = 2 * np.pi * np.arange(nu) / nu
    th = 2 * np.pi * np.arange(nv) / nv
    ring = big + small * np.cos(th)[None, :]
    x = ring * np.cos(phi)[:, None]
    y = np.broadcast_to(small * np.sin(th)[None, :], (nu, nv))
    z = ring * np.sin(phi)[:, None]
    verts = np.stack([x, y * np.cos(a) - z * np.sin(a), y * np.sin(a) + z * np.cos(a)], -1).reshape(-1, 3)
    i, j = np.meshgrid(np.arange(nu), np.arange(nv), indexing="ij")
    q = np.stack([i * nv + j, ((i + 1) % nu) * nv + j, ((i + 1) % nu) * nv + (j + 1) % nv,
                  i * nv + (j + 1) % nv], -1).reshape(-1, 4)
    faces = np.concatenate([q[:, [0, 1, 2]], q[:, [0, 2, 3]]], axis=1).reshape(-1, 3)
    return verts, faces


def banded_map(rng: np.random.Generator, colour, width: int, height: int) -> np.ndarray:
    """A u8 (height, width, 3) planet map: latitude bands of seeded
    frequencies and phases around ``colour``, with mild noise."""
    lat = np.linspace(0.0, 1.0, height, dtype=np.float32)[:, None, None]
    lon = np.linspace(0.0, 2 * np.pi, width, dtype=np.float32)[None, :, None]
    freqs, phases = rng.uniform(4.0, 24.0, 3), rng.uniform(0.0, 2 * np.pi, 3)
    bands = sum(np.sin(2 * np.pi * f * lat + p + 0.15 * np.sin(lon + p)) for f, p in zip(freqs, phases))
    img = np.asarray(colour, dtype=np.float32) * (0.8 + 0.07 * bands)
    img = img + rng.normal(0.0, 0.02, (height, width, 3)).astype(np.float32)
    return (np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)
