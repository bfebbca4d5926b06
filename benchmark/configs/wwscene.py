"""wwscene: the reference's own deployment, the frame its CLI renders.

Source: Jerx2y/Raytracer-2022, raytracer/src/main.rs:33-51 (2560x1440,
2000 spp, depth 50, the camera) and raytracer/src/scene.rs:468-571 (the
scene): the light sphere, three image-textured planets, 80 ring stars
(40 metal, 40 glass), 128 rings of the weight table, 101 emissive stars
and the Shuttle mesh (zoom 13.5, rot_y 56, translate (40.88, 1.3,
-85.59)).  Ship.obj is left out, as the reference's library leaves it out
when the file is absent.

The real planet maps and ``Shuttle.obj`` are not in the repository: the
maps are made from the seed, and the mesh at the sizes in ``ASSUMED``.
The layout (the random stars, rings and the mesh's shape) is drawn from
one fixed generator, ``LAYOUT_SEED``, so that every seed renders the same
geometry and so the same work; the seed draws the maps and, in the modes,
every sample.
"""

from __future__ import annotations

import numpy as np

SOURCE = "https://github.com/Jerx2y/Raytracer-2022 (raytracer/src/main.rs:33-51, raytracer/src/scene.rs:468-571)"
FRAME = (2560, 1440)
DEPTH = 50
SPP = 2000  # the source's; the frame cells render passes of 32 (their workload files)
ASSUMED = {
    "planet_maps": "three 1024x512 u8 RGB latitude-band maps made from the seed (Saturn, Jupiter, Mars)",
    "shuttle": "a closed torus of 13,056 triangles (the real Shuttle.obj has 13,079)",
    "layout": "the stars, ring stars and rings drawn from one fixed generator (the reference draws them anew each run)",
}
REDUCED = ["spp"]
MESH = (96, 68)  # torus quads: 2 * 96 * 68 = 13,056 triangles
MAP = (1024, 512)
LAYOUT_SEED = 2022  # the scene's own random layout, fixed
WEIGHTS = [2, 3, 2, 3, 4, 3, 2, 2, 3, 2, 3, 4, 3, 6, 4, 5, 3, 3, 4, 3]  # scene.rs:523-543
CAMERA = dict(lookfrom=(0.0, 15.0, -150.0), lookat=(35.0, 0.0, 0.0), vup=(1.0, 5.0, 0.0), vfov=40.0,
              aspect_ratio=16 / 9, aperture=0.0, focus_dist=10.0, time0=0.0, time1=1.0)


def describe(seed: int, mesh=MESH, maps=MAP) -> dict:
    """The scene of ``seed`` (``harness/scene.py``'s description): the
    fixed layout with maps drawn from ``seed``."""
    from harness.scene import banded_map, torus

    rng = np.random.default_rng(LAYOUT_SEED)
    maps_rng = np.random.default_rng(seed)
    mats, centers, radii, smat = [], [], [], []

    def material(**m):
        mats.append(m)
        return len(mats) - 1

    def sphere(c, r, m):
        centers.append(np.asarray(c, dtype=np.float64))
        radii.append(float(r))
        smat.append(m)

    images = [banded_map(maps_rng, colour, *maps) for colour in ((0.85, 0.75, 0.55), (0.8, 0.6, 0.45), (0.75, 0.35, 0.2))]
    sphere((800, 700, -800), 70, material(kind="light", color=(130.0, 130.0, 130.0)))
    sphere((0, 0, 0), 43, material(kind="lambertian", image=0))
    sphere((150, 20, 150), 26, material(kind="lambertian", image=1))
    sphere((480, 25, 500), 25, material(kind="lambertian", image=2))

    def xz_disk_unit():
        while True:
            p = rng.uniform(-1, 1, 2)
            if p[0] ** 2 + p[1] ** 2 < 1:
                v = np.array([p[0], 0.0, p[1]])
                return v / np.linalg.norm(v)

    for glass in (False, True):  # ring stars (scene.rs:505-521)
        for _ in range(40):
            pos = xz_disk_unit() * (100.0 + rng.uniform(-15, 15)) + np.array([0.0, 0.0, rng.uniform(-1, 1)])
            if glass:
                sphere(pos, rng.uniform(0.3, 0.6), material(kind="dielectric", param=1.5))
            else:
                r = rng.uniform(0.3, 0.5)
                sphere(pos, r, material(kind="metal", color=tuple(rng.uniform(0.5, 1, 3)), param=rng.uniform(0, 0.5)))
    ring_mat = material(kind="lambertian", color=(0.78, 0.78, 0.78))
    ring_r, ring_t = [], []
    now, delta = 80, 2
    for w in WEIGHTS:  # Saturn's rings (scene.rs:523-543)
        for i in range(now * w, (now + delta) * w):
            ring_r.append(i / w)
            ring_t.append(rng.uniform(0.009, 0.01) if w <= 4 else rng.uniform(0.007, 0.008))
        now += delta
    for i in range(101):  # stars (scene.rs:545-564): i % 2 reaches the first two colours only
        colour = [(1.0, 1.0, 1.0), (1.0, 1.0, 0.0)][i % 2]
        pos = (rng.uniform(-500, 500), rng.uniform(-500, 500), rng.uniform(100, 400))
        sphere(pos, rng.uniform(0.3, 0.45), material(kind="light", color=colour))
    verts, faces = torus(rng, *mesh)
    grey = material(kind="lambertian", color=(0.78, 0.78, 0.78))
    return {
        "materials": mats,
        "images": images,
        "spheres": {"center": np.stack(centers), "radius": np.asarray(radii), "mat": np.asarray(smat)},
        "rings": {"radius": np.asarray(ring_r), "thickness": np.asarray(ring_t),
                  "mat": np.full(len(ring_r), ring_mat)},
        "mesh": {"verts": verts, "faces": faces, "mat": grey, "zoom": 13.5, "rot_y": 56.0,
                 "translate": (40.88, 1.3, -85.59)},
        "lights": [("sphere", 0)],
        "camera": dict(CAMERA),
        "background": (0.0, 0.0, 0.0),
    }
