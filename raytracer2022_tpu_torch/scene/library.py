"""The reference's scene library, rebuilt declaratively (PyTorch).

Counterpart of ``raytracer2022_tpu/scene/library.py`` with every scene
(reference: raytracer/src/scene.rs).  Each function returns a
:class:`SceneBundle` (compiled scene, camera kwargs, background), and
compiles on the host for any ``device`` (default: the card; without one
it raises), and every scene renders.
``earth``, ``final_scene``, ``obj_uv_demo`` and ``wwscene`` read assets
(``earthmap.jpg``, ``Saturn.jpg``, ``Jupiter.jpg``, ``Mars.jpg``,
``obj/Shuttle.obj``) from ``source_dir``, by default ``RT2022_SOURCE_DIR``
as it is when the scene is built, else ``assets/`` at the repository root.
The repository does not hold the reference's assets;
``tools/standins.py::write_stand_in_assets`` writes generated stand-ins.
Images are decoded by the port's own codec (``utils/imageio.py``), without
Pillow.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..utils.device import DEFAULT_DEVICE
from .builder import SceneBuilder
from .types import SceneData

# asset directory of the scenes that read files (images, OBJ meshes)
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_SOURCE = os.path.join(_REPO_ROOT, "assets")


def source_root(source_dir: Optional[str] = None) -> str:
    """The directory the file-bound scenes read their assets from."""
    return source_dir or os.environ.get("RT2022_SOURCE_DIR", DEFAULT_SOURCE)


def _asset(source_dir: Optional[str], *parts: str) -> str:
    """Path of an asset file; a missing file raises naming it and
    ``RT2022_SOURCE_DIR``."""
    path = os.path.join(source_root(source_dir), *parts)
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"scene asset {path!r} is missing: set RT2022_SOURCE_DIR (now "
            f"{os.environ.get('RT2022_SOURCE_DIR')!r}) to a directory holding it, or write "
            "stand-ins with python -m raytracer2022_tpu_torch.tools.standins DIR"
        )
    return path


@dataclass
class SceneBundle:
    scene: SceneData
    camera_kwargs: dict
    background: Optional[tuple]  # None => sky gradient
    name: str = ""
    meta: dict = field(default_factory=dict)


def _book_camera(lookfrom, lookat, vfov, aperture=0.0, focus=10.0, aspect=16 / 9):
    return dict(
        lookfrom=lookfrom,
        lookat=lookat,
        vup=(0.0, 1.0, 0.0),
        vfov=vfov,
        aspect_ratio=aspect,
        aperture=aperture,
        focus_dist=focus,
        time0=0.0,
        time1=1.0,
    )


def random_scene(seed: int = 0, bvh_threshold: int = 4096, device=DEFAULT_DEVICE) -> SceneBundle:
    """Book1 final scene + motion blur (scene.rs:22-84).  The default
    threshold keeps the 530-prim field dense, as the JAX package does."""
    b = SceneBuilder(seed=seed)
    rng = b.rng
    checker = b.checker((0.2, 0.3, 0.1), (0.9, 0.9, 0.9))
    b.sphere((0, -1000, 0), 1000, b.lambertian(checker))

    for a in range(-11, 12):
        for bb in range(-11, 12):
            choose_mat = rng.random()
            center = np.array([a + 0.9 * rng.random(), 0.2, bb + 0.9 * rng.random()])
            if np.linalg.norm(center - np.array([4.0, 0.2, 0.0])) > 0.9:
                if choose_mat < 0.80:
                    albedo = rng.uniform(0, 1, 3)
                    center2 = center + np.array([0.0, rng.uniform(0, 0.5), 0.0])
                    b.moving_sphere(center, center2, 0.0, 1.0, 0.2, b.lambertian(albedo))
                elif choose_mat < 0.95:
                    albedo = rng.uniform(0.5, 1, 3)
                    fuzz = rng.uniform(0, 0.5)
                    b.sphere(center, 0.2, b.metal(albedo, fuzz))
                else:
                    b.sphere(center, 0.2, b.dielectric(1.5))

    b.sphere((0, 1, 0), 1, b.dielectric(1.5))
    b.sphere((-4, 1, 0), 1, b.lambertian((0.4, 0.2, 0.1)))
    b.sphere((4, 1, 0), 1, b.metal((0.7, 0.6, 0.5), 0.0))

    cam = _book_camera((13, 2, 3), (0, 0, 0), 20, aperture=0.1, aspect=3 / 2)
    return SceneBundle(
        b.finalize(bvh_threshold=bvh_threshold, device=device), cam, background=None, name="random_scene"
    )


def two_spheres(seed: int = 0, device=DEFAULT_DEVICE) -> SceneBundle:
    """Checker spheres (scene.rs:87-105)."""
    b = SceneBuilder(seed=seed)
    checker = b.checker((0.2, 0.3, 0.1), (0.9, 0.9, 0.9))
    mat = b.lambertian(checker)
    b.sphere((0, -10, 0), 10, mat)
    b.sphere((0, 10, 0), 10, mat)
    cam = _book_camera((13, 2, 3), (0, 0, 0), 20)
    return SceneBundle(b.finalize(device=device), cam, background=None, name="two_spheres")


def two_perlin_spheres(seed: int = 0, device=DEFAULT_DEVICE) -> SceneBundle:
    """Perlin marble spheres (scene.rs:108-124)."""
    b = SceneBuilder(seed=seed)
    pertext = b.noise(4.0)
    mat = b.lambertian(pertext)
    b.sphere((0, -1000, 0), 1000, mat)
    b.sphere((0, 2, 0), 2, mat)
    cam = _book_camera((13, 2, 3), (0, 0, 0), 20)
    return SceneBundle(b.finalize(device=device), cam, background=None, name="two_perlin_spheres")


def earth(
    seed: int = 0, source_dir: Optional[str] = None, device=DEFAULT_DEVICE
) -> SceneBundle:
    """Earth-textured sphere (scene.rs:127-140)."""
    b = SceneBuilder(seed=seed)
    tex = b.image(_asset(source_dir, "earthmap.jpg"))
    b.sphere((0, 0, 0), 2, b.lambertian(tex))
    cam = _book_camera((13, 2, 3), (0, 0, 0), 20)
    return SceneBundle(b.finalize(device=device), cam, background=None, name="earth")


def simple_light(seed: int = 0, device=DEFAULT_DEVICE) -> SceneBundle:
    """Perlin spheres + one XY rect light (scene.rs:143-162)."""
    b = SceneBuilder(seed=seed)
    pertext = b.noise(4.0)
    mat = b.lambertian(pertext)
    b.sphere((0, -1000, 0), 1000, mat)
    b.sphere((0, 2, 0), 2, mat)
    light = b.rect_xy(3, 5, 1, 3, -2, b.diffuse_light((4.0, 4.0, 4.0)))
    b.add_light(light)
    cam = _book_camera((26, 3, 6), (0, 2, 0), 20)
    return SceneBundle(b.finalize(device=device), cam, background=(0.0, 0.0, 0.0), name="simple_light")


def cornell_box(seed: int = 0, device=DEFAULT_DEVICE) -> SceneBundle:
    """Book3 Cornell box with one-sided strong light (scene.rs:165-196)."""
    b = SceneBuilder(seed=seed)
    light = b.rect_xz(213, 343, 127, 232, 554, b.diffuse_light((60.0, 60.0, 60.0)))
    b.flip_face(light)
    b.add_light(light)
    red = b.lambertian((0.65, 0.05, 0.05))
    white = b.lambertian((0.73, 0.73, 0.73))
    green = b.lambertian((0.12, 0.45, 0.15))
    b.rect_yz(0, 555, 0, 555, 555, red)
    b.rect_yz(0, 555, 0, 555, 0, green)
    b.rect_xz(0, 555, 0, 555, 0, white)
    b.rect_xz(0, 555, 0, 555, 555, white)
    b.rect_xy(0, 555, 0, 555, 555, white)
    cam = _book_camera((278, 278, -800), (278, 278, 0), 40, aspect=1.0)
    return SceneBundle(b.finalize(device=device), cam, background=(0.0, 0.0, 0.0), name="cornell_box")


def cornell_box_book(seed: int = 0, device=DEFAULT_DEVICE) -> SceneBundle:
    """Book3 cornell as the committed goldens were rendered (book colors:
    green at x=555, light (15,15,15) — the frozen scene.rs:165-196 later
    swapped red/green and brightened the light to 60; the goldens
    output/book2/image18.jpg and output/book3/* predate that edit).
    Used for golden-image validation (tools/golden.py)."""
    b = SceneBuilder(seed=seed)
    light = b.rect_xz(213, 343, 227, 332, 554, b.diffuse_light((15.0, 15.0, 15.0)))
    b.flip_face(light)
    b.add_light(light)
    red = b.lambertian((0.65, 0.05, 0.05))
    white = b.lambertian((0.73, 0.73, 0.73))
    green = b.lambertian((0.12, 0.45, 0.15))
    b.rect_yz(0, 555, 0, 555, 555, green)
    b.rect_yz(0, 555, 0, 555, 0, red)
    b.rect_xz(0, 555, 0, 555, 0, white)
    b.rect_xz(0, 555, 0, 555, 555, white)
    b.rect_xy(0, 555, 0, 555, 555, white)
    cam = _book_camera((278, 278, -800), (278, 278, 0), 40, aspect=1.0)
    return SceneBundle(b.finalize(device=device), cam, background=(0.0, 0.0, 0.0), name="cornell_box_book")


def cornell_smoke(seed: int = 0, device=DEFAULT_DEVICE) -> SceneBundle:
    """Cornell box with two smoke boxes (scene.rs:199-257)."""
    b = SceneBuilder(seed=seed)
    red = b.lambertian((0.65, 0.05, 0.05))
    white = b.lambertian((0.73, 0.73, 0.73))
    green = b.lambertian((0.12, 0.45, 0.15))
    b.rect_yz(0, 555, 0, 555, 555, green)
    b.rect_yz(0, 555, 0, 555, 0, red)
    light = b.rect_xz(113, 443, 127, 432, 554, b.diffuse_light((7.0, 7.0, 7.0)))
    b.flip_face(light)
    b.add_light(light)
    b.rect_xz(0, 555, 0, 555, 555, white)
    b.rect_xz(0, 555, 0, 555, 0, white)
    b.rect_xy(0, 555, 0, 555, 555, white)

    box1 = b.box((0, 0, 0), (165, 330, 165), white)
    b.rotate_y(box1, 15.0)
    b.translate(box1, (265, 0, 295))
    b.constant_medium(box1, 0.01, (0.0, 0.0, 0.0))

    box2 = b.box((0, 0, 0), (165, 165, 165), white)
    b.rotate_y(box2, -18.0)
    b.translate(box2, (130, 0, 65))
    b.constant_medium(box2, 0.01, (1.0, 1.0, 1.0))

    cam = _book_camera((278, 278, -800), (278, 278, 0), 40, aspect=1.0)
    return SceneBundle(b.finalize(device=device), cam, background=(0.0, 0.0, 0.0), name="cornell_smoke")


def final_scene(
    seed: int = 0, source_dir: Optional[str] = None, device=DEFAULT_DEVICE
) -> SceneBundle:
    """Book2 final composite (scene.rs:260-362)."""
    b = SceneBuilder(seed=seed)
    rng = b.rng
    ground = b.lambertian((0.48, 0.83, 0.53))
    for i in range(20):
        for j in range(20):
            w = 100.0
            x0 = -1000.0 + i * w
            z0 = -1000.0 + j * w
            y1 = rng.uniform(1.0, 101.0)
            b.box((x0, 0.0, z0), (x0 + w, y1, z0 + w), ground)

    light = b.rect_xz(123, 423, 147, 412, 554, b.diffuse_light((7.0, 7.0, 7.0)))
    b.flip_face(light)
    b.add_light(light)

    center1 = np.array([400.0, 400.0, 200.0])
    b.moving_sphere(center1, center1 + [25, 0, 0], 0.0, 1.0, 50, b.lambertian((0.7, 0.3, 0.1)))
    b.sphere((260, 150, 45), 50, b.dielectric(1.5))
    b.sphere((0, 150, 145), 50, b.metal((0.8, 0.8, 0.9), 1.0))

    boundary = b.sphere((360, 150, 145), 70, b.dielectric(1.5))
    # the same sphere is both visible glass and a medium boundary: re-add a
    # shadow copy for the medium (the reference shares the object,
    # scene.rs:319-325)
    shadow = b.sphere((360, 150, 145), 70, b.dielectric(1.5))
    b.constant_medium([shadow], 0.2, (0.2, 0.4, 0.9))

    world_boundary = b.sphere((0, 0, 0), 5000, b.dielectric(1.5))
    b.constant_medium([world_boundary], 0.0001, (1.0, 1.0, 1.0))

    emat = b.lambertian(b.image(_asset(source_dir, "earthmap.jpg")))
    b.sphere((400, 200, 400), 100, emat)
    b.sphere((220, 280, 300), 80, b.lambertian(b.noise(0.1)))

    white = b.lambertian((0.73, 0.73, 0.73))
    cluster = [b.sphere(rng.uniform(0, 165, 3), 10, white) for _ in range(1000)]
    b.rotate_y(cluster, 15.0)
    b.translate(cluster, (-100, 270, 395))

    cam = _book_camera((478, 278, -600), (278, 278, 0), 40, aspect=1.0)
    return SceneBundle(b.finalize(device=device), cam, background=(0.0, 0.0, 0.0), name="final_scene")


def _import_obj(
    b: SceneBuilder,
    path: str,
    mat: int,
    zoom: float,
    rot_y: float,
    trans,
    use_uvs: bool = False,
):
    """OBJ triangle import (scene.rs:364-414): triangulated single-index
    positions -> triangles, then Zoom/RotateY/Translate.

    With ``use_uvs`` the file's per-corner ``vt`` texcoords are attached to
    each triangle, feeding ObjTexture's barycentric uv interpolation
    (texture/mod.rs:141-189); ``mat`` should then reference a
    :meth:`SceneBuilder.objuv` texture.  (The reference defines ObjTexture
    but its frozen scene shades meshes flat-Lambertian, scene.rs:398-404.)
    """
    from .objio import load_obj

    verts, faces, face_uvs = load_obj(path)
    attach_uv = use_uvs and face_uvs is not None
    ids = [
        b.triangle(
            verts[f[0]],
            verts[f[1]],
            verts[f[2]],
            mat,
            uv=face_uvs[i] if attach_uv else None,
        )
        for i, f in enumerate(faces)
    ]
    b.zoom(ids, zoom)
    b.rotate_y(ids, rot_y)
    b.translate(ids, trans)
    return ids


def obj_uv_demo(
    seed: int = 0, source_dir: Optional[str] = None, device=DEFAULT_DEVICE
) -> SceneBundle:
    """Smoke scene for the ObjTexture path (TEX_OBJUV): an earth-textured
    uv-mapped quad mesh under the sky gradient.  Exercises the full chain
    OBJ vt records -> per-triangle uv params -> barycentric interpolation ->
    nearest-neighbor atlas sample (texture/mod.rs:141-189)."""
    import tempfile

    b = SceneBuilder(seed=seed)
    tex = b.objuv(_asset(source_dir, "earthmap.jpg"))
    mat = b.lambertian(tex)
    quad = (
        "v -1 -1 0\nv 1 -1 0\nv 1 1 0\nv -1 1 0\n"
        "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n"
        "f 1/1 2/2 3/3 4/4\n"
    )
    with tempfile.NamedTemporaryFile("w", suffix=".obj", delete=False) as f:
        f.write(quad)
        path = f.name
    try:
        _import_obj(b, path, mat, zoom=2.0, rot_y=0.0, trans=(0.0, 0.0, 0.0), use_uvs=True)
    finally:
        os.unlink(path)
    cam = _book_camera((0, 0, -6), (0, 0, 0), 40)
    return SceneBundle(b.finalize(device=device), cam, background=None, name="obj_uv_demo")


def wwscene(
    seed: int = 0, source_dir: Optional[str] = None, device=DEFAULT_DEVICE
) -> SceneBundle:
    """The active composite scene (scene.rs:468-571): Saturn system with
    rings, planets, stars, and the OBJ shuttle.

    Ship.obj is imported only when the file exists (the reference's copy
    of it is not distributed).
    """
    b = SceneBuilder(seed=seed)
    rng = b.rng

    light = b.sphere((800, 700, -800), 70, b.diffuse_light((130.0, 130.0, 130.0)))
    b.add_light(light)

    b.sphere((0, 0, 0), 43, b.lambertian(b.image(_asset(source_dir, "Saturn.jpg"))))
    b.sphere((150, 20, 150), 26, b.lambertian(b.image(_asset(source_dir, "Jupiter.jpg"))))
    b.sphere((480, 25, 500), 25, b.lambertian(b.image(_asset(source_dir, "Mars.jpg"))))

    def xz_disk_unit():
        while True:
            p = rng.uniform(-1, 1, 2)
            if p[0] ** 2 + p[1] ** 2 < 1:
                v = np.array([p[0], 0.0, p[1]])
                return v / np.linalg.norm(v)

    # ring stars (scene.rs:505-521)
    for _ in range(40):
        pos = xz_disk_unit() * (100.0 + rng.uniform(-15, 15))
        pos = pos + np.array([0.0, 0.0, rng.uniform(-1, 1)])
        b.sphere(pos, rng.uniform(0.3, 0.5), b.metal(rng.uniform(0.5, 1, 3), rng.uniform(0, 0.5)))
    for _ in range(40):
        pos = xz_disk_unit() * (100.0 + rng.uniform(-15, 15))
        pos = pos + np.array([0.0, 0.0, rng.uniform(-1, 1)])
        b.sphere(pos, rng.uniform(0.3, 0.6), b.dielectric(1.5))

    # Saturn's rings (scene.rs:523-543)
    ring_mat = b.lambertian((0.78, 0.78, 0.78))
    weight = [2, 3, 2, 3, 4, 3, 2, 2, 3, 2, 3, 4, 3, 6, 4, 5, 3, 3, 4, 3]
    now, delta = 80, 2
    for k in range(20):
        for i in range(now * weight[k], (now + delta) * weight[k]):
            thickness = rng.uniform(0.009, 0.01) if weight[k] <= 4 else rng.uniform(0.007, 0.008)
            b.ring(i / weight[k], thickness, ring_mat)
        now += delta

    # stars (scene.rs:545-564); note the reference's i % 2 makes only the
    # first two colors reachable
    for i in range(101):
        scolor = [(1.0, 1.0, 1.0), (1.0, 1.0, 0.0), (0.0, 1.0, 1.0), (1.0, 0.0, 1.0)][i % 2]
        b.sphere(
            (rng.uniform(-500, 500), rng.uniform(-500, 500), rng.uniform(100, 400)),
            rng.uniform(0.3, 0.45),
            b.diffuse_light(scolor),
        )

    grey = b.lambertian((0.78, 0.78, 0.78))
    _import_obj(
        b,
        _asset(source_dir, "obj", "Shuttle.obj"),
        grey,
        zoom=13.5,
        rot_y=56.0,
        trans=(40.88, 1.3, -85.59),
    )
    ship_path = os.path.join(source_root(source_dir), "obj", "Ship.obj")
    if os.path.exists(ship_path) and os.path.getsize(ship_path) > 0:
        _import_obj(b, ship_path, grey, zoom=0.56, rot_y=153.0, trans=(15.0, 2.0, -116.0))

    cam = dict(
        lookfrom=(0.0, 15.0, -150.0),
        lookat=(35.0, 0.0, 0.0),
        vup=(1.0, 5.0, 0.0),
        vfov=40.0,
        aspect_ratio=16 / 9,
        aperture=0.0,
        focus_dist=10.0,
        time0=0.0,
        time1=1.0,
    )
    return SceneBundle(b.finalize(device=device), cam, background=(0.0, 0.0, 0.0), name="wwscene")


READS_FILES = ("earth", "final_scene", "obj_uv_demo", "wwscene")  # the scenes that read asset files

SCENES = {
    "obj_uv_demo": obj_uv_demo,
    "random_scene": random_scene,
    "two_spheres": two_spheres,
    "two_perlin_spheres": two_perlin_spheres,
    "earth": earth,
    "simple_light": simple_light,
    "cornell_box": cornell_box,
    "cornell_box_book": cornell_box_book,
    "cornell_smoke": cornell_smoke,
    "final_scene": final_scene,
    "wwscene": wwscene,
}
