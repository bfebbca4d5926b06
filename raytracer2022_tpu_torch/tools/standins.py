"""Generated stand-ins for the asset files the repository does not hold.

``earth``, ``final_scene``, ``obj_uv_demo`` and ``wwscene`` read
``earthmap.jpg``, ``Saturn.jpg``, ``Jupiter.jpg``, ``Mars.jpg`` and
``obj/Shuttle.obj`` from ``RT2022_SOURCE_DIR`` (``scene/library.py``).
:func:`write_stand_in_assets` writes seeded stand-ins for all five: banded
1024x512 JPEGs and a closed torus of 13,056 triangles for the Shuttle's
13,079.  Usage::

    python -m raytracer2022_tpu_torch.tools.standins DIR
    RT2022_SOURCE_DIR=DIR rt2022-torch --scene wwscene

:func:`source_dir_env` points ``RT2022_SOURCE_DIR`` at a directory for the
length of a block.
"""

from __future__ import annotations

import argparse
import contextlib
import math
import os

import numpy as np


def earth_stand_in(seed: int = 0, width: int = 1024, height: int = 512) -> np.ndarray:
    """A u8[height, width, 3] image in place of ``earthmap.jpg`` (1024x512),
    which the repository does not hold: latitude bands with seeded noise."""
    rng = np.random.default_rng(seed)
    lat = np.linspace(0.0, math.pi, height)[:, None, None]
    lon = np.linspace(0.0, 2.0 * math.pi, width)[None, :, None]
    base = 0.5 + 0.25 * np.sin(3.0 * lat + np.array([0.0, 1.0, 2.0])) * np.cos(2.0 * lon)
    img = base + rng.normal(0.0, 0.08, (height, width, 3))
    return (np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)


PLANETS = {"Saturn.jpg": (1, (0.85, 0.75, 0.55)), "Jupiter.jpg": (2, (0.8, 0.6, 0.45)),
           "Mars.jpg": (3, (0.75, 0.35, 0.2))}  # file -> (seed offset, base colour)
SHUTTLE_RADII = (0.35, 0.15)  # the stand-in Shuttle's torus at model scale: about one unit across
SHUTTLE_TILT_DEG = 35.0


def planet_stand_in(seed: int, colour, width: int = 1024, height: int = 512) -> np.ndarray:
    """A u8[height, width, 3] banded planet map: latitude bands of seeded
    widths and shades around ``colour``, with mild noise."""
    rng = np.random.default_rng(seed)
    lat = np.linspace(0.0, 1.0, height)[:, None, None]
    lon = np.linspace(0.0, 2.0 * math.pi, width)[None, :, None]
    freqs, phases = rng.uniform(4.0, 24.0, 3), rng.uniform(0.0, 2.0 * math.pi, 3)
    bands = sum(np.sin(2.0 * math.pi * f * lat + p + 0.15 * np.sin(lon + p)) for f, p in zip(freqs, phases))
    img = np.asarray(colour) * (0.8 + 0.07 * bands) + rng.normal(0.0, 0.02, (height, width, 3))
    return (np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)


def shuttle_obj_text(nu: int = 96, nv: int = 68) -> str:
    """OBJ text of a closed torus of ``2 * nu * nv`` triangles standing in
    for ``obj/Shuttle.obj`` (13,079 triangles): ``nu * nv`` quads with ``vt``
    and ``vn`` records, at model scale (about one unit across, tilted), so
    that ``wwscene``'s zoom 13.5, rotate_y 56 and translate place it in the
    camera's view.  With the defaults: 13,056 triangles."""
    big, small = SHUTTLE_RADII
    phi = 2.0 * math.pi * np.arange(nu) / nu
    th = 2.0 * math.pi * np.arange(nv) / nv
    ring = big + small * np.cos(th)[None, :]
    a = math.radians(SHUTTLE_TILT_DEG)

    def tilt(x, y, z):
        return np.stack([x, y * math.cos(a) - z * math.sin(a), y * math.sin(a) + z * math.cos(a)], -1)

    verts = tilt(ring * np.cos(phi)[:, None], np.broadcast_to(small * np.sin(th)[None, :], (nu, nv)),
                 ring * np.sin(phi)[:, None]).reshape(-1, 3)
    normals = tilt(np.cos(th)[None, :] * np.cos(phi)[:, None], np.broadcast_to(np.sin(th)[None, :], (nu, nv)),
                   np.cos(th)[None, :] * np.sin(phi)[:, None]).reshape(-1, 3)
    uvs = np.stack(np.meshgrid(np.arange(nu) / nu, np.arange(nv) / nv, indexing="ij"), -1).reshape(-1, 2)
    lines = ["# stand-in for Shuttle.obj: a torus of quads", "o shuttle_stand_in", "g hull", "s 1",
             "usemtl grey"]
    lines += [f"v {x:.9g} {y:.9g} {z:.9g}" for x, y, z in verts]
    lines += [f"vt {u:.9g} {v:.9g}" for u, v in uvs]
    lines += [f"vn {x:.9g} {y:.9g} {z:.9g}" for x, y, z in normals]
    for i in range(nu):
        for j in range(nv):
            quad = [i * nv + j, ((i + 1) % nu) * nv + j, ((i + 1) % nu) * nv + (j + 1) % nv, i * nv + (j + 1) % nv]
            lines.append("f " + " ".join(f"{k + 1}/{k + 1}/{k + 1}" for k in quad))
    return "\n".join(lines) + "\n"


def write_stand_in_assets(directory: str, seed: int = 0, shuttle=(96, 68), encode=None) -> dict:
    """Write the files that ``earth``, ``final_scene``, ``obj_uv_demo`` and
    ``wwscene`` read, which the repository does not hold, as generated
    stand-ins: ``earthmap.jpg`` (:func:`earth_stand_in`), ``Saturn.jpg``,
    ``Jupiter.jpg`` and ``Mars.jpg`` (1024x512 each, :func:`planet_stand_in`)
    and ``obj/Shuttle.obj`` (:func:`shuttle_obj_text` of ``shuttle = (nu, nv)``).
    ``encode(path, u8[H, W, 3])`` writes a JPEG, by default the port's
    ``write_jpeg`` at quality 100.  Returns ``{file name: image}``."""
    if encode is None:
        from ..utils.imageio import write_jpeg as encode
    images = {"earthmap.jpg": earth_stand_in(seed)}
    for name, (offset, colour) in PLANETS.items():
        images[name] = planet_stand_in(seed + offset, colour)
    os.makedirs(os.path.join(directory, "obj"), exist_ok=True)
    for name, img in images.items():
        encode(os.path.join(directory, name), img)
    with open(os.path.join(directory, "obj", "Shuttle.obj"), "w") as f:
        f.write(shuttle_obj_text(*shuttle))
    return images


@contextlib.contextmanager
def source_dir_env(path: str):
    """``RT2022_SOURCE_DIR`` set to ``path`` inside the block, restored after."""
    old = os.environ.get("RT2022_SOURCE_DIR")
    os.environ["RT2022_SOURCE_DIR"] = path
    try:
        yield path
    finally:
        if old is None:
            del os.environ["RT2022_SOURCE_DIR"]
        else:
            os.environ["RT2022_SOURCE_DIR"] = old


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("directory", help="where to write the files (made if missing)")
    args = ap.parse_args(argv)
    images = write_stand_in_assets(args.directory)
    print(f"wrote {', '.join(images)} and obj/Shuttle.obj into {args.directory}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
