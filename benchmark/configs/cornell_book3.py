"""cornell_book3: book 3's Cornell box as the reference builds it.

Source: Ray Tracing: The Rest of Your Life (final render 600x600, 1000
spp, depth 50), as Jerx2y/Raytracer-2022 raytracer/src/scene.rs:165-196
builds it: five lambertian walls and a one-sided light rect of 60 on the
ceiling, flipped to face down, sampled by the 50/50 mixture pdf.  No tree:
every primitive is a dense rect.

The fit cell renders 256x256 x 64 spp, ``bench.py``'s fwd+bwd shape
(``FIT``), toward a target image made from the seed (``target``).
"""

from __future__ import annotations

import numpy as np

SOURCE = "https://raytracing.github.io/books/RayTracingTheRestOfYourLife.html (final Cornell box; Raytracer-2022 scene.rs:165-196)"
FRAME = (600, 600)
DEPTH = 50
SPP = 1000  # the source's; the frame cell renders passes of 32 (its workload file)
FIT = {"width": 256, "height": 256, "spp": 64}  # bench.py l. 129-156: the project's fwd+bwd setting
ASSUMED = {"fit_target": "a 256x256 RGB image of smooth colour fields in [0, 1] made from the seed"}
REDUCED = ["spp", "fit"]
CAMERA = dict(lookfrom=(278.0, 278.0, -800.0), lookat=(278.0, 278.0, 0.0), vup=(0.0, 1.0, 0.0), vfov=40.0,
              aspect_ratio=1.0, aperture=0.0, focus_dist=10.0, time0=0.0, time1=1.0)


def describe(seed: int) -> dict:
    """The box (the same for every seed: the source has no random part)."""
    mats = [{"kind": "light", "color": (60.0, 60.0, 60.0)},
            {"kind": "lambertian", "color": (0.65, 0.05, 0.05)},
            {"kind": "lambertian", "color": (0.73, 0.73, 0.73)},
            {"kind": "lambertian", "color": (0.12, 0.45, 0.15)}]
    light, red, white, green = range(4)
    rects = [
        {"axis": 1, "a": (213, 343), "b": (127, 232), "k": 554, "mat": light, "flip": True},
        {"axis": 0, "a": (0, 555), "b": (0, 555), "k": 555, "mat": red},
        {"axis": 0, "a": (0, 555), "b": (0, 555), "k": 0, "mat": green},
        {"axis": 1, "a": (0, 555), "b": (0, 555), "k": 0, "mat": white},
        {"axis": 1, "a": (0, 555), "b": (0, 555), "k": 555, "mat": white},
        {"axis": 2, "a": (0, 555), "b": (0, 555), "k": 555, "mat": white},
    ]
    return {"materials": mats, "images": [], "rects": rects, "lights": [("rect", 0)], "camera": dict(CAMERA),
            "background": (0.0, 0.0, 0.0)}


def target(seed: int, width: int, height: int) -> np.ndarray:
    """The fit's target: f32 (3, height, width) in [0, 1], a sum of a few
    seeded smooth colour fields."""
    rng = np.random.default_rng([seed, 1])
    y, x = np.meshgrid(np.linspace(0, 1, height), np.linspace(0, 1, width), indexing="ij")
    img = np.zeros((3, height, width))
    for _ in range(4):
        fx, fy, ph = rng.uniform(0.5, 3.0), rng.uniform(0.5, 3.0), rng.uniform(0, 2 * np.pi)
        img += rng.uniform(0.05, 0.2, (3, 1, 1)) * (1 + np.sin(2 * np.pi * (fx * x + fy * y) + ph))[None]
    return np.clip(img, 0.0, 1.0).astype(np.float32)
