"""Golden-image comparison against the reference's committed renders.

Counterpart of ``tools/golden.py``.  The reference repository commits 50
milestone renders (``output/book{1,2,3}``, ``output/output.jpg``), its only
correctness baseline.  This tool renders one of the port's scenes with the
golden's aspect, box-averages both images to a common small grid (which
averages away Monte-Carlo noise and JPEG artifacts), and reports the mean
absolute error in [0, 1] post-gamma space.  Usage::

    python -m raytracer2022_tpu_torch.tools.golden --scene cornell_box_book \\
        --golden output/book2/image18.jpg --spp 500 --size 300 [--device cuda]
    python -m raytracer2022_tpu_torch.tools.golden --all   # the curated scene->golden map

Goldens are read from ``RT2022_REFERENCE_DIR``, by default ``reference/``
at the repository root (the repository does not hold them), with the
port's own decoder (``utils/imageio.py``, no Pillow); ``--save-dir`` writes
the renders as PNG.  The file-bound scenes read their assets from
``RT2022_SOURCE_DIR`` as the library does.  ``--device`` defaults to the
card and raises without one; ``--device cpu`` renders on the CPU.

Pass/fail guidance (the JAX tool's): MAE <= 0.05 after 500+ spp is a match
within Monte-Carlo noise and JPEG quantisation for these scenes; 0.05-0.10
is a visible but minor deviation; > 0.10 is a real mismatch.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
REFERENCE = os.environ.get("RT2022_REFERENCE_DIR", os.path.join(_REPO_ROOT, "reference"))

# scene -> golden relpath.  The committed book renders are historical
# milestones whose code was partly edited away; only output/output.jpg was
# produced by the frozen sources.  Structural deviations put an MAE floor
# under some scenes regardless of spp:
#   random_scene  - the reference builds it with an unseeded thread_rng
#                   (scene.rs:30-35): its own golden is unreproducible;
#                   layout differs, palette and exposure comparable.
#   cornell_box   - the frozen source swapped the red and green walls and
#                   brightened the light 15 -> 60 against every committed
#                   cornell golden (scene.rs:168-176); cornell_box_book is
#                   the golden-faithful variant.
#   final_scene / cornell_smoke - unseeded rng for the box-height field,
#                   plus milestone-era material tweaks.
GOLDEN_MAP = {
    "random_scene": "output/book2/image2.jpg",  # checker ground + motion blur (scene.rs:22-84)
    "two_perlin_spheres": "output/book2/image13.jpg",  # marble sphere + ground
    "simple_light": "output/book2/image17.jpg",
    "cornell_box": "output/book2/image18.jpg",  # frozen config vs book colours: wall swap + 4x light
    "cornell_box_book": "output/book2/image18.jpg",  # empty cornell, book colours
    "cornell_smoke": "output/book2/image21.jpg",  # two smoke boxes
    "final_scene": "output/book2/Finanscene.jpg",  # book 2's final composite
    "wwscene": "output/output.jpg",  # the frozen main.rs render
}

# Scenes with no committed golden anywhere in the reference's 50 renders:
# the two_spheres checker pair and the standalone earth sphere were never
# committed (GOLDEN.md).
NO_GOLDEN = ("two_spheres", "earth", "obj_uv_demo")


def downsample(img: np.ndarray, gh: int, gw: int) -> np.ndarray:
    """Box-average an (H, W, 3) float image to (gh, gw, 3)."""
    h, w, _ = img.shape
    ys = (np.arange(h) * gh // h).clip(0, gh - 1)
    xs = (np.arange(w) * gw // w).clip(0, gw - 1)
    out = np.zeros((gh, gw, 3))
    cnt = np.zeros((gh, gw, 1))
    np.add.at(out, (ys[:, None], xs[None, :]), img)
    np.add.at(cnt, (ys[:, None], xs[None, :]), 1.0)
    return out / cnt


def compare(ours: np.ndarray, golden: np.ndarray, grid: int = 64) -> dict:
    """Both images float [0, 1] (H, W, 3) -> {mae, rmse, exposure, mae_norm}
    on a ``grid``-row grid of ``ours``'s aspect."""
    gh = grid
    gw = max(1, int(round(grid * ours.shape[1] / ours.shape[0])))
    a = downsample(ours, gh, gw)
    b = downsample(golden, gh, gw)
    mae = float(np.mean(np.abs(a - b)))
    rmse = float(np.sqrt(np.mean((a - b) ** 2)))
    # exposure-normalised MAE: forgives a uniform brightness offset
    s = float(np.sum(a * b) / max(np.sum(a * a), 1e-9))
    mae_n = float(np.mean(np.abs(a * s - b)))
    return {"mae": mae, "rmse": rmse, "exposure": s, "mae_norm": mae_n}


def read_golden(path: str) -> np.ndarray:
    """A golden as float64 (H, W, 3) in [0, 1]."""
    from ..utils.imageio import read_image

    return read_image(path).astype(np.float64) / 255.0


def save_render(out_dir: str, scene: str, img: np.ndarray) -> None:
    """Write a render in [0, 1] as ``out_dir/scene.png``."""
    from ..utils.imageio import write_image

    os.makedirs(out_dir, exist_ok=True)
    write_image(os.path.join(out_dir, f"{scene}.png"), (img * 255).astype(np.uint8))


def render_scene(name: str, width: int, height: int, spp: int, seed: int = 0, device="cuda") -> np.ndarray:
    """``SCENES[name]`` at ``width x height`` (the camera's aspect set to
    match) through ``render_sum_n``, depth 50 -> float64 (H, W, 3) in [0, 1]."""
    from ..render.camera import make_camera
    from ..render.film import tonemap_u8
    from ..render.renderer import RenderConfig, render_sum_n
    from ..scene.library import SCENES

    bundle = SCENES[name](seed=seed, device=device)
    kw = dict(bundle.camera_kwargs)
    kw["aspect_ratio"] = width / height
    cam = make_camera(**kw, device=device)
    cfg = RenderConfig(width=width, height=height, spp=spp, max_depth=50, background=bundle.background, seed=seed)
    total, n = render_sum_n(bundle.scene, cam, cfg)
    return tonemap_u8(total, n).cpu().numpy().astype(np.float64) / 255.0


def run_one(scene: str, golden_rel: str, spp: int, size: int, grid: int, out_dir=None, device="cuda") -> dict:
    """Render ``scene`` ``size`` rows high at the aspect of the golden
    ``REFERENCE/golden_rel`` and compare the two."""
    g = read_golden(os.path.join(REFERENCE, golden_rel))
    gh, gw = g.shape[:2]
    height = size
    width = max(1, int(round(size * gw / gh)))
    ours = render_scene(scene, width, height, spp, device=device)
    m = compare(ours, g, grid=grid)
    m.update(scene=scene, golden=golden_rel, width=width, height=height, spp=spp)
    if out_dir:
        save_render(out_dir, scene, ours)
    return m


def find_best(scene: str, spp: int, size: int, grid: int, aspect: float, out_dir=None, device="cuda") -> list:
    """Render ``scene`` once and rank all goldens of the same aspect by MAE
    -> [(mae, relpath, metrics)], best first."""
    height = size
    width = max(1, int(round(size * aspect)))
    ours = render_scene(scene, width, height, spp, device=device)
    if out_dir:
        save_render(out_dir, scene, ours)
    rows = []
    for sub in ["output/book1", "output/book2", "output/book3", "output"]:
        d = os.path.join(REFERENCE, sub)
        for f in sorted(os.listdir(d)):
            p = os.path.join(d, f)
            if not f.lower().endswith((".jpg", ".png")) or not os.path.isfile(p):
                continue
            g = read_golden(p)
            ga = g.shape[1] / g.shape[0]
            if abs(ga - aspect) > 0.02:
                continue
            m = compare(ours, g, grid=grid)
            rows.append((m["mae"], os.path.join(sub, f), m))
    rows.sort(key=lambda r: r[0])
    return rows


def main(argv=None) -> int:
    from ..utils.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene")
    ap.add_argument("--golden")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--find", action="store_true", help="rank all goldens by match")
    ap.add_argument("--aspect", type=float, default=None)
    ap.add_argument("--spp", type=int, default=500)
    ap.add_argument("--size", type=int, default=256, help="render height in px")
    ap.add_argument("--grid", type=int, default=64, help="comparison grid height")
    ap.add_argument("--save-dir", default=None, help="also save our renders here")
    ap.add_argument("--device", default="cuda", help="cuda (default), cuda:N or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    if args.find:
        aspect = args.aspect or (16 / 9)
        rows = find_best(args.scene, args.spp, args.size, args.grid, aspect, args.save_dir, device)
        for _, rel, m in rows[:6]:
            print(json.dumps({"golden": rel, **m}))
        return 0

    jobs = list(GOLDEN_MAP.items()) if args.all else [(args.scene, args.golden or GOLDEN_MAP[args.scene])]
    results = []
    for scene, rel in jobs:
        m = run_one(scene, rel, args.spp, args.size, args.grid, args.save_dir, device)
        results.append(m)
        print(json.dumps(m), flush=True)
    worst = max(r["mae"] for r in results)
    print(f"# worst MAE = {worst:.4f} over {len(results)} scene(s)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
