"""Forward render rates of one tree of this repository on one CUDA card.

    python3 compare_forward.py ROOT

ROOT is the root of a checkout (``.`` for this one; an older commit
unpacked with ``git archive`` into a git-ignored directory for the other).
Imports that tree's port and ``chip_smoke.py``, and renders as the smoke
does: the stand-in mesh at 600x600x64 (twice, after a small warm-up), the
stand-in final_scene at 600x600x32, and the pixel pool on cornell_box at
256x256 x 4 lanes x 512 (twice), all at depth 50.  Prints one JSON line of
Mpaths/s with the card's name and power limit.  Host-bound renders move
with the host, so two trees are compared in turns within one call:

    for r in build/parent . . build/parent; do python3 compare_forward.py $r; done
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time


def main(root: str) -> dict:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import chip_smoke as smoke
    from raytracer2022_tpu_torch.render.camera import make_camera
    from raytracer2022_tpu_torch.render.integrator import Schedule, TraceConfig
    from raytracer2022_tpu_torch.render.renderer import RenderConfig, render_batch_regen, render_sum_n
    from raytracer2022_tpu_torch.scene.builder import SceneBuilder
    from raytracer2022_tpu_torch.scene.library import SCENES

    try:  # the generator of launch 0 (launch_generator in older trees)
        from raytracer2022_tpu_torch.render.renderer import step_generator as launch0
    except ImportError:
        from raytracer2022_tpu_torch.render.renderer import launch_generator as launch0

    dev = torch.device("cuda")
    out = {"root": root}

    def timed(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    b = SceneBuilder()
    mesh_cam = make_camera(**smoke.stand_in_mesh_scene(b), device=dev)
    mesh = b.finalize(device=dev)
    render_sum_n(mesh, mesh_cam, RenderConfig(width=64, height=64, spp=8, max_depth=50))  # warm-up
    cfg = RenderConfig(width=600, height=600, spp=64, max_depth=50, background=(0.0, 0.0, 0.0))
    for rep in range(2):
        out[f"mesh_{rep}"] = 600 * 600 * 64 / timed(lambda: render_sum_n(mesh, mesh_cam, cfg)) / 1e6

    b = SceneBuilder()
    fs_cam = make_camera(**smoke.final_scene_stand_in(b, smoke.earth_stand_in()), device=dev)
    fs = b.finalize(device=dev)
    cfg = RenderConfig(width=600, height=600, spp=32, max_depth=50, background=(0.0, 0.0, 0.0))
    out["final_scene"] = 600 * 600 * 32 / timed(lambda: render_sum_n(fs, fs_cam, cfg)) / 1e6

    bundle = SCENES["cornell_box"](device=dev)
    cam = make_camera(**bundle.camera_kwargs, device=dev)
    tcfg = TraceConfig(max_depth=50, background=bundle.background)
    for rep in range(2):
        out[f"pixel_pool_{rep}"] = 256 * 256 * 4 * 512 / timed(lambda: render_batch_regen(
            bundle.scene, cam, launch0(0, 0, dev), 256, 256, 4, 512, tcfg, schedule=Schedule.PIXEL)) / 1e6
    out["card"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                 capture_output=True, text=True, check=True).stdout.strip()
    return out


if __name__ == "__main__":
    print(json.dumps(main(sys.argv[1] if len(sys.argv) > 1 else ".")), flush=True)
