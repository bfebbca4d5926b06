"""Per-scene throughput of the port: scene build, first call, steady state.

Counterpart of ``tools/perf.py``.  Usage::

    python -m raytracer2022_tpu_torch.tools.perf [scene ...] [--spp 16] [--size 128x128] \\
        [--depth 50] [--reps 3] [--scan] [--device cuda]

A scene is a name of ``scene.library.SCENES`` or ``module:function`` as
``parallel/worker.py::build_scene`` takes it.  The scenes that read files
(``earth``, ``final_scene``, ``obj_uv_demo``, ``wwscene``) read them from
``RT2022_SOURCE_DIR`` as the library does; where it is unset, from the
stand-ins that ``tools/standins.py::write_stand_in_assets`` writes into a
temporary directory (the repository does not hold the reference's files).  Their
records name the directory.  The default list is cornell_box,
random_scene, final_scene and wwscene.

Each scene renders one launch of ``render_batch_regen`` with the JAX tool's
split, ``spp_par = max(1, min(spp // 8, 2**19 // (w * h)))`` lanes per
pixel and ``spp_seq = ceil(spp / spp_par)`` samples each, or with
``--scan`` one launch of the fixed-depth ``render_batch`` of ``spp``
samples per pixel.  The first call (seed 0) includes what the JAX tool's
includes in place of its compile: building K1 with nvcc on a mesh scene.
``steady_s`` is the median of ``max(reps, 3)`` calls, call ``i`` with the
seed ``i + 1``; every timed call ends in ``torch.cuda.synchronize()`` on
the card.  Prints the card's name and power limit (nvidia-smi), then one
JSON line per scene with the JAX tool's keys, unrounded, and the device's
name and K1's launches in one steady call beside them.  ``--device``
defaults to the card and raises without one; ``--device cpu`` times the
plain versions on the CPU, which says nothing of the card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import tempfile
import time

DEFAULT_SCENES = ("cornell_box", "random_scene", "final_scene", "wwscene")


def regen_split(spp: int, width: int, height: int) -> tuple[int, int]:
    """``(spp_par, spp_seq)``: the JAX tool's split of ``spp`` samples."""
    spp_par = max(1, min(spp // 8, (1 << 19) // (width * height)))
    return spp_par, -(-spp // spp_par)


def measure(name: str, width: int, height: int, spp: int, depth: int, reps: int, scan: bool, device) -> dict:
    """One scene's record (see the module docstring)."""
    import torch

    from ..ops import bvh8
    from ..parallel.worker import build_scene
    from ..render.integrator import step_generator
    from ..render.renderer import RenderConfig, render_batch, render_batch_regen
    from ..utils.device import synchronize
    from . import device_kind

    t0 = time.perf_counter()
    scene, cam, background = build_scene(name, width, height, device)
    synchronize(device)
    t_build = time.perf_counter() - t0
    tcfg = RenderConfig(width=width, height=height, spp=spp, max_depth=depth, background=background).trace_cfg()
    spp_par, spp_seq = regen_split(spp, width, height)

    def render(seed: int):
        with torch.no_grad():
            if scan:
                return render_batch(scene, cam, seed, width, height, spp, tcfg)
            return render_batch_regen(scene, cam, step_generator(seed, 0, device), width, height, spp_par,
                                      spp_seq, tcfg)

    def timed(seed: int) -> float:
        t0 = time.perf_counter()
        img = render(seed)
        synchronize(device)
        dt = time.perf_counter() - t0
        if not bool(torch.isfinite(img).all()):
            raise RuntimeError(f"perf: {name} rendered non-finite pixels")
        return dt

    t_first = timed(0)
    times = []
    for i in range(max(reps, 3)):
        bvh8.LAUNCHES = 0
        times.append(timed(i + 1))
    t_run = sorted(times)[len(times) // 2]
    paths = width * height * spp
    return {
        "scene": name,
        "prims": int(scene.n_prims),
        "scene_build_s": t_build,
        "first_call_s": t_first,
        "steady_s": t_run,
        "Mpaths_per_s": paths / t_run / 1e6,
        "device": device_kind(device),
        "k1_launches": bvh8.LAUNCHES,
    }


def main(argv=None) -> int:
    from ..scene.library import READS_FILES
    from ..utils.device import resolve_device
    from . import device_line

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("scenes", nargs="*", default=None)
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--size", default="128x128", help="HxW")
    ap.add_argument("--depth", type=int, default=50)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--scan", action="store_true", help="the fixed-depth render_batch")
    ap.add_argument("--device", default="cuda", help="cuda (default), cuda:N or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    h, w = (int(x) for x in args.size.split("x"))
    names = args.scenes or DEFAULT_SCENES
    print(device_line(device), flush=True)
    with contextlib.ExitStack() as stack:
        src = os.environ.get("RT2022_SOURCE_DIR")
        if src is None and set(names) & set(READS_FILES):
            from .standins import source_dir_env, write_stand_in_assets

            src = os.path.join(stack.enter_context(tempfile.TemporaryDirectory()), "stand-ins")
            write_stand_in_assets(src)
            stack.enter_context(source_dir_env(src))
        for name in names:
            rec = measure(name, w, h, args.spp, args.depth, args.reps, args.scan, device)
            if name in READS_FILES:
                rec["assets"] = src
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
