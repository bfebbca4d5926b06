"""The reference's whole workload on one card, restart-safe.

Counterpart of ``tools/flagship.py``.  The reference renders ``wwscene`` at
2560x1440 x 2000 spp, depth 50, to ``output/output.jpg`` (raytracer/src/
main.rs:33-41, 89).  This tool runs that workload through the port's
``render_sum_n`` in outer chunks: chunk ``ci`` renders ``min(chunk, spp -
lo)`` samples with seed ``1000 + ci``, rescaled by ``spp_c / n`` (the
renderer rounds a chunk up to whole launches and returns its sample count
``n``), into a float64 host total that is saved atomically to ``--state``
after every chunk, so a killed run resumes where it stopped.  Usage::

    RT2022_SOURCE_DIR=DIR python -m raytracer2022_tpu_torch.tools.flagship \\
        [--spp 2000] [--chunk 125] [--width 2560] [--height 1440] \\
        [--state FILE.npz] [--out FILE.png] [--golden FILE.jpg] [--device cuda]

The scene reads its files from ``RT2022_SOURCE_DIR`` as the library does; a
missing file raises the library's ``FileNotFoundError`` (the tool writes no
stand-ins: ``tools/standins.py`` does, on request).  Prints
the card's name and power limit (nvidia-smi), the JAX tool's ``# chunk
i/n`` lines, and one JSON line with its keys (``workload``, ``wall_s``,
``paths``, ``Mpaths_per_s``; ``mae``, ``rmse``, ``exposure``,
``mae_norm`` and ``note`` against ``--golden`` where that file exists,
``''`` skips it), unrounded, with the device's name, K1's launches in this
run and the asset directory beside them.  ``--golden`` defaults to
``output/output.jpg`` under ``RT2022_REFERENCE_DIR`` (``tools/golden.py``).
``--state`` and ``--out`` default to the temporary directory.  ``--device``
defaults to the card and raises without one.

A chunk is skipped on resume when ``lo + spp_c <= done_spp``.  The JAX tool
skips on ``lo + chunk <= done_spp`` (``tools/flagship.py:71``), which
renders a finished partial last chunk again on a rerun and adds it to the
total while ``done_spp`` stays, brightening the image.  The state also
keeps ``--chunk``, ``--width`` and ``--height``, and a resume is refused
(``ValueError``, the state untouched) when they differ or when ``done_spp``
does not end a chunk of this run (``min(k * chunk, spp)``): a partial last
chunk resumed with a larger ``--spp``, or another ``--chunk``, would render
samples twice with the seeds of other chunks.  Every other resume, and
every uninterrupted run, is the JAX tool's.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np

from .golden import REFERENCE, compare

DEPTH = 50
FIRST_SEED = 1000  # chunk ci renders with seed FIRST_SEED + ci


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--spp", type=int, default=2000)
    ap.add_argument("--chunk", type=int, default=125)
    ap.add_argument("--width", type=int, default=2560)
    ap.add_argument("--height", type=int, default=1440)
    ap.add_argument("--state", default=os.path.join(tempfile.gettempdir(), "flagship_state.npz"))
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "flagship.png"))
    ap.add_argument("--golden", default=os.path.join(REFERENCE, "output", "output.jpg"),
                    help="reference render to compare against ('' to skip)")
    ap.add_argument("--device", default="cuda", help="cuda (default), cuda:N or cpu")
    args = ap.parse_args(argv)

    from ..utils.imageio import image_extension, read_image, write_image

    try:  # before the state is read and the chunks run: the image is written last
        image_extension(args.out)
        if args.golden and os.path.exists(args.golden):
            image_extension(args.golden)
    except ValueError as e:
        ap.error(str(e))

    import torch

    from ..ops import bvh8
    from ..render.camera import make_camera
    from ..render.film import tonemap_u8
    from ..render.renderer import RenderConfig, render_sum_n
    from ..scene.library import SCENES, source_root
    from ..utils.device import resolve_device
    from . import device_kind, device_line

    device = resolve_device(args.device)
    print(device_line(device), flush=True)
    n_chunks = -(-args.spp // args.chunk)
    meta = {"chunk": args.chunk, "width": args.width, "height": args.height}
    total = np.zeros((3, args.height, args.width), np.float64)
    done_spp = 0
    elapsed = 0.0
    if os.path.exists(args.state):
        with np.load(args.state) as st:
            held = {k: int(st[k]) for k in meta if k in st}
            total = st["total"]
            done_spp = int(st["done_spp"])
            elapsed = float(st["elapsed"])
        if held != meta:
            raise ValueError(f"{args.state} holds a run of {held}, not {meta}: pass its flags or remove it")
        ends = {min(k * args.chunk, args.spp) for k in range(n_chunks + 1)}
        if done_spp not in ends:
            raise ValueError(f"{args.state} holds {done_spp} spp, which ends no chunk of --spp {args.spp} "
                             f"--chunk {args.chunk}: resuming would render samples twice")
        print(f"# resuming: {done_spp}/{args.spp} spp, {elapsed:.0f}s so far")

    launches0 = bvh8.LAUNCHES
    bundle = SCENES["wwscene"](device=device)
    cam = make_camera(**bundle.camera_kwargs, device=device)
    for ci in range(n_chunks):
        lo = ci * args.chunk
        spp_c = min(args.chunk, args.spp - lo)
        if lo + spp_c <= done_spp:
            continue
        cfg = RenderConfig(width=args.width, height=args.height, spp=spp_c, max_depth=DEPTH,
                           background=bundle.background, seed=FIRST_SEED + ci)
        t0 = time.perf_counter()
        part, n = render_sum_n(bundle.scene, cam, cfg)
        part = part.cpu().numpy().astype(np.float64) * (spp_c / n)
        dt = time.perf_counter() - t0
        elapsed += dt
        total = total + part
        done_spp = lo + spp_c
        tmp = args.state + ".tmp.npz"  # savez keeps a name that ends in .npz
        np.savez(tmp, total=total, done_spp=done_spp, elapsed=elapsed, **meta)
        os.replace(tmp, args.state)
        rate = args.width * args.height * spp_c / dt / 1e6
        print(f"# chunk {ci + 1}/{n_chunks}: {spp_c} spp in {dt:.1f}s "
              f"({rate:.2f} Mpaths/s), total {done_spp}/{args.spp}", flush=True)

    img = tonemap_u8(torch.from_numpy(total.astype(np.float32)), done_spp).numpy()
    write_image(args.out, img)

    paths = args.width * args.height * done_spp
    out = {
        "workload": f"wwscene {args.width}x{args.height} x {done_spp} spp x depth {DEPTH}",
        "wall_s": elapsed,
        "paths": paths,
        "Mpaths_per_s": paths / elapsed / 1e6,
        "device": device_kind(device),
        "k1_launches": bvh8.LAUNCHES - launches0,
        "assets": source_root(),
    }
    if args.golden and os.path.exists(args.golden):
        golden = read_image(args.golden).astype(np.float32) / 255.0
        ours = img.astype(np.float32) / 255.0
        if golden.shape != ours.shape:
            out["note"] = f"golden shape {golden.shape} != ours {ours.shape}"
        out.update(compare(ours, golden))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
