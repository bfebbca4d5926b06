"""The benchmark's cells on one device: the port's counterpart of ``bench.py``.

Usage::

    python -m raytracer2022_tpu_torch.tools.bench [--device cuda] [--reps N] \\
        [--size-div D] [--spp-div D]

The cells are ``bench.py``'s, at its shapes and depth 50 unless named:

- ``book3`` (the headline ``value``): ``cornell_box`` 256x256, one
  ``render_batch_regen`` launch of 4 lanes a pixel x 512 samples under the
  pixel pool; ``book1``: ``random_scene`` 128x128, 2 x 512, pixel pool;
  ``book2``: ``final_scene`` 128x128, 8 x 32, the schedule
  ``choose_schedule`` picks (the global pool, as JAX's heuristic);
  ``obj``: ``wwscene`` 128x128, 4 x 64, global pool.  Mpaths/s.
- ``fwd_bwd``: ``cornell_box`` 256x256, 2 x 32, ``render_batch_regen_diff``
  over ``regen_iters_estimate(split_drain=True)``'s trip counts, loss
  ``mean(img / clamp(cnt, 1))``, gradients of ``materials.param`` and
  ``textures.color``; ``fwd_bwd_obj``: ``wwscene`` 128x128, 4 x 8, of
  ``textures.color``; ``fwd_bwd_scan``: ``cornell_box`` 256x256 x 64
  through the fixed-depth ``render_batch``, loss its mean.  Paths/s.
- ``fit_step``: ``parallel/mesh.py::fit_step_fn`` at 64x64 x 32, depth 8,
  against a black target.  Seconds.

Each cell is timed as ``bench.py::_median_time``: one warm-up call with
seed 0 (on a mesh scene it builds K1), then ``reps`` calls with seeds 1 to
``reps``, each ended by ``torch.cuda.synchronize()`` on the card; the time
taken is ``times[len // 2]`` of the sorted times (with 2 reps the larger).
Prints the device line (the card's name and power limit from nvidia-smi),
one JSON detail line a cell (seconds as median, min and max, K1's launches
in one timed call, a forward cell's iterations in that call, peak device
memory of the fwd+bwd cells, the asset directory of the wwscene cells), and last one JSON line with ``bench.py``'s
keys in its order, unrounded; a run cut by ``--reps``, ``--size-div`` or
``--spp-div`` adds ``"cut"``, which names the cut.

``final_scene`` and ``wwscene`` read their files from ``RT2022_SOURCE_DIR``;
where it is unset, from the stand-ins that
``tools/standins.py::write_stand_in_assets`` writes into a temporary
directory.
``--device`` defaults to the card and raises without one; ``--device cpu``
times the plain versions on the CPU, which says nothing of the card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import tempfile
import time
from typing import NamedTuple, Optional

REF_CPU_PATHS_PER_S = 1e6  # bench.py's estimate for the reference on 8 CPU threads (it publishes no numbers)
METRIC = "forward primary paths/s/chip, Cornell box depth-50"
DEPTH = 50


class Cell(NamedTuple):
    """One cell of ``bench.py``: ``spp_par`` lanes a pixel of ``spp_seq``
    samples each (``spp_par`` 1 and ``spp_seq`` the spp for the scan and the
    fit step); ``schedule`` a :class:`render.integrator.Schedule` value or
    None for ``choose_schedule``'s."""

    key: str
    scene: str
    width: int
    height: int
    spp_par: int
    spp_seq: int
    reps: int
    schedule: Optional[str] = None
    depth: int = DEPTH


FORWARD = (  # bench.py l. 110, 118-120
    Cell("book3", "cornell_box", 256, 256, 4, 512, 5, "pixel"),
    Cell("book1", "random_scene", 128, 128, 2, 512, 5, "pixel"),
    Cell("book2", "final_scene", 128, 128, 8, 32, 5),
    Cell("obj", "wwscene", 128, 128, 4, 64, 5, "global"),
)
FWD_BWD = Cell("fwd_bwd", "cornell_box", 256, 256, 2, 32, 3)  # bench.py l. 129-156
FWD_BWD_OBJ = Cell("fwd_bwd_obj", "wwscene", 128, 128, 4, 8, 2)  # l. 162-181
FWD_BWD_SCAN = Cell("fwd_bwd_scan", "cornell_box", 256, 256, 1, 64, 2)  # l. 184-197
FIT_STEP = Cell("fit_step", "cornell_box", 64, 64, 1, 32, 3, depth=8)  # l. 200-211
CELLS = FORWARD + (FWD_BWD, FWD_BWD_OBJ, FWD_BWD_SCAN, FIT_STEP)
KEYS = ("metric", "value", "unit", "vs_baseline", "vs_baseline_estimate",
        *(f"{c.key}_{s}" for c in FORWARD for s in ("Mpaths_s", "spread")),
        "fwd_bwd_paths_per_s", "fwd_bwd_regen_iters", "fwd_bwd_obj_paths_per_s", "fwd_bwd_scan_paths_per_s",
        "fit_step_s")  # bench.py's last line, in its order


def cut_cell(cell: Cell, size_div: int, spp_div: int, reps: Optional[int]) -> Cell:
    """``cell`` with its width and height divided by ``size_div`` (at least
    2: a ray's u divides by ``width - 1``), its ``spp_seq`` by ``spp_div``
    (at least 1), and ``reps`` in place of its own where given."""
    return cell._replace(width=max(2, cell.width // size_div), height=max(2, cell.height // size_div),
                         spp_seq=max(1, cell.spp_seq // spp_div), reps=cell.reps if reps is None else reps)


def median_time(fn, reps: int, device) -> tuple:
    """``bench.py::_median_time``: ``fn(0)`` to warm up, then ``fn(i)`` for
    ``i`` in 1..``reps``, each timed to ``synchronize(device)`` -> (median,
    min, max seconds, K1 launches of the last timed call, what it
    returned).  The median is ``times[len // 2]`` of the sorted times."""
    from ..ops import bvh8
    from ..utils.device import synchronize

    fn(0)
    synchronize(device)
    times = []
    for seed in range(1, reps + 1):
        bvh8.LAUNCHES = 0
        t0 = time.perf_counter()
        out = fn(seed)
        synchronize(device)
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2], times[0], times[-1], bvh8.LAUNCHES, out


def forward_fn(bundle, cam, cell: Cell):
    """``fn(seed)``: one forward launch of ``cell`` -> its iterations by
    phase (``trace_regen``'s pool and two drains)."""
    import torch

    from ..render.integrator import Schedule, TraceConfig, step_generator
    from ..render.renderer import render_batch_regen

    tcfg = TraceConfig(max_depth=cell.depth, background=bundle.background)
    schedule = None if cell.schedule is None else Schedule(cell.schedule)

    def fn(seed: int):
        with torch.no_grad():
            img, iters = render_batch_regen(bundle.scene, cam, step_generator(seed, 0, bundle.scene.device),
                                            cell.width, cell.height, cell.spp_par, cell.spp_seq, tcfg,
                                            return_iters=True, schedule=schedule)
        if not bool(torch.isfinite(img).all()):
            raise RuntimeError(f"bench: {cell.key} rendered non-finite pixels")
        return iters

    return fn


def fwd_bwd_fn(bundle, cam, cell: Cell, wrt, n_iters: Optional[int] = None, n_drain: int = 0):
    """``fn(seed)``: one fwd+bwd step of ``cell``: the regeneration render
    over ``n_iters`` (+ ``n_drain``) trip counts, loss ``mean(img /
    clamp(cnt, 1))``, or with ``n_iters`` None the fixed-depth render of
    ``cell.spp_seq`` samples, loss its mean; ``torch.autograd.grad`` of the
    tables named in ``wrt`` -> the gradients, in that order."""
    import torch

    from ..parallel.mesh import with_params
    from ..render.integrator import TraceConfig
    from ..render.renderer import render_batch, render_batch_regen_diff

    scene = bundle.scene
    tcfg = TraceConfig(max_depth=cell.depth, background=bundle.background)

    def fn(seed: int):
        leaves = {"materials.param": scene.materials.param.detach().clone(),
                  "textures.color": scene.textures.color.detach().clone()}
        for name in wrt:
            leaves[name].requires_grad_()
        s = with_params(scene, leaves["materials.param"], leaves["textures.color"])
        if n_iters is None:
            loss = torch.mean(render_batch(s, cam, seed, cell.width, cell.height, cell.spp_seq, tcfg))
        else:
            img, cnt = render_batch_regen_diff(s, cam, seed, cell.width, cell.height, cell.spp_par, cell.spp_seq,
                                               n_iters, tcfg, n_drain=n_drain)
            loss = torch.mean(img / torch.clamp(cnt, min=1)[None])
        grads = torch.autograd.grad(loss, [leaves[name] for name in wrt])
        if not all(bool(torch.isfinite(g).all()) for g in grads):
            raise RuntimeError(f"bench: {cell.key} has non-finite gradients")
        return grads

    return fn


def fit_fn(bundle, cam, cell: Cell):
    """``fn(seed)``: one ``fit_step_fn`` step of ``cell`` from the scene's
    own tables against a black target."""
    import torch

    from ..parallel.mesh import fit_step_fn
    from ..render.renderer import RenderConfig

    step = fit_step_fn(RenderConfig(width=cell.width, height=cell.height, spp=cell.spp_seq, max_depth=cell.depth,
                                    background=bundle.background))
    target = torch.zeros((3, cell.height, cell.width), device=bundle.scene.device)

    def fn(seed: int):
        loss = step(bundle.scene, cam, target, seed)[2]
        if not bool(torch.isfinite(loss)):
            raise RuntimeError("bench: the fit step's loss is not finite")

    return fn


def measure(cell: Cell, fn, device, peak_memory: bool = False) -> tuple:
    """Time ``fn`` over ``cell.reps`` calls (:func:`median_time`) -> (the
    cell's detail record, what the last call returned); with
    ``peak_memory``, on the card, the record holds the peak device memory
    of the calls above what was allocated before them."""
    import torch

    measure_peak = peak_memory and device.type == "cuda"
    if measure_peak:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
    t_med, t_min, t_max, launches, out = median_time(fn, cell.reps, device)
    rec = {"cell": cell.key, "scene": cell.scene, "width": cell.width, "height": cell.height,
           "spp_par": cell.spp_par, "spp_seq": cell.spp_seq, "schedule": cell.schedule, "depth": cell.depth,
           "reps": cell.reps, "paths": cell.width * cell.height * cell.spp_par * cell.spp_seq,
           "seconds": [t_med, t_min, t_max], "k1_launches": launches}
    if peak_memory:
        rec["peak_gib_above_base"] = (torch.cuda.max_memory_allocated(device) - base) / 2**30 if measure_peak else None
    return rec, out


def regen_trips(bundle, cam, cell: Cell) -> tuple:
    """``regen_iters_estimate(split_drain=True)`` of ``cell``, as ``bench.py``
    takes them before it times its fwd+bwd cells."""
    from ..render.integrator import TraceConfig
    from ..render.renderer import regen_iters_estimate

    tcfg = TraceConfig(max_depth=cell.depth, background=bundle.background)
    return regen_iters_estimate(bundle.scene, cam, cell.width, cell.height, cell.spp_par, cell.spp_seq, tcfg,
                                split_drain=True)


def rate(rec: dict, unit: float = 1.0) -> tuple:
    """A cell's (median, lowest, highest) paths per second over ``unit``:
    the median time's rate, the slowest call's, the fastest call's."""
    t_med, t_min, t_max = rec["seconds"]
    paths = rec["paths"] / unit
    return paths / t_med, paths / t_max, paths / t_min


def main(argv=None) -> int:
    from ..utils.device import resolve_device
    from . import device_kind, device_line

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default), cuda:N or cpu")
    ap.add_argument("--reps", type=int, default=None, help="timed calls of every cell (default: bench.py's)")
    ap.add_argument("--size-div", type=int, default=1, help="divide every width and height (tests, the smoke)")
    ap.add_argument("--spp-div", type=int, default=1, help="divide every spp_seq (tests, the smoke)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    print(device_line(device), flush=True)
    cells = {c.key: cut_cell(c, args.size_div, args.spp_div, args.reps) for c in CELLS}
    bundles, recs = {}, {}

    def bundle(name):
        from ..render.camera import make_camera
        from ..scene.library import SCENES

        if name not in bundles:
            b = SCENES[name](device=device)
            bundles[name] = (b, make_camera(**b.camera_kwargs, device=device))
        return bundles[name]

    def emit(rec, **extra):
        rec.update(extra)
        if rec["scene"] == "wwscene":
            rec["assets"] = os.environ["RT2022_SOURCE_DIR"]
        rec["device"] = device_kind(device)
        recs[rec["cell"]] = rec
        print(json.dumps(rec), flush=True)

    with contextlib.ExitStack() as stack:
        if os.environ.get("RT2022_SOURCE_DIR") is None:
            from .standins import source_dir_env, write_stand_in_assets

            src = os.path.join(stack.enter_context(tempfile.TemporaryDirectory()), "stand-ins")
            write_stand_in_assets(src)
            stack.enter_context(source_dir_env(src))
        for cell in FORWARD:
            c = cells[cell.key]
            b, cam = bundle(c.scene)
            rec, iters = measure(c, forward_fn(b, cam, c), device)
            emit(rec, iters=iters)
        for cell, wrt in ((FWD_BWD, ("materials.param", "textures.color")), (FWD_BWD_OBJ, ("textures.color",))):
            c = cells[cell.key]
            b, cam = bundle(c.scene)
            n_iters, n_drain = regen_trips(b, cam, c)
            emit(measure(c, fwd_bwd_fn(b, cam, c, wrt, n_iters, n_drain), device, peak_memory=True)[0],
                 n_iters=n_iters, n_drain=n_drain)
        c = cells[FWD_BWD_SCAN.key]
        b, cam = bundle(c.scene)
        emit(measure(c, fwd_bwd_fn(b, cam, c, ("materials.param", "textures.color")), device, peak_memory=True)[0])
        c = cells[FIT_STEP.key]
        emit(measure(c, fit_fn(*bundle(c.scene), c), device)[0])

    out = {"metric": METRIC}
    book3 = rate(recs["book3"], 1e6)[0]
    out.update(value=book3 * 1e6, unit="paths/s", vs_baseline=book3 * 1e6 / REF_CPU_PATHS_PER_S,
               vs_baseline_estimate=True)  # the reference publishes no numbers; 1 Mpaths/s is bench.py's estimate
    for cell in FORWARD:
        med, lo, hi = rate(recs[cell.key], 1e6)
        out[f"{cell.key}_Mpaths_s"] = med
        out[f"{cell.key}_spread"] = [lo, hi]
    out["fwd_bwd_paths_per_s"] = rate(recs["fwd_bwd"])[0]
    out["fwd_bwd_regen_iters"] = recs["fwd_bwd"]["n_iters"]
    out["fwd_bwd_obj_paths_per_s"] = rate(recs["fwd_bwd_obj"])[0]
    out["fwd_bwd_scan_paths_per_s"] = rate(recs["fwd_bwd_scan"])[0]
    out["fit_step_s"] = recs["fit_step"]["seconds"][0]
    cut = [f"{flag} {v}" for flag, v, default in (("--size-div", args.size_div, 1), ("--spp-div", args.spp_div, 1),
                                                  ("--reps", args.reps, None)) if v != default]
    if cut:
        out["cut"] = ", ".join(cut)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
