"""Mode ``frame``: the program renders the configuration's frame in passes.

Set-up: the scene is made from the seed and compiled by the program
(``scene_build_s``); one strip launch of the frame's lane count at two
samples a lane loads the kernels and sizes the allocator.  The window:
passes of ``pass_spp`` samples a pixel through ``render_sum_n``, each pass
with its own seed, each ending in a synchronisation; a pass starts while
the window's time, plus one pass more, fits in ``--seconds``, and always
``min_units`` passes (two passes give the comparison the passes' own
spread).
``Mpaths_s`` is the pixels times the samples of every pass over the wall
time from the window's start to the end of its last pass.

After the window: the device's peak memory, the per-layer metrics (traced
runs), then the program's state is freed and the plain reference renders
the same description with ``ref_spp`` samples a pixel; the tiles compare
(``harness/compare.py``) against the workload's limits.
"""

from __future__ import annotations

import gc
import time

import numpy as np


def pass_seed(seed: int, k: int) -> int:
    return int(np.random.SeedSequence([seed, 1, k]).generate_state(1, np.uint64)[0] >> 1)


class UnitLog(list):
    """``render_sum_n``'s launch log, which marks each launch's end (after
    its synchronisation) for the tracer."""

    def __init__(self, tracer):
        super().__init__()
        self.tracer = tracer

    def append(self, item) -> None:
        super().append(item)
        self.tracer.boundary()


def measure(cell, seed: int, seconds: float, trace: bool, t_start: float, device, frame=None, describe_kw=None,
            render=None, ref_spp=None):
    """One run on ``device`` -> a dict of the run's record.  ``frame``,
    ``describe_kw``, ``render`` (in place of ``render_sum_n``) and
    ``ref_spp`` are for tests on the CPU at small sizes."""
    import torch

    from harness import trace as tracing
    from harness.cell import Context, read_per_layer
    from harness.compare import frame_numbers
    from harness.scene import build_port_scene
    from raytracer2022_tpu_torch import RenderConfig, render_sum_n
    from raytracer2022_tpu_torch.render.integrator import step_generator
    from raytracer2022_tpu_torch.render.renderer import render_batch_regen

    p = cell.params
    cfg = cell.config
    render = render_sum_n if render is None else render
    width, height = frame or cfg.FRAME
    pass_spp = int(p["pass_spp"])
    desc = cfg.describe(seed, **(describe_kw or {}))
    scene, cam, build_s = build_port_scene(desc, device)

    def rcfg(s):
        return RenderConfig(width=width, height=height, spp=pass_spp, max_depth=cfg.DEPTH,
                            background=tuple(desc["background"]), seed=s)

    base = rcfg(0)
    rows = max(1, min(height, base.max_rays_per_batch // width))  # render_sum_n's strip at one lane a pixel
    with torch.no_grad():
        render_batch_regen(scene, cam, step_generator(seed, 1 << 40, device), width, height, 1, 2,
                           base.trace_cfg(), row0=0, rows=rows)
    _sync(device)

    tracer = tracing.Tracer(trace, int(p.get("trace_every", 4)), int(p.get("trace_limit", 4)))
    log = UnitLog(tracer)
    pass_sums, n_done = [], 0
    min_units = int(p.get("min_units", 1))
    t0 = time.perf_counter()
    tracer.boundary()
    while True:
        ts = time.perf_counter()
        with torch.no_grad():
            total, n = render(scene, cam, rcfg(pass_seed(seed, len(pass_sums))), launch_log=log)
        pass_sums.append(total.float().cpu())
        n_done += n
        now = time.perf_counter()
        if len(pass_sums) >= min_units and now - t0 + (now - ts) > seconds:
            break
    window_s = time.perf_counter() - t0
    tracer.close()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    setup = {"scene_build_s": build_s}
    ctx = Context(units=list(log), profiled=tracer.profiled, trace=tracer.summary(), setup=setup,
                  probes={"k1": lambda: k1_probe(scene, cam, width, height, seed, device)})
    rec = {"setup_s": t0 - t_start, "window_s": window_s, "passes": len(pass_sums), "memory_peak_bytes": peak,
           "attempted": len(pass_sums), "failed": sum(1 for t in pass_sums if not bool(torch.isfinite(t).all())),
           "e2e": {"Mpaths_s": width * height * pass_spp * len(pass_sums) / window_s / 1e6, "setup_s": t0 - t_start},
           "per_layer": read_per_layer(cell, ctx) if trace else {}, "trace": ctx.trace}
    log_units = list(log)
    del scene, cam, ctx, log
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    from reference import tracer as reference

    m = int(ref_spp or p["ref_spp"])
    t_ref = time.perf_counter()
    s, q = reference.render_sums(reference.Tables(desc, device), width, height, m, cfg.DEPTH, seed=seed)
    rec["reference_s"] = time.perf_counter() - t_ref
    rec["numbers"] = frame_numbers(pass_sums, pass_spp, len(pass_sums) * pass_spp, s, q, m, int(p["tile"]))
    rec["worst_tile"] = rec["numbers"].pop("_worst_tile", None)
    rec["iterations"] = sum(u.get("pool", 0) + u.get("drain_n4", 0) + u.get("drain_n16", 0) for u in log_units)
    rec["numbers"]["samples_gap"] = float(abs(n_done - len(pass_sums) * pass_spp))
    return rec


def k1_probe(scene, cam, width: int, height: int, seed: int, device, n: int = 262144, reps: int = 20):
    """K1 on ``n`` camera rays of the frame (pixels drawn from the seed),
    the dense primitives' closest t as ``t_init``, as ``closest_hit``
    passes it: its visit counts, the frozen bound, and its device time a
    launch under the profiler -> dict, or None without a packet tree."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from harness.k1_bound import k1_bound, tree_bytes
    from raytracer2022_tpu_torch.ops.bvh8 import traverse_bvh8
    from raytracer2022_tpu_torch.ops.intersect import candidate_t
    from raytracer2022_tpu_torch.render.camera import get_rays

    trees = [(i, t) for i, t in enumerate(scene.bvh8) if t is not None]
    if not trees or device.type != "cuda":
        return None
    i, tree = trees[0]
    kind = scene.stats.trees[i][0]
    gen = torch.Generator(device=device)
    gen.manual_seed(pass_seed(seed, 1 << 20))
    pix = torch.randint(0, width * height, (n,), generator=gen, device=device)
    u = ((pix % width).float() + torch.rand(n, generator=gen, device=device)) / (width - 1)
    v = ((pix // width).float() + torch.rand(n, generator=gen, device=device)) / (height - 1)
    with torch.no_grad():
        o, d, tm = get_rays(cam, u, v, gen)
        t_dense = candidate_t(scene, o, d, tm, 1e-3, float("inf"),
                              prim_slice=slice(scene.stats.n_in_bvh, scene.n_prims)).amin(dim=0)
        visits = traverse_bvh8(tree, kind, o, d, tm, 1e-3, t_init=t_dense, return_visits=True)[-1]
        groups, leaves = (int(x) for x in visits.sum(dim=1, dtype=torch.int64).cpu())
        bound = k1_bound(tree_bytes(tree), kind, n, groups, leaves, rows=True)
        traverse_bvh8(tree, kind, o, d, tm, 1e-3, t_init=t_dense, return_rows=True)
        torch.cuda.synchronize(device)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                traverse_bvh8(tree, kind, o, d, tm, 1e-3, t_init=t_dense, return_rows=True)
            torch.cuda.synchronize(device)
    dev_us = sum(e.self_device_time_total for e in prof.key_averages()
                 if "bvh8" in e.key and str(e.device_type).endswith("CUDA"))
    if dev_us <= 0:
        return None
    ms = dev_us / reps / 1e3
    return {**bound, "device_ms": ms, "share_pct": 100.0 * bound["bound_ms"] / ms, "rays": n,
            "groups_per_ray": groups / n, "leaves_per_ray": leaves / n}


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(cell, seed: int, seconds: float, trace: bool, t_start: float) -> int:
    import torch

    from harness.result import report

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    rec = measure(cell, seed, seconds, trace, t_start, device)
    notes = {k: rec[k] for k in ("passes", "window_s", "setup_s", "reference_s", "worst_tile", "iterations")}
    return report(cell, rec, trace, dict(notes, seed=seed))
