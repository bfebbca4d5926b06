"""Mode ``fit``: the program's differentiable fit step, one step after
another.

Set-up: the scene is made from the seed and compiled by the program, the
target image is made from the seed, ``regen_iters_estimate`` takes the trip
count from one forward render, and ``parallel/mesh.py::fit_step_fn``
builds the step.  The same step object then runs the first three steps
from the scene's own leaves (the steps the reference follows), which also
warm it up, and the window goes on from there: whole steps, each read back
(its loss), while the window's time plus one step fits in ``--seconds``,
and always ``min_units`` steps.
``fit_step_s`` is the window's wall time over its steps; ``fit_peak_GiB``
the device's peak allocation in the window above what was allocated
before it.

After the window the program's state is freed and the reference follows
the first three steps itself (``reference/fit.py``); the losses, the
first gradient ((leaves before - leaves after) / lr) and the leaves'
change over the three steps compare over the scene's leaves
(``harness/compare.py::fit_gaps``); the camera's norms are printed.
"""

from __future__ import annotations

import gc
import time

import numpy as np

FIRST_STEPS = 3


def step_seed(seed: int, k: int) -> int:
    return int(np.random.SeedSequence([seed, 3, k]).generate_state(1, np.uint64)[0] >> 1)


def snapshot(scene, cam) -> dict:
    """The step's leaves, by the reference's names, on the host."""
    import dataclasses

    out = {"mat_param": scene.materials.param.detach().float().cpu(),
           "tex_color": scene.textures.color.detach().float().cpu()}
    out.update({f.name: getattr(cam, f.name).detach().float().cpu() for f in dataclasses.fields(cam)})
    return out


def measure(cell, seed: int, seconds: float, trace: bool, t_start: float, device, fit=None, step_fn=None):
    """One run on ``device`` -> the run's record.  ``fit`` (frame and spp)
    and ``step_fn`` (in place of ``fit_step_fn``'s step) are for tests on
    the CPU at small sizes."""
    import torch

    from harness import trace as tracing
    from harness.cell import Context, read_per_layer
    from harness.compare import fit_gaps
    from harness.scene import build_port_scene
    from raytracer2022_tpu_torch import RenderConfig, regen_iters_estimate
    from raytracer2022_tpu_torch.parallel.mesh import fit_regen_split, fit_step_fn

    p = cell.params
    cfg = cell.config
    fit = dict(fit or cfg.FIT)
    width, height, spp = fit["width"], fit["height"], fit["spp"]
    lr = float(p["lr"])
    desc = cfg.describe(seed)
    scene, cam, build_s = build_port_scene(desc, device)
    target = torch.as_tensor(cfg.target(seed, width, height), device=device)
    rc = RenderConfig(width=width, height=height, spp=spp, max_depth=cfg.DEPTH, background=tuple(desc["background"]))
    spp_par, spp_seq = fit_regen_split(spp)
    regen_iters = regen_iters_estimate(scene, cam, width, height, spp_par, spp_seq, rc.trace_cfg(),
                                       seed=step_seed(seed, 1 << 20))
    step = fit_step_fn(rc, lr=lr, regen_iters=regen_iters) if step_fn is None else step_fn(rc, lr, regen_iters)
    first = [snapshot(scene, cam)]
    losses = []
    for k in range(FIRST_STEPS):
        scene, cam, loss = step(scene, cam, target, step_seed(seed, k))
        losses.append(float(loss))
        first.append(snapshot(scene, cam))
    peak_setup = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device) if device.type == "cuda" else 0
    tracer = tracing.Tracer(trace, int(p.get("trace_every", 4)), int(p.get("trace_limit", 2)))
    units = []
    min_units = int(p.get("min_units", 1))
    t0 = time.perf_counter()
    tracer.boundary()
    while True:
        ts = time.perf_counter()
        scene, cam, loss = step(scene, cam, target, step_seed(seed, FIRST_STEPS + len(units)))
        loss = float(loss)
        now = time.perf_counter()
        units.append({"seconds": now - ts, "loss": loss})
        tracer.boundary()
        if len(units) >= min_units and now - t0 + (now - ts) > seconds:
            break
    window_s = time.perf_counter() - t0
    tracer.close()
    peak_window = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    ctx = Context(units=units, profiled=tracer.profiled, trace=tracer.summary(),
                  setup={"scene_build_s": build_s, "regen_iters": regen_iters})
    rec = {"setup_s": t0 - t_start, "window_s": window_s, "steps": len(units), "regen_iters": regen_iters,
           "memory_peak_bytes": max(peak_setup, peak_window),
           "e2e": {"fit_step_s": window_s / len(units), "fit_peak_GiB": (peak_window - base) / 2**30,
                   "setup_s": t0 - t_start},
           "per_layer": read_per_layer(cell, ctx) if trace else {}, "trace": ctx.trace,
           "attempted": len(units), "failed": sum(1 for u in units if not np.isfinite(u["loss"]))}
    prog = {"losses": losses,
            "first_grad": {k: (first[0][k] - first[1][k]) / lr for k in first[0]},
            "change": {k: first[FIRST_STEPS][k] - first[0][k] for k in first[0]}}
    del scene, cam, step, ctx
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    from reference.fit import follow

    t_ref = time.perf_counter()
    ref = follow(desc, target, width, height, spp, cfg.DEPTH, lr, FIRST_STEPS, seed=step_seed(seed, 1 << 30))
    rec["reference_s"] = time.perf_counter() - t_ref
    ref = {"losses": ref["losses"], "first_grad": {k: v.cpu() for k, v in ref["first_grad"].items()},
           "change": {k: v.cpu() for k, v in ref["change"].items()}}
    gaps = fit_gaps(prog, ref)
    rec["leaves"] = gaps.pop("_leaves")
    rec["numbers"] = gaps
    rec["losses"] = {"program": losses, "reference": ref["losses"]}
    return rec


def run(cell, seed: int, seconds: float, trace: bool, t_start: float) -> int:
    import torch

    from harness.result import report

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    rec = measure(cell, seed, seconds, trace, t_start, device)
    notes = {k: rec[k] for k in ("steps", "regen_iters", "window_s", "setup_s", "reference_s", "leaves", "losses")}
    return report(cell, rec, trace, dict(notes, seed=seed))
