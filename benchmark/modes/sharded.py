"""Mode ``sharded``: the configuration's frame rendered by ``WORLD`` ranks
on one host, one card each, as ``rt2022-torch --sharded`` renders it.

The run starts the ranks (``modes/sharded_rank.py``) with the program's
``parallel/worker.py::launch_local``, which kills every rank and raises
when one fails or the time limit (the window and ``MARGIN_S``) passes, so
the run ends non-zero and never hangs.  Each rank joins through
``init_distributed`` (the configuration's ``BACKEND``) and
``make_device_mesh``, compiles the description
(``harness/scene.py::build_port_scene``) and warms up: one strip launch
at two samples a lane, as mode ``frame`` does, and one all_reduce of a
buffer of the sum's size, which makes the communicator.  The ranks meet
at a barrier.  The window then runs passes back to back, each one
``render_sharded_regen_sum`` of ``pass_spp`` samples a pixel with a
launch log, its seed ``pass_seed(seed, k)`` as in mode ``frame``; rank 0
decides after each pass by mode ``frame``'s rule whether another starts,
and broadcasts it.  ``Mpaths_s`` is the pixels times the samples of every
pass over rank 0's wall time from the window's start to the end of its
last pass; ``setup_s`` runs from this process's start to that window's
start (one host: ``time.perf_counter`` is its monotonic clock).

After the window every rank writes its records and exits.  The readers'
context is rank 0's (its launch log, its profiled units under
``--trace 1``, its set-up), and every rank's launch log is the probe
``ranks``.  With the ranks gone, and their device state with them, the
plain reference renders the description on one device and the window's
pass sums (rank 0's copy of each all-reduced sum) compare with it as in
mode ``frame``.
"""

from __future__ import annotations

import collections
import json
import os
import sys
import tempfile
import time

import numpy as np

RANK = os.path.join(os.path.dirname(os.path.abspath(__file__)), "sharded_rank.py")
# the time limit of the ranks beyond the window: start, compile, first
# builds of the kernels, the communicator, one pass beyond the window
MARGIN_S = 300.0
FAULTS = ("rank_left_out",)  # the last rank's share left out of the sum, its samples still counted


def pass_records(units: list, profiled=frozenset()) -> list:
    """The passes of a rank's launch log, each ended by the collective's
    record: the strips' seconds, the collective's seconds, and whether a
    unit of the pass is in ``profiled`` -> list, empty where the log holds
    no collective record."""
    out, strip_s, hit = [], 0.0, False
    for i, u in enumerate(units):
        hit = hit or i in profiled
        if "collective" in u:
            out.append({"strip_s": strip_s, "collective_s": u["seconds"], "profiled": hit})
            strip_s, hit = 0.0, False
        else:
            strip_s += u["seconds"]
    return out


def rank_records(out: str, world: int) -> list:
    """Each rank's record (``sharded_rank.py``), rank 0's trace summary
    with its counters restored."""
    ranks = []
    for k in range(world):
        with open(os.path.join(out, f"rank{k}.json")) as f:
            ranks.append(json.load(f))
    tr = ranks[0].get("trace")
    if tr is not None:
        for key in ("kernels", "spans", "gaps"):
            tr[key] = collections.Counter(tr[key])
    return ranks


def measure(cell, seed: int, seconds: float, trace: bool, t_start: float, device_type: str = "cuda", frame=None,
            describe_kw=None, ref_spp=None, fault=None):
    """One run of ``WORLD`` ranks on devices of ``device_type`` -> a dict
    of the run's record.  ``frame``, ``describe_kw``, ``ref_spp`` and
    ``device_type`` "cpu" (ranks over gloo) are for tests at small sizes;
    ``fault`` (one of ``FAULTS``) plants a fault for the control."""
    import torch

    from harness.cell import Context, load_module, read_per_layer
    from harness.compare import frame_numbers
    from raytracer2022_tpu_torch.parallel.worker import launch_local

    if fault is not None and fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    p, cfg = cell.params, cell.config
    width, height = frame or cfg.FRAME
    pass_spp = int(p["pass_spp"])
    with tempfile.TemporaryDirectory(prefix="bench-sharded-") as out:
        spec = {"workload": cell.name, "params": p, "seed": seed, "seconds": seconds, "trace": bool(trace),
                "t_start": t_start, "device": device_type, "frame": [width, height],
                "describe_kw": describe_kw or {}, "fault": fault, "out": out}
        with open(os.path.join(out, "spec.json"), "w") as f:
            json.dump(spec, f)
        launch_local(cfg.WORLD, [sys.executable, RANK, os.path.join(out, "spec.json")], seconds + MARGIN_S)
        ranks = rank_records(out, cfg.WORLD)
        r0 = ranks[0]
        pass_sums = [torch.from_numpy(np.load(os.path.join(out, f"pass{k}.npy"))) for k in range(r0["passes"])]
    units = r0["units"]
    ctx = Context(units=units, profiled=set(r0["profiled"]), trace=r0["trace"],
                  setup={"scene_build_s": r0["scene_build_s"]}, probes={"ranks": lambda: [r["units"] for r in ranks]})
    passes = len(pass_sums)
    rec = {"setup_s": r0["setup_s"], "window_s": r0["window_s"], "passes": passes,
           "memory_peak_bytes": max(r["memory_peak_bytes"] for r in ranks), "attempted": passes,
           "failed": sum(1 for t in pass_sums if not bool(torch.isfinite(t).all())),
           "e2e": {"Mpaths_s": width * height * pass_spp * passes / r0["window_s"] / 1e6, "setup_s": r0["setup_s"]},
           "per_layer": read_per_layer(cell, ctx) if trace else {}, "trace": ctx.trace}
    ms = load_module("metrics", "allreduce_ms.x4").read(ctx)
    rec["collective"] = None if ms is None else {"bytes": r0["sum_bytes"], "ms": ms,
                                                 "GB_s": r0["sum_bytes"] / ms / 1e6}
    rec["rank_strip_s"] = [[q["strip_s"] for q in pass_records(r["units"])] for r in ranks]
    rec["iterations"] = sum(u.get("pool", 0) + u.get("drain_n4", 0) + u.get("drain_n16", 0) for u in units)

    from reference import tracer as reference

    device = torch.device("cuda", 0) if device_type == "cuda" else torch.device("cpu")
    desc = cfg.describe(seed, **(describe_kw or {}))
    m = int(ref_spp or p["ref_spp"])
    t_ref = time.perf_counter()
    s, q = reference.render_sums(reference.Tables(desc, device), width, height, m, cfg.DEPTH, seed=seed)
    rec["reference_s"] = time.perf_counter() - t_ref
    rec["numbers"] = frame_numbers(pass_sums, pass_spp, passes * pass_spp, s, q, m, int(p["tile"]))
    rec["worst_tile"] = rec["numbers"].pop("_worst_tile", None)
    rec["numbers"]["samples_gap"] = float(abs(sum(r0["n"]) - passes * pass_spp))
    return rec


def run(cell, seed: int, seconds: float, trace: bool, t_start: float) -> int:
    from harness.result import report

    rec = measure(cell, seed, seconds, trace, t_start)
    notes = {k: rec[k] for k in ("passes", "window_s", "setup_s", "reference_s", "worst_tile", "iterations",
                                 "collective", "rank_strip_s")}
    return report(cell, rec, trace, dict(notes, seed=seed, world=cell.config.WORLD))
