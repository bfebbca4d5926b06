"""One rank of mode ``sharded`` (``modes/sharded.py``, which starts
``WORLD`` of them through the program's ``launch_local``; not a mode):

    python3 benchmark/modes/sharded_rank.py SPEC --coordinator HOST:PORT --num-processes N --process-id K

``SPEC`` is the run's JSON (cell and its parameters, seed, window, trace, the parent's start
on this host's monotonic clock, device, frame, the description's options,
a planted fault, the output folder).  The rank writes ``rank<K>.json``
there: its launch log (strip records, then the collective's, a pass after
a pass), its sample count a pass, the sum's bytes, its peak memory and
scene compile; rank 0 adds the window, its set-up, its profiled units,
the trace summary and each pass's all-reduced sum (``pass<k>.npy``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
sys.path[:0] = [BENCH, os.path.dirname(BENCH)]


def leave_share_out(mesh_module, rank: int) -> None:
    """The fault ``rank_left_out``: rank ``rank`` renders its share and
    adds zeros to the sum in its place, its samples still counted."""
    import torch

    render = mesh_module.render_regen_shard

    def zeroed(scene, camera, cfg, r, world, launch_log=None):
        total, n = render(scene, camera, cfg, r, world, launch_log=launch_log)
        return (torch.zeros_like(total) if r == rank else total), n

    mesh_module.render_regen_shard = zeroed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="One rank of the benchmark's mode sharded")
    ap.add_argument("spec")
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    args = ap.parse_args(argv)
    with open(args.spec) as f:
        spec = json.load(f)

    import numpy as np
    import torch
    import torch.distributed as dist

    from harness import cell as cells
    from harness import trace as tracing
    from harness.scene import build_port_scene
    from raytracer2022_tpu_torch import RenderConfig
    from raytracer2022_tpu_torch.parallel import mesh as pmesh
    from raytracer2022_tpu_torch.parallel.distributed import init_distributed, rank_device
    from raytracer2022_tpu_torch.render.integrator import step_generator
    from raytracer2022_tpu_torch.render.renderer import render_batch_regen

    frame_mode = cells.load_module("modes", "frame")
    cfg = cells.load(spec["workload"]).config
    p = spec["params"]
    rank, world = args.process_id, args.num_processes
    seed, seconds = int(spec["seed"]), float(spec["seconds"])
    width, height = spec["frame"]
    pass_spp = int(p["pass_spp"])
    device = rank_device(spec["device"], rank)
    if device.type == "cpu":
        torch.set_num_threads(1)  # the ranks share the host's cores
    init_distributed(args.coordinator, world, rank, backend=cfg.BACKEND if device.type == "cuda" else "gloo",
                     device=device)
    mesh = pmesh.make_device_mesh(device.type)
    group = mesh.get_group()
    if spec["fault"] == "rank_left_out":
        leave_share_out(pmesh, world - 1)

    desc = cfg.describe(seed, **spec["describe_kw"])
    scene, cam, build_s = build_port_scene(desc, device)

    def rcfg(s):
        return RenderConfig(width=width, height=height, spp=pass_spp, max_depth=cfg.DEPTH,
                            background=tuple(desc["background"]), seed=s)

    base = rcfg(0)
    spp_par, _, rows = pmesh.regen_split(base, world)
    with torch.no_grad():
        render_batch_regen(scene, cam, step_generator(seed, 1 << 40, device), width, height, spp_par, 2,
                           base.trace_cfg(), row0=0, rows=rows)
        dist.all_reduce(torch.zeros((3, height, width), device=device), group=group)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dist.barrier(group=group)

    tracer = tracing.Tracer(bool(spec["trace"]) and rank == 0, int(p.get("trace_every", 4)),
                            int(p.get("trace_limit", 4)))
    log = frame_mode.UnitLog(tracer)
    min_units = int(p.get("min_units", 1))
    go = torch.ones(1, dtype=torch.int32, device=device)
    sums, ns = [], []
    t0 = time.perf_counter()
    tracer.boundary()
    while True:
        ts = time.perf_counter()
        with torch.no_grad():
            total, n = pmesh.render_sharded_regen_sum(scene, cam, rcfg(frame_mode.pass_seed(seed, len(ns))), mesh,
                                                      launch_log=log)
        if rank == 0:
            sums.append(total.float().cpu())
        ns.append(int(n))
        now = time.perf_counter()
        if rank == 0:
            t_end = now
            go.fill_(0 if len(ns) >= min_units and now - t0 + (now - ts) > seconds else 1)
        dist.broadcast(go, src=0, group=group)
        if not int(go.item()):
            break
    tracer.close()
    out = spec["out"]
    units = list(log)
    rec = {"rank": rank, "units": units, "n": ns, "scene_build_s": build_s,
           "sum_bytes": total.numel() * total.element_size(),
           "memory_peak_bytes": torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0}
    if rank == 0:
        for k, s in enumerate(sums):
            np.save(os.path.join(out, f"pass{k}.npy"), s.numpy())
        rec.update(passes=len(sums), window_s=t_end - t0, setup_s=t0 - float(spec["t_start"]),
                   profiled=sorted(tracer.profiled), trace=tracer.summary())
    tmp = os.path.join(out, f"rank{rank}.json.tmp")
    with open(tmp, "w") as f:
        json.dump(rec, f)
    os.replace(tmp, os.path.join(out, f"rank{rank}.json"))
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:
        # exit at once: a rank that failed must not wait on its peers at exit
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
    raise SystemExit(code)
