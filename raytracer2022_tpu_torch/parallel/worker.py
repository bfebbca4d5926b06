"""One rank of a multi-process run, and :func:`launch_local`, which starts
the ranks of one host.

Counterpart of ``tools/fake_cluster_worker.py`` and of
``__graft_entry__.py::dryrun_multichip``.  Usage::

    python -m raytracer2022_tpu_torch.parallel.worker --coordinator localhost:PORT \\
        --num-processes N --process-id K --device cuda --backend nccl \\
        --task regen --scene cornell_box --width 64 --height 64 --spp 16 --out x.npz

Each rank joins the group (:func:`.distributed.init_distributed`), builds
the scene and camera on its device (a name of ``scene.library.SCENES``,
or ``module:function``, a function that adds a scene to a
``SceneBuilder`` and returns its camera kwargs, on a black background),
warms up (one small render and one all_reduce), waits at a barrier, sets
K1's launch count to 0 and runs its task over the one-dimensional mesh:

- ``scan``: :func:`.mesh.render_sharded_sum`;
- ``regen``: :func:`.mesh.render_sharded_regen_sum`;
- ``fit``, ``fit_regen``: ``--steps`` steps of :func:`.mesh.fit_step_fn`
  toward a black target, step ``i`` with the seed ``i``;
  ``fit_regen`` renders with the regeneration integrator over
  ``regen_iters_estimate``'s trip count;
- ``dryrun``: the four steps of ``__graft_entry__.py::dryrun_multichip``
  (cornell_box, 16x16, ``spp = world``, depth 4) with their checks;
- ``scaling``: one rank of ``tools/scaling.py`` (:func:`scaling_share`).

Rank ``K`` writes ``x.rankK.npz`` (:func:`rank_path`): what it computed,
its K1 launches, and its wall seconds from the barrier to the end of the
task (the last collective included).  On the CPU a rank runs one
intra-op thread: the ranks share the host's cores.
"""

from __future__ import annotations

import argparse
import importlib
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time
import traceback
from typing import Optional

TASKS = ("scan", "regen", "fit", "fit_regen", "dryrun", "scaling")
SCALING_REPS = 3  # timed sharded renders of the scaling task, after one warm-up
SCALING_PROBE = (2, 16, 50)  # its iteration probe: lanes per pixel, samples per lane, depth
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
LOG_TAIL = 4000  # characters of each rank's log in a launch failure


def rank_path(out: str, rank: int) -> str:
    """The file rank ``rank`` writes for ``--out out``."""
    base, ext = os.path.splitext(out)
    return f"{base}.rank{rank}{ext or '.npz'}"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch_local(n: int, argv: list, timeout_s: Optional[float]) -> list:
    """Run ``n`` ranks of the command ``argv`` on this host and wait for
    all of them -> each rank's output (stdout and stderr).

    Rank ``k`` runs ``argv + ["--coordinator", "localhost:PORT",
    "--num-processes", n, "--process-id", k]`` on a free port, in a
    session of its own, with the repository on ``PYTHONPATH``.  When a
    rank exits non-zero, or ``timeout_s`` passes (None: no limit), every
    rank still running is killed with its children, and RuntimeError
    names each rank's exit code and the tail of its output."""
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (_REPO_ROOT, env.get("PYTHONPATH")) if p)
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    logs = [tempfile.TemporaryFile() for _ in range(n)]
    procs = []
    failed = None
    try:
        for k in range(n):
            cmd = [*map(str, argv), "--coordinator", f"localhost:{port}", "--num-processes", str(n),
                   "--process-id", str(k)]
            procs.append(subprocess.Popen(cmd, stdout=logs[k], stderr=subprocess.STDOUT, env=env,
                                          start_new_session=True))
        while True:
            codes = [p.poll() for p in procs]
            if any(c not in (None, 0) for c in codes):
                failed = "a rank failed"
                break
            if all(c == 0 for c in codes):
                break
            if deadline is not None and time.monotonic() > deadline:
                failed = f"timed out after {timeout_s} s"
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                try:
                    os.killpg(p.pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
                p.wait()
        out = []
        for f in logs:
            f.seek(0)
            out.append(f.read().decode(errors="replace"))
            f.close()
    if failed is not None:
        lines = [f"launch_local: {failed} ({n} ranks of {' '.join(map(str, argv))})"]
        for k, (p, log) in enumerate(zip(procs, out)):
            lines.append(f"--- rank {k}: exit code {p.returncode} (negative: killed by that signal)\n{log[-LOG_TAIL:]}")
        raise RuntimeError("\n".join(lines))
    return out


def build_scene(name: str, width: int, height: int, device):
    """``(scene, camera, background)`` of ``name`` on ``device``: a
    library scene, or ``module:function`` (see the module docstring).  The
    camera's aspect ratio is ``width / height``, as the CLI sets it."""
    from ..render.camera import make_camera
    from ..scene.builder import SceneBuilder
    from ..scene.library import SCENES

    if ":" in name:
        module, fn = name.split(":")
        b = SceneBuilder()
        cam_kw = getattr(importlib.import_module(module), fn)(b)
        scene, background = b.finalize(device=device), (0.0, 0.0, 0.0)
    else:
        bundle = SCENES[name](device=device)
        scene, cam_kw, background = bundle.scene, bundle.camera_kwargs, bundle.background
    camera = make_camera(**dict(cam_kw, aspect_ratio=width / height), device=device)
    return scene, camera, background


def _flat_params(scene, camera):
    import numpy as np

    from .mesh import CAMERA_LEAVES

    leaves = [scene.materials.param, scene.textures.color] + [getattr(camera, f) for f in CAMERA_LEAVES]
    return np.concatenate([x.detach().cpu().numpy().reshape(-1) for x in leaves])


def dryrun_multichip(mesh, device) -> dict:
    """``__graft_entry__.py::dryrun_multichip`` on ``mesh``: cornell_box at
    16x16, ``spp = world``, depth 4, through the sharded scan render, the
    sharded regeneration render, the sharded fit step through the
    regeneration integrator (``max_depth + 2`` iterations) and through the
    fixed-depth trace, with the same checks -> the results."""
    import torch

    from ..render.renderer import RenderConfig
    from .mesh import fit_step_fn, render_sharded_regen_sum, render_sharded_sum

    scene, cam, background = build_scene("cornell_box", 16, 16, device)
    cfg = RenderConfig(width=16, height=16, spp=mesh.size(), max_depth=4, background=background)

    img_sum = render_sharded_sum(scene, cam, cfg, mesh)
    assert img_sum.shape == (3, 16, 16)

    regen_sum, n_samples = render_sharded_regen_sum(scene, cam, cfg, mesh)
    assert regen_sum.shape == (3, 16, 16) and n_samples >= cfg.spp

    step = fit_step_fn(cfg, mesh=mesh, regen_iters=cfg.max_depth + 2)
    target = torch.zeros((3, 16, 16), device=device)
    scene2, cam2, loss = step(scene, cam, target, 0)
    assert torch.isfinite(loss)

    step_scan = fit_step_fn(cfg, mesh=mesh)
    scene3, cam3, loss2 = step_scan(scene, cam, target, 1)
    assert torch.isfinite(loss2)
    return {"scan_sum": img_sum.cpu().numpy(), "regen_sum": regen_sum.cpu().numpy(), "n": n_samples,
            "loss": [float(loss), float(loss2)], "params_regen": _flat_params(scene2, cam2),
            "params_scan": _flat_params(scene3, cam3)}


def scaling_share(scene, cam, cfg, mesh, device) -> dict:
    """One rank of ``tools/scaling.py``: after a warm-up, ``SCALING_REPS``
    renders through :func:`.mesh.render_sharded_regen_sum` (render ``i``
    with the seed ``i``), each timed from a barrier to after its
    all_reduce; then this rank's regeneration iterations at
    ``SCALING_PROBE``, drawn from ``step_generator(derive_seed(cfg.seed,
    rank), 0)``, gathered from every rank in rank order."""
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist

    from ..render.integrator import derive_seed, step_generator
    from ..render.renderer import render_batch_regen
    from ..utils.device import synchronize
    from .mesh import render_sharded_regen_sum

    rank, world, group = mesh.get_local_rank(), mesh.size(), mesh.get_group()
    render_sharded_regen_sum(scene, cam, cfg, mesh)
    seconds = []
    for i in range(SCALING_REPS):
        synchronize(device)
        dist.barrier(group=group)
        t0 = time.perf_counter()
        render_sharded_regen_sum(scene, cam, dataclasses.replace(cfg, seed=i), mesh)
        synchronize(device)
        seconds.append(time.perf_counter() - t0)
    spp_par, spp_seq, depth = SCALING_PROBE
    _, iters = render_batch_regen(
        scene, cam, step_generator(derive_seed(cfg.seed, rank), 0, device), cfg.width, cfg.height, spp_par,
        spp_seq, dataclasses.replace(cfg, max_depth=depth).trace_cfg(), return_iters=True,
    )
    mine = torch.tensor([sum(iters.values())], dtype=torch.int64, device=device)
    every = [torch.zeros_like(mine) for _ in range(world)]
    dist.all_gather(every, mine, group=group)
    return {"sharded_seconds": np.array(seconds), "regen_iters": torch.cat(every).cpu().numpy()}


def run_task(args, mesh, device) -> dict:
    """Run ``args.task`` on ``mesh`` -> the arrays its rank file holds."""
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist

    from ..ops import bvh8
    from ..render.renderer import RenderConfig, regen_iters_estimate
    from ..utils.device import synchronize
    from .mesh import (
        fit_regen_split, fit_step_fn, render_regen_shard, render_sharded_regen_sum, render_sharded_sum,
    )

    rank, world = mesh.get_local_rank(), mesh.size()
    out = {}
    if args.task != "dryrun":
        scene, cam, background = build_scene(args.scene, args.width, args.height, device)
        cfg = RenderConfig(width=args.width, height=args.height, spp=args.spp, max_depth=args.depth,
                           background=background, max_rays_per_batch=args.max_rays)
        # warm-up: loads the kernels and sets up the communicator
        render_regen_shard(scene, cam, dataclasses.replace(cfg, width=8, height=8, spp=1), rank, world)
        dist.all_reduce(torch.zeros(1, device=device), group=mesh.get_group())
    if args.task == "fit_regen":
        spp_par, spp_seq = fit_regen_split(args.spp // world)
        out["regen_iters"] = regen_iters_estimate(scene, cam, args.width, args.height, spp_par, spp_seq,
                                                  cfg.trace_cfg())
    synchronize(device)
    dist.barrier(group=mesh.get_group())
    bvh8.LAUNCHES = 0
    t0 = time.perf_counter()
    if args.task == "dryrun":
        out.update(dryrun_multichip(mesh, device))
    elif args.task == "scaling":
        out.update(scaling_share(scene, cam, cfg, mesh, device))
    elif args.task in ("scan", "regen"):
        if args.task == "scan":
            total, n = render_sharded_sum(scene, cam, cfg, mesh), cfg.spp
        else:
            log: list = []
            total, n = render_sharded_regen_sum(scene, cam, cfg, mesh, launch_log=log)
            strips = [rec for rec in log if "collective" not in rec]
            out["iters"] = np.array([[rec["pool"], rec["drain_n4"], rec["drain_n16"]] for rec in strips])
            out["strip_seconds"] = np.array([rec["seconds"] for rec in strips])
        out.update(sum=total.cpu().numpy(), n=n)
    else:
        step = fit_step_fn(cfg, mesh=mesh, lr=args.lr, regen_iters=out.get("regen_iters"))
        target = torch.zeros((3, args.height, args.width), device=device)
        losses, params, seconds = [], [], []
        for i in range(args.steps):
            t_step = time.perf_counter()
            scene, cam, loss = step(scene, cam, target, i)
            synchronize(device)
            seconds.append(time.perf_counter() - t_step)
            losses.append(float(loss))
            params.append(_flat_params(scene, cam))
        out.update(loss=np.array(losses), params=np.stack(params), step_seconds=np.array(seconds))
    synchronize(device)
    out.update(seconds=time.perf_counter() - t0, k1_launches=bvh8.LAUNCHES, rank=rank, world=world,
               device=str(device), backend=dist.get_backend())
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="One rank of a multi-process render or fit step")
    ap.add_argument("--coordinator", required=True, help="host:port of rank 0")
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--device", default="cuda", help="cuda (rank k on card k %% count), cuda:N, or cpu")
    ap.add_argument("--backend", default=None, help="gloo or nccl (default: nccl on cards, gloo on the CPU)")
    ap.add_argument("--task", required=True, choices=TASKS)
    ap.add_argument("--out", required=True, help="x.npz: rank K writes x.rankK.npz")
    ap.add_argument("--scene", default="cornell_box", help="library scene name or module:function")
    ap.add_argument("--width", type=int, default=16)
    ap.add_argument("--height", type=int, default=16)
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--max-rays", type=int, default=1 << 18, help="lanes per launch (RenderConfig.max_rays_per_batch)")
    ap.add_argument("--steps", type=int, default=1)
    ap.add_argument("--lr", type=float, default=0.05)
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    import torch.distributed as dist

    from .distributed import init_distributed, rank_device
    from .mesh import make_device_mesh

    device = rank_device(args.device, args.process_id)
    if device.type == "cpu":
        torch.set_num_threads(1)
    init_distributed(args.coordinator, args.num_processes, args.process_id, backend=args.backend, device=device)
    mesh = make_device_mesh(device.type)
    out = run_task(args, mesh, device)
    path = rank_path(args.out, args.process_id)
    tmp = f"{path}.tmp.npz"
    np.savez(tmp, **out)
    os.replace(tmp, path)
    print(f"rank {args.process_id}/{args.num_processes} on {device} ({out['backend']}): task {args.task} "
          f"done in {out['seconds']:.3f} s, K1 launches {out['k1_launches']}", flush=True)
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
