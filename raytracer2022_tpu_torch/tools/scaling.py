"""The sharded regeneration render over N ranks against one rank.

Counterpart of ``tools/scaling.py``.  Usage::

    python -m raytracer2022_tpu_torch.tools.scaling N [--device cuda] [--size 64]

Measures, as the JAX tool does, on ``cornell_box`` at ``size`` x ``size``
(64 by default), ``spp = 16 * N``, depth 8:

- ``t_single_s``: one process renders the whole workload with
  ``render_batch_regen``, 2 lanes per pixel x ``8 * N`` samples, on card 0
  (or the CPU with one thread, a rank's share of the host); the median of
  3 calls after a warm-up, call ``i`` drawing from ``step_generator(0,
  i)``;
- ``t_sharded_s``: the same ``RenderConfig`` through
  ``render_sharded_regen_sum`` over N ranks of ``parallel/worker.py``
  (task ``scaling``) started by ``launch_local``: one rank per card over
  NCCL, or N one-thread ranks on the CPU over gloo.  Rank 0's wall from a
  barrier to after the all_reduce, the median of 3 seeds after a warm-up;
- ``per_device_regen_iters``: each rank's regeneration iterations at depth
  50, 2 lanes x 16 samples, from ``step_generator(derive_seed(0, rank),
  0)``, gathered from the ranks; ``work_normalized_efficiency`` is their
  mean over their max (the slowest rank sets the wall).

``parallel_efficiency`` is ``speedup / N`` on cards, where N ranks are N
devices, and ``speedup / min(N, host_cores)`` on the CPU, where the ranks
share the host's cores as the JAX tool's virtual devices do;
``parallel_efficiency_divisor`` says which ran.  Prints nvidia-smi's name
and power limit of the cards used (the host's core count on the CPU), then
one JSON line with the JAX tool's keys, unrounded, and ``device`` and
``backend`` beside them.  ``--device`` defaults to the card and raises
without N cards; nothing falls back to the CPU unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

SCENE = "cornell_box"
SPP_PER_RANK = 16
DEPTH = 8
SPP_PAR = 2  # lanes per pixel of the one-process render
REPS = 3
TIMEOUT_S = 600.0  # what the ranks may take together


def t_single(size: int, spp: int, device) -> float:
    """Median seconds of the one-process render (see the module docstring)."""
    import torch

    from ..parallel.worker import build_scene
    from ..render.integrator import step_generator
    from ..render.renderer import RenderConfig, render_batch_regen
    from ..utils.device import synchronize

    scene, cam, background = build_scene(SCENE, size, size, device)
    tcfg = RenderConfig(width=size, height=size, spp=spp, max_depth=DEPTH, background=background).trace_cfg()
    threads = torch.get_num_threads()
    if device.type == "cpu":
        torch.set_num_threads(1)
    try:
        times = []
        for i in range(REPS + 1):  # the first is the warm-up
            t0 = time.perf_counter()
            with torch.no_grad():
                render_batch_regen(scene, cam, step_generator(0, i, device), size, size, SPP_PAR,
                                   spp // SPP_PAR, tcfg)
            synchronize(device)
            times.append(time.perf_counter() - t0)
    finally:
        torch.set_num_threads(threads)
    return sorted(times[1:])[REPS // 2]


def sharded(world: int, size: int, spp: int, device) -> dict:
    """Rank 0's record of ``world`` ranks of the worker's scaling task."""
    import numpy as np

    from ..parallel.worker import launch_local, rank_path

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "scaling.npz")
        launch_local(world, [sys.executable, "-m", "raytracer2022_tpu_torch.parallel.worker", "--device",
                             device.type, "--task", "scaling", "--scene", SCENE, "--width", size, "--height", size,
                             "--spp", spp, "--depth", DEPTH, "--out", out], TIMEOUT_S)
        with np.load(rank_path(out, 0)) as f:
            return {key: f[key] for key in f.files}


def main(argv=None) -> int:
    import numpy as np
    import torch

    from ..utils.device import resolve_device
    from . import device_kind, device_line

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("world", type=int, nargs="?", default=2, help="ranks N")
    ap.add_argument("--device", default="cuda", help="cuda (one rank per card) or cpu")
    ap.add_argument("--size", type=int, default=64, help="image width and height")
    args = ap.parse_args(argv)

    n = args.world
    device = resolve_device(args.device)
    cores = os.cpu_count() or 1
    if device.type == "cuda":
        cards = torch.cuda.device_count()
        if cards < n:
            raise RuntimeError(f"scaling over {n} ranks needs {n} cards, one rank a card (NCCL refuses two "
                               f"ranks on one card); {cards} visible")
        device, divisor = torch.device("cuda", 0), n
        print(device_line(device, range(n)), flush=True)
    else:
        divisor = min(n, cores)
        print(device_line(device), flush=True)
    spp = SPP_PER_RANK * n
    single = t_single(args.size, spp, device)
    rank0 = sharded(n, args.size, spp, device)
    t_sharded = float(np.median(rank0["sharded_seconds"]))
    iters = [int(x) for x in rank0["regen_iters"]]
    speedup = single / t_sharded
    mean_it = sum(iters) / n
    print(json.dumps({
        "n_devices": n,
        "host_cores": cores,
        "device": device_kind(device),
        "backend": str(rank0["backend"]),
        "t_single_s": single,
        "t_sharded_s": t_sharded,
        "speedup_sharded_vs_single": speedup,
        "parallel_efficiency": speedup / divisor,
        "parallel_efficiency_divisor": divisor,
        "per_device_regen_iters": iters,
        "iters_mean": mean_it,
        "iters_max": max(iters),
        "work_normalized_efficiency": mean_it / max(iters),
    }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
