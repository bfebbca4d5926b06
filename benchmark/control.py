"""The control of a cell's comparison, run apart from the benchmark.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3 [--kind bf16] [--passes K]

The benchmark's own runs never run this.  It puts the plain reference in
the program's place, computed in the nearest precision below the one the
configuration states (``bf16``: bfloat16 for the configuration's float32),
at the cell's own size, and compares it with the float32 reference exactly
as a run compares the program: a frame cell renders ``--passes`` passes of
the workload's ``pass_spp`` (as many as a run's window holds), a fit cell
follows its first steps.  For a fit cell two faults of a training step can
stand in the program's place too: ``half`` (each step renders the top half
of the rows only and takes the mean over them) and ``altered`` (each
step's loss, and so every gradient, is scaled by 1.25 where it is
produced).  Prints one JSON line a seed with the numbers and the limits.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]


def frame_control(cell, seed: int, passes: int, device, dtype, frame=None, describe_kw=None, ref_spp=None) -> dict:
    from harness.compare import frame_numbers
    from reference import tracer as reference

    p, cfg = cell.params, cell.config
    width, height = frame or cfg.FRAME
    desc = cfg.describe(seed, **(describe_kw or {}))
    n = int(p["pass_spp"])
    low = reference.Tables(desc, device, dtype=dtype)
    sums = []
    for k in range(passes):
        s, _ = reference.render_sums(low, width, height, n, cfg.DEPTH, seed=seed * 31 + k + 5)
        sums.append(s.float().cpu())
    m = int(ref_spp or p["ref_spp"])
    s, q = reference.render_sums(reference.Tables(desc, device), width, height, m, cfg.DEPTH, seed=seed)
    out = frame_numbers(sums, n, passes * n, s, q, m, int(p["tile"]))
    out.pop("_worst_tile", None)
    return out


def fit_control(cell, seed: int, device, kind: str, fit=None) -> dict:
    import torch

    from harness.compare import fit_gaps
    from reference import fit as rfit

    p, cfg = cell.params, cell.config
    fit = dict(fit or cfg.FIT)
    w, h, spp = fit["width"], fit["height"], fit["spp"]
    lr = float(p["lr"])
    desc = cfg.describe(seed)
    target = torch.as_tensor(cfg.target(seed, w, h), device=device)
    steps = 3
    if kind == "bf16":
        prog = rfit.follow(desc, target, w, h, spp, cfg.DEPTH, lr, steps, seed=seed + 1, dtype=torch.bfloat16)
    else:
        prog = faulty_follow(desc, target, w, h, spp, cfg.DEPTH, lr, steps, seed + 1, kind)
    ref = rfit.follow(desc, target, w, h, spp, cfg.DEPTH, lr, steps, seed=seed + 2)
    out = fit_gaps({k: v if k == "losses" else {a: b.cpu() for a, b in v.items()} for k, v in prog.items()},
                   {k: v if k == "losses" else {a: b.cpu() for a, b in v.items()} for k, v in ref.items()})
    out.pop("_leaves")
    return out


def faulty_follow(desc, target, w, h, spp, depth, lr, steps, seed, kind):
    """``reference.fit.follow`` with a training step's fault planted."""
    from reference import fit as rfit

    leaves0 = rfit.initial_leaves(desc, target.device)
    leaves, losses, first = dict(leaves0), [], None
    for s in range(steps):
        if kind == "half":  # the top half of the rows, the mean over them
            hh = h // 2
            loss, g = rfit.loss_and_grads(desc, leaves, target, w, h, spp, depth, seed + 7919 * s,
                                          rows=(h - hh, h))
        elif kind == "altered":  # the loss scaled where it is produced
            loss, g = rfit.loss_and_grads(desc, leaves, target, w, h, spp, depth, seed + 7919 * s)
            loss, g = 1.25 * loss, {k: 1.25 * v for k, v in g.items()}
        else:
            raise ValueError(f"unknown fault {kind!r}")
        losses.append(loss)
        first = g if first is None else first
        leaves = {k: (v - lr * g[k]).detach() for k, v in leaves.items()}
    return {"losses": losses, "first_grad": first, "change": {k: leaves[k] - leaves0[k] for k in leaves0}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--kind", default="bf16", choices=("bf16", "half", "altered"))
    ap.add_argument("--passes", type=int, default=2, help="passes of a frame cell's run")
    args = ap.parse_args(argv)
    import torch

    from harness import cell as cells

    cell = cells.load(args.workload)
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        t0 = time.perf_counter()
        if cell.mode == "frame":
            numbers = frame_control(cell, seed, args.passes, device, torch.bfloat16)
        else:
            numbers = fit_control(cell, seed, device, args.kind)
        print(json.dumps({"workload": cell.name, "kind": args.kind, "seed": seed, "numbers": numbers,
                          "limits": cell.limits, "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
