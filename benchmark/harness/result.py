"""The run's result: the card it ran on, the numbers compared beside
their limits, and the one JSON line the benchmark prints last."""

from __future__ import annotations

import json
import math
import subprocess
import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "raytracer2022_tpu")  # top-level module names a run may not hold


def forbidden_modules() -> list:
    """Modules in ``sys.modules`` whose top-level name (the part before the
    first dot) is one of ``FORBIDDEN``, compared whole."""
    return sorted(name for name in list(sys.modules) if name.split(".")[0] in FORBIDDEN)


def power_limit_w(index: int = 0):
    """The card's power limit from nvidia-smi, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits",
                              "-i", str(index)], capture_output=True, text=True, timeout=60)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def device_record(count: int, memory_peak_bytes: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": int(memory_peak_bytes), "power_limit_w": power_limit_w(0)}


def judge(numbers: dict, limits: dict) -> tuple:
    """-> (correct, {name: {"value", "limit"}}); a number passes when it is
    finite and at most its limit."""
    checks = {k: {"value": float(v), "limit": float(limits[k])} for k, v in numbers.items() if k in limits}
    missing = [k for k in limits if k not in numbers]
    ok = not missing and all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks


def emit(correct: bool, attempted: int, failed: int, metrics: dict, device: dict, checks: dict,
         breakdown=None, notes=None) -> int:
    """Print the checks on standard error and the result line on standard
    output (last), or, where a forbidden module was loaded, name it and
    print no result -> the exit code."""
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {', '.join(bad)}; no result", file=sys.stderr, flush=True)
        return 3
    if notes:
        print(json.dumps({"notes": notes}), flush=True)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr, flush=True)
    line = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed), "metrics": metrics,
            "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = checks
    print(json.dumps(line), flush=True)
    return 0


def report(cell, rec: dict, trace: bool, notes: dict) -> int:
    """Judge a mode's record (``numbers``, ``e2e``, ``per_layer``,
    ``trace``, ``attempted``, ``failed``, ``memory_peak_bytes``) against the
    cell's limits and print it (:func:`emit`) -> the exit code.  A traced
    run reports the per-layer metrics, its device's busy and window
    seconds, and in the notes its end-to-end numbers, which the profiler
    slows."""
    from harness import trace as tracing

    correct, checks = judge(rec["numbers"], cell.limits)
    if trace:
        names = {m["name"] for m in cell.per_layer}
        metrics = {k: v for k, v in rec["per_layer"].items() if k in names}
    else:
        metrics = {m["name"]: {"value": rec["e2e"][m["name"]], "unit": m["unit"]} for m in cell.end_to_end}
    device = device_record(cell.chips, rec["memory_peak_bytes"])
    tr = rec["trace"] if trace else None
    if tr is not None:
        device.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        notes.update(trace_units=tr["units"], trace_reduce_s=tr["reduce_s"], e2e_traced=rec["e2e"])
    return emit(correct, rec["attempted"], rec["failed"], metrics, device, checks,
                breakdown=tracing.breakdown(tr) if trace else None, notes=notes)
