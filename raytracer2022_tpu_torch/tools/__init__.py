"""Tools beside the package: :mod:`.bench` (``bench.py``'s cells),
:mod:`.perf` (per-scene throughput), :mod:`.scaling` (the sharded render
against one rank), :mod:`.flagship` (the reference's whole workload,
restart-safe), :mod:`.golden` (renders against the reference's committed
images) and :mod:`.standins` (generated stand-ins for the asset files the
repository does not hold)."""

from __future__ import annotations

import os
import subprocess


def device_line(device, indices=None) -> str:
    """What the numbers were measured on: for a card, nvidia-smi's name and
    power limit of each card in ``indices`` (default: ``device``'s); for
    the CPU, the host's core count."""
    import torch

    if device.type != "cuda":
        return f"cpu: {os.cpu_count()} host cores, torch {torch.__version__}"
    if indices is None:
        indices = [torch.cuda.current_device() if device.index is None else device.index]
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "-i", ",".join(str(i) for i in indices)],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()


def device_kind(device) -> str:
    """The device's name as ``torch.cuda.get_device_name`` gives it, or "cpu"."""
    import torch

    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"

