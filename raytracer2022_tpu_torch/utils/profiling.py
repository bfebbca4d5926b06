"""Profiling hook: an optional ``torch.profiler`` trace around a render
(wired to ``--trace-dir`` in the CLI), in place of the JAX package's
``xla_trace``."""

from __future__ import annotations

import contextlib
import os


@contextlib.contextmanager
def torch_trace(logdir: str | None):
    """Capture CPU and CUDA activity into ``logdir/trace.json`` (a Chrome
    trace) and ``logdir/kernels.txt`` (time by kernel) when ``logdir`` is set."""
    if not logdir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    sort_by = "self_cpu_time_total"
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
        sort_by = "self_device_time_total"
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    with open(os.path.join(logdir, "kernels.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by=sort_by, row_limit=40))
