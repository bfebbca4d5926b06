"""Profiling hooks: an optional ``torch.profiler`` trace around a render
(wired to ``--trace-dir`` in the CLI), in place of the JAX package's
``xla_trace``, and the named spans of the render loop."""

from __future__ import annotations

import contextlib
import os

import torch
from torch.profiler import record_function

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A ``record_function`` span named ``name`` while a profiler runs, and
    a no-op otherwise: the render loop is bound by host dispatch, and an
    entered span is an operator call even with no profiler attached."""
    if torch.autograd._profiler_enabled():
        return record_function(name)
    return _NO_SPAN


@contextlib.contextmanager
def torch_trace(logdir: str | None):
    """Capture CPU and CUDA activity into ``logdir/trace.json`` (a Chrome
    trace) and ``logdir/kernels.txt`` (time by kernel) when ``logdir`` is set."""
    if not logdir:
        yield None
        return
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
