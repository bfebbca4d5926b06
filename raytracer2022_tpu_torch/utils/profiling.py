"""Profiling hooks: an optional ``torch.profiler`` trace around a render
(wired to ``--trace-dir`` in the CLI), in place of the JAX package's
``xla_trace``, the named spans of the render loop, and the host-side
record of one launch.

A launch whose caller passed a ``launch_log`` runs inside
:func:`launch_record`.  While that record is open, every :func:`span`
adds its host self time (its duration less its child spans, the sync
waits among them) and its entries to the record; :func:`host_sync`, the one door
of the render path's deliberate device-to-host reads, counts the reads
and the seconds the host was blocked in them; and :func:`count_lanes`
sums the live lanes and the wavefront's width over the iterations.  The
launch's log entry carries the sums.  Under a profiler every span is also
a ``record_function`` of the same name, so a device trace and the record
name the same host activities.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import time
from collections import Counter
from typing import Optional

import torch
from torch.profiler import record_function

_NO_SPAN = contextlib.nullcontext()
SYNC = "regen.sync"  # the span of every counted sync

_OPEN: contextvars.ContextVar[Optional["LaunchRecord"]] = contextvars.ContextVar("launch_record", default=None)


class LaunchRecord:
    """The host's account of one launch: self seconds and entries by span
    name, counted syncs and their wait, and lane occupancy sums."""

    def __init__(self):
        self.self_s: Counter = Counter()
        self.calls: Counter = Counter()
        self.syncs = 0
        self.sync_wait_s = 0.0
        self.live_lanes = 0
        self.wavefront_lanes = 0
        self.stack: list = []  # the open spans, innermost last

    def fields(self) -> dict:
        """The entries a launch's log entry gains."""
        return {"span_self_s": dict(self.self_s), "span_calls": dict(self.calls), "syncs": self.syncs,
                "sync_wait_s": self.sync_wait_s, "live_lanes": self.live_lanes,
                "wavefront_lanes": self.wavefront_lanes}


class _Span:
    """A span while a record is open: host clock around the body, the
    duration of its children taken off its own."""

    __slots__ = ("rec", "name", "rf", "t0", "inner")

    def __init__(self, rec: LaunchRecord, name: str, rf):
        self.rec, self.name, self.rf = rec, name, rf

    def __enter__(self):
        if self.rf is not None:
            self.rf.__enter__()
        self.rec.stack.append(self)
        self.inner = 0.0
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        rec = self.rec
        rec.stack.pop()
        if self.name == SYNC:
            rec.syncs += 1
            rec.sync_wait_s += dt
        else:
            rec.self_s[self.name] += dt - self.inner
        rec.calls[self.name] += 1
        if rec.stack:
            rec.stack[-1].inner += dt
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def span(name: str):
    """A ``record_function`` span named ``name`` while a profiler runs, and
    while a launch record is open a host-clock span that feeds it; the
    shared no-op otherwise: the render loop is bound by host dispatch, and
    an entered span is an operator call even with no profiler attached."""
    rec = _OPEN.get()
    rf = record_function(name) if torch.autograd._profiler_enabled() else None
    if rec is None:
        return _NO_SPAN if rf is None else rf
    return _Span(rec, name, rf)


def host_sync(read, *args):
    """``read(*args)``, a deliberate device-to-host read (a count for the
    host's loop, or the wait for the device's queue), inside a ``regen.sync``
    span: an open record counts it and the seconds the host was blocked.
    Pass the operands already computed, so that the span holds the wait
    and not their dispatch."""
    with span(SYNC):
        return read(*args)


def count_lanes(live: int, width: int) -> None:
    """Add one iteration's live lanes and wavefront width, counts the host
    already holds, to the open record (nothing without one)."""
    rec = _OPEN.get()
    if rec is not None:
        rec.live_lanes += live
        rec.wavefront_lanes += width


@contextlib.contextmanager
def launch_record(launch_log: Optional[list], device):
    """Around one launch: without ``launch_log`` nothing.  With it, a
    :class:`LaunchRecord` is open while the body runs; at the end the host
    waits for ``device`` (a counted sync on CUDA) and ``launch_log``
    receives the keys the body put in the yielded dict, the wall
    ``seconds`` since entry, and the record's keys."""
    entry: dict = {}
    if launch_log is None:
        yield entry
        return
    rec = LaunchRecord()
    token = _OPEN.set(rec)
    t0 = time.perf_counter()
    try:
        yield entry
        if device.type == "cuda":
            host_sync(torch.cuda.synchronize, device)
    finally:
        _OPEN.reset(token)
    launch_log.append({**entry, "seconds": time.perf_counter() - t0, **rec.fields()})


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
