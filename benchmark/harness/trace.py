"""The traced run's device timeline: ``torch.profiler`` over some units
of the window, reduced in memory to the numbers the per-layer metrics
read.

A unit is what the mode times as one piece of work (a strip launch of a
frame, a step of a fit).  Every ``every``-th unit from the second (the
first follows the warm-up), at most ``limit`` of them, runs under its own
profiler; the rest run as in an untraced run, and
the readers that time units read those.  The mode calls
:meth:`Tracer.boundary` at the window's start and after each unit, each
time after the device has finished its queue, so a profiled segment holds
exactly one unit's work.

Of each segment it keeps: the wall seconds, the union of the device's
activity intervals (busy seconds), the device seconds of each kernel name,
the device seconds of the kernels launched inside each named span of the
program (``vertex.closest_hit``, ...: a kernel counts for the span its
launching operator started in), and the device's idle gaps, named by the
innermost span the host was in.  No trace file is written.
"""

from __future__ import annotations

import bisect
import collections
import time

SPANS = ("vertex.closest_hit", "vertex.shading", "vertex.sampling", "closest_hit.dense",
         "closest_hit.packet_tree", "closest_hit.cluster_walk", "closest_hit.media", "closest_hit.hit_details")


class Tracer:
    def __init__(self, enabled: bool, every: int = 4, limit: int = 4):
        self.enabled = enabled
        self.every, self.limit = max(1, every), limit
        self.unit = -1  # index of the unit now running
        self.prof = None
        self.t0 = 0.0
        self.profiled = set()
        self.segments = []
        self.reduce_s = 0.0

    def boundary(self) -> None:
        """End the unit that ran (reducing its profile) and start the next."""
        if self.prof is not None:
            wall = time.perf_counter() - self.t0
            self.prof.__exit__(None, None, None)
            t = time.perf_counter()
            self.segments.append(reduce_profile(self.prof, wall))
            self.reduce_s += time.perf_counter() - t
            self.prof = None
        self.unit += 1
        if self.enabled and len(self.profiled) < self.limit and self.unit % self.every == 1 % self.every:
            from torch.profiler import ProfilerActivity, profile

            self.profiled.add(self.unit)
            self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self.prof.__enter__()
            self.t0 = time.perf_counter()

    def close(self) -> None:
        if self.prof is not None:
            self.prof.__exit__(None, None, None)
            self.prof = None
            self.profiled.discard(self.unit)

    def summary(self):
        """The segments together, or None where nothing was profiled."""
        if not self.segments:
            return None
        out = {"window_s": 0.0, "busy_s": 0.0, "kernels": collections.Counter(), "spans": collections.Counter(),
               "gaps": collections.Counter(), "units": sorted(self.profiled), "reduce_s": self.reduce_s}
        for s in self.segments:
            out["window_s"] += s["window_s"]
            out["busy_s"] += s["busy_s"]
            for key in ("kernels", "spans", "gaps"):
                out[key].update(s[key])
        return out


def reduce_profile(prof, wall_s: float) -> dict:
    """One segment's numbers (seconds) from a finished profiler, read from
    its raw events (no event tree is built)."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    cpu, dev = [], []
    for e in events:
        (cpu if e.device_type() == DeviceType.CPU else dev).append(e)
    annotations = {e.name() for e in cpu if e.is_user_annotation()}
    # the device's own work: kernels, copies and sets, not the ranges the
    # profiler draws on the device for the host's annotations
    dev = [e for e in dev if not e.is_user_annotation() and e.name() not in annotations]
    intervals = sorted((e.start_ns(), e.end_ns()) for e in dev)
    merged = []
    for a, b in intervals:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged)
    kernels = collections.Counter()
    for e in dev:
        kernels[e.name()] += (e.end_ns() - e.start_ns()) / 1e9
    # kernels by the span their launching operator (or innermost annotation)
    # started in
    op_start = {e.correlation_id(): e.start_ns() for e in cpu if e.linked_correlation_id() == 0}
    spans = collections.Counter()
    for name in SPANS:
        iv = sorted((e.start_ns(), e.end_ns()) for e in cpu if e.name() == name)
        if not iv:
            continue
        starts = [a for a, _ in iv]
        for e in dev:
            t = op_start.get(e.linked_correlation_id())
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= iv[i][1]:
                spans[name] += (e.end_ns() - e.start_ns()) / 1e9
    # the device's idle gaps, named by the innermost span the host was in at
    # their middle, else "outside the spans"
    span_iv = sorted((e.start_ns(), e.end_ns(), e.name()) for e in cpu if e.name() in SPANS)
    starts = [a for a, _, _ in span_iv]
    gaps = collections.Counter()
    for (_, b), (a2, _) in zip(merged, merged[1:]):
        mid = 0.5 * (b + a2)
        i = bisect.bisect_right(starts, mid) - 1
        label = "outside the spans"
        for j in range(i, max(i - 8, -1), -1):
            if span_iv[j][1] >= mid:
                label = span_iv[j][2]
                break
        gaps[label] += (a2 - b) / 1e9
    return {"window_s": wall_s, "busy_s": busy / 1e9, "kernels": kernels, "spans": spans, "gaps": gaps}


def breakdown(summary) -> dict:
    """The result line's ``breakdown``: the ten device operations that took
    most time and the ten host activities with the most idle device time."""
    if summary is None:
        return None
    return {"device_ops": [[k[:160], v] for k, v in summary["kernels"].most_common(10)],
            "idle_gaps": [[k, v] for k, v in summary["gaps"].most_common(10)]}
