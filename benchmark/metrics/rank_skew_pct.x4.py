"""``rank_skew_pct.x4``: how far the slowest rank's strips lag the others'.
For each pass, 100 x (the largest over ranks of the pass's strip seconds
over their mean over ranks - 1); the median over the window's passes.
Every rank's launch log is the probe ``ranks``; a pass ends at the
collective's record (``render_sharded_regen_sum``).  Only ranks whose
host ran no profiler count: in a traced run rank 0 runs it, and its
strips stay slower for the rest of the window, which would read as skew,
so there the skew is over the other ranks.  Nothing where the logs hold
no collective record.  Moves ``Mpaths_s``."""

import statistics

from harness.cell import load_module


def read(ctx):
    ranks = ctx.probe("ranks")
    if not ranks:
        return None
    sharded = load_module("modes", "sharded")
    per_rank = [sharded.pass_records(units) for units in (ranks[1:] if ctx.profiled else ranks)]
    n = len(per_rank[0]) if per_rank else 0
    if not n or any(len(p) != n for p in per_rank):
        return None
    skews = []
    for k in range(n):
        strips = [p[k]["strip_s"] for p in per_rank]
        skews.append(100.0 * (max(strips) * len(strips) / sum(strips) - 1.0))
    return statistics.median(skews)
