"""``allreduce_ms.x4``: milliseconds of the collective a pass.  For each
pass, the least over ranks of the collective record's seconds
(``render_sharded_regen_sum``'s launch log, from the call to the
collective's end, synchronised): the last rank to arrive waits for the
transfer alone, the others for it too.  The median over the window's
passes, less those in which a unit of rank 0 ran under the profiler.
Every rank's launch log is the probe ``ranks``.  Nothing where the logs
hold no collective record.  Moves ``Mpaths_s``."""

import statistics

from harness.cell import load_module


def read(ctx):
    ranks = ctx.probe("ranks")
    if not ranks:
        return None
    sharded = load_module("modes", "sharded")
    per_rank = [sharded.pass_records(units) for units in ranks]
    marks = sharded.pass_records(ctx.units, ctx.profiled)
    if not marks or any(len(p) != len(marks) for p in per_rank):
        return None
    least = [min(p[k]["collective_s"] for p in per_rank) for k, mark in enumerate(marks) if not mark["profiled"]]
    return 1e3 * statistics.median(least) if least else None
