"""``scheduler_host_pct.frame``: the host's self seconds in the
scheduler's spans (``regen.*``: lane update and reservation, ray
generation, ray sort, the drains' compaction and scatter-back, the strip's
accumulation), sync waits excluded, over the launches' wall seconds, in
the window's strip launches that ran without the profiler, from the
launch records in ``render_sum_n``'s launch log.  Nothing where the
records lack the spans' times.  Moves ``Mpaths_s``."""


def read(ctx):
    units = [u for u in ctx.unprofiled() if "span_self_s" in u]
    seconds = sum(u["seconds"] for u in units)
    if seconds <= 0:
        return None
    own = sum(s for u in units for name, s in u["span_self_s"].items() if name.startswith("regen."))
    return 100.0 * own / seconds
