"""``vertex_host_pct.frame``: the host's self seconds in the path vertex's
spans (``vertex.*``, ``closest_hit.*``) over the launches' wall seconds, in
the window's strip launches that ran without the profiler, from the launch
records in ``render_sum_n``'s launch log.  Nothing where the records lack
the spans' times.  Moves ``Mpaths_s``."""

PREFIXES = ("vertex.", "closest_hit.")


def read(ctx):
    units = [u for u in ctx.unprofiled() if "span_self_s" in u]
    seconds = sum(u["seconds"] for u in units)
    if seconds <= 0:
        return None
    own = sum(s for u in units for name, s in u["span_self_s"].items() if name.startswith(PREFIXES))
    return 100.0 * own / seconds
