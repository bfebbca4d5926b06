"""``lane_occupancy_pct.frame``: the live lanes over the wavefront's lanes,
each summed over the regeneration iterations (phase A at full width, the
drains at N/4 and N/16), in the window's strip launches that ran without
the profiler, from the launch records in ``render_sum_n``'s launch log.
Nothing where the records lack the counts.  Moves ``Mpaths_s``."""


def read(ctx):
    units = [u for u in ctx.unprofiled() if "wavefront_lanes" in u]
    width = sum(u["wavefront_lanes"] for u in units)
    if not width:
        return None
    return 100.0 * sum(u["live_lanes"] for u in units) / width
