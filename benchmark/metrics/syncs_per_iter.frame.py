"""``syncs_per_iter.frame``: the host's counted syncs (``regen.sync``: the
live-count reads and the launch's closing wait) over the regeneration
iterations (phase A and both drains), in the window's strip launches that
ran without the profiler, from the launch records in ``render_sum_n``'s
launch log.  Nothing where the records lack the count.  Moves
``Mpaths_s``."""


def read(ctx):
    units = [u for u in ctx.unprofiled() if "syncs" in u and "pool" in u]
    iters = sum(u["pool"] + u["drain_n4"] + u["drain_n16"] for u in units)
    if not iters:
        return None
    return sum(u["syncs"] for u in units) / iters
