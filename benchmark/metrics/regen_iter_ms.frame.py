"""``regen_iter_ms.frame``: milliseconds of wall time a regeneration
iteration, over the window's strip launches that ran without the profiler:
their seconds over their iterations (phase A and both drains) from
``render_sum_n``'s launch log.  Moves ``Mpaths_s``."""


def read(ctx):
    units = [u for u in ctx.unprofiled() if "pool" in u]
    iters = sum(u["pool"] + u["drain_n4"] + u["drain_n16"] for u in units)
    if not iters:
        return None
    return 1e3 * sum(u["seconds"] for u in units) / iters
