"""``fit_iter_ms``: milliseconds of wall time a regeneration iteration of
the fit step: the unprofiled steps' seconds over their count times the trip
count the cell passes as ``regen_iters``.  Moves ``fit_step_s``."""


def read(ctx):
    steps = ctx.unprofiled()
    iters = ctx.setup.get("regen_iters")
    if not steps or not iters:
        return None
    return 1e3 * sum(s["seconds"] for s in steps) / (len(steps) * iters)
