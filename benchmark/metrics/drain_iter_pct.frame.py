"""``drain_iter_pct.frame``: the share of the window's regeneration
iterations that ran in the N/4 and N/16 drains, from ``render_sum_n``'s
launch log.  Moves ``Mpaths_s``."""


def read(ctx):
    units = [u for u in ctx.units if "pool" in u]
    total = sum(u["pool"] + u["drain_n4"] + u["drain_n16"] for u in units)
    if not total:
        return None
    return 100.0 * sum(u["drain_n4"] + u["drain_n16"] for u in units) / total
