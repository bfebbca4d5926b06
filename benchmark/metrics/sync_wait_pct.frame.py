"""``sync_wait_pct.frame``: the host's seconds blocked in counted syncs
(``regen.sync``) over the launches' wall seconds, in the window's strip
launches that ran without the profiler, from the launch records in
``render_sum_n``'s launch log.  Nothing where the records lack the wait.
Moves ``Mpaths_s``."""


def read(ctx):
    units = [u for u in ctx.unprofiled() if "sync_wait_s" in u]
    seconds = sum(u["seconds"] for u in units)
    if seconds <= 0:
        return None
    return 100.0 * sum(u["sync_wait_s"] for u in units) / seconds
