"""``device_idle_pct.fit``: 100 minus the union of the device's activity
over the wall time of the profiled fit steps.  Moves ``fit_step_s``."""


def read(ctx):
    tr = ctx.trace
    if tr is None or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
