"""``closest_hit_device_pct.frame``: device time of the kernels launched
inside the program's ``vertex.closest_hit`` spans over the device's busy
time, in the profiled launches.  Moves ``Mpaths_s``."""


def read(ctx):
    tr = ctx.trace
    if tr is None or tr["busy_s"] <= 0 or not tr["spans"].get("vertex.closest_hit"):
        return None
    return 100.0 * tr["spans"]["vertex.closest_hit"] / tr["busy_s"]
