"""``k1_device_pct``: K1's kernels (names holding ``bvh8``) over the device's
busy time in the profiled launches.  Nothing where K1 did not run.  Moves
``Mpaths_s``."""


def read(ctx):
    tr = ctx.trace
    if tr is None or tr["busy_s"] <= 0:
        return None
    k1 = sum(s for name, s in tr["kernels"].items() if "bvh8" in name)
    return 100.0 * k1 / tr["busy_s"] if k1 > 0 else None
