"""``k1_roofline``: kernel K1's share of its roofline, the frozen bound
(``harness/k1_bound.py``) over K1's device time a launch (profiler), on
262,144 camera rays of the cell's frame against the mesh's packet tree
with the dense hits as ``t_init``, after the window.  Nothing where the
scene has no packet tree.  Moves ``Mpaths_s``."""


def read(ctx):
    probe = ctx.probe("k1")
    return None if probe is None else probe["share_pct"]
