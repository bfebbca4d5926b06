"""``scene_build_s``: seconds of the program's compile of the scene from the
benchmark's description (``SceneBuilder`` and ``finalize``), host clock,
ending in a synchronisation.  Moves ``setup_s``."""


def read(ctx):
    return ctx.setup.get("scene_build_s")
