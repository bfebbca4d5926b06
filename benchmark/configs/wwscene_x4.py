"""wwscene_x4: the reference's own frame rendered by four ranks on one
four-card host, as ``rt2022-torch --sharded`` renders it.

Source: Jerx2y/Raytracer-2022, README.md:9-17 (the multithreaded track:
one frame over several OS threads) with the frame and scene of
``configs/wwscene.py`` (main.rs:33-51, scene.rs:468-571).  The scene is
that configuration's whole: ``FRAME``, ``DEPTH``, ``SPP``, ``ASSUMED``
and ``describe`` are read from its file, not copied.

The cluster: ``WORLD`` ranks, one a card, on one host, joined over
``BACKEND``.  The samples of a pass split over the ranks by the
program's ``parallel/mesh.py::regen_split`` (at 128 spp: 32 a rank, one
lane a pixel, 15 strips of 102 rows), rank ``r`` draws from
``derive_seed(pass seed, r)``, and one ``all_reduce(SUM)`` of the float32
sum (3 x 1440 x 2560 x 4 = 44,236,800 bytes) ends each pass.

Cut: ``spp`` only, as ``wwscene``'s: passes of 128 (the workload file)
against the source's 2000.  No width, frame size, depth or element of
the scene is cut, and the whole deployment is one four-card host, so
the cluster is not cut either.
"""

from __future__ import annotations

from harness.cell import load_module

_SCENE = load_module("configs", "wwscene")

SOURCE = ("https://github.com/Jerx2y/Raytracer-2022 (README.md:9-17 multithreaded track; main.rs:33-51; "
          "scene.rs:468-571) as rt2022-torch --sharded, one rank per card")
FRAME = _SCENE.FRAME
DEPTH = _SCENE.DEPTH
SPP = _SCENE.SPP
ASSUMED = _SCENE.ASSUMED
describe = _SCENE.describe
REDUCED = ["spp"]
WORLD = 4  # one rank a card, one host
BACKEND = "nccl"  # the ranks on cards; a CPU rehearsal joins over gloo
