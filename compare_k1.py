"""Kernel K1 built from several trees' sources, timed in turns on one card.

    python3 compare_k1.py ROOT [ROOT ...]

Each ROOT is the root of a checkout (``.`` for this one; an older commit
unpacked with ``git archive`` into a git-ignored directory for another).
Its ``raytracer2022_tpu_torch/csrc/bvh8.cu`` is compiled with this tree's
nvcc flags into ``build/compare_k1/``, once per distinct ROOT, beside a
probe: the same source included into a file that asks
``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` for the blocks an SM
holds.  A build with this tree's C interface (``ops/bvh8.py::declare``:
the stack sized by the tree's depth) or the one before it (a fixed stack
of ``MAX_DEPTH`` words, :class:`FixedStack`) will do.  The
shapes are this tree's, as
``chip_smoke.py`` makes them: S1 the stand-in mesh's 262,144 camera rays
with the dense t_init, S2 262,144 bounce rays of its 600x600x64 render, S3
final_scene's 1,000 spheres with a packet tree.  Then, for each ROOT in
the order given, each shape in each instantiation its tree fits: the mean
ms of 50 direct launches by CUDA events (``chip_smoke.raw_k1``), three
times, and the blocks per SM; and the most groups a tree may have in the
shared-memory instantiation.  Prints one JSON line per ROOT, with the
card's name and power limit.  Compare in turns within one call:

    python3 compare_k1.py build/parent . . build/parent
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

REPS = 3  # timings of 50 launches each, per shape and instantiation
THREADS = 512  # csrc/bvh8.cu: threads a block, each a column of the stack

PROBE = r"""
#include "{source}"

namespace {{
template <int K, bool SH>
int blocks_per_sm(int ng, int stack_bytes) {{
  const int smem = stack_bytes + (SH ? ng * GROUP_BYTES : 0);
  if (cudaFuncSetAttribute(bvh8_walk<K, SH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) != cudaSuccess)
    return -1;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, bvh8_walk<K, SH>, THREADS, smem) != cudaSuccess) return -1;
  return n;
}}
template <int K>
int of_kind(int shared, int ng, int stack_bytes) {{
  return shared ? blocks_per_sm<K, true>(ng, stack_bytes) : blocks_per_sm<K, false>(ng, stack_bytes);
}}
}}  // namespace

extern "C" int rt_bvh8_blocks_per_sm(int kind, int shared, int ng, int stack_bytes) {{
  switch (kind) {{
    case 0: return of_kind<0>(shared, ng, stack_bytes);
    case 1: return of_kind<1>(shared, ng, stack_bytes);
    case 2: return of_kind<2>(shared, ng, stack_bytes);
    case 3: return of_kind<3>(shared, ng, stack_bytes);
    case 4: return of_kind<4>(shared, ng, stack_bytes);
    default: return -1;
  }}
}}
"""


def _nvcc(src: str, out: str) -> None:
    from raytracer2022_tpu_torch.cuda_build import NVCC_FLAGS, _nvcc as nvcc

    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", out, src], capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}\n{proc.stderr}")


class FixedStack:
    """A build from before the tree's depth was an argument (a stack of
    ``levels`` words a thread whatever the tree) behind the present
    C interface, so that ``chip_smoke.raw_k1`` and ``shared_fits_groups``
    launch and ask it as they do this tree's."""

    def __init__(self, lib, levels: int):
        self.lib, self.levels = lib, levels
        lib.rt_bvh8_traverse.restype = lib.rt_bvh8_shared_fits.restype = ctypes.c_int
        lib.rt_bvh8_traverse.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                                         ctypes.c_int] + [ctypes.c_void_p] * 15
        lib.rt_bvh8_shared_fits.argtypes = [ctypes.c_int]

    def rt_bvh8_traverse(self, kind, shared, t_min, n, ng, depth, *pointers):
        return self.lib.rt_bvh8_traverse(kind, shared, t_min, n, ng, *pointers)

    def rt_bvh8_shared_fits(self, ng, depth):
        return self.lib.rt_bvh8_shared_fits(ng)


def build_root(root: str, tag: str, outdir: str):
    """(K1 library, probe library, stack levels or None) of ``root``'s
    bvh8.cu: None where the stack takes the tree's depth."""
    import re

    from raytracer2022_tpu_torch.ops.bvh8 import declare

    source = os.path.join(os.path.abspath(root), "raytracer2022_tpu_torch", "csrc", "bvh8.cu")
    with open(source) as f:
        fixed = re.search(r"constexpr int MAX_DEPTH = (\d+);", f.read())
    lib_path = os.path.join(outdir, f"bvh8-{tag}.so")
    _nvcc(source, lib_path)
    probe_src = os.path.join(outdir, f"probe-{tag}.cu")
    with open(probe_src, "w") as f:
        f.write(PROBE.format(source=source))
    probe_path = os.path.join(outdir, f"probe-{tag}.so")
    _nvcc(probe_src, probe_path)
    probe = ctypes.CDLL(probe_path)
    probe.rt_bvh8_blocks_per_sm.restype = ctypes.c_int
    probe.rt_bvh8_blocks_per_sm.argtypes = [ctypes.c_int] * 4
    if fixed:
        levels = int(fixed.group(1))
        return FixedStack(ctypes.CDLL(lib_path), levels), probe, levels
    return declare(ctypes.CDLL(lib_path)), probe, None


def make_shapes(dev) -> dict:
    """S1-S3 as ``chip_smoke.py`` makes them: name -> (tree, kind, o, d,
    tm, t_init, rows)."""
    import numpy as np
    import torch

    import chip_smoke as smoke
    from raytracer2022_tpu_torch.render.camera import make_camera
    from raytracer2022_tpu_torch.render.renderer import RenderConfig
    from raytracer2022_tpu_torch.scene.builder import SceneBuilder

    b = SceneBuilder()
    cam = make_camera(**smoke.stand_in_mesh_scene(b), device=dev)
    mesh = b.finalize(device=dev)
    o, d, tm, t_dense = smoke.mesh_rays(mesh, cam, np.random.default_rng(1234))
    s1 = [x[..., : smoke.LANES].contiguous() for x in (o, d, tm, t_dense)]
    cfg = RenderConfig(width=smoke.WIDTH, height=smoke.HEIGHT, spp=smoke.SPP, max_depth=smoke.DEPTH,
                       background=(0.0, 0.0, 0.0))
    s2 = smoke.s2_rays(smoke.render_capturing(mesh, cam, cfg, smoke.S2_CALLS)[2])
    s3_scene, o3, d3, tm3 = smoke.sphere_tree_rays(dev)
    tree = mesh.bvh8[0]
    return {
        "S1": (tree, smoke.TRIANGLE, *s1, True),
        "S2": (tree, smoke.TRIANGLE, *s2, True),
        "S3": (s3_scene.bvh8[0], smoke.SPHERE, o3, d3, tm3, torch.full_like(tm3, float("inf")), False),
    }


def time_root(lib, probe, levels, shapes: dict) -> dict:
    """Each shape's times (ms, REPS of them) and blocks per SM in each
    instantiation its tree fits, its stack bytes a block, and the
    shared-memory threshold at the deepest tree."""
    import chip_smoke as smoke
    from raytracer2022_tpu_torch.ops.bvh8 import FANOUT, MAX_DEPTH

    out = {"stack_levels": levels or "tree depth", "shared_fits_groups": smoke.shared_fits_groups(lib, MAX_DEPTH)}
    for name, (tree, kind, o, d, tm, t_init, rows) in shapes.items():
        ng = tree.entries.shape[0] // FANOUT
        stack_bytes = (levels or tree.depth) * THREADS * 4
        rec = {"groups": ng, "depth": tree.depth, "stack_bytes": stack_bytes,
               "shared_fits_groups": smoke.shared_fits_groups(lib, tree.depth)}
        for mode in ("shared", "global"):
            if mode == "shared" and ng > rec["shared_fits_groups"]:
                continue
            run = smoke.raw_k1(lib, tree, kind, o, d, tm, t_init, rows, mode == "shared")
            rec[mode] = {"ms": [smoke._time_cuda(run, 50) for _ in range(REPS)],
                         "per_sm": probe.rt_bvh8_blocks_per_sm(kind, int(mode == "shared"), ng, stack_bytes)}
        out[name] = rec
    return out


def main(roots: list) -> int:
    import torch

    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    os.chdir(here)
    if not torch.cuda.is_available():
        print("compare_k1: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    outdir = os.path.join(here, "build", "compare_k1")
    os.makedirs(outdir, exist_ok=True)
    builds = {}
    for root in roots:
        if root not in builds:
            builds[root] = build_root(root, str(len(builds)), outdir)
    shapes = make_shapes(dev)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    for root in roots:
        rec = {"root": root, **time_root(*builds[root], shapes), "card": card}
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:] or ["."]))
