"""The plain reference: it agrees with the program's CPU render within
noise on small frames, imports nothing of the program, and the frozen K1
bound is chip_smoke's."""

import json
import subprocess
import sys

import pytest
import torch
from conftest import BENCH, ROOT

from harness import cell as cells
from harness.compare import frame_numbers
from harness.scene import build_port_scene

SMALL = {"cornell_book3": ((48, 48), {}), "wwscene": ((64, 36), {"mesh": (20, 16), "maps": (64, 32)})}


@pytest.mark.parametrize("cell", ["cornell_book3.frame", "wwscene.frame"])
def test_reference_agrees_with_the_program_on_the_cpu(cell):
    from raytracer2022_tpu_torch import RenderConfig, render_sum_n
    from reference import tracer

    c = cells.load(cell)
    (w, h), kw = SMALL[c.config_name]
    desc = c.config.describe(123, **kw)
    scene, cam, _ = build_port_scene(desc, "cpu")
    sums = []
    for k in range(2):
        total, n = render_sum_n(scene, cam, RenderConfig(width=w, height=h, spp=32, max_depth=c.config.DEPTH,
                                                         background=(0.0, 0.0, 0.0), seed=40 + k))
        sums.append(total)
    s, q = tracer.render_sums(tracer.Tables(desc, "cpu"), w, h, 256, c.config.DEPTH, seed=7, block_lanes=1 << 16)
    numbers = frame_numbers(sums, 32, 64, s, q, 256, 16)
    assert numbers["samples_gap"] == 0
    assert numbers["tile_z2_mean"] <= c.limits["tile_z2_mean"] and numbers["tile_z_max"] <= c.limits["tile_z_max"]


def test_frozen_k1_bound_is_chip_smokes():
    import chip_smoke
    from harness.k1_bound import k1_bound, tree_bytes
    from raytracer2022_tpu_torch import SceneBuilder
    from raytracer2022_tpu_torch.scene.types import TRIANGLE

    b = SceneBuilder(seed=0)
    mat = b.lambertian((0.5, 0.5, 0.5))
    rng = torch.Generator().manual_seed(0)
    for _ in range(600):
        a = torch.rand(3, generator=rng) * 10
        b.triangle(a, a + torch.rand(3, generator=rng), a + torch.rand(3, generator=rng), mat)
    scene = b.finalize(device="cpu")
    tree = next(t for t in scene.bvh8 if t is not None)
    for n, g, lv, rows in ((262144, 1_500_000, 400_000, True), (1000, 10, 3, False)):
        assert k1_bound(tree_bytes(tree), TRIANGLE, n, g, lv, rows) == chip_smoke.k1_bound(tree, TRIANGLE, n, g, lv, rows)


def test_the_reference_loads_no_module_of_the_program():
    code = f"""
import sys, json, torch
sys.path[:0] = [{BENCH!r}]
sys.path.append({ROOT!r})
import importlib.util
spec = importlib.util.spec_from_file_location("cfg", {BENCH!r} + "/configs/wwscene.py")
cfg = importlib.util.module_from_spec(spec); spec.loader.exec_module(cfg)
from reference import tracer, fit
desc = cfg.describe(1, mesh=(8, 6), maps=(16, 8))
tracer.render_sums(tracer.Tables(desc, "cpu"), 16, 9, 2, 50, seed=1)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not tops & {"raytracer2022_tpu_torch", "raytracer2022_tpu", "jax", "jaxlib", "flax"}


def test_a_pixel_the_reference_missed_keeps_the_programs_largest_spread():
    from harness.compare import tile_z

    ref = torch.zeros(3, 8, 8, dtype=torch.float64)
    passes = [torch.zeros(3, 8, 8) for _ in range(2)]
    for p in passes:  # one sample of 0.24 in each pass of 32, so the passes do not spread
        p[:, 0, 0] = 0.24
    z = tile_z(passes, 32, ref, ref.clone(), 8, 8)
    assert bool(torch.isfinite(z).all()) and float(z.abs().max()) < 1.0, z
