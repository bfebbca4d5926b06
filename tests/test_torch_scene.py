"""Scene compiler parity: the PyTorch port's compiled arrays equal the JAX
compiler's exactly, for the library scenes and the stand-in mesh scene."""

import dataclasses
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from raytracer2022_tpu.scene import library as jlib
from raytracer2022_tpu.scene.builder import SceneBuilder as JaxBuilder
from raytracer2022_tpu_torch.scene import library as tlib
from raytracer2022_tpu_torch.scene.builder import SceneBuilder as TorchBuilder
from raytracer2022_tpu_torch.scene.types import SceneData, SceneStats

torch.set_num_threads(1)

LIBRARY = [
    "cornell_box",
    "cornell_box_book",
    "cornell_smoke",
    "random_scene",
    "two_spheres",
    "two_perlin_spheres",
    "simple_light",
]


def jax_scene_arrays(scene) -> dict:
    """The JAX compiled scene as the nested numpy dict of
    ``SceneData.from_numpy``."""

    def fields(obj):
        return {f.name: np.asarray(getattr(obj, f.name)) for f in dataclasses.fields(obj)}

    names = ("kind", "params", "mat_id", "flip", "active", "xf_rot", "xf_inv_scale",
             "xf_trans", "lights")
    out = {name: np.asarray(getattr(scene, name)) for name in names}
    out["materials"] = fields(scene.materials)
    out["textures"] = fields(scene.textures)
    out["clusters"] = [fields(c) for c in scene.clusters]
    out["bvh8"] = [None if t is None else fields(t) for t in scene.bvh8]
    out["any_xform"] = scene.any_xform
    out["any_medium"] = scene.any_medium
    return out


def assert_tree_equal(a, b, path="scene"):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            assert_tree_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_tree_equal(x, y, f"{path}[{i}]")
    elif a is None or isinstance(a, bool):
        assert a == b, path
    else:
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=path)


def _both(name):
    if name == "stand_in_mesh":
        jb, tb = JaxBuilder(), TorchBuilder()
        chip_smoke.stand_in_mesh_scene(jb, 24, 12)
        chip_smoke.stand_in_mesh_scene(tb, 24, 12)
        return jb.finalize(), tb.finalize(device="cpu")
    if name == "final_scene_stand_in":
        jb, tb = JaxBuilder(), TorchBuilder()
        earth = chip_smoke.earth_stand_in()
        chip_smoke.final_scene_stand_in(jb, earth)
        chip_smoke.final_scene_stand_in(tb, earth)
        return jb.finalize(), tb.finalize(device="cpu")
    return jlib.SCENES[name]().scene, tlib.SCENES[name](device="cpu").scene


@pytest.mark.parametrize("name", LIBRARY + ["stand_in_mesh", "final_scene_stand_in"])
def test_compiled_arrays_equal_jax(name):
    js, ts = _both(name)
    assert_tree_equal(jax_scene_arrays(js), ts.to_numpy())
    assert dataclasses.asdict(js.stats) == dataclasses.asdict(ts.stats)


def test_stand_in_mesh_builds_a_triangle_packet_tree():
    _, ts = _both("stand_in_mesh")
    assert ts.n_prims == 6 + 576
    assert len(ts.bvh8) == 1 and ts.bvh8[0] is not None
    assert ts.stats.trees[0][0] == 3  # TRIANGLE
    assert ts.stats.n_in_bvh == 576


def test_from_numpy_round_trip():
    js, ts = _both("stand_in_mesh")
    again = SceneData.from_numpy(ts.to_numpy(), ts.stats, "cpu")
    assert_tree_equal(again.to_numpy(), ts.to_numpy())
    assert again.stats == ts.stats
    # the JAX compiler's scene, handed over as numpy + its own stats object
    from_jax = SceneData.from_numpy(jax_scene_arrays(js), js.stats, "cpu")
    assert isinstance(from_jax.stats, SceneStats)
    assert from_jax.stats == ts.stats
    assert_tree_equal(from_jax.to_numpy(), ts.to_numpy())


def test_entry_points_default_to_the_card(monkeypatch):
    """Scenes, builders, cameras and from_numpy build on the card unless
    asked for the CPU; without a card they raise instead of moving there."""
    from raytracer2022_tpu_torch.render.camera import make_camera

    def builder():
        b = TorchBuilder()
        b.sphere((0, 0, 0), 1, b.lambertian((0.5, 0.5, 0.5)))
        return b

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    bundle = tlib.cornell_box(device="cpu")
    cam_kw = bundle.camera_kwargs
    for build in (
        lambda: tlib.cornell_box(),
        lambda: builder().finalize(),
        lambda: make_camera(**cam_kw),
        lambda: SceneData.from_numpy(bundle.scene.to_numpy(), bundle.scene.stats),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
    assert bundle.scene.device.type == "cpu"
    assert make_camera(**cam_kw, device="cpu").origin.device.type == "cpu"
    assert builder().finalize(device="cpu").device.type == "cpu"


def test_port_never_imports_jax():
    code = (
        "import pkgutil, importlib, sys\n"
        "import raytracer2022_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith(('jax.', 'raytracer2022_tpu.')) or k == 'raytracer2022_tpu')\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
