"""Scene compiler parity: the PyTorch port's compiled arrays equal the JAX
compiler's exactly, for the library scenes, the stand-in mesh scene and the
four scenes that read files (from the stand-in assets, JPEGs written by the
port's encoder and by Pillow's); the OBJ parser and import against the JAX
package's on the native and the NumPy path; the port's own host runtime."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
import raytracer2022_tpu.native as jax_native  # noqa: E402
from raytracer2022_tpu.scene import library as jlib  # noqa: E402
from raytracer2022_tpu.scene import objio as jax_objio  # noqa: E402
from raytracer2022_tpu.scene.builder import SceneBuilder as JaxBuilder  # noqa: E402
from raytracer2022_tpu_torch import native  # noqa: E402
from raytracer2022_tpu_torch.scene import library as tlib  # noqa: E402
from raytracer2022_tpu_torch.scene import objio  # noqa: E402
from raytracer2022_tpu_torch.scene.builder import SceneBuilder as TorchBuilder  # noqa: E402
from raytracer2022_tpu_torch.scene.types import SceneData, SceneStats  # noqa: E402

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
# the scenes that read files, each from JPEGs of both encoders
FILE_BOUND = [f"{name}/{enc}" for name in ("earth", "final_scene", "obj_uv_demo", "wwscene")
              for enc in ("port-jpeg", "pillow-jpeg")]
SHUTTLE = (20, 16)  # the stand-in Shuttle: 640 triangles, enough for a TRIANGLE packet tree


def write_asset_dirs(root) -> dict:
    """The stand-in assets twice: JPEGs from the port's encoder and from
    Pillow's at quality 100 (files the port's decoder did not write)."""
    from PIL import Image

    dirs = {"port-jpeg": os.path.join(root, "port"), "pillow-jpeg": os.path.join(root, "pillow")}
    chip_smoke.write_stand_in_assets(dirs["port-jpeg"], shuttle=SHUTTLE)
    chip_smoke.write_stand_in_assets(dirs["pillow-jpeg"], shuttle=SHUTTLE,
                                     encode=lambda path, img: Image.fromarray(img).save(path, quality=100))
    return dirs


@pytest.fixture(scope="module")
def asset_dirs(tmp_path_factory):
    return write_asset_dirs(str(tmp_path_factory.mktemp("assets")))


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


def unpack_atlas(atlas: np.ndarray) -> np.ndarray:
    """u32[I, H, W] packed texels -> u8[I, H, W, 3]."""
    return np.stack([(atlas >> sh) & 255 for sh in (16, 8, 0)], -1).astype(np.uint8)


def _both(name, source_dir=None):
    if source_dir is not None:
        scene = name.split("/")[0]
        return (jlib.SCENES[scene](source_dir=source_dir).scene,
                tlib.SCENES[scene](source_dir=source_dir, device="cpu").scene)
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


@pytest.mark.parametrize("name", LIBRARY + ["stand_in_mesh", "final_scene_stand_in"] + FILE_BOUND)
def test_compiled_arrays_equal_jax(name, request):
    """Equal arrays; for the file-bound scenes the image texels (decoded by
    Pillow for JAX and by the port's codec) meet the decoder criterion of
    tests/test_torch_imageio.py and every other array is equal."""
    source_dir = request.getfixturevalue("asset_dirs")[name.split("/")[1]] if "/" in name else None
    js, ts = _both(name, source_dir)
    ja, ta = jax_scene_arrays(js), ts.to_numpy()
    if source_dir is not None:
        want, got = (unpack_atlas(x["textures"].pop("atlas")).astype(np.int64) for x in (ja, ta))
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1 and (got == want).mean() >= 0.99
        assert ts.stats.features >= {"image"} or ts.stats.features >= {"objuv"}
    assert_tree_equal(ja, ta)
    assert dataclasses.asdict(js.stats) == dataclasses.asdict(ts.stats)


def test_wwscene_mesh_gets_a_packet_tree_and_is_in_view(asset_dirs):
    bundle = tlib.wwscene(source_dir=asset_dirs["port-jpeg"], device="cpu")
    trees = [t for t in bundle.scene.bvh8 if t is not None]
    assert len(trees) == 1 and bundle.scene.stats.trees[0][0] == 3  # TRIANGLE
    assert bundle.scene.stats.n_in_bvh == 2 * SHUTTLE[0] * SHUTTLE[1]
    assert chip_smoke.mesh_view_share(bundle, "cpu") > 0


def test_missing_asset_names_the_file_and_the_variable(tmp_path):
    for scene in ("earth", "final_scene", "obj_uv_demo", "wwscene"):
        with pytest.raises(FileNotFoundError, match="RT2022_SOURCE_DIR") as e:
            tlib.SCENES[scene](source_dir=str(tmp_path), device="cpu")
        assert str(tmp_path) in str(e.value)


def _obj_text(rng, n_verts: int = 40, n_faces: int = 60) -> str:
    """OBJ text with every corner form (p, p/t, p//n, p/t/n), triangles,
    quads and n-gons, negative indices, 2- and 3-component vt, and the vn,
    o, g, s, usemtl, mtllib and comment lines a loader skips."""
    lines = ["# generated mesh", "mtllib none.mtl", "o body", "g part", "s off", "usemtl grey"]
    nv = nt = 0
    for i in range(n_faces):
        while nv < min(n_verts, 3 + i):
            lines.append("v " + " ".join(f"{x:.6f}" for x in rng.normal(size=3)))
            nv += 1
        if rng.uniform() < 0.5:
            uv = rng.uniform(size=2 + int(rng.uniform() < 0.3))
            lines.append("vt " + " ".join(f"{x:.5f}" for x in uv))
            nt += 1
        if i % 7 == 0:
            lines += ["vn 0 0 1", f"g group{i}", f"s {i % 2}", f"usemtl m{i % 3}", "# a comment"]
        n = int(rng.integers(3, min(7, nv + 1)))
        idx = rng.choice(nv, size=n, replace=False) + 1
        form = i % 4
        corners = []
        for k in idx:
            p = int(k) if rng.uniform() < 0.7 else int(k) - nv - 1  # negative: relative to the end
            t = int(rng.integers(1, nt + 1)) if nt else 0
            t = t if rng.uniform() < 0.7 or not nt else t - nt - 1
            if form == 0 or not nt and form in (1, 3):
                corners.append(f"{p}")
            elif form == 1:
                corners.append(f"{p}/{t}")
            elif form == 2:
                corners.append(f"{p}//1")
            else:
                corners.append(f"{p}/{t}/1")
        lines.append("f " + " ".join(corners))
    return "\n".join(lines) + "\n"


def _select_parser(monkeypatch, path_kind: str) -> None:
    """Both packages parse OBJ files natively, or both in Python."""
    if path_kind == "numpy":
        monkeypatch.setattr(native, "load_obj_native", lambda p: None)
        monkeypatch.setattr(jax_native, "load_obj_native", lambda p: None)
    else:
        assert native.available() and jax_native.available()


@pytest.mark.parametrize("path_kind", ["native", "numpy"])
@pytest.mark.parametrize("seed", [0, 1])
def test_load_obj_matches_jax(seed, path_kind, tmp_path, monkeypatch):
    path = str(tmp_path / "m.obj")
    with open(path, "w") as f:
        f.write(_obj_text(np.random.default_rng(seed)))
    _select_parser(monkeypatch, path_kind)
    (jv, jf, juv), (tv, tf, tuv) = jax_objio.load_obj(path), objio.load_obj(path)
    assert len(tf) > 60 and tuv is not None  # fans of n-gons, and texcoords
    for a, b in ((jv, tv), (jf, tf), (juv, tuv)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_load_obj_native_and_numpy_paths_agree(tmp_path, monkeypatch):
    path = str(tmp_path / "m.obj")
    with open(path, "w") as f:
        f.write(_obj_text(np.random.default_rng(2)))
    assert native.available()
    fast = objio.load_obj(path)
    monkeypatch.setattr(native, "load_obj_native", lambda p: None)
    slow = objio.load_obj(path)
    for a, b in zip(fast, slow):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("path_kind", ["native", "numpy"])
@pytest.mark.parametrize("use_uvs", [False, True])
def test_import_obj_matches_jax(use_uvs, path_kind, tmp_path, monkeypatch):
    """library._import_obj: triangles baked through zoom, rotate_y and
    translate, with the corners' uvs, compile to equal arrays."""
    path = str(tmp_path / "shuttle.obj")
    with open(path, "w") as f:
        f.write(chip_smoke.shuttle_obj_text(*SHUTTLE))
    _select_parser(monkeypatch, path_kind)
    scenes = []
    for lib, builder, kw in ((jlib, JaxBuilder(), {}), (tlib, TorchBuilder(), {"device": "cpu"})):
        tex = builder.objuv(chip_smoke.earth_stand_in(0, 64, 32)) if use_uvs else None
        mat = builder.lambertian(tex) if use_uvs else builder.lambertian((0.78, 0.78, 0.78))
        lib._import_obj(builder, path, mat, zoom=13.5, rot_y=56.0, trans=(40.88, 1.3, -85.59), use_uvs=use_uvs)
        scenes.append(builder.finalize(**kw))
    js, ts = scenes
    assert_tree_equal(jax_scene_arrays(js), ts.to_numpy())
    assert dataclasses.asdict(js.stats) == dataclasses.asdict(ts.stats)


def test_host_runtime_is_built_from_the_ports_source():
    """The port compiles csrc/rt_native.cpp into build/native/ and never
    opens the JAX package's committed native/librt_native.so."""
    code = (
        "import os, tempfile\n"
        "from raytracer2022_tpu_torch import native\n"
        "from raytracer2022_tpu_torch.scene.bvh import build_bvh\n"
        "from raytracer2022_tpu_torch.scene.objio import load_obj\n"
        "import numpy as np\n"
        "assert native.available()\n"
        "lo = np.random.default_rng(0).uniform(0, 1, (50, 3)).astype(np.float32)\n"
        "build_bvh(lo, lo + 0.1)\n"
        "with tempfile.NamedTemporaryFile('w', suffix='.obj', delete=False) as f:\n"
        "    f.write('v 0 0 0\\nv 1 0 0\\nv 0 1 0\\nf 1 2 3\\n')\n"
        "load_obj(f.name); os.unlink(f.name)\n"
        "maps = open('/proc/self/maps').read()\n"
        "assert 'librt_native.so' not in maps, 'opened the committed library'\n"
        "assert native.LIBRARY_PATH in maps\n"
        "print(native.LIBRARY_PATH)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "RT2022_NO_NATIVE"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr
    lib = out.stdout.strip()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(native.__file__)))
    assert os.path.dirname(lib) == os.path.join(repo, "build", "native")
    assert os.path.basename(lib).startswith("rt_native-") and lib.endswith(".so")


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
        "import raytracer2022_tpu_torch.utils.imageio\n"
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
