"""Library scenes through the port: renders of cornell_smoke (media,
rotated boxes), two_perlin_spheres (Perlin marble), random_scene (checker,
motion blur, defocus, sky), the stand-in final_scene (media, image and
noise textures, a 1000-sphere cluster tree), obj_uv_demo (an OBJ quad with
per-corner uvs) and wwscene (rings, image-textured planets and the OBJ
mesh's packet tree) from the stand-in assets, within Monte-Carlo noise of
the JAX package's renders; every scene that needs no file, and wwscene
into a JPEG, through the CLI on the CPU."""

import os

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from raytracer2022_tpu.render.camera import make_camera as jax_make_camera
from raytracer2022_tpu.render.integrator import TraceConfig as JaxTraceConfig
from raytracer2022_tpu.render.renderer import render_batch_regen as jax_render_batch_regen
from raytracer2022_tpu.scene import library as jlib
from raytracer2022_tpu.scene.builder import SceneBuilder as JaxBuilder
from raytracer2022_tpu_torch import cli
from raytracer2022_tpu_torch.render import renderer as R
from raytracer2022_tpu_torch.render.camera import make_camera
from raytracer2022_tpu_torch.render.integrator import TraceConfig
from raytracer2022_tpu_torch.scene import library as tlib
from raytracer2022_tpu_torch.scene.builder import SceneBuilder as TorchBuilder
from raytracer2022_tpu_torch.utils.imageio import read_png

torch.set_num_threads(1)

W = H = 24
SPP_PAR, SPP_SEQ = 4, 8
# the mean per-pixel gap between the port and JAX, over the gap between two
# JAX seeds: 1 in expectation when both draw from one distribution
MAX_GAP_RATIO = 1.3
MAX_CHANNEL_REL = 0.08  # channel means, chip_smoke.py's MAX_REL
MIN_MEAN = 0.05  # a render darker than this is taken for a black one
MIN_MEAN_OF = {"wwscene": 0.01}  # a small far light and black space: its renders' mean is about 0.04
# wwscene's emissive stars leave fireflies at 24x24 x 32 spp: the blue
# means of JAX seeds 0 and 1 differ by more than MAX_CHANNEL_REL.  Its
# channel means are held in standard errors of this many JAX seeds' spread,
# as chip_smoke.card_vs_cpu holds the card's, instead of within
# MAX_CHANNEL_REL of two seeds' mean.
Z_SEEDS = {"wwscene": 6}

FILE_FREE = ["random_scene", "two_spheres", "two_perlin_spheres", "simple_light", "cornell_smoke",
             "cornell_box_book"]


@pytest.fixture(scope="module")
def source_dir(tmp_path_factory):
    """The stand-in assets (the port's JPEGs, a 640-triangle Shuttle)."""
    path = str(tmp_path_factory.mktemp("assets"))
    chip_smoke.write_stand_in_assets(path, shuttle=(20, 16))
    return path


def _bundles(name, source_dir=None):
    """(scene, camera kwargs, background) of both packages."""
    if name == "final_scene_stand_in":
        earth = chip_smoke.earth_stand_in()
        jb, tb = JaxBuilder(), TorchBuilder()
        kw = chip_smoke.final_scene_stand_in(jb, earth)
        chip_smoke.final_scene_stand_in(tb, earth)
        return (jb.finalize(), kw, (0.0, 0.0, 0.0)), (tb.finalize(device="cpu"), kw, (0.0, 0.0, 0.0))
    kw = {} if source_dir is None else {"source_dir": source_dir}
    jb, tb = jlib.SCENES[name](**kw), tlib.SCENES[name](device="cpu", **kw)
    return (jb.scene, jb.camera_kwargs, jb.background), (tb.scene, tb.camera_kwargs, tb.background)


@pytest.mark.parametrize("name", ["cornell_smoke", "two_perlin_spheres", "random_scene", "final_scene_stand_in",
                                  "obj_uv_demo", "wwscene"])
def test_render_matches_jax_within_noise(name, request):
    files = request.getfixturevalue("source_dir") if name in ("obj_uv_demo", "wwscene") else None
    (js, jkw, jbg), (ts, tkw, tbg) = _bundles(name, files)
    n = SPP_PAR * SPP_SEQ
    jcfg = JaxTraceConfig(max_depth=50, background=jbg)
    jcam = jax_make_camera(**jkw)
    ref = [
        np.asarray(jax_render_batch_regen(js, jcam, jax.random.PRNGKey(s), W, H, SPP_PAR, SPP_SEQ, jcfg)) / n
        for s in (0, 1)
    ]
    tcfg = TraceConfig(max_depth=50, background=tbg)
    got = R.render_batch_regen(ts, make_camera(**tkw, device="cpu"), R.step_generator(0, 0, "cpu"),
                               W, H, SPP_PAR, SPP_SEQ, tcfg).numpy() / n
    assert np.isfinite(got).all() and got.mean() > MIN_MEAN_OF.get(name, MIN_MEAN)
    gap = np.abs(got - ref[0]).mean()
    noise = np.abs(ref[1] - ref[0]).mean()
    assert gap < MAX_GAP_RATIO * noise, (gap, noise)
    if name in Z_SEEDS:
        k = Z_SEEDS[name]
        ref += [np.asarray(jax_render_batch_regen(js, jcam, jax.random.PRNGKey(s), W, H, SPP_PAR, SPP_SEQ, jcfg)) / n
                for s in range(2, k)]
        runs = np.array([r.mean(axis=(1, 2)) for r in ref])
        z = (got.mean(axis=(1, 2)) - runs.mean(axis=0)) / (runs.std(axis=0, ddof=1) * np.sqrt(1.0 + 1.0 / k))
        assert (np.abs(z) < chip_smoke.MAX_Z).all(), z
        return
    m_got, m_ref = got.mean(axis=(1, 2)), (ref[0] + ref[1]).mean(axis=(1, 2)) / 2
    np.testing.assert_allclose(m_got, m_ref, rtol=MAX_CHANNEL_REL)


@pytest.mark.parametrize("name", FILE_FREE)
def test_file_free_scene_renders_through_the_cli(name, tmp_path):
    out = str(tmp_path / f"{name}.png")
    rc = cli.main(["--scene", name, "--width", "12", "--height", "10", "--spp", "4",
                   "--max-depth", "8", "--device", "cpu", "--out", out, "--quiet"])
    assert rc == 0
    img = read_png(out)
    assert img.shape == (10, 12, 3) and img.max() > 0


def test_wwscene_through_the_cli_writes_a_jpeg(source_dir, tmp_path, monkeypatch):
    from PIL import Image

    monkeypatch.setenv("RT2022_SOURCE_DIR", source_dir)
    out = str(tmp_path / "out" / "output.jpg")
    rc = cli.main(["--scene", "wwscene", "--width", "32", "--height", "18", "--spp", "2",
                   "--max-depth", "8", "--device", "cpu", "--out", out, "--quiet"])
    assert rc == 0
    with Image.open(out) as im:
        assert im.format == "JPEG" and im.size == (32, 18)
        img = np.asarray(im.convert("RGB"))
    assert img.max() > 0


def test_cli_defaults_to_wwscene_from_the_asset_directory(tmp_path, monkeypatch):
    """With no --scene the CLI builds wwscene, as the JAX CLI does; an empty
    asset directory is an error naming the missing file and the variable."""
    empty = str(tmp_path / "empty")
    os.makedirs(empty)
    monkeypatch.setenv("RT2022_SOURCE_DIR", empty)
    with pytest.raises(FileNotFoundError, match="Saturn.jpg.*RT2022_SOURCE_DIR"):
        cli.main(["--device", "cpu", "--width", "8", "--height", "8", "--spp", "1", "--quiet",
                  "--out", str(tmp_path / "x.jpg")])
    assert not os.path.exists(tmp_path / "x.jpg")
