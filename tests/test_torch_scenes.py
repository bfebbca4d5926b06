"""Library scenes through the port: renders of cornell_smoke (media,
rotated boxes), two_perlin_spheres (Perlin marble), random_scene (checker,
motion blur, defocus, sky) and the stand-in final_scene (media, image and
noise textures, a 1000-sphere cluster tree) within Monte-Carlo noise of the
JAX package's renders, and every scene that needs no file through the CLI
on the CPU."""

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

torch.set_num_threads(1)

W = H = 24
SPP_PAR, SPP_SEQ = 4, 8
# the mean per-pixel gap between the port and JAX, over the gap between two
# JAX seeds: 1 in expectation when both draw from one distribution
MAX_GAP_RATIO = 1.3
MAX_CHANNEL_REL = 0.08  # channel means, chip_smoke.py's MAX_REL

FILE_FREE = ["random_scene", "two_spheres", "two_perlin_spheres", "simple_light", "cornell_smoke",
             "cornell_box_book"]


def _bundles(name):
    """(scene, camera kwargs, background) of both packages."""
    if name == "final_scene_stand_in":
        earth = chip_smoke.earth_stand_in()
        jb, tb = JaxBuilder(), TorchBuilder()
        kw = chip_smoke.final_scene_stand_in(jb, earth)
        chip_smoke.final_scene_stand_in(tb, earth)
        return (jb.finalize(), kw, (0.0, 0.0, 0.0)), (tb.finalize(device="cpu"), kw, (0.0, 0.0, 0.0))
    jb, tb = jlib.SCENES[name](), tlib.SCENES[name](device="cpu")
    return (jb.scene, jb.camera_kwargs, jb.background), (tb.scene, tb.camera_kwargs, tb.background)


@pytest.mark.parametrize("name", ["cornell_smoke", "two_perlin_spheres", "random_scene", "final_scene_stand_in"])
def test_render_matches_jax_within_noise(name):
    (js, jkw, jbg), (ts, tkw, tbg) = _bundles(name)
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
    assert np.isfinite(got).all() and got.mean() > 0.05
    gap = np.abs(got - ref[0]).mean()
    noise = np.abs(ref[1] - ref[0]).mean()
    assert gap < MAX_GAP_RATIO * noise, (gap, noise)
    m_got, m_ref = got.mean(axis=(1, 2)), (ref[0] + ref[1]).mean(axis=(1, 2)) / 2
    np.testing.assert_allclose(m_got, m_ref, rtol=MAX_CHANNEL_REL)


@pytest.mark.parametrize("name", FILE_FREE)
def test_file_free_scene_renders_through_the_cli(name, tmp_path):
    out = str(tmp_path / f"{name}.png")
    rc = cli.main(["--scene", name, "--width", "12", "--height", "10", "--spp", "4",
                   "--max-depth", "8", "--device", "cpu", "--out", out, "--quiet"])
    assert rc == 0
    img = chip_smoke._read_png(out)
    assert img.shape == (10, 12, 3) and img.max() > 0
