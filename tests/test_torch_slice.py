"""The forward slice end to end on the CPU: the regeneration integrator's
bookkeeping, the stand-in mesh render against the JAX package, checkpoint
resume, film and the CLI."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from raytracer2022_tpu.render.camera import make_camera as jax_make_camera
from raytracer2022_tpu.render.film import tonemap_u8 as jax_tonemap_u8
from raytracer2022_tpu.render.integrator import TraceConfig as JaxTraceConfig
from raytracer2022_tpu.render.renderer import render_batch_regen as jax_render_batch_regen
from raytracer2022_tpu.scene.builder import SceneBuilder as JaxBuilder
from raytracer2022_tpu_torch import cli
from raytracer2022_tpu_torch.render import renderer as R
from raytracer2022_tpu_torch.render.camera import make_camera
from raytracer2022_tpu_torch.render.film import tonemap_u8
from raytracer2022_tpu_torch.render.integrator import (
    Schedule,
    TraceConfig,
    choose_schedule,
    trace_regen,
)
from raytracer2022_tpu_torch.scene.builder import SceneBuilder
from raytracer2022_tpu_torch.utils.imageio import read_png

torch.set_num_threads(1)


def _dome(mirrors: bool):
    b = SceneBuilder()
    dome = b.sphere((0, 0, 0), 50, b.diffuse_light((1.5, 2.0, 2.5)))
    b.flip_face(dome)
    if mirrors:
        # a hall of albedo-1 mirrors: paths bounce 0 to ~6 times and still
        # carry exactly the emission, so lanes finish at different iterations
        mirror = b.metal((1.0, 1.0, 1.0), 0.0)
        b.rect_yz(-10, 10, -20, 0, -1, mirror)
        b.rect_yz(-10, 10, -20, 0, 1, mirror)
    return b.finalize(device="cpu")


@pytest.mark.parametrize(
    "mirror,w,h,spp_par,spp_seq",
    [(False, 16, 16, 4, 8), (False, 32, 32, 8, 4), (True, 32, 32, 8, 4)],
)
def test_regen_pool_counts_exact(mirror, w, h, spp_par, spp_seq):
    """Inside an emissive dome every sample contributes exactly the
    emission, so the pixel mean equals it iff no sample is dropped,
    duplicated or misrouted by the pool, the slot deposit, the narrow
    drains (8192 lanes) or the final regroup."""
    scene = _dome(mirror)
    cam = make_camera((0, 0, 0), (0, 0, -1), (0, 1, 0), 60, 1.0, device="cpu")
    cfg = TraceConfig(max_depth=16, background=(0.0, 0.0, 0.0))
    gen = R.step_generator(11, 0, "cpu")
    img, iters = R.render_batch_regen(
        scene, cam, gen, w, h, spp_par, spp_seq, cfg, return_iters=True
    )
    img = img.numpy() / (spp_par * spp_seq)
    np.testing.assert_allclose(img[0], 1.5, rtol=1e-6)
    np.testing.assert_allclose(img[1], 2.0, rtol=1e-6)
    np.testing.assert_allclose(img[2], 2.5, rtol=1e-6)
    if mirror:
        assert iters["drain_n4"] + iters["drain_n16"] > 0  # the drains ran


def test_stand_in_mesh_matches_jax_within_noise():
    """The stand-in mesh scene (576 triangles, a TRIANGLE tree) at 24x24 x
    32 spp through both packages.  The random streams differ, so the
    images agree within Monte-Carlo noise, as in tests/test_integrator.py."""
    jb, tb = JaxBuilder(), SceneBuilder()
    cam_kw = chip_smoke.stand_in_mesh_scene(jb, 24, 12)
    chip_smoke.stand_in_mesh_scene(tb, 24, 12)
    js, ts = jb.finalize(), tb.finalize(device="cpu")
    assert ts.bvh8[0] is not None
    jcfg = JaxTraceConfig(max_depth=50, background=(0.0, 0.0, 0.0))
    a = np.asarray(
        jax_render_batch_regen(js, jax_make_camera(**cam_kw), jax.random.PRNGKey(5),
                               24, 24, 4, 8, jcfg)
    ) / 32
    tcfg = TraceConfig(max_depth=50, background=(0.0, 0.0, 0.0))
    r = R.render_batch_regen(
        ts, make_camera(**cam_kw, device="cpu"), R.step_generator(5, 0, "cpu"), 24, 24, 4, 8, tcfg
    ).numpy() / 32
    assert np.isfinite(r).all() and r.mean() > 0.05
    np.testing.assert_allclose(r.mean(), a.mean(), rtol=0.05)
    np.testing.assert_allclose(r.mean(axis=(1, 2)), a.mean(axis=(1, 2)), rtol=0.08)


def _checkpoint_scene():
    b = SceneBuilder()
    light = b.rect_xz(-1, 1, -1, 1, 3.9, b.diffuse_light((8.0, 8.0, 8.0)))
    b.flip_face(light)
    b.add_light(light)
    b.rect_xz(-4, 4, -4, 4, 0.0, b.lambertian((0.6, 0.4, 0.3)))
    return b.finalize(device="cpu"), make_camera((0, 2, -8), (0, 1, 0), (0, 1, 0), 40, 1.0, device="cpu")


def test_render_checkpoint_resume(tmp_path, monkeypatch):
    """Interrupting after some launches and rerunning with the same
    configuration produces the identical image: each launch draws from a
    generator seeded by (seed, launch)."""
    scene, cam = _checkpoint_scene()
    cfg = R.RenderConfig(
        width=16, height=12, spp=64, max_depth=3, background=(0.0, 0.0, 0.0),
        spp_per_batch=1, max_rays_per_batch=16 * 4,  # 3 strips x 2 launches
    )
    ref, n_ref = R.render_sum_n(scene, cam, cfg)

    ckpt = str(tmp_path / "render.npz")
    orig = R.render_batch_regen
    calls = {"n": 0}

    def crashing(*a, **kw):
        calls["n"] += 1
        if calls["n"] > 3:
            raise RuntimeError("simulated interruption")
        return orig(*a, **kw)

    monkeypatch.setattr(R, "render_batch_regen", crashing)
    with pytest.raises(RuntimeError):
        R.render_sum_n(scene, cam, cfg, checkpoint=ckpt)
    monkeypatch.setattr(R, "render_batch_regen", orig)
    resumed = {"n": 0}

    def counting(*a, **kw):
        resumed["n"] += 1
        return orig(*a, **kw)

    monkeypatch.setattr(R, "render_batch_regen", counting)
    out, n = R.render_sum_n(scene, cam, cfg, checkpoint=ckpt)
    assert n == n_ref == 64
    assert resumed["n"] == 3  # only the launches after the interruption
    np.testing.assert_array_equal(out.numpy(), ref.numpy())

    # a different scene of the same size restarts instead of blending
    b = SceneBuilder()
    b.rect_xz(-4, 4, -4, 4, 0.0, b.lambertian((0.1, 0.1, 0.1)))
    resumed["n"] = 0
    R.render_sum_n(b.finalize(device="cpu"), cam, cfg, checkpoint=ckpt)
    assert resumed["n"] == 6


def test_schedule_choice_and_unported_schedules():
    """choose_schedule picks as the JAX package does, and every schedule,
    with and without the ray sort request, now runs: each keeps the
    per-lane contract (lane l carries pixel l % n_pix, and a pixel's lanes
    sum to its spp_par * spp_seq samples), exact on the emissive dome."""
    assert choose_schedule(32, 4) is Schedule.GLOBAL
    assert choose_schedule(33, 4) is Schedule.PIXEL
    assert choose_schedule(8, None) is Schedule.QUOTA
    scene = _dome(True)
    cam = make_camera((0, 0, 0), (0, 0, -1), (0, 1, 0), 60, 1.0, device="cpu")
    gen_rays = R._regen_gen_rays(cam, 8, 8)
    pix0 = torch.arange(128) % 64
    for sched in Schedule:
        for sort in (False, True):
            cfg = TraceConfig(max_depth=16, background=(0.0, 0.0, 0.0), sort_rays=sort)
            rad = trace_regen(scene, gen_rays, pix0, 4, torch.Generator().manual_seed(1), cfg,
                              spp_par=2, schedule=sched)
            assert rad.shape == (3, 128)
            per_pixel = rad.reshape(3, 2, 64).sum(dim=1).numpy() / 8
            np.testing.assert_allclose(per_pixel, np.broadcast_to(np.array([[1.5], [2.0], [2.5]]), (3, 64)),
                                       rtol=1e-6)


def test_tonemap_matches_jax():
    rng = np.random.default_rng(3)
    total = rng.uniform(0, 40, (3, 9, 7)).astype(np.float32)
    total[0, 0, 0] = np.nan
    total[1, 2, 3] = np.inf
    np.testing.assert_array_equal(
        tonemap_u8(torch.as_tensor(total), 16).numpy(), np.asarray(jax_tonemap_u8(jnp.asarray(total), 16))
    )


def test_cli_cpu_writes_png(tmp_path):
    out = str(tmp_path / "sub" / "cornell.png")
    rc = cli.main(["--scene", "cornell_box", "--width", "16", "--height", "16", "--spp", "4",
                   "--max-depth", "8", "--device", "cpu", "--out", out, "--quiet"])
    assert rc == 0 and os.path.exists(out)
    img = read_png(out)
    assert img.shape == (16, 16, 3) and img.dtype == np.uint8
    assert img.max() > 0


def test_cli_without_gpu_is_an_error(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit) as e:
        cli.main(["--scene", "cornell_box", "--out", str(tmp_path / "x.png"), "--quiet"])
    assert e.value.code != 0
    assert not os.path.exists(tmp_path / "x.png")
