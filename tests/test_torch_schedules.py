"""The regeneration schedules of the port: exact per-pixel sample counts of
the pixel pool and the quota schedule through their N/4 -> N/16 drains,
the ray sort (key bit-equal to the JAX package's, pixel regroup), and the
fixed-depth ``trace`` against ``trace_regen``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer2022_tpu.ops import sort as jsort
from raytracer2022_tpu_torch.ops import sort as tsort
from raytracer2022_tpu_torch.render import renderer as R
from raytracer2022_tpu_torch.render.camera import make_camera
from raytracer2022_tpu_torch.render.integrator import Schedule, TraceConfig, trace_regen
from raytracer2022_tpu_torch.scene.builder import SceneBuilder

torch.set_num_threads(1)

EMIT = (1.5, 2.0, 2.5)


def _dome(mirrors: bool, tree: bool = False):
    """An emissive dome seen from inside: every sample contributes exactly
    EMIT.  Albedo-1 mirrors make paths bounce 0 to ~6 times, so lanes finish
    at different iterations; ``tree`` adds 600 small spheres of the same
    emission beyond the mirrors, a SPHERE cluster tree (so the sort runs)."""
    b = SceneBuilder()
    emit = b.diffuse_light(EMIT)
    dome = b.sphere((0, 0, 0), 50, emit)
    b.flip_face(dome)
    if mirrors:
        mirror = b.metal((1.0, 1.0, 1.0), 0.0)
        b.rect_yz(-10, 10, -20, 0, -1, mirror)
        b.rect_yz(-10, 10, -20, 0, 1, mirror)
    if tree:
        rng = np.random.default_rng(0)
        for c in rng.uniform((-12, -12, -45), (12, 12, -25), (600, 3)):
            b.sphere(c, 0.4, emit)
    return b.finalize(device="cpu")


CAM = dict(lookfrom=(0, 0, 0), lookat=(0, 0, -1), vup=(0, 1, 0), vfov=60, aspect_ratio=1.0)


def _assert_exact_emission(img, n_samples):
    img = img.numpy() / n_samples
    for c, e in enumerate(EMIT):
        np.testing.assert_allclose(img[c], e, rtol=1e-6)


@pytest.mark.parametrize("schedule", [Schedule.PIXEL, Schedule.QUOTA])
@pytest.mark.parametrize("mirrors", [False, True])
def test_counts_exact_through_the_drains(schedule, mirrors):
    """8192 lanes (the drains' threshold), 40 sequential samples: the pixel
    mean equals the emission iff no sample is dropped, duplicated or
    misrouted by the pool, the leftover-quota split or the drains."""
    cfg = TraceConfig(max_depth=16, background=(0.0, 0.0, 0.0))
    img, iters = R.render_batch_regen(
        _dome(mirrors), make_camera(**CAM, device="cpu"), R.step_generator(11, 0, "cpu"), 32, 32, 8, 40, cfg,
        return_iters=True, schedule=schedule,
    )
    _assert_exact_emission(img, 8 * 40)
    assert iters["pool"] >= 40  # at least one vertex per sample
    if mirrors:
        assert iters["drain_n4"] + iters["drain_n16"] > 0  # the drains ran


def test_pixel_pool_is_the_default_above_32_sequential_samples():
    cfg = TraceConfig(max_depth=4, background=(0.0, 0.0, 0.0))
    img = R.render_batch_regen(_dome(False), make_camera(**CAM, device="cpu"), R.step_generator(1, 0, "cpu"),
                               8, 8, 2, 33, cfg)
    _assert_exact_emission(img, 2 * 33)


def test_sorted_quota_counts_exact():
    """The sort runs on a scene with a tree at N >= 2048 lanes: every lane
    still completes its quota and the regroup returns each pixel its own
    spp_par * spp_seq samples."""
    scene = _dome(True, tree=True)
    assert scene.use_bvh
    cfg = TraceConfig(max_depth=50, background=(0.0, 0.0, 0.0), sort_rays=True)
    img, iters = R.render_batch_regen(
        scene, make_camera(**CAM, device="cpu"), R.step_generator(2, 0, "cpu"), 16, 16, 8, 6, cfg,
        return_iters=True,
    )
    _assert_exact_emission(img, 8 * 6)
    assert iters["drain_n4"] == 0  # the sort path has no drains


def _pixel_scene():
    """A dome whose emission is a checker texture: each direction has its
    own value, so a misrouted sample changes a pixel."""
    b = SceneBuilder()
    dome = b.sphere((0, 0, 0), 50, b.diffuse_light(b.checker((0.2, 0.9, 0.4), (3.0, 1.0, 0.5))))
    b.flip_face(dome)
    rng = np.random.default_rng(1)
    for c in rng.uniform((-12, -12, -45), (12, 12, -25), (600, 3)):
        b.sphere(c, 0.4, b.diffuse_light((0.7, 0.7, 0.7)))
    return b.finalize(device="cpu")


def test_sort_regroup_returns_every_pixel_its_own_samples():
    """Deterministic camera rays (no jitter) make each pixel's samples
    identical, so the sorted render must equal the unsorted one lane for
    lane: lane l carries pixel l % n_pix after the regroup."""
    scene = _pixel_scene()
    n_pix, spp_par = 256, 8
    pix0 = torch.arange(n_pix * spp_par) % n_pix

    def gen_rays(gen, pix):
        x = (pix % 16).float() / 15.0 - 0.5
        y = torch.div(pix, 16, rounding_mode="floor").float() / 15.0 - 0.5
        d = torch.stack([x, y, -torch.ones_like(x)])
        return torch.zeros_like(d), d, torch.zeros_like(x)

    out = {}
    for sort in (False, True):
        cfg = TraceConfig(max_depth=8, background=(0.0, 0.0, 0.0), sort_rays=sort)
        out[sort] = trace_regen(scene, gen_rays, pix0, 4, torch.Generator().manual_seed(0), cfg,
                                spp_par=spp_par, schedule=Schedule.QUOTA)
    ref, got = out[False].numpy(), out[True].numpy()
    assert len(np.unique(ref[0])) > 2  # pixels differ
    np.testing.assert_allclose(got, ref, rtol=1e-6)


def test_ray_sort_key_is_bit_equal_to_jax():
    rng = np.random.default_rng(4)
    n = 4096
    o = rng.uniform(-300, 900, (3, n)).astype(np.float32)
    d = rng.normal(size=(3, n)).astype(np.float32)
    o[:, :8] = [[np.nan], [np.inf], [-np.inf]]  # non-finite origins
    o[:, 8:16] = 1e6  # parked dead lanes
    o[:, 16:24] = -1e30
    d[:, 24:32] = 0.0  # -0/+0 compare >= 0
    d[:, 32:40] = -0.0
    # the library's Cornell bounds, and a box flat on y (scale 0 there)
    for bmin, bmax in (((0.0, 0.0, 0.0), (555.0, 555.0, 555.0)), ((-1.0, 5.0, 2.0), (1.0, 5.0, 3.0))):
        ref = np.asarray(jsort.ray_sort_key(jnp.asarray(o), jnp.asarray(d), bmin, bmax))
        got = tsort.ray_sort_key(torch.as_tensor(o), torch.as_tensor(d), bmin, bmax).numpy()
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, ref)
        assert len(np.unique(got)) > 40


def test_sort_by_key_applies_one_permutation_to_every_payload():
    key = torch.as_tensor(np.random.default_rng(5).integers(0, 1000, 257))
    a = torch.arange(257.0)
    vec = torch.stack([a, 2 * a, 3 * a])
    k2, a2, v2 = tsort.sort_by_key(key, (key, a, vec))
    assert (k2[1:] >= k2[:-1]).all()
    np.testing.assert_array_equal(v2.numpy(), np.stack([a2, 2 * a2, 3 * a2]))
    assert sorted(a2.tolist()) == list(range(257))


def _lit_scene():
    b = SceneBuilder()
    light = b.rect_xz(-1, 1, -1, 1, 3.9, b.diffuse_light((8.0, 8.0, 8.0)))
    b.flip_face(light)
    b.add_light(light)
    b.rect_xz(-4, 4, -4, 4, 0.0, b.lambertian((0.6, 0.4, 0.3)))
    b.rect_xy(-4, 4, 0, 4, 3.0, b.metal((0.8, 0.8, 0.8), 0.3))  # behind the light
    return b.finalize(device="cpu"), make_camera((0, 2, -8), (0, 1, 0), (0, 1, 0), 40, 1.0, device="cpu")


def test_trace_matches_trace_regen_in_distribution():
    """The fixed-depth trace and the regeneration integrator run the same
    per-sample estimator: at 16x16 x 64 spp their channel means agree
    within 5 standard errors of the difference (from per-pixel variance),
    and their per-pixel gap is no larger than two regen seeds' gap."""
    scene, cam = _lit_scene()
    cfg = TraceConfig(max_depth=8, background=(0.0, 0.0, 0.0))
    fixed = R.render_batch(scene, cam, 0, 16, 16, 64, cfg).numpy() / 64
    regen = [
        R.render_batch_regen(scene, cam, R.step_generator(s, 0, "cpu"), 16, 16, 4, 16, cfg).numpy() / 64
        for s in (1, 2)
    ]
    assert np.isfinite(fixed).all() and fixed.mean() > 0.05
    se = np.sqrt((fixed.var(axis=(1, 2)) + regen[0].var(axis=(1, 2))) / 256)
    assert (np.abs(fixed.mean(axis=(1, 2)) - regen[0].mean(axis=(1, 2))) < 5 * se).all()
    gap = np.abs(fixed - regen[0]).mean()
    noise = np.abs(regen[1] - regen[0]).mean()
    assert gap < 1.3 * noise, (gap, noise)


def test_render_sum_n_fixed_depth_launches():
    """regen=False: ceil(spp / batch) launches of render_batch, each seeded
    from (seed, launch), and the sample count they return."""
    scene, cam = _lit_scene()
    cfg = R.RenderConfig(width=8, height=6, spp=10, max_depth=4, background=(0.0, 0.0, 0.0),
                         regen=False, spp_per_batch=4)
    log: list = []
    total, n = R.render_sum_n(scene, cam, cfg, launch_log=log)
    assert n == 12 and len(log) == 3 and log[0]["lanes"] == 8 * 6 * 4
    again, _ = R.render_sum_n(scene, cam, cfg)
    np.testing.assert_array_equal(total.numpy(), again.numpy())
    tcfg = cfg.trace_cfg()
    parts = sum(R.render_batch(scene, cam, R.derive_seed(0, i), 8, 6, 4, tcfg) for i in range(3))
    np.testing.assert_allclose(total.numpy(), parts.numpy(), rtol=1e-6)
