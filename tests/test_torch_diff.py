"""The differentiable regeneration integrator: its estimator, its trip-count
estimate, the checkpoint replay, and its expected gradient against the JAX
package's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer2022_tpu import make_camera as jax_make_camera
from raytracer2022_tpu.render.integrator import TraceConfig as JaxTraceConfig
from raytracer2022_tpu.render.renderer import render_batch_regen_diff as jax_render_batch_regen_diff
from raytracer2022_tpu.scene.builder import SceneBuilder as JaxBuilder
from raytracer2022_tpu_torch.render import integrator as I
from raytracer2022_tpu_torch.render.camera import make_camera
from raytracer2022_tpu_torch.render.integrator import TraceConfig, trace_regen_diff
from raytracer2022_tpu_torch.render.renderer import (
    _regen_gen_rays,
    regen_iters_estimate,
    render_batch,
    render_batch_regen_diff,
)
from raytracer2022_tpu_torch.scene.builder import SceneBuilder

torch.set_num_threads(1)


def _metal_scene():
    """tests/test_integrator.py's scene: a light, a floor, a fuzzy metal sphere."""
    b = SceneBuilder()
    light = b.rect_xz(-1, 1, -1, 1, 3, b.diffuse_light((8.0, 8.0, 8.0)))
    b.flip_face(light)
    b.add_light(light)
    b.rect_xz(-4, 4, -4, 4, 0, b.lambertian((0.6, 0.5, 0.4)))
    b.sphere((0, 1, 0), 0.7, b.metal((0.8, 0.8, 0.8), 0.1))
    return b.finalize(device="cpu"), make_camera((0, 2, -6), (0, 1, 0), (0, 1, 0), 45, 1.0, device="cpu")


def _mini_cornell(builder, device=None):
    b = builder
    light = b.rect_xz(-1, 1, -1, 1, 3.9, b.diffuse_light((8.0, 8.0, 8.0)))
    b.flip_face(light)
    b.add_light(light)
    b.rect_xz(-4, 4, -4, 4, 0.0, b.lambertian((0.6, 0.4, 0.3)))
    b.sphere((0, 1, 0), 1, b.lambertian((0.3, 0.5, 0.7)))
    return b.finalize() if device is None else b.finalize(device=device)


MINI_CAM = dict(lookfrom=(0, 2, -8), lookat=(0, 1, 0), vup=(0, 1, 0), vfov=40, aspect_ratio=1.0)


@pytest.mark.parametrize("mode", ["pooled", "quota"])
def test_exact_bound_completes_every_sample_and_matches_trace(mode):
    """With n_iters = spp_seq * max_depth + 1 every sample ends: each
    pixel counts exactly its samples, and the image means agree with the
    fixed-depth trace within tests/test_integrator.py's bounds."""
    scene, cam = _metal_scene()
    cfg = TraceConfig(max_depth=16, background=(0.0, 0.0, 0.0))
    spp = 64
    with torch.no_grad():
        a = render_batch(scene, cam, 3, 24, 24, spp, cfg).numpy() / spp
        if mode == "pooled":
            img, cnt = render_batch_regen_diff(scene, cam, 3, 24, 24, 8, spp // 8, 8 * 16 + 1, cfg)
            img, cnt = img.numpy(), cnt.numpy()
        else:
            n = 24 * 24 * 8
            pix0 = torch.arange(n) % (24 * 24)
            rad, done = trace_regen_diff(scene, _regen_gen_rays(cam, 24, 24), pix0, 8, 8 * 16 + 1, 3, cfg)
            img = rad.reshape(3, 8, 24, 24).sum(dim=1).numpy()
            cnt = done.reshape(8, 24, 24).sum(dim=0).numpy()
    np.testing.assert_array_equal(cnt, spp)
    r = img / spp
    np.testing.assert_allclose(a.mean(), r.mean(), rtol=0.05)
    np.testing.assert_allclose(a.mean(axis=(1, 2)), r.mean(axis=(1, 2)), rtol=0.08)


def test_drain_only_adds_samples_and_keeps_the_mean():
    """tests/test_grad.py:278-300: the drain arm against the same budget
    without it.  The first 20 iterations are identical (same seed, same
    schedule), the drain only completes samples that truncation drops."""
    scene = _mini_cornell(SceneBuilder(), "cpu")
    cam = make_camera(**MINI_CAM, device="cpu")
    cfg = TraceConfig(max_depth=6, background=(0.0, 0.0, 0.0))
    with torch.no_grad():
        img1, cnt1 = render_batch_regen_diff(scene, cam, 3, 12, 12, 4, 8, 20, cfg, n_drain=6)
        img0, cnt0 = render_batch_regen_diff(scene, cam, 3, 12, 12, 4, 8, 20, cfg)
    cnt1, cnt0 = cnt1.numpy(), cnt0.numpy()
    m1 = img1.numpy() / np.maximum(cnt1, 1)
    m0 = img0.numpy() / np.maximum(cnt0, 1)
    assert cnt1.mean() > 0.95 * 32
    assert (cnt1 >= cnt0).all() and (cnt1 > cnt0).any()
    np.testing.assert_allclose(m1.mean(), m0.mean(), rtol=2e-2)


def _mirror_dome(facing: bool):
    """An emissive dome seen from inside with albedo-1 mirrors: every
    sample that ends on the dome carries exactly its emission.  ``facing``:
    two large parallel mirrors with the camera between them looking at one,
    so paths run long (many reach the depth cap)."""
    b = SceneBuilder()
    dome = b.sphere((0, 0, 0), 50, b.diffuse_light((1.5, 2.0, 2.5)))
    b.flip_face(dome)
    mirror = b.metal((1.0, 1.0, 1.0), 0.0)
    if facing:
        b.rect_yz(-10, 10, -10, 10, -1, mirror)
        b.rect_yz(-10, 10, -10, 10, 1, mirror)
        cam = make_camera((0, 0, 0), (1, 0, 0), (0, 1, 0), 60, 1.0, device="cpu")
    else:
        b.rect_yz(-10, 10, -20, 0, -1, mirror)
        b.rect_yz(-10, 10, -20, 0, 1, mirror)
        cam = make_camera((0, 0, 0), (0, 0, -1), (0, 1, 0), 60, 1.0, device="cpu")
    return b.finalize(device="cpu"), cam


def test_drain_cascade_at_16384_lanes():
    """64x64 x 4 lanes run both drain stages (N/4 for 8 iterations, then
    N/16).  Short paths: every pixel's mean is exactly the emission, so no
    finished sample was dropped, doubled or sent to another lane.  Long
    paths: the N/16 stage completes samples the N/4 stage left."""
    scene, cam = _mirror_dome(False)
    cfg = TraceConfig(max_depth=16, background=(0.0, 0.0, 0.0))
    with torch.no_grad():
        img, cnt = render_batch_regen_diff(scene, cam, 5, 64, 64, 4, 2, 4, cfg, n_drain=12)
    cnt = cnt.numpy()
    assert cnt.min() >= 1
    np.testing.assert_allclose(img.numpy() / cnt, np.broadcast_to(np.array([1.5, 2.0, 2.5])[:, None, None],
                                                                 (3, 64, 64)), rtol=1e-6)
    scene, cam = _mirror_dome(True)
    with torch.no_grad():
        cnts = [render_batch_regen_diff(scene, cam, 5, 64, 64, 4, 2, 12, cfg, n_drain=nd)[1].numpy()
                for nd in (0, 8, 16)]
    assert (cnts[1] >= cnts[0]).all() and (cnts[2] >= cnts[1]).all()
    assert cnts[2].sum() > cnts[1].sum() > cnts[0].sum()


@pytest.mark.parametrize("split_drain", [False, True])
def test_regen_iters_estimate(split_drain):
    """Both forms stay below the exact bound and complete at least 99% of
    the samples (tests/test_integrator.py:162-191)."""
    b = SceneBuilder()
    light = b.rect_xz(-1, 1, -1, 1, 3, b.diffuse_light((8.0, 8.0, 8.0)))
    b.flip_face(light)
    b.add_light(light)
    b.rect_xz(-4, 4, -4, 4, 0, b.lambertian((0.6, 0.5, 0.4)))
    scene = b.finalize(device="cpu")
    cam = make_camera((0, 2, -6), (0, 1, 0), (0, 1, 0), 45, 1.0, device="cpu")
    cfg = TraceConfig(max_depth=16, background=(0.0, 0.0, 0.0))
    est = regen_iters_estimate(scene, cam, 16, 16, 4, 8, cfg, split_drain=split_drain)
    n_iters, n_drain = est if split_drain else (est, 0)
    assert n_iters < 8 * 16 + 1
    assert n_drain == (cfg.max_depth if split_drain else 0)
    with torch.no_grad():
        _, cnt = render_batch_regen_diff(scene, cam, 3, 16, 16, 4, 8, n_iters, cfg, n_drain=n_drain)
    assert cnt.min() > 0 and cnt.sum() >= 0.99 * 16 * 16 * 32


@pytest.mark.parametrize("integrator", ["regen_diff", "trace"])
def test_checkpoint_replay_is_bit_exact(integrator, monkeypatch):
    """The generator rule: each checkpointed iteration builds its generator
    from the seed and its step, so the backward's recompute replays the
    same numbers and the gradients equal, bit for bit, those of the same
    computation kept whole.  A segment drawing from a generator passed in
    would replay other numbers and give other gradients."""
    scene = _mini_cornell(SceneBuilder(), "cpu")
    cam = make_camera(**MINI_CAM, device="cpu")
    cfg = TraceConfig(max_depth=6, background=(0.0, 0.0, 0.0))

    def grads():
        color = scene.textures.color.clone().requires_grad_()
        param = scene.materials.param.clone().requires_grad_()
        s = dataclasses.replace(scene, textures=dataclasses.replace(scene.textures, color=color),
                                materials=dataclasses.replace(scene.materials, param=param))
        if integrator == "regen_diff":
            img, cnt = render_batch_regen_diff(s, cam, 3, 12, 12, 4, 8, 16, cfg, n_drain=6)
            loss = torch.mean(img / torch.clamp(cnt, min=1)[None])
        else:
            loss = torch.mean(render_batch(s, cam, 3, 12, 12, 8, cfg))
        return torch.autograd.grad(loss, (color, param), allow_unused=True)

    calls = []
    replay = I._checkpointed
    monkeypatch.setattr(I, "_checkpointed", lambda fn, *a: calls.append(1) or replay(fn, *a))
    with_ckpt = grads()
    assert len(calls) >= 6  # every bounce or iteration went through the checkpoint
    monkeypatch.setattr(I, "_checkpointed", lambda fn, *a: fn(*a))
    whole = grads()
    assert torch.isfinite(with_ckpt[0]).all() and with_ckpt[0].abs().max() > 0
    for a, b in zip(with_ckpt, whole):
        if a is None:
            assert b is None
        else:
            assert torch.equal(a, b)


def test_expected_gradient_matches_jax():
    """Mini-cornell 12x12 at the exact trip bound: the albedo and emission
    gradients of mean(img / counts), averaged over 4 seeds in each package,
    agree within 5 standard errors of the seeds' spread (the random
    streams differ, so the gradients agree in expectation only)."""
    seeds = 4
    cfg = TraceConfig(max_depth=6, background=(0.0, 0.0, 0.0))
    scene = _mini_cornell(SceneBuilder(), "cpu")
    cam = make_camera(**MINI_CAM, device="cpu")
    floor_tex, light_tex = int(scene.materials.tex[1]), int(scene.materials.tex[0])
    entries = [(0, floor_tex), (1, floor_tex), (1, light_tex)]

    def torch_grad(seed):
        color = scene.textures.color.clone().requires_grad_()
        s = dataclasses.replace(scene, textures=dataclasses.replace(scene.textures, color=color))
        img, cnt = render_batch_regen_diff(s, cam, seed, 12, 12, 4, 8, 8 * 6 + 1, cfg)
        (g,) = torch.autograd.grad(torch.mean(img / cnt[None]), color)
        return np.array([float(g[e]) for e in entries])

    js = _mini_cornell(JaxBuilder())
    jcam = jax_make_camera(**MINI_CAM)
    jcfg = JaxTraceConfig(max_depth=6, background=(0.0, 0.0, 0.0))

    @jax.jit
    def jax_grad(color, key):
        def f(c):
            img, cnt = jax_render_batch_regen_diff(js.replace(textures=js.textures.replace(color=c)), jcam, key,
                                                   12, 12, 4, 8, 8 * 6 + 1, jcfg)
            return jnp.mean(img / cnt[None])

        return jax.grad(f)(color)

    g_t = np.stack([torch_grad(s) for s in range(seeds)])
    g_j = np.stack([np.asarray(jax_grad(js.textures.color, jax.random.PRNGKey(s)))[tuple(zip(*entries))]
                    for s in range(seeds)])
    assert np.isfinite(g_t).all() and (g_t > 0).all() and (g_j > 0).all()
    se = np.sqrt(g_t.var(axis=0, ddof=1) / seeds + g_j.var(axis=0, ddof=1) / seeds)
    z = (g_t.mean(axis=0) - g_j.mean(axis=0)) / se
    assert (np.abs(z) < 5).all(), (g_t.mean(axis=0), g_j.mean(axis=0), z)
