"""The single-device fit step and the fit demo on the CPU."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from raytracer2022_tpu_torch import fit  # noqa: E402
from raytracer2022_tpu_torch.parallel.mesh import CAMERA_LEAVES, fit_step_fn, with_params  # noqa: E402
from raytracer2022_tpu_torch.render.camera import Camera, make_camera  # noqa: E402
from raytracer2022_tpu_torch.render.renderer import RenderConfig, render_batch  # noqa: E402
from raytracer2022_tpu_torch.scene.builder import SceneBuilder  # noqa: E402

torch.set_num_threads(1)


def _mini_cornell():
    b = SceneBuilder()
    light = b.rect_xz(-1, 1, -1, 1, 3.9, b.diffuse_light((8.0, 8.0, 8.0)))
    b.flip_face(light)
    b.add_light(light)
    b.rect_xz(-4, 4, -4, 4, 0.0, b.lambertian((0.6, 0.4, 0.3)))
    b.sphere((0, 1, 0), 1, b.metal((0.7, 0.5, 0.3), 0.2))
    return b.finalize(device="cpu"), make_camera((0, 2, -8), (0, 1, 0), (0, 1, 0), 40, 1.0, device="cpu")


CFG = RenderConfig(width=8, height=8, spp=8, max_depth=4, background=(0.0, 0.0, 0.0))


@pytest.mark.parametrize("regen_iters", [None, 4 * 4 + 1])
def test_fit_step_is_one_sgd_step(regen_iters):
    """One step at 8x8 moves materials.param, textures.color and the ten
    camera leaves by exactly -lr * their gradient of the MSE (zero for a
    leaf the render does not reach), and returns the loss before it."""
    scene, cam = _mini_cornell()
    target = torch.full((3, 8, 8), 0.3)
    lr = 0.05
    step = fit_step_fn(CFG, lr=lr, regen_iters=regen_iters)
    s2, c2, loss = step(scene, cam, target, 5)

    # the same loss, differentiated here
    leaves = [scene.materials.param, scene.textures.color] + [getattr(cam, f) for f in CAMERA_LEAVES]
    leaves = [x.clone().requires_grad_() for x in leaves]
    s, c = with_params(scene, *leaves[:2]), Camera(*leaves[2:])
    if regen_iters is None:
        img = render_batch(s, c, 5, 8, 8, CFG.spp, CFG.trace_cfg()) / CFG.spp
    else:
        from raytracer2022_tpu_torch.render.renderer import render_batch_regen_diff

        img, cnt = render_batch_regen_diff(s, c, 5, 8, 8, 1, 8, regen_iters, CFG.trace_cfg())
        img = img / torch.clamp(cnt, min=1)[None]
    ref_loss = torch.mean((img - target) ** 2)
    grads = torch.autograd.grad(ref_loss, leaves, allow_unused=True)
    assert torch.equal(loss, ref_loss.detach())
    new = [s2.materials.param, s2.textures.color] + [getattr(c2, f) for f in CAMERA_LEAVES]
    for x, g, y in zip(leaves, grads, new):
        expect = x.detach() if g is None else x.detach() - lr * g
        assert torch.equal(y, expect)
        assert not y.requires_grad
    assert float(grads[1].abs().max()) > 0 and float(grads[0].abs().max()) > 0  # albedo and fuzz
    assert grads[2] is not None and float(grads[2].abs().max()) > 0  # the camera origin
    assert c2.lens_radius.shape == () and c2.time0.dtype == torch.float32


def test_fit_steps_lower_the_loss():
    """Five steps with a fixed seed, from a halved floor albedo toward a
    target render of the true scene, lower the loss tenfold.  The scene is
    smooth in every leaf (a uniform floor under an edgeless emissive dome,
    no silhouette in view), so plain SGD descends."""
    b = SceneBuilder()
    dome = b.sphere((0, 0, 0), 50, b.diffuse_light((2.0, 2.0, 2.0)))
    b.flip_face(dome)
    b.rect_xz(-30, 30, -30, 30, 0.0, b.lambertian((0.6, 0.4, 0.3)))
    scene = b.finalize(device="cpu")
    cam = make_camera((0.0, 3.0, -2.0), (0.0, 0.0, -1.9), (0, 1, 0), 30, 1.0, device="cpu")
    with torch.no_grad():
        target = render_batch(scene, cam, 1, 8, 8, CFG.spp, CFG.trace_cfg()) / CFG.spp
    color = scene.textures.color.clone()
    color[:, int(scene.materials.tex[1])] *= 0.5  # the floor
    s = dataclasses.replace(scene, textures=dataclasses.replace(scene.textures, color=color))
    step = fit_step_fn(CFG, lr=0.2)
    losses = []
    for _ in range(5):
        s, cam, loss = step(s, cam, target, 1)
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert all(b < a for a, b in zip(losses, losses[1:])) and losses[-1] < 0.1 * losses[0], losses


def test_fit_demo_recovers(capsys):
    """The demo at 16x16 on the CPU (its default 64x64 is for the card),
    60 steps (its default) of 128 spp, recovers the perturbed albedos and
    emission: relative error below 0.2, exit code 0.  At 30 steps of 64
    spp the final error sits at the limit, whatever the random stream:
    0.203 +- 0.029 over 40 target seeds before the vertex drew one
    variate block (17 below 0.2), 0.212 +- 0.037 after (15); at 60 steps
    of 128 spp it reads 0.07-0.17 over target seeds 0-15."""
    rc = fit.main(["--size", "16", "--steps", "60", "--spp", "128", "--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()[-1]
    import json

    report = json.loads(out)
    assert rc == 0 and report["recovered"], report
    assert report["param_relerr_final"] < report["param_relerr_initial"]
