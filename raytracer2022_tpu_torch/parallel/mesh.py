"""The differentiable fit step on one device.

Counterpart of the single-device branch of
``raytracer2022_tpu/parallel/mesh.py::fit_step_fn`` (l. 178-244): render,
mean squared error against a target image, backpropagation through the
whole bounce loop, and one SGD step on the material and texture tables and
the camera.  The JAX module also shards renders and this step over a device
mesh, all-reducing the gradients; that part is not ported yet (ROADMAP.md,
Queue 1).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..render.camera import Camera
from ..render.renderer import RenderConfig, render_batch, render_batch_regen_diff
from ..scene.types import SceneData

CAMERA_LEAVES = tuple(f.name for f in dataclasses.fields(Camera))


def with_params(scene: SceneData, mat_param: torch.Tensor, tex_color: torch.Tensor) -> SceneData:
    """``scene`` with its material parameters and texture colours replaced."""
    return dataclasses.replace(
        scene,
        materials=dataclasses.replace(scene.materials, param=mat_param),
        textures=dataclasses.replace(scene.textures, color=tex_color),
    )


def fit_step_fn(cfg: RenderConfig, lr: float = 0.05, regen_iters: Optional[int] = None):
    """Fit-step factory -> ``step(scene, camera, target, seed) -> (scene',
    camera', loss)``.

    The step renders ``cfg.spp`` samples per pixel of ``cfg.width x
    cfg.height`` with the seed ``seed``, takes the MSE against ``target``
    (3, H, W), backpropagates, and applies SGD with rate ``lr`` to
    ``materials.param``, ``textures.color`` and the camera's ten leaves (a
    leaf the render does not reach has a zero gradient).  The loss
    renders with the fixed-depth :func:`render_batch`, or, with
    ``regen_iters``, with the differentiable regeneration integrator over
    that many iterations (:func:`renderer.regen_iters_estimate`).  The
    returned loss is the one before the step.
    """
    tcfg = cfg.trace_cfg()

    def loss_fn(scene, camera, target, seed):
        if regen_iters is not None:
            spp_par = max(1, cfg.spp // 8)
            spp_seq = -(-cfg.spp // spp_par)
            img, cnt = render_batch_regen_diff(
                scene, camera, seed, cfg.width, cfg.height, spp_par, spp_seq, regen_iters, tcfg
            )
            img = img / torch.clamp(cnt, min=1)[None]
        else:
            img = render_batch(scene, camera, seed, cfg.width, cfg.height, cfg.spp, tcfg) / float(cfg.spp)
        return torch.mean((img - target) ** 2)

    def step(scene: SceneData, camera: Camera, target: torch.Tensor, seed: int):
        leaves = [scene.materials.param, scene.textures.color] + [getattr(camera, f) for f in CAMERA_LEAVES]
        leaves = [x.detach().requires_grad_() for x in leaves]
        loss = loss_fn(with_params(scene, *leaves[:2]), Camera(*leaves[2:]), target, seed)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        with torch.no_grad():
            new = [x if g is None else x - lr * g for x, g in zip(leaves, grads)]
        new = [x.detach() for x in new]
        return with_params(scene, *new[:2]), Camera(*new[2:]), loss.detach()

    return step
