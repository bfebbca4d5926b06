"""Thin-lens camera and batched ray generation (PyTorch).

Counterpart of ``raytracer2022_tpu/render/camera.py`` (reference
raytracer/src/basic/camera.rs): ``make_camera`` mirrors ``Camera::new``
(camera.rs:24-62), ``get_rays`` mirrors ``Camera::get_ray``
(camera.rs:64-73) over a whole wavefront.  Every field is a tensor, the
JAX package's ten leaves, so a fit can step them all, and ``make_camera``
is differentiable in its look-at inputs.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..ops.sampling import uniform, uniform_in_unit_disk
from ..ops.vecmath import cross, to_unit
from ..utils.device import DEFAULT_DEVICE, resolve_device


@dataclasses.dataclass(frozen=True)
class Camera:
    origin: torch.Tensor  # f32[3]
    lower_left: torch.Tensor  # f32[3]
    horizontal: torch.Tensor  # f32[3]
    vertical: torch.Tensor  # f32[3]
    u: torch.Tensor  # f32[3]
    v: torch.Tensor  # f32[3]
    w: torch.Tensor  # f32[3]
    lens_radius: torch.Tensor  # f32[]
    time0: torch.Tensor  # f32[]
    time1: torch.Tensor  # f32[]


def make_camera(
    lookfrom,
    lookat,
    vup,
    vfov: float,
    aspect_ratio: float,
    aperture: float = 0.0,
    focus_dist: float = 1.0,
    time0: float = 0.0,
    time1: float = 1.0,
    device=DEFAULT_DEVICE,
) -> Camera:
    """Camera::new (camera.rs:24-62), in float32 like the JAX package.
    ``vup`` may be non-unit.  On the card unless ``device`` says otherwise
    (without a card it raises).  Tensor inputs that require grad (say
    ``lookfrom``) keep their graph: the leaves are differentiable in them."""
    device = resolve_device(device)

    def f32(x):
        return x.float() if torch.is_tensor(x) else torch.as_tensor(x, dtype=torch.float32)

    lookfrom = f32(lookfrom)
    lookat = f32(lookat)
    vup = f32(vup)
    theta = f32(vfov) * (math.pi / 180.0)
    h = torch.tan(theta / 2.0)
    viewport_height = 2.0 * h
    viewport_width = aspect_ratio * viewport_height

    w = to_unit(lookfrom - lookat)
    u = to_unit(cross(vup, w))
    v = cross(w, u)

    origin = lookfrom
    horizontal = u * viewport_width * focus_dist
    vertical = v * viewport_height * focus_dist
    lower_left = origin - horizontal / 2.0 - vertical / 2.0 - w * focus_dist

    def on(x):
        return x.to(device)

    return Camera(
        origin=on(origin),
        lower_left=on(lower_left),
        horizontal=on(horizontal),
        vertical=on(vertical),
        u=on(u),
        v=on(v),
        w=on(w),
        lens_radius=on(f32(aperture) / 2.0),
        time0=on(f32(time0)),
        time1=on(f32(time1)),
    )


def get_rays(cam: Camera, s: torch.Tensor, t: torch.Tensor, gen: torch.Generator):
    """Camera::get_ray (camera.rs:64-73) for a batch of (s, t) in [0, 1]
    -> (origins (3,N), directions (3,N), times (N,)).  Defocus uses the
    closed-form disk sampler; shutter time is uniform in [time0, time1)."""
    n = s.shape[0]
    rd = uniform_in_unit_disk(gen, (n,)) * cam.lens_radius
    offset = cam.u[:, None] * rd[0][None] + cam.v[:, None] * rd[1][None]
    o = cam.origin[:, None] + offset
    d = (
        cam.lower_left[:, None]
        + cam.horizontal[:, None] * s[None]
        + cam.vertical[:, None] * t[None]
        - cam.origin[:, None]
        - offset
    )
    tm = cam.time0 + (cam.time1 - cam.time0) * uniform(gen, (n,))
    return o, d, tm
