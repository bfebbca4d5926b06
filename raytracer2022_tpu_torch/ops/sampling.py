"""Closed-form batched samplers on component-leading ``(3, *batch)`` tensors.

Counterpart of ``raytracer2022_tpu/ops/sampling.py``: the same closed-form
transforms of uniform variates (the reference's rejection loops,
raytracer/src/basic/vec.rs:69-106, draw the same distributions).  The
``uniform*`` samplers take an explicit ``torch.Generator`` and draw on its
device with ``torch.rand``; the ``*_local`` forms transform variates that
the caller drew; there is no global RNG state.
"""

from __future__ import annotations

import math

import torch

from .vecmath import dot, masked_sqrt, scale, to_unit, vec3

PI = math.pi


def uniform(gen: torch.Generator, shape, lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
    """U[lo, hi) variates of ``shape`` on the generator's device."""
    u = torch.rand(shape, generator=gen, device=gen.device)
    if lo == 0.0 and hi == 1.0:
        return u
    return lo + (hi - lo) * u


def on_unit_sphere_local(uz: torch.Tensor, uphi: torch.Tensor) -> torch.Tensor:
    """Uniform direction on the unit sphere, via the z/phi closed form, of
    the U[0, 1) variates ``uz``, ``uphi``."""
    z = -1.0 + 2.0 * uz
    phi = 2.0 * PI * uphi
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    return vec3(r * torch.cos(phi), r * torch.sin(phi), z)


def in_unit_ball_local(uz: torch.Tensor, uphi: torch.Tensor, ur: torch.Tensor) -> torch.Tensor:
    """Uniform point in the unit ball (vec.rs:69-76) of the U[0, 1)
    variates ``uz``, ``uphi``, ``ur``: ``ur^(1/3)`` radius times the
    direction :func:`on_unit_sphere_local` gives."""
    return scale(on_unit_sphere_local(uz, uphi), ur ** (1.0 / 3.0))


def uniform_in_unit_disk(gen, shape) -> torch.Tensor:
    """Uniform point in the unit XY disk, z=0 (vec.rs:88-96)."""
    r = torch.sqrt(uniform(gen, shape))
    phi = uniform(gen, shape, 0.0, 2.0 * PI)
    return vec3(r * torch.cos(phi), r * torch.sin(phi), torch.zeros_like(r))


def cosine_local(r1: torch.Tensor, r2: torch.Tensor) -> torch.Tensor:
    """Cosine-weighted hemisphere direction about +z (pdf.rs:12-21) of the
    U[0, 1) variates ``r1``, ``r2``."""
    z = torch.sqrt(1.0 - r2)
    phi = 2.0 * PI * r1
    sq_r2 = torch.sqrt(r2)
    return vec3(torch.cos(phi) * sq_r2, torch.sin(phi) * sq_r2, z)


def sphere_cone_local(r1, r2, radius: torch.Tensor, dist_sqr: torch.Tensor) -> torch.Tensor:
    """Cone sample toward a sphere of ``radius`` at squared distance
    ``dist_sqr``, in the frame whose +z points at its center
    (vec.rs:108-117), of the U[0, 1) variates ``r1``, ``r2``."""
    rel = 1.0 - radius * radius / dist_sqr
    cos_max = torch.where(rel > 0.0, masked_sqrt(rel, rel > 0.0), 0.0)
    z = 1.0 + r2 * (cos_max - 1.0)
    phi = 2.0 * PI * r1
    zz = 1.0 - z * z
    s = torch.where(zz > 0.0, masked_sqrt(zz, zz > 0.0), 0.0)
    return vec3(torch.cos(phi) * s, torch.sin(phi) * s, z)


def cos_pdf_value(direction: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Cosine-hemisphere pdf of ``direction`` about unit axis ``w``
    (CosPdf::value, pdf.rs:46-53)."""
    cos = dot(to_unit(direction), w)
    return torch.where(cos <= 0.0, 0.0, cos / PI)
