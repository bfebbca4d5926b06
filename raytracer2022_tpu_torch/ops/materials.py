"""Batched material scatter / emission (PyTorch).

Counterpart of ``raytracer2022_tpu/ops/materials.py`` (reference
raytracer/src/material/mod.rs:15-231): one masked pass over the four
surface materials (lambertian, metal, dielectric, diffuse light), switching
on the integer material kind, plus the isotropic phase function of
constant media (material/mod.rs:207-213).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..scene.types import DIELECTRIC, DIFFUSE_LIGHT, ISOTROPIC, METAL
from .sampling import in_unit_ball_local
from .textures import eval_texture_shade
from .vecmath import dot, reflect, refract, scale, to_unit

PI = math.pi


@dataclasses.dataclass(frozen=True)
class Scatter:
    """SoA ScatterRecord (reference material/mod.rs:217-231)."""

    has_scatter: torch.Tensor  # bool[N]: False for DiffuseLight (absorbs)
    is_specular: torch.Tensor  # bool[N]: metal/dielectric/isotropic
    spec_dir: torch.Tensor  # f32[3, N]
    spec_time: torch.Tensor  # f32[N]
    attenuation: torch.Tensor  # f32[3, N]


def texture_value(tt, shade, hit, features: frozenset) -> torch.Tensor:
    """The winning primitive's texture value (3, N), shared by
    :func:`emitted` and :func:`scatter`."""
    return eval_texture_shade(tt, shade, hit.u, hit.v, hit.p, hit.tex_uv, features)


def emitted(shade, hit, tex_val: torch.Tensor) -> torch.Tensor:
    """DiffuseLight::emitted: the texture value on front faces only
    (material/mod.rs:174-180); every other kind emits black."""
    is_light = shade.mat_kind == DIFFUSE_LIGHT
    return torch.where((is_light & hit.front & hit.hit)[None], tex_val, 0.0)


def scatter(shade, hit, tex_val, d_in, tm, u: torch.Tensor) -> Scatter:
    """One masked pass implementing all five scatter functions, of the
    variates ``u`` f32[3, N] (U[0, 1)): metal's fuzz and the isotropic
    phase function take one ball sample of all three rows, the
    dielectric's reflect test the first (a lane has one material)."""
    kind = shade.mat_kind
    param = shade.mat_param
    n = hit.normal
    ball = in_unit_ball_local(u[0], u[1], u[2])

    # Metal (material/mod.rs:85-96): reflect + fuzz * in-ball jitter; the
    # scattered ray's time is 0 in the reference (mod.rs:92)
    unit_d = to_unit(d_in)
    metal_dir = reflect(unit_d, n) + scale(ball, param)

    # Dielectric (material/mod.rs:120-147), neutral IOR on other lanes
    ir = torch.where(kind == DIELECTRIC, param, 1.5)
    refraction_ratio = torch.where(hit.front, 1.0 / ir, ir)
    cos_theta = torch.clamp(dot(-unit_d, n), max=1.0)
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    cannot_refract = refraction_ratio * sin_theta > 1.0
    r0 = (1.0 - refraction_ratio) / (1.0 + refraction_ratio)
    r0 = r0 * r0
    reflectance = r0 + (1.0 - r0) * (1.0 - cos_theta) ** 5
    do_reflect = cannot_refract | (reflectance > u[0])
    diel_dir = torch.where(
        do_reflect[None], reflect(unit_d, n), refract(unit_d, n, refraction_ratio)
    )

    is_metal = kind == METAL
    is_diel = kind == DIELECTRIC
    return Scatter(
        has_scatter=kind != DIFFUSE_LIGHT,
        is_specular=is_metal | is_diel | (kind == ISOTROPIC),
        # Isotropic (material/mod.rs:207-213): the ball sample itself
        spec_dir=torch.where(
            is_metal[None], metal_dir, torch.where(is_diel[None], diel_dir, ball)
        ),
        spec_time=torch.where(is_metal, 0.0, tm),
        # Dielectric attenuation is (1,1,1) (mod.rs:144)
        attenuation=torch.where(is_diel[None], 1.0, tex_val),
    )


def scattering_pdf_lambertian(normal: torch.Tensor, scattered_dir: torch.Tensor) -> torch.Tensor:
    """Lambertian::scattering_pdf = max(cos, 0)/pi (material/mod.rs:58-65)."""
    cosine = dot(normal, to_unit(scattered_dir))
    return torch.where(cosine < 0.0, 0.0, cosine / PI)
