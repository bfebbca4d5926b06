"""Per-ray shading inputs of the winning primitive.

Counterpart of ``raytracer2022_tpu/ops/shade.py``.  The JAX package
resolves material -> texture -> parameters into a per-material table and
fetches its rows with one-hot MXU contractions, because per-ray gathers are
slow on a TPU.  On a GPU those fetches are plain indexing by material id.
Checker sub-texture colours and image-atlas fields wait with their textures
(ROADMAP.md, port queue: 'Textures').
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Shade:
    """Per-ray shading inputs for the winning primitive."""

    mat_kind: torch.Tensor  # i32[N]
    mat_param: torch.Tensor  # f32[N] (metal fuzz / dielectric ir)
    tex_kind: torch.Tensor  # i32[N]
    color: torch.Tensor  # f32[3, N] solid color / emission


def shade_for_mats(scene, mat: torch.Tensor) -> Shade:
    """Resolve material -> texture -> parameters for material ids ``mat``."""
    mt, tt = scene.materials, scene.textures
    tex = mt.tex.long()[mat]
    return Shade(
        mat_kind=mt.kind[mat],
        mat_param=mt.param[mat],
        tex_kind=tt.kind[tex],
        color=tt.color[:, tex],
    )
