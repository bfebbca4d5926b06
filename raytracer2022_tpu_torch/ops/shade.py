"""Per-ray shading inputs of the winning primitive.

Counterpart of ``raytracer2022_tpu/ops/shade.py``.  The JAX package
resolves material -> texture -> parameters into a per-material table and
fetches its rows with one-hot MXU contractions, because per-ray gathers are
slow on a TPU.  On a GPU those fetches are plain indexing by material id,
and a field is fetched only when the scene's texture features read it.
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
    scale: torch.Tensor  # f32[N] noise scale
    img: torch.Tensor  # i32[N] atlas index
    img_h: torch.Tensor  # i32[N]
    img_w: torch.Tensor  # i32[N]
    odd: torch.Tensor  # f32[3, N] checker odd color
    even: torch.Tensor  # f32[3, N] checker even color


def shade_for_mats(scene, mat: torch.Tensor) -> Shade:
    """Resolve material -> texture -> parameters for material ids ``mat``.

    Checker sub-textures are always solids (texture/mod.rs:40-48), so the
    checker colours are the sub-textures' ``color`` columns.  Fields no
    texture of the scene reads are zeros.
    """
    mt, tt = scene.materials, scene.textures
    features = scene.stats.features
    tex = mt.tex.long()[mat]
    zeros = torch.zeros(mat.shape, dtype=torch.float32, device=mat.device)
    izeros = torch.zeros(mat.shape, dtype=torch.int32, device=mat.device)
    img, img_h, img_w = izeros, izeros, izeros
    if "image" in features or "objuv" in features:
        img = tt.img[tex]
        img_h = tt.atlas_size[0][img.long()]
        img_w = tt.atlas_size[1][img.long()]
    if "checker" in features:
        odd = tt.color[:, tt.sub[0].long()[tex]]
        even = tt.color[:, tt.sub[1].long()[tex]]
    else:
        odd = even = zeros[None].expand(3, -1)
    return Shade(
        mat_kind=mt.kind[mat],
        mat_param=mt.param[mat],
        tex_kind=tt.kind[tex],
        color=tt.color[:, tex],
        scale=tt.scale[tex] if "noise" in features else zeros,
        img=img,
        img_h=img_h,
        img_w=img_w,
        odd=odd,
        even=even,
    )
