"""Texture evaluation (counterpart of ``raytracer2022_tpu/ops/textures.py``).

Solid colours only in this port so far (texture/mod.rs:26-28).  Checker,
Perlin marble, image and per-triangle-uv textures are not ported yet
(ROADMAP.md, port queue: 'Textures'); a scene that uses them raises
``NotImplementedError``.
"""

from __future__ import annotations

import torch

_TEXTURES_TODO = (
    "checker, noise, image and objuv textures are not ported yet "
    "(ROADMAP.md, port queue: 'Textures')"
)


def eval_texture_shade(
    tt,
    shade,  # ops.shade.Shade of the winning primitives
    u: torch.Tensor,
    v: torch.Tensor,
    p: torch.Tensor,  # (3, N)
    tex_uv: torch.Tensor,  # (2, N)
    features: frozenset = frozenset(),
) -> torch.Tensor:
    """Texture value (3, N) from pre-fetched shading inputs."""
    if features:
        raise NotImplementedError(f"{sorted(features)}: {_TEXTURES_TODO}")
    return shade.color
