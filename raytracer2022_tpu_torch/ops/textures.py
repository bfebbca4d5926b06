"""Texture evaluation (counterpart of ``raytracer2022_tpu/ops/textures.py``).

The reference's ``Texture`` trait objects (texture/mod.rs) become integer
dispatch on the winning primitive's texture kind with masked evaluation;
the scene's static ``features`` skip the evaluators a scene never uses.

The JAX package fetches the Perlin tables and atlas texels with one-hot MXU
contractions (``ops/tables.py``) because per-lane gathers are slow on a
TPU; here they are plain integer indexing, so the Perlin values are the
reference's to f32 rounding.
"""

from __future__ import annotations

import torch

from ..scene.types import TEX_CHECKER, TEX_IMAGE, TEX_NOISE, TEX_OBJUV


def _hermite(x):
    return x * x * (3.0 - 2.0 * x)


def perlin_noise(tt, p: torch.Tensor) -> torch.Tensor:
    """Perlin gradient noise (reference texture/perlin.rs:52-99) -> f32[N].

    Reproduces the reference's double Hermite smoothing quirk: ``noise()``
    smooths (u, v, w) in place (perlin.rs:56-58) and ``trilinear_interp``
    smooths them again for the interpolation weights (perlin.rs:81-83)
    while the gradient offsets use the single-smoothed values (perlin.rs:90).
    """
    fl = torch.floor(p)
    uvw1 = _hermite(p - fl)  # single-smoothed (the reference's u, v, w)
    uvw2 = _hermite(uvw1)  # double-smoothed weights (uu, vv, ww)
    ijk = fl.to(torch.int32)
    perm = tt.perlin_perm
    # perm[a][i & 255] and perm[a][(i + 1) & 255] per axis, kept in int32
    # through the XOR like the reference's usize arithmetic
    pa = [
        [perm[a][(ijk[a] & 255).long()], perm[a][((ijk[a] + 1) & 255).long()]]
        for a in range(3)
    ]
    accum = torch.zeros_like(p[0])
    for di in range(2):
        for dj in range(2):
            for dk in range(2):
                idx = pa[0][di] ^ pa[1][dj] ^ pa[2][dk]
                g = tt.perlin_vec[:, idx.long()]  # (3, N)
                grad_dot = g[0] * (uvw1[0] - di) + g[1] * (uvw1[1] - dj) + g[2] * (uvw1[2] - dk)
                wx = uvw2[0] if di else (1.0 - uvw2[0])
                wy = uvw2[1] if dj else (1.0 - uvw2[1])
                wz = uvw2[2] if dk else (1.0 - uvw2[2])
                accum = accum + grad_dot * wx * wy * wz
    return accum


def perlin_turb(tt, p: torch.Tensor, depth: int = 7) -> torch.Tensor:
    """Turbulence: |sum of ``depth`` halved octaves| (perlin.rs:100-112)."""
    accum = torch.zeros_like(p[0])
    tmp_p = p
    weight = 1.0
    for _ in range(depth):
        accum = accum + weight * perlin_noise(tt, tmp_p)
        weight *= 0.5
        tmp_p = tmp_p * 2.0
    return torch.abs(accum)


def _to_index(x: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Truncate ``x`` toward zero to int64, saturating outside [-1, hi]
    first: an out-of-range float-to-int cast is undefined in C++, and every
    caller clips the result into [0, hi - 1] afterwards."""
    return torch.minimum(torch.clamp(x, min=-1.0), hi.to(x.dtype)).long()


def _image_lookup(tt, img_id, w, h, i, j) -> torch.Tensor:
    """Texel (3, N) in [0, ~1] of the u32-packed RGB atlas, whose rows are
    stored v-flipped like the reference's loader (texture/mod.rs:96-105).
    The packed word R | G<<8 | B<<16 fits in 24 bits, so it is read as
    int32, where the shifts are defined on every device."""
    i = torch.minimum(torch.clamp(i, min=0), (w - 1).long())
    j = torch.minimum(torch.clamp(j, min=0), (h - 1).long())
    packed = tt.atlas.view(torch.int32)[img_id.long(), j, i]
    color_scale = 1.0 / 255.999
    return (
        torch.stack(
            [
                (packed & 0xFF).to(torch.float32),
                ((packed >> 8) & 0xFF).to(torch.float32),
                ((packed >> 16) & 0xFF).to(torch.float32),
            ]
        )
        * color_scale
    )


def _eval_image(tt, img_id, w, h, u, v) -> torch.Tensor:
    """ImageTexture nearest-neighbour sample (texture/mod.rs:111-138)."""
    u = torch.clamp(u, 0.0, 1.0)
    v = torch.clamp(v, 0.0, 1.0)
    i = _to_index(u * w.to(torch.float32), w)
    j = _to_index(v * h.to(torch.float32), h)
    return _image_lookup(tt, img_id, w, h, i, j)


def _eval_objuv(tt, img_id, w, h, tex_uv) -> torch.Tensor:
    """ObjTexture sample (texture/mod.rs:167-188): the uv was interpolated
    from the triangle's per-vertex uvs in the hit record; the reference
    indexes from the image top (j = (1 - v) * H), so flip against the
    v-flipped atlas."""
    i = _to_index(tex_uv[0] * w.to(torch.float32), w)
    j_top = _to_index((1.0 - tex_uv[1]) * h.to(torch.float32), h)
    j_top = torch.minimum(torch.clamp(j_top, min=0), (h - 1).long())
    j = h.long() - 1 - j_top  # the atlas is stored bottom-up
    return _image_lookup(tt, img_id, w, h, i, j)


def eval_texture_shade(
    tt,
    shade,  # ops.shade.Shade of the winning primitives
    u: torch.Tensor,
    v: torch.Tensor,
    p: torch.Tensor,  # (3, N)
    tex_uv: torch.Tensor,  # (2, N)
    features: frozenset = frozenset(),
) -> torch.Tensor:
    """Texture value (3, N) from pre-fetched shading inputs
    (``Texture::value`` dispatch); only the Perlin tables and the atlas are
    read from the texture table here."""
    kind = shade.tex_kind
    value = shade.color  # TEX_SOLID (texture/mod.rs:26-28)
    if "noise" in features:
        # NoiseTexture marble (texture/mod.rs:76-78)
        noise_val = 0.5 * (1.0 + torch.sin(shade.scale * p[2] + 10.0 * perlin_turb(tt, p)))
        value = torch.where((kind == TEX_NOISE)[None], noise_val[None], value)
    if "image" in features:
        img_val = _eval_image(tt, shade.img, shade.img_w, shade.img_h, u, v)
        value = torch.where((kind == TEX_IMAGE)[None], img_val, value)
    if "objuv" in features:
        obj_val = _eval_objuv(tt, shade.img, shade.img_w, shade.img_h, tex_uv)
        value = torch.where((kind == TEX_OBJUV)[None], obj_val, value)
    if "checker" in features:
        # CheckerTexture sine-product select (texture/mod.rs:52-59)
        sines = torch.sin(10.0 * p[0]) * torch.sin(10.0 * p[1]) * torch.sin(10.0 * p[2])
        checker_val = torch.where((sines < 0.0)[None], shade.odd, shade.even)
        value = torch.where((kind == TEX_CHECKER)[None], checker_val, value)
    return value
