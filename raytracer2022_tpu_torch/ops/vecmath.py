"""Batched 3-vector math on component-leading ``f32[3, ...]`` tensors.

Counterpart of ``raytracer2022_tpu/ops/vecmath.py`` (reference
raytracer/src/basic/vec.rs:12-128): a batch of vectors is one tensor of
shape ``(3, *batch)`` with the component axis leading, the layout the
JAX package uses at every public function.
"""

from __future__ import annotations

import torch


def vec3(x, y, z) -> torch.Tensor:
    """Stack three equal-shape component tensors into ``(3, *batch)``."""
    return torch.stack([x, y, z], dim=0)


def safe_div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a / b`` with a 1-denominator on b==0 lanes (callers mask those
    lanes out themselves).  Gradient safety: a masked lane must not compute
    an inf or NaN primal, or the backward of the ``torch.where`` that drops
    it multiplies its zero cotangent by inf (0 * inf = NaN) upstream."""
    return a / torch.where(b == 0.0, 1.0, b)


def masked_sqrt(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """``sqrt(x)`` on valid lanes, 1 elsewhere: no sqrt'(0) = inf on lanes a
    caller clamps or drops (the same gradient safety as :func:`safe_div`)."""
    return torch.sqrt(torch.where(valid, x, 1.0))


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot product over the leading axis (vec.rs:24-26)."""
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product over the leading axis (vec.rs:28-34)."""
    return vec3(
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def length_sqr(a: torch.Tensor) -> torch.Tensor:
    return dot(a, a)


def length(a: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(length_sqr(a))


def scale(a: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Multiply a ``(3, *batch)`` vector by a ``[...]``-shaped scalar field."""
    return a * s[None]


def to_unit(a: torch.Tensor) -> torch.Tensor:
    """Normalize to unit length (vec.rs:44-46); a zero vector gives
    non-finite components, like the reference."""
    return scale(a, 1.0 / length(a))


def reflect(v: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Mirror reflection of ``v`` about ``n`` (vec.rs:119-121)."""
    return v - scale(n, 2.0 * dot(v, n))


def refract(uv: torch.Tensor, n: torch.Tensor, etai_over_etat: torch.Tensor) -> torch.Tensor:
    """Snell refraction of unit direction ``uv`` about ``n`` (vec.rs:123-128)."""
    cos_theta = torch.clamp(dot(-uv, n), max=1.0)
    r_out_perp = scale(uv + scale(n, cos_theta), etai_over_etat)
    r_out_parallel = scale(
        -n, torch.sqrt(torch.clamp(torch.abs(1.0 - length_sqr(r_out_perp)), min=1e-12))
    )
    return r_out_perp + r_out_parallel


def onb_from_w(n: torch.Tensor):
    """Orthonormal basis ``(u, v, w)`` about ``n`` (reference onb.rs:26-36):
    ``a = (0,1,0) if |w.x| > 0.9 else (1,0,0)``; ``v = unit(w x a)``;
    ``u = w x v``."""
    w = to_unit(n)
    use_y = torch.abs(w[0]) > 0.9
    zeros = torch.zeros_like(w[0])
    ones = torch.ones_like(w[0])
    a = vec3(torch.where(use_y, zeros, ones), torch.where(use_y, ones, zeros), zeros)
    v = to_unit(cross(w, a))
    u = cross(w, v)
    return u, v, w


def onb_local(u, v, w, a: torch.Tensor) -> torch.Tensor:
    """Local coords ``a`` in the (u, v, w) basis (onb.rs:22-24)."""
    return scale(u, a[0]) + scale(v, a[1]) + scale(w, a[2])
