"""The path vertex after its closest hit, for a whole wavefront in one call.

Between the hit record and the next ray (ray_color, main.rs:233-278): the
winning primitive's texture value and emission, its material's scatter
(``ops/materials.py``), the diffuse branch's mixture sample
(``ops/mis.py``), and the update: each lane's class (miss, absorb,
specular, or diffuse with a mixture pdf > 0; a pdf <= 0 or NaN kills the
sample with its radiance kept), the radiance it adds (the background on a
miss), its throughput and its next ray.

:func:`vertex_tail` draws one block of uniform variates a vertex,
f32[:func:`variate_rows`, N]: the mixture sample's rows
(``mis.variate_rows``) first, so that their view is contiguous, then the
scatter's three (the ball sample of metal's fuzz and of the isotropic
phase function takes z, azimuth and radius from them, the dielectric's
reflect test the first; a lane has one material).  Every vertex draws that
block, on every device and with or without gradients.  Where
:func:`kernel_takes` holds (CUDA tensors, no gradient wanted through the
call, and lights the mixture sample's kernel takes: every forward render
on the card) it launches the hand-written kernel ``csrc/vertex.cu`` inside
one ``vertex.shading`` span, counted in ``LAUNCHES``; everywhere else (the
CPU, gradient renders on either device) it runs :func:`vertex_tail_plain`,
the same function in plain PyTorch, in the spans ``vertex.shading``,
``vertex.sampling`` and ``vertex.update``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..scene.types import ISOTROPIC, LAMBERTIAN
from ..utils.profiling import span
from . import mis
from .materials import emitted, scatter, scattering_pdf_lambertian, texture_value
from .sampling import uniform
from .vecmath import dot, scale, to_unit, vec3

LAUNCHES = 0  # launches of the kernel in this process
SCATTER_ROWS = 3  # the ball sample's z, azimuth, radius; the first is also the dielectric's test
THREADS = 256  # threads a block, as csrc/vertex.cu launches them
BLOCKS_PER_SM = 8  # the grid's cap; a block's threads stride over the rest
FEATURES = {"checker": 1, "noise": 2, "image": 4, "objuv": 8}  # csrc/vertex.cu's FEAT_* bits


class Vertex(NamedTuple):
    """Result of evaluating one path vertex for the whole wavefront."""

    radiance_add: torch.Tensor  # (3, N) throughput-weighted contribution
    cont: torch.Tensor  # bool[N] path continues
    o: torch.Tensor  # next ray (valid where cont)
    d: torch.Tensor
    tm: torch.Tensor
    throughput: torch.Tensor  # updated throughput (valid where cont)


def variate_rows(n_lights: int) -> int:
    """Rows of a vertex's variate block for ``n_lights`` lights: the
    mixture sample's, then the scatter's three."""
    return mis.variate_rows(n_lights) + SCATTER_ROWS


def _floats(scene, hit, shade, d, tm, throughput):
    """Every float tensor a vertex reads: the scene's float tables, the hit
    record, the shading inputs, the ray and the throughput."""
    return (scene.params, scene.materials.param, scene.textures.color, scene.textures.scale,
            scene.textures.perlin_vec, hit.p, hit.normal, hit.u, hit.v, hit.tex_uv, shade.mat_param,
            shade.color, shade.scale, shade.odd, shade.even, d, tm, throughput)


def kernel_takes(scene, hit, shade, d, tm, throughput) -> bool:
    """Whether the vertex goes to the kernel: CUDA tensors, grad mode off or
    nothing of the call requiring a gradient, and lights the mixture
    sample's kernel takes (``mis.lights_take``)."""
    if not d.is_cuda:
        return False
    if torch.is_grad_enabled() and any(x.requires_grad for x in _floats(scene, hit, shade, d, tm, throughput)):
        return False
    return mis.lights_take(scene)


def background(cfg, d: torch.Tensor) -> torch.Tensor:
    """The radiance of a miss along ``d``: ``cfg.background``, or where that
    is None the RTiOW sky gradient of the book1/book2 golden images."""
    if cfg.background is not None:
        return vec3(*(torch.full_like(d[0], float(c)) for c in cfg.background))
    unit_d = to_unit(d)
    tt = 0.5 * (unit_d[1] + 1.0)
    ones = torch.ones_like(tt)
    white = vec3(ones, ones, ones)
    blue = vec3(0.5 * ones, 0.7 * ones, ones)
    return scale(white, 1.0 - tt) + scale(blue, tt)


def vertex_tail_plain(scene, cfg, hit, shade, d, tm, throughput, alive, u) -> Vertex:
    """:func:`vertex_tail` in plain PyTorch, of the same variate block ``u``."""
    k = mis.variate_rows(len(scene.stats.light_ids))
    with span("vertex.shading"):
        tex_val = texture_value(scene.textures, shade, hit, scene.stats.features)
        em = emitted(shade, hit, tex_val)
        sc = scatter(shade, hit, tex_val, d, tm, u[k:])

    with span("vertex.sampling"):
        new_dir, pdf_val = mis.mis_sample(scene, hit.p.contiguous(), hit.normal.contiguous(), u[:k])

    with span("vertex.update"):
        spdf = scattering_pdf_lambertian(hit.normal, new_dir)
        lamb = shade.mat_kind == LAMBERTIAN

        miss = alive & ~hit.hit
        absorb = alive & hit.hit & ~sc.has_scatter
        specular = alive & hit.hit & sc.has_scatter & sc.is_specular
        diffuse = alive & hit.hit & sc.has_scatter & ~sc.is_specular & lamb
        pdf_ok = pdf_val > 0.0  # NaN compares False
        diffuse = diffuse & pdf_ok

        radiance_add = torch.where(miss[None], throughput * background(cfg, d), 0.0)
        radiance_add = radiance_add + torch.where((absorb | diffuse)[None], throughput * em, 0.0)

        w_diffuse = sc.attenuation * (spdf / torch.where(diffuse & pdf_ok, pdf_val, 1.0))[None]
        throughput = torch.where(
            specular[None],
            throughput * sc.attenuation,
            torch.where(diffuse[None], throughput * w_diffuse, throughput),
        )

        next_dir = torch.where(specular[None], sc.spec_dir, new_dir)
        next_tm = torch.where(specular, sc.spec_time, tm)
        if cfg.spawn_eps > 0.0:
            # origin offset along the face normal toward the outgoing side
            is_surface = shade.mat_kind != ISOTROPIC
            eps = cfg.spawn_eps * torch.clamp(torch.abs(hit.p).amax(dim=0), min=1.0)
            side = torch.sign(dot(hit.normal, next_dir))
            new_o = hit.p + scale(hit.normal, eps * side * is_surface.to(eps.dtype))
        else:
            new_o = hit.p

        return Vertex(radiance_add=radiance_add, cont=specular | diffuse, o=new_o, d=next_dir, tm=next_tm,
                      throughput=throughput)


class _Args(ctypes.Structure):
    """csrc/vertex.cu's ``VertexArgs``, field for field."""

    _fields_ = (
        [(name, ctypes.c_void_p) for name in (
            "hit", "p", "normal", "front", "u", "v", "tex_uv", "mat_kind", "mat_param", "tex_kind", "color",
            "scale", "img", "img_h", "img_w", "odd", "even", "d", "tm", "throughput", "alive", "var",
            "perlin_perm", "perlin_vec", "atlas", "params", "kind", "lights", "radiance", "cont", "o_out",
            "d_out", "tm_out", "th_out")]
        + [(name, ctypes.c_longlong) for name in ("n", "n_prims", "atlas_h", "atlas_w")]
        + [(name, ctypes.c_int) for name in ("rows", "n_lights", "features", "sky", "spawn")]
        + [("spawn_eps", ctypes.c_float), ("bg", ctypes.c_float * 3)]
    )


@functools.cache
def _kernel_lib():
    from ..cuda_build import load

    lib = load("vertex.cu")
    lib.rt_vertex.restype = ctypes.c_int
    lib.rt_vertex.argtypes = [ctypes.POINTER(_Args), ctypes.c_int, ctypes.c_void_p]
    return lib


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _inputs(scene, hit, shade, d, tm, throughput, alive) -> dict:
    """The tensors the kernel reads besides the variate block, by its names,
    each with its dtype and shape: what no texture kind of the scene reads
    is left out."""
    n = tm.shape[0]
    f32, i32 = torch.float32, torch.int32
    features = scene.stats.features
    want = {
        "hit": (hit.hit, torch.bool, (n,)), "p": (hit.p, f32, (3, n)), "normal": (hit.normal, f32, (3, n)),
        "front": (hit.front, torch.bool, (n,)), "mat_kind": (shade.mat_kind, i32, (n,)),
        "mat_param": (shade.mat_param, f32, (n,)), "tex_kind": (shade.tex_kind, i32, (n,)),
        "color": (shade.color, f32, (3, n)), "d": (d, f32, (3, n)), "tm": (tm, f32, (n,)),
        "throughput": (throughput, f32, (3, n)), "alive": (alive, torch.bool, (n,)),
    }
    if "noise" in features:
        want["scale"] = (shade.scale, f32, (n,))
        want["perlin_perm"] = (scene.textures.perlin_perm, i32, (3, 256))
        want["perlin_vec"] = (scene.textures.perlin_vec, f32, (3, 256))
    if "image" in features:
        want.update(u=(hit.u, f32, (n,)), v=(hit.v, f32, (n,)))
    if "objuv" in features:
        want["tex_uv"] = (hit.tex_uv, f32, (2, n))
    if "image" in features or "objuv" in features:
        want.update(img=(shade.img, i32, (n,)), img_h=(shade.img_h, i32, (n,)), img_w=(shade.img_w, i32, (n,)))
    if "checker" in features:
        want.update(odd=(shade.odd, f32, (3, n)), even=(shade.even, f32, (3, n)))
    return want


def _check(scene, want: dict) -> None:
    """Raise on inputs the kernel does not take (the plain version is held
    to the same, so that both paths refuse the same calls)."""
    for name, (x, dtype, shape) in want.items():
        if x.dtype != dtype or tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"vertex: {name} must be a contiguous {dtype}{list(shape)}, got {x.dtype} "
                             f"{list(x.shape)}{'' if x.is_contiguous() else ' not contiguous'}")
        if x.device != scene.params.device:
            raise ValueError(f"vertex: {name} is on {x.device}, the scene on {scene.params.device}")


def _vertex_cuda(scene, cfg, want: dict) -> Vertex:
    params, kind, lights = scene.params, scene.kind, scene.lights
    n_lights = len(scene.stats.light_kinds)
    if (params.dtype != torch.float32 or params.dim() != 2 or not params.is_contiguous()
            or kind.dtype != torch.int32 or lights.dtype != torch.int32 or lights.shape != (n_lights,)):
        raise ValueError("vertex: the scene needs contiguous f32 params (NPARAM, P), i32 kinds and i32 light ids")
    features = scene.stats.features
    u = want["var"][0]
    rows, n = u.shape
    out = torch.empty((13, n), dtype=torch.float32, device=u.device)
    vx = Vertex(radiance_add=out[0:3], cont=torch.empty((n,), dtype=torch.bool, device=u.device), o=out[3:6],
                d=out[6:9], tm=out[12], throughput=out[9:12])
    if n == 0:
        return vx
    args = _Args(**{name: x.data_ptr() for name, (x, _, _) in want.items()},
                 params=params.data_ptr(), kind=kind.data_ptr(), lights=lights.data_ptr(),
                 radiance=vx.radiance_add.data_ptr(), cont=vx.cont.data_ptr(), o_out=vx.o.data_ptr(),
                 d_out=vx.d.data_ptr(), tm_out=vx.tm.data_ptr(), th_out=vx.throughput.data_ptr(),
                 n=n, n_prims=params.shape[1], rows=rows, n_lights=n_lights,
                 features=sum(bit for name, bit in FEATURES.items() if name in features),
                 sky=int(cfg.background is None), spawn=int(cfg.spawn_eps > 0.0), spawn_eps=cfg.spawn_eps)
    if cfg.background is not None:
        args.bg = (ctypes.c_float * 3)(*(float(c) for c in cfg.background))
    if "image" in features or "objuv" in features:
        atlas = scene.textures.atlas.view(torch.int32)
        if atlas.dim() != 3 or not atlas.is_contiguous() or atlas.device != u.device:
            raise ValueError(f"vertex: the atlas must be a contiguous (I, H, W) on {u.device}")
        args.atlas, args.atlas_h, args.atlas_w = atlas.data_ptr(), atlas.shape[1], atlas.shape[2]
    blocks = min(-(-n // THREADS), BLOCKS_PER_SM * _sms(u.device.index))
    global LAUNCHES
    lib = _kernel_lib()
    with torch.cuda.device(u.device):  # the launch goes to the current device
        LAUNCHES += 1
        err = lib.rt_vertex(ctypes.byref(args), blocks, torch.cuda.current_stream(u.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"vertex kernel launch failed: cudaError {err}")
    return vx


def vertex_tail(scene, cfg, hit, shade, d, tm, throughput, alive, gen: torch.Generator) -> Vertex:
    """The vertex after :func:`ops.intersect.closest_hit`: of the hit record
    ``hit`` and shading inputs ``shade`` it returns, the ray direction ``d``
    (f32[3, N]) and time ``tm`` (f32[N]), the ``throughput`` (f32[3, N])
    and the live lanes ``alive`` (bool[N]), with ``cfg`` a
    ``TraceConfig`` (its ``background`` and ``spawn_eps``) -> the
    :class:`Vertex`.  It draws one variate block of :func:`variate_rows`
    rows from ``gen``; the kernel where :func:`kernel_takes` holds,
    :func:`vertex_tail_plain` on every other call."""
    shape = (variate_rows(len(scene.stats.light_ids)), tm.shape[0])
    if kernel_takes(scene, hit, shade, d, tm, throughput):
        with span("vertex.shading"):
            want = _inputs(scene, hit, shade, d, tm, throughput, alive)
            _check(scene, want)
            want["var"] = (uniform(gen, shape), torch.float32, shape)
            return _vertex_cuda(scene, cfg, want)
    _check(scene, _inputs(scene, hit, shade, d, tm, throughput, alive))
    return vertex_tail_plain(scene, cfg, hit, shade, d, tm, throughput, alive, uniform(gen, shape))
