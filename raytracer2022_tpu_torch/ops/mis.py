"""The diffuse branch's mixture sample for a whole wavefront in one call.

The vertex's 50/50 mixture of the lights and the cosine lobe (ray_color,
main.rs:263-266): a cosine-weighted direction about the normal, a light
sample (a uniform pick over the lights list, then the sphere cone or the
rect point), the pick between them, and the mixture's pdf
``0.5 * lights_pdf + 0.5 * cos_pdf`` (the cosine pdf alone without
lights).

:func:`mis_sample` takes the wavefront's hit points and normals and one
block of uniform variates ``u`` f32[k, N] (:func:`variate_rows`: rows 0-1
the cosine lobe, row 2 the 50/50 pick, rows 3-4 the picked light's pair,
row 5 the light pick where there are several lights) and returns
``(new_dir f32[3, N], pdf_val f32[N])``.  A vertex's variate block
(``ops/vertex.py``) begins with these rows.  Forward renders on the card
take the mixture sample inside the vertex's kernel ``csrc/vertex.cu``,
which shares this kernel's lane code (``csrc/mis_sample.cuh``); every other
vertex calls :func:`mis_sample`.  Where :func:`kernel_takes` holds (CUDA
tensors, no gradient wanted through the block, and lights the kernel
samples) it launches the hand-written kernel ``csrc/mis_sample.cu``,
counted in ``LAUNCHES``; everywhere else (the CPU, gradient renders on
either device) it runs :func:`mis_sample_plain`, the same function in
plain PyTorch.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..scene.types import RECT, SPHERE
from .lights import light_directions, lights_pdf
from .sampling import cos_pdf_value, cosine_local
from .vecmath import onb_from_w, onb_local, to_unit

LAUNCHES = 0  # launches of the kernel in this process
MAX_LIGHTS = 1024  # the kernel's light table: 32 B a light in a block's shared memory
THREADS = 256  # threads a block, as csrc/mis_sample.cu launches them
BLOCKS_PER_SM = 8  # the grid's cap; a block's threads stride over the rest


def variate_rows(n_lights: int) -> int:
    """Rows of the variate block for ``n_lights`` lights: the cosine
    lobe's pair; then, with lights, the 50/50 pick and the light's pair;
    then, with several, the light pick."""
    if n_lights == 0:
        return 2
    return 5 if n_lights == 1 else 6


def lights_take(scene) -> bool:
    """Whether the kernel samples the scene's lights: at most MAX_LIGHTS,
    each a sphere or a rect (``csrc/vertex.cu`` shares the rule)."""
    kinds = scene.stats.light_kinds
    return len(kinds) <= MAX_LIGHTS and set(kinds) <= {SPHERE, RECT}


def kernel_takes(scene, p: torch.Tensor, normal: torch.Tensor) -> bool:
    """Whether the vertex's sampling goes to the kernel: CUDA tensors, grad
    mode off or nothing in the block requiring a gradient, and lights the
    kernel samples (:func:`lights_take`)."""
    if not p.is_cuda:
        return False
    if torch.is_grad_enabled() and (p.requires_grad or normal.requires_grad or scene.params.requires_grad):
        return False
    return lights_take(scene)


def mis_sample_plain(scene, p: torch.Tensor, normal: torch.Tensor, u: torch.Tensor):
    """:func:`mis_sample` in plain PyTorch, of the same variate block."""
    cos_dir = onb_local(*onb_from_w(normal), cosine_local(u[0], u[1]))
    w = to_unit(normal)
    n_lights = len(scene.stats.light_ids)
    if n_lights == 0:
        return cos_dir, cos_pdf_value(cos_dir, w)
    pick = None
    if n_lights > 1:
        pick = torch.clamp(torch.floor(u[5] * n_lights), max=n_lights - 1).long()
    pair = (u[3], u[4])  # the picked light's, whichever its kind
    light_dir = light_directions(scene, p, pick, pair, pair)
    new_dir = torch.where((u[2] < 0.5)[None], light_dir, cos_dir)
    return new_dir, 0.5 * lights_pdf(scene, p, new_dir, None) + 0.5 * cos_pdf_value(new_dir, w)


@functools.cache
def _kernel_lib():
    from ..cuda_build import load

    lib = load("mis_sample.cu")
    lib.rt_mis_sample.restype = ctypes.c_int
    lib.rt_mis_sample.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                                 ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int]
        + [ctypes.c_void_p] * 3
    )
    return lib


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(scene, p, normal, u) -> None:
    """Raise on inputs the kernel does not take (the plain version is held
    to the same, so that both paths refuse the same calls)."""
    n = p.shape[-1]
    k = variate_rows(len(scene.stats.light_ids))
    for name, x, shape in (("p", p, (3, n)), ("normal", normal, (3, n)), ("u", u, (k, n))):
        if x.dtype != torch.float32 or tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"mis_sample: {name} must be a contiguous f32{list(shape)}, got {x.dtype} "
                             f"{list(x.shape)}{'' if x.is_contiguous() else ' not contiguous'}")
        if x.device != scene.params.device:
            raise ValueError(f"mis_sample: {name} is on {x.device}, the scene on {scene.params.device}")


def _mis_sample_cuda(scene, p, normal, u):
    kinds = scene.stats.light_kinds
    params, kind, lights = scene.params, scene.kind, scene.lights
    if (params.dtype != torch.float32 or params.dim() != 2 or not params.is_contiguous()
            or kind.dtype != torch.int32 or lights.dtype != torch.int32 or lights.shape != (len(kinds),)):
        raise ValueError("mis_sample: the scene needs contiguous f32 params (NPARAM, P), i32 kinds and i32 light ids")
    dev = p.device
    n = p.shape[1]
    new_dir = torch.empty((3, n), dtype=torch.float32, device=dev)
    pdf_val = torch.empty((n,), dtype=torch.float32, device=dev)
    if n == 0:
        return new_dir, pdf_val
    blocks = min(-(-n // THREADS), BLOCKS_PER_SM * _sms(dev.index))
    global LAUNCHES
    lib = _kernel_lib()
    with torch.cuda.device(dev):  # the launch goes to the current device
        LAUNCHES += 1
        err = lib.rt_mis_sample(
            p.data_ptr(), normal.data_ptr(), u.data_ptr(), u.shape[0], params.data_ptr(), params.shape[1],
            kind.data_ptr(), lights.data_ptr(), len(kinds), n, blocks, new_dir.data_ptr(), pdf_val.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"mis_sample kernel launch failed: cudaError {err}")
    return new_dir, pdf_val


def mis_sample(scene, p: torch.Tensor, normal: torch.Tensor, u: torch.Tensor):
    """The diffuse branch's mixture sample of hit points ``p`` and normals
    ``normal`` (contiguous f32[3, N]) from the variates ``u`` (contiguous
    f32[variate_rows(L), N], U[0, 1)) -> ``(new_dir f32[3, N], pdf_val
    f32[N])``: the kernel where :func:`kernel_takes` holds,
    :func:`mis_sample_plain` on every other call.  A pdf is NaN where the
    origin lies inside a light sphere that the direction hits, and 0 where
    no light and no lobe gives the direction a density; the integrator
    kills both samples."""
    _check(scene, p, normal, u)
    if kernel_takes(scene, p, normal):
        return _mis_sample_cuda(scene, p, normal, u)
    return mis_sample_plain(scene, p, normal, u)
