"""Per-ray shading inputs of the winning primitive, and the gather from
the scene's float tables that differentiates them.

Counterpart of ``raytracer2022_tpu/ops/shade.py``.  The JAX package
resolves material -> texture -> parameters into a per-material table and
fetches its rows with one-hot MXU contractions, because per-ray gathers are
slow on a TPU.  On a GPU those fetches are plain indexing by material id,
and a field is fetched only when the scene's texture features read it.

Where a gradient of a float table is wanted (grad mode on and the table
requiring grad: the fit, ``render_batch``'s backward), the fetch goes
through :func:`gather_table`, whose backward is :func:`table_grad`: for
CUDA tensors the hand-written kernel ``csrc/table_grad.cu`` (a
deterministic privatised reduction; PyTorch's own backward of indexing
serialises on ids that repeat ~10^5 times in a wavefront), counted in
``TABLE_GRAD_LAUNCHES``; for CPU tensors :func:`table_grad_plain`.  Every
other fetch, and every fetch of an integer table, is plain indexing.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
from torch.autograd.function import once_differentiable

TABLE_GRAD_LAUNCHES = 0  # table_grad calls on CUDA tensors in this process (two kernels each)
MAX_WARPS = 8  # warps a block of the kernel's first launch, each with its own bins
MIN_CHUNKS = 2  # 32-lane chunks a warp takes at the least before the grid grows


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


def table_grad_plain(grad: torch.Tensor, idx: torch.Tensor, shape) -> torch.Tensor:
    """The gradient of ``table[..., idx]`` for a table of ``shape`` (T,) or
    (C, T), given the output's gradient ``grad`` (N,) or (C, N)."""
    idx = torch.where(idx < 0, idx + shape[-1], idx)
    return torch.zeros(shape, dtype=grad.dtype, device=grad.device).index_add_(-1, idx, grad)


def grad_plan(n: int, c: int, t: int, sms: int, smem: int) -> tuple:
    """The kernel's launch for ``n`` lanes, ``c`` rows and ``t`` entries on
    a card of ``sms`` SMs that gives a block ``smem`` bytes of shared
    memory -> (blocks, slices, warps, slice, lanes_per_block).

    A warp's bins hold ``slice`` entries of each row (the whole table where
    it fits, else the grid's ``slices`` split it); as many warps as fit,
    up to MAX_WARPS; about two blocks an SM, fewer for small ``n``, each on
    a contiguous range of ``lanes_per_block`` lanes."""
    entry_bytes = 4 * c
    if entry_bytes > smem:
        raise ValueError(f"table_grad: a table of {c} rows does not fit {smem} bytes of shared memory")
    slice_ = min(t, smem // entry_bytes)
    warps = max(1, min(MAX_WARPS, smem // (slice_ * entry_bytes)))
    chunks = -(-n // 32)
    blocks = max(1, min(2 * sms, chunks // (warps * MIN_CHUNKS)))
    lanes = -(-chunks // blocks) * 32
    return -(-n // lanes), -(-t // slice_), warps, slice_, lanes


@functools.cache
def _kernel_lib():
    from ..cuda_build import load

    lib = load("table_grad.cu")
    lib.rt_table_grad_smem.restype = ctypes.c_int
    lib.rt_table_grad_smem.argtypes = []
    lib.rt_table_grad.restype = ctypes.c_int
    lib.rt_table_grad.argtypes = (
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_int] * 6
        + [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    )
    return lib


@functools.cache
def _card(index: int) -> tuple:
    """(SMs, shared memory a block of the kernel takes) of card ``index``:
    half of what a block may opt into, so that two blocks share an SM."""
    with torch.cuda.device(index):
        smem = _kernel_lib().rt_table_grad_smem()
    if smem < 0:
        raise RuntimeError(f"table_grad shared-memory query failed: cudaError {-smem}")
    return torch.cuda.get_device_properties(index).multi_processor_count, smem // 2


def _table_grad_cuda(grad: torch.Tensor, idx: torch.Tensor, shape) -> torch.Tensor:
    dev = grad.device
    n, t = idx.shape[0], shape[-1]
    c = shape[0] if len(shape) == 2 else 1
    if grad.dtype != torch.float32 or idx.dtype != torch.int64 or idx.device != dev or idx.dim() != 1:
        raise ValueError(f"table_grad: needs f32 gradients and i64[N] ids on one card, got {grad.dtype} "
                         f"{tuple(grad.shape)} and {idx.dtype} {tuple(idx.shape)} on {dev} and {idx.device}")
    if tuple(grad.shape) != tuple(shape[:-1]) + (n,):
        raise ValueError(f"table_grad: gradient {tuple(grad.shape)} does not match {n} ids of a table {tuple(shape)}")
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    if n == 0:
        return out.zero_()
    grad, idx = grad.contiguous(), idx.contiguous()
    sms, smem = _card(dev.index)
    blocks, slices, warps, slice_, lanes = grad_plan(n, c, t, sms, smem)
    partials = torch.empty((blocks, c * t), dtype=torch.float32, device=dev)
    global TABLE_GRAD_LAUNCHES
    lib = _kernel_lib()
    with torch.cuda.device(dev):  # the launch goes to the current device
        TABLE_GRAD_LAUNCHES += 1
        err = lib.rt_table_grad(
            grad.data_ptr(), idx.data_ptr(), n, c, t, blocks, slices, warps, slice_, lanes,
            partials.data_ptr(), out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"table_grad kernel launch failed: cudaError {err}")
    return out


def table_grad(grad: torch.Tensor, idx: torch.Tensor, shape) -> torch.Tensor:
    """The gradient of ``table[..., idx]`` for a table of ``shape`` (T,) or
    (C, T) and ids i64[N] in [-T, T), given the output's gradient ``grad``
    (N,) or (C, N): the kernel for CUDA tensors, :func:`table_grad_plain`
    for CPU tensors."""
    if grad.device.type == "cpu":
        return table_grad_plain(grad, idx, shape)
    if grad.device.type == "cuda":
        return _table_grad_cuda(grad, idx, tuple(shape))
    raise ValueError(f"table_grad: no kernel for device {grad.device}")


class _GatherTable(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.shape = table.shape
        return table[..., idx]

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        return table_grad(grad, idx, ctx.shape), None


def gather_table(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[..., idx]`` for a table (T,) or (C, T) and ids i64[N], with
    :func:`table_grad` as its backward.  The forward is that indexing; the
    backward keeps only the ids and the table's shape."""
    return _GatherTable.apply(table, idx)


def _fetch(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[..., idx]``: through :func:`gather_table` where a gradient of
    ``table`` is wanted, else plain indexing."""
    if torch.is_grad_enabled() and table.requires_grad:
        return gather_table(table, idx)
    return table[..., idx]


def shade_for_mats(scene, mat: torch.Tensor) -> Shade:
    """Resolve material -> texture -> parameters for material ids ``mat``.

    Checker sub-textures are always solids (texture/mod.rs:40-48), so the
    checker colours are the sub-textures' ``color`` columns.  Fields no
    texture of the scene reads are zeros.  The float tables go through
    :func:`_fetch`.
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
        odd = _fetch(tt.color, tt.sub[0].long()[tex])
        even = _fetch(tt.color, tt.sub[1].long()[tex])
    else:
        odd = even = zeros[None].expand(3, -1)
    return Shade(
        mat_kind=mt.kind[mat],
        mat_param=_fetch(mt.param, mat),
        tex_kind=tt.kind[tex],
        color=_fetch(tt.color, tex),
        scale=_fetch(tt.scale, tex) if "noise" in features else zeros,
        img=img,
        img_h=img_h,
        img_w=img_w,
        odd=odd,
        even=even,
    )
