"""8-ary BVH: host build, and the closest-hit walk as a CUDA kernel (K1).

Counterpart of ``raytracer2022_tpu/ops/bvh8.py``.  The host build
(:func:`build_bvh8`, :func:`_leaf_rows`) is the JAX package's code
unchanged, with the JAX package's depth bound stated as the kernel's
stack (``MAX_DEPTH`` group levels): the 8-ary topology is collapsed from the
host binned-SAH binary tree, every leaf holds 16 primitive rows of 24 f32
columns (the full param row, then pid/mat/flip/kind), and each group
stores a near-first child order per ray-sign octant.

:func:`traverse_bvh8` is the wrapper.  For CUDA tensors it launches the
hand-written kernel ``csrc/bvh8.cu`` (persistent warps that fetch rays
from a counter, a compact per-group stack, warp-cooperative leaf tests,
the group arrays in shared memory where they fit) and counts the launch in
``LAUNCHES``; for CPU tensors it
runs :func:`traverse_bvh8_plain`, a chunked brute force over the tree's
leaf rows with the same per-kind formulas, FAR sentinel, ``t_init`` rule
and tie rule.  Both return the same three outputs.  Exact-t ties across
two leaves may resolve differently (the walk keeps the first leaf it
visits, the plain version the smallest prim id), so the two agree on the
hit mask and t, and on the id wherever no such tie exists.
:func:`walk_bvh8_reference` is the kernel's walk in numpy, ray by ray,
with its visit counts.
"""

from __future__ import annotations

import ctypes
import functools
import sys
from typing import Optional

import numpy as np
import torch

from ..scene.types import MSPHERE, RECT, RING, SPHERE, TRIANGLE, Bvh8Tree
from ..utils.device import DEFAULT_DEVICE, resolve_device
from .vecmath import masked_sqrt

LEAF = 16  # prims per leaf
FANOUT = 8
# The JAX package's walk keeps up to FANOUT - 1 net pushes per level on a
# stack of MAX_STACK entries, so it takes (FANOUT - 1) * depth + 1 <= 160.
# The kernel's compact stack holds one word per group level of the tree it
# walks (Bvh8Tree.depth), up to MAX_DEPTH levels, the same 22, in
# csrc/bvh8.cu.
MAX_STACK = 160
MAX_DEPTH = (MAX_STACK - 1) // (FANOUT - 1)
MAX_GROUPS = 1 << 24  # a stack word holds the group id above an 8-bit child mask
SENT = 0x7FFFFFFF  # empty-child tag, never pushed
NONE = SENT  # the walk's "no node left"
# Leaf-row columns: 0-15 the primitive's full global param row, then
# COL_PID / COL_MAT / COL_FLIP / COL_KIND; padded to 24.
NCOL = 24
COL_PID = 16
COL_MAT = 17
COL_FLIP = 18
COL_KIND = 19
FAR = 1e30
_NO_PID = float(1 << 24)  # above every prim id (ids ride f32 exactly below 2^24)
_PLAIN_ELEMS = 1 << 22  # (leaf rows x rays) per chunk of the plain version

LAUNCHES = 0  # K1 launches in this process (traverse_bvh8 on CUDA tensors)
TREE_MEMORY = None  # "shared" or "global": where the last launch read the group arrays


# --------------------------------------------------------------------------
# host build (the JAX package's code, tensors at the end)
# --------------------------------------------------------------------------


def _leaf_rows(kind, params, mat_id, flip, pids, prim_rows):
    """Pack leaf rows -> f32[Lb*LEAF, NCOL].

    ``params`` is the global (NPARAM, P) table, ``pids`` the global prim
    ids of the tree's prims, ``prim_rows`` the (Lb, LEAF) tree-local prim
    index blocks (-1 padded).  Padded slots get per-kind guaranteed-miss
    values on the columns the leaf test reads.
    """
    lb = prim_rows.shape[0]
    rows = np.zeros((lb * LEAF, NCOL), np.float32)
    flat = prim_rows.reshape(-1)
    valid = flat >= 0
    safe = np.where(valid, flat, 0)
    gids = pids[safe]
    p = params[:, gids].T
    rows[:, : p.shape[1]] = p

    if kind in (SPHERE, MSPHERE):
        rows[~valid, 0:3] = FAR
        rows[~valid, 3] = 0.0
    elif kind == RECT:
        rows[~valid, 0] = FAR  # a0 > a1: bounds test always fails
        rows[~valid, 1] = -FAR
    elif kind == TRIANGLE:
        rows[~valid, 0:9] = 0.0  # degenerate: nlen == 0 rejects
    elif kind == RING:
        rows[~valid, 2] = FAR  # dmin2 > dmax2: band test always fails
        rows[~valid, 3] = -FAR
    else:
        raise ValueError(f"bvh8 cannot hold kind {kind}")
    if valid.any() and int(gids[valid].max()) >= 1 << 24:
        raise ValueError("bvh8: prim ids >= 2^24 would lose precision in f32")
    rows[:, COL_PID] = np.where(valid, gids, 0)
    rows[:, COL_MAT] = np.where(valid, mat_id[gids], 0)
    rows[:, COL_FLIP] = np.where(valid, flip[gids].astype(np.float32), 0.0)
    rows[:, COL_KIND] = float(kind)
    return rows


def _check_size(depth: int, groups: int) -> None:
    """The kernel's stack holds one word per group level, and a stack word
    a group id below MAX_GROUPS."""
    if depth > MAX_DEPTH or groups > MAX_GROUPS:
        raise ValueError(
            f"bvh8 tree of depth {depth} and {groups} groups exceeds the "
            f"kernel's MAX_DEPTH={MAX_DEPTH} or MAX_GROUPS={MAX_GROUPS}"
        )


def tree_depth(entries) -> int:
    """Group levels of a tree from its ``entries`` (i32[Ng*8], numpy): the
    stack words the kernel needs.  Raises ValueError on a child id outside
    the groups or on a cycle."""
    e = np.asarray(entries).reshape(-1, FANOUT)
    level = np.zeros(1, np.int64)
    depth = seen = 0
    while level.size:
        depth += 1
        seen += level.size  # a tree visits each group once
        if seen > len(e) or (level >= len(e)).any():
            raise ValueError("bvh8 entries are not a tree: a cycle, a shared group or a group outside")
        kids = e[level].reshape(-1)
        level = kids[(kids >= 0) & (kids != SENT)]
    return depth


def check_tree(entries) -> int:
    """The depth of a tree another compiler built (``SceneData.from_numpy``
    takes the JAX package's), refused as ``build_bvh8`` refuses its own
    where the kernel cannot walk it."""
    depth = tree_depth(entries)
    _check_size(depth, np.asarray(entries).size // FANOUT)
    return depth


def build_bvh8(kind, params, mat_id, flip, pids, bmin, bmax, device=DEFAULT_DEVICE) -> Bvh8Tree:
    """8-ary tree collapsed from the host binned-SAH binary tree ->
    :class:`Bvh8Tree` on ``device`` (default: the card; without one it
    raises).  Each group's 8 slots are formed by repeatedly expanding the
    largest-surface-area internal slot."""
    from ..scene.bvh import build_bvh

    device = resolve_device(device)
    nodes, order = build_bvh(bmin, bmax, leaf_size=LEAF)
    nb_min = nodes["bmin"].T  # (Nn, 3)
    nb_max = nodes["bmax"].T
    lcount = nodes["leaf_count"]
    lstart = nodes["leaf_start"]
    skip = nodes["skip"]
    order = np.asarray(order, dtype=np.int64)

    def area(i: int) -> float:
        e = np.maximum(nb_max[i] - nb_min[i], 0.0)
        return float(e[0] * e[1] + e[1] * e[2] + e[2] * e[0])

    def collect8(i: int) -> list[int]:
        slots = [i] if lcount[i] > 0 else [i + 1, int(skip[i + 1])]
        while len(slots) < FANOUT:
            cand = [s for s in slots if lcount[s] == 0]
            if not cand:
                break
            s = max(cand, key=area)
            slots[slots.index(s)] = s + 1  # preorder: left child
            slots.append(int(skip[s + 1]))  # right child
        return slots

    groups_box: list[np.ndarray] = []
    child_entry: list[np.ndarray] = []
    prim_rows: list[np.ndarray] = []
    ax_order: list[np.ndarray] = []
    max_depth = 0

    _octs = np.array(
        [[1 if o & (1 << a) else -1 for a in range(3)] for o in range(8)], np.float64
    )  # octant o: sign of direction component a = bit a

    def rec(i: int, depth: int) -> int:
        nonlocal max_depth
        max_depth = max(max_depth, depth)
        g = len(groups_box)
        gb = np.zeros((FANOUT, 8), np.float32)
        gb[:, 0:3] = FAR
        gb[:, 3:6] = -FAR
        groups_box.append(gb)
        ce = np.full(FANOUT, SENT, np.int32)
        child_entry.append(ce)
        slots = collect8(i)
        cent = np.full((FANOUT, 3), FAR, np.float64)
        for j, s in enumerate(slots):
            cent[j] = (nb_min[s] + nb_max[s]) * 0.5
        ao = np.zeros(FANOUT, np.int32)
        for o in range(FANOUT):
            proj = cent @ _octs[o]
            proj[np.isnan(proj)] = FAR
            order8 = np.argsort(proj, kind="stable")
            packed = 0
            for ordinal, j in enumerate(order8):
                packed |= int(j) << (3 * ordinal)
            ao[o] = packed
        ax_order.append(ao)
        for j, s in enumerate(slots):
            gb[j, 0:3] = nb_min[s]
            gb[j, 3:6] = nb_max[s]
            if lcount[s] > 0:
                ce[j] = -(len(prim_rows) * LEAF) - 1
                w = order[lstart[s] : lstart[s] + lcount[s]]
                prim_rows.append(np.pad(w, (0, LEAF - len(w)), constant_values=-1))
        for j, s in enumerate(slots):
            if lcount[s] == 0:
                ce[j] = rec(s, depth + 1)
        return g

    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 10000))
    try:
        rec(0, 1)
    finally:
        sys.setrecursionlimit(old)

    _check_size(max_depth, len(groups_box))
    rows = _leaf_rows(kind, params, mat_id, flip, pids, np.stack(prim_rows))
    return Bvh8Tree(
        entries=torch.as_tensor(np.concatenate(child_entry).astype(np.int32), device=device),
        boxes=torch.as_tensor(np.concatenate(groups_box, axis=0), device=device),
        prows=torch.as_tensor(rows, device=device),
        axorder=torch.as_tensor(np.concatenate(ax_order).astype(np.int32), device=device),
        depth=max_depth,
    )


# --------------------------------------------------------------------------
# plain version
# --------------------------------------------------------------------------


def sphere_roots(ocx, ocy, ocz, dx, dy, dz, r):
    """Roots of the ray-sphere quadratic (sphere.rs:39-66) from the f32
    origin-to-center offset -> (root1 f32, root2 f32, disc >= 0).

    The quadratic runs in f64 and only the roots are rounded to f32: for a
    grazing ray ``half_b^2 - a*c`` cancels, and f32 arithmetic that rounds
    differently (the JAX package's XLA fuses multiply-adds) then moves the
    near root by ~1e-4 relative.  In f64 the roots are within f32 rounding
    of exact.  A zero-length direction divides by 1, like ``safe_div``.
    ``csrc/bvh8.cu`` does the same operations in the same order on the
    lanes it keeps; a missed lane's roots are never read.  Differentiable
    through the f64 casts, grad-safe on missed lanes (``masked_sqrt``).
    """
    ocx, ocy, ocz = ocx.double(), ocy.double(), ocz.double()
    dx, dy, dz, r = dx.double(), dy.double(), dz.double(), r.double()
    a = dx * dx + dy * dy + dz * dz
    hb = ocx * dx + ocy * dy + ocz * dz
    cc = ocx * ocx + ocy * ocy + ocz * ocz - r * r
    disc = hb * hb - a * cc
    ok = disc >= 0.0
    sq = masked_sqrt(disc, ok)
    a = torch.where(a == 0.0, 1.0, a)
    return ((-hb - sq) / a).float(), ((-hb + sq) / a).float(), ok


def leaf_t(kind: int, pb, ox, oy, oz, dx, dy, dz, tmv, t_min: float, t_best):
    """Candidate t of leaf rows against rays; FAR on a miss.

    ``pb[j]`` is leaf-row column j (shape ``(C, 1)``), the ray components
    are ``(1, N)``.  Same formulas, in the same operation order, as the
    kernel's ``leaf_t`` in ``csrc/bvh8.cu`` and the JAX package's
    ``_leaf_test`` (sphere.rs:39-66, aarect.rs:47-66, triangle.rs:33-63,
    ring.rs:36-52).
    """
    if kind in (SPHERE, MSPHERE):
        c0x, c0y, c0z, r = pb[0], pb[1], pb[2], pb[3]
        if kind == MSPHERE:
            t0, t1 = pb[7], pb[8]
            denom = t1 - t0
            nz = denom != 0.0
            frac = torch.where(nz, (tmv - t0) / torch.where(nz, denom, 1.0), 0.0)
            cx = c0x + (pb[4] - c0x) * frac
            cy = c0y + (pb[5] - c0y) * frac
            cz = c0z + (pb[6] - c0z) * frac
        else:
            cx, cy, cz = c0x, c0y, c0z
        # the quadratic in f64 (see sphere_roots): grazing rays cancel in disc
        r1, r2, ok = sphere_roots(ox - cx, oy - cy, oz - cz, dx, dy, dz, r)
        v1 = ok & (r1 >= t_min) & (r1 <= t_best)
        v2 = ok & (r2 >= t_min) & (r2 <= t_best)
        return torch.where(v1, r1, torch.where(v2, r2, FAR))

    if kind == RECT:
        a0, a1, b0, b1, kk, ax = pb[0], pb[1], pb[2], pb[3], pb[4], pb[5]
        ok_ = torch.where(ax == 0.0, ox, torch.where(ax == 1.0, oy, oz))
        dk = torch.where(ax == 0.0, dx, torch.where(ax == 1.0, dy, dz))
        t = (kk - ok_) / torch.where(dk != 0.0, dk, 1.0)
        av = torch.where(ax == 0.0, oy + t * dy, ox + t * dx)
        bv = torch.where(ax == 2.0, oy + t * dy, oz + t * dz)
        valid = (
            (dk != 0.0) & (t >= t_min) & (t <= t_best)
            & (av >= a0) & (av <= a1) & (bv >= b0) & (bv <= b1)
        )
        return torch.where(valid, t, FAR)

    if kind == TRIANGLE:
        ax_, ay, az = pb[0], pb[1], pb[2]
        bx, by, bz = pb[3], pb[4], pb[5]
        cx, cy, cz = pb[6], pb[7], pb[8]
        abx, aby, abz = bx - ax_, by - ay, bz - az
        acx, acy, acz = cx - ax_, cy - ay, cz - az
        nx = aby * acz - abz * acy
        ny = abz * acx - abx * acz
        nz = abx * acy - aby * acx
        nlen = torch.sqrt(nx * nx + ny * ny + nz * nz)
        inv = 1.0 / torch.where(nlen == 0.0, 1.0, nlen)
        nx, ny, nz = nx * inv, ny * inv, nz * inv
        denom = dx * nx + dy * ny + dz * nz
        t = ((ax_ - ox) * nx + (ay - oy) * ny + (az - oz) * nz) / torch.where(
            denom != 0.0, denom, 1.0
        )
        px = ox + dx * t
        py = oy + dy * t
        pz = oz + dz * t

        def crs(ux, uy, uz, vx, vy, vz):
            return uy * vz - uz * vy, uz * vx - ux * vz, ux * vy - uy * vx

        def dt3(ux, uy, uz, vx, vy, vz):
            return ux * vx + uy * vy + uz * vz

        e0 = crs(acx, acy, acz, px - ax_, py - ay, pz - az)
        r0 = crs(acx, acy, acz, abx, aby, abz)
        bax, bay, baz = ax_ - bx, ay - by, az - bz
        e1 = crs(bax, bay, baz, px - bx, py - by, pz - bz)
        r1 = crs(bax, bay, baz, cx - bx, cy - by, cz - bz)
        cbx, cby, cbz = bx - cx, by - cy, bz - cz
        e2 = crs(cbx, cby, cbz, px - cx, py - cy, pz - cz)
        r2 = crs(cbx, cby, cbz, ax_ - cx, ay - cy, az - cz)
        inside = (dt3(*e0, *r0) >= 0.0) & (dt3(*e1, *r1) >= 0.0) & (dt3(*e2, *r2) >= 0.0)
        valid = (denom != 0.0) & (nlen != 0.0) & (t >= t_min) & (t <= t_best) & inside
        return torch.where(valid, t, FAR)

    if kind == RING:
        dmin2, dmax2 = pb[2], pb[3]
        t = -oy / torch.where(dy != 0.0, dy, 1.0)
        px = ox + t * dx
        pz = oz + t * dz
        dd = px * px + pz * pz
        valid = (dy != 0.0) & (t >= t_min) & (t <= t_best) & (dd >= dmin2) & (dd <= dmax2)
        return torch.where(valid, t, FAR)

    raise ValueError(f"bvh8: unsupported kind {kind}")


def traverse_bvh8_plain(tree: Bvh8Tree, kind: int, o, d, tm, t_min: float, t_init):
    """Brute force over every leaf row -> (t f32[N], best i32[N], rows
    f32[NCOL, N]); the kernel's contract with ``t_init`` already clamped to
    FAR.  A prim replaces the running winner on a strictly smaller t, or on
    an equal t with a smaller prim id."""
    n = o.shape[1]
    prows = tree.prows
    nrows = prows.shape[0]
    chunk = max(1, min(nrows, _PLAIN_ELEMS // max(n, 1)))
    ox, oy, oz = o[0][None], o[1][None], o[2][None]
    dx, dy, dz = d[0][None], d[1][None], d[2][None]
    tmv = tm[None]
    tb = t_init[None]
    t_run = torch.full((n,), FAR, dtype=torch.float32, device=o.device)
    pid_run = torch.full((n,), _NO_PID, dtype=torch.float32, device=o.device)
    row_run = torch.zeros((n,), dtype=torch.int64, device=o.device)
    for cs in range(0, nrows, chunk):
        pb = prows[cs : cs + chunk].T[:, :, None]  # (NCOL, C, 1)
        tj = leaf_t(kind, pb, ox, oy, oz, dx, dy, dz, tmv, t_min, tb)  # (C, N)
        tmc = tj.min(dim=0).values
        cand = torch.where(tj == tmc[None], pb[COL_PID], _NO_PID)
        pidc, rowc = cand.min(dim=0)
        better = (tmc < t_run) | ((tmc == t_run) & (pidc < pid_run))
        t_run = torch.where(better, tmc, t_run)
        pid_run = torch.where(better, pidc, pid_run)
        row_run = torch.where(better, rowc + cs, row_run)
    upd = (t_run < t_init) & (t_run < FAR)
    t = torch.where(upd, t_run, t_init)
    best = torch.where(upd, pid_run.to(torch.int32), -1)
    rows = torch.where(upd[None], prows[row_run].T, 0.0)
    return t, best, rows


# --------------------------------------------------------------------------
# reference walk (tests and chip_smoke.py only)
# --------------------------------------------------------------------------


def walk_bvh8_reference(tree: Bvh8Tree, kind: int, o, d, tm, t_min: float, t_init):
    """The kernel's walk in numpy, one ray at a time -> (t f32[N], best
    i32[N], groups visited, leaves visited, deepest stack), the last three
    i32[N].

    ``o``, ``d`` are f32[3, N], ``tm`` and ``t_init`` f32[N] (``t_init``
    clamped to FAR), all numpy.  Same compact stack and visit order as
    ``csrc/bvh8.cu``: a visited group pushes one entry, its hit children
    as an ordinal mask of the ray's octant order, and the walk pops the
    nearest remaining child of the top entry.  The slab test is the
    kernel's f32 arithmetic (numpy's minimum/maximum propagate NaN like
    the kernel's); a leaf's 16 rows go through :func:`leaf_t`.
    """
    entries = tree.entries.cpu().numpy().reshape(-1, FANOUT)
    axorder = tree.axorder.cpu().numpy().reshape(-1, FANOUT)
    boxes = tree.boxes.cpu().numpy().reshape(-1, FANOUT, 8)
    prows = tree.prows.cpu()
    f32 = np.float32
    o, d = np.asarray(o, f32), np.asarray(d, f32)
    tm, t_init = np.asarray(tm, f32), np.asarray(t_init, f32)
    n = o.shape[1]
    t_out = np.empty(n, f32)
    best = np.full(n, -1, np.int32)
    visits = np.zeros((3, n), np.int32)
    tmin32, far32 = f32(t_min), f32(FAR)
    shifts = 3 * np.arange(FANOUT)
    for i in range(n):
        org = o[:, i]
        with np.errstate(divide="ignore"):
            inv = f32(1.0) / d[:, i]
        oct_ = int(d[0, i] > 0) + 2 * int(d[1, i] > 0) + 4 * int(d[2, i] > 0)
        ray = [torch.tensor([[x]], dtype=torch.float32) for x in (*org, *d[:, i], tm[i])]
        t_best = t_init[i]
        stack: list = []  # [group, ordinal mask]
        node = 0
        while node != NONE:
            if node >= 0:
                with np.errstate(invalid="ignore", over="ignore"):
                    t0 = (boxes[node, :, 0:3] - org) * inv
                    t1 = (boxes[node, :, 3:6] - org) * inv
                lo, hi = np.minimum(t0, t1), np.maximum(t0, t1)
                tnear = np.maximum(np.maximum(lo[:, 0], lo[:, 1]), np.maximum(lo[:, 2], tmin32))
                tfar = np.minimum(np.minimum(hi[:, 0], hi[:, 1]), np.minimum(hi[:, 2], t_best))
                hit = (tfar >= tnear) & (entries[node] != SENT)
                slots = (int(axorder[node, oct_]) >> shifts) & 7
                mask = int((hit[slots].astype(np.int64) << np.arange(FANOUT)).sum())
                visits[0, i] += 1
                if mask:
                    stack.append([node, mask])
                    visits[2, i] = max(visits[2, i], len(stack))
            else:
                ptr = -node - 1
                pb = prows[ptr : ptr + LEAF].T[:, :, None]
                t_b = torch.tensor([[t_best]], dtype=torch.float32)
                tj = leaf_t(kind, pb, *ray, t_min, t_b)[:, 0].numpy()
                pid = pb[COL_PID, :, 0].numpy()
                tl, sel = far32, f32(_NO_PID)
                for s in range(LEAF):
                    if tj[s] < far32 and (tj[s] < tl or (tj[s] == tl and pid[s] < sel)):
                        tl, sel = tj[s], pid[s]
                if tl < t_best and tl < far32:
                    t_best, best[i] = tl, int(sel)
                visits[1, i] += 1
            node = NONE
            if stack:
                g, mask = stack[-1]
                k = (mask & -mask).bit_length() - 1
                if mask & (mask - 1):
                    stack[-1][1] = mask & (mask - 1)
                else:
                    stack.pop()
                node = int(entries[g, (int(axorder[g, oct_]) >> (3 * k)) & 7])
        t_out[i] = t_best
    return t_out, best, visits[0], visits[1], visits[2]


# --------------------------------------------------------------------------
# kernel K1 (csrc/bvh8.cu)
# --------------------------------------------------------------------------

_KINDS = (SPHERE, MSPHERE, RECT, TRIANGLE, RING)


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a ``csrc/bvh8.cu`` build on ``lib``."""
    fn = lib.rt_bvh8_traverse
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int] + [
        ctypes.c_void_p
    ] * 15
    lib.rt_bvh8_shared_fits.restype = ctypes.c_int
    lib.rt_bvh8_shared_fits.argtypes = [ctypes.c_int, ctypes.c_int]
    return lib


@functools.cache
def _kernel_lib():
    from ..cuda_build import load

    return declare(load("bvh8.cu"))


def _tree_in_shared(lib, ng: int, depth: int) -> bool:
    """Whether a tree of ``ng`` groups and ``depth`` levels (its stack)
    fits the kernel's shared-memory instantiation on the current device
    (the tests replace this to run the global-memory one)."""
    fits = lib.rt_bvh8_shared_fits(ng, depth)
    if fits < 0:
        raise RuntimeError(f"bvh8 shared-memory query failed: cudaError {-fits}")
    return fits == 1


def _check(x: torch.Tensor, name: str, dtype, shape, device, vectors: bool = False):
    if x.dtype != dtype or tuple(x.shape) != tuple(shape) or x.device != device:
        raise ValueError(
            f"traverse_bvh8: {name} must be {dtype} {tuple(shape)} on {device}, "
            f"got {x.dtype} {tuple(x.shape)} on {x.device}"
        )
    if not x.is_contiguous():
        raise ValueError(f"traverse_bvh8: {name} must be contiguous")
    if vectors and x.data_ptr() % 16:  # bulk copies and 16-byte loads
        raise ValueError(f"traverse_bvh8: {name} must be 16-byte aligned")


def _traverse_cuda(tree: Bvh8Tree, kind: int, o, d, tm, t_min: float, t_init, return_rows,
                   return_visits):
    n = o.shape[1]
    dev = o.device
    f32, i32 = torch.float32, torch.int32
    ng8 = tree.entries.shape[0]
    _check(o, "o", f32, (3, n), dev)
    _check(d, "d", f32, (3, n), dev)
    _check(tm, "tm", f32, (n,), dev)
    _check(t_init, "t_init", f32, (n,), dev)
    _check(tree.entries, "entries", i32, (ng8,), dev, vectors=True)
    _check(tree.axorder, "axorder", i32, (ng8,), dev, vectors=True)
    _check(tree.boxes, "boxes", f32, (ng8, 8), dev, vectors=True)
    _check(tree.prows, "prows", f32, (tree.prows.shape[0], NCOL), dev, vectors=True)
    if ng8 % FANOUT or ng8 // FANOUT > MAX_GROUPS or not 1 <= tree.depth <= MAX_DEPTH:
        raise ValueError(f"traverse_bvh8: {ng8} group slots of depth {tree.depth} is not a tree the kernel takes")
    t = torch.empty((n,), dtype=f32, device=dev)
    best = torch.empty((n,), dtype=i32, device=dev)
    rows = torch.empty((NCOL, n), dtype=f32, device=dev) if return_rows else None
    win = torch.empty((n,), dtype=i32, device=dev) if return_rows else None
    visits = torch.empty((2, n), dtype=i32, device=dev) if return_visits else None
    if n == 0:
        return t, best, rows, visits

    def ptr(x):
        return None if x is None else x.data_ptr()

    global LAUNCHES, TREE_MEMORY
    lib = _kernel_lib()
    with torch.cuda.device(dev):  # the launch goes to the current device
        shared = _tree_in_shared(lib, ng8 // FANOUT, tree.depth)
        counter = torch.zeros((1,), dtype=i32, device=dev)
        LAUNCHES += 1
        TREE_MEMORY = "shared" if shared else "global"
        err = lib.rt_bvh8_traverse(
            kind, int(shared), t_min, n, ng8 // FANOUT, tree.depth,
            tree.entries.data_ptr(), tree.axorder.data_ptr(),
            tree.boxes.data_ptr(), tree.prows.data_ptr(),
            o.data_ptr(), d.data_ptr(), tm.data_ptr(), t_init.data_ptr(),
            t.data_ptr(), best.data_ptr(), ptr(win), ptr(rows), ptr(visits), counter.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"bvh8 kernel launch failed: cudaError {err}")
    return t, best, rows, visits


def traverse_bvh8(
    tree: Bvh8Tree,
    kind: int,
    o: torch.Tensor,  # (3, N)
    d: torch.Tensor,
    tm: torch.Tensor,  # (N,)
    t_min: float,
    t_init: Optional[torch.Tensor] = None,  # (N,) running closest hit (prunes)
    return_rows: bool = False,  # also return winner leaf rows f32[NCOL, N]
    return_visits: bool = False,  # also return the kernel's visit counts i32[2, N]
):
    """Closest hit in one 8-ary tree -> (t f32[N], best i32[N][, rows][, visits]).

    ``best`` is -1 where no hit beat ``t_init`` (+inf is clamped to FAR);
    ``rows`` carries the winning primitive's full leaf row (zeros where
    ``best`` < 0); ``visits`` (CUDA tensors only) holds the groups and the
    leaves each ray visited.  CUDA tensors launch kernel K1 and record in
    ``TREE_MEMORY`` whether its group arrays were read from shared or
    global memory; CPU tensors run :func:`traverse_bvh8_plain`.  Forward
    only, as in the JAX package: K1 has no backward, so ``closest_hit``
    passes detached rays on both devices and recomputes the winner's t.
    """
    if kind not in _KINDS:
        raise ValueError(f"bvh8: unsupported kind {kind}")
    n = o.shape[1]
    if t_init is None:
        t_init = torch.full((n,), FAR, dtype=torch.float32, device=o.device)
    else:
        t_init = torch.clamp(t_init, max=FAR)
    if o.device.type == "cpu":
        if return_visits:
            raise ValueError("traverse_bvh8: visit counts come from the kernel; on the CPU "
                             "walk_bvh8_reference gives them")
        t, best, rows = traverse_bvh8_plain(tree, kind, o, d, tm, float(t_min), t_init)
        visits = None
    elif o.device.type == "cuda":
        t, best, rows, visits = _traverse_cuda(
            tree, kind, o, d, tm, float(t_min), t_init.contiguous(), return_rows, return_visits
        )
    else:
        raise ValueError(f"traverse_bvh8: no kernel for device {o.device}")
    return (t, best) + ((rows,) if return_rows else ()) + ((visits,) if return_visits else ())
