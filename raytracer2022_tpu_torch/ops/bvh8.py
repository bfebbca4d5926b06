"""8-ary BVH: host build, and the closest-hit walk as a CUDA kernel (K1).

Counterpart of ``raytracer2022_tpu/ops/bvh8.py``.  The host build
(:func:`build_bvh8`, :func:`_leaf_rows`) is the JAX package's code
unchanged: the 8-ary topology is collapsed from the host binned-SAH binary
tree, every leaf holds 16 primitive rows of 24 f32 columns (the full param
row, then pid/mat/flip/kind), and each group stores a near-first child
order per ray-sign octant.

:func:`traverse_bvh8` is the wrapper.  For CUDA tensors it launches the
hand-written kernel ``csrc/bvh8.cu`` (one thread per ray, a local stack)
and counts the launch in ``traverse_bvh8.launches``; for CPU tensors it
runs :func:`traverse_bvh8_plain`, a chunked brute force over the tree's
leaf rows with the same per-kind formulas, FAR sentinel, ``t_init`` rule
and tie rule.  Both return the same three outputs.  Exact-t ties across
two leaves may resolve differently (the walk keeps the first leaf it
visits, the plain version the smallest prim id), so the two agree on the
hit mask and t, and on the id wherever no such tie exists.
"""

from __future__ import annotations

import ctypes
import sys
from typing import Optional

import numpy as np
import torch

from ..scene.types import MSPHERE, RECT, RING, SPHERE, TRIANGLE, Bvh8Tree

LEAF = 16  # prims per leaf
FANOUT = 8
MAX_STACK = 160  # must match csrc/bvh8.cu
SENT = 0x7FFFFFFF  # empty-child tag, never pushed
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


def build_bvh8(kind, params, mat_id, flip, pids, bmin, bmax, device="cpu") -> Bvh8Tree:
    """8-ary tree collapsed from the host binned-SAH binary tree ->
    :class:`Bvh8Tree` on ``device``.  Each group's 8 slots are formed by
    repeatedly expanding the largest-surface-area internal slot."""
    from ..scene.bvh import build_bvh

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

    # every pop pushes at most FANOUT-1 net entries per level
    need = (FANOUT - 1) * max_depth + 1
    if need > MAX_STACK:
        raise ValueError(
            f"bvh8 stack bound {need} exceeds MAX_STACK={MAX_STACK} (tree depth {max_depth})"
        )

    rows = _leaf_rows(kind, params, mat_id, flip, pids, np.stack(prim_rows))
    return Bvh8Tree(
        entries=torch.as_tensor(np.concatenate(child_entry).astype(np.int32), device=device),
        boxes=torch.as_tensor(np.concatenate(groups_box, axis=0), device=device),
        prows=torch.as_tensor(rows, device=device),
        axorder=torch.as_tensor(np.concatenate(ax_order).astype(np.int32), device=device),
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
    ``csrc/bvh8.cu`` does the same operations in the same order.
    """
    ocx, ocy, ocz = ocx.double(), ocy.double(), ocz.double()
    dx, dy, dz, r = dx.double(), dy.double(), dz.double(), r.double()
    a = dx * dx + dy * dy + dz * dz
    hb = ocx * dx + ocy * dy + ocz * dz
    cc = ocx * ocx + ocy * ocy + ocz * ocz - r * r
    disc = hb * hb - a * cc
    ok = disc >= 0.0
    sq = torch.sqrt(torch.where(ok, disc, 0.0))
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
# kernel K1 (csrc/bvh8.cu)
# --------------------------------------------------------------------------

_KINDS = (SPHERE, MSPHERE, RECT, TRIANGLE, RING)


def _kernel_lib():
    from ..cuda_build import load

    lib = load("bvh8.cu")
    fn = lib.rt_bvh8_traverse
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_float, ctypes.c_int] + [ctypes.c_void_p] * 12
    return lib


def _check(x: torch.Tensor, name: str, dtype, shape, device):
    if x.dtype != dtype or tuple(x.shape) != tuple(shape) or x.device != device:
        raise ValueError(
            f"traverse_bvh8: {name} must be {dtype} {tuple(shape)} on {device}, "
            f"got {x.dtype} {tuple(x.shape)} on {x.device}"
        )
    if not x.is_contiguous():
        raise ValueError(f"traverse_bvh8: {name} must be contiguous")


def _traverse_cuda(tree: Bvh8Tree, kind: int, o, d, tm, t_min: float, t_init, return_rows):
    n = o.shape[1]
    dev = o.device
    f32, i32 = torch.float32, torch.int32
    ng8 = tree.entries.shape[0]
    _check(o, "o", f32, (3, n), dev)
    _check(d, "d", f32, (3, n), dev)
    _check(tm, "tm", f32, (n,), dev)
    _check(t_init, "t_init", f32, (n,), dev)
    _check(tree.entries, "entries", i32, (ng8,), dev)
    _check(tree.axorder, "axorder", i32, (ng8,), dev)
    _check(tree.boxes, "boxes", f32, (ng8, 8), dev)
    _check(tree.prows, "prows", f32, (tree.prows.shape[0], NCOL), dev)
    t = torch.empty((n,), dtype=f32, device=dev)
    best = torch.empty((n,), dtype=i32, device=dev)
    rows = torch.empty((NCOL, n), dtype=f32, device=dev) if return_rows else None
    if n == 0:
        return t, best, rows
    lib = _kernel_lib()
    with torch.cuda.device(dev):  # the launch goes to the current device
        traverse_bvh8.launches += 1
        err = lib.rt_bvh8_traverse(
            kind, t_min, n,
            tree.entries.data_ptr(), tree.axorder.data_ptr(),
            tree.boxes.data_ptr(), tree.prows.data_ptr(),
            o.data_ptr(), d.data_ptr(), tm.data_ptr(), t_init.data_ptr(),
            t.data_ptr(), best.data_ptr(), rows.data_ptr() if return_rows else None,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"bvh8 kernel launch failed: cudaError {err}")
    return t, best, rows


def traverse_bvh8(
    tree: Bvh8Tree,
    kind: int,
    o: torch.Tensor,  # (3, N)
    d: torch.Tensor,
    tm: torch.Tensor,  # (N,)
    t_min: float,
    t_init: Optional[torch.Tensor] = None,  # (N,) running closest hit (prunes)
    return_rows: bool = False,  # also return winner leaf rows f32[NCOL, N]
):
    """Closest hit in one 8-ary tree -> (t f32[N], best i32[N][, rows]).

    ``best`` is -1 where no hit beat ``t_init`` (+inf is clamped to FAR);
    ``rows`` carries the winning primitive's full leaf row (zeros where
    ``best`` < 0).  CUDA tensors launch kernel K1; CPU tensors run
    :func:`traverse_bvh8_plain`.
    """
    if kind not in _KINDS:
        raise ValueError(f"bvh8: unsupported kind {kind}")
    n = o.shape[1]
    if t_init is None:
        t_init = torch.full((n,), FAR, dtype=torch.float32, device=o.device)
    else:
        t_init = torch.clamp(t_init, max=FAR)
    if o.device.type == "cpu":
        t, best, rows = traverse_bvh8_plain(tree, kind, o, d, tm, float(t_min), t_init)
    elif o.device.type == "cuda":
        t, best, rows = _traverse_cuda(
            tree, kind, o, d, tm, float(t_min), t_init.contiguous(), return_rows
        )
    else:
        raise ValueError(f"traverse_bvh8: no kernel for device {o.device}")
    return (t, best, rows) if return_rows else (t, best)


traverse_bvh8.launches = 0  # K1 launches in this process
