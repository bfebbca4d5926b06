"""Kernel K1's roofline: the least time of one launch, frozen here.

K1 (the program's 8-ary BVH walk, kernels ``bvh8_walk`` and ``bvh8_rows``)
on ``n`` rays that visit ``groups`` groups and ``leaves`` leaves in all
reads each input once (a ray 32 B: origin, direction, time, t_init; the
tree's four arrays) and writes each output once (t and the winner 8 B a
ray, the winner's row 96 B where asked for); it makes 8 child slab tests a
group and 16 row tests a leaf.  The least time is the larger of the bytes
over the card's memory rate and the operations over the peak rate of
their type.

Peaks of one H100 SXM (NVIDIA's data sheet, 700 W): 3.35 TB/s, 67 TFLOP/s
in f32 and 34 TFLOP/s in f64 outside the tensor cores.  Those count a fused
multiply-add as two operations; K1 is built with -fmad=false, so each of
its operations is one instruction, and the bound takes half of each peak:
one instruction per lane and cycle.  Operation counts per slab test and
per row of each kind follow the kernel's source (``csrc/bvh8.cu``:
``leaf_t``), counting each add, sub, mul, div, sqrt and compare once.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12 / 2
F64_OPS_PER_S = 34e12 / 2
BOX_OPS = 25  # f32 ops of one child's slab test: 6 sub, 6 mul, 12 min/max, 1 compare
SPHERE, MSPHERE, RECT, TRIANGLE, RING = 0, 1, 2, 3, 4  # the program's primitive kinds
ROW_OPS = {SPHERE: (7, 27), MSPHERE: (20, 27), RECT: (18, 0), TRIANGLE: (144, 0), RING: (14, 0)}  # (f32, f64)


def k1_bound(tree_bytes: int, kind: int, n: int, groups: int, leaves: int, rows: bool) -> dict:
    """The least time of one K1 launch -> ``bound_ms``, ``bound_by``,
    ``bytes``, ``f32_ops``, ``f64_ops``."""
    nbytes = n * 32 + n * 8 + (n * 96 if rows else 0) + tree_bytes
    f32 = BOX_OPS * 8 * groups + ROW_OPS[kind][0] * 16 * leaves
    f64 = ROW_OPS[kind][1] * 16 * leaves
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = f32 / F32_OPS_PER_S + f64 / F64_OPS_PER_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3, "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "f32_ops": f32, "f64_ops": f64}


def tree_bytes(tree) -> int:
    """Bytes of a tree's four arrays (entries, axorder, boxes, prows)."""
    return sum(x.numel() * x.element_size() for x in (tree.entries, tree.axorder, tree.boxes, tree.prows))
