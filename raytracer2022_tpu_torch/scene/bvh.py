"""Host-side BVH build, flattened in preorder with skip links.

Counterpart of ``raytracer2022_tpu/scene/bvh.py``: the native binned-SAH
builder when the port's host runtime loads (``native.py``), else the same NumPy
largest-extent median split.  Node ``i`` continues to ``i+1`` on an AABB
hit and jumps to ``skip[i]`` on a miss; leaves own contiguous windows of
the reordered primitive array.
"""

from __future__ import annotations

import sys

import numpy as np


def build_bvh(bmin: np.ndarray, bmax: np.ndarray, leaf_size: int = 4):
    """Flattened BVH over ``f32[P, 3]`` bounds -> ``(nodes, order)``.

    ``order`` is the primitive permutation (prim ``order[j]`` is the j-th
    prim in leaf windows); ``nodes`` holds ``bmin/bmax f32[3, Nn]`` and
    ``leaf_start/leaf_count/skip i32[Nn]`` (leaf_count == 0 for internal
    nodes).
    """
    from ..native import build_bvh_native

    out = build_bvh_native(bmin, bmax, leaf_size=leaf_size, sah=True)
    if out is not None:
        return out

    n = len(bmin)
    centroid = (bmin + bmax) * 0.5
    order: list[int] = []
    nb_min: list[np.ndarray] = []
    nb_max: list[np.ndarray] = []
    leaf_start: list[int] = []
    leaf_count: list[int] = []
    skip: list[int] = []

    def rec(ids: np.ndarray) -> None:
        node = len(nb_min)
        nb_min.append(bmin[ids].min(axis=0))
        nb_max.append(bmax[ids].max(axis=0))
        leaf_start.append(0)
        leaf_count.append(0)
        skip.append(0)
        if len(ids) <= leaf_size:
            leaf_start[node] = len(order)
            leaf_count[node] = len(ids)
            order.extend(int(i) for i in ids)
        else:
            c = centroid[ids]
            axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
            ids = ids[np.argsort(c[:, axis], kind="stable")]
            mid = len(ids) // 2
            rec(ids[:mid])
            rec(ids[mid:])
        skip[node] = len(nb_min)

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 64 + 4 * int(np.ceil(np.log2(max(n, 2)))) * 32))
    try:
        rec(np.arange(n))
    finally:
        sys.setrecursionlimit(old_limit)

    nodes = {
        "bmin": np.stack(nb_min).T.astype(np.float32),
        "bmax": np.stack(nb_max).T.astype(np.float32),
        "leaf_start": np.array(leaf_start, dtype=np.int32),
        "leaf_count": np.array(leaf_count, dtype=np.int32),
        "skip": np.array(skip, dtype=np.int32),
    }
    return nodes, np.array(order, dtype=np.int64)
