"""Minimal OBJ loader (host-side), counterpart of the JAX package's
``scene/objio.py``: triangulate + single-index semantics (reference:
raytracer/src/scene.rs:364-414); ``vt`` records and per-corner "p/t"
indices feed ObjTexture (reference texture/mod.rs:141-189).
"""

from __future__ import annotations

import numpy as np


def load_obj(path: str):
    """Parse an OBJ file -> (verts f64[V, 3], faces i64[F, 3],
    face_uvs f64[F, 3, 2] | None).

    Face indices are 0-based position indices (negative OBJ indices are
    supported); faces with more than 3 vertices are fan-triangulated.  Uses
    the C++ parser when the native library loads, else this Python path.
    """
    from ..native import load_obj_native

    out = load_obj_native(path)
    if out is not None:
        return out

    verts: list[list[float]] = []
    uvs: list[list[float]] = []
    faces: list[tuple[int, int, int]] = []
    face_uv_idx: list[tuple[int, int, int]] = []

    def resolve(tok: str) -> int:
        idx = int(tok.split("/")[0])
        return idx - 1 if idx > 0 else len(verts) + idx

    def resolve_uv(tok: str) -> int:
        parts = tok.split("/")
        if len(parts) < 2 or parts[1] == "":
            return -1
        idx = int(parts[1])
        return idx - 1 if idx > 0 else len(uvs) + idx

    with open(path, "r", errors="replace") as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif line.startswith("vt "):
                parts = line.split()
                uvs.append([float(parts[1]), float(parts[2]) if len(parts) > 2 else 0.0])
            elif line.startswith("f "):
                toks = line.split()[1:]
                idx = [resolve(tok) for tok in toks]
                tdx = [resolve_uv(tok) for tok in toks]
                for k in range(1, len(idx) - 1):  # fan triangulation
                    faces.append((idx[0], idx[k], idx[k + 1]))
                    face_uv_idx.append((tdx[0], tdx[k], tdx[k + 1]))

    verts_a = np.asarray(verts, dtype=np.float64)
    faces_a = np.asarray(faces, dtype=np.int64)
    face_uvs = None
    if uvs:
        fuv_idx = np.asarray(face_uv_idx, dtype=np.int64)
        if (fuv_idx >= 0).any():
            uv_a = np.asarray(uvs, dtype=np.float64)
            safe = np.clip(fuv_idx, 0, len(uvs) - 1)
            face_uvs = uv_a[safe]
            face_uvs[fuv_idx < 0] = 0.0
    return verts_a, faces_a, face_uvs
