"""ctypes bindings for the C++ host runtime (native/rt_native.cpp).

The same ``native/librt_native.so`` the JAX package loads (its
``native.py``): the OBJ parser and the binned-SAH BVH builder.  Nothing
here is copied from the C++; when the library cannot be loaded or built,
every caller falls back to its NumPy path (set ``RT2022_NO_NATIVE=1`` to
force that).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_SO_PATH = os.path.join(_NATIVE_DIR, "librt_native.so")

_lock = threading.Lock()
_lib = None
_tried = False


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if os.environ.get("RT2022_NO_NATIVE"):
            return None
        if not os.path.exists(_SO_PATH) and os.path.isdir(_NATIVE_DIR):
            try:
                subprocess.run(
                    ["make", "-C", _NATIVE_DIR], check=True, capture_output=True, timeout=120
                )
            except (OSError, subprocess.SubprocessError):
                return None
        if not os.path.exists(_SO_PATH):
            return None
        try:
            lib = ctypes.CDLL(_SO_PATH)
        except OSError:
            return None

        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.rt_obj_open.restype = ctypes.c_void_p
        lib.rt_obj_open.argtypes = [ctypes.c_char_p]
        lib.rt_obj_counts.restype = None
        lib.rt_obj_counts.argtypes = [ctypes.c_void_p, i64p, i64p, i64p]
        lib.rt_obj_fill.restype = None
        lib.rt_obj_fill.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_double),
            i64p,
            ctypes.POINTER(ctypes.c_double),
        ]
        lib.rt_obj_close.restype = None
        lib.rt_obj_close.argtypes = [ctypes.c_void_p]
        lib.rt_obj_fill_face_uvs.restype = None
        lib.rt_obj_fill_face_uvs.argtypes = [ctypes.c_void_p, i64p]

        f32p = ctypes.POINTER(ctypes.c_float)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.rt_build_bvh.restype = ctypes.c_int64
        lib.rt_build_bvh.argtypes = [
            f32p, f32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            f32p, f32p, i32p, i32p, i32p, i64p,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    """True when the native library loaded (else the NumPy fallbacks run)."""
    return _load() is not None


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def load_obj_native(path: str):
    """Native OBJ parse -> (verts f64[V,3], faces i64[F,3],
    face_uvs f64[F,3,2] | None), or None when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    h = lib.rt_obj_open(path.encode())
    if not h:
        raise FileNotFoundError(path)
    try:
        nv = ctypes.c_int64()
        nf = ctypes.c_int64()
        nt = ctypes.c_int64()
        lib.rt_obj_counts(h, ctypes.byref(nv), ctypes.byref(nf), ctypes.byref(nt))
        verts = np.empty((nv.value, 3), dtype=np.float64)
        faces = np.empty((nf.value, 3), dtype=np.int64)
        uvs = np.empty((max(nt.value, 1), 2), dtype=np.float64)
        lib.rt_obj_fill(
            h, _ptr(verts, ctypes.c_double), _ptr(faces, ctypes.c_int64),
            _ptr(uvs, ctypes.c_double),
        )
        face_uvs = None
        if nt.value > 0:
            fuv_idx = np.full((nf.value, 3), -1, dtype=np.int64)
            lib.rt_obj_fill_face_uvs(h, _ptr(fuv_idx, ctypes.c_int64))
            if (fuv_idx >= 0).any():
                safe = np.clip(fuv_idx, 0, nt.value - 1)
                face_uvs = uvs[safe]  # (F, 3, 2)
                face_uvs[fuv_idx < 0] = 0.0
        return verts, faces, face_uvs
    finally:
        lib.rt_obj_close(h)


def build_bvh_native(bmin: np.ndarray, bmax: np.ndarray, leaf_size: int = 4, sah: bool = True):
    """Native BVH build -> (nodes dict, order i64[P]) or None; the output
    contract of :func:`raytracer2022_tpu_torch.scene.bvh.build_bvh`."""
    lib = _load()
    if lib is None:
        return None
    n = len(bmin)
    bmin = np.ascontiguousarray(bmin, dtype=np.float32)
    bmax = np.ascontiguousarray(bmax, dtype=np.float32)
    cap = max(2 * n, 1)
    nb_min = np.empty((cap, 3), dtype=np.float32)
    nb_max = np.empty((cap, 3), dtype=np.float32)
    leaf_start = np.empty(cap, dtype=np.int32)
    leaf_count = np.empty(cap, dtype=np.int32)
    skip = np.empty(cap, dtype=np.int32)
    order = np.empty(max(n, 1), dtype=np.int64)
    n_nodes = lib.rt_build_bvh(
        _ptr(bmin, ctypes.c_float), _ptr(bmax, ctypes.c_float), n, leaf_size,
        1 if sah else 0,
        _ptr(nb_min, ctypes.c_float), _ptr(nb_max, ctypes.c_float),
        _ptr(leaf_start, ctypes.c_int32), _ptr(leaf_count, ctypes.c_int32),
        _ptr(skip, ctypes.c_int32), _ptr(order, ctypes.c_int64),
    )
    nodes = {
        "bmin": nb_min[:n_nodes].T.copy(),
        "bmax": nb_max[:n_nodes].T.copy(),
        "leaf_start": leaf_start[:n_nodes].copy(),
        "leaf_count": leaf_count[:n_nodes].copy(),
        "skip": skip[:n_nodes].copy(),
    }
    return nodes, order.copy()
