"""ctypes bindings for the port's C++ host runtime (csrc/rt_native.cpp).

The OBJ parser and the binned-SAH BVH builder, the port's own copy of the
JAX package's native runtime.  The source is compiled with ``g++`` at first
use into ``build/native/rt_native-<hash>.so`` at the repository root, on
the host that runs it (``-march=native``); the hash covers the source, the
flags and the host's CPU (a library built for another CPU is never
loaded), and the library is renamed into place atomically, so concurrent
test workers never load a torn file.  Where ``g++`` is missing, every
caller takes its NumPy path, as the JAX package does (set
``RT2022_NO_NATIVE=1`` to force that).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading

import numpy as np

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_PKG_DIR, "csrc", "rt_native.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "native")
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17", "-Wall")  # native/Makefile's

_lock = threading.Lock()
_lib = None
_tried = False
LIBRARY_PATH: str | None = None  # the library that loaded, for reports and tests


def _cpu_identity() -> bytes:
    """What ``-march=native`` compiles for: the CPU's model and flags."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = f.read().splitlines()
    except OSError:
        return platform.machine().encode() + platform.processor().encode()
    keep = [ln for ln in lines if ln.startswith((b"model name", b"flags", b"Features", b"CPU part"))]
    return b"\n".join(sorted(set(keep)))


def build() -> str | None:
    """Compile the runtime unless a build of this exact source exists;
    its path, or None where there is no ``g++``."""
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        return None
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(CXX_FLAGS).encode() + _cpu_identity()).hexdigest()[:16]
    so_path = os.path.join(BUILD_DIR, f"rt_native-{digest}.so")
    if os.path.exists(so_path):
        return so_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so_path}.{os.getpid()}.{threading.get_ident()}.tmp"
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE], capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {SOURCE}:\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, so_path)  # atomic: a concurrent loader never sees a torn file
    return so_path


def _load():
    global _lib, _tried, LIBRARY_PATH
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if os.environ.get("RT2022_NO_NATIVE"):
            return None
        so_path = build()
        if so_path is None:
            return None
        lib = ctypes.CDLL(so_path)
        LIBRARY_PATH = so_path

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
