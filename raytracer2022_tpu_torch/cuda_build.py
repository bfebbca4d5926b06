"""Build the package's hand-written CUDA kernels with nvcc and load them.

Each ``csrc/*.cu`` file has a plain C interface and is compiled at first
use into ``kernels/<stem>-<hash>.so`` under :func:`build_root` (the hash
covers the source, the ``csrc/`` headers it includes and the flags, so an
edited source or header rebuilds), then
loaded with ctypes.  The sources ship with the package, installed or not.
Nothing is built when the package is imported: only a kernel launch on a
CUDA tensor reaches here.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")


def build_root() -> str:
    """Where the package builds what it compiles: ``build/`` at the
    repository root in a checkout (the package's parent directory holds this
    repository's ``pyproject.toml``, and ``.gitignore`` lists ``build/``);
    for an installed package, a per-user cache directory,
    ``$XDG_CACHE_HOME/raytracer2022_tpu_torch`` (``~/.cache`` when that is
    unset), so that it never writes under its own installed tree."""
    root = os.path.dirname(_PKG_DIR)
    try:
        with open(os.path.join(root, "pyproject.toml")) as f:
            checkout = 'name = "raytracer2022-tpu"' in f.read()
    except FileNotFoundError:
        checkout = False
    if checkout:
        return os.path.join(root, "build")
    cache = os.environ.get("XDG_CACHE_HOME") or os.path.join(os.path.expanduser("~"), ".cache")
    return os.path.join(cache, "raytracer2022_tpu_torch")


BUILD_DIR = os.path.join(build_root(), "kernels")

# sm_90a: Hopper.  No --use_fast_math: the slab tests rely on IEEE 1/0 = inf
# and parity with the plain versions is judged at rtol 2e-5.  -fmad=false
# keeps every a*b+c as two rounded operations, the same arithmetic as the
# plain PyTorch versions, so kernel and plain version agree to the bit on
# the same winner.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _text(path: str) -> bytes:
    """The bytes of ``path`` followed by those of each ``csrc/`` header it
    includes by a quoted name: what its build depends on."""
    with open(path, "rb") as f:
        text = f.read()
    for name in re.findall(rb'^#include "([^"]+)"', text, flags=re.MULTILINE):
        text += _text(os.path.join(CSRC_DIR, name.decode()))
    return text


def build(source: str) -> tuple[str, str, float]:
    """Compile ``csrc/<source>`` unless a build of this exact source exists.

    Returns ``(so_path, compiler_log, seconds)``; seconds is 0 and the log
    empty when the cached library was reused.
    """
    src = os.path.join(CSRC_DIR, source)
    digest = hashlib.sha256(_text(src) + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    stem = os.path.splitext(source)[0]
    so_path = os.path.join(BUILD_DIR, f"{stem}-{digest}.so")
    if os.path.exists(so_path):
        return so_path, "", 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so_path}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, src], capture_output=True, text=True, timeout=600
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, so_path)  # atomic: a concurrent loader never sees a torn file
    return so_path, proc.stdout + proc.stderr, time.perf_counter() - t0


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built on first use."""
    with _lock:
        lib = _loaded.get(source)
        if lib is None:
            lib = ctypes.CDLL(build(source)[0])
            _loaded[source] = lib
        return lib
