"""Compiled flat SoA scene representation (PyTorch).

Counterpart of ``raytracer2022_tpu/scene/types.py``: the scene compiler
(:mod:`raytracer2022_tpu_torch.scene.builder`) lowers every hittable into
rows of flat tensors, and dispatch happens by integer ``kind`` with masked
vectorized evaluation.  The layouts are the JAX package's, so the two
compilers produce identical arrays:

  * per-primitive arrays are field-leading: ``params[j]`` is ``[P]``;
  * vectors are component-leading ``(3, ...)``.

Primitive param slots (``params: f32[NPARAM, P]``) are documented in the
JAX package's module; they are unchanged here.

The JAX package's ``flax.struct`` dataclasses become frozen dataclasses of
tensors.  Static metadata lives in :class:`SceneStats`, exactly as there.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..utils.device import DEFAULT_DEVICE, resolve_device

# Primitive kinds
SPHERE = 0
MSPHERE = 1
RECT = 2
TRIANGLE = 3
RING = 4
MEDIUM = 5
BOX = 6

NPARAM = 16

# Material kinds (reference material/mod.rs)
LAMBERTIAN = 0
METAL = 1
DIELECTRIC = 2
DIFFUSE_LIGHT = 3
ISOTROPIC = 4

# Texture kinds (reference texture/mod.rs)
TEX_SOLID = 0
TEX_CHECKER = 1
TEX_NOISE = 2
TEX_IMAGE = 3
TEX_OBJUV = 4


def _to_numpy(obj):
    """Tensors -> numpy arrays, recursively through dataclasses/tuples."""
    if obj is None:
        return None
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if dataclasses.is_dataclass(obj):
        return {f.name: _to_numpy(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, tuple):
        return [_to_numpy(x) for x in obj]
    return obj


def _tensors(cls, arrays: dict, device):
    """Build dataclass ``cls`` from a dict of numpy arrays on ``device``."""
    return cls(
        **{
            f.name: torch.tensor(np.asarray(arrays[f.name]), device=device)
            for f in dataclasses.fields(cls)
        }
    )


@dataclasses.dataclass(frozen=True)
class TextureTable:
    """Flat texture table (reference texture/mod.rs traits -> integer ids)."""

    kind: torch.Tensor  # i32[T]
    color: torch.Tensor  # f32[3, T]
    sub: torch.Tensor  # i32[2, T] checker (odd, even)
    scale: torch.Tensor  # f32[T] noise scale
    img: torch.Tensor  # i32[T] atlas index
    atlas: torch.Tensor  # u32[I, Hmax, Wmax] packed RGB
    atlas_size: torch.Tensor  # i32[2, I] (h, w)
    perlin_vec: torch.Tensor  # f32[3, 256]
    perlin_perm: torch.Tensor  # i32[3, 256]


@dataclasses.dataclass(frozen=True)
class MaterialTable:
    """Flat material table (reference material/mod.rs:15-25).  ``param`` is
    fuzz for METAL, ir for DIELECTRIC."""

    kind: torch.Tensor  # i32[M]
    tex: torch.Tensor  # i32[M] albedo / emission texture id
    param: torch.Tensor  # f32[M]


@dataclasses.dataclass(frozen=True)
class ClusterTree:
    """Two-level acceleration structure: fixed-size primitive clusters
    (layout documented in the JAX package's ``ClusterTree``), walked by
    ``ops.intersect.traverse_clusters``."""

    bmin: torch.Tensor  # f32[3, C]
    bmax: torch.Tensor  # f32[3, C]
    pack: torch.Tensor  # f32[R, C]


@dataclasses.dataclass(frozen=True)
class Bvh8Tree:
    """Tensors of one 8-ary packet tree (ops/bvh8.py); its primitive kind is
    ``SceneStats.trees[i][0]`` for the tree at index ``i``.  ``depth`` is
    not in the JAX package's tree: the port sets it where a tree is made
    (``build_bvh8``, ``SceneData.from_numpy``), and kernel K1 sizes its
    stack by it."""

    entries: torch.Tensor  # i32[Ng*8] tagged: >=0 group id, <0 leaf -(ptr+1), SENT empty
    boxes: torch.Tensor  # f32[Ng*8, 8] cols 0-2 bmin, 3-5 bmax
    prows: torch.Tensor  # f32[Lb*16, NCOL] leaf prim rows
    # near-first child visit order per (group, ray-sign octant): 8 slot ids
    # packed 3 bits each, nearest at the LOW bits
    axorder: torch.Tensor  # i32[Ng*8] (group-major, octant minor)
    depth: int  # group levels (ops/bvh8.py::tree_depth)


BVH8_ARRAYS = ("entries", "boxes", "prows", "axorder")  # a Bvh8Tree's tensors, the JAX package's fields


@dataclasses.dataclass(frozen=True)
class SceneStats:
    """Static (hashable) per-scene metadata; fields as in the JAX package."""

    mediums: Tuple[Tuple[int, int, int], ...] = ()
    features: frozenset = frozenset()
    light_ids: Tuple[int, ...] = ()
    light_kinds: Tuple[int, ...] = ()
    light_axes: Tuple[int, ...] = ()
    n_in_bvh: int = 0
    # (kind, n_clusters, cluster_size, nparam, has_xf) per tree
    trees: Tuple[Tuple[int, int, int, int, bool], ...] = ()
    time0: float = 0.0
    time1: float = 1.0
    kind_ranges: Tuple[Tuple[int, int, int], ...] = ()
    kinds_present: Tuple[int, ...] = ()
    world_bounds: Tuple[Tuple[float, float, float], Tuple[float, float, float]] = (
        (0.0, 0.0, 0.0),
        (1.0, 1.0, 1.0),
    )


_SCENE_TENSORS = (
    "kind", "params", "mat_id", "flip", "active",
    "xf_rot", "xf_inv_scale", "xf_trans", "lights",
)


@dataclasses.dataclass(frozen=True)
class SceneData:
    """The complete compiled scene: geometry + shading tables + lights."""

    kind: torch.Tensor  # i32[P]
    params: torch.Tensor  # f32[NPARAM, P]
    mat_id: torch.Tensor  # i32[P]
    flip: torch.Tensor  # bool[P]
    active: torch.Tensor  # bool[P]
    xf_rot: torch.Tensor  # f32[3, 3, P]
    xf_inv_scale: torch.Tensor  # f32[P]
    xf_trans: torch.Tensor  # f32[3, P]
    materials: MaterialTable
    textures: TextureTable
    lights: torch.Tensor  # i32[L]
    clusters: Tuple[ClusterTree, ...] = ()
    bvh8: Tuple[Optional[Bvh8Tree], ...] = ()
    any_xform: bool = False
    any_medium: bool = False
    stats: SceneStats = SceneStats()

    @property
    def n_prims(self) -> int:
        return self.kind.shape[0]

    @property
    def n_lights(self) -> int:
        return self.lights.shape[0]

    @property
    def use_bvh(self) -> bool:
        return len(self.clusters) > 0

    @property
    def device(self) -> torch.device:
        return self.params.device

    def to_numpy(self) -> dict:
        """Every array as numpy, nested like the fields (the inverse of
        :meth:`from_numpy`; ``stats`` is returned separately by the caller)."""
        out = {name: _to_numpy(getattr(self, name)) for name in _SCENE_TENSORS}
        out["materials"] = _to_numpy(self.materials)
        out["textures"] = _to_numpy(self.textures)
        out["clusters"] = _to_numpy(self.clusters)
        out["bvh8"] = [None if t is None else {name: _to_numpy(getattr(t, name)) for name in BVH8_ARRAYS}
                       for t in self.bvh8]
        out["any_xform"] = self.any_xform
        out["any_medium"] = self.any_medium
        return out

    @classmethod
    def from_numpy(cls, arrays: dict, stats, device=DEFAULT_DEVICE) -> "SceneData":
        """Scene from numpy arrays plus static stats, on ``device`` (default:
        the card; without one it raises).

        ``arrays`` is nested like :meth:`to_numpy`'s result: the top-level
        tensors by field name, ``materials``/``textures`` as dicts,
        ``clusters`` as a list of dicts and ``bvh8`` as a list of dicts or
        None.  ``stats`` is a :class:`SceneStats` or any object with the
        same fields (the JAX package's compiled scene hands over its own).
        Each packet tree gets its depth from its ``entries`` and is refused
        where the kernel cannot walk it, as ``build_bvh8`` refuses its own.
        """
        from ..ops.bvh8 import check_tree

        device = resolve_device(device)

        def bvh8(t: dict) -> Bvh8Tree:
            depth = check_tree(t["entries"])
            return Bvh8Tree(**{name: torch.tensor(np.asarray(t[name]), device=device) for name in BVH8_ARRAYS},
                            depth=depth)

        if not isinstance(stats, SceneStats):
            stats = SceneStats(
                **{f.name: getattr(stats, f.name) for f in dataclasses.fields(SceneStats)}
            )
        return cls(
            **{
                name: torch.tensor(np.asarray(arrays[name]), device=device)
                for name in _SCENE_TENSORS
            },
            materials=_tensors(MaterialTable, arrays["materials"], device),
            textures=_tensors(TextureTable, arrays["textures"], device),
            clusters=tuple(_tensors(ClusterTree, c, device) for c in arrays["clusters"]),
            bvh8=tuple(None if t is None else bvh8(t) for t in arrays["bvh8"]),
            any_xform=bool(arrays["any_xform"]),
            any_medium=bool(arrays["any_medium"]),
            stats=stats,
        )
