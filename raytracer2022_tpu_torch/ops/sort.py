"""Wavefront ray sorting: restore coherence between bounces (PyTorch).

Counterpart of ``raytracer2022_tpu/ops/sort.py``.  Once per bounce the
regeneration integrator may sort the wavefront by a coarse spatial and
directional key, so neighbouring lanes trace similar rays again.  The JAX
package carries every per-lane state row as the payload of one
``lax.sort``; here the key is sorted once and every state tensor is
indexed with the permutation.

Key layout (i32, compared ascending):
  [octant:3 | morton:3*MORTON_BITS] - the direction octant first, then an
  interleaved Morton code of the origin quantized against the scene's
  static bounding box.  :func:`ray_sort_key` is bit-equal to the JAX
  package's.
"""

from __future__ import annotations

import torch

MORTON_BITS = 4  # per-axis origin bits; 3*4+3 = 15 key bits total


def _part_bits(x: torch.Tensor) -> torch.Tensor:
    """Spread the MORTON_BITS low bits of x with 2 zero bits between each."""
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def ray_sort_key(o: torch.Tensor, d: torch.Tensor, bmin, bmax) -> torch.Tensor:
    """Coherence key per lane -> i32[N]; ``bmin``/``bmax`` are the scene's
    static world bounds (``SceneStats.world_bounds``)."""
    n_cells = (1 << MORTON_BITS) - 1
    key = torch.zeros(o.shape[1], dtype=torch.int32, device=o.device)
    for a in range(3):
        lo, hi = float(bmin[a]), float(bmax[a])
        scale = n_cells / (hi - lo) if hi > lo else 0.0
        # saturate before the cast (an out-of-range float-to-int cast is
        # undefined in C++; XLA's saturates), then clip as the JAX key does
        q = torch.clamp((o[a] - lo) * scale, -1.0, float(n_cells + 1)).to(torch.int32)
        q = torch.clamp(q, 0, n_cells)
        key = key | (_part_bits(q) << a)
    octant = (
        (d[0] >= 0.0).to(torch.int32)
        | ((d[1] >= 0.0).to(torch.int32) << 1)
        | ((d[2] >= 0.0).to(torch.int32) << 2)
    )
    return (octant << (3 * MORTON_BITS)) | key


def sort_by_key(key: torch.Tensor, payload: tuple) -> tuple:
    """Sort every payload tensor's last axis by ``key`` (ascending) ->
    the reordered payloads, in input order."""
    perm = torch.argsort(key, stable=True)
    return tuple(x[..., perm] for x in payload)
