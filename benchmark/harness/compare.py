"""The comparison that decides ``correct``.

A frame: the program's radiance sum of ``n`` samples a pixel against the
reference's own render of the same description (sum and sum of squares
of ``m`` samples a pixel, other random numbers).  The frame is cut into
square tiles; in each tile and channel the two means differ by

    z = (mean_prog - mean_ref) / sqrt(var * (1/n + 1/m)),

where ``var`` is the mean over the tile's pixels of each pixel's
per-sample variance, divided by the tile's pixel count.  A pixel's
variance is the widest of the reference's (from its samples) and the
program's (from the pixel's spread over its passes).  Where the reference
saw no radiance in a pixel, it is also at least the largest that the
program's pass sums allow: each pass's sum carried by one sample.  Two
passes give the program's spread one degree of freedom, so a pixel that
the reference missed and that got one rare sample in each pass would
otherwise read a spread of almost 0.  A tile whose samples never vary
compares exactly: z is 0 where the means are equal and infinite where they
are not.  Two numbers are compared: the mean of z^2 over the tiles (about
1 when both sides estimate one image) and the largest |z| (a fault in a
few tiles).  The sample count must be exact.

A fit: the program's losses, the norm of the first gradient and of the
change after the first steps, over the scene's leaves, against the
reference's (:func:`fit_gaps`).
"""

from __future__ import annotations

import math

import torch

# the camera's leaves (``reference.tracer.CAMERA_LEAVES``; not imported, as
# the reference's module sets the card's matmul precision when loaded)
CAMERA_LEAVES = ("origin", "lower_left", "horizontal", "vertical", "u", "v", "w", "lens_radius", "time0", "time1")


def tile_z(pass_sums, n_pass: int, ref_sum, ref_sq, n_ref: int, tile: int) -> torch.Tensor:
    """z of every tile and channel -> float64 (3, tiles).  ``pass_sums``
    holds the program's radiance sum of each pass, ``n_pass`` samples a
    pixel each."""
    ref_sum, ref_sq = (x.double().cpu() for x in (ref_sum, ref_sq))
    _, h, w = ref_sum.shape
    ty, tx = -(-h // tile), -(-w // tile)
    ys = torch.arange(h)[:, None] // tile
    xs = torch.arange(w)[None, :] // tile
    tid = (ys * tx + xs).reshape(-1)
    n_t = ty * tx
    pixels = torch.zeros(n_t, dtype=torch.float64).index_add_(0, tid, torch.ones(h * w, dtype=torch.float64))

    def tile_mean(x):
        out = torch.zeros((3, n_t), dtype=torch.float64)
        return out.index_add_(1, tid, x.reshape(3, -1)) / pixels

    k = len(pass_sums)
    n_prog = k * n_pass
    passes = torch.stack([p.double().cpu() / n_pass for p in pass_sums])  # (K, 3, H, W) per-pass means
    mp = tile_mean(passes.mean(dim=0))
    mean_r = ref_sum / n_ref
    var = torch.clamp(ref_sq / n_ref - mean_r * mean_r, min=0.0) * (n_ref / max(n_ref - 1, 1))
    if k > 1:
        # the program's own per-sample variance, from each pixel's spread over
        # the passes; where wider it stands for both sides: a rare bright path
        # that one side's samples missed leaves that side's estimate short
        var = torch.maximum(var, passes.var(dim=0) * n_pass)
    # where the reference saw nothing, the largest variance that non-negative
    # samples with the program's pass sums can have: n * mean^2 * (1 - 1/n)
    one = (passes * passes).mean(dim=0) * (n_pass - 1)
    var = torch.where(ref_sum == 0, torch.maximum(var, one), var)
    del passes, one
    var_tile = tile_mean(var)  # per-sample variance, averaged over the tile's pixels
    v = var_tile / pixels * (1.0 / n_prog + 1.0 / n_ref)
    diff = mp - tile_mean(mean_r)
    z = diff / torch.sqrt(torch.where(v > 0, v, torch.ones_like(v)))
    exact = torch.where(diff == 0, torch.zeros_like(diff), torch.full_like(diff, math.inf))
    return torch.where(v > 0, z, exact)


def frame_numbers(pass_sums, n_pass: int, n_expected: int, ref_sum, ref_sq, n_ref: int, tile: int) -> dict:
    """The numbers a frame is judged by: ``samples_gap`` (the program's
    samples a pixel against the window's, exact), ``tile_z2_mean`` and
    ``tile_z_max``."""
    n_prog = len(pass_sums) * n_pass
    gap = float(abs(n_prog - n_expected))
    if n_prog <= 0 or not all(bool(torch.isfinite(p).all()) for p in pass_sums):
        return {"samples_gap": gap, "tile_z2_mean": math.inf, "tile_z_max": math.inf}
    z = tile_z(pass_sums, n_pass, ref_sum, ref_sq, n_ref, tile)
    finite = torch.isfinite(z)
    z2 = float((z[finite] ** 2).mean()) if bool(finite.any()) else 0.0
    worst = int(z.abs().reshape(-1).argmax())
    return {"samples_gap": gap, "tile_z2_mean": z2 if bool(finite.all()) else math.inf,
            "tile_z_max": float(z.abs().max()),
            "_worst_tile": {"channel": worst // z.shape[1], "tile": worst % z.shape[1],
                            "tiles_across": -(-ref_sum.shape[2] // tile), "z": float(z.reshape(-1)[worst])}}


def reached_leaves(ref: dict, exclude_below: float = 1e-3) -> list:
    """The leaves compared: those the render reaches (the reference's value
    is not exactly 0) and whose reference norm is at least
    ``exclude_below`` times the median of those (else nought to rounding)."""
    norms = {k: float(torch.linalg.vector_norm(v.double())) for k, v in ref.items()}
    reached = [n for n in norms.values() if n > 0.0]
    med = float(torch.tensor(reached, dtype=torch.float64).median()) if reached else 0.0
    return [k for k, n in norms.items() if n > 0.0 and n >= exclude_below * med]


def norm_gap(prog: dict, ref: dict, leaves: list) -> float:
    """|‖prog‖ - ‖ref‖| / ‖ref‖ over the leaves together."""
    pn = math.sqrt(sum(float(torch.linalg.vector_norm(prog[k].double())) ** 2 for k in leaves))
    rn = math.sqrt(sum(float(torch.linalg.vector_norm(ref[k].double())) ** 2 for k in leaves))
    return abs(pn - rn) / rn if math.isfinite(pn) and rn > 0 else math.inf


def fit_gaps(prog: dict, ref: dict) -> dict:
    """The numbers a fit is judged by, from each side's record of its first
    steps (``losses``, ``first_grad`` and ``change``, dicts of leaves):
    ``loss_gap``, the widest relative gap of a step's loss; ``grad_gap``
    and ``change_gap``, the relative gap of the norm of the first gradient
    and of the change over the steps, over the compared leaves together:
    those the render reaches (:func:`reached_leaves`) less the camera's.
    A camera leaf's gradient at the fit's size is sampling noise with a
    heavy tail (one draw in ten can read it tenfold, on either side), so
    its norm is printed beside the numbers and not compared."""
    loss_gap = max(abs(p - r) / abs(r) if math.isfinite(p) else math.inf
                   for p, r in zip(prog["losses"], ref["losses"]))
    reached = reached_leaves(ref["first_grad"])
    used = [k for k in reached if k not in CAMERA_LEAVES]
    norms = {kind: {k: [float(torch.linalg.vector_norm(side[kind][k].double())) for side in (prog, ref)]
                    for k in reached} for kind in ("first_grad", "change")}
    return {"loss_gap": loss_gap, "grad_gap": norm_gap(prog["first_grad"], ref["first_grad"], used),
            "change_gap": norm_gap(prog["change"], ref["change"], used),
            "_leaves": {"compared": used, "norms": norms}}
