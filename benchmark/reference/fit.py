"""The reference's fit step: the plain tracer differentiated by autograd.

A step renders ``spp`` samples a pixel of the frame with the leaves
(``mat_param``, ``tex_color`` and the camera's ten quantities), takes the
mean squared error against the target over every pixel and channel,
back-propagates, and moves every leaf by ``-lr`` times its gradient (a
leaf the render does not reach keeps its value).  The frame is rendered in
blocks of rows, each block's share of the loss back-propagated on its own,
so that a block's graph is all that is held.
"""

from __future__ import annotations

import numpy as np
import torch

from .tracer import CAMERA_LEAVES, Tables, camera, texture_table, trace

LEAVES = ("mat_param", "tex_color") + CAMERA_LEAVES


def initial_leaves(desc: dict, device, dtype=torch.float32) -> dict:
    """The description's leaves, as the reference computes them."""
    mats = desc["materials"]
    color, _ = texture_table(desc)
    cam = camera(desc["camera"])
    f = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64), device=device).to(dtype)  # noqa: E731
    out = {"mat_param": f([m.get("param", 0.0) for m in mats]), "tex_color": f(color)}
    out.update({k: f(cam[k]) for k in CAMERA_LEAVES})
    return out


def loss_and_grads(desc: dict, leaves: dict, target, width: int, height: int, spp: int, depth: int, seed: int,
                   dtype=torch.float32, block_lanes: int = 1 << 18, rows=None) -> tuple:
    """(loss, {leaf: gradient}) of one step's render at ``leaves``; ``rows``
    (first, end) renders those rows only, the mean over them (a fault of
    the control's)."""
    dev = target.device
    req = {k: v.detach().clone().to(dtype).requires_grad_() for k, v in leaves.items()}
    tab = Tables(desc, dev, dtype=dtype, leaves=req)
    first, end = rows or (0, height)
    n_el = 3 * width * (end - first)
    step = max(1, block_lanes // (width * spp))
    gen = torch.Generator(device=dev)
    loss = 0.0
    for k, r0 in enumerate(range(first, end, step)):
        r1 = min(end, r0 + step)
        gen.manual_seed(int(np.random.SeedSequence([seed, 11, k]).generate_state(1, np.uint64)[0]) >> 1)
        pix = torch.arange(r0 * width, r1 * width, device=dev).repeat_interleave(spp)
        o, d = tab.camera_rays(pix % width, pix // width, width, height, gen)
        rad = trace(tab, o, d, gen, depth)
        img = rad.reshape(-1, spp, 3).mean(dim=1).t().reshape(3, r1 - r0, width)
        part = ((img.float() - target[:, r0:r1]) ** 2).sum() / n_el
        part.backward()
        loss += float(part.detach())
    grads = {k: (torch.zeros_like(v) if v.grad is None else v.grad.detach()).float() for k, v in req.items()}
    return loss, grads


def follow(desc: dict, target, width: int, height: int, spp: int, depth: int, lr: float, steps: int,
           seed: int, dtype=torch.float32) -> dict:
    """``steps`` steps from the description's leaves -> ``losses`` (each
    step's, before its move), ``first_grad`` and ``change`` (the leaves
    after the steps less the leaves before)."""
    leaves0 = initial_leaves(desc, target.device)
    leaves = dict(leaves0)
    losses, first = [], None
    for s in range(steps):
        loss, g = loss_and_grads(desc, leaves, target, width, height, spp, depth, seed + 7919 * s, dtype=dtype)
        losses.append(loss)
        first = g if first is None else first
        leaves = {k: (v - lr * g[k]).detach() for k, v in leaves.items()}
    return {"losses": losses, "first_grad": first, "change": {k: leaves[k] - leaves0[k] for k in leaves0}}
