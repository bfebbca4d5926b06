"""Differentiable-fit demo: recover perturbed material albedos and light
emission on the Cornell box from a rendered target image by gradient
descent through the whole path tracer.

Counterpart of ``tools/fit.py``.  Usage::

    python -m raytracer2022_tpu_torch.fit [--steps 60] [--spp 64] [--size 64]
        [--depth 8] [--lr 0.06] [--regen] [--device cuda] [--out fit.json]

Prints one JSON line: the first and last loss, the parameters' mean
relative error before and after, and the loss trajectory.  Exit code 0 iff
the fit recovered the parameters (relative error below 0.2).
"""

from __future__ import annotations

import argparse
import dataclasses
import json

TARGET_SEED = 7


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Differentiable fit on the Cornell box")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--depth", type=int, default=8)
    ap.add_argument("--lr", type=float, default=0.06)
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default="cuda", help="torch device (cuda, cpu)")
    ap.add_argument(
        "--regen", action="store_true",
        help="fit through the differentiable regeneration integrator (trace_regen_diff)",
    )
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from .render.camera import make_camera
    from .render.integrator import derive_seed
    from .render.renderer import (
        RenderConfig, regen_iters_estimate, render_batch, render_batch_regen_diff,
    )
    from .scene.library import cornell_box
    from .scene.types import DIFFUSE_LIGHT, LAMBERTIAN

    bundle = cornell_box(device=args.device)
    scene = bundle.scene
    cam = make_camera(**bundle.camera_kwargs, device=args.device)
    size, spp = args.size, args.spp
    cfg = RenderConfig(width=size, height=size, spp=spp, max_depth=args.depth, background=bundle.background)
    tcfg = cfg.trace_cfg()

    # the target: a render of the true scene
    with torch.no_grad():
        target = render_batch(scene, cam, TARGET_SEED, size, size, spp, tcfg) / spp

    # perturb: dim the light, brighten and shift the lambertian albedos
    c0 = scene.textures.color.cpu().numpy().copy()
    true_c = c0.copy()
    kinds = scene.materials.kind.cpu().numpy()
    mats_tex = scene.materials.tex.cpu().numpy()
    light_tex = int(mats_tex[np.argmax(kinds == DIFFUSE_LIGHT)])
    lamb_texs = [int(t) for t, k in zip(mats_tex, kinds) if k == LAMBERTIAN]
    c0[:, light_tex] *= 0.5
    for t in lamb_texs:
        c0[:, t] = np.clip(c0[:, t] * 1.6 + 0.08, 0.02, 0.95)

    if args.regen:
        spp_par = max(1, spp // 8)
        spp_seq = -(-spp // spp_par)
        n_iters, n_drain = regen_iters_estimate(
            scene, cam, size, size, spp_par, spp_seq, tcfg, split_drain=True
        )

        def render(s, seed):
            img, cnt = render_batch_regen_diff(
                s, cam, seed, size, size, spp_par, spp_seq, n_iters, tcfg, n_drain=n_drain
            )
            return img / torch.clamp(cnt, min=1)[None]
    else:

        def render(s, seed):
            return render_batch(s, cam, seed, size, size, spp, tcfg) / spp

    # log-space parameters: a x2 emission error and a x1.6 albedo error
    # become comparable steps, so one Adam rate fits both (emission ~60 and
    # albedos ~0.7 differ by two orders of magnitude)
    params = torch.log(torch.as_tensor(c0, device=scene.device) + 1e-4).requires_grad_()
    opt = torch.optim.Adam([params], lr=args.lr)
    losses = []
    for i in range(args.steps):
        s = dataclasses.replace(scene, textures=dataclasses.replace(scene.textures, color=torch.exp(params)))
        loss = torch.mean((render(s, derive_seed(TARGET_SEED, i)) - target) ** 2)
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))

    cf = torch.exp(params).detach().cpu().numpy()
    track = [light_tex] + lamb_texs

    def err(c):
        return float(np.mean(np.abs(c[:, track] - true_c[:, track]) / np.maximum(np.abs(true_c[:, track]), 1e-3)))

    report = {
        "loss_initial": losses[0],
        "loss_final": losses[-1],
        "param_relerr_initial": err(c0),
        "param_relerr_final": err(cf),
        "recovered": err(cf) < 0.2,
        "losses": [round(x, 6) for x in losses],
    }
    print(json.dumps(report), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f)
    return 0 if report["recovered"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
