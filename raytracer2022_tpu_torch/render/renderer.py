"""High-level renderer: config, launches, strips and checkpoints (PyTorch).

Counterpart of ``raytracer2022_tpu/render/renderer.py`` (the reference's
main program, raytracer/src/main.rs:28-231).  A render is a sequence of
launches.  On the regeneration path (``RenderConfig.regen``, the default)
they run over horizontal image strips; each launch traces ``spp_par`` lanes
per pixel, each running up to 32 samples in sequence through
:func:`integrator.trace_regen`.  With ``regen=False`` each launch traces a
batch of samples per pixel through the fixed-depth :func:`integrator.trace`
(:func:`render_batch`).  Launch ``i`` draws from generators seeded from
``(seed, i)``, so a resumed render gives the identical image.

The differentiable launches, :func:`render_batch` and
:func:`render_batch_regen_diff`, take an integer seed (the integrator's
generator rule); :func:`regen_iters_estimate` picks the latter's trip
counts from one forward run.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch

from ..scene.types import SceneData
from .camera import Camera, get_rays
from .film import tonemap_u8
from .integrator import (
    Schedule,
    TraceConfig,
    derive_seed,
    measure_regen_handoff,
    step_generator,
    trace,
    trace_regen,
    trace_regen_diff,
)

# sequential samples per lane in one launch: every launch pays the
# scheduler's low-occupancy tail once, and more samples amortise it
MAX_SPP_SEQ = 32


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Render settings (the reference hard-codes these, main.rs:33-51)."""

    width: int = 400
    height: int = 225
    spp: int = 100
    max_depth: int = 50
    background: Optional[tuple] = (0.0, 0.0, 0.0)  # None => sky gradient
    seed: int = 0
    t_min: float = 1e-3
    spawn_eps: float = 1e-4
    spp_per_batch: int = 0  # lanes per pixel: 0 = auto, -1 = all spp in parallel
    max_rays_per_batch: int = 1 << 18  # lanes per launch (auto batching, strips)
    regen: bool = True  # path regeneration; False: the fixed-depth trace

    def trace_cfg(self) -> TraceConfig:
        return TraceConfig(
            max_depth=self.max_depth,
            background=self.background,
            t_min=self.t_min,
            spawn_eps=self.spawn_eps,
        )


def render_batch(
    scene: SceneData,
    camera: Camera,
    seed: int,
    width: int,
    height: int,
    spp: int,
    cfg: TraceConfig,
) -> torch.Tensor:
    """One launch of the fixed-depth :func:`integrator.trace` -> (3, H, W)
    radiance SUM over ``spp`` samples per pixel; reverse-differentiable in
    the scene's tables and the camera.  Lanes are pixel-contiguous (the
    ``spp`` lanes of a pixel are adjacent); pixel (x, y) uses
    u = (x + U)/(W-1), v = (y + U)/(H-1) (main.rs:144-148).  The camera
    rays draw from ``step_generator(seed, 0)``, bounce ``b`` from step
    ``b + 1``."""
    n = height * width * spp
    dev = scene.device
    gen = step_generator(seed, 0, dev)
    ys = torch.arange(height, dtype=torch.float32, device=dev).repeat_interleave(width * spp)
    xs = torch.arange(width, dtype=torch.float32, device=dev).repeat_interleave(spp).repeat(height)
    u = (xs + torch.rand((n,), generator=gen, device=gen.device)) / (width - 1)
    v = (ys + torch.rand((n,), generator=gen, device=gen.device)) / (height - 1)
    o, d, tm = get_rays(camera, u, v, gen)
    radiance = trace(scene, o, d, tm, seed, cfg)  # (3, N)
    return radiance.reshape(3, height, width, spp).sum(dim=3)


def _regen_gen_rays(camera: Camera, width: int, height: int, pix_offset: int = 0):
    """Ray generator for the regen integrator: lane pixel ids are local to
    the strip, ``pix_offset`` maps them to image pixels.  Pixel (x, y) uses
    u = (x + U)/(W-1), v = (y + U)/(H-1) (main.rs:144-148)."""

    def gen_rays(gen, pix):
        gpix = pix + pix_offset
        xs = (gpix % width).to(torch.float32)
        ys = torch.div(gpix, width, rounding_mode="floor").to(torch.float32)
        u = (xs + torch.rand(pix.shape, generator=gen, device=gen.device)) / (width - 1)
        v = (ys + torch.rand(pix.shape, generator=gen, device=gen.device)) / (height - 1)
        return get_rays(camera, u, v, gen)

    return gen_rays


def render_batch_regen(
    scene: SceneData,
    camera: Camera,
    gen: torch.Generator,
    width: int,
    height: int,
    spp_par: int,  # lanes per pixel
    spp_seq: int,  # samples each lane runs in sequence
    cfg: TraceConfig,
    row0: int = 0,  # first image row of this launch's strip
    rows: Optional[int] = None,  # strip height (None = full frame)
    return_iters: bool = False,
    schedule: Optional[Schedule] = None,  # None: integrator.choose_schedule
):
    """One launch -> (3, rows, W) radiance SUM over ``spp_par * spp_seq``
    samples per pixel of the strip; ``schedule`` forces how samples reach
    lanes (the JAX package's ``pool`` argument)."""
    rows = height if rows is None else rows
    n = rows * width * spp_par
    pix0 = torch.arange(n, device=scene.device) % (rows * width)
    gen_rays = _regen_gen_rays(camera, width, height, pix_offset=row0 * width)
    radiance, iters = trace_regen(
        scene, gen_rays, pix0, spp_seq, gen, cfg, spp_par=spp_par, schedule=schedule,
        return_iters=True,
    )
    img = radiance.reshape(3, spp_par, rows, width).sum(dim=1)
    return (img, iters) if return_iters else img


def render_batch_regen_diff(
    scene: SceneData,
    camera: Camera,
    seed: int,
    width: int,
    height: int,
    spp_par: int,  # lanes per pixel
    spp_seq: int,  # samples each lane completes in sequence
    n_iters: int,  # fixed trip count (integrator.trace_regen_diff)
    cfg: TraceConfig,
    n_drain: int = 0,  # narrow-drain trip count (integrator.trace_regen_diff)
):
    """Differentiable regeneration render -> ``((3, H, W) radiance sum over
    the completed samples, (H, W) i32 completed-sample counts)``.

    The pixel mean is ``sum / counts``; the counts are ``spp_par * spp_seq``
    everywhere when ``n_iters >= spp_seq * max_depth``.  Reverse-
    differentiable in the scene's tables and the camera; the counts are
    integers, so the normalisation needs no detach."""
    n = height * width * spp_par
    pix0 = torch.arange(n, device=scene.device) % (height * width)
    radiance, done = trace_regen_diff(
        scene, _regen_gen_rays(camera, width, height), pix0, spp_seq, n_iters, seed, cfg,
        spp_par=spp_par, drain_iters=n_drain,
    )
    img = radiance.reshape(3, spp_par, height, width).sum(dim=1)
    counts = done.reshape(spp_par, height, width).sum(dim=0)
    return img, counts


def regen_iters_estimate(
    scene: SceneData,
    camera: Camera,
    width: int,
    height: int,
    spp_par: int,
    spp_seq: int,
    cfg: TraceConfig,
    seed: int = 0,
    split_drain: bool = False,
):
    """Trip counts for :func:`render_batch_regen_diff`, from one forward
    run: ``int(measured * 1.3) + 8 + max_depth``, clamped to the exact
    bound ``spp_seq * max_depth + 1``.

    The single-phase form measures the global-pool schedule's iterations
    before its drains and budgets a whole ``max_depth`` for the survivors,
    which the one-phase integrator runs at full width.  ``split_drain``
    returns ``(n_iters, n_drain)`` for the two-phase integrator: the
    measured handoff of the pixel-pooled schedule itself
    (:func:`integrator.measure_regen_handoff`; the global pool drains
    faster and would overshoot) with a small jitter allowance, and
    ``max_depth`` drain iterations."""
    n = height * width * spp_par
    pix0 = torch.arange(n, device=scene.device) % (height * width)
    gen_rays = _regen_gen_rays(camera, width, height)
    bound = spp_seq * cfg.max_depth + 1
    if split_drain:
        iters = measure_regen_handoff(scene, gen_rays, pix0, spp_seq, seed, cfg, spp_par=spp_par)
        return min(int(iters * 1.03) + 3, bound), cfg.max_depth
    with torch.no_grad():
        _, iters = trace_regen(
            scene, gen_rays, pix0, spp_seq, step_generator(seed, 0, scene.device), cfg,
            spp_par=spp_par, return_iters=True,
        )
    return min(int(iters["pool"] * 1.3) + 8 + cfg.max_depth, bound)


def _fingerprint(scene: SceneData, camera: Camera) -> float:
    """Scene/camera fingerprint: a resume against a different scene of the
    same size must restart, not blend images."""
    fp = float(scene.params.double().sum()) + 1e-3 * scene.n_prims
    return fp + float(camera.origin.double().sum())


def render_sum_n(
    scene: SceneData,
    camera: Camera,
    cfg: RenderConfig,
    progress=None,
    checkpoint: Optional[str] = None,
    launch_log: Optional[list] = None,
):
    """Full render -> ((3, H, W) radiance sum, n_samples per pixel).

    ``cfg.spp`` is rounded up to whole launches; the actual sample count is
    returned.  ``progress(done_spp, total_spp)`` is called after every
    launch.  ``checkpoint`` (an .npz path) saves the running sum after every
    launch, atomically, and a rerun with the same configuration resumes
    from the last completed launch; a mismatched file restarts.
    ``launch_log``, when given, receives each launch's lane count,
    iteration counts and wall seconds (synchronised on CUDA).  With
    ``cfg.regen`` False the launches run :func:`render_batch` over the
    whole frame, ``batch`` samples per pixel each, without checkpoints.
    """
    tcfg = cfg.trace_cfg()
    pixels = cfg.width * cfg.height
    if cfg.spp_per_batch > 0:
        batch = min(cfg.spp_per_batch, cfg.spp)
    elif cfg.spp_per_batch < 0:
        batch = cfg.spp
    else:
        # auto: bound lanes per launch
        batch = min(cfg.spp, max(1, cfg.max_rays_per_batch // pixels))
        if cfg.regen:
            # regeneration pays only when each lane runs several samples:
            # keep spp_seq >= 8 when spp allows
            batch = max(1, min(batch, cfg.spp // 8))
    if not cfg.regen:
        return _render_fixed_depth(scene, camera, cfg, batch, progress, launch_log)
    spp_seq = -(-cfg.spp // batch)
    chunk = min(spp_seq, MAX_SPP_SEQ)
    if progress is not None:
        chunk = max(1, min(chunk, spp_seq // 8 or 1))
    n_launches = -(-spp_seq // chunk)
    # large frames tile into row strips so each launch stays under the lane budget
    rows_per = max(1, min(cfg.height, cfg.max_rays_per_batch // max(1, cfg.width * batch)))
    n_strips = -(-cfg.height // rows_per)
    device = scene.device
    total = torch.zeros((3, cfg.height, cfg.width), dtype=torch.float32, device=device)
    resume_from = 0
    meta = None
    if checkpoint is not None:
        meta = np.array(
            [cfg.width, cfg.height, cfg.spp, batch, chunk, rows_per, cfg.seed,
             _fingerprint(scene, camera)]
        )
        if os.path.exists(checkpoint):
            with np.load(checkpoint) as st:
                if "meta" in st and np.array_equal(st["meta"], meta):
                    total = torch.as_tensor(st["total"], device=device)
                    resume_from = int(st["launch"])
    launch = 0
    for s in range(n_strips):
        r0 = s * rows_per
        rs = min(rows_per, cfg.height - r0)
        for _ in range(n_launches):
            if launch < resume_from:
                launch += 1
                continue
            t0 = time.perf_counter()
            part, iters = render_batch_regen(
                scene, camera, step_generator(cfg.seed, launch, device),
                cfg.width, cfg.height, batch, chunk, tcfg, row0=r0, rows=rs,
                return_iters=True,
            )
            total[:, r0 : r0 + rs, :] += part
            launch += 1
            if launch_log is not None:
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                launch_log.append(
                    {"lanes": rs * cfg.width * batch, **iters, "seconds": time.perf_counter() - t0}
                )
            if checkpoint is not None:
                # atomic write: a crash mid-save must not corrupt the resume
                # state; savez keeps a name that already ends in .npz
                tmp = checkpoint + ".tmp.npz"
                np.savez(tmp, total=total.cpu().numpy(), launch=launch, meta=meta)
                os.replace(tmp, checkpoint)
            if progress is not None:
                total_spp = n_launches * chunk * batch
                progress(launch * total_spp // (n_strips * n_launches), total_spp)
    return total, n_launches * chunk * batch


def _render_fixed_depth(scene, camera, cfg: RenderConfig, batch: int, progress, launch_log):
    """``render_sum_n`` on the fixed-depth path: ceil(spp / batch) launches
    of :func:`render_batch`."""
    tcfg = cfg.trace_cfg()
    device = scene.device
    n_batches = -(-cfg.spp // batch)
    total = torch.zeros((3, cfg.height, cfg.width), dtype=torch.float32, device=device)
    for i in range(n_batches):
        t0 = time.perf_counter()
        total += render_batch(
            scene, camera, derive_seed(cfg.seed, i), cfg.width, cfg.height, batch, tcfg,
        )
        if launch_log is not None:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            launch_log.append(
                {"lanes": cfg.width * cfg.height * batch, "bounces": cfg.max_depth,
                 "seconds": time.perf_counter() - t0}
            )
        if progress is not None:
            progress((i + 1) * batch, n_batches * batch)
    return total, n_batches * batch


def render_sum(scene, camera, cfg: RenderConfig, progress=None, checkpoint=None):
    """Full render -> (3, H, W) sum scaled to exactly ``cfg.spp`` samples."""
    total, n = render_sum_n(scene, camera, cfg, progress=progress, checkpoint=checkpoint)
    if n != cfg.spp:
        total = total * (cfg.spp / n)
    return total


def render(scene, camera, cfg: RenderConfig, progress=None, checkpoint=None):
    """Full render -> u8[H, W, 3] tone-mapped image."""
    total, n = render_sum_n(scene, camera, cfg, progress=progress, checkpoint=checkpoint)
    return tonemap_u8(total, n)
