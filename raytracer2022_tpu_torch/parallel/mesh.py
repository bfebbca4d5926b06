"""Rendering and the differentiable fit step over several devices.

Counterpart of ``raytracer2022_tpu/parallel/mesh.py``.  The JAX package
shards the samples-per-pixel axis over a ``jax.sharding.Mesh`` of chips
with ``shard_map`` and sums the radiance with one ``psum``.  Here the mesh
is a one-dimensional ``torch.distributed.device_mesh.DeviceMesh`` (axis
``"chips"``) with one process per rank (:mod:`.distributed`).  Every rank
builds the same scene and camera, renders its share of the samples with
its own seed, ``derive_seed(cfg.seed, rank)`` (the counterpart of
``fold_in(key, axis_index)``), and the partial sums ride one
``all_reduce(SUM)``.  Each sharded render is a pure ``*_shard(..., rank,
world)`` function plus that one collective, so one process can compute
every rank's share.  The fit step's loss and gradients ride one
``all_reduce`` as one flat buffer, divided by the world size (gloo has no
average).  Nothing collective runs inside a render: the regeneration
loops end at different iterations on different ranks.

With ``mesh=None`` :func:`fit_step_fn` is the one-device step: render,
mean squared error against a target image, backpropagation through the
whole bounce loop, and one SGD step on the material and texture tables and
the camera.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..render.camera import Camera
from ..render.integrator import derive_seed, step_generator
from ..render.renderer import RenderConfig, render_batch, render_batch_regen, render_batch_regen_diff
from ..scene.types import SceneData
from ..utils.profiling import launch_record, span

AXIS = "chips"
CAMERA_LEAVES = tuple(f.name for f in dataclasses.fields(Camera))


def make_device_mesh(device_type: str, axis_name: str = AXIS) -> DeviceMesh:
    """A one-dimensional mesh of every rank of the default process group,
    on devices of ``device_type`` ("cuda" or "cpu")."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_device_mesh needs a process group: call "
            "parallel.distributed.init_distributed first"
        )
    return init_device_mesh(device_type, (dist.get_world_size(),), mesh_dim_names=(axis_name,))


def _rank_world(mesh: DeviceMesh) -> tuple[int, int]:
    return mesh.get_local_rank(), mesh.size()


def _check_divides(spp: int, world: int) -> None:
    if spp % world:
        raise ValueError(f"spp {spp} must divide evenly over {world} ranks")


def with_params(scene: SceneData, mat_param: torch.Tensor, tex_color: torch.Tensor) -> SceneData:
    """``scene`` with its material parameters and texture colours replaced."""
    return dataclasses.replace(
        scene,
        materials=dataclasses.replace(scene.materials, param=mat_param),
        textures=dataclasses.replace(scene.textures, color=tex_color),
    )


def render_shard(scene: SceneData, camera: Camera, cfg: RenderConfig, rank: int, world: int) -> torch.Tensor:
    """Rank ``rank``'s share of :func:`render_sharded_sum`: ``cfg.spp //
    world`` samples per pixel through the fixed-depth :func:`render_batch`
    with the seed ``derive_seed(cfg.seed, rank)`` -> (3, H, W) radiance
    sum.  ``cfg.spp`` must divide over the ranks."""
    _check_divides(cfg.spp, world)
    return render_batch(
        scene, camera, derive_seed(cfg.seed, rank), cfg.width, cfg.height, cfg.spp // world, cfg.trace_cfg()
    )


def render_sharded_sum(scene: SceneData, camera: Camera, cfg: RenderConfig, mesh: DeviceMesh) -> torch.Tensor:
    """Full render with spp sharded over the mesh -> (3, H, W) radiance sum
    of ``cfg.spp`` samples per pixel, the same on every rank."""
    total = render_shard(scene, camera, cfg, *_rank_world(mesh))
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=mesh.get_group())
    return total


def regen_split(cfg: RenderConfig, world: int) -> tuple[int, int, int]:
    """``(spp_par, spp_seq, rows_per)`` of the sharded regeneration render:
    ``ceil(cfg.spp / world)`` samples per pixel on each rank, as lanes per
    pixel times sequential samples (the JAX package's split, which differs
    from ``render_sum_n``'s: one launch per strip, not chunked), and the
    strip height that keeps a launch under ``cfg.max_rays_per_batch``
    lanes."""
    spp_chip = -(-cfg.spp // world)
    if cfg.spp_per_batch > 0:
        spp_par = min(cfg.spp_per_batch, spp_chip)
    else:
        spp_par = max(1, min(cfg.max_rays_per_batch // (cfg.width * cfg.height), spp_chip // 8 or 1))
    spp_seq = -(-spp_chip // spp_par)
    rows_per = max(1, min(cfg.height, cfg.max_rays_per_batch // max(1, cfg.width * spp_par)))
    return spp_par, spp_seq, rows_per


def render_regen_shard(
    scene: SceneData,
    camera: Camera,
    cfg: RenderConfig,
    rank: int,
    world: int,
    launch_log: Optional[list] = None,
):
    """Rank ``rank``'s share of :func:`render_sharded_regen_sum` ->
    ``((3, H, W) radiance sum, n)``, where ``n = world * spp_par * spp_seq``
    (:func:`regen_split`) is the sample count per pixel of the sum over
    all ranks: ``cfg.spp`` rounded up, no divisibility needed.  Strip ``s``
    draws from ``step_generator(derive_seed(cfg.seed, rank), s)``.
    ``launch_log``, when given, receives each strip's lane count,
    iteration counts, wall seconds (synchronised on CUDA) and host record
    (:func:`utils.profiling.launch_record`)."""
    spp_par, spp_seq, rows_per = regen_split(cfg, world)
    seed = derive_seed(cfg.seed, rank)
    tcfg = cfg.trace_cfg()
    device = scene.device
    total = torch.zeros((3, cfg.height, cfg.width), dtype=torch.float32, device=device)
    for s in range(-(-cfg.height // rows_per)):
        r0 = s * rows_per
        rs = min(rows_per, cfg.height - r0)
        with launch_record(launch_log, device) as entry:
            part, iters = render_batch_regen(
                scene, camera, step_generator(seed, s, device), cfg.width, cfg.height, spp_par, spp_seq, tcfg,
                row0=r0, rows=rs, return_iters=True,
            )
            with span("regen.accumulate"):
                total[:, r0 : r0 + rs, :] += part
            entry.update(lanes=rs * cfg.width * spp_par, **iters)
    return total, world * spp_par * spp_seq


def render_sharded_regen_sum(
    scene: SceneData,
    camera: Camera,
    cfg: RenderConfig,
    mesh: DeviceMesh,
    launch_log: Optional[list] = None,
):
    """The production multi-device render: the path-regeneration
    integrator (K1 on mesh scenes) with spp sharded over the mesh ->
    ``((3, H, W) radiance sum, n_samples)``, the same on every rank
    (:func:`render_regen_shard`)."""
    rank, world = _rank_world(mesh)
    total, n = render_regen_shard(scene, camera, cfg, rank, world, launch_log=launch_log)
    # asynchronous on the card (NCCL), so not a counted sync; the span names
    # its kernel in a device trace
    with span("shard.all_reduce"):
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=mesh.get_group())
    return total, n


def fit_regen_split(spp: int) -> tuple[int, int]:
    """``(spp_par, spp_seq)`` of the fit step's regeneration render of
    ``spp`` samples per pixel (per rank on a mesh)."""
    spp_par = max(1, spp // 8)
    return spp_par, -(-spp // spp_par)


def _mean_over_ranks(mesh: DeviceMesh, loss: torch.Tensor, grads, leaves):
    """The loss and every leaf's gradient (zeros where a leaf is unused)
    averaged over the ranks in one all_reduce of one flat buffer."""
    world = mesh.size()
    with torch.no_grad():
        parts = [loss.reshape(1)] + [(torch.zeros_like(x) if g is None else g).reshape(-1) for x, g in zip(leaves, grads)]
        flat = torch.cat(parts)
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.get_group())
        flat = flat / world
        out = torch.split(flat, [1] + [x.numel() for x in leaves])
    return out[0].reshape(()), [g.view_as(x) for g, x in zip(out[1:], leaves)]


def fit_step_fn(
    cfg: RenderConfig,
    mesh: Optional[DeviceMesh] = None,
    lr: float = 0.05,
    regen_iters: Optional[int] = None,
):
    """Fit-step factory -> ``step(scene, camera, target, seed) -> (scene',
    camera', loss)``.

    The step renders ``cfg.spp`` samples per pixel of ``cfg.width x
    cfg.height`` with the seed ``seed``, takes the MSE against ``target``
    (3, H, W), backpropagates, and applies SGD with rate ``lr`` to
    ``materials.param``, ``textures.color`` and the camera's ten leaves (a
    leaf the render does not reach has a zero gradient).  The loss
    renders with the fixed-depth :func:`render_batch`, or, with
    ``regen_iters``, with the differentiable regeneration integrator over
    that many iterations (:func:`renderer.regen_iters_estimate`).  The
    returned loss is the one before the step.

    With ``mesh`` every rank renders ``cfg.spp // world`` samples (which
    must divide) with the seed ``derive_seed(seed, rank)``; the loss and
    the gradients are averaged over the ranks before the step, so every
    rank holds the same parameters after it.
    """
    tcfg = cfg.trace_cfg()
    rank, world = (0, 1) if mesh is None else _rank_world(mesh)
    _check_divides(cfg.spp, world)
    spp = cfg.spp // world

    def loss_fn(scene, camera, target, seed):
        if regen_iters is not None:
            spp_par, spp_seq = fit_regen_split(spp)
            img, cnt = render_batch_regen_diff(
                scene, camera, seed, cfg.width, cfg.height, spp_par, spp_seq, regen_iters, tcfg
            )
            img = img / torch.clamp(cnt, min=1)[None]
        else:
            img = render_batch(scene, camera, seed, cfg.width, cfg.height, spp, tcfg) / float(spp)
        return torch.mean((img - target) ** 2)

    def step(scene: SceneData, camera: Camera, target: torch.Tensor, seed: int):
        leaves = [scene.materials.param, scene.textures.color] + [getattr(camera, f) for f in CAMERA_LEAVES]
        leaves = [x.detach().requires_grad_() for x in leaves]
        if mesh is not None:
            seed = derive_seed(seed, rank)
        loss = loss_fn(with_params(scene, *leaves[:2]), Camera(*leaves[2:]), target, seed)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        if mesh is not None:
            loss, grads = _mean_over_ranks(mesh, loss, grads, leaves)
        with torch.no_grad():
            new = [x if g is None else x - lr * g for x, g in zip(leaves, grads)]
        new = [x.detach() for x in new]
        return with_params(scene, *new[:2]), Camera(*new[2:]), loss.detach()

    return step
