"""Wavefront path-tracing integrators, forward and differentiable (PyTorch).

Counterpart of ``raytracer2022_tpu/render/integrator.py`` (reference
``ray_color``, raytracer/src/main.rs:233-278).  Per path vertex: closest
hit -> emitted -> scatter -> mixture-PDF sample -> throughput/radiance
update; the vertex math (:func:`_eval_vertex`) is the JAX package's.
After the closest hit it draws one block of variates a vertex, on every
device and with or without gradients, and hands the rest to
:func:`ops.vertex.vertex_tail`: the hand-written kernel for card tensors
that want no gradient, its plain version everywhere else.

Forward: :func:`trace_regen` is the path regeneration wavefront with three
schedules (:class:`Schedule`): the global sample pool, the pixel pool and
per-lane quotas, each finished by N/4 -> N/16 narrow drains, and an
optional per-bounce ray sort.  Each of its ``while`` conditions reads one
or two counts on the host (:func:`utils.profiling.host_sync`), so every
iteration costs one device synchronisation; the counts also give the
launch record's lane occupancy (:func:`utils.profiling.count_lanes`).
The scheduler's own work runs in ``regen.*`` spans.
:func:`measure_regen_handoff` runs the pixel-pool schedule forward to
find its drain handoff.

Differentiable (``torch.autograd``): :func:`trace`, the fixed-depth bounce
loop, and :func:`trace_regen_diff`, the regeneration schedule over a fixed
trip count with its narrow-drain cascade.  Neither reads a count on the
host.  Every bounce or iteration runs under
``torch.utils.checkpoint.checkpoint``, so the backward keeps one
iteration's carry and recomputes its inside.  The generator rule: a
checkpointed segment draws only from a generator it builds itself from
the integer seed and its step (:func:`step_generator`), the counterpart of
JAX's ``fold_in(key, step)``.  The checkpoint restores the default
generators only, so a segment that drew from a generator passed in would
replay other numbers when recomputed and give a wrong gradient silently.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..ops.intersect import closest_hit
from ..ops.sort import ray_sort_key, sort_by_key
from ..ops.vertex import Vertex, vertex_tail
from ..scene.types import SceneData
from ..utils.profiling import count_lanes, host_sync, span


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    max_depth: int = 50
    background: Optional[tuple] = (0.0, 0.0, 0.0)  # None => book1/2 sky gradient
    t_min: float = 1e-3
    spawn_eps: float = 1e-4  # relative origin offset (f32 robustness); 0 = off
    sort_rays: bool = False  # per-bounce coherence sort (ops/sort.py), quota schedule


class Schedule(enum.Enum):
    """How a regeneration launch hands out samples to lanes."""

    GLOBAL = "global"  # one pool of N * spp_seq samples shared by all lanes
    PIXEL = "pixel"  # each pixel's samples shared by that pixel's lanes
    QUOTA = "quota"  # each lane runs exactly spp_seq samples


def choose_schedule(spp_seq: int, spp_par: Optional[int]) -> Schedule:
    """The JAX package's heuristic (``pool = spp_seq <= 32 or "pixel"``),
    made explicit: the global pool up to 32 sequential samples per lane,
    the pixel pool above, the quota schedule without lanes per pixel."""
    if spp_par is None:
        return Schedule.QUOTA
    return Schedule.GLOBAL if spp_seq <= 32 else Schedule.PIXEL


def derive_seed(seed: int, step: int) -> int:
    """The integer seed of step ``step`` of a stream seeded ``seed``."""
    return int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0])


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """A fresh generator on ``device`` for step ``step`` of a stream seeded
    ``seed``: the same numbers however often the step is run."""
    gen = torch.Generator(device=device)
    gen.manual_seed(derive_seed(seed, step))
    return gen


def _checkpointed(fn, *args):
    """``fn(*args)`` with its inside recomputed in the backward
    (``jax.checkpoint``); ``fn`` must build its own generator."""
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)


def _eval_vertex(
    scene: SceneData, cfg: TraceConfig, o, d, tm, throughput, alive, gen: torch.Generator,
    recompute_t: bool = True,
) -> Vertex:
    """One path vertex: closest hit, then :func:`ops.vertex.vertex_tail`
    (texture, emission, scatter, mixture sample and update).

    Semantics of ray_color (main.rs:233-278): the specular branch carries
    attenuation without emission; the diffuse branch samples a 50/50
    mixture of the lights and the cosine lobe; a mixture pdf <= 0 or NaN
    kills the sample with its radiance kept.  ``recompute_t`` goes to
    :func:`closest_hit`: the forward-only schedules pass False.
    """
    # Park dead lanes far outside every AABB so tree walks reject them at
    # the root (1e6, beyond any library scene; 1e30 would overflow when
    # squared in the sphere quadratic, and its non-finite primals would
    # poison the backward: 0 * inf = NaN on the masked lanes).
    o = torch.where(alive[None], o, 1e6)
    d = torch.where(alive[None], d, 1.0)

    with span("vertex.closest_hit"):
        hit, shade = closest_hit(scene, o, d, tm, cfg.t_min, float("inf"), gen, recompute_t)
    return vertex_tail(scene, cfg, hit, shade, d, tm.contiguous(), throughput.contiguous(), alive.contiguous(), gen)


def _first_true(mask: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the lanes where ``mask`` holds first, in lane order,
    padded with the others: a stable compaction to width ``k``."""
    return torch.sort((~mask).to(torch.uint8), stable=True).indices[:k]


def trace(scene: SceneData, o, d, tm, seed: int, cfg: TraceConfig) -> torch.Tensor:
    """Trace a wavefront to completion -> radiance (3, N).

    The fixed-depth loop of the JAX package's ``trace``: ``max_depth``
    vertices, every one at full wavefront width, with dead lanes masked.
    Its trip count is fixed, so it never reads a count on the host.
    Reverse-differentiable: bounce ``b`` is checkpointed and draws from
    ``step_generator(seed, b + 1)``.  For forward renders
    :func:`trace_regen` is faster.
    """
    n = tm.shape[0]
    dev = o.device

    def bounce(b, o, d, tm, throughput, radiance, alive):
        gen = step_generator(seed, b + 1, dev)
        vx = _eval_vertex(scene, cfg, o, d, tm, throughput, alive, gen)
        radiance = radiance + vx.radiance_add  # masked by `alive`
        cont = vx.cont
        o = torch.where(cont[None], vx.o, o)
        d = torch.where(cont[None], vx.d, d)
        tm = torch.where(cont, vx.tm, tm)
        throughput = torch.where(cont[None], vx.throughput, throughput)
        return o, d, tm, throughput, radiance, cont

    carry = (
        o, d, tm,
        torch.ones((3, n), dtype=torch.float32, device=dev),
        torch.zeros((3, n), dtype=torch.float32, device=dev),
        torch.ones((n,), dtype=torch.bool, device=dev),
    )
    for b in range(cfg.max_depth):
        carry = _checkpointed(bounce, b, *carry)
    return carry[4]


def _pool_reserve(want: torch.Tensor, remaining: torch.Tensor, spp_par: int):
    """Grant pixel-pool samples to the lanes that want one.

    Lanes are pixel-strided (lane l serves pixel l % n_pix), so the
    ``(spp_par, n_pix)`` view has one column per pixel; an exclusive cumsum
    down each column ranks the pixel's requesters and the first
    ``remaining[pixel]`` of them are granted.  -> (start bool[N], remaining').
    """
    wantm = want.reshape(spp_par, -1)
    wanti = wantm.to(remaining.dtype)
    rank = torch.cumsum(wanti, dim=0) - wanti  # exclusive rank within the pixel
    startm = wantm & (rank < remaining[None])
    remaining = remaining - startm.sum(dim=0)
    return startm.reshape(-1), remaining


class _Lanes(NamedTuple):
    """Per-lane state of the pixel-pool and quota schedules and of the
    narrow drains."""

    o: torch.Tensor
    d: torch.Tensor
    tm: torch.Tensor
    th: torch.Tensor
    rad: torch.Tensor  # radiance sum of the lane's finished and in-flight samples
    need: torch.Tensor  # samples the lane still owes after its in-flight one
    alive: torch.Tensor  # a sample is in flight
    depth: torch.Tensor
    pix: torch.Tensor  # the lane's pixel

    def take(self, idx: torch.Tensor) -> "_Lanes":
        return _Lanes(*(x[..., idx] for x in self))


def _regen_step(scene, cfg, gen, gen_rays, lanes: _Lanes, reserve=None):
    """One vertex of every live lane, then regeneration: a lane whose sample
    finished starts a new one where it still owes samples (``need``), or,
    with ``reserve`` (the pixel pool's phase A), where ``reserve(want)``
    grants one.  With ``gen_rays`` None the lanes owe nothing (the global
    pool's drains): no lane starts a sample and no ray is generated."""
    o, d, tm, th, rad, need, alive, depth, pix = lanes
    vx = _eval_vertex(scene, cfg, o, d, tm, th, alive, gen, recompute_t=False)  # forward only
    with span("regen.update"):
        rad = rad + vx.radiance_add  # masked by `alive`
        depth = depth + 1
        cont = vx.cont & (depth < cfg.max_depth)  # depth cap = black tail
        if gen_rays is None:
            return lanes._replace(
                o=torch.where(cont[None], vx.o, o),
                d=torch.where(cont[None], vx.d, d),
                tm=torch.where(cont, vx.tm, tm),
                th=torch.where(cont[None], vx.throughput, th),
                rad=rad,
                alive=cont,
                depth=depth,
            )
        finished = alive & ~cont
        if reserve is None:
            start = finished & (need > 0)
            need = need - start.to(need.dtype)
        else:
            start = reserve(finished | ~alive)
        with span("regen.rays"):
            o_new, d_new, tm_new = gen_rays(gen, pix)
        return _Lanes(
            o=torch.where(start[None], o_new, torch.where(cont[None], vx.o, o)),
            d=torch.where(start[None], d_new, torch.where(cont[None], vx.d, d)),
            tm=torch.where(start, tm_new, torch.where(cont, vx.tm, tm)),
            th=torch.where(start[None], 1.0, torch.where(cont[None], vx.throughput, th)),
            rad=rad,
            need=need,
            alive=cont | start,
            depth=torch.where(start, 0, depth),
            pix=pix,
        )


def _regen_drains(scene, cfg, gen, gen_rays, lanes: _Lanes, it: int, max_iter: int):
    """The narrow drains of every schedule: compact the live lanes (stable)
    into an N/4 wavefront and run their quotas there while more than N/16
    live, then compact again into N/16 and finish (global-pool lanes owe
    nothing after their in-flight sample and pass ``gen_rays`` None).
    -> (per-lane radiance at full width, iterations of each stage)."""
    n = lanes.alive.shape[0]
    stages, counts = [], []
    cur = lanes
    for width, stop in ((n // 4, n // 16), (n // 16, 0)):
        with span("regen.compact"):
            perm = _first_true(cur.alive, width)
            nxt = cur.take(perm)
        j = 0
        while it < max_iter:
            live = host_sync(int, nxt.alive.sum())
            if live <= stop:
                break
            count_lanes(live, width)
            nxt = _regen_step(scene, cfg, gen, gen_rays, nxt)
            it += 1
            j += 1
        stages.append((cur.rad, perm))
        counts.append(j)
        cur = nxt
    with span("regen.compact"):
        rad = cur.rad
        for outer, perm in reversed(stages):
            outer = outer.clone()
            outer[:, perm] = rad
            rad = outer
    return rad, counts


def _trace_lanes(scene, gen_rays, pix0, spp_seq, gen, cfg, spp_par, pixel_pool, do_sort):
    """The pixel-pool (``pixel_pool``) and quota schedules -> (per-lane
    radiance SUM (3, N), iterations by phase).

    **Quota**: every lane runs exactly ``spp_seq`` samples of its own pixel.
    **Pixel pool**: each pixel's ``spp_par * spp_seq`` samples are shared by
    that pixel's ``spp_par`` lanes; a lane idles only when its pixel's pool
    is empty.  With the narrow drains (N >= 8192, no sort), phase A hands
    off once N/4 or fewer lanes live; a pixel with samples left has all its
    lanes live then, and its leftover pool is split among them by rank as
    per-lane quotas, so every pixel still gets exactly
    ``spp_par * spp_seq`` samples.

    With ``do_sort`` (quota only), the wavefront is sorted by
    :func:`ops.sort.ray_sort_key` after every vertex, and the final
    radiance is regrouped by pixel: sorted by pixel id (pixel-contiguous),
    then, with ``spp_par``, reshaped to lane ``l`` -> pixel ``l % n_pix``.
    """
    n = pix0.shape[0]
    dev = pix0.device
    max_iter = (spp_seq + 1) * cfg.max_depth + 2  # hard safety bound
    narrow = n >= 8192 and not do_sort
    n2 = n // 4 if narrow else n
    wb = scene.stats.world_bounds

    o, d, tm = gen_rays(gen, pix0)
    reserve = None
    if pixel_pool:
        n_pix = n // spp_par
        remaining = torch.full((n_pix,), spp_par * (spp_seq - 1), dtype=torch.int64, device=dev)
        need = torch.zeros((n,), dtype=torch.int64, device=dev)

        def reserve(want):
            nonlocal remaining
            start, remaining = _pool_reserve(want, remaining, spp_par)
            return start
    else:
        need = torch.full((n,), spp_seq - 1, dtype=torch.int64, device=dev)
    lanes = _Lanes(
        o=o,
        d=d,
        tm=tm,
        th=torch.ones((3, n), dtype=torch.float32, device=dev),
        rad=torch.zeros((3, n), dtype=torch.float32, device=dev),
        need=need,
        alive=torch.ones((n,), dtype=torch.bool, device=dev),
        depth=torch.zeros((n,), dtype=torch.int32, device=dev),
        pix=pix0,
    )
    it = 0
    while it < max_iter:
        n_live = host_sync(int, lanes.alive.sum())
        if n_live == 0 or (narrow and n_live <= n2):
            break
        count_lanes(n_live, n)
        lanes = _regen_step(scene, cfg, gen, gen_rays, lanes, reserve)
        if do_sort:
            # re-pack neighbouring lanes into coherent rays; every per-lane
            # state tensor follows the one permutation
            with span("regen.sort"):
                lanes = _Lanes(*sort_by_key(ray_sort_key(lanes.o, lanes.d, wb[0], wb[1]), lanes))
        it += 1

    iters = {"pool": it, "drain_n4": 0, "drain_n16": 0}
    rad = lanes.rad
    if narrow:
        if pixel_pool:
            # split each pixel's leftover pool among its live lanes by rank
            alivem = lanes.alive.reshape(spp_par, n_pix)
            ai = alivem.to(torch.int64)
            rank = torch.cumsum(ai, dim=0) - ai
            k_al = torch.clamp(ai.sum(dim=0), min=1)
            need_m = (remaining // k_al)[None] + (rank < (remaining % k_al)[None]).to(torch.int64)
            lanes = lanes._replace(need=torch.where(alivem, need_m, 0).reshape(-1))
        rad, (j4, j16) = _regen_drains(scene, cfg, gen, gen_rays, lanes, it, max_iter)
        iters.update(drain_n4=j4, drain_n16=j16)
    if do_sort:
        # regroup by pixel: pixel-contiguous, then pixel-strided
        (rad,) = sort_by_key(lanes.pix, (rad,))
        if spp_par is not None:
            rad = rad.reshape(3, -1, spp_par).transpose(1, 2).reshape(3, n)
    return rad, iters


def _trace_global(scene, gen_rays, pix0, spp_seq, gen, cfg, spp_par):
    """The global sample pool -> (per-lane radiance SUM (3, N), iterations
    by phase).

    The launch shares one pool of ``N * spp_seq`` samples; sample ``m``
    targets pixel ``m % n_pix``.  A lane that finishes (or idles) reserves
    the next undone sample by an exclusive cumsum over the wavefront.  A
    finished sample's radiance is written at ``(slot, lane)``, where
    ``slot`` is the lane's completed-sample count, and the sample's pixel
    is recorded at the same place; one ``index_add_`` regroups everything
    by pixel at the end.  With ``s_max > spp_seq`` slots the pool drains
    before any lane could cap out, so every pixel gets exactly
    ``spp_par * spp_seq`` samples.

    **Narrow drain** (N >= 8192): once the pool is empty and the lanes
    still in flight fit in N/4, they are compacted to N/4 and finished
    there, then again to N/16.

    ``index_add_`` on CUDA sums with atomics in an order that changes
    between runs, so two runs agree to float tolerance, not bit for bit.
    """
    dev = pix0.device
    n = pix0.shape[0]
    n_pix = n // spp_par
    # slot capacity: N * s_max > N * spp_seq, so the pool drains first
    s_max = 2 * spp_seq + 2 if spp_seq <= 16 else spp_seq + 8
    max_iter = (spp_seq + 1) * cfg.max_depth + 2  # hard safety bound
    narrow = n >= 8192
    n2 = n // 4 if narrow else n

    lane = torch.arange(n, device=dev)
    pix = lane % n_pix  # samples 0..N-1
    o, d, tm = gen_rays(gen, pix)
    # deposit store and pixel map, by (slot, lane); the spare row s_max takes
    # the writes of lanes that have nothing to record this iteration
    store = torch.zeros((3, s_max + 1, n), dtype=torch.float32, device=dev)
    pix_map = torch.full((s_max + 1, n), n_pix, dtype=torch.int64, device=dev)
    pix_map[0] = pix
    sample_rad = torch.zeros((3, n), dtype=torch.float32, device=dev)
    throughput = torch.ones((3, n), dtype=torch.float32, device=dev)
    working = torch.ones((n,), dtype=torch.bool, device=dev)
    remaining = torch.full((), n * (spp_seq - 1), dtype=torch.int64, device=dev)
    drawn = torch.full((), n, dtype=torch.int64, device=dev)
    slots = torch.zeros((n,), dtype=torch.int64, device=dev)
    depth = torch.zeros((n,), dtype=torch.int32, device=dev)

    it = 0
    while it < max_iter:
        n_work, rem = host_sync(torch.Tensor.tolist, torch.stack([working.sum(), remaining]))
        go = n_work > 0 or rem > 0
        if narrow:
            # hand off once the pool is empty and the survivors fit in N/4
            go = go and (rem > 0 or n_work > n2)
        if not go:
            break
        count_lanes(n_work, n)
        vx = _eval_vertex(scene, cfg, o, d, tm, throughput, working, gen, recompute_t=False)
        with span("regen.update"):
            depth = depth + 1
            cont = vx.cont & (depth < cfg.max_depth)  # depth cap = black tail
            finished = working & ~cont

            sample_rad = sample_rad + vx.radiance_add
            # each (slot, lane) pair is written once: a direct indexed write
            store[:, torch.where(finished, slots, s_max), lane] = sample_rad
            slots = slots + finished
            sample_rad = torch.where(finished[None], 0.0, sample_rad)
            # reserve pool samples for idle or just-finished lanes with slot room
            want = (finished | ~working) & (slots < s_max)
            wanti = want.to(torch.int64)
            rank = torch.cumsum(wanti, dim=0) - wanti
            start = want & (rank < remaining)
            pix = torch.where(start, (drawn + rank) % n_pix, pix)
            n_started = start.sum()
            pix_map[torch.where(start, slots, s_max), lane] = pix
            working = cont | start
            remaining = remaining - n_started
            drawn = drawn + n_started

            with span("regen.rays"):
                o_new, d_new, tm_new = gen_rays(gen, pix)
            o = torch.where(start[None], o_new, torch.where(cont[None], vx.o, o))
            d = torch.where(start[None], d_new, torch.where(cont[None], vx.d, d))
            tm = torch.where(start, tm_new, torch.where(cont, vx.tm, tm))
            throughput = torch.where(
                start[None], 1.0, torch.where(cont[None], vx.throughput, throughput)
            )
            depth = torch.where(start, 0, depth)
        it += 1

    vals = store[:, :s_max].reshape(3, -1)
    pids = pix_map[:s_max].reshape(-1)
    iters = {"pool": it, "drain_n4": 0, "drain_n16": 0}
    if narrow:
        # no pool is left: each live lane finishes its one in-flight sample
        # (it owes no more, so no rays are generated), and the lane's pixel
        # takes the result
        lanes = _Lanes(o, d, tm, throughput, sample_rad, torch.zeros_like(slots), working, depth, pix)
        sr, (j4, j16) = _regen_drains(scene, cfg, gen, None, lanes, it, max_iter)
        vals = torch.cat([vals, sr], dim=1)
        pids = torch.cat([pids, torch.where(working, pix, n_pix)])
        iters.update(drain_n4=j4, drain_n16=j16)
    # one regroup by pixel (the sentinel n_pix row drops off)
    img = torch.zeros((3, n_pix + 1), dtype=torch.float32, device=dev)
    img.index_add_(1, pids, vals)
    # per-lane contract: lane l carries pixel l % n_pix
    radiance = img[:, :n_pix].repeat(1, spp_par) / float(spp_par)
    return radiance, iters


def trace_regen(
    scene: SceneData,
    gen_rays,  # (gen, pix i64[N]) -> (o (3,N), d (3,N), tm (N,))
    pix0: torch.Tensor,  # i64[N] lane -> pixel (lane l serves pixel l % n_pix)
    spp_seq: int,  # samples per lane
    gen: torch.Generator,
    cfg: TraceConfig,
    spp_par: Optional[int] = None,  # lanes per pixel
    schedule: Optional[Schedule] = None,  # None: choose_schedule
    return_iters: bool = False,
):
    """Path-regeneration wavefront -> per-lane radiance SUM (3, N); lane l
    carries pixel ``pix0[l]`` (``l % n_pix`` as the renderer lays lanes
    out) and the lanes of one pixel sum to that pixel's
    ``spp_par * spp_seq`` samples.

    A lane whose sample terminates (miss, absorption, pdf kill, depth cap)
    starts the next one at once, so iterations stay near full occupancy:
    about ``spp_seq * E[path length]`` of them instead of
    ``spp_seq * max_depth``.  The per-sample estimator is :func:`trace`'s.
    ``schedule`` picks how samples reach lanes (:class:`Schedule`); the ray
    sort (``cfg.sort_rays``, on scenes with a tree and N >= 2048) runs the
    quota schedule, as does a launch without ``spp_par``.
    ``return_iters`` also returns the iteration counts of phase A (before
    the drains) and of the two drain stages.
    """
    n = pix0.shape[0]
    do_sort = cfg.sort_rays and scene.use_bvh and n >= 2048
    schedule = choose_schedule(spp_seq, spp_par) if schedule is None else schedule
    if spp_par is None or do_sort:
        schedule = Schedule.QUOTA
    if schedule is Schedule.GLOBAL:
        radiance, iters = _trace_global(scene, gen_rays, pix0, spp_seq, gen, cfg, spp_par)
    else:
        radiance, iters = _trace_lanes(
            scene, gen_rays, pix0, spp_seq, gen, cfg, spp_par,
            pixel_pool=schedule is Schedule.PIXEL, do_sort=do_sort,
        )
    return (radiance, iters) if return_iters else radiance


def measure_regen_handoff(
    scene: SceneData,
    gen_rays,
    pix0: torch.Tensor,
    spp_seq: int,
    seed: int,
    cfg: TraceConfig,
    spp_par: int,
) -> int:
    """Run the pixel-pool schedule that :func:`trace_regen_diff` replays,
    forward, and return the iteration at which at most N/4 lanes are
    still alive: the narrow drain's handoff point.  A lane idles only
    when its own pixel's pool is empty, so by then all but the hardest
    pixels' pools have drained.  Forward only, under ``torch.no_grad``;
    it reads the live count on the host every iteration."""
    n = pix0.shape[0]
    dev = pix0.device
    remaining = torch.full((n // spp_par,), spp_par * (spp_seq - 1), dtype=torch.int64, device=dev)

    def reserve(want):
        nonlocal remaining
        start, remaining = _pool_reserve(want, remaining, spp_par)
        return start

    max_iter = (spp_seq + 1) * cfg.max_depth + 2
    it = 0
    with torch.no_grad():
        o, d, tm = gen_rays(step_generator(seed, 0, dev), pix0)
        lanes = _Lanes(
            o, d, tm,
            th=torch.ones((3, n), dtype=torch.float32, device=dev),
            rad=torch.zeros((3, n), dtype=torch.float32, device=dev),
            need=torch.zeros((n,), dtype=torch.int64, device=dev),
            alive=torch.ones((n,), dtype=torch.bool, device=dev),
            depth=torch.zeros((n,), dtype=torch.int32, device=dev),
            pix=pix0,
        )
        while it < max_iter and host_sync(int, lanes.alive.sum()) > max(n // 4, 1):
            lanes = _regen_step(scene, cfg, step_generator(seed, it + 1, dev), gen_rays, lanes, reserve)
            it += 1
    return it


def trace_regen_diff(
    scene: SceneData,
    gen_rays,  # (gen, pix i64[N]) -> (o (3,N), d (3,N), tm (N,))
    pix0: torch.Tensor,  # i64[N] lane -> pixel (fixed)
    spp_seq: int,  # samples each lane must complete
    n_iters: int,  # fixed trip count of the main phase
    seed: int,
    cfg: TraceConfig,
    spp_par: Optional[int] = None,  # lanes per pixel: the pixel-pooled schedule
    drain_iters: int = 0,  # trip count of the narrow-drain cascade (pooled only)
):
    """Differentiable path regeneration -> ``(radiance (3, N), done i32[N])``.

    The regeneration schedule of :func:`trace_regen` (a lane whose sample
    ends starts its pixel's next one at once) over a fixed number of
    iterations, so the loop needs no count on the host and
    ``torch.autograd`` differentiates it; each iteration is checkpointed.
    With ``spp_par`` the lanes of a pixel share its pool of
    ``spp_par * spp_seq`` samples; without, each lane runs ``spp_seq``.

    A sample's radiance accumulates in flight and joins ``radiance`` when
    the sample ends; ``done`` counts the ended samples.  A sample still in
    flight at the end contributes nothing, and ``radiance / done`` stays a
    consistent estimator; with ``n_iters >= spp_seq * max_depth`` every
    sample ends and the estimator is exactly :func:`trace`'s
    (:func:`renderer.regen_iters_estimate` picks a smaller trip count).

    **Narrow drain** (``drain_iters > 0``, pooled): once the pools empty no
    lane regenerates, so the survivors are compacted (stable, indices
    without gradient) into an N/4 wavefront and finished there; when
    N >= 16,384, after 8 iterations at N/4 they are compacted again into
    N/16 for the rest.  The values move by a
    differentiable gather, and each stage's finished samples go back to
    their lanes by an out-of-place ``index_add`` (unique indices, so its
    backward is a gather).  Survivors beyond the width, or still alive at
    the end, count as truncated.

    Step ``s`` draws from ``step_generator(seed, s)``: 0 for the first
    rays, ``it + 1`` for iteration ``it``, the drains continuing the count.
    Discrete decisions (hit winner, branch, light pick, termination, the
    schedule) are piecewise constant, so the gradients are the
    reparameterised path-replay gradients of :func:`trace`.
    """
    dev = pix0.device
    n = pix0.shape[0]
    pooled = spp_par is not None
    o, d, tm = gen_rays(step_generator(seed, 0, dev), pix0)
    zeros3 = torch.zeros((3, n), dtype=torch.float32, device=dev)

    def body(it, o, d, tm, th, sample_rad, radiance, done, depth, alive, remaining):
        gen = step_generator(seed, it + 1, dev)
        working = alive if pooled else done < spp_seq
        vx = _eval_vertex(scene, cfg, o, d, tm, th, working, gen)
        sample_rad = sample_rad + vx.radiance_add  # masked by `working`
        depth = depth + 1
        cont = vx.cont & (depth < cfg.max_depth)  # depth cap = black tail
        finished = working & ~cont
        radiance = radiance + torch.where(finished[None], sample_rad, 0.0)
        sample_rad = torch.where(finished[None], 0.0, sample_rad)
        done = done + finished.to(done.dtype)
        if pooled:
            start, remaining = _pool_reserve(finished | ~alive, remaining, spp_par)
            alive = cont | start
        else:
            start = finished  # quota: lanes regenerate unconditionally
        o_new, d_new, tm_new = gen_rays(gen, pix0)
        o = torch.where(start[None], o_new, torch.where(cont[None], vx.o, o))
        d = torch.where(start[None], d_new, torch.where(cont[None], vx.d, d))
        tm = torch.where(start, tm_new, torch.where(cont, vx.tm, tm))
        th = torch.where(start[None], 1.0, torch.where(cont[None], vx.throughput, th))
        depth = torch.where(start, 0, depth)
        return o, d, tm, th, sample_rad, radiance, done, depth, alive, remaining

    carry = (
        o, d, tm,
        torch.ones((3, n), dtype=torch.float32, device=dev),
        zeros3,
        zeros3,
        torch.zeros((n,), dtype=torch.int32, device=dev),
        torch.zeros((n,), dtype=torch.int32, device=dev),
        torch.ones((n,), dtype=torch.bool, device=dev),
        torch.full((n // spp_par,), spp_par * (spp_seq - 1), dtype=torch.int64, device=dev)
        if pooled else None,
    )
    for it in range(n_iters):
        carry = _checkpointed(body, it, *carry)
    o, d, tm, th, sample_rad, radiance, done, depth, alive, _ = carry
    if not pooled or drain_iters <= 0:
        return radiance, done

    def drain_body(step, o, d, tm, th, sr, alive, depth):
        vx = _eval_vertex(scene, cfg, o, d, tm, th, alive, step_generator(seed, step + 1, dev))
        sr = sr + vx.radiance_add  # masked by `alive`
        depth = depth + 1
        cont = vx.cont & (depth < cfg.max_depth)  # cont implies alive
        o = torch.where(cont[None], vx.o, o)
        d = torch.where(cont[None], vx.d, d)
        tm = torch.where(cont, vx.tm, tm)
        th = torch.where(cont[None], vx.throughput, th)
        return o, d, tm, th, sr, cont, depth

    # occupancy keeps decaying through the drain (N/4 alive at handoff,
    # ~1% within 8 iterations on cornell), so the tail runs at N/16
    if n >= 16 * 1024:
        stages = [(n // 4, min(8, drain_iters)), (n // 16, max(drain_iters - 8, 0))]
    else:
        stages = [(max(n // 4, 1), drain_iters)]
    lanes = torch.arange(n, device=dev)  # compacted lane -> original lane
    cur = (o, d, tm, th, sample_rad, alive, depth)
    step = n_iters
    for width, iters in stages:
        if iters == 0:
            continue
        perm = _first_true(cur[5], width)
        lanes = lanes[perm]
        cur = tuple(x[..., perm] for x in cur)
        alive0 = cur[5]
        for j in range(iters):
            cur = _checkpointed(drain_body, step + j, *cur)
        fin = alive0 & ~cur[5]  # samples that ended inside this stage
        radiance = radiance.index_add(1, lanes, torch.where(fin[None], cur[4], 0.0))
        done = done.index_add(0, lanes, fin.to(done.dtype))
        step += iters
    return radiance, done
