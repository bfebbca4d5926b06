"""Wavefront path-regeneration integrator (PyTorch, forward only).

Counterpart of ``raytracer2022_tpu/render/integrator.py`` (reference
``ray_color``, raytracer/src/main.rs:233-278).  Per path vertex: closest
hit -> emitted -> scatter -> mixture-PDF sample -> throughput/radiance
update; the vertex math (:func:`_eval_vertex`) is the JAX package's.

:func:`trace_regen` runs the global sample pool with its N/4 -> N/16 narrow
drain, the schedule the renderer uses for every launch (launches hold at
most 32 sequential samples, and the JAX package picks the global pool for
``spp_seq <= 32``).  Each ``while`` condition reads one or two counts on the
host, so every iteration costs one device synchronisation.  The pixel-pool
and quota schedules and the ray sort are not ported yet (ROADMAP.md, port
queue: 'Pixel-pool and quota schedules, and the ray sort').
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, NamedTuple, Optional

import torch

from ..ops.intersect import closest_hit
from ..ops.lights import lights_pdf, sample_lights
from ..ops.materials import emitted, scatter, scattering_pdf_lambertian, texture_value
from ..ops.sampling import cos_pdf_value, cosine_about_normal, uniform
from ..ops.vecmath import dot, scale, to_unit, vec3
from ..scene.types import ISOTROPIC, LAMBERTIAN, SceneData

_SCHEDULES_TODO = (
    "not ported yet (ROADMAP.md, port queue: 'Pixel-pool and quota schedules, "
    "and the ray sort')"
)


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    max_depth: int = 50
    background: Optional[tuple] = (0.0, 0.0, 0.0)  # None => book1/2 sky gradient
    t_min: float = 1e-3
    spawn_eps: float = 1e-4  # relative origin offset (f32 robustness); 0 = off
    sort_rays: bool = False  # per-bounce coherence sort (not ported yet)


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


def _background(cfg: TraceConfig, d):
    if cfg.background is not None:
        return vec3(*(torch.full_like(d[0], float(c)) for c in cfg.background))
    # RTiOW sky gradient of the book1/book2 golden images
    unit_d = to_unit(d)
    tt = 0.5 * (unit_d[1] + 1.0)
    ones = torch.ones_like(tt)
    white = vec3(ones, ones, ones)
    blue = vec3(0.5 * ones, 0.7 * ones, ones)
    return scale(white, 1.0 - tt) + scale(blue, tt)


class _Vertex(NamedTuple):
    """Result of evaluating one path vertex for the whole wavefront."""

    radiance_add: torch.Tensor  # (3, N) throughput-weighted contribution
    cont: torch.Tensor  # bool[N] path continues
    o: torch.Tensor  # next ray (valid where cont)
    d: torch.Tensor
    tm: torch.Tensor
    throughput: torch.Tensor  # updated throughput (valid where cont)


def _eval_vertex(
    scene: SceneData, cfg: TraceConfig, o, d, tm, throughput, alive, gen: torch.Generator
) -> _Vertex:
    """One path vertex: closest hit -> emitted -> scatter -> MIS sample.

    Semantics of ray_color (main.rs:233-278): the specular branch carries
    attenuation without emission; the diffuse branch samples a 50/50
    mixture of the lights and the cosine lobe; a mixture pdf <= 0 or NaN
    kills the sample with its radiance kept.
    """
    n = tm.shape[0]
    has_lights = len(scene.stats.light_ids) > 0

    # Park dead lanes far outside every AABB so tree walks reject them at
    # the root (1e6, beyond any library scene; 1e30 would overflow when
    # squared in the sphere quadratic).
    o = torch.where(alive[None], o, 1e6)
    d = torch.where(alive[None], d, 1.0)

    hit, shade = closest_hit(scene, o, d, tm, cfg.t_min, float("inf"))
    tex_val = texture_value(scene.textures, shade, hit, scene.stats.features)
    em = emitted(shade, hit, tex_val)
    sc = scatter(shade, hit, tex_val, d, tm, gen)

    # diffuse branch: 50/50 mixture of light and cosine (main.rs:263-266)
    cos_dir = cosine_about_normal(gen, hit.normal)
    if has_lights:
        light_dir = sample_lights(scene, hit.p, gen)
        pick_light = uniform(gen, (n,)) < 0.5
        new_dir = torch.where(pick_light[None], light_dir, cos_dir)
        pdf_val = 0.5 * lights_pdf(scene, hit.p, new_dir, tm) + 0.5 * cos_pdf_value(
            new_dir, to_unit(hit.normal)
        )
    else:
        # lightless scenes: pure cosine importance sampling
        new_dir = cos_dir
        pdf_val = cos_pdf_value(new_dir, to_unit(hit.normal))

    spdf = scattering_pdf_lambertian(hit.normal, new_dir)
    lamb = shade.mat_kind == LAMBERTIAN

    miss = alive & ~hit.hit
    absorb = alive & hit.hit & ~sc.has_scatter
    specular = alive & hit.hit & sc.has_scatter & sc.is_specular
    diffuse = alive & hit.hit & sc.has_scatter & ~sc.is_specular & lamb
    pdf_ok = pdf_val > 0.0  # NaN compares False
    diffuse = diffuse & pdf_ok

    radiance_add = torch.where(miss[None], throughput * _background(cfg, d), 0.0)
    radiance_add = radiance_add + torch.where((absorb | diffuse)[None], throughput * em, 0.0)

    w_diffuse = sc.attenuation * (spdf / torch.where(diffuse & pdf_ok, pdf_val, 1.0))[None]
    throughput = torch.where(
        specular[None],
        throughput * sc.attenuation,
        torch.where(diffuse[None], throughput * w_diffuse, throughput),
    )

    next_dir = torch.where(specular[None], sc.spec_dir, new_dir)
    next_tm = torch.where(specular, sc.spec_time, tm)
    if cfg.spawn_eps > 0.0:
        # origin offset along the face normal toward the outgoing side
        is_surface = shade.mat_kind != ISOTROPIC
        eps = cfg.spawn_eps * torch.clamp(torch.abs(hit.p).amax(dim=0), min=1.0)
        side = torch.sign(dot(hit.normal, next_dir))
        new_o = hit.p + scale(hit.normal, eps * side * is_surface.to(eps.dtype))
    else:
        new_o = hit.p

    return _Vertex(
        radiance_add=radiance_add,
        cont=specular | diffuse,
        o=new_o,
        d=next_dir,
        tm=next_tm,
        throughput=throughput,
    )


class _Drain(NamedTuple):
    """Lanes of a narrow drain stage: each finishes its in-flight sample."""

    o: torch.Tensor
    d: torch.Tensor
    tm: torch.Tensor
    th: torch.Tensor
    sr: torch.Tensor  # in-flight sample radiance
    alive: torch.Tensor
    depth: torch.Tensor

    def take(self, idx: torch.Tensor) -> "_Drain":
        return _Drain(*(x[..., idx] for x in self))


def _drain(scene, cfg, gen, lanes: _Drain, j: int, more: Callable[[int], bool]):
    """Bounce ``lanes`` (no regeneration) while ``j < max_depth + 1`` and
    ``more(alive_count)``; -> (lanes, j)."""
    while j < cfg.max_depth + 1 and more(int(lanes.alive.sum())):
        o, d, tm, th, sr, alive, dp = lanes
        vx = _eval_vertex(scene, cfg, o, d, tm, th, alive, gen)
        dp = dp + 1
        cont = vx.cont & (dp < cfg.max_depth)
        lanes = _Drain(
            o=torch.where(cont[None], vx.o, o),
            d=torch.where(cont[None], vx.d, d),
            tm=torch.where(cont, vx.tm, tm),
            th=torch.where(cont[None], vx.throughput, th),
            sr=sr + vx.radiance_add,  # masked by `alive`
            alive=cont,
            depth=dp,
        )
        j += 1
    return lanes, j


def _first_true(mask: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the lanes where ``mask`` holds first, in lane order,
    padded with the others: a stable compaction to width ``k``."""
    return torch.sort((~mask).to(torch.uint8), stable=True).indices[:k]


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
    carries pixel ``l % n_pix`` and the lanes of one pixel sum to that
    pixel's ``spp_par * spp_seq`` samples.

    **Global sample pool**: the launch shares one pool of ``N * spp_seq``
    samples; sample ``m`` targets pixel ``m % n_pix``.  A lane that finishes
    (or idles) reserves the next undone sample by an exclusive cumsum over
    the wavefront.  A finished sample's radiance is written at
    ``(slot, lane)``, where ``slot`` is the lane's completed-sample count,
    and the sample's pixel is recorded at the same place; one
    ``index_add_`` regroups everything by pixel at the end.  With
    ``s_max > spp_seq`` slots the pool drains before any lane could cap
    out, so every pixel gets exactly ``spp_par * spp_seq`` samples.

    **Narrow drain** (N >= 8192): once the pool is empty and the lanes
    still in flight fit in N/4, they are compacted to N/4 and finished
    there, then again to N/16.

    ``index_add_`` on CUDA sums with atomics in an order that changes
    between runs, so two runs agree to float tolerance, not bit for bit.
    ``return_iters`` also returns the iteration counts of the three phases.
    """
    if cfg.sort_rays:
        raise NotImplementedError(f"the ray sort is {_SCHEDULES_TODO}")
    schedule = choose_schedule(spp_seq, spp_par) if schedule is None else schedule
    if schedule is not Schedule.GLOBAL:
        raise NotImplementedError(f"the {schedule.value} schedule is {_SCHEDULES_TODO}")
    if spp_par is None:
        raise ValueError("the global pool needs spp_par (lanes per pixel)")

    dev = pix0.device
    n = pix0.shape[0]
    n_pix = n // spp_par
    # slot capacity: N * s_max > N * spp_seq, so the pool drains first
    s_max = 2 * spp_seq + 2 if spp_seq <= 16 else spp_seq + 8
    max_iter = (spp_seq + 1) * cfg.max_depth + 2  # hard safety bound
    narrow = n >= 8192
    n2 = n // 4 if narrow else n
    n3 = n // 16

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
        n_work, rem = torch.stack([working.sum(), remaining]).tolist()
        go = n_work > 0 or rem > 0
        if narrow:
            # hand off once the pool is empty and the survivors fit in N/4
            go = go and (rem > 0 or n_work > n2)
        if not go:
            break
        vx = _eval_vertex(scene, cfg, o, d, tm, throughput, working, gen)
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
        perm = _first_true(working, n2)
        lanes = _Drain(o, d, tm, throughput, sample_rad, working, depth).take(perm)
        pix_b = torch.where(lanes.alive, pix[perm], n_pix)
        lanes, j4 = _drain(scene, cfg, gen, lanes, 0, lambda k: k > n3)
        perm2 = _first_true(lanes.alive, n3)
        lanes2, j16 = _drain(scene, cfg, gen, lanes.take(perm2), j4, lambda k: k > 0)
        sr = lanes.sr.clone()
        sr[:, perm2] = lanes2.sr
        vals = torch.cat([vals, sr], dim=1)
        pids = torch.cat([pids, pix_b])
        iters.update(drain_n4=j4, drain_n16=j16 - j4)
    # one regroup by pixel (the sentinel n_pix row drops off)
    img = torch.zeros((3, n_pix + 1), dtype=torch.float32, device=dev)
    img.index_add_(1, pids, vals)
    # per-lane contract: lane l carries pixel l % n_pix
    radiance = img[:, :n_pix].repeat(1, spp_par) / float(spp_par)
    return (radiance, iters) if return_iters else radiance
