"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds kernel K1 (``raytracer2022_tpu_torch/csrc/bvh8.cu``) with nvcc,
checks it against its plain PyTorch version on every primitive kind (three
``t_init`` modes, both instantiations: group arrays in shared and in
global memory) and on the stand-in mesh at the main path's width, then
renders through the port's entry points: the stand-in mesh scene (whose K1
calls also give S2, bounce rays; S1 is camera rays, S3 final_scene's
sphere tree), holds K1's visit counts against the reference walk, times K1
at S1-S3 against its bound, holds K1 on the deepest tree the builder makes
(phase ``deep``: 22 group levels, the kernel's stack) and renders it, runs
``tools/perf.py`` on ``cornell_box`` and ``tools/bench.py`` (``bench.py``'s
cells) at a cut, and renders a stand-in ``final_scene``
(media, image and noise textures, a 1000-sphere cluster tree) through
``render_sum_n``, ``cornell_box`` and every library scene that needs no
file through ``cli.main``.  Phase ``assets`` writes stand-ins for the
files the repository does not hold (``write_stand_in_assets``: JPEG
textures by the port's encoder, an OBJ torus for the Shuttle), decodes
them with the port's decoder, renders the JAX CLI's default invocation
(``wwscene``, 640x360 x 100 spp, depth 50, K1 on the OBJ mesh's tree)
through ``cli.main`` into a JPEG, holds it card against CPU, and renders
``earth``, ``obj_uv_demo`` and ``final_scene`` from the files.  Phase
``installed`` builds a wheel of the checkout with pip, installs it into a
temporary directory and runs its ``rt2022-torch`` command from outside the
checkout at the same invocation: K1 and the host runtime build from the
sources the wheel ships into a per-user cache directory, nothing is
written under the install directory, and the JPEG matches phase
``assets``'.  Phase ``flagship`` renders the reference's own frame, ``wwscene`` at 2560x1440,
depth 50, through ``tools/flagship.py``: K1 against its plain version on a
full-frame strip's rays, 4 spp in two chunks, and the same run interrupted
and resumed, byte-equal to the uninterrupted image.  It runs
the pixel-pool and quota schedules with exact
per-pixel sample counts, the ray sort and the fixed-depth ``trace``, and
times the cluster walk against K1 on one sphere tree.  The ``diff`` phase
drives the differentiable path: K1 against the cluster walk under
gradients, a central difference, fwd+bwd through ``trace_regen_diff`` on
``cornell_box`` (256x256 x 64 spp, depth 50) and on the stand-in mesh
through K1 (128x128 x 32 spp), the fit step, and the fit demo.  Phases
``sampling`` and ``vertex`` hold the vertex's kernels (``csrc/mis_sample.cu``,
``csrc/vertex.cu``) to their plain versions at the first vertex of wwscene
and cornell_box_book, time the second against its byte bound, and count
its launches: one a vertex of a forward render, none in a fit step.  The
``multi`` phase starts ranks of ``parallel/worker.py``: the stand-in mesh
render sharded over one rank (NCCL) and two ranks on one card (gloo), and
over two cards (NCCL) where there are two, the sharded fit step on two
ranks, and the dry run.  Every phase that
fails makes the script exit non-zero; nothing falls back to the CPU.  The
last line of standard output is ``{"ok": true, "device": {...}}``; the
line before the card's name and power limit is the kernel table as JSON.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np

from raytracer2022_tpu_torch.tools.standins import (
    earth_stand_in,
    shuttle_obj_text,
    source_dir_env,
    write_stand_in_assets,
)

# stand-in mesh: a torus standing in for the Shuttle mesh (13,079 triangles)
TORUS_CENTER = (278.0, 200.0, 300.0)
TORUS_RADII = (120.0, 50.0)  # major, minor
TORUS_TILT_DEG = 60.0  # about the x axis, so the camera sees into the ring
TORUS_ALBEDO = (0.8, 0.85, 0.88)


def stand_in_mesh_scene(builder, nu: int = 96, nv: int = 68) -> dict:
    """Add ``cornell_box``'s exact builder calls plus a closed torus of
    ``2 * nu * nv`` triangles (metal, fuzz 0) inside the box to
    ``builder``, an instance of either package's ``SceneBuilder``.  Returns
    the camera kwargs; the background is black.  With the defaults the
    mesh has 13,056 triangles."""
    b = builder
    light = b.rect_xz(213, 343, 127, 232, 554, b.diffuse_light((60.0, 60.0, 60.0)))
    b.flip_face(light)
    b.add_light(light)
    red = b.lambertian((0.65, 0.05, 0.05))
    white = b.lambertian((0.73, 0.73, 0.73))
    green = b.lambertian((0.12, 0.45, 0.15))
    b.rect_yz(0, 555, 0, 555, 555, red)
    b.rect_yz(0, 555, 0, 555, 0, green)
    b.rect_xz(0, 555, 0, 555, 0, white)
    b.rect_xz(0, 555, 0, 555, 555, white)
    b.rect_xy(0, 555, 0, 555, 555, white)

    big, small = TORUS_RADII
    phi = 2.0 * math.pi * np.arange(nu) / nu
    th = 2.0 * math.pi * np.arange(nv) / nv
    ring = big + small * np.cos(th)[None, :]
    x = ring * np.cos(phi)[:, None]
    y = np.broadcast_to(small * np.sin(th)[None, :], (nu, nv))
    z = ring * np.sin(phi)[:, None]
    a = math.radians(TORUS_TILT_DEG)
    verts = np.stack(
        [x, y * math.cos(a) - z * math.sin(a), y * math.sin(a) + z * math.cos(a)], axis=-1
    ) + np.asarray(TORUS_CENTER)
    metal = b.metal(TORUS_ALBEDO, 0.0)
    for i in range(nu):
        i1 = (i + 1) % nu
        for j in range(nv):
            j1 = (j + 1) % nv
            b.triangle(verts[i, j], verts[i1, j], verts[i1, j1], metal)
            b.triangle(verts[i, j], verts[i1, j1], verts[i, j1], metal)
    return dict(
        lookfrom=(278.0, 278.0, -800.0),
        lookat=(278.0, 278.0, 0.0),
        vup=(0.0, 1.0, 0.0),
        vfov=40.0,
        aspect_ratio=1.0,
        aperture=0.0,
        focus_dist=10.0,
        time0=0.0,
        time1=1.0,
    )


def two_rect_scene(builder) -> dict:
    """The scene of the JAX package's tests/test_parallel.py: a rect light
    above a lambertian floor, added to ``builder`` (either package's).
    Returns the camera kwargs; the background is black."""
    b = builder
    light = b.rect_xz(-1, 1, -1, 1, 3.9, b.diffuse_light((8.0, 8.0, 8.0)))
    b.flip_face(light)
    b.add_light(light)
    b.rect_xz(-4, 4, -4, 4, 0.0, b.lambertian((0.6, 0.4, 0.3)))
    return dict(lookfrom=(0, 2, -8), lookat=(0, 1, 0), vup=(0, 1, 0), vfov=40, aspect_ratio=1.0)


def mesh_view_share(bundle, device, width: int = 64, height: int = 36) -> float:
    """Share of a ``width x height`` grid of camera rays (pixel centres) of a
    library scene ``bundle`` whose closest hit is a triangle: > 0 shows that
    ``wwscene``'s OBJ mesh is in the camera's view."""
    import torch

    from raytracer2022_tpu_torch.ops.intersect import closest_hit
    from raytracer2022_tpu_torch.render.camera import get_rays, make_camera

    cam = make_camera(**dict(bundle.camera_kwargs, aspect_ratio=width / height), device=device)
    ys, xs = torch.meshgrid(torch.arange(height, device=device), torch.arange(width, device=device), indexing="ij")
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    o, d, tm = get_rays(cam, (xs.reshape(-1).float() + 0.5) / width, (ys.reshape(-1).float() + 0.5) / height, gen)
    with torch.no_grad():
        hit, _ = closest_hit(bundle.scene, o, d, tm, 1e-3, float("inf"), gen, recompute_t=False)
    on_mesh = hit.hit & (bundle.scene.kind[hit.prim] == TRIANGLE)
    return float(on_mesh.float().mean())


def final_scene_stand_in(builder, earth: np.ndarray) -> dict:
    """``scene/library.py::final_scene`` (book 2's final scene) call for
    call, with ``earth`` as the earth sphere's image in place of the file:
    400 ground boxes, two media (one inside a glass sphere), a moving
    sphere, glass, fuzzy metal, image and noise textures, and 1000 rotated
    and translated spheres.  Works with either package's ``SceneBuilder``,
    whose ``rng`` draws the box heights and sphere centres.  Returns the
    camera kwargs; the background is black."""
    b = builder
    rng = b.rng
    ground = b.lambertian((0.48, 0.83, 0.53))
    for i in range(20):
        for j in range(20):
            w = 100.0
            x0 = -1000.0 + i * w
            z0 = -1000.0 + j * w
            y1 = rng.uniform(1.0, 101.0)
            b.box((x0, 0.0, z0), (x0 + w, y1, z0 + w), ground)
    light = b.rect_xz(123, 423, 147, 412, 554, b.diffuse_light((7.0, 7.0, 7.0)))
    b.flip_face(light)
    b.add_light(light)
    center1 = np.array([400.0, 400.0, 200.0])
    b.moving_sphere(center1, center1 + [25, 0, 0], 0.0, 1.0, 50, b.lambertian((0.7, 0.3, 0.1)))
    b.sphere((260, 150, 45), 50, b.dielectric(1.5))
    b.sphere((0, 150, 145), 50, b.metal((0.8, 0.8, 0.9), 1.0))
    b.sphere((360, 150, 145), 70, b.dielectric(1.5))
    shadow = b.sphere((360, 150, 145), 70, b.dielectric(1.5))
    b.constant_medium([shadow], 0.2, (0.2, 0.4, 0.9))
    world_boundary = b.sphere((0, 0, 0), 5000, b.dielectric(1.5))
    b.constant_medium([world_boundary], 0.0001, (1.0, 1.0, 1.0))
    b.sphere((400, 200, 400), 100, b.lambertian(b.image(earth)))
    b.sphere((220, 280, 300), 80, b.lambertian(b.noise(0.1)))
    white = b.lambertian((0.73, 0.73, 0.73))
    cluster = [b.sphere(rng.uniform(0, 165, 3), 10, white) for _ in range(1000)]
    b.rotate_y(cluster, 15.0)
    b.translate(cluster, (-100, 270, 395))
    return dict(
        lookfrom=(478.0, 278.0, -600.0),
        lookat=(278.0, 278.0, 0.0),
        vup=(0.0, 1.0, 0.0),
        vfov=40.0,
        aspect_ratio=1.0,
        aperture=0.0,
        focus_dist=10.0,
        time0=0.0,
        time1=1.0,
    )


# nested triangle sets: NESTED_PER triangles at each scale 0.5^k around the
# origin make a TRIANGLE tree about two group levels deeper per three scales
NESTED_PER = 400
NESTED_SCALES = 34  # with NESTED_SEED: depth 22, the kernel's MAX_DEPTH, in 305 groups
NESTED_SEED = 3
NESTED_TOO_DEEP = 35  # one scale more: depth 23, which both packages refuse
NESTED_EXTENT = 1000.0  # half-width of the outermost scale


def nested_triangles(builder, scales: int = NESTED_SCALES, seed: int = NESTED_SEED) -> dict:
    """Add ``NESTED_PER`` lambertian triangles (edges up to 5% of the
    scale) at each of ``scales`` nested scales, centres uniform in
    [-s, s]^3 with s = NESTED_EXTENT * 0.5^k, to ``builder`` (either
    package's).  Returns the camera kwargs of a view of the whole set; the
    background is the sky."""
    rng = np.random.default_rng(seed)
    mat = builder.lambertian((0.7, 0.6, 0.5))
    for k in range(scales):
        s = NESTED_EXTENT * 0.5**k
        c = rng.uniform(-s, s, (NESTED_PER, 3))
        e1, e2 = rng.uniform(-0.05 * s, 0.05 * s, (2, NESTED_PER, 3))
        for i in range(NESTED_PER):
            builder.triangle(c[i], c[i] + e1[i], c[i] + e2[i], mat)
    return dict(lookfrom=(0.0, 0.0, -4.0 * NESTED_EXTENT), lookat=(0.0, 0.0, 0.0), vup=(0.0, 1.0, 0.0),
                vfov=40.0, aspect_ratio=1.0)


def nested_rays(rng, n: int, scales: int = NESTED_SCALES):
    """``n`` rays of :func:`nested_triangles`' set from points of its three
    innermost scales outward, directions as long as the scale: every box
    around the origin holds them, so they walk the deepest paths of its tree
    (phase ``deep`` prints how deep the reference walk's stack gets), and
    every triangle they meet is at least as large as their own scale, so
    the hits are well conditioned in f32."""
    s = NESTED_EXTENT * 0.5 ** rng.integers(scales - 3, scales, n)
    o = rng.uniform(-1.0, 1.0, (3, n)) * s
    d = rng.normal(size=(3, n)) * s
    tm = rng.uniform(0, 1, n).astype(np.float32)
    return o.astype(np.float32), d.astype(np.float32), tm


def sphere_cluster_scene(builder, bvh8_kinds=None, *, device):
    """final_scene's 1000 spheres (radius 10, centres uniform in
    [0, 165)^3), untransformed, alone: one SPHERE tree.  With the default
    packet-tree policy it has no packet tree (the cluster walk); with
    ``bvh8_kinds=(SPHERE,)`` it has one (kernel K1)."""
    rng = np.random.default_rng(1000)
    white = builder.lambertian((0.73, 0.73, 0.73))
    for _ in range(1000):
        builder.sphere(rng.uniform(0, 165, 3), 10, white)
    return builder.finalize(bvh8_kinds=bvh8_kinds, device=device)


# ---------------------------------------------------------------------------
# K1 parity contract and inputs (shared with tests/test_torch_bvh8.py and
# tests/test_torch_kernels.py).  This part imports neither package, so kinds
# are the numbers both packages' scene/types.py define.
# ---------------------------------------------------------------------------

RTOL = 2e-5
ATOL = 2e-5
MIN_ID_MATCH = 0.99
SPHERE, MSPHERE, RECT, TRIANGLE, RING = 0, 1, 2, 3, 4


def check_parity(kind: int, ref, got) -> dict:
    """Hold ``got = (t, best, rows)`` against ``ref`` (numpy arrays, rows
    may be None): the same hit mask (best >= 0), t within rtol/atol 2e-5,
    at least 99% of winner ids equal (not for RING, whose overlapping bands
    tie exactly), and rows equal wherever the ids are equal.  Ids may
    differ only on exact-t ties across two leaves.  Returns the measured
    max |dt| and id agreement; raises AssertionError on a breach."""
    t_r, b_r, rows_r = ref
    t_g, b_g, rows_g = got
    hit_r = b_r >= 0
    hit_g = b_g >= 0
    n_diff = int((hit_r != hit_g).sum())
    assert n_diff == 0, f"kind {kind}: hit masks differ on {n_diff} rays"
    err = np.abs(t_g[hit_r].astype(np.float64) - t_r[hit_r])
    tol = ATOL + RTOL * np.abs(t_r[hit_r].astype(np.float64))
    assert (err <= tol).all(), f"kind {kind}: t differs, max |dt| {err.max()}"
    same = b_g[hit_r] == b_r[hit_r]
    id_match = float(same.mean()) if hit_r.any() else 1.0
    if kind != RING:
        assert id_match >= MIN_ID_MATCH, f"kind {kind}: only {id_match:.4f} of ids agree"
    if rows_r is not None and rows_g is not None:
        eq = hit_r.copy()
        eq[hit_r] = same
        assert np.array_equal(rows_g[:, eq], rows_r[:, eq]), f"kind {kind}: winner rows differ"
        assert not rows_g[:, ~hit_g].any(), f"kind {kind}: rows of missed rays are not zero"
    return {
        "max_abs_err": float(err.max()) if err.size else 0.0,
        "id_match": id_match,
        "hits": int(hit_r.sum()),
    }


def small_tree_scene(builder, kind: int, rng, n_prims: int = 100, **finalize_kw):
    """A generated scene of one primitive kind with an 8-ary tree (the
    shapes of the JAX package's tests/test_bvh8.py); ``finalize_kw`` go to
    the builder's ``finalize`` (the port's takes ``device``)."""
    b = builder
    mat = b.lambertian((0.5, 0.5, 0.5))
    for _ in range(n_prims):
        c = rng.uniform(-25, 25, 3)
        if kind == SPHERE:
            b.sphere(c, rng.uniform(0.5, 3.0), mat)
        elif kind == MSPHERE:
            b.moving_sphere(c, c + rng.uniform(-2, 2, 3), 0.0, 1.0, rng.uniform(0.5, 3.0), mat)
        elif kind == RECT:
            a0, b0 = c[0], c[1]
            b._rect(a0, a0 + rng.uniform(1, 8), b0, b0 + rng.uniform(1, 8),
                    c[2], int(rng.integers(0, 3)), mat)
        elif kind == TRIANGLE:
            b.triangle(c, c + rng.uniform(-4, 4, 3), c + rng.uniform(-4, 4, 3), mat)
        else:
            b.ring(rng.uniform(2, 25), rng.uniform(0.05, 0.5), mat)
    return b.finalize(bvh_threshold=16, cluster_size=32, bvh8_kinds=(kind,), **finalize_kw)


def random_rays(rng, n: int, lo: float, hi: float):
    """``n`` rays from origins uniform in [lo, hi)^3, Gaussian directions."""
    o = rng.uniform(lo, hi, (3, n)).astype(np.float32)
    d = rng.normal(size=(3, n)).astype(np.float32)
    tm = rng.uniform(0, 1, n).astype(np.float32)
    return o, d, tm


# ---------------------------------------------------------------------------
# the differentiable path: K1 (or its plain version) against the cluster
# walk under gradients (shared with tests/test_torch_grad.py and
# tests/test_torch_kernels.py).  The scenes are those of the JAX package's
# tests/test_bvh8.py and tests/test_grad_geom.py; the walk's scene is the
# same scene with ``dataclasses.replace(scene, bvh8=(None,))``.
# ---------------------------------------------------------------------------

# material gradients: a few samples' paths flip on winner ties and
# rounding between the two searches (tests/test_bvh8.py:204-208)
MAT_RTOL, MAT_ATOL = 0.1, 1e-5
# geometry gradients: isolated tie flips (tests/test_grad_geom.py:155-162)
GEOM_RTOL, GEOM_ATOL, GEOM_BIG_RTOL = 1e-3, 3e-4, 2e-2


def tri64_scene(builder, seed: int = 1234, **finalize_kw):
    """64 random triangles under a rect light, one TRIANGLE tree with a
    packet tree -> (scene, camera kwargs)."""
    rng = np.random.default_rng(seed)
    b = builder
    light = b.rect_xz(-3, 3, -3, 3, 10.0, b.diffuse_light((6.0, 6.0, 6.0)))
    b.flip_face(light)
    b.add_light(light)
    mat = b.lambertian((0.6, 0.5, 0.4))
    for _ in range(64):
        c = rng.uniform(-6, 6, 3) * np.array([1.0, 0.2, 1.0])
        b.triangle(c, c + rng.uniform(-2, 2, 3), c + rng.uniform(-2, 2, 3), mat)
    cam_kw = dict(lookfrom=(0, 8, -10), lookat=(0, 0, 0), vup=(0, 1, 0), vfov=45, aspect_ratio=1.0)
    return b.finalize(bvh_threshold=16, cluster_size=32, **finalize_kw), cam_kw


def geom_sphere_scene(builder, **finalize_kw):
    """A sphere filling the view under the sky gradient, 20 filler spheres
    inside it, a SPHERE packet tree -> (scene, camera kwargs, the target's
    column in ``params``)."""
    b = builder
    b.sphere((0.0, 0.0, 0.0), 3.0, b.lambertian((0.6, 0.5, 0.4)))
    filler = b.lambertian((0.5, 0.5, 0.5))
    for i in range(20):
        b.sphere((0.0, 0.0, 0.0), 0.05 + 0.001 * i, filler)
    scene = b.finalize(bvh_threshold=16, cluster_size=8, bvh8_kinds=(SPHERE,), **finalize_kw)
    col = int(np.argmax(np.asarray(scene.params[3].cpu()) == 3.0))
    cam_kw = dict(lookfrom=(0.0, 0.0, -4.5), lookat=(0.0, 0.0, 0.0), vup=(0, 1, 0), vfov=30, aspect_ratio=1.0)
    return scene, cam_kw, col


def geom_triangle_scene(builder, **finalize_kw):
    """One tilted triangle covering the view under the sky gradient, 20
    filler triangles behind it, a TRIANGLE packet tree -> (scene, camera
    kwargs, the target's column)."""
    b = builder
    b.triangle((-6.0, -3.0, 2.8), (5.5, -2.6, 4.2), (0.3, 7.0, 2.2), b.lambertian((0.6, 0.5, 0.4)))
    filler = b.lambertian((0.5, 0.5, 0.5))
    rng = np.random.default_rng(5)
    for _ in range(20):
        c = rng.uniform(-3, 3, 3) + np.array([0.0, 0.0, 20.0])
        b.triangle(c, c + rng.uniform(-1, 1, 3), c + rng.uniform(-1, 1, 3), filler)
    scene = b.finalize(bvh_threshold=16, cluster_size=8, bvh8_kinds=(TRIANGLE,), **finalize_kw)
    col = int(np.argmax(np.asarray(scene.params[0].cpu()) == -6.0))
    cam_kw = dict(lookfrom=(0.0, 0.0, -1.0), lookat=(0.0, 0.3, 3.0), vup=(0, 1, 0), vfov=25, aspect_ratio=1.0)
    return scene, cam_kw, col


def _regen_grad(scene, cam, size, spp_seq, n_iters, cfg, wrt: str, seed: int) -> np.ndarray:
    """d(mean radiance / spp_seq)/d(``wrt``: "color" or "params") of
    trace_regen_diff on ``size`` x ``size`` pixels x 4 lanes."""
    import dataclasses

    import torch

    from raytracer2022_tpu_torch.render.integrator import trace_regen_diff
    from raytracer2022_tpu_torch.render.renderer import _regen_gen_rays

    if wrt == "color":
        x = scene.textures.color.clone().requires_grad_()
        s = dataclasses.replace(scene, textures=dataclasses.replace(scene.textures, color=x))
    else:
        x = scene.params.clone().requires_grad_()
        s = dataclasses.replace(scene, params=x)
    n = size * size * 4
    pix0 = torch.arange(n, device=scene.device) % (size * size)
    rad, _ = trace_regen_diff(s, _regen_gen_rays(cam, size, size), pix0, spp_seq, n_iters, seed, cfg, spp_par=4)
    (g,) = torch.autograd.grad(rad.mean() / spp_seq, x)
    return g.cpu().numpy()


def material_grad(scene, cam, seed: int = 0) -> np.ndarray:
    """The texture-colour gradient of tests/test_bvh8.py's parity test:
    16x16 pixels x 4 lanes x 8 samples, 33 iterations, depth 4."""
    from raytracer2022_tpu_torch.render.integrator import TraceConfig

    return _regen_grad(scene, cam, 16, 8, 4 * 8 + 1, TraceConfig(max_depth=4, background=(0.0, 0.0, 0.0)),
                       "color", seed)


def geometry_grad(scene, cam, seed: int = 11) -> np.ndarray:
    """The params gradient of tests/test_grad_geom.py's parity test: 12x12
    pixels x 4 lanes x 8 samples, 13 iterations, depth 3, sky background."""
    from raytracer2022_tpu_torch.render.integrator import TraceConfig

    return _regen_grad(scene, cam, 12, 8, 4 * 3 + 1, TraceConfig(max_depth=3, background=None), "params", seed)


def geometry_loss(scene, cam, seed: int = 11):
    """tests/test_grad_geom.py's FD loss: the mean pixel of a 12x12 x 4 x 8
    render_batch_regen_diff, 13 iterations, depth 3, sky background, and a
    spawn offset of 5e-3 (the search sees the baked tree, the recompute the
    perturbed params, so a hit point can sit up to the step inside the
    baked surface)."""
    import torch

    from raytracer2022_tpu_torch.render.integrator import TraceConfig
    from raytracer2022_tpu_torch.render.renderer import render_batch_regen_diff

    cfg = TraceConfig(max_depth=3, background=None, spawn_eps=5e-3)
    img, cnt = render_batch_regen_diff(scene, cam, seed, 12, 12, 4, 8, 4 * 3 + 1, cfg)
    return torch.mean(img / torch.clamp(cnt, min=1)[None])


def check_geometry_parity(g_k1: np.ndarray, g_walk: np.ndarray) -> float:
    """K1's geometry gradient against the cluster walk's: all entries at
    rtol 1e-3, atol 3e-4, the dominant ones (above a tenth of the largest)
    at rtol 2e-2.  -> the max |difference|."""
    assert np.isfinite(g_k1).all() and np.abs(g_walk).max() > 1e-5
    np.testing.assert_allclose(g_k1, g_walk, rtol=GEOM_RTOL, atol=GEOM_ATOL)
    big = np.abs(g_walk) > np.abs(g_walk).max() / 10
    np.testing.assert_allclose(g_k1[big], g_walk[big], rtol=GEOM_BIG_RTOL)
    return float(np.abs(g_k1 - g_walk).max())


# ---------------------------------------------------------------------------
# the smoke run
# ---------------------------------------------------------------------------

T_MIN = 1e-3
WIDTH = HEIGHT = 600
SPP = 64
FINAL_SPP = 32
PIXEL_SPP_SEQ = 512  # bench.py's pixel-pool launch: 256x256 x 4 lanes x 512
DEPTH = 50
LANES = 1 << 18  # the main path's launch width (RenderConfig.max_rays_per_batch)


def _time_cuda(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` on the current stream, by CUDA events."""
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# K1 at the main path's shapes: time, bound, visit counts
# ---------------------------------------------------------------------------

# The least time of a K1 launch is the larger of its bytes over the card's
# memory rate and its operations over the peak rate of their type, from an
# H100 SXM's data sheet: 3.35 TB/s, and 67 TFLOP/s in f32 and 34 TFLOP/s in
# f64 outside the tensor cores.  Those peaks count a fused multiply-add as
# two operations; K1 is built with -fmad=false, so each of its operations
# is one instruction, and the bound takes half of each peak: one
# instruction per lane and cycle.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12 / 2
F64_OPS_PER_S = 34e12 / 2
BOX_OPS = 25  # f32 ops of one child's slab test: 6 sub, 6 mul, 12 min/max, 1 compare
# (f32, f64) ops of one leaf row's formula (csrc/bvh8.cu leaf_t), counting
# each add, sub, mul, div, sqrt and compare once
ROW_OPS = {SPHERE: (7, 27), MSPHERE: (20, 27), RECT: (18, 0), TRIANGLE: (144, 0), RING: (14, 0)}
S2_CALLS = (20, 21)  # main-path K1 calls whose rays make S2: bounce rays of launch 0
VISIT_SAMPLE = 2048  # rays of S1 and S2 whose visit counts are held against the reference walk


def k1_bound(tree, kind: int, n: int, groups: int, leaves: int, rows: bool) -> dict:
    """The least time of one K1 launch on ``n`` rays that visit ``groups``
    groups and ``leaves`` leaves in all: each input read once (rays 32 B,
    the tree's four arrays), each output written once (t and best 8 B, the
    winner row 96 B when asked for); 8 child slab tests per group and 16
    rows per leaf."""
    tree_bytes = sum(x.numel() * x.element_size() for x in (tree.entries, tree.axorder, tree.boxes, tree.prows))
    nbytes = n * 32 + n * 8 + (n * 96 if rows else 0) + tree_bytes
    f32 = BOX_OPS * 8 * groups + ROW_OPS[kind][0] * 16 * leaves
    f64 = ROW_OPS[kind][1] * 16 * leaves
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = f32 / F32_OPS_PER_S + f64 / F64_OPS_PER_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3, "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "f32_ops": f32, "f64_ops": f64}


def _device_ms(fn, reps: int, match: str = "bvh8") -> float:
    """Mean device milliseconds per ``fn()`` of the CUDA kernels whose name
    holds ``match``, under torch.profiler (the kernel's own time, not the
    host's enqueue pace)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    # each matching kernel runs once per call: its mean over the events the
    # profiler kept
    means = [e.self_device_time_total / e.count for e in prof.key_averages()
             if match in e.key and str(e.device_type).endswith("CUDA") and e.count > 0]
    assert means, "the profiler saw no K1 kernel on the device"
    return sum(means) / 1e3


@contextlib.contextmanager
def k1_tree_memory(mode: str):
    """Within the block, K1 runs its ``global`` instantiation (group arrays
    in global memory) even where the tree fits in shared memory; with
    ``shared`` the wrapper chooses, as on the main path."""
    from raytracer2022_tpu_torch.ops import bvh8

    keep = bvh8._tree_in_shared
    if mode == "global":
        bvh8._tree_in_shared = lambda lib, ng, depth: False
    try:
        yield
    finally:
        bvh8._tree_in_shared = keep


def check_visits(label: str, tree, kind: int, o, d, tm, t_init, visits, rng) -> None:
    """The kernel's per-ray visit counts equal the reference walk's on
    ``VISIT_SAMPLE`` rays drawn from ``rng``."""
    import torch

    from raytracer2022_tpu_torch.ops.bvh8 import FAR, walk_bvh8_reference

    idx = torch.as_tensor(np.sort(rng.choice(o.shape[1], VISIT_SAMPLE, replace=False)), device=o.device)
    ti = torch.clamp(t_init, max=FAR)[idx]
    _, _, groups, leaves, deepest = walk_bvh8_reference(
        tree, kind, *(x[..., idx].cpu().numpy() for x in (o, d, tm)), T_MIN, ti.cpu().numpy())
    got = visits[:, idx].cpu().numpy()
    assert np.array_equal(got[0], groups) and np.array_equal(got[1], leaves), \
        f"{label}: K1's visit counts differ from the reference walk's"
    print(f"K1 visits {label}: {VISIT_SAMPLE} sampled rays equal the reference walk's (groups mean "
          f"{groups.mean():.3f} max {groups.max()}, leaves mean {leaves.mean():.3f} max {leaves.max()}, "
          f"deepest stack {deepest.max()})", flush=True)


def raw_k1(lib, tree, kind: int, o, d, tm, t_init, rows: bool, tree_in_shared=None):
    """A closure that launches K1 (``lib``, the ctypes library of
    ``csrc/bvh8.cu``) on outputs allocated once, with nothing around the
    ctypes call but zeroing the ray counter: timed by CUDA events it gives
    the kernel's own time, where the wrapper's Python would set the pace."""
    import torch

    from raytracer2022_tpu_torch.ops import bvh8

    n = o.shape[1]
    dev = o.device
    ti = torch.clamp(t_init, max=bvh8.FAR).contiguous()
    t = torch.empty_like(tm)
    best = torch.empty((n,), dtype=torch.int32, device=dev)
    out_rows = torch.empty((bvh8.NCOL, n), dtype=torch.float32, device=dev) if rows else None
    win = torch.empty((n,), dtype=torch.int32, device=dev) if rows else None
    counter = torch.zeros((1,), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    tree_ptrs = [x.data_ptr() for x in (tree.entries, tree.axorder, tree.boxes, tree.prows)]
    ray_ptrs = [x.data_ptr() for x in (o, d, tm, ti)]
    rows_ptr = None if out_rows is None else out_rows.data_ptr()
    ng = tree.entries.shape[0] // bvh8.FANOUT
    shared = bvh8._tree_in_shared(lib, ng, tree.depth) if tree_in_shared is None else tree_in_shared
    args = (kind, int(shared), T_MIN, n, ng, tree.depth, *tree_ptrs, *ray_ptrs, t.data_ptr(), best.data_ptr(),
            None if win is None else win.data_ptr(), rows_ptr, None, counter.data_ptr(), stream)

    def run():
        counter.zero_()
        assert lib.rt_bvh8_traverse(*args) == 0, "K1 launch failed"

    run.buffers = (ti, t, best, out_rows, win, counter)  # alive while the kernel writes them
    return run


def run_both(tree, kind: int, o, d, tm, t_init):
    """K1 and its plain version on the same rays -> (plain, kernel), each
    (t, best, rows) as numpy."""
    import torch

    from raytracer2022_tpu_torch.ops.bvh8 import FAR, traverse_bvh8, traverse_bvh8_plain

    got = traverse_bvh8(tree, kind, o, d, tm, T_MIN, t_init=t_init, return_rows=True)
    ti = torch.full_like(tm, FAR) if t_init is None else torch.clamp(t_init, max=FAR)
    ref = traverse_bvh8_plain(tree, kind, o, d, tm, T_MIN, ti)
    torch.cuda.synchronize()
    return [x.cpu().numpy() for x in ref], [x.cpu().numpy() for x in got]


def shared_fits_groups(lib, depth: int) -> int:
    """The most groups a tree of ``depth`` levels may have and still take
    K1's shared-memory instantiation on the current device:
    ``rt_bvh8_shared_fits`` of ``lib``, bisected (the stack, ``depth``
    words a thread, and the group arrays share the opt-in limit)."""

    def fits(ng: int) -> bool:
        r = lib.rt_bvh8_shared_fits(ng, depth)
        assert r >= 0, f"rt_bvh8_shared_fits failed: cudaError {-r}"
        return r == 1

    lo, hi = 0, 1
    while fits(hi):
        lo, hi = hi, 2 * hi
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if fits(mid) else (lo, mid)
    return lo


def k1_at_shape(label: str, tree, kind: int, o, d, tm, t_init, rows: bool, smi: str) -> dict:
    """K1 on one shape: its visit counts over every ray, the bound they
    give, and, in each instantiation the tree can take, its time: by CUDA
    events over direct launches (``ms``), by the profiler's device time,
    and by CUDA events over calls of the wrapper as the main path makes
    them (``wrapper_ms``, which the host's pace may set)."""
    import torch

    from raytracer2022_tpu_torch.ops import bvh8
    from raytracer2022_tpu_torch.ops.bvh8 import traverse_bvh8

    n = o.shape[1]
    out = {"rays": n, "depth": tree.depth, "shared_fits_groups": shared_fits_groups(bvh8._kernel_lib(), tree.depth)}
    for mode in ("shared", "global"):
        with k1_tree_memory(mode):
            visits = traverse_bvh8(tree, kind, o, d, tm, T_MIN, t_init=t_init, return_visits=True)[-1]
            if bvh8.TREE_MEMORY != mode:
                continue  # the tree does not fit in shared memory

            def run():
                traverse_bvh8(tree, kind, o, d, tm, T_MIN, t_init=t_init, return_rows=rows)

            raw = raw_k1(bvh8._kernel_lib(), tree, kind, o, d, tm, t_init, rows, mode == "shared")
            out[mode] = {"ms": _time_cuda(raw, 50), "device_ms": _device_ms(run, 20),
                         "wrapper_ms": _time_cuda(run, 20)}
    groups, leaves = (int(x) for x in visits.sum(dim=1, dtype=torch.int64).cpu())
    out.update(k1_bound(tree, kind, n, groups, leaves, rows))
    out.update(groups_per_ray=groups / n, leaves_per_ray=leaves / n,
               leaves_max=int(visits[1].max()), groups_max=int(visits[0].max()))
    best = out.get("shared", out["global"])
    out["ms"] = best["ms"]
    out["share_of_bound"] = out["bound_ms"] / out["ms"]
    times = ", ".join(f"{m} {out[m]['ms']:.4f} ms (profiler {out[m]['device_ms']:.4f}, through the wrapper "
                      f"{out[m]['wrapper_ms']:.4f})" for m in ("shared", "global") if m in out)
    print(f"K1 {label}: {n} rays, {groups / n:.3f} groups and {leaves / n:.3f} leaves per ray; {times}; bound "
          f"{out['bound_ms'] * 1e3:.2f} us by {out['bound_by']} ({out['bytes'] / 1e6:.2f} MB, "
          f"{out['f32_ops'] / 1e9:.3f} GFLOP f32, {out['f64_ops'] / 1e9:.3f} f64), {100 * out['share_of_bound']:.1f}% "
          f"of it ({smi})", flush=True)
    return out


def sphere_tree_rays(dev):
    """S3: final_scene's 1000 spheres with a packet tree and 262,144
    bounce-like rays (origins spread through the cluster's box)."""
    import torch

    from raytracer2022_tpu_torch.scene.builder import SceneBuilder

    scene = sphere_cluster_scene(SceneBuilder(), bvh8_kinds=(SPHERE,), device=dev)
    rng = np.random.default_rng(77)
    o, d, tm = (torch.as_tensor(x, device=dev) for x in random_rays(rng, LANES, -10.0, 175.0))
    return scene, o, d, tm


def mesh_rays(mesh, cam, rng):
    """262,144 camera rays of the stand-in mesh (a jittered 512 x 512 grid;
    with their t_init, S1) followed by 65,536 random rays inside the box,
    and as t_init the dense windows' closest t, as closest_hit passes it."""
    import torch

    from raytracer2022_tpu_torch.ops.intersect import candidate_t
    from raytracer2022_tpu_torch.render.camera import get_rays

    dev = mesh.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    side = 512  # 512 x 512 = 262,144 camera rays
    ys, xs = torch.meshgrid(torch.arange(side, device=dev), torch.arange(side, device=dev), indexing="ij")
    u = (xs.reshape(-1).float() + torch.rand(side * side, generator=gen, device=dev)) / (side - 1)
    v = (ys.reshape(-1).float() + torch.rand(side * side, generator=gen, device=dev)) / (side - 1)
    o_c, d_c, tm_c = get_rays(cam, u, v, gen)
    o_r, d_r, tm_r = (torch.as_tensor(x, device=dev) for x in random_rays(rng, 65536, 1.0, 554.0))
    o = torch.cat([o_c, o_r], 1)
    d = torch.cat([d_c, d_r], 1)
    tm = torch.cat([tm_c, tm_r])
    t_dense = candidate_t(mesh, o, d, tm, T_MIN, float("inf"),
                          prim_slice=slice(mesh.stats.n_in_bvh, mesh.n_prims)).amin(dim=0)
    return o, d, tm, t_dense


def capture_k1(launch, calls) -> list:
    """Run ``launch()`` -> [([o, d, tm, t_init], (t, prim, row)) of K1
    calls ``calls`` (counted from 0)]: each kept call's inputs, cloned
    before the call, and its outputs."""
    from raytracer2022_tpu_torch.ops import bvh8

    traverse = bvh8.traverse_bvh8
    kept = []
    seen = [-1]

    def capturing(*a, **kw):
        seen[0] += 1
        inputs = [x.clone() for x in (*a[2:5], kw["t_init"])] if seen[0] in calls else None
        out = traverse(*a, **kw)
        if inputs is not None:
            kept.append((inputs, out))
        return out

    bvh8.traverse_bvh8 = capturing
    try:
        launch()
    finally:
        bvh8.traverse_bvh8 = traverse
    return kept


def render_capturing(scene, cam, cfg, calls, launch_log=None):
    """``render_sum_n`` with the inputs of K1 calls ``calls`` (counted from
    0) kept -> (total, n, [[o, d, tm, t_init] of each kept call])."""
    from raytracer2022_tpu_torch.render.renderer import render_sum_n

    result = []
    kept = capture_k1(lambda: result.append(render_sum_n(scene, cam, cfg, launch_log=launch_log)), calls)
    (total, n), = result
    return total, n, [inputs for inputs, _ in kept]


def s2_rays(captured):
    """S2: the first LANES rays of the kept calls, with their t_init."""
    import torch

    return [torch.cat(x, dim=-1)[..., :LANES].contiguous() for x in zip(*captured)]


def print_ptxas(log: str) -> None:
    """One line per kernel of an nvcc -Xptxas -v log: registers, stack
    frame, spills and shared memory."""
    import re

    name = "?"
    props = ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"(bvh8_\w+?)(?:ILi(\d)E(Lb(\d))?)?E", line)
            name = m.group(1) if m else line.split("'")[1]
            if m and m.group(2):
                name += f"<kind {m.group(2)}" + (f", shared {m.group(4)}>" if m.group(4) else ">")
        elif "stack frame" in line:
            props = line.strip()
        elif "Used" in line and "registers" in line:
            print(f"  ptxas {name}: {line.split(':', 1)[1].strip()}; {props}", flush=True)


# ---------------------------------------------------------------------------
# phases of this slice: final_scene, the library, schedules, sort, trace,
# and the packet-tree policy
# ---------------------------------------------------------------------------

FILE_FREE = ["random_scene", "two_spheres", "two_perlin_spheres", "simple_light", "cornell_smoke",
             "cornell_box_book"]
SMALL = 64  # library renders through the CLI: 64x64 x 8 spp
SMALL_SPP = 8
MAX_REL = 0.08  # card-vs-CPU and render-vs-render channel means (Monte-Carlo noise)
CPU_SEEDS = 8  # card-vs-CPU checks: CPU renders, one per seed, give the CPU mean ...
REPLICATES = 32  # ... and with this many card renders at the CPU's samples (one launch) the seed-to-seed spread
CARD_FACTOR = 16  # ... and the card renders once at this many times the samples
MAX_Z = 5.0  # card-vs-CPU bound, in standard errors of the difference of means
MAX_VAR_RATIO = 12.0  # the replicates' variance counts at most this many times the CPU renders' (F's 0.999
# quantile at 31 and 63 over 7 degrees of freedom is 12.5 and 12.1): a card that scatters more cannot widen its bound
REPLICATE_SEED = 1000  # the replicates' stream, apart from the card's and the CPU's render seeds
EMIT = (1.5, 2.0, 2.5)


def _means(total, n) -> np.ndarray:
    return (total / n).mean(dim=(-2, -1)).cpu().numpy().astype(np.float64)


def _rel(a, b) -> np.ndarray:
    return np.abs(a - b) / np.maximum(np.abs(b), 1e-6)


def _seed_means(scene, cam, cfg, seeds, spp: int) -> tuple:
    """One render of ``cfg`` at ``spp`` samples for each seed: its channel
    means as f64[len(seeds), 3], and the sample count of each render."""
    import dataclasses

    from raytracer2022_tpu_torch.render.renderer import render_sum_n

    means = []
    for seed in seeds:
        total, n = render_sum_n(scene, cam, dataclasses.replace(cfg, spp=spp, seed=seed))
        means.append(_means(total, n))
    return np.array(means), n


def _skew(m) -> np.ndarray:
    """The skewness of each column of ``m`` (population moments)."""
    return ((m - m.mean(axis=0)) ** 3).mean(axis=0) / m.std(axis=0) ** 3


def pooled_check(cpu_means, rep_means, card_means, n_cpu: int, n_card: int) -> dict:
    """The card-vs-CPU statistic of :func:`card_vs_cpu`, on numpy arrays.

    ``cpu_means`` f64[C, 3] are the channel means of C CPU renders at
    ``n_cpu`` samples, ``rep_means`` f64[K, 3] those of K card renders at the
    same samples, ``card_means`` f64[..., 3] those of card renders at
    ``n_card`` samples.  The variance of one render at ``n_cpu`` samples is
    pooled from both sets, each taken about its own mean: ``var = ((C - 1)
    var_cpu + (K - 1) min(var_rep, MAX_VAR_RATIO var_cpu)) / (C - 1 + K -
    1)``, which is the CPU renders' own for K = 0 (or 1); the cap keeps a
    card whose renders scatter more from widening its own bound past
    ``MAX_VAR_RATIO``.  ``z = (card_means - mean_cpu) / se`` with ``se =
    sqrt(var * (1/C + n_cpu/n_card))``; ``rep_z`` is the replicates' mean
    (K renders at ``n_cpu`` samples) against ``mean_cpu`` in standard errors
    ``sqrt(var * (1/C + 1/K))`` (nan for K = 0).  Returns ``z``, ``rep_z``,
    ``sd`` (pooled), ``cpu_sd`` (the CPU renders' alone), ``var_ratio``
    (``var_rep / var_cpu`` before the cap; nan below K = 2), ``se``,
    ``cpu_mean``, ``min_rel_bias`` (``MAX_Z * se / mean_cpu``: the smallest
    relative bias the check detects), ``skew`` (of the replicates' means;
    nan below 3) and ``replicates`` (K)."""
    cpu_means = np.asarray(cpu_means, np.float64)
    rep_means = np.asarray(rep_means, np.float64).reshape(-1, cpu_means.shape[1])
    c, k = len(cpu_means), len(rep_means)
    nan = np.full(cpu_means.shape[1], np.nan)
    m_cpu = cpu_means.mean(axis=0)
    var_cpu = cpu_means.var(axis=0, ddof=1)
    ss, dof, var_ratio = (c - 1) * var_cpu, c - 1, nan
    if k > 1:
        var_rep = rep_means.var(axis=0, ddof=1)
        var_ratio = var_rep / np.maximum(var_cpu, 1e-300)
        ss, dof = ss + (k - 1) * np.minimum(var_rep, MAX_VAR_RATIO * var_cpu), dof + k - 1
    sd = np.sqrt(ss / dof)
    se = sd * np.sqrt(1.0 / c + n_cpu / n_card)
    rep_z = (rep_means.mean(axis=0) - m_cpu) / np.maximum(sd * np.sqrt(1.0 / c + 1.0 / k), 1e-12) if k else nan
    return {"z": (np.asarray(card_means, np.float64) - m_cpu) / np.maximum(se, 1e-12), "rep_z": rep_z, "sd": sd,
            "cpu_sd": np.sqrt(var_cpu), "var_ratio": var_ratio, "se": se, "cpu_mean": m_cpu,
            "min_rel_bias": MAX_Z * se / np.maximum(np.abs(m_cpu), 1e-6),
            "skew": _skew(rep_means) if k > 2 else nan, "replicates": k}


def replicate_means(scene, cam, cfg, k: int, seed: int = REPLICATE_SEED) -> np.ndarray:
    """``k`` independent renders of ``cfg`` at ``cfg.spp`` samples from one
    launch -> their channel means, f64[k, 3].  The launch is
    ``trace_regen`` under ``Schedule.QUOTA`` with ``k`` lanes a pixel of
    ``cfg.spp`` samples each, where every lane runs exactly its own
    ``cfg.spp`` samples of pixel ``l % n_pix``; so lanes ``r * n_pix`` to
    ``(r + 1) * n_pix - 1`` are render ``r``.  Fails unless the launch ended
    before the schedule's safety bound (a lane cut off there would have
    fewer samples)."""
    import torch

    from raytracer2022_tpu_torch.render.integrator import Schedule, step_generator, trace_regen
    from raytracer2022_tpu_torch.render.renderer import _regen_gen_rays

    w, h = cfg.width, cfg.height
    pix0 = torch.arange(k * w * h, device=scene.device) % (w * h)
    with torch.no_grad():
        rad, iters = trace_regen(scene, _regen_gen_rays(cam, w, h), pix0, cfg.spp,
                                 step_generator(seed, 0, scene.device), cfg.trace_cfg(), spp_par=k,
                                 schedule=Schedule.QUOTA, return_iters=True)
    bound = (cfg.spp + 1) * cfg.max_depth + 2  # integrator._trace_lanes' max_iter
    assert sum(iters.values()) < bound, f"replicates: the quota launch reached its bound {bound} ({iters})"
    return _means(rad.reshape(3, k, h, w), cfg.spp).T


def card_vs_cpu(dev, label: str, build, cfg, card_seeds=(0,), replicates: int = REPLICATES) -> list:
    """Hold the card's channel means against the CPU's (plain versions) on
    one scene: ``CPU_SEEDS`` CPU renders at ``cfg`` give a mean; their
    seed-to-seed variance, pooled with that of ``replicates`` card renders
    at ``cfg.spp`` drawn in one launch (:func:`replicate_means`), gives the
    spread (:func:`pooled_check`); the card renders once for each of
    ``card_seeds`` at about ``CARD_FACTOR`` times the samples.  Fails unless
    every channel of every card render, and the replicates' mean, agrees
    within ``MAX_Z`` standard errors of the difference, and each card render
    within ``MAX_REL``.  ``build(device)`` returns ``(scene, camera)``.
    Returns each card render's z."""
    scene, cam = build(dev)
    m_cards, n_card = _seed_means(scene, cam, cfg, card_seeds, cfg.spp * CARD_FACTOR)
    reps = replicate_means(scene, cam, cfg, replicates)
    runs, n_cpu = _seed_means(*build("cpu"), cfg, range(100, 100 + CPU_SEEDS), cfg.spp)
    st = pooled_check(runs, reps, m_cards, n_cpu, n_card)
    m_cpu = st["cpu_mean"]
    print(f"{label} {cfg.width}x{cfg.height}: {st['replicates']} card replicates x {n_cpu} spp from one launch, "
          f"their mean vs the CPU's z {st['rep_z'].round(2).tolist()}, their variance over the CPU seeds' "
          f"{st['var_ratio'].round(2).tolist()} (counted at most {MAX_VAR_RATIO})", flush=True)
    assert (np.abs(st["rep_z"]) < MAX_Z).all(), f"{label}: the card's replicates and the CPU disagree"
    zs = []
    for seed, m_card, z in zip(card_seeds, m_cards, st["z"]):
        rel = _rel(m_card, m_cpu)
        seed_note = f" seed {seed}" if len(card_seeds) > 1 else ""
        print(f"{label} {cfg.width}x{cfg.height}: card{seed_note} x {n_card} spp vs CPU {CPU_SEEDS} seeds x {n_cpu} "
              f"spp, channel means {m_card.round(4).tolist()} vs {m_cpu.round(4).tolist()} (rel "
              f"{rel.round(4).tolist()}, z {z.round(2).tolist()}; seed-to-seed sd rel "
              f"{(st['sd'] / m_cpu).round(4).tolist()} pooled over the CPU seeds and {st['replicates']} card "
              f"replicates x {n_cpu} spp (CPU seeds alone {(st['cpu_sd'] / m_cpu).round(4).tolist()}), replicates' "
              f"skewness {st['skew'].round(2).tolist()}, "
              f"smallest relative bias detected {st['min_rel_bias'].round(4).tolist()}; bounds |z| < {MAX_Z}, "
              f"rel < {MAX_REL})", flush=True)
        assert np.isfinite(m_card).all(), f"{label}: non-finite card render"
        assert (np.abs(z) < MAX_Z).all() and (rel < MAX_REL).all(), f"{label}: card and CPU disagree"
        zs.append(z.tolist())
    return zs


def phase_final_scene(dev, smi) -> dict:
    """The stand-in final_scene through render_sum_n at 600x600 (the
    slice's full-width path), after a small card-vs-CPU check."""
    import time

    import torch

    from raytracer2022_tpu_torch.ops import bvh8
    from raytracer2022_tpu_torch.render.camera import make_camera
    from raytracer2022_tpu_torch.render.renderer import RenderConfig, render_sum_n
    from raytracer2022_tpu_torch.scene.builder import SceneBuilder

    earth = earth_stand_in()

    def build(device):
        b = SceneBuilder()
        cam_kw = final_scene_stand_in(b, earth)
        return b.finalize(device=device), make_camera(**cam_kw, device=device)

    scene, cam = build(dev)
    print(f"final_scene stand-in: {scene.n_prims} prims, trees {scene.stats.trees} "
          f"(packet trees {[t is not None for t in scene.bvh8]}), media {len(scene.stats.mediums)}, "
          f"textures {sorted(scene.stats.features)}, earth image {earth.shape[1]}x{earth.shape[0]}", flush=True)

    card_vs_cpu(dev, "final_scene", build,
                RenderConfig(width=32, height=32, spp=16, max_depth=DEPTH, background=(0.0, 0.0, 0.0)))

    # the main path of this slice, its kernel counts read just around it
    cfg = RenderConfig(width=WIDTH, height=HEIGHT, spp=FINAL_SPP, max_depth=DEPTH, background=(0.0, 0.0, 0.0))
    log: list = []
    torch.cuda.synchronize()
    bvh8.LAUNCHES = 0
    t0 = time.perf_counter()
    total, n = render_sum_n(scene, cam, cfg, launch_log=log)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    k1 = bvh8.LAUNCHES
    img = (total / n).cpu().numpy()
    assert img.shape == (3, HEIGHT, WIDTH) and np.isfinite(img).all(), "final_scene: non-finite pixels"
    assert img.mean() > 1e-3, "final_scene render is black"
    mpaths = WIDTH * HEIGHT * n / dt / 1e6
    print(f"final_scene render {WIDTH}x{HEIGHT} x {n} spp, depth {DEPTH}: {dt:.2f} s, {mpaths:.3f} Mpaths/s, "
          f"K1 launches {k1} (no TRIANGLE tree: the cluster walk), channel means "
          f"{np.round(img.mean(axis=(1, 2)), 4).tolist()} ({smi})", flush=True)
    for i, rec in enumerate(log):
        print(f"  launch {i}: {rec}")
    return {"mpaths": mpaths, "seconds": dt, "spp": n, "k1": k1, "log": log, "scene": scene, "cam": cam}


def phase_library(dev, smi) -> dict:
    """Every library scene that needs no file through cli.main, and the
    card-vs-CPU channel means of cornell_smoke and two_perlin_spheres."""
    import os
    import tempfile
    import time

    from raytracer2022_tpu_torch import cli
    from raytracer2022_tpu_torch.utils.imageio import read_png

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in FILE_FREE:
            path = os.path.join(tmp, f"{name}.png")
            t0 = time.perf_counter()
            rc = cli.main(["--scene", name, "--width", str(SMALL), "--height", str(SMALL),
                           "--spp", str(SMALL_SPP), "--out", path, "--quiet"])
            dt = time.perf_counter() - t0
            assert rc == 0, f"cli {name} returned {rc}"
            png = read_png(path)
            assert png.shape == (SMALL, SMALL, 3) and png.mean() > 1.0, f"cli {name}: bad image"
            out[name] = dt
            print(f"cli {name} {SMALL}x{SMALL} x {SMALL_SPP} spp: {dt:.2f} s wall, png mean "
                  f"{png.mean():.2f}", flush=True)
    for name in ("cornell_smoke", "two_perlin_spheres"):
        card_vs_cpu(dev, name, *library_check(name))
    return out


def library_check(name: str) -> tuple:
    """``(build, cfg)`` of phase ``library``'s card-vs-CPU check of the
    library scene ``name``: ``build(device) -> (scene, camera)``, and
    ``SMALL`` x ``SMALL`` x ``SMALL_SPP``, depth ``DEPTH``, under the scene's
    own background."""
    from raytracer2022_tpu_torch.render.camera import make_camera
    from raytracer2022_tpu_torch.render.renderer import RenderConfig
    from raytracer2022_tpu_torch.scene.library import SCENES

    def build(device):
        bundle = SCENES[name](device=device)
        return bundle.scene, make_camera(**bundle.camera_kwargs, device=device)

    background = SCENES[name](device="cpu").background
    return build, RenderConfig(width=SMALL, height=SMALL, spp=SMALL_SPP, max_depth=DEPTH, background=background)


# phase assets: the JAX CLI's default invocation, wwscene from the stand-in files
WW_WIDTH, WW_HEIGHT, WW_SPP = 640, 360, 100
WW_ARGV = ("--scene", "wwscene", "--width", str(WW_WIDTH), "--height", str(WW_HEIGHT), "--spp", str(WW_SPP),
           "--max-depth", str(DEPTH))  # the JAX CLI's default invocation, less its --out
WW_CHECK = (64, 36, 24)  # card-vs-CPU check of wwscene: width, height, spp (at 8 spp it detected 8.4-9.1% only) ...
WW_CHECK_CARD_SEEDS = (0, 1)  # ... with two card renders, each held to the bound
WW_CHECK_REPLICATES = 64  # ... and this many card replicates: its 8-spp means are heavy-tailed (PERF.md §6)
WW_CHECK_SHUTTLE = (24, 12)  # ... with a 576-triangle Shuttle, which the CPU's plain version walks by brute force
FROM_FILES_SMALL = ("earth", "obj_uv_demo", "final_scene")  # rendered from the files at SMALL x SMALL


def ww_check_build(source_dir: str):
    """``build(device) -> (scene, camera)`` of the wwscene card-vs-CPU
    check: ``wwscene`` from the files in ``source_dir``, its camera at the
    aspect of ``WW_CHECK``."""
    from raytracer2022_tpu_torch.render.camera import make_camera
    from raytracer2022_tpu_torch.scene.library import SCENES

    def build(device):
        b = SCENES["wwscene"](source_dir=source_dir, device=device)
        return b.scene, make_camera(**dict(b.camera_kwargs, aspect_ratio=WW_CHECK[0] / WW_CHECK[1]), device=device)

    return build


def card_cpu_study(label: str, build, cfg, card_seeds, cpu_seeds, replicates: int, first: int = CPU_SEEDS,
                   factor: int = CARD_FACTOR, device: str = "cuda") -> dict:
    """Draw or bias: a card-vs-CPU check (:func:`card_vs_cpu`) with more
    seeds on both sides.  ``build(device) -> (scene, camera)`` and ``cfg``
    are the check's own; the ``device`` renders each of ``card_seeds`` at
    ``factor`` times the samples, the CPU each of ``cpu_seeds``.  Prints and
    returns, per channel: ``pooled_z``, the pooled ``device`` mean against the pooled
    CPU mean in standard errors from each side's own seed-to-seed variance;
    ``single_z``, each ``device`` render against the CPU mean from the
    CPU's variance only (the check's statistic without replicates);
    ``single_z_first``, the same against the mean of the first ``first``
    CPU seeds (the check's own CPU side when those are seeds 100-107);
    ``pooled_sd_z``, each ``device`` render against that mean as the check
    computes it (:func:`pooled_check`: the variance pooled from those
    ``first`` CPU renders and ``replicates`` ``device`` renders at
    the CPU's samples from one launch), ``pooled_sd`` its sd, ``var_ratio``,
    ``rep_z`` and ``min_rel_bias`` its replicates' variance ratio, their
    mean's z and the smallest relative bias it detects; ``first_z``,
    that mean against the whole CPU mean; ``device_sd`` and ``cpu_sd``, each side's
    seed-to-seed sd, ``device_skew`` and ``cpu_skew`` the skewness of its
    renders' channel means (``device_means``, ``cpu_means``), and
    ``first_sd_ratio`` the first ``first`` CPU seeds' sd over ``cpu_sd``
    (below 1 when rare bright paths are missing from them); ``sd_ratio``,
    the ``device``'s seed-to-seed sd over the CPU's scaled to its samples
    (about 1 when both are the same estimator and the seeds sample its
    tail).  ``verdict`` is ``"draw"`` when every |pooled_z| < 3, else
    ``"bias"``.  The last line printed is ``{"<label>_study": result}``."""
    import json
    import time

    import torch

    from raytracer2022_tpu_torch.tools import device_line

    card_seeds, cpu_seeds = list(card_seeds), list(cpu_seeds)
    dev = torch.device(device)
    line = device_line(dev)
    print(line, flush=True)
    n = cfg.spp
    t0 = time.perf_counter()
    scene, cam = build(dev)
    m_dev, n_dev = _seed_means(scene, cam, cfg, card_seeds, n * factor)
    reps = replicate_means(scene, cam, cfg, replicates)
    dev_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    m_cpu, n_cpu = _seed_means(*build("cpu"), cfg, cpu_seeds, n)
    cpu_s = time.perf_counter() - t0
    mean_dev, var_dev = m_dev.mean(axis=0), m_dev.var(axis=0, ddof=1)
    mean_cpu, var_cpu = m_cpu.mean(axis=0), m_cpu.var(axis=0, ddof=1)
    sd_cpu = np.sqrt(var_cpu)
    k, c = len(card_seeds), len(cpu_seeds)
    pooled_z = (mean_dev - mean_cpu) / np.sqrt(var_dev / k + var_cpu / c)
    single_z = (m_dev - mean_cpu) / (sd_cpu * np.sqrt(1.0 / c + n_cpu / n_dev))
    mean_first, sd_first = m_cpu[:first].mean(axis=0), m_cpu[:first].std(axis=0, ddof=1)
    single_z_first = (m_dev - mean_first) / (sd_first * np.sqrt(1.0 / first + n_cpu / n_dev))
    first_z = (mean_first - mean_cpu) / (sd_cpu * np.sqrt(1.0 / first - 1.0 / c))
    pooled = pooled_check(m_cpu[:first], reps, m_dev, n_cpu, n_dev)

    result = {
        "setup": f"{label} {cfg.width}x{cfg.height}, depth {cfg.max_depth}",
        "device": line, "device_seeds": card_seeds, "device_spp": n_dev, "cpu_seeds": cpu_seeds, "cpu_spp": n_cpu,
        "device_mean": mean_dev.tolist(), "cpu_mean": mean_cpu.tolist(), "cpu_first_mean": mean_first.tolist(),
        "pooled_z": pooled_z.tolist(), "single_z": single_z.tolist(), "single_z_first": single_z_first.tolist(),
        "pooled_sd_z": pooled["z"].tolist(), "pooled_sd": pooled["sd"].tolist(), "replicates": replicates,
        "var_ratio": pooled["var_ratio"].tolist(), "rep_z": pooled["rep_z"].tolist(),
        "min_rel_bias": pooled["min_rel_bias"].tolist(),
        "first_z": first_z.tolist(), "device_sd": np.sqrt(var_dev).tolist(), "cpu_sd": sd_cpu.tolist(),
        "device_skew": _skew(m_dev).tolist(), "cpu_skew": _skew(m_cpu).tolist(),
        "first_sd_ratio": (sd_first / sd_cpu).tolist(),
        "sd_ratio": (np.sqrt(var_dev) / (sd_cpu * np.sqrt(n_cpu / n_dev))).tolist(),
        "verdict": "draw" if (np.abs(pooled_z) < 3.0).all() else "bias",
        "device_s": dev_s, "cpu_s": cpu_s, "device_means": m_dev.tolist(), "cpu_means": m_cpu.tolist(),
    }
    print(json.dumps({f"{label}_study": result}), flush=True)
    return result


def wwscene_study(card_seeds=range(16), cpu_seeds=range(100, 116), first: int = CPU_SEEDS,
                  factor: int = CARD_FACTOR, device: str = "cuda") -> dict:
    """:func:`card_cpu_study` of wwscene's check (phase ``assets``): its
    ``WW_CHECK``, depth ``DEPTH``, the stand-in assets with a
    ``WW_CHECK_SHUTTLE`` Shuttle and ``WW_CHECK_REPLICATES`` replicates.  Not
    called by :func:`main`: run it alone with
    ``python3 -c "import chip_smoke; chip_smoke.wwscene_study(range(16), range(100, 116))"``."""
    import tempfile

    from raytracer2022_tpu_torch.render.renderer import RenderConfig

    w, h, n = WW_CHECK
    cfg = RenderConfig(width=w, height=h, spp=n, max_depth=DEPTH, background=(0.0, 0.0, 0.0))
    with tempfile.TemporaryDirectory() as tmp:
        write_stand_in_assets(tmp, shuttle=WW_CHECK_SHUTTLE)
        return card_cpu_study("wwscene", ww_check_build(tmp), cfg, card_seeds, cpu_seeds, WW_CHECK_REPLICATES,
                              first, factor, device)


def library_study(name: str, card_seeds=range(64), cpu_seeds=range(100, 164), device: str = "cuda") -> dict:
    """:func:`card_cpu_study` of phase ``library``'s check of ``name``
    (``cornell_smoke`` or ``two_perlin_spheres``: :func:`library_check`, with
    ``REPLICATES`` replicates).  Not called by :func:`main`: run it alone with
    ``python3 -c "import chip_smoke; chip_smoke.library_study('two_perlin_spheres')"``."""
    return card_cpu_study(name, *library_check(name), card_seeds, cpu_seeds, REPLICATES, device=device)


def _cli_capture(argv) -> tuple:
    """Run cli.main, echo its output, return (seconds, its Mpaths/s)."""
    import io
    import re
    import time

    from raytracer2022_tpu_torch import cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    dt = time.perf_counter() - t0
    print(buf.getvalue(), end="", flush=True)
    assert rc == 0, f"cli {argv} returned {rc}"
    rate = re.findall(r"([0-9.]+) Mpaths/s", buf.getvalue())
    assert rate, "the CLI printed no rate"
    return dt, float(rate[-1])


def phase_assets(dev, smi) -> dict:
    """The JAX CLI's default scene from asset files: the stand-in files
    written by the port's JPEG encoder and read back by its decoder, then
    ``wwscene`` at 640x360 x 100 spp, depth 50, through ``cli.main`` into a
    JPEG (K1 on the OBJ mesh's TRIANGLE tree), its card-vs-CPU check, and
    ``earth``, ``obj_uv_demo`` and ``final_scene`` from the files."""
    import os
    import tempfile
    import time

    from raytracer2022_tpu_torch import cli
    from raytracer2022_tpu_torch.ops import bvh8
    from raytracer2022_tpu_torch.render.camera import make_camera
    from raytracer2022_tpu_torch.render.renderer import RenderConfig
    from raytracer2022_tpu_torch.scene.library import SCENES
    from raytracer2022_tpu_torch.utils.device import synchronize
    from raytracer2022_tpu_torch.utils.imageio import read_jpeg

    host = f"host: {os.cpu_count()} cores"
    with tempfile.TemporaryDirectory() as tmp, source_dir_env(os.path.join(tmp, "source")) as src:
        t0 = time.perf_counter()
        images = write_stand_in_assets(src)
        print(f"assets: wrote {', '.join(images)} and obj/Shuttle.obj with the port's encoder in "
              f"{time.perf_counter() - t0:.2f} s ({host})", flush=True)
        decode_s = {}
        for name, img in images.items():
            path = os.path.join(src, name)
            t0 = time.perf_counter()
            back = read_jpeg(path)
            decode_s[name] = time.perf_counter() - t0
            assert back.shape == img.shape, f"{name}: decoded {back.shape}, wrote {img.shape}"
            err = np.abs(back.astype(np.int64) - img)
            print(f"assets: {name} {img.shape[1]}x{img.shape[0]}, {os.path.getsize(path)} bytes: decode "
                  f"{decode_s[name]:.3f} s ({host}), round trip mean abs err {err.mean():.3f}, max {err.max()}",
                  flush=True)
            assert err.mean() < 16.0, f"{name}: the round trip lost the image"

        t0 = time.perf_counter()
        bundle = SCENES["wwscene"](device=dev)
        synchronize(dev)
        build_s = time.perf_counter() - t0
        (tree,) = [t for t in bundle.scene.bvh8 if t is not None]
        groups, depth = tree.entries.shape[0] // 8, tree.depth
        share = mesh_view_share(bundle, dev)
        print(f"wwscene: {bundle.scene.n_prims} prims, trees {bundle.scene.stats.trees}, mesh tree {groups} groups, "
              f"depth {depth}; {share:.4f} of 64x36 camera rays hit the mesh; scene build from the files (the three "
              f"planet JPEG decodes, the OBJ import, the BVHs, the upload), as the CLI run below repeats it: {build_s} s "
              f"({host})", flush=True)
        assert share > 0, "the stand-in Shuttle is not in the camera's view"

        out = os.path.join(tmp, "output.jpg")
        synchronize(dev)
        bvh8.LAUNCHES = 0  # count only this render's launches
        dt, mpaths = _cli_capture([*WW_ARGV, "--out", out, "--device", str(dev)])
        launches, memory = bvh8.LAUNCHES, bvh8.TREE_MEMORY
        img = read_jpeg(out)
        with open(out, "rb") as f:
            jpeg = f.read()
        assert launches > 0 or dev.type != "cuda", "the wwscene render never launched K1"
        assert img.shape == (WW_HEIGHT, WW_WIDTH, 3), f"output.jpg is {img.shape}"
        assert img.std() > 1.0 and img.max() > 64, "output.jpg is blank"
        print(f"cli wwscene {WW_WIDTH}x{WW_HEIGHT} x {WW_SPP} spp, depth {DEPTH}: {dt} s wall (scene build from the "
              f"files and JPEG write included), {WW_WIDTH * WW_HEIGHT * WW_SPP / dt / 1e6} Mpaths/s over the wall time, "
              f"{mpaths} Mpaths/s of the render alone (the CLI's, 2 decimals), K1 launches "
              f"{launches}, {memory} instantiation, output.jpg channel means "
              f"{img.reshape(-1, 3).mean(axis=0).round(3).tolist()} ({smi})", flush=True)

        # K1 against its plain version on wwscene's own rays: the first two
        # K1 calls (camera rays, then mostly bounce rays) of a small render
        # with the full-size Shuttle
        w, h, n = WW_CHECK
        cfg = RenderConfig(width=w, height=h, spp=n, max_depth=DEPTH, background=(0.0, 0.0, 0.0))
        cam = make_camera(**dict(bundle.camera_kwargs, aspect_ratio=w / h), device=dev)
        _, _, captured = render_capturing(bundle.scene, cam, cfg, (0, 1))
        for call, (o, d, tm, t_init) in enumerate(captured):
            rep = check_parity(TRIANGLE, *run_both(tree, TRIANGLE, o, d, tm, t_init))
            print(f"K1 parity wwscene K1 call {call} of a {w}x{h} x {n} spp render ({tm.shape[0]} rays): hits "
                  f"{rep['hits']}, max|dt| {rep['max_abs_err']:.3g}, ids equal {rep['id_match']:.5f}", flush=True)

        # the card-vs-CPU check reads the same JPEGs and a smaller Shuttle
        check_dir = os.path.join(tmp, "check")
        os.makedirs(os.path.join(check_dir, "obj"))
        for name in images:
            os.symlink(os.path.join(src, name), os.path.join(check_dir, name))
        with open(os.path.join(check_dir, "obj", "Shuttle.obj"), "w") as f:
            f.write(shuttle_obj_text(*WW_CHECK_SHUTTLE))

        ww_z = card_vs_cpu(dev, "wwscene", ww_check_build(check_dir), cfg, card_seeds=WW_CHECK_CARD_SEEDS,
                           replicates=WW_CHECK_REPLICATES)
        small = {}
        for name in FROM_FILES_SMALL:
            path = os.path.join(tmp, f"{name}.jpg")
            t0 = time.perf_counter()
            rc = cli.main(["--scene", name, "--width", str(SMALL), "--height", str(SMALL), "--spp", str(SMALL_SPP),
                           "--out", path, "--quiet", "--device", str(dev)])
            small[name] = time.perf_counter() - t0
            got = read_jpeg(path)
            assert rc == 0 and got.shape == (SMALL, SMALL, 3) and got.mean() > 1.0, f"cli {name}: bad image"
            print(f"cli {name} from the files {SMALL}x{SMALL} x {SMALL_SPP} spp: {small[name]:.2f} s wall, jpg mean "
                  f"{got.mean():.2f}", flush=True)
    return {"seconds": dt, "mpaths": mpaths, "wall_mpaths": WW_WIDTH * WW_HEIGHT * WW_SPP / dt / 1e6, "spp": WW_SPP,
            "launches": launches, "groups": groups, "depth": depth, "tree_memory": memory, "decode_s": decode_s,
            "build_s": build_s, "check_z": ww_z,
            "mesh_share": share, "small_s": small, "jpeg": jpeg}


# phase installed: the port as a user installs it, outside the checkout
PIP_OFFLINE = ("--no-index", "--no-cache-dir", "--disable-pip-version-check")  # nothing fetched, nothing cached
INSTALL_TIMEOUT_S = 600  # each pip call, and the installed command's run
INSTALLED_REPORT = "installed: "  # the prefix of INSTALLED_RUNNER's report line

# ``python -c INSTALLED_RUNNER NU NV SCRIPT ARG...``: with the installed
# package, write stand-ins with a NU x NV Shuttle into $RT2022_SOURCE_DIR,
# then run the console script SCRIPT as __main__ with ARG... (its
# ``sys.exit(main())`` is the process's exit code) and, at exit, print one
# line: INSTALLED_REPORT and JSON of where the package, its sources and its
# builds lie, nvcc's seconds, K1's launches in this process, and whether
# chip_smoke can be imported here.
INSTALLED_RUNNER = f"""
import atexit, importlib.util, json, os, runpy, sys
from raytracer2022_tpu_torch import cuda_build, native
from raytracer2022_tpu_torch.ops import bvh8
from raytracer2022_tpu_torch.tools.standins import write_stand_in_assets

nu, nv, script, *argv = sys.argv[1:]
write_stand_in_assets(os.environ["RT2022_SOURCE_DIR"], shuttle=(int(nu), int(nv)))
builds = []
_build = cuda_build.build


def build(source):
    out = _build(source)
    builds.append({{"source": source, "path": out[0], "nvcc_s": out[2]}})
    return out


def report():
    print({INSTALLED_REPORT!r} + json.dumps({{
        "package": os.path.dirname(cuda_build.__file__), "csrc": cuda_build.CSRC_DIR, "builds": builds,
        "native": native.LIBRARY_PATH, "k1_launches": bvh8.LAUNCHES,
        "chip_smoke_importable": importlib.util.find_spec("chip_smoke") is not None}}), flush=True)


cuda_build.build = build
atexit.register(report)
sys.argv = [script, *argv]
runpy.run_path(script, run_name="__main__")
"""


def _run(cmd) -> None:
    """``subprocess.run`` that raises with the command's output when it fails."""
    import subprocess

    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=INSTALL_TIMEOUT_S)
    if proc.returncode != 0:
        raise RuntimeError(f"{cmd[:4]} exited {proc.returncode}:\n{proc.stdout}\n{proc.stderr}")


def build_wheel(root: str, out_dir: str) -> str:
    """A wheel of the checkout at ``root``, built by pip with the host's
    setuptools (``--no-deps --no-build-isolation``, nothing fetched) from a
    copy of ``pyproject.toml`` and the two packages under ``out_dir``, so that
    the build writes nothing into the checkout.  Returns the wheel's path."""
    import glob
    import os
    import shutil
    import sys

    src = os.path.join(out_dir, "src")
    os.makedirs(src)
    shutil.copy(os.path.join(root, "pyproject.toml"), src)
    for pkg in ("raytracer2022_tpu", "raytracer2022_tpu_torch"):
        shutil.copytree(os.path.join(root, pkg), os.path.join(src, pkg), ignore=shutil.ignore_patterns("__pycache__"))
    _run([sys.executable, "-m", "pip", "wheel", "--no-deps", "--no-build-isolation", *PIP_OFFLINE, "-w", out_dir,
          src])
    (wheel,) = glob.glob(os.path.join(out_dir, "*.whl"))
    return wheel


def install_wheel(wheel: str, target: str) -> None:
    """``pip install --no-deps --target target wheel``, offline."""
    import sys

    _run([sys.executable, "-m", "pip", "install", "--no-deps", *PIP_OFFLINE, "--target", target, wheel])


def tree_state(root: str) -> dict:
    """Every path under ``root`` -> (size, mtime in ns)."""
    import os

    state = {}
    for here, dirs, files in os.walk(root):
        for name in dirs + files:
            st = os.lstat(os.path.join(here, name))
            state[os.path.relpath(os.path.join(here, name), root)] = (st.st_size, st.st_mtime_ns)
    return state


def run_installed(target: str, work: str, env: dict, argv, shuttle=(96, 68)) -> tuple:
    """The installed ``rt2022-torch`` (pip's console script under
    ``target/bin``) with ``argv``, from ``work`` under ``env``, through
    :data:`INSTALLED_RUNNER`.  Returns ``(process, its report or None)``."""
    import json
    import os
    import subprocess
    import sys

    proc = subprocess.run([sys.executable, "-c", INSTALLED_RUNNER, str(shuttle[0]), str(shuttle[1]),
                           os.path.join(target, "bin", "rt2022-torch"), *argv],
                          cwd=work, env=env, capture_output=True, text=True, timeout=INSTALL_TIMEOUT_S)
    lines = [ln[len(INSTALLED_REPORT):] for ln in proc.stdout.splitlines() if ln.startswith(INSTALLED_REPORT)]
    return proc, json.loads(lines[-1]) if lines else None


def installed_env(target: str, home: str, **extra) -> dict:
    """This process's environment with only ``target`` on ``PYTHONPATH``,
    ``HOME`` at ``home``, no ``XDG_CACHE_HOME`` nor ``RT2022_SOURCE_DIR``
    unless ``extra`` sets them."""
    import os

    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "XDG_CACHE_HOME", "RT2022_SOURCE_DIR")}
    env.update(PYTHONPATH=target, HOME=home, **extra)
    return env


def phase_installed(dev, smi, assets: dict) -> dict:
    """The port as a user installs it: a wheel of the checkout (pip, offline),
    installed with ``pip install --target`` into a temporary directory, and
    its ``rt2022-torch`` command run from a temporary working directory with
    only that directory on ``PYTHONPATH`` and ``HOME`` and ``XDG_CACHE_HOME``
    in a temporary directory: the JAX CLI's default invocation (``wwscene``,
    640x360 x 100 spp, depth 50, ``--out output.jpg``) on stand-ins the
    installed package writes, twice: with the cache empty, then warm.
    Holds: exit 0, a 640x360 JPEG whose channel means lie within
    ``MAX_REL`` of phase ``assets``' (and whose bytes equal them where two
    checkout renders on the card do), K1 and the host runtime built from the
    shipped sources under ``XDG_CACHE_HOME`` (the same source hashes as the
    checkout's builds) by the first run and found there by the second, K1
    launched, nothing written under the install directory, and
    ``chip_smoke`` not importable there."""
    import os
    import re
    import tempfile
    import time
    import zipfile

    from raytracer2022_tpu_torch import native
    from raytracer2022_tpu_torch.cuda_build import build
    from raytracer2022_tpu_torch.utils.imageio import read_jpeg

    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        wheel = build_wheel(root, os.path.join(tmp, "wheel"))
        wheel_s = time.perf_counter() - t0
        with zipfile.ZipFile(wheel) as z:
            names = z.namelist()
            (entry,) = [n for n in names if n.endswith(".dist-info/entry_points.txt")]
            entry_points = z.read(entry).decode()
        shipped = sorted(n for n in names if n.startswith("raytracer2022_tpu_torch/csrc/"))
        print(f"installed: wheel {os.path.basename(wheel)} ({len(names)} files) in {wheel_s:.2f} s, its csrc/: "
              f"{shipped}", flush=True)
        assert {"raytracer2022_tpu_torch/csrc/bvh8.cu", "raytracer2022_tpu_torch/csrc/rt_native.cpp"} <= set(shipped)
        assert "rt2022-torch = raytracer2022_tpu_torch.cli:main" in entry_points, entry_points

        target, home, work = (os.path.join(tmp, d) for d in ("site", "home", "work"))
        install_wheel(wheel, target)
        os.makedirs(home)
        os.makedirs(work)
        before = tree_state(target)
        cache = os.path.join(home, "cache")
        env = installed_env(target, home, XDG_CACHE_HOME=cache, RT2022_SOURCE_DIR=os.path.join(work, "stand-ins"))
        runs = {}
        for run in ("cold", "warm"):  # the first run builds K1 and the runtime, the second finds them
            t0 = time.perf_counter()
            proc, rep = run_installed(target, work, env, [*WW_ARGV, "--out", "output.jpg"])
            dt = time.perf_counter() - t0
            print(proc.stdout, end="", flush=True)
            assert proc.returncode == 0 and rep is not None, f"rt2022-torch exited {proc.returncode}:\n{proc.stderr}"
            after = tree_state(target)
            changed = sorted(k for k in set(before) | set(after) if before.get(k) != after.get(k))
            assert not changed, f"the installed run wrote under its install directory: {changed[:10]}"
            (k1,) = [b for b in rep["builds"] if b["source"] == "bvh8.cu"]
            with open(os.path.join(work, "output.jpg"), "rb") as f:
                jpeg = f.read()
            rate = float(re.findall(r"([0-9.]+) Mpaths/s", proc.stdout)[-1])
            runs[run] = {"seconds": dt, "mpaths": rate, "launches": rep["k1_launches"], "nvcc_s": k1["nvcc_s"],
                         "k1": k1["path"], "native": rep["native"], "jpeg": jpeg}
            print(f"installed, {run} cache: package {rep['package']}; K1 from {rep['csrc']}/bvh8.cu in {k1['path']} "
                  f"(nvcc {k1['nvcc_s']:.2f} s), host runtime {rep['native']}; K1 launches {rep['k1_launches']}; "
                  f"chip_smoke importable there: {rep['chip_smoke_importable']}; {rate} Mpaths/s of the render (the "
                  f"CLI's, 2 decimals), {dt} s wall of the process ({smi})", flush=True)
            assert rep["package"].startswith(target + os.sep) and rep["csrc"].startswith(target + os.sep)
            assert k1["path"].startswith(cache + os.sep), k1["path"]
            assert os.path.basename(k1["path"]) == os.path.basename(build("bvh8.cu")[0]), "K1: another source"
            if native.available():  # else both processes build their trees with NumPy
                assert rep["native"].startswith(cache + os.sep), rep["native"]
                assert os.path.basename(rep["native"]) == os.path.basename(native.LIBRARY_PATH), "another source"
            assert rep["k1_launches"] > 0, "the installed render never launched K1"
            assert not rep["chip_smoke_importable"], "chip_smoke is importable beside the installed package"
        cold, warm = runs["cold"], runs["warm"]
        assert cold["nvcc_s"] > 0 and warm["nvcc_s"] == 0 and warm["k1"] == cold["k1"], "K1 was not built once"
        assert warm["native"] == cold["native"] and warm["jpeg"] == cold["jpeg"]

        img = read_jpeg(cold["jpeg"])
        assert img.shape == (WW_HEIGHT, WW_WIDTH, 3), f"the installed render's JPEG is {img.shape}"
        m_inst = img.reshape(-1, 3).mean(axis=0)
        m_ref = read_jpeg(assets["jpeg"]).reshape(-1, 3).mean(axis=0)
        rel = _rel(m_inst, m_ref)
        note = "byte-equal to phase assets' output.jpg"
        if cold["jpeg"] != assets["jpeg"]:
            again = os.path.join(work, "again.jpg")
            with source_dir_env(env["RT2022_SOURCE_DIR"]):
                _cli_capture([*WW_ARGV, "--out", again, "--device", str(dev)])
            with open(again, "rb") as f:
                assert f.read() != assets["jpeg"], "two checkout renders are byte-equal, the installed one differs"
            note = "its bytes differ from phase assets' output.jpg, as a second checkout render's do"
        print(f"installed rt2022-torch wwscene {WW_WIDTH}x{WW_HEIGHT} x {WW_SPP} spp, depth {DEPTH}: {warm['mpaths']} "
              f"Mpaths/s with the cache warm ({cold['mpaths']} cold: its render includes the K1 build) vs phase "
              f"assets' {assets['mpaths']}; channel means {m_inst.round(3).tolist()} vs phase assets' "
              f"{m_ref.round(3).tolist()} (rel {rel.round(4).tolist()}, bound {MAX_REL}); {note} ({smi})", flush=True)
        assert (rel < MAX_REL).all(), "the installed render and phase assets' disagree"
    return {"wheel_files": len(names), "csrc": shipped, "wheel_s": wheel_s, "launches": cold["launches"],
            "byte_equal": cold["jpeg"] == assets["jpeg"],
            **{f"{run}_{k}": v for run, r in runs.items() for k, v in r.items() if k in ("seconds", "mpaths", "nvcc_s")}}

FLAGSHIP_WIDTH, FLAGSHIP_HEIGHT = 2560, 1440  # the reference's own frame (main.rs:33-41)
FLAGSHIP_SPP, FLAGSHIP_CHUNK = 4, 2  # phase flagship's run: two chunks of the tool's loop
FLAGSHIP_MAX_MAE = 0.01  # the resumed image against a quality-100 JPEG of the uninterrupted one


def phase_flagship(dev, smi) -> dict:
    """The reference's own workload at its full frame: ``wwscene`` at
    2560x1440, depth 50, from stand-in assets.  K1 against its plain version
    on the first K1 call of a full-frame strip launch (102 rows, 261,120
    rays: the strip whose camera rays hit the mesh most) and of the 12-row
    last strip; ``tools.flagship.main`` for 4 spp in chunks of 2 on a fresh state;
    the same run interrupted after the first chunk and resumed, whose image
    must equal the uninterrupted one byte for byte and match a quality-100
    JPEG of it as the golden."""
    import io
    import json
    import os
    import tempfile
    import time

    import torch

    from raytracer2022_tpu_torch.ops import bvh8
    from raytracer2022_tpu_torch.render.camera import make_camera
    from raytracer2022_tpu_torch.render.renderer import RenderConfig, render_batch_regen, step_generator
    from raytracer2022_tpu_torch.scene.library import SCENES
    from raytracer2022_tpu_torch.tools import flagship
    from raytracer2022_tpu_torch.tools.flagship import FIRST_SEED
    from raytracer2022_tpu_torch.utils.imageio import read_png, write_jpeg

    w, h = FLAGSHIP_WIDTH, FLAGSHIP_HEIGHT
    with tempfile.TemporaryDirectory() as tmp, source_dir_env(os.path.join(tmp, "source")) as src:
        write_stand_in_assets(src)

        # K1 on the flagship's own rays: the first K1 call (camera rays) of
        # each strip launch of chunk 0's shape at 1 spp; held against its
        # plain version on the strip whose call hits the mesh most, and on
        # the short last strip
        bundle = SCENES["wwscene"](device=dev)
        (tree,) = [t for t in bundle.scene.bvh8 if t is not None]
        cam = make_camera(**bundle.camera_kwargs, device=dev)
        tcfg = RenderConfig(width=w, height=h, max_depth=DEPTH, background=bundle.background).trace_cfg()
        rows = min(h, LANES // w)
        firsts = []
        for s in range(-(-h // rows)):
            ((inputs, out),) = capture_k1(lambda: render_batch_regen(
                bundle.scene, cam, step_generator(FIRST_SEED, s, dev), w, h, 1, 1, tcfg, row0=s * rows,
                rows=min(rows, h - s * rows)), (0,))
            firsts.append((inputs, int((out[1] >= 0).sum())))
            del out
        hits = [n for _, n in firsts]
        most = max(range(len(firsts)), key=hits.__getitem__)
        assert hits[most] > 0, "no strip's camera rays hit the mesh"
        parity = {}
        for s in sorted({most, len(firsts) - 1}):
            o, d, tm, t_init = firsts[s][0]
            rs = min(rows, h - s * rows)
            assert tm.shape[0] == rs * w, f"strip {s}: K1 call 0 took {tm.shape[0]} rays, not {rs * w}"
            parity[s] = rep = check_parity(TRIANGLE, *run_both(tree, TRIANGLE, o, d, tm, t_init))
            print(f"K1 parity flagship strip {s} of {len(firsts)} ({rs} rows), its launch's first K1 call "
                  f"({tm.shape[0]} camera rays): hits {rep['hits']}, max|dt| {rep['max_abs_err']:.3g}, ids equal "
                  f"{rep['id_match']:.5f}", flush=True)
        print(f"flagship: mesh hits of each strip's first K1 call {hits}", flush=True)
        rays = firsts[most][0][2].shape[0]  # the rays K1 took in the parity call of the strip with the most hits
        del firsts

        def run(tag: str, spp: int, state: str, golden: str = "") -> dict:
            """tools.flagship.main, its output echoed, into ``tag.png``."""
            out = os.path.join(tmp, f"{tag}.png")
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = flagship.main(["--spp", str(spp), "--chunk", str(FLAGSHIP_CHUNK), "--width", str(w),
                                    "--height", str(h), "--state", state, "--out", out, "--golden", golden,
                                    "--device", str(dev)])
            dt = time.perf_counter() - t0
            print(buf.getvalue(), end="", flush=True)
            assert rc == 0, f"flagship run {tag} returned {rc}"
            lines = buf.getvalue().strip().splitlines()
            rec = json.loads(lines[-1])
            chunks = [line for line in lines if line.startswith("# chunk ")]
            resumed = [line for line in lines if line.startswith("# resuming")]
            print(f"flagship run {tag}: --spp {spp} --chunk {FLAGSHIP_CHUNK}, {len(chunks)} chunk(s) rendered: "
                  f"{rec['wall_s']} s of render over the state's chunks ({dt} s wall of this call, scene build and "
                  f"writes included), {rec['Mpaths_per_s']} Mpaths/s, K1 launches {rec['k1_launches']} ({smi})",
                  flush=True)
            assert rec["device"] == torch.cuda.get_device_name(dev) and rec["assets"] == src, rec
            with open(out, "rb") as f:
                png = f.read()
            return {"wall_s": dt, "rec": rec, "chunks": len(chunks), "resumed": resumed, "png": png, "out": out}

        # the tool's main path, uninterrupted
        state_b = os.path.join(tmp, "whole.npz")
        torch.cuda.synchronize(dev)
        bvh8.LAUNCHES = 0  # count only this run's launches
        whole = run("whole", FLAGSHIP_SPP, state_b)
        launches = bvh8.LAUNCHES
        assert launches > 0, "the flagship run never launched K1"
        assert whole["rec"]["k1_launches"] == launches, (whole["rec"]["k1_launches"], launches)
        n_chunks = -(-FLAGSHIP_SPP // FLAGSHIP_CHUNK)
        assert whole["chunks"] == n_chunks and not whole["resumed"], "the fresh run resumed or skipped a chunk"
        img = read_png(whole["out"])
        assert img.shape == (h, w, 3) and img.std() > 1.0 and img.max() > 64, f"flagship image {img.shape} is blank"
        golden = os.path.join(tmp, "golden.jpg")
        write_jpeg(golden, img)

        # the same run killed after its first chunk, then resumed
        state_c = os.path.join(tmp, "resumed.npz")
        first = run("first", FLAGSHIP_CHUNK, state_c)
        resumed = run("resumed", FLAGSHIP_SPP, state_c, golden)
        assert first["chunks"] == 1 and resumed["chunks"] == n_chunks - 1, "the resumed run rendered a done chunk"
        assert resumed["resumed"] == [f"# resuming: {FLAGSHIP_CHUNK}/{FLAGSHIP_SPP} spp, "
                                      f"{first['rec']['wall_s']:.0f}s so far"], resumed["resumed"]
        with np.load(state_b) as a, np.load(state_c) as b:
            assert np.array_equal(a["total"], b["total"]) and int(a["done_spp"]) == int(b["done_spp"]) == FLAGSHIP_SPP
        assert resumed["png"] == whole["png"], "the resumed image differs from the uninterrupted one"
        mae = resumed["rec"]["mae"]
        assert mae < FLAGSHIP_MAX_MAE, f"resumed image against the golden: mae {mae}"
        print(f"flagship: resumed image equals the uninterrupted one byte for byte; against its q100 JPEG mae {mae}, "
              f"rmse {resumed['rec']['rmse']}, exposure {resumed['rec']['exposure']}; image channel means "
              f"{img.reshape(-1, 3).mean(axis=0).round(3).tolist()}", flush=True)
    runs = {tag: {"wall_s": r["wall_s"], "render_s": r["rec"]["wall_s"], "mpaths": r["rec"]["Mpaths_per_s"],
                  "k1": r["rec"]["k1_launches"], "chunks": r["chunks"], "spp": r["rec"]["paths"] // (w * h)}
            for tag, r in (("whole", whole), ("first", first), ("resumed", resumed))}
    return {"launches": launches, "parity": parity, "rays": rays, "strip_hits": hits, "mae": mae, "runs": runs}


def _dome(builder, mirrors: bool = True):
    """An emissive dome seen from inside, with albedo-1 mirrors: every
    sample contributes exactly EMIT, whatever its path length."""
    b = builder
    dome = b.sphere((0, 0, 0), 50, b.diffuse_light(EMIT))
    b.flip_face(dome)
    if mirrors:
        mirror = b.metal((1.0, 1.0, 1.0), 0.0)
        b.rect_yz(-10, 10, -20, 0, -1, mirror)
        b.rect_yz(-10, 10, -20, 0, 1, mirror)
    return dict(lookfrom=(0, 0, 0), lookat=(0, 0, -1), vup=(0, 1, 0), vfov=60, aspect_ratio=1.0)


def phase_schedules(dev, smi) -> dict:
    """The pixel pool on cornell_box at bench.py's launch (256x256, 4 lanes
    per pixel, 512 sequential samples) and the quota schedule on
    random_scene at 128x128, each with an exact per-pixel count check on
    the emissive dome at the same lane count."""
    import time

    import torch

    from raytracer2022_tpu_torch.render.camera import make_camera
    from raytracer2022_tpu_torch.render.integrator import Schedule, TraceConfig
    from raytracer2022_tpu_torch.render.renderer import render_batch_regen, step_generator
    from raytracer2022_tpu_torch.scene.builder import SceneBuilder
    from raytracer2022_tpu_torch.scene.library import SCENES

    out = {}
    for sched, name, size, spp_par, spp_seq in (
        (Schedule.PIXEL, "cornell_box", 256, 4, PIXEL_SPP_SEQ),
        (Schedule.QUOTA, "random_scene", 128, 4, 32),
    ):
        b = SceneBuilder()
        dome_cam = make_camera(**_dome(b), device=dev)
        cfg = TraceConfig(max_depth=16, background=(0.0, 0.0, 0.0))
        cnt_seq = min(spp_seq, 64)
        img, iters = render_batch_regen(b.finalize(device=dev), dome_cam, step_generator(0, 0, dev), size, size,
                                        spp_par, cnt_seq, cfg, return_iters=True, schedule=sched)
        img = (img / (spp_par * cnt_seq)).cpu().numpy()
        err = max(float(np.abs(img[c] - e).max()) for c, e in enumerate(EMIT))
        print(f"{sched.value} schedule count check {size}x{size} x {spp_par} lanes x {cnt_seq}: every pixel "
              f"= emission to {err:.3g} (iterations {iters})", flush=True)
        assert err <= 1e-5 * max(EMIT), f"{sched.value}: per-pixel sample counts are not exact"
        assert iters["drain_n4"] + iters["drain_n16"] > 0, f"{sched.value}: the drains never ran"

        bundle = SCENES[name](device=dev)
        cam = make_camera(**bundle.camera_kwargs, device=dev)
        cfg = TraceConfig(max_depth=DEPTH, background=bundle.background)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img, iters = render_batch_regen(bundle.scene, cam, step_generator(0, 0, dev), size, size, spp_par,
                                        spp_seq, cfg, return_iters=True, schedule=sched)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        img = (img / (spp_par * spp_seq)).cpu().numpy()
        assert np.isfinite(img).all() and img.mean() > 1e-3, f"{name}: bad {sched.value} render"
        mpaths = size * size * spp_par * spp_seq / dt / 1e6
        out[sched.value] = mpaths
        print(f"{sched.value} schedule {name} {size}x{size} x {spp_par} lanes x {spp_seq} seq, depth {DEPTH}: "
              f"{dt:.2f} s, {mpaths:.3f} Mpaths/s, iterations {iters}, channel means "
              f"{np.round(img.mean(axis=(1, 2)), 4).tolist()} ({smi})", flush=True)
    return out


def phase_sort_and_trace(dev, smi) -> None:
    """random_scene with a tree and the ray sort against the unsorted
    render; cornell_box through the fixed-depth trace against the
    regeneration render."""
    import torch

    from raytracer2022_tpu_torch.render.camera import make_camera
    from raytracer2022_tpu_torch.render.integrator import TraceConfig
    from raytracer2022_tpu_torch.render.renderer import (
        RenderConfig, render_batch_regen, render_sum_n, step_generator,
    )
    from raytracer2022_tpu_torch.scene.library import SCENES, random_scene

    bundle = random_scene(bvh_threshold=64, device=dev)
    assert bundle.scene.use_bvh
    cam = make_camera(**bundle.camera_kwargs, device=dev)
    m = {}
    for sort in (False, True):
        cfg = TraceConfig(max_depth=DEPTH, background=bundle.background, sort_rays=sort)
        img = render_batch_regen(bundle.scene, cam, step_generator(0, 0, dev), 64, 64, 2, 16, cfg)
        m[sort] = (img / 32).mean(dim=(1, 2)).cpu().numpy()
    rel = _rel(m[True], m[False])
    print(f"ray sort: random_scene (trees {bundle.scene.stats.trees}) 64x64 x 2 lanes x 16, sorted vs unsorted "
          f"channel means {m[True].round(4).tolist()} vs {m[False].round(4).tolist()} (rel {rel.round(4).tolist()})",
          flush=True)
    assert np.isfinite(m[True]).all() and (rel < MAX_REL).all(), "the sorted render disagrees"

    bundle = SCENES["cornell_box"](device=dev)
    cam = make_camera(**bundle.camera_kwargs, device=dev)
    means = {}
    for regen in (True, False):
        cfg = RenderConfig(width=64, height=64, spp=64, max_depth=DEPTH, background=bundle.background,
                           regen=regen)
        torch.cuda.synchronize()
        means[regen] = _means(*render_sum_n(bundle.scene, cam, cfg))
    rel = _rel(means[False], means[True])
    print(f"fixed-depth trace: cornell_box 64x64x64, trace vs trace_regen channel means "
          f"{means[False].round(4).tolist()} vs {means[True].round(4).tolist()} (rel {rel.round(4).tolist()})",
          flush=True)
    assert np.isfinite(means[False]).all() and (rel < MAX_REL).all(), "trace and trace_regen disagree"


def phase_packet_policy(dev, smi, s3) -> dict:
    """The TRIANGLE-only packet-tree policy, measured: final_scene's 1000
    spheres untransformed, walked by the cluster walk (the default policy)
    and by K1 (``bvh8_kinds=(SPHERE,)``) on S3's 262,144 bounce-like rays,
    whose K1 time ``s3`` (``k1_at_shape``) holds."""
    import torch

    from raytracer2022_tpu_torch.ops.bvh8 import traverse_bvh8
    from raytracer2022_tpu_torch.ops.intersect import traverse_clusters
    from raytracer2022_tpu_torch.scene.builder import SceneBuilder

    s_walk = sphere_cluster_scene(SceneBuilder(), device=dev)
    s_k1, o, d, tm = sphere_tree_rays(dev)
    assert s_walk.bvh8 == (None,) and s_k1.bvh8[0] is not None
    inf = torch.full_like(tm, float("inf"))
    t_w, b_w = traverse_clusters(s_walk, 0, o, d, tm, T_MIN, float("inf"))
    t_k, b_k, _ = traverse_bvh8(s_k1.bvh8[0], SPHERE, o, d, tm, T_MIN, t_init=inf, return_rows=True)
    torch.cuda.synchronize()
    ref = (t_w.cpu().numpy(), np.where(np.isfinite(t_w.cpu().numpy()), b_w.cpu().numpy(), -1), None)
    rep = check_parity(SPHERE, ref, (np.where(b_k.cpu().numpy() >= 0, t_k.cpu().numpy(), np.inf),
                                     b_k.cpu().numpy(), None))
    walk_ms = _time_cuda(lambda: traverse_clusters(s_walk, 0, o, d, tm, T_MIN, float("inf")), 5)
    print(f"packet-tree policy, 1000 spheres ({s_walk.stats.trees[0][1]} clusters of <= "
          f"{s_walk.stats.trees[0][2]}), {LANES} bounce-like rays: cluster walk {walk_ms:.3f} ms, "
          f"K1 {s3['ms']:.4f} ms (S3); hits {rep['hits']}, max|dt| {rep['max_abs_err']:.3g}, ids equal "
          f"{rep['id_match']:.4f} ({smi})", flush=True)
    return {"walk_ms": walk_ms, "k1_ms": s3["ms"]}


DEEP_RAYS = 4096
DEEP_WALK_SAMPLE = 128  # rays of the deep tree walked by the reference walk
DEEP_SIZE, DEEP_SPP = 128, 8  # the deep mesh render


def phase_deep(dev, smi) -> dict:
    """The deepest TRIANGLE tree the builder makes here
    (:func:`nested_triangles`: 22 group levels, the kernel's MAX_DEPTH): K1
    against its plain version on ``DEEP_RAYS`` rays with three ``t_init``
    modes in both instantiations, its visit counts and the stack depth
    against the reference walk on a sample, and one render through
    ``render_sum_n`` with K1's launches counted around it."""
    import time

    import torch

    from raytracer2022_tpu_torch.ops import bvh8
    from raytracer2022_tpu_torch.render.camera import make_camera
    from raytracer2022_tpu_torch.render.renderer import RenderConfig, render_sum_n
    from raytracer2022_tpu_torch.scene.builder import SceneBuilder

    b = SceneBuilder()
    cam_kw = nested_triangles(b)
    scene = b.finalize(device=dev)
    tree = scene.bvh8[0]
    depth = tree.depth
    groups = tree.entries.shape[0] // bvh8.FANOUT
    assert depth == bvh8.tree_depth(tree.entries.cpu().numpy()) == bvh8.MAX_DEPTH, \
        f"the nested set's tree has {depth} levels, not {bvh8.MAX_DEPTH}"
    rng = np.random.default_rng(2022)
    o, d, tm = (torch.as_tensor(x, device=dev) for x in nested_rays(rng, DEEP_RAYS))
    finite = torch.as_tensor(rng.uniform(0.05, 2.0, DEEP_RAYS).astype(np.float32), device=dev)
    err = 0.0
    for label, t_init in (("no t_init", None), ("+inf t_init", torch.full_like(tm, float("inf"))),
                          ("finite t_init", finite)):
        for mode in ("shared", "global"):
            with k1_tree_memory(mode):
                ref, got = run_both(tree, TRIANGLE, o, d, tm, t_init)
            assert bvh8.TREE_MEMORY == mode, f"K1 ran {bvh8.TREE_MEMORY}, not {mode}"
            rep = check_parity(TRIANGLE, ref, got)
            err = max(err, rep["max_abs_err"])
            print(f"K1 parity deep tree {label:13s} {mode:6s}: hits {rep['hits']}, max|dt| "
                  f"{rep['max_abs_err']:.3g}, ids equal {rep['id_match']:.4f}", flush=True)
    visits = bvh8.traverse_bvh8(tree, TRIANGLE, o, d, tm, T_MIN, return_visits=True)[-1].cpu().numpy()
    sample = np.arange(DEEP_WALK_SAMPLE)
    far = np.full(DEEP_WALK_SAMPLE, bvh8.FAR, np.float32)
    _, _, g_ref, l_ref, deepest = bvh8.walk_bvh8_reference(
        tree, TRIANGLE, *(x[..., sample].cpu().numpy() for x in (o, d, tm)), T_MIN, far)
    assert np.array_equal(visits[0, sample], g_ref) and np.array_equal(visits[1, sample], l_ref), \
        "deep tree: K1's visit counts differ from the reference walk's"
    print(f"K1 visits deep tree: {DEEP_WALK_SAMPLE} rays equal the reference walk's (groups mean "
          f"{g_ref.mean():.1f} max {g_ref.max()}, deepest stack {deepest.max()} words of {bvh8.MAX_DEPTH})",
          flush=True)

    cam = make_camera(**cam_kw, device=dev)
    cfg = RenderConfig(width=DEEP_SIZE, height=DEEP_SIZE, spp=DEEP_SPP, max_depth=DEPTH, background=None)
    torch.cuda.synchronize()
    bvh8.LAUNCHES = 0
    t0 = time.perf_counter()
    total, n = render_sum_n(scene, cam, cfg)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = bvh8.LAUNCHES
    img = (total / n).cpu().numpy()
    assert launches > 0, "the deep mesh render never launched K1"
    assert np.isfinite(img).all() and img.mean() > 1e-3, "deep mesh render: non-finite or black"
    tree_bytes = sum(x.numel() * x.element_size() for x in (tree.entries, tree.axorder, tree.boxes, tree.prows))
    print(f"deep mesh: {scene.n_prims} triangles, tree depth {depth}, {groups} groups, group arrays "
          f"{groups * 320} B in {bvh8.TREE_MEMORY} memory, tree {tree_bytes} B; render {DEEP_SIZE}x{DEEP_SIZE} x {n} "
          f"spp, depth {DEPTH}: {dt:.2f} s, K1 launches {launches}, channel means "
          f"{np.round(img.mean(axis=(1, 2)), 4).tolist()} ({smi})", flush=True)
    return {"depth": depth, "groups": groups, "tree_memory": bvh8.TREE_MEMORY, "max_abs_err": err,
            "launches": launches, "deepest_stack": int(deepest.max()), "render_s": dt}


def phase_perf(smi) -> dict:
    """``raytracer2022_tpu_torch.tools.perf`` on cornell_box at 128x128 x 16
    spp: its JSON line, with finite positive times and rate."""
    import contextlib
    import io
    import json

    from raytracer2022_tpu_torch.tools import perf

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = perf.main(["cornell_box", "--size", "128x128", "--spp", "16"])
    print(buf.getvalue(), end="", flush=True)
    rec = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert rc == 0 and rec["scene"] == "cornell_box", "perf: bad result"
    for key in ("scene_build_s", "first_call_s", "steady_s", "Mpaths_per_s"):
        assert np.isfinite(rec[key]) and rec[key] > 0, f"perf: {key} = {rec[key]}"
    return rec


BENCH_CUT = ("--size-div", "4", "--spp-div", "16", "--reps", "1")  # phase bench: bench.py's cells in ~30 s


def check_bench_line(line: dict, keys) -> None:
    """``tools/bench.py``'s last line: exactly ``keys``, every number finite
    and positive, each ``*_spread`` around its ``*_Mpaths_s``."""
    assert list(line) == list(keys), f"bench: keys {list(line)}"
    for key, value in line.items():
        if key.endswith("_spread"):
            lo, hi = value
            assert 0 < lo <= line[key.replace("spread", "Mpaths_s")] <= hi, f"bench: {key} {value}"
        elif key not in ("metric", "unit", "vs_baseline_estimate", "cut"):
            assert np.isfinite(value) and value > 0, f"bench: {key} = {value}"


def phase_bench(dev, smi) -> dict:
    """``raytracer2022_tpu_torch.tools.bench`` at ``BENCH_CUT``: its last
    line has ``bench.py``'s keys and ``cut`` (:func:`check_bench_line`);
    K1 ran in the two ``wwscene`` cells and in no other.  Then those two
    cells, the ones that run K1, at ``bench.py``'s own shapes through the
    tool's functions (a warm-up and one timed call each), with K1 held
    against its plain version on the warm-up's first two K1 calls (camera
    rays, then mostly bounce rays: 65,536 rays each).  -> ``{"line": the
    last line, "k1": K1's launches in the timed call of each full-shape
    cell, "parity": each parity call's report, "seconds": each full-shape
    cell's timed call}``."""
    import io
    import json
    import os
    import tempfile

    from raytracer2022_tpu_torch.render.camera import make_camera
    from raytracer2022_tpu_torch.scene.library import SCENES
    from raytracer2022_tpu_torch.tools import bench

    with tempfile.TemporaryDirectory() as tmp, source_dir_env(os.path.join(tmp, "stand-ins")) as src:
        write_stand_in_assets(src)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = bench.main(list(BENCH_CUT))
        print(buf.getvalue(), end="", flush=True)
        lines = buf.getvalue().strip().splitlines()
        details, line = [json.loads(x) for x in lines[1:-1]], json.loads(lines[-1])
        assert rc == 0 and [d["cell"] for d in details] == [c.key for c in bench.CELLS], "bench: cells missing"
        check_bench_line(line, [*bench.KEYS, "cut"])
        for d in details:
            launches = d["k1_launches"]
            assert (launches > 0) == (d["scene"] == "wwscene"), f"bench: {d['cell']} K1 launches {launches}"

        b = SCENES["wwscene"](device=dev)
        cam = make_camera(**b.camera_kwargs, device=dev)
        (tree,) = [t for t in b.scene.bvh8 if t is not None]
        obj = bench.FORWARD[-1]._replace(reps=1)
        fwd_bwd = bench.FWD_BWD_OBJ._replace(reps=1)
        fns = {obj.key: (obj, bench.forward_fn(b, cam, obj)),
               fwd_bwd.key: (fwd_bwd, bench.fwd_bwd_fn(b, cam, fwd_bwd, ("textures.color",),
                                                       *bench.regen_trips(b, cam, fwd_bwd)))}
        k1, parity, seconds = {}, {}, {}
        for key, (cell, fn) in fns.items():
            assert cell.scene == "wwscene", cell
            recs = []
            kept = capture_k1(lambda: recs.append(bench.measure(cell, fn, dev)[0]), (0, 1))
            (rec,) = recs
            k1[key], seconds[key] = rec["k1_launches"], rec["seconds"][0]
            assert k1[key] > 0, f"bench {key} at its full shape never launched K1"
            for call, ((o, d, tm, t_init), _) in enumerate(kept):
                parity[f"{key} call {call}"] = rep = check_parity(TRIANGLE, *run_both(tree, TRIANGLE, o, d, tm, t_init))
                print(f"K1 parity bench {key} {cell.width}x{cell.height} x {cell.spp_par} x {cell.spp_seq}, K1 call "
                      f"{call} of its warm-up ({tm.shape[0]} rays): hits {rep['hits']}, max|dt| "
                      f"{rep['max_abs_err']:.3g}, ids equal {rep['id_match']:.5f}", flush=True)
            assert len(kept) == 2 and kept[0][0][2].shape[0] == cell.width * cell.height * cell.spp_par, kept
            print(f"bench {key} at bench.py's shape {cell.width}x{cell.height} x {cell.spp_par} x {cell.spp_seq}: "
                  f"{seconds[key]} s a call, {rec['paths'] / seconds[key] / 1e6} Mpaths/s, K1 launches {k1[key]}, "
                  f"assets {src} ({smi})", flush=True)
    return {"line": line, "k1": k1, "parity": parity, "seconds": seconds}


def _fwd_bwd_cell(label: str, bundle, cam, cell, wrt, smi: str) -> dict:
    """One of ``bench.py``'s fwd+bwd cells through ``tools/bench.py``'s own
    functions: the trip counts (``regen_trips``), the median fwd+bwd step
    with its peak memory and K1 launches (``measure`` of ``fwd_bwd_fn``,
    gradients with respect to ``wrt``), and beside it the forward alone
    under ``torch.no_grad()`` over the same trip counts (its time, K1
    launches and the share of samples it completed)."""
    import time

    import torch

    from raytracer2022_tpu_torch.render.integrator import TraceConfig
    from raytracer2022_tpu_torch.render.renderer import render_batch_regen_diff
    from raytracer2022_tpu_torch.tools import bench

    dev = bundle.scene.device
    t0 = time.perf_counter()
    n_iters, n_drain = bench.regen_trips(bundle, cam, cell)
    est_s = time.perf_counter() - t0
    step, grads = bench.measure(cell, bench.fwd_bwd_fn(bundle, cam, cell, wrt, n_iters, n_drain), dev,
                                peak_memory=True)
    tcfg = TraceConfig(max_depth=cell.depth, background=bundle.background)

    def forward(seed):
        with torch.no_grad():
            cnt = render_batch_regen_diff(bundle.scene, cam, seed, cell.width, cell.height, cell.spp_par,
                                          cell.spp_seq, n_iters, tcfg, n_drain=n_drain)[1]
        return float(cnt.sum())

    t_fwd, _, _, k1_fwd, done = bench.median_time(forward, cell.reps, dev)
    t_fb, paths = step["seconds"][0], step["paths"]
    rec = {"n_iters": n_iters, "n_drain": n_drain, "estimate_s": est_s, "fwd_bwd_s": t_fb, "fwd_s": t_fwd,
           "fwd_bwd_mpaths": paths / t_fb / 1e6, "fwd_mpaths": paths / t_fwd / 1e6, "fwd_bwd_over_fwd": t_fb / t_fwd,
           "peak_gib": step["peak_gib_above_base"], "k1_per_step": step["k1_launches"], "k1_per_forward": k1_fwd,
           "completed": done / paths, "grads": [g.cpu().numpy() for g in grads]}
    print(f"fwd+bwd {label} {cell.width}x{cell.height} x {cell.spp_par} lanes x {cell.spp_seq} seq, depth "
          f"{cell.depth}: n_iters {n_iters} + drain {n_drain} (estimate {est_s:.2f} s); step {t_fb:.3f} s "
          f"({rec['fwd_bwd_mpaths']:.3f} Mpaths/s; median of {cell.reps}), forward alone {t_fwd:.3f} s "
          f"({rec['fwd_mpaths']:.3f} Mpaths/s), fwd+bwd / fwd {rec['fwd_bwd_over_fwd']:.2f}; peak memory "
          f"{rec['peak_gib']} GiB above what was allocated before; K1 launches per step {rec['k1_per_step']} "
          f"(forward alone {k1_fwd}); samples completed {100 * rec['completed']:.2f}% ({smi})", flush=True)
    return rec


# The shading tables' gradient kernel (ops/shade.py::table_grad,
# csrc/table_grad.cu) at the fit's shapes: the wavefront of a 256x256 x 64
# fit (spp_par 8, parallel/mesh.py::fit_regen_split) over cornell_book3's 4
# materials and random_scene's ~480, one row (materials.param) and three
# (textures.color).  Its bound: each id (8 B) and gradient (4 B a row) read
# once, the table's gradient written once, at HBM_BYTES_PER_S.
TABLE_GRAD_N = 256 * 256 * 8
TABLE_GRAD_SHAPES = ((4, 1), (4, 3), (480, 1), (480, 3))  # (entries, rows)
TABLE_GRAD_REPS = 50
TABLE_GRAD_RTOL = 1e-5  # against the plain version in float64: the kernel sums in f32 in another order
FIT_SHAPE = (256, 256, 64)  # cornell_book3.fit's frame and samples per pixel (benchmark/configs/cornell_book3.py)


def table_grad_ids(n: int, t: int, gen):
    """Ids as a fit's wavefront gives them: over a small table 70% of the
    lanes on one entry (cornell_book3's white walls), else uniform."""
    import torch

    ids = torch.randint(0, t, (n,), generator=gen, device=gen.device)
    if t > 8:
        return ids
    return torch.where(torch.rand(n, generator=gen, device=gen.device) < 0.7, torch.full_like(ids, 2), ids)


def table_grad_at_shape(t: int, c: int, dev, smi: str) -> dict:
    """The kernel on TABLE_GRAD_N lanes of positive gradients into a table
    of ``t`` entries and ``c`` rows: equal bits on two launches, within
    TABLE_GRAD_RTOL of the plain version in float64, its time by CUDA
    events and by the profiler's device time, its bound, the plain
    version's time and ``index_put_(accumulate=True)``'s (the call
    PyTorch's backward of indexing makes) as ``library_ms``."""
    import torch

    from raytracer2022_tpu_torch.ops import shade

    n = TABLE_GRAD_N
    gen = torch.Generator(device=dev).manual_seed(10 * t + c)
    idx = table_grad_ids(n, t, gen)
    shape = (c, t) if c > 1 else (t,)
    g = torch.rand(shape[:-1] + (n,), generator=gen, device=dev)
    before = shade.TABLE_GRAD_LAUNCHES
    got = shade.table_grad(g, idx, shape)
    again = shade.table_grad(g, idx, shape)
    torch.cuda.synchronize()
    assert shade.TABLE_GRAD_LAUNCHES == before + 2, "table_grad did not count its launches"
    assert torch.equal(got, again), f"table_grad ({c}, {t}): two launches on the same inputs differ"
    want = shade.table_grad_plain(g.double(), idx, shape)
    rel = float(((got.double() - want).abs() / want.abs().clamp_min(1e-30)).max())
    assert rel <= TABLE_GRAD_RTOL, f"table_grad ({c}, {t}): relative error {rel:.3g} against the plain version"

    def kernel():
        shade.table_grad(g, idx, shape)

    lib_idx = [idx] if c == 1 else [None, idx]
    rec = {"n": n, "rows": c, "entries": t, "rel_err": rel,
           "ms": _time_cuda(kernel, TABLE_GRAD_REPS),
           "device_ms": _device_ms(kernel, TABLE_GRAD_REPS, match="table_grad"),
           "plain_ms": _time_cuda(lambda: shade.table_grad_plain(g, idx, shape), TABLE_GRAD_REPS),
           "library_ms": _time_cuda(lambda: torch.ops.aten.index_put_(torch.zeros(shape, device=dev), lib_idx, g,
                                                                       True), TABLE_GRAD_REPS),
           "bytes": n * 8 + n * c * 4 + c * t * 4}
    rec["bound_ms"] = rec["bytes"] / HBM_BYTES_PER_S * 1e3
    rec["share_of_bound"] = rec["bound_ms"] / rec["device_ms"]
    print(f"table_grad {n} lanes into ({c}, {t}): {rec['ms']:.4f} ms a call by events, {rec['device_ms']:.4f} ms "
          f"of device time ({100 * rec['share_of_bound']:.1f}% of its bound {1e3 * rec['bound_ms']:.2f} us, "
          f"bytes); plain version {rec['plain_ms']:.4f} ms, index_put_(accumulate=True) {rec['library_ms']:.4f} "
          f"ms; relative error {rel:.3g} against float64, two launches bit-equal ({smi})", flush=True)
    return rec


def count_table_grads(run) -> dict:
    """``run() -> (loss, leaves)``: the gathers through ``gather_table``
    while ``run`` builds the loss (``gathers``) and while the backward
    recomputes its checkpoints (``recomputed``), the calls of
    ``table_grad`` (``differentiated``) and ``TABLE_GRAD_LAUNCHES``
    (``launches``) while ``torch.autograd.grad`` takes the leaves'
    gradients."""
    import torch

    from raytracer2022_tpu_torch.ops import shade

    calls = {"gathers": 0, "differentiated": 0}
    gather, grad = shade.gather_table, shade.table_grad

    def counting_gather(table, idx):
        calls["gathers"] += 1
        return gather(table, idx)

    def counting_grad(*args):
        calls["differentiated"] += 1
        return grad(*args)

    shade.gather_table, shade.table_grad = counting_gather, counting_grad
    try:
        loss, leaves = run()
        forward = calls["gathers"]
        before = shade.TABLE_GRAD_LAUNCHES
        torch.autograd.grad(loss, leaves, allow_unused=True)
        launches = shade.TABLE_GRAD_LAUNCHES - before
    finally:
        shade.gather_table, shade.table_grad = gather, grad
    return {"gathers": forward, "recomputed": calls["gathers"] - forward,
            "differentiated": calls["differentiated"], "launches": launches}


def fit_loss_run(bundle, cam, shape, n_iters: int, seed: int = 0):
    """``run`` for :func:`count_table_grads`: ``fit_step_fn``'s regeneration
    loss against a black target over ``shape`` (width, height, spp), with
    ``materials.param`` and ``textures.color`` as the leaves."""
    import torch

    from raytracer2022_tpu_torch.parallel.mesh import fit_regen_split, with_params
    from raytracer2022_tpu_torch.render.integrator import TraceConfig
    from raytracer2022_tpu_torch.render.renderer import render_batch_regen_diff

    width, height, spp = shape
    scene = bundle.scene

    def run():
        leaves = [scene.materials.param.detach().requires_grad_(), scene.textures.color.detach().requires_grad_()]
        spp_par, spp_seq = fit_regen_split(spp)
        img, cnt = render_batch_regen_diff(with_params(scene, *leaves), cam, seed, width, height, spp_par, spp_seq,
                                           n_iters, TraceConfig(max_depth=DEPTH, background=bundle.background))
        return torch.mean((img / torch.clamp(cnt, min=1)[None]) ** 2), leaves

    return run


def table_grad_fit_step(bundle, cam, smi: str) -> dict:
    """The kernel in a ``cornell_book3``-shaped regeneration fit step
    (FIT_SHAPE, depth 50, ``regen_iters_estimate``'s trip count): every
    gather the backward differentiated launched it once (the last
    iterations' gathers of ``materials.param`` reach no loss term, and
    autograd leaves them out); then
    ``TABLE_GRAD_LAUNCHES`` over one ``fit_step_fn`` step and the median
    step time of three after a warm-up."""
    import time

    import torch

    from raytracer2022_tpu_torch.ops import shade
    from raytracer2022_tpu_torch.parallel.mesh import fit_regen_split, fit_step_fn
    from raytracer2022_tpu_torch.render.renderer import RenderConfig, regen_iters_estimate

    width, height, spp = FIT_SHAPE
    rc = RenderConfig(width=width, height=height, spp=spp, max_depth=DEPTH, background=bundle.background)
    n_iters = regen_iters_estimate(bundle.scene, cam, width, height, *fit_regen_split(spp), rc.trace_cfg())
    counts = count_table_grads(fit_loss_run(bundle, cam, FIT_SHAPE, n_iters))
    assert counts["launches"] == counts["differentiated"] > 0, \
        f"the fit's backward did not launch table_grad once a gather it differentiated: {counts}"
    step = fit_step_fn(rc, regen_iters=n_iters)
    target = torch.zeros((3, height, width), device=bundle.scene.device)
    scene, cam_k = bundle.scene, cam
    times = []
    for k in range(4):
        before = shade.TABLE_GRAD_LAUNCHES
        t0 = time.perf_counter()
        scene, cam_k, loss = step(scene, cam_k, target, k)
        float(loss)  # the step's end
        times.append(time.perf_counter() - t0)
        per_step = shade.TABLE_GRAD_LAUNCHES - before
    rec = dict(counts, regen_iters=n_iters, launches_per_step=per_step, step_s=float(np.median(times[1:])))
    assert per_step == counts["launches"], f"fit_step_fn launched table_grad {per_step} times, the loss {counts}"
    print(f"table_grad in a cornell_book3-shaped fit step ({width}x{height} x {spp}, {n_iters} iterations): "
          f"{counts['differentiated']} of {counts['gathers']} gathers differentiated ({counts['recomputed']} "
          f"recomputed), {counts['launches']} launches; fit_step_fn: {per_step} launches a step, median step "
          f"{rec['step_s']:.3f} s of 3 after a warm-up ({smi})", flush=True)
    return rec


def phase_diff(dev, smi) -> dict:
    """The differentiable path: K1 against the cluster walk under
    gradients, a central difference on the card, fwd+bwd at full width on
    cornell_box and on the stand-in mesh through K1, the fit step, the
    shading tables' gradient kernel at the fit's shapes and in a
    cornell_book3-shaped fit step, and the fit demo."""
    import dataclasses
    import time

    import torch

    from raytracer2022_tpu_torch import fit
    from raytracer2022_tpu_torch.cuda_build import build
    from raytracer2022_tpu_torch.ops import bvh8
    from raytracer2022_tpu_torch.render.camera import make_camera
    from raytracer2022_tpu_torch.render.integrator import TraceConfig
    from raytracer2022_tpu_torch.render.renderer import render_batch_regen_diff
    from raytracer2022_tpu_torch.scene.builder import SceneBuilder
    from raytracer2022_tpu_torch.scene.library import SceneBundle, cornell_box
    from raytracer2022_tpu_torch.scene.types import RECT
    from raytracer2022_tpu_torch.tools import bench

    out = {}
    t0 = time.perf_counter()
    log = build("table_grad.cu")[1]  # the first gradient below launches it
    print(f"table_grad kernel built in {time.perf_counter() - t0:.1f} s", flush=True)
    print_ptxas(log)
    # 1. K1 against the cluster walk: one gradient convention on the card
    scene, cam_kw = tri64_scene(SceneBuilder(), device=dev)
    cam = make_camera(**cam_kw, device=dev)
    bvh8.LAUNCHES = 0
    g_k1 = material_grad(scene, cam)
    k1_runs = bvh8.LAUNCHES
    g_walk = material_grad(dataclasses.replace(scene, bvh8=(None,)), cam)
    assert k1_runs > 0, "the material gradient never launched K1"
    assert np.isfinite(g_k1).all() and np.abs(g_k1).max() > 0
    np.testing.assert_allclose(g_k1, g_walk, rtol=MAT_RTOL, atol=MAT_ATOL)
    print(f"diff K1 vs cluster walk, 64-triangle scene material gradient: max |diff| "
          f"{np.abs(g_k1 - g_walk).max():.3g} (max |g| {np.abs(g_walk).max():.3g}; rtol {MAT_RTOL}, atol "
          f"{MAT_ATOL}), K1 launches {k1_runs}", flush=True)
    for label, build in (("sphere", geom_sphere_scene), ("triangle", geom_triangle_scene)):
        scene, cam_kw, col = build(SceneBuilder(), device=dev)
        cam = make_camera(**cam_kw, device=dev)
        bvh8.LAUNCHES = 0
        g_k1 = geometry_grad(scene, cam)
        k1_runs = bvh8.LAUNCHES
        assert k1_runs > 0, f"the {label} geometry gradient never launched K1"
        err = check_geometry_parity(g_k1, geometry_grad(dataclasses.replace(scene, bvh8=(None,)), cam))
        rows = (1, 3) if label == "sphere" else (1,)
        print(f"diff K1 vs cluster walk, {label} geometry gradient: max |diff| {err:.3g}, target rows "
              f"{[float(g_k1[r, col]) for r in rows]}, K1 launches {k1_runs}", flush=True)

    # 2. a central difference on the card: tests/test_grad.py:75-98
    b = SceneBuilder()
    light = b.rect_xz(-1, 1, -1, 1, 3.9, b.diffuse_light((8.0, 8.0, 8.0)))
    b.flip_face(light)
    b.add_light(light)
    b.rect_xz(-4, 4, -4, 4, 0.0, b.lambertian((0.6, 0.4, 0.3)))
    b.sphere((0, 1, 0), 1, b.lambertian((0.3, 0.5, 0.7)))
    mini = b.finalize(device=dev)
    mini_cam = make_camera((0, 2, -8), (0, 1, 0), (0, 1, 0), 40, 1.0, device=dev)
    mini_cfg = TraceConfig(max_depth=6, background=(0.0, 0.0, 0.0))

    def f(color):
        s = dataclasses.replace(mini, textures=dataclasses.replace(mini.textures, color=color))
        img, cnt = render_batch_regen_diff(s, mini_cam, 3, 12, 12, 4, 8, 4 * 6 + 1, mini_cfg)
        return torch.mean(img / cnt[None])

    floor_tex = int(mini.materials.tex[1])
    x = mini.textures.color.clone().requires_grad_()
    (g,) = torch.autograd.grad(f(x), x)
    e = torch.zeros_like(x)
    e[0, floor_tex] = 1e-2
    with torch.no_grad():
        fd = float((f(mini.textures.color + e) - f(mini.textures.color - e)) / 2e-2)
    g = float(g[0, floor_tex])
    print(f"diff central difference, mini-cornell floor albedo: gradient {g:.6g}, difference {fd:.6g} "
          f"(rtol 2e-2, atol 1e-5)", flush=True)
    np.testing.assert_allclose(g, fd, rtol=2e-2, atol=1e-5)
    assert g > 0

    # 3. bench.py's fwd+bwd cell on cornell_box
    bundle = cornell_box(device=dev)
    corn_cam = make_camera(**bundle.camera_kwargs, device=dev)
    corn = _fwd_bwd_cell("cornell_box", bundle, corn_cam, bench.FWD_BWD, ("materials.param", "textures.color"), smi)
    sc = bundle.scene
    tex = sc.materials.tex.cpu().numpy()
    light_tex = int(tex[int(np.argmax(sc.materials.kind.cpu().numpy() == 3))])
    # the floor: the RECT at y = 0 with constant axis y
    p = sc.params.cpu().numpy()
    floor = [i for i in range(sc.n_prims) if int(sc.kind[i]) == RECT and p[5, i] == 1 and p[4, i] == 0.0]
    floor_tex = int(tex[int(sc.mat_id[floor[0]])])
    g_color = corn["grads"][1]
    print(f"fwd+bwd cornell_box gradients: light emission {g_color[:, light_tex].tolist()}, floor albedo "
          f"{g_color[:, floor_tex].tolist()}", flush=True)
    assert (g_color[:, light_tex] > 0).all() and (g_color[:, floor_tex] > 0).all(), "cornell gradients not > 0"
    out["cornell"] = corn

    # 4. bench.py's OBJ fwd+bwd shape on the stand-in mesh through K1, its counts read around it
    b = SceneBuilder()
    cam_kw = stand_in_mesh_scene(b)
    mesh = SceneBundle(b.finalize(device=dev), cam_kw, (0.0, 0.0, 0.0), name="stand-in mesh")
    cam = make_camera(**cam_kw, device=dev)
    out["mesh"] = rec = _fwd_bwd_cell("stand-in mesh", mesh, cam, bench.FWD_BWD_OBJ._replace(scene=mesh.name),
                                      ("textures.color",), smi)
    assert rec["k1_per_step"] > rec["k1_per_forward"] > 0, "the mesh fwd+bwd did not launch K1 in its recompute"

    # 5. bench.py's fit step (fixed-depth trace)
    cell = bench.FIT_STEP
    out["fit_step_s"] = bench.median_time(bench.fit_fn(bundle, corn_cam, cell), cell.reps, dev)[0]
    print(f"fit step {cell.width}x{cell.height} x {cell.spp_seq} spp, depth {cell.depth}: median "
          f"{out['fit_step_s']:.3f} s of {cell.reps} after a warm-up ({smi})", flush=True)

    # 6. the shading tables' gradient kernel
    out["table_grad"] = {f"{c}x{t}": table_grad_at_shape(t, c, dev, smi) for t, c in TABLE_GRAD_SHAPES}
    out["table_grad_fit"] = table_grad_fit_step(bundle, corn_cam, smi)

    # 7. the fit demo through the regeneration integrator
    t0 = time.perf_counter()
    rc = fit.main(["--regen"])
    out["fit_demo_s"] = time.perf_counter() - t0
    print(f"fit demo --regen: exit {rc}, {out['fit_demo_s']:.1f} s ({smi})", flush=True)
    assert rc == 0, "the fit demo did not recover the parameters"
    return out


MIS_LANES = 261_120  # a wwscene.frame strip's lanes: 2560 x 102
MIS_REPS = 50
MIS_RTOL = 1e-5  # the kernel against its plain version on the card, same variates
MIS_FRAMES = {"wwscene": (2560, 1440), "cornell_box_book": (600, 600)}  # the benchmark's frames


def _max0(x) -> float:
    """The largest entry of ``x``, 0 for an empty tensor."""
    return float(x.max()) if x.numel() else 0.0


def mis_at_first_vertex(name: str, bundle, dev, smi: str) -> dict:
    """The sampling kernel on the first vertex of ``name``'s frame: the
    hit points and normals of MIS_LANES camera rays spread over it, one
    variate block; the kernel against its plain version on the hit lanes
    (NaN on the same lanes, directions within MIS_RTOL of their norm, pdfs
    within MIS_RTOL relative), its device time by the profiler beside its
    byte bound, and the plain version's time by CUDA events."""
    import torch

    from raytracer2022_tpu_torch.ops import mis
    from raytracer2022_tpu_torch.ops.intersect import closest_hit
    from raytracer2022_tpu_torch.render.camera import make_camera
    from raytracer2022_tpu_torch.render.renderer import _regen_gen_rays

    width, height = MIS_FRAMES[name]
    scene = bundle.scene
    cam = make_camera(**bundle.camera_kwargs, device=dev)
    gen = torch.Generator(device=dev).manual_seed(20)
    pix = torch.arange(MIS_LANES, device=dev) * max(width * height // MIS_LANES, 1) % (width * height)
    with torch.no_grad():
        o, d, tm = _regen_gen_rays(cam, width, height)(gen, pix)
        hit, _ = closest_hit(scene, o, d, tm, T_MIN, float("inf"), gen, False)
    p, nrm = hit.p.contiguous(), hit.normal.contiguous()
    k = mis.variate_rows(len(scene.stats.light_ids))
    u = torch.rand((k, MIS_LANES), generator=gen, device=dev)
    before = mis.LAUNCHES
    got = mis.mis_sample(scene, p, nrm, u)
    want = mis.mis_sample_plain(scene, p, nrm, u)
    torch.cuda.synchronize()
    assert mis.LAUNCHES == before + 1, "mis_sample did not count its launch"
    on = hit.hit
    nan = torch.isnan(want[1])
    assert torch.equal(torch.isnan(got[1])[on], nan[on]), f"{name}: the kernel's NaN pdfs are not the plain version's"
    ok = on & ~nan
    dir_abs = (got[0] - want[0]).abs()[:, on]
    dir_rel = ((got[0] - want[0]).norm(dim=0) / want[0].norm(dim=0))[on]
    pdf_abs = (got[1] - want[1]).abs()[ok]
    pdf_rel = pdf_abs / want[1].abs()[ok].clamp_min(1e-30)
    rec = {"lanes": MIS_LANES, "hit_lanes": int(on.sum()), "nan_pdf_lanes": int((nan & on).sum()), "rows": k,
           "dir_max_abs_err": _max0(dir_abs), "dir_max_rel_err": _max0(dir_rel),
           "pdf_max_abs_err": _max0(pdf_abs), "pdf_max_rel_err": _max0(pdf_rel),
           "dir_bit_equal_share": float((got[0] == want[0]).all(dim=0)[on].float().mean()),
           "pdf_bit_equal_share": float((got[1] == want[1])[ok].float().mean())}
    assert rec["dir_max_rel_err"] <= MIS_RTOL and rec["pdf_max_rel_err"] <= MIS_RTOL, f"{name}: {rec}"

    def kernel():
        mis.mis_sample(scene, p, nrm, u)

    rec.update(ms=_time_cuda(kernel, MIS_REPS), device_ms=_device_ms(kernel, MIS_REPS, match="mis_sample"),
               plain_ms=_time_cuda(lambda: mis.mis_sample_plain(scene, p, nrm, u), MIS_REPS),
               bytes=MIS_LANES * (12 + 12 + 4 * k + 16))
    rec["bound_ms"] = rec["bytes"] / HBM_BYTES_PER_S * 1e3
    rec["share_of_bound"] = rec["bound_ms"] / rec["device_ms"]
    print(f"mis_sample {name} first vertex, {MIS_LANES} lanes ({rec['hit_lanes']} hit, {k} variate rows): max abs "
          f"err dir {rec['dir_max_abs_err']:.3g} pdf {rec['pdf_max_abs_err']:.3g}, max rel err dir "
          f"{rec['dir_max_rel_err']:.3g} pdf {rec['pdf_max_rel_err']:.3g}, bit-equal dir "
          f"{rec['dir_bit_equal_share']:.5f} pdf {rec['pdf_bit_equal_share']:.5f}; {rec['ms']:.4f} ms a call by "
          f"events, {1e3 * rec['device_ms']:.2f} us of device time ({100 * rec['share_of_bound']:.1f}% of its "
          f"bound {1e3 * rec['bound_ms']:.2f} us, bytes); plain version {rec['plain_ms']:.4f} ms ({smi})", flush=True)
    return rec


def launches_in_a_frame(name: str, bundle, dev, smi: str, spp: int = 2) -> dict:
    """Launches of the vertex's kernels in a logged ``render_sum_n`` of
    ``name``'s frame at ``spp`` samples: ``csrc/vertex.cu`` once a vertex,
    so the ``vertex.LAUNCHES`` it adds equal the launch records'
    ``vertex.shading`` spans, and ``csrc/mis_sample.cu`` alone never (the
    vertex's kernel takes the mixture sample; no ``vertex.sampling`` span
    is left)."""
    import time

    import torch

    from raytracer2022_tpu_torch.ops import mis, vertex
    from raytracer2022_tpu_torch.render.camera import make_camera
    from raytracer2022_tpu_torch.render.renderer import RenderConfig, render_sum_n

    width, height = MIS_FRAMES[name]
    cam = make_camera(**bundle.camera_kwargs, device=dev)
    cfg = RenderConfig(width=width, height=height, spp=spp, max_depth=DEPTH, background=bundle.background)
    log: list = []
    before, mis_before = vertex.LAUNCHES, mis.LAUNCHES
    t0 = time.perf_counter()
    render_sum_n(bundle.scene, cam, cfg, launch_log=log)
    torch.cuda.synchronize()
    rec = {"launches": vertex.LAUNCHES - before, "mis_launches": mis.LAUNCHES - mis_before,
           "seconds": time.perf_counter() - t0, "spp": spp,
           "vertices": sum(e["span_calls"]["vertex.shading"] for e in log),
           "sampling_spans": sum(e["span_calls"].get("vertex.sampling", 0) for e in log)}
    assert rec["launches"] == rec["vertices"] > 0 and rec["mis_launches"] == rec["sampling_spans"] == 0, \
        f"{name}: {rec}"
    print(f"vertex kernel in a {name} render {width}x{height} x {spp} spp: {rec['launches']} launches, one a "
          f"vertex of the launch records; mis_sample alone {rec['mis_launches']} ({rec['seconds']:.2f} s) ({smi})",
          flush=True)
    return rec


def launches_in_a_fit_step(bundle, dev, smi: str) -> dict:
    """The vertex's kernels over one ``cornell_book3``-shaped fit step
    (FIT_SHAPE, depth 50): none, the render runs with gradients; its trip
    count's estimate, under ``no_grad``, takes ``csrc/vertex.cu``.  Counts
    are [vertex, mis_sample]."""
    import torch

    from raytracer2022_tpu_torch.ops import mis, vertex
    from raytracer2022_tpu_torch.parallel.mesh import fit_regen_split, fit_step_fn
    from raytracer2022_tpu_torch.render.camera import make_camera
    from raytracer2022_tpu_torch.render.renderer import RenderConfig, regen_iters_estimate

    def counts():
        return vertex.LAUNCHES, mis.LAUNCHES

    width, height, spp = FIT_SHAPE
    cam = make_camera(**bundle.camera_kwargs, device=dev)
    rc = RenderConfig(width=width, height=height, spp=spp, max_depth=DEPTH, background=bundle.background)
    before = counts()
    n_iters = regen_iters_estimate(bundle.scene, cam, width, height, *fit_regen_split(spp), rc.trace_cfg())
    rec = {"regen_iters": n_iters, "estimate_launches": [a - b for a, b in zip(counts(), before)]}
    step = fit_step_fn(rc, regen_iters=n_iters)
    before = counts()
    _, _, loss = step(bundle.scene, cam, torch.zeros((3, height, width), device=dev), 0)
    float(loss)
    rec["launches_per_step"] = [a - b for a, b in zip(counts(), before)]
    assert rec["launches_per_step"] == [0, 0] and rec["estimate_launches"][0] > 0 == rec["estimate_launches"][1], \
        f"a fit step launched a vertex kernel: {rec}"
    print(f"vertex / mis_sample kernels in a cornell_book3-shaped fit step ({width}x{height} x {spp}, {n_iters} "
          f"iterations): {rec['launches_per_step']} launches a step, {rec['estimate_launches']} in the trip count's "
          f"estimate ({smi})", flush=True)
    return rec


def phase_sampling(dev, smi) -> dict:
    """The vertex's sampling kernel (``csrc/mis_sample.cu``): its build, and
    on wwscene (stand-in assets) and cornell_box_book (book 3's Cornell
    box, the benchmark's cornell_book3) the kernel against its plain version
    at the first vertex.  Renders take the mixture sample inside the
    vertex's kernel, which shares this kernel's lane code: phase ``vertex``
    counts that this one launches in none of them."""
    import os
    import tempfile
    import time

    from raytracer2022_tpu_torch.cuda_build import build
    from raytracer2022_tpu_torch.scene.library import SCENES

    t0 = time.perf_counter()
    log = build("mis_sample.cu")[1]
    print(f"mis_sample kernel built in {time.perf_counter() - t0:.1f} s", flush=True)
    print_ptxas(log)
    out = {}
    with tempfile.TemporaryDirectory() as tmp, source_dir_env(os.path.join(tmp, "source")) as src:
        write_stand_in_assets(src)
        for name in MIS_FRAMES:
            out[name] = mis_at_first_vertex(name, SCENES[name](device=dev), dev, smi)
    return out


VERTEX_RTOL = 2e-5  # the vertex's kernel against its plain version on the card, same block
VERTEX_OUTPUTS = ("radiance_add", "o", "d", "tm", "throughput")
VERTEX_WRITE_BYTES = 53  # radiance, origin, direction, throughput 12 B each, time 4, cont 1
# bytes a lane reads besides the variates: hit 1, p 12, normal 12, front 1,
# material kind and parameter 8, texture kind 4, ray 12, time 4, throughput 12, alive 1
VERTEX_READ_BYTES = 67
# and by its texture kind: a colour (solid, checker: the picked one), the
# noise scale, uv and atlas id and size and a texel (image, OBJ uv)
VERTEX_TEXTURE_BYTES = {"solid": 12, "checker": 12, "noise": 4, "image": 24, "objuv": 24}


def vertex_bytes(scene, shade, rows: int) -> int:
    """The bytes ``csrc/vertex.cu`` moves at least in one launch over the
    lanes of ``shade``: each input read once (a lane's record, its ``rows``
    variates and its texture kind's inputs; the lights list and the Perlin
    tables), each output written once."""
    from raytracer2022_tpu_torch.scene.types import TEX_CHECKER, TEX_IMAGE, TEX_NOISE, TEX_OBJUV

    n = shade.tex_kind.shape[0]
    features = scene.stats.features
    kinds = {"checker": TEX_CHECKER, "noise": TEX_NOISE, "image": TEX_IMAGE, "objuv": TEX_OBJUV}
    textured = {name: int((shade.tex_kind == k).sum()) if name in features else 0 for name, k in kinds.items()}
    tex = sum(VERTEX_TEXTURE_BYTES[name] * c for name, c in textured.items())
    tex += VERTEX_TEXTURE_BYTES["solid"] * (n - sum(textured.values()))
    tables = 28 * len(scene.stats.light_ids) + (6 * 256 * 4 if "noise" in features else 0)
    return n * (VERTEX_READ_BYTES + 4 * rows + VERTEX_WRITE_BYTES) + tex + tables


def vertex_at_first_vertex(name: str, bundle, dev, smi: str) -> dict:
    """The vertex's kernel on the first vertex of ``name``'s frame: the hit
    records of MIS_LANES camera rays spread over it, one variate block; the
    kernel against its plain version on every lane (``cont`` equal, each
    output's max abs error and bit-equal share), its device time by the
    profiler beside its byte bound, and its and the plain version's time a
    call by CUDA events."""
    import torch

    from raytracer2022_tpu_torch.ops import vertex
    from raytracer2022_tpu_torch.ops.intersect import closest_hit
    from raytracer2022_tpu_torch.render.camera import make_camera
    from raytracer2022_tpu_torch.render.integrator import TraceConfig
    from raytracer2022_tpu_torch.render.renderer import _regen_gen_rays

    width, height = MIS_FRAMES[name]
    scene = bundle.scene
    cam = make_camera(**bundle.camera_kwargs, device=dev)
    cfg = TraceConfig(max_depth=DEPTH, background=bundle.background)
    gen = torch.Generator(device=dev).manual_seed(21)
    pix = torch.arange(MIS_LANES, device=dev) * max(width * height // MIS_LANES, 1) % (width * height)
    with torch.no_grad():
        o, d, tm = _regen_gen_rays(cam, width, height)(gen, pix)
        hit, shade = closest_hit(scene, o, d, tm, T_MIN, float("inf"), gen, False)
    th = torch.ones((3, MIS_LANES), device=dev)
    alive = torch.ones(MIS_LANES, dtype=torch.bool, device=dev)
    rows = vertex.variate_rows(len(scene.stats.light_ids))
    u = torch.rand((rows, MIS_LANES), generator=gen, device=dev)
    want = dict(vertex._inputs(scene, hit, shade, d, tm, th, alive), var=(u, torch.float32, tuple(u.shape)))
    before = vertex.LAUNCHES
    with torch.no_grad():
        got = vertex._vertex_cuda(scene, cfg, want)
        ref = vertex.vertex_tail_plain(scene, cfg, hit, shade, d, tm, th, alive, u)
    torch.cuda.synchronize()
    assert vertex.LAUNCHES == before + 1, "the vertex kernel did not count its launch"
    assert torch.equal(got.cont, ref.cont), f"{name}: the kernel's cont is not the plain version's"
    rec = {"lanes": MIS_LANES, "hit_lanes": int(hit.hit.sum()), "continued": int(got.cont.sum()), "rows": rows,
           "features": sorted(scene.stats.features)}
    for key in VERTEX_OUTPUTS:
        g, w = getattr(got, key), getattr(ref, key)
        assert torch.equal(torch.isnan(g), torch.isnan(w)), f"{name}: {key}'s NaN lanes differ"
        diff = (torch.nan_to_num(g) - torch.nan_to_num(w)).abs()
        scale = w.abs() if w.dim() == 1 else w.norm(dim=0)
        rel = (diff if w.dim() == 1 else diff.norm(dim=0)) / torch.nan_to_num(scale).clamp_min(1e-30)
        same = (g == w) | (torch.isnan(g) & torch.isnan(w))
        rec[key] = {"max_abs_err": _max0(diff), "max_rel_err": _max0(rel),
                    "bit_equal_share": float((same if w.dim() == 1 else same.all(dim=0)).float().mean())}
        assert rec[key]["max_rel_err"] <= VERTEX_RTOL, f"{name}: {key} {rec[key]}"

    def kernel():
        vertex._vertex_cuda(scene, cfg, want)

    with torch.no_grad():
        rec.update(ms=_time_cuda(kernel, MIS_REPS), device_ms=_device_ms(kernel, MIS_REPS, match="vertex_kernel"),
                   plain_ms=_time_cuda(lambda: vertex.vertex_tail_plain(scene, cfg, hit, shade, d, tm, th, alive, u),
                                       MIS_REPS),
                   bytes=vertex_bytes(scene, shade, rows))
    rec["bound_ms"] = rec["bytes"] / HBM_BYTES_PER_S * 1e3
    rec["share_of_bound"] = rec["bound_ms"] / rec["device_ms"]
    errs = ", ".join(f"{k} {rec[k]['max_abs_err']:.3g} ({rec[k]['bit_equal_share']:.5f} bit-equal)"
                     for k in VERTEX_OUTPUTS)
    print(f"vertex {name} first vertex, {MIS_LANES} lanes ({rec['hit_lanes']} hit, {rec['continued']} continue, "
          f"{rows} variate rows, features {rec['features']}): max abs err {errs}; {rec['ms']:.4f} ms a call by "
          f"events, {1e3 * rec['device_ms']:.2f} us of device time ({100 * rec['share_of_bound']:.1f}% of its "
          f"bound {1e3 * rec['bound_ms']:.2f} us, {rec['bytes']} B); plain version {rec['plain_ms']:.4f} ms ({smi})",
          flush=True)
    return rec


def phase_vertex(dev, smi) -> dict:
    """The vertex's kernel after its closest hit (``csrc/vertex.cu``): its
    build, and on wwscene (stand-in assets) and cornell_box_book (the
    benchmark's cornell_book3) the kernel against its plain version at the
    first vertex, with its time and byte bound, and its launches in a frame
    render (one a ``vertex.shading`` span; ``mis_sample`` alone none); and
    none in a fit step."""
    import os
    import tempfile
    import time

    from raytracer2022_tpu_torch.cuda_build import build
    from raytracer2022_tpu_torch.scene.library import SCENES

    t0 = time.perf_counter()
    log = build("vertex.cu")[1]
    print(f"vertex kernel built in {time.perf_counter() - t0:.1f} s", flush=True)
    print_ptxas(log)
    out = {}
    with tempfile.TemporaryDirectory() as tmp, source_dir_env(os.path.join(tmp, "source")) as src:
        write_stand_in_assets(src)
        for name in MIS_FRAMES:
            bundle = SCENES[name](device=dev)
            out[name] = dict(vertex_at_first_vertex(name, bundle, dev, smi),
                             frame=launches_in_a_frame(name, bundle, dev, smi))
    out["fit"] = launches_in_a_fit_step(SCENES["cornell_box_book"](device=dev), dev, smi)
    return out


MULTI_TIMEOUT_S = 300  # each launch of phase multi; a rank that fails ends it at once
MULTI_FIT_STEPS = 4  # one warm-up, then the median of 3


def _launch(n: int, task: str, device: str, backend: str, out: str, *extra) -> list:
    """``n`` ranks of the port's worker on ``device`` over ``backend``
    (parallel/worker.py) -> each rank's results; raises if any rank fails."""
    import sys

    from raytracer2022_tpu_torch.parallel.worker import launch_local, rank_path

    launch_local(n, [sys.executable, "-m", "raytracer2022_tpu_torch.parallel.worker", "--device", device,
                     "--backend", backend, "--task", task, "--out", out, *extra], MULTI_TIMEOUT_S)
    res = []
    for k in range(n):
        with np.load(rank_path(out, k)) as f:
            res.append({key: f[key] for key in f.files})
    return res


def _mesh_args() -> list:
    """The worker's arguments for the stand-in mesh at 600x600 x SPP, depth 50."""
    return ["--scene", "chip_smoke:stand_in_mesh_scene", "--width", str(WIDTH), "--height", str(HEIGHT),
            "--spp", str(SPP), "--depth", str(DEPTH)]


def _sharded_mesh_render(label: str, n: int, device: str, backend: str, out: str, ref_means, smi: str) -> dict:
    """The stand-in mesh, 600x600 x SPP, depth 50, through
    render_sharded_regen_sum on ``n`` ranks: the rate by rank 0's wall
    from a barrier to after the all_reduce, each rank's K1 launches and
    regeneration iterations, their work-normalised efficiency
    mean(iters) / max(iters), every rank's sum identical, and the channel
    means against the one-process render's (``ref_means``)."""
    res = _launch(n, "regen", device, backend, out, *_mesh_args())
    spp = int(res[0]["n"])
    iters = [int(r["iters"].sum()) for r in res]
    k1 = [int(r["k1_launches"]) for r in res]
    means = (res[0]["sum"] / spp).mean(axis=(1, 2)).astype(np.float64)
    rel = _rel(means, ref_means)
    rec = {"world": n, "device": device, "backend": backend, "spp": spp, "seconds": float(res[0]["seconds"]),
           "mpaths": WIDTH * HEIGHT * spp / float(res[0]["seconds"]) / 1e6, "k1": k1, "iters": iters,
           "iters_by_strip": [r["iters"].tolist() for r in res], "efficiency": float(np.mean(iters)) / max(iters),
           "rank_seconds": [float(r["seconds"]) for r in res], "channel_means": means.tolist()}
    print(f"multi {label}: stand-in mesh {WIDTH}x{HEIGHT} x {spp} spp, depth {DEPTH}, {n} rank(s) on {device} over "
          f"{backend}: {rec['seconds']:.3f} s (rank 0, barrier to all_reduce), {rec['mpaths']:.3f} Mpaths/s; "
          f"K1 launches by rank {k1}; iterations by rank {iters} (by strip {rec['iters_by_strip']}), "
          f"mean/max {rec['efficiency']:.4f}; channel means {means.round(4).tolist()} vs one process "
          f"{np.round(ref_means, 4).tolist()} (rel {rel.round(4).tolist()}) ({smi})", flush=True)
    assert all(np.array_equal(r["sum"], res[0]["sum"]) for r in res), f"{label}: the ranks' sums differ"
    assert all(k > 0 for k in k1), f"{label}: a rank never launched K1"
    assert np.isfinite(means).all() and (rel < MAX_REL).all(), f"{label}: the sharded render disagrees"
    return rec


def phase_multi(dev, smi, mesh_means, one_device_fwd_bwd_s: float) -> dict:
    """Several processes through parallel/worker.py: the stand-in mesh
    render sharded over 1 rank (NCCL) and 2 ranks on one card (gloo); the
    sharded fit step at the fwd+bwd cornell cell's size on 2 ranks of one
    card; the dry run on 2 ranks of one card; and, where two cards are
    visible, :func:`phase_multi_cards`."""
    import os
    import tempfile

    import torch

    from raytracer2022_tpu_torch.tools.bench import FWD_BWD as cell

    n_cards = torch.cuda.device_count()
    out = {"cards": n_cards}
    with tempfile.TemporaryDirectory() as tmp:
        out["world1_nccl"] = _sharded_mesh_render("world 1", 1, "cuda:0", "nccl", os.path.join(tmp, "w1.npz"),
                                                  mesh_means, smi)
        out["world2_gloo"] = w2 = _sharded_mesh_render("world 2, one card", 2, "cuda:0", "gloo",
                                                       os.path.join(tmp, "w2.npz"), mesh_means, smi)
        print(f"multi: world 2 on one card at {w2['mpaths'] / out['world1_nccl']['mpaths']:.3f}x world 1's rate "
              f"(time-sliced on one card, not scaling across cards) ({smi})", flush=True)

        res = _launch(2, "fit_regen", "cuda:0", "gloo", os.path.join(tmp, "fit.npz"), "--scene", "cornell_box",
                      "--width", str(cell.width), "--height", str(cell.height), "--spp",
                      str(cell.spp_par * cell.spp_seq), "--depth", str(cell.depth), "--steps", str(MULTI_FIT_STEPS))
        assert all(np.array_equal(r["params"], res[0]["params"]) for r in res), "fit: the ranks' parameters differ"
        assert all(np.array_equal(r["loss"], res[0]["loss"]) for r in res) and np.isfinite(res[0]["loss"]).all()
        step_s = res[0]["step_seconds"].tolist()
        out["fit"] = fit = {"regen_iters": int(res[0]["regen_iters"]), "step_seconds": step_s,
                            "median_s": float(np.median(step_s[1:])), "loss": res[0]["loss"].tolist(),
                            "k1": [int(r["k1_launches"]) for r in res], "one_device_fwd_bwd_s": one_device_fwd_bwd_s}
        print(f"multi fit: cornell_box {cell.width}x{cell.height} x {cell.spp_par * cell.spp_seq} spp, depth "
              f"{cell.depth}, "
              f"2 ranks on cuda:0 over gloo, regen_iters {fit['regen_iters']}: step median {fit['median_s']:.3f} s "
              f"of {MULTI_FIT_STEPS - 1} after a warm-up (all {np.round(step_s, 3).tolist()}), losses "
              f"{np.round(fit['loss'], 6).tolist()}, parameters bit-identical on both ranks after every step; "
              f"one-device fwd+bwd step of phase diff {one_device_fwd_bwd_s:.3f} s ({smi})", flush=True)

        res = _launch(2, "dryrun", "cuda:0", "gloo", os.path.join(tmp, "dry.npz"))
        out["dryrun_gloo"] = {"loss": res[0]["loss"].tolist(), "seconds": float(res[0]["seconds"])}
        print(f"multi dryrun (gloo, one card): exit 0 on both ranks, losses {res[0]['loss'].tolist()}", flush=True)
    if n_cards >= 2:
        out.update(phase_multi_cards(smi, mesh_means))
    else:
        out["cards_nccl"] = f"not run: {n_cards} card visible"
        print(f"multi over NCCL across two cards: not run, {n_cards} card visible", flush=True)
    return out


def phase_multi_cards(smi, mesh_means=None) -> dict:
    """Ranks on several cards over NCCL: the stand-in mesh render sharded
    over cards 0 and 1, the dry run on them, and the CLI's ``--sharded``,
    one rank per visible card.  Without ``mesh_means`` (run alone) the
    world-1 render on card 0 gives the reference channel means."""
    import os
    import tempfile
    import time

    import torch

    from raytracer2022_tpu_torch import cli
    from raytracer2022_tpu_torch.utils.imageio import read_png

    n_cards = torch.cuda.device_count()
    assert n_cards >= 2, f"phase_multi_cards needs two cards, {n_cards} visible"
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        if mesh_means is None:
            res = _launch(1, "regen", "cuda:0", "nccl", os.path.join(tmp, "w1.npz"), *_mesh_args())
            mesh_means = (res[0]["sum"] / int(res[0]["n"])).mean(axis=(1, 2)).astype(np.float64)
            print(f"multi world 1 (reference): channel means {mesh_means.round(4).tolist()}", flush=True)
        out["world2_nccl"] = _sharded_mesh_render("world 2, two cards", 2, "cuda", "nccl",
                                                  os.path.join(tmp, "n2.npz"), mesh_means, smi)
        res = _launch(2, "dryrun", "cuda", "nccl", os.path.join(tmp, "dry.npz"))
        out["dryrun_nccl"] = {"loss": res[0]["loss"].tolist(), "seconds": float(res[0]["seconds"])}
        print(f"multi dryrun (nccl, two cards): exit 0 on both ranks, losses {res[0]['loss'].tolist()}", flush=True)

        path = os.path.join(tmp, "sharded.png")
        t0 = time.perf_counter()
        rc = cli.main(["--scene", "cornell_box", "--width", str(WIDTH), "--height", str(HEIGHT), "--spp", str(SPP),
                       "--sharded", "--out", path, "--quiet"])
        dt = time.perf_counter() - t0
        png = read_png(path)
        assert rc == 0 and png.shape == (HEIGHT, WIDTH, 3) and png.mean() > 1.0, "cli --sharded: bad image"
        out["cli_sharded"] = {"ranks": n_cards, "seconds": dt, "png_mean": float(png.mean())}
        print(f"multi cli --sharded cornell_box {WIDTH}x{HEIGHT} x {SPP} spp: {n_cards} ranks, one a card, "
              f"{dt:.2f} s wall (rank start-up included), png mean {png.mean():.2f} ({smi})", flush=True)
    return out


def main(argv=None) -> int:
    import argparse
    import json
    import os
    import subprocess
    import sys
    import tempfile
    import time

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--spp", type=int, default=SPP, help="samples per pixel of the mesh and cornell_box renders")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card",
              file=sys.stderr)
        return 1
    # the port itself: without it (the script alone) this fails before any output
    from raytracer2022_tpu_torch import cli, native
    from raytracer2022_tpu_torch.cuda_build import build
    from raytracer2022_tpu_torch.ops import bvh8 as bvh8_mod
    from raytracer2022_tpu_torch.ops.bvh8 import traverse_bvh8, traverse_bvh8_plain
    from raytracer2022_tpu_torch.render.camera import make_camera
    from raytracer2022_tpu_torch.render.renderer import RenderConfig
    from raytracer2022_tpu_torch.scene.builder import SceneBuilder
    from raytracer2022_tpu_torch.utils.imageio import read_png

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(f"card: {smi} | torch {torch.__version__} cuda {torch.version.cuda} | {name}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    print("host runtime: " + (f"native SAH builder and C++ OBJ parser ({os.path.relpath(native.LIBRARY_PATH)})"
                              if native.available() else "NumPy builder and Python OBJ parser (no g++)"), flush=True)

    # --- phase 2: build K1
    t0 = time.perf_counter()
    so_path, log, secs = build("bvh8.cu")
    print(f"K1 build: {time.perf_counter() - t0:.2f} s (nvcc {secs:.2f} s) -> {os.path.relpath(so_path)}")
    print_ptxas(log)

    def to_dev(*xs):
        return [torch.as_tensor(x, device=dev) for x in xs]

    # --- phase 3a: all five kinds on small generated trees, three t_init
    # modes, both instantiations of the kernel
    rng = np.random.default_rng(1234)
    for kind, kname in enumerate(["SPHERE", "MSPHERE", "RECT", "TRIANGLE", "RING"]):
        tree = small_tree_scene(SceneBuilder(), kind, rng, device=dev).bvh8[0]
        o, d, tm = to_dev(*random_rays(rng, 4096, -30, 30))
        finite = torch.as_tensor(rng.uniform(5, 60, 4096).astype(np.float32), device=dev)
        for label, t_init in (("no t_init", None), ("+inf t_init", torch.full_like(tm, float("inf"))),
                              ("finite t_init", finite)):
            for mode in ("shared", "global"):
                with k1_tree_memory(mode):
                    ref, got = run_both(tree, kind, o, d, tm, t_init)
                assert bvh8_mod.TREE_MEMORY == mode, f"K1 ran {bvh8_mod.TREE_MEMORY}, not {mode}"
                rep = check_parity(kind, ref, got)
                print(f"K1 parity {kname:8s} {label:13s} {mode:6s}: hits {rep['hits']}, max|dt| "
                      f"{rep['max_abs_err']:.3g}, ids equal {rep['id_match']:.4f}", flush=True)

    # --- phase 3b: the stand-in mesh tree at the main path's width
    b = SceneBuilder()
    cam_kw = stand_in_mesh_scene(b)
    mesh = b.finalize(device=dev)
    assert mesh.n_prims == 13062 and mesh.stats.trees[0][0] == TRIANGLE, "unexpected stand-in mesh"
    tree = mesh.bvh8[0]
    print(f"stand-in mesh: {mesh.n_prims} prims, tree of {tree.prows.shape[0]} leaf rows, "
          f"{tree.entries.shape[0] // 8} groups", flush=True)
    cam = make_camera(**cam_kw, device=dev)
    o, d, tm, t_dense = mesh_rays(mesh, cam, rng)
    o_c, d_c, tm_c = (x[..., :LANES].contiguous() for x in (o, d, tm))
    reports = {}
    for label, t_init in (("dense t_init", t_dense), ("+inf t_init", torch.full_like(tm, float("inf")))):
        ref, got = run_both(tree, TRIANGLE, o, d, tm, t_init)
        reports[label] = rep = check_parity(TRIANGLE, ref, got)
        print(f"K1 parity mesh {o.shape[1]} rays, {label}: hits {rep['hits']}, "
              f"max|dt| {rep['max_abs_err']:.3g}, ids equal {rep['id_match']:.5f}", flush=True)

    # S1, one launch's shape: 262,144 camera rays, dense t_init, rows
    ti1 = t_dense[:LANES]
    p_ms = _time_cuda(lambda: traverse_bvh8_plain(tree, TRIANGLE, o_c, d_c, tm_c, T_MIN, ti1), 2)
    print(f"K1 plain version at {LANES} camera rays: {p_ms:.3f} ms ({smi})", flush=True)

    # --- phase 4a: a small render, card against the CPU (plain traversal)
    def small_mesh(device):
        sb = SceneBuilder()
        stand_in_mesh_scene(sb, 24, 12)  # 576 triangles: the CPU walks it by brute force
        return sb.finalize(device=device), make_camera(**cam_kw, device=device)

    card_vs_cpu(dev, "small-mesh render", small_mesh,
                RenderConfig(width=32, height=32, spp=64, max_depth=DEPTH, background=(0.0, 0.0, 0.0)))

    # --- phase 4b: the main path, the stand-in mesh through render_sum_n;
    # the rays of two of its K1 calls become S2
    cfg = RenderConfig(width=WIDTH, height=HEIGHT, spp=args.spp, max_depth=DEPTH,
                       background=(0.0, 0.0, 0.0))
    launch_log: list = []
    torch.cuda.synchronize()
    bvh8_mod.LAUNCHES = 0  # count only the main path's launches from here
    t0 = time.perf_counter()
    total, n, captured = render_capturing(mesh, cam, cfg, S2_CALLS, launch_log)
    torch.cuda.synchronize()
    dt_mesh = time.perf_counter() - t0
    mesh_launches = bvh8_mod.LAUNCHES
    img = (total / n).cpu().numpy()
    assert mesh_launches > 0, "the mesh render never launched K1"
    assert np.isfinite(img).all(), "mesh render has non-finite pixels"
    assert img.mean() > 1e-3, "mesh render is black"
    mpaths_mesh = WIDTH * HEIGHT * n / dt_mesh / 1e6
    print(f"mesh render {WIDTH}x{HEIGHT} x {n} spp, depth {DEPTH}: {dt_mesh:.2f} s, "
          f"{mpaths_mesh:.3f} Mpaths/s, K1 launches {mesh_launches}, "
          f"channel means {np.round(img.mean(axis=(1, 2)), 4).tolist()} ({smi})", flush=True)
    for i, rec in enumerate(launch_log):
        print(f"  launch {i}: {rec}")
    mesh_means = img.mean(axis=(1, 2)).astype(np.float64)

    # --- phase 4c: K1 at the main path's shapes.  S1: the camera rays of
    # phase 3b; S2: the main path's bounce rays; S3: final_scene's 1000
    # spheres with a packet tree on bounce-like rays
    o2, d2, tm2, ti2 = s2_rays(captured)
    for label, t_init in (("dense t_init", ti2), ("+inf t_init", torch.full_like(tm2, float("inf")))):
        ref, got = run_both(tree, TRIANGLE, o2, d2, tm2, t_init)
        reports["S2 " + label] = rep = check_parity(TRIANGLE, ref, got)
        print(f"K1 parity mesh S2 ({LANES} bounce rays of main-path calls {S2_CALLS}), {label}: hits "
              f"{rep['hits']}, max|dt| {rep['max_abs_err']:.3g}, ids equal {rep['id_match']:.5f}", flush=True)
    vrng = np.random.default_rng(99)
    for label, (o_s, d_s, tm_s, ti_s) in (("S1", (o_c, d_c, tm_c, ti1)), ("S2", (o2, d2, tm2, ti2))):
        visits = traverse_bvh8(tree, TRIANGLE, o_s, d_s, tm_s, T_MIN, t_init=ti_s, return_visits=True)[-1]
        check_visits(label, tree, TRIANGLE, o_s, d_s, tm_s, ti_s, visits, vrng)
    s3_scene, o3, d3, tm3 = sphere_tree_rays(dev)
    inf3 = torch.full_like(tm3, float("inf"))
    shapes = {
        "S1": (tree, TRIANGLE, o_c, d_c, tm_c, ti1, True),
        "S2": (tree, TRIANGLE, o2, d2, tm2, ti2, True),
        "S3": (s3_scene.bvh8[0], SPHERE, o3, d3, tm3, inf3, False),
    }
    k1 = {name: k1_at_shape(name, *shape, smi) for name, shape in shapes.items()}
    fits_groups = {depth: shared_fits_groups(bvh8_mod._kernel_lib(), depth)
                   for depth in sorted({s["depth"] for s in k1.values()} | {16, bvh8_mod.MAX_DEPTH})}
    print(f"K1 shared-memory instantiation, most groups by tree depth: {fits_groups} ({smi})", flush=True)

    # --- phase deep: the deepest tree the builder makes, and the perf tool
    t_phase = time.perf_counter()
    deep = phase_deep(dev, smi)
    print(f"[phase deep: {time.perf_counter() - t_phase:.1f} s]", flush=True)
    t_phase = time.perf_counter()
    perf_rec = phase_perf(smi)
    print(f"[phase perf: {time.perf_counter() - t_phase:.1f} s]", flush=True)
    t_phase = time.perf_counter()
    bench_rec = phase_bench(dev, smi)
    print(f"[phase bench: {time.perf_counter() - t_phase:.1f} s]", flush=True)

    # --- phase 5: cornell_box through the CLI
    before = bvh8_mod.LAUNCHES
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "cornell.png")
        t0 = time.perf_counter()
        rc = cli.main(["--scene", "cornell_box", "--width", str(WIDTH), "--height", str(HEIGHT),
                       "--spp", str(args.spp), "--out", out, "--quiet"])
        dt_cli = time.perf_counter() - t0
        assert rc == 0, f"cli returned {rc}"
        png = read_png(out)
    assert bvh8_mod.LAUNCHES == before, "cornell_box has no tree, yet K1 was launched"
    assert png.shape == (HEIGHT, WIDTH, 3), png.shape
    assert png.mean() > 1.0, "cornell render is black"
    mpaths_cli = WIDTH * HEIGHT * args.spp / dt_cli / 1e6
    print(f"cli cornell_box {WIDTH}x{HEIGHT} x {args.spp} spp: {dt_cli:.2f} s wall (scene build and "
          f"PNG write included), {mpaths_cli:.3f} Mpaths/s, png {png.shape} mean {png.mean():.2f} ({smi})",
          flush=True)

    # --- phases 6-10: this slice's scenes, schedules and integrators
    t_phase = time.perf_counter()
    final = phase_final_scene(dev, smi)
    print(f"[phase final_scene: {time.perf_counter() - t_phase:.1f} s]", flush=True)
    t_phase = time.perf_counter()
    phase_library(dev, smi)
    print(f"[phase library: {time.perf_counter() - t_phase:.1f} s]", flush=True)
    t_phase = time.perf_counter()
    assets = phase_assets(dev, smi)
    print(f"[phase assets: {time.perf_counter() - t_phase:.1f} s]", flush=True)
    t_phase = time.perf_counter()
    installed = phase_installed(dev, smi, assets)
    print(f"[phase installed: {time.perf_counter() - t_phase:.1f} s]", flush=True)
    t_phase = time.perf_counter()
    flag = phase_flagship(dev, smi)
    print(f"[phase flagship: {time.perf_counter() - t_phase:.1f} s]", flush=True)
    t_phase = time.perf_counter()
    sched = phase_schedules(dev, smi)
    print(f"[phase schedules: {time.perf_counter() - t_phase:.1f} s]", flush=True)
    t_phase = time.perf_counter()
    phase_sort_and_trace(dev, smi)
    print(f"[phase sort and trace: {time.perf_counter() - t_phase:.1f} s]", flush=True)
    t_phase = time.perf_counter()
    policy = phase_packet_policy(dev, smi, k1["S3"])
    print(f"[phase packet-tree policy: {time.perf_counter() - t_phase:.1f} s]", flush=True)
    t_phase = time.perf_counter()
    diff = phase_diff(dev, smi)
    print(f"[phase diff: {time.perf_counter() - t_phase:.1f} s]", flush=True)
    t_phase = time.perf_counter()
    sampling = phase_sampling(dev, smi)
    print(f"[phase sampling: {time.perf_counter() - t_phase:.1f} s]", flush=True)
    t_phase = time.perf_counter()
    vert = phase_vertex(dev, smi)
    print(f"[phase vertex: {time.perf_counter() - t_phase:.1f} s]", flush=True)
    t_phase = time.perf_counter()
    multi = phase_multi(dev, smi, mesh_means, diff["cornell"]["fwd_bwd_s"])
    print(f"[phase multi: {time.perf_counter() - t_phase:.1f} s]", flush=True)
    diff_keys = ("n_iters", "n_drain", "estimate_s", "fwd_bwd_s", "fwd_s", "fwd_bwd_mpaths", "fwd_mpaths",
                 "fwd_bwd_over_fwd", "peak_gib", "k1_per_step", "k1_per_forward", "completed")
    print(json.dumps({"summary": {
        "mesh_mpaths": mpaths_mesh, "cli_cornell_mpaths": mpaths_cli,
        "final_scene_mpaths": final["mpaths"], "final_scene_spp": final["spp"],
        "pixel_pool_mpaths": sched["pixel"], "quota_mpaths": sched["quota"],
        "cluster_walk_ms": policy["walk_ms"], "k1_sphere_ms": policy["k1_ms"],
        "fwd_bwd_cornell": {k: diff["cornell"][k] for k in diff_keys},
        "fwd_bwd_mesh": {k: diff["mesh"][k] for k in diff_keys},
        "fit_step_s": diff["fit_step_s"], "fit_demo_s": diff["fit_demo_s"], "multi": multi, "perf": perf_rec,
        "table_grad_fit": diff["table_grad_fit"],
        "deep_render_s": deep["render_s"],
        "bench": bench_rec["line"],
        "wwscene": {k: assets[k] for k in ("seconds", "mpaths", "wall_mpaths", "spp", "launches", "decode_s", "small_s")},
        "installed": installed,
        "flagship": {k: flag[k] for k in ("runs", "mae", "launches")},
        "card": smi,
    }}), flush=True)

    s1 = k1["S1"]
    kernels = [{
        "name": "bvh8_traverse",
        "route": "cuda",
        "source": "raytracer2022_tpu_torch/csrc/bvh8.cu",
        "replaces": "raytracer2022_tpu/ops/bvh8.py:540",
        "launches": mesh_launches,
        "launches_by_path": {"mesh": mesh_launches, "final_scene": final["k1"],
                             "mesh_fwd_bwd_step": diff["mesh"]["k1_per_step"],
                             "mesh_diff_forward": diff["mesh"]["k1_per_forward"],
                             "mesh_sharded_rank0": multi["world2_gloo"]["k1"][0],
                             "mesh_sharded_rank1": multi["world2_gloo"]["k1"][1],
                             "deep_mesh": deep["launches"], "wwscene": assets["launches"],
                             "installed_wwscene": installed["launches"],
                             "flagship": flag["launches"], "bench_obj": bench_rec["k1"]["obj"],
                             "bench_fwd_bwd_obj": bench_rec["k1"]["fwd_bwd_obj"]},
        "launches_per_mesh_render": mesh_launches,
        "launches_per_fwd_bwd_step": diff["mesh"]["k1_per_step"],
        "max_abs_err": max([r["max_abs_err"] for r in reports.values()] + [deep["max_abs_err"]]
                           + [r["max_abs_err"] for r in flag["parity"].values()]
                           + [r["max_abs_err"] for r in bench_rec["parity"].values()]),
        "ms": s1["ms"],
        "plain_ms": p_ms,
        "bound_ms": s1["bound_ms"],
        "bound_by": s1["bound_by"],
        "library_ms": None,  # no single PyTorch call computes a BVH closest hit
        "bound_us": s1["bound_ms"] * 1e3,
        "share_of_bound": s1["share_of_bound"],
        "shapes": k1,
        "shared_fits_groups": fits_groups,
        "deep_tree": {k: deep[k] for k in ("depth", "groups", "tree_memory", "deepest_stack")},
        "wwscene_render": {k: assets[k] for k in ("launches", "groups", "depth", "tree_memory", "spp")},
        "flagship_run": {"launches": flag["launches"], "spp": flag["runs"]["whole"]["spp"],
                         "rays_per_launch": flag["rays"]},
    }, {
        "name": "table_grad",
        "route": "cuda",
        "source": "raytracer2022_tpu_torch/csrc/table_grad.cu",
        "replaces": None,  # PyTorch's backward of indexing; the JAX package's fetch was a one-hot contraction
        "launches_per_fit_step": diff["table_grad_fit"]["launches_per_step"],
        "max_rel_err": max(r["rel_err"] for r in diff["table_grad"].values()),
        "shapes": diff["table_grad"],
    }, {
        "name": "mis_sample",
        "route": "cuda",
        "source": "raytracer2022_tpu_torch/csrc/mis_sample.cu",
        "replaces": None,  # the JAX package left the vertex's mixture sample to XLA's fusion
        "launches_per_frame_render": {name: vert[name]["frame"]["mis_launches"] for name in MIS_FRAMES},
        "launches_per_fit_step": vert["fit"]["launches_per_step"][1],
        "max_rel_err": max(max(sampling[name]["dir_max_rel_err"], sampling[name]["pdf_max_rel_err"])
                           for name in MIS_FRAMES),
        "shapes": sampling,
    }, {
        "name": "vertex",
        "route": "cuda",
        "source": "raytracer2022_tpu_torch/csrc/vertex.cu",
        "replaces": None,  # the JAX package left the vertex's shading, sampling and update to XLA's fusion
        "launches_per_frame_render": {name: vert[name]["frame"]["launches"] for name in MIS_FRAMES},
        "launches_per_fit_step": vert["fit"]["launches_per_step"][0],
        "max_rel_err": max(vert[name][k]["max_rel_err"] for name in MIS_FRAMES for k in VERTEX_OUTPUTS),
        "shapes": {name: {k: v for k, v in vert[name].items() if k != "frame"} for name in MIS_FRAMES},
    }]
    print(f"[smoke total: {time.perf_counter() - t_start:.1f} s]", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
