"""The vertex after its closest hit in one call (``ops/vertex.py``): its
plain version against the written-out composite it replaced (texture
value, emission, a scatter that drew one ``torch.rand`` at a time, the
mixture sample, the update) on the same variates, replayed in the
composite's draw order, over every material and texture kind, both
backgrounds, with and without the origin offset, with dead, missing,
killed and totally reflected lanes; the block's rows; the routing (every
CPU vertex and every gradient vertex runs the plain version on one block
drawn from its generator); the wrapper's refusals; and on the card the
kernel against its plain version on the same block, at the first vertex of
the benchmark's frames, and once a vertex in forward renders, never in
gradient renders.

No JAX here, so the file also runs on a card machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_vertex.py

Tests marked ``cuda`` skip without a CUDA device: ``csrc/vertex.cu`` is
CUDA C++ and has no CPU mode.
"""

import dataclasses
import math
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from raytracer2022_tpu_torch.ops import mis, vertex  # noqa: E402
from raytracer2022_tpu_torch.ops.intersect import Hit  # noqa: E402
from raytracer2022_tpu_torch.ops.materials import emitted, scattering_pdf_lambertian, texture_value  # noqa: E402
from raytracer2022_tpu_torch.ops.sampling import uniform  # noqa: E402
from raytracer2022_tpu_torch.ops.shade import shade_for_mats  # noqa: E402
from raytracer2022_tpu_torch.ops.vecmath import dot, reflect, refract, scale, to_unit, vec3  # noqa: E402
from raytracer2022_tpu_torch.render.integrator import TraceConfig  # noqa: E402
from raytracer2022_tpu_torch.scene.builder import SceneBuilder  # noqa: E402
from raytracer2022_tpu_torch.scene.types import (  # noqa: E402
    DIELECTRIC, DIFFUSE_LIGHT, ISOTROPIC, LAMBERTIAN, METAL, RECT, SPHERE, TEX_CHECKER, TEX_IMAGE, TEX_NOISE,
    TEX_OBJUV, TEX_SOLID, TRIANGLE,
)

torch.set_num_threads(1)

N = 4096
LIGHTS = ["sphere", "rect", "two", "none"]
LIGHT_CENTER, LIGHT_RADIUS = (0.0, 8.0, 0.0), 1.5
MATERIALS = (LAMBERTIAN, METAL, DIELECTRIC, DIFFUSE_LIGHT, ISOTROPIC)
TEXTURES = (TEX_SOLID, TEX_CHECKER, TEX_NOISE, TEX_IMAGE, TEX_OBJUV)
RTOL = 2e-5  # the kernel against its plain version on the card, same block


def _scene(lights: str, device="cpu"):
    """Every material over every texture kind (the dielectric's texture is
    its own white solid), two atlas images of different sizes, and the
    lights: the sphere (wwscene's kind), the flipped rect (the Cornell
    box's), both, or none."""
    b = SceneBuilder()
    rng = np.random.default_rng(0)
    textures = [
        b.solid((0.6, 0.4, 0.3)), b.checker((0.9, 0.1, 0.1), (0.1, 0.9, 0.1)), b.noise(4.0),
        b.image(rng.integers(0, 256, (12, 20, 3), dtype=np.uint8)),
        b.objuv(rng.integers(0, 256, (7, 5, 3), dtype=np.uint8)),
    ]
    for tex in textures:
        b.lambertian(tex)
        b.metal(tex, 0.3)
        b.diffuse_light(tex)
        b.isotropic(tex)
    b.dielectric(1.5)
    b.dielectric(1.0 / 1.33)
    if lights in ("sphere", "two"):
        b.add_light(b.sphere(LIGHT_CENTER, LIGHT_RADIUS, b.diffuse_light((4.0, 4.0, 4.0))))
    if lights in ("rect", "two"):
        light = b.rect_xz(-1, 1, -1, 1, 3.9, b.diffuse_light((8.0, 8.0, 8.0)))
        b.flip_face(light)
        b.add_light(light)
    b.rect_xz(-4, 4, -4, 4, 0.0, b.lambertian(textures[0]))
    return b.finalize(device=device)


def _wavefront(scene, seed: int, n: int = N):
    """A vertex's inputs with hit records made up on every material of the
    scene: points in the room (a tenth inside the light sphere, where the
    mixture pdf is NaN), unit normals, both faces, uvs a little outside
    [0, 1] (the textures saturate), a tenth of the lanes missing and a
    tenth dead (their rays parked as the integrator parks them)
    -> (hit, shade, d, tm, throughput, alive), on the scene's device."""
    dev = scene.params.device
    rng = np.random.default_rng(seed)

    def f32(x):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=torch.float32, device=dev)

    def flag(share):
        return torch.as_tensor(rng.random(n) < share, device=dev)

    mat = torch.as_tensor(rng.integers(0, scene.materials.kind.shape[0], n), device=dev)
    p = rng.uniform((-3.5, 0.05, -3.5), (3.5, 3.5, 3.5), (n, 3)).T
    inside = rng.random(n) < 0.1
    p[:, inside] = np.asarray(LIGHT_CENTER)[:, None] + rng.uniform(-0.8, 0.8, (3, int(inside.sum())))
    nrm = rng.normal(size=(3, n))
    nrm /= np.linalg.norm(nrm, axis=0)
    hit = Hit(hit=flag(0.9), t=f32(rng.uniform(0.1, 5.0, n)), prim=torch.zeros(n, dtype=torch.int64, device=dev),
              p=f32(p), normal=f32(nrm), front=flag(0.6), u=f32(rng.uniform(-0.2, 1.2, n)),
              v=f32(rng.uniform(-0.2, 1.2, n)), tex_uv=f32(rng.uniform(-0.2, 1.2, (2, n))), mat=mat)
    alive = flag(0.9)
    d = torch.where(alive[None], f32(rng.normal(size=(3, n))), 1.0)
    return hit, shade_for_mats(scene, mat), d, f32(rng.uniform(0, 1, n)), f32(rng.uniform(0.1, 1.0, (3, n))), alive


# --- the composite, written out: the vertex after its closest hit as the
# integrator ran it before the block, the scatter drawing one ``torch.rand``
# at a time (metal's ball: z, azimuth, radius; the dielectric's test;
# isotropic's ball), then the mixture sample's block


def _composite_ball(gen, shape):
    z = uniform(gen, shape, -1.0, 1.0)
    phi = uniform(gen, shape, 0.0, 2.0 * math.pi)
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    return scale(vec3(r * torch.cos(phi), r * torch.sin(phi), z), uniform(gen, shape) ** (1.0 / 3.0))


def _composite(scene, cfg, hit, shade, d, tm, throughput, alive, gen) -> vertex.Vertex:
    kind, param, n = shade.mat_kind, shade.mat_param, hit.normal
    shape = tuple(tm.shape)
    tex_val = texture_value(scene.textures, shade, hit, scene.stats.features)
    em = emitted(shade, hit, tex_val)
    unit_d = to_unit(d)
    metal_dir = reflect(unit_d, n) + scale(_composite_ball(gen, shape), param)
    ir = torch.where(kind == DIELECTRIC, param, 1.5)
    ratio = torch.where(hit.front, 1.0 / ir, ir)
    cos_theta = torch.clamp(dot(-unit_d, n), max=1.0)
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    r0 = (1.0 - ratio) / (1.0 + ratio)
    r0 = r0 * r0
    reflectance = r0 + (1.0 - r0) * (1.0 - cos_theta) ** 5
    do_reflect = (ratio * sin_theta > 1.0) | (reflectance > uniform(gen, shape))
    diel_dir = torch.where(do_reflect[None], reflect(unit_d, n), refract(unit_d, n, ratio))
    iso_dir = _composite_ball(gen, shape)
    is_metal, is_diel = kind == METAL, kind == DIELECTRIC
    has_scatter = kind != DIFFUSE_LIGHT
    is_specular = is_metal | is_diel | (kind == ISOTROPIC)
    spec_dir = torch.where(is_metal[None], metal_dir, torch.where(is_diel[None], diel_dir, iso_dir))
    attenuation = torch.where(is_diel[None], 1.0, tex_val)

    u = uniform(gen, (mis.variate_rows(len(scene.stats.light_ids)), shape[0]))
    new_dir, pdf_val = mis.mis_sample_plain(scene, hit.p, hit.normal, u)

    spdf = scattering_pdf_lambertian(hit.normal, new_dir)
    miss = alive & ~hit.hit
    absorb = alive & hit.hit & ~has_scatter
    specular = alive & hit.hit & has_scatter & is_specular
    diffuse = alive & hit.hit & has_scatter & ~is_specular & (kind == LAMBERTIAN) & (pdf_val > 0.0)
    radiance_add = torch.where(miss[None], throughput * vertex.background(cfg, d), 0.0)
    radiance_add = radiance_add + torch.where((absorb | diffuse)[None], throughput * em, 0.0)
    w_diffuse = attenuation * (spdf / torch.where(diffuse, pdf_val, 1.0))[None]
    throughput = torch.where(specular[None], throughput * attenuation,
                             torch.where(diffuse[None], throughput * w_diffuse, throughput))
    next_dir = torch.where(specular[None], spec_dir, new_dir)
    next_tm = torch.where(specular, torch.where(is_metal, 0.0, tm), tm)
    new_o = hit.p
    if cfg.spawn_eps > 0.0:
        eps = cfg.spawn_eps * torch.clamp(torch.abs(hit.p).amax(dim=0), min=1.0)
        side = torch.sign(dot(hit.normal, next_dir))
        new_o = hit.p + scale(hit.normal, eps * side * (kind != ISOTROPIC).to(eps.dtype))
    return vertex.Vertex(radiance_add, specular | diffuse, new_o, next_dir, next_tm, throughput)


def _replayed_block(scene, kind: torch.Tensor, seed: int) -> torch.Tensor:
    """The block that gives the plain version the composite's numbers: the
    generator replayed in the composite's draw order, then laid out as
    ``vertex.variate_rows`` says, the scatter rows of each lane from the
    draws of its material (metal's ball, the dielectric's test, isotropic's
    ball)."""
    n = kind.shape[0]
    gen = torch.Generator().manual_seed(seed)
    draws = [torch.rand((n,), generator=gen) for _ in range(7)]
    mix = torch.rand((mis.variate_rows(len(scene.stats.light_ids)), n), generator=gen)
    metal, rnd, iso = draws[0:3], draws[3], draws[4:7]
    rows = [torch.where(kind == DIELECTRIC, rnd, torch.where(kind == ISOTROPIC, iso[0], metal[0]))]
    rows += [torch.where(kind == ISOTROPIC, iso[j], metal[j]) for j in (1, 2)]
    u = torch.cat([mix, torch.stack(rows)])
    assert u.shape[0] == vertex.variate_rows(len(scene.stats.light_ids))
    return u


def _assert_equal(got: vertex.Vertex, want: vertex.Vertex):
    for name, g, w in zip(vertex.Vertex._fields, got, want):
        torch.testing.assert_close(g.detach(), w.detach(), rtol=0, atol=0, equal_nan=True, msg=name)


@pytest.mark.parametrize("spawn_eps", [0.0, 1e-4], ids=["no_offset", "offset"])
@pytest.mark.parametrize("background", [(0.1, 0.2, 0.3), None], ids=["constant", "sky"])
@pytest.mark.parametrize("lights", LIGHTS)
def test_plain_version_is_the_composite_on_the_same_variates(lights, background, spawn_eps):
    """Bit for bit on every lane, over every material and texture kind;
    and the wavefront holds what the test claims to cover."""
    scene = _scene(lights)
    cfg = TraceConfig(background=background, spawn_eps=spawn_eps)
    hit, shade, d, tm, th, alive = _wavefront(scene, seed=1)
    u = _replayed_block(scene, shade.mat_kind, seed=7)
    got = vertex.vertex_tail_plain(scene, cfg, hit, shade, d, tm, th, alive, u)
    _assert_equal(got, _composite(scene, cfg, hit, shade, d, tm, th, alive, torch.Generator().manual_seed(7)))

    live = alive & hit.hit
    pairs = set(zip(shade.mat_kind[live].tolist(), shade.tex_kind[live].tolist()))
    assert {(m, t) for m in MATERIALS if m != DIELECTRIC for t in TEXTURES} | {(DIELECTRIC, TEX_SOLID)} <= pairs
    assert (~alive).any() and (alive & ~hit.hit).any() and got.cont.any()
    assert (got.radiance_add[:, alive & ~hit.hit] > 0).all()  # the background on a miss
    k = mis.variate_rows(len(scene.stats.light_ids))
    _, pdf = mis.mis_sample_plain(scene, hit.p, hit.normal, u[:k])
    killed = live & (shade.mat_kind == LAMBERTIAN) & ~(pdf > 0)
    if lights in ("sphere", "two"):
        assert torch.isnan(pdf[killed]).any() and killed.any()
    assert not got.cont[killed].any() and torch.equal(got.throughput[:, killed], th[:, killed])
    unit_d = to_unit(d)
    cos_theta = torch.clamp(dot(-unit_d, hit.normal), max=1.0)
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    tir = live & (shade.mat_kind == DIELECTRIC) & ~hit.front & (shade.mat_param * sin_theta > 1.0)
    assert tir.any() and torch.equal(got.d[:, tir], reflect(unit_d, hit.normal)[:, tir])


@pytest.mark.parametrize("mode", ["no_grad", "grad", "requires_grad"])
def test_cpu_vertices_run_the_plain_version_on_one_block(mode, monkeypatch):
    """The routing of ``vertex_tail`` on the CPU, under ``no_grad``, under
    grad, and with rays that require a gradient: one draw of
    ``variate_rows(L)`` rows from the vertex's generator, the plain version
    run once on it, bit for bit; the kernel never launched, and the
    throughput still requires grad."""
    scene = _scene("two")
    cfg = TraceConfig(background=None)
    hit, shade, d, tm, th, alive = _wavefront(scene, seed=2, n=1024)
    if mode == "requires_grad":
        d = d.requires_grad_()
        hit = dataclasses.replace(hit, p=hit.p.requires_grad_())
    draws, blocks = [], []
    real_uniform, real_plain = vertex.uniform, vertex.vertex_tail_plain

    def drawn(gen, shape, *args):
        draws.append((gen.get_state(), tuple(shape)))
        return real_uniform(gen, shape, *args)

    def plain(*args):
        blocks.append(args[-1])
        return real_plain(*args)

    def no_kernel(*args):
        raise AssertionError("a CPU vertex launched the kernel")

    monkeypatch.setattr(vertex, "uniform", drawn)
    monkeypatch.setattr(vertex, "vertex_tail_plain", plain)
    monkeypatch.setattr(vertex, "_vertex_cuda", no_kernel)
    launches = vertex.LAUNCHES
    with torch.no_grad() if mode == "no_grad" else torch.enable_grad():
        got = vertex.vertex_tail(scene, cfg, hit, shade, d, tm, th, alive, torch.Generator().manual_seed(11))
        ((state, shape),) = draws
        (u,) = blocks
        assert shape == (vertex.variate_rows(2), 1024)
        assert torch.equal(u, torch.rand(shape, generator=torch.Generator().set_state(state)))
        _assert_equal(got, real_plain(scene, cfg, hit, shade, d, tm, th, alive, u))
    assert vertex.LAUNCHES == launches and got.cont.any()
    assert got.throughput.requires_grad == (mode == "requires_grad")


def test_kernel_takes_forward_vertices_on_the_card_only():
    """The routing rule on stand-ins for the tensors: CUDA tensors, no
    gradient wanted through the call (the scene's float tables, the hit
    record, the shading inputs, the ray, the throughput), sphere and rect
    lights only, at most MAX_LIGHTS of them."""
    scene = _scene("two")
    card = SimpleNamespace(is_cuda=True, requires_grad=False)
    leaf = SimpleNamespace(is_cuda=True, requires_grad=True)

    def call(scene=scene, p=card, color=card, d=card, throughput=card):
        hit = SimpleNamespace(p=p, normal=card, u=card, v=card, tex_uv=card)
        shade = SimpleNamespace(mat_param=card, color=color, scale=card, odd=card, even=card)
        return vertex.kernel_takes(scene, hit, shade, d, card, throughput)

    assert call()
    hit, shade, d, tm, th, _ = _wavefront(scene, seed=3, n=8)
    assert not vertex.kernel_takes(scene, hit, shade, d, tm, th)  # CPU tensors
    assert not call(p=leaf) and not call(color=leaf) and not call(d=leaf, p=leaf) and not call(throughput=leaf)
    with torch.no_grad():
        assert call(p=leaf, color=leaf, throughput=leaf)
    tables = SimpleNamespace(params=scene.params, materials=SimpleNamespace(param=torch.zeros(3, requires_grad=True)),
                             textures=scene.textures, stats=scene.stats)
    assert not call(scene=tables)
    other = SimpleNamespace(**{**vars(tables), "materials": scene.materials,
                               "stats": SimpleNamespace(light_kinds=(RECT, TRIANGLE))})
    assert not call(scene=other)
    many = SimpleNamespace(**{**vars(other), "stats": SimpleNamespace(light_kinds=(SPHERE,) * (mis.MAX_LIGHTS + 1))})
    assert not call(scene=many)


def test_variate_rows():
    """The mixture sample's rows, then the scatter's three."""
    assert [vertex.variate_rows(n) for n in (0, 1, 2, 7)] == [5, 8, 9, 9]
    assert [vertex.variate_rows(n) - mis.variate_rows(n) for n in (0, 1, 2)] == [vertex.SCATTER_ROWS] * 3 == [3] * 3


@pytest.mark.parametrize("fault", ["f64_points", "short_normals", "strided_throughput", "i64_kinds", "u8_alive",
                                   "strided_colors"])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(fault):
    scene = _scene("sphere")
    hit, shade, d, tm, th, alive = _wavefront(scene, seed=4, n=64)
    if fault == "f64_points":
        hit = dataclasses.replace(hit, p=hit.p.double())
    elif fault == "short_normals":
        hit = dataclasses.replace(hit, normal=hit.normal[:, :32])
    elif fault == "strided_throughput":
        th = th.T.contiguous().T
    elif fault == "i64_kinds":
        shade = dataclasses.replace(shade, mat_kind=shade.mat_kind.long())
    elif fault == "u8_alive":
        alive = alive.to(torch.uint8)
    else:
        shade = dataclasses.replace(shade, color=shade.color.T.contiguous().T)
    with pytest.raises(ValueError, match="vertex"):
        vertex.vertex_tail(scene, TraceConfig(), hit, shade, d, tm, th, alive, torch.Generator().manual_seed(0))


# --- on the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: csrc/vertex.cu is CUDA C++ and has no CPU mode")
    return torch.device("cuda")


def _compare(got: vertex.Vertex, want: vertex.Vertex, lanes=None) -> dict:
    """The kernel's vertex against the plain version's: ``cont`` equal, NaN
    on the same lanes, every other output within RTOL of its lane's norm;
    -> the largest relative error and the share of bit-equal lanes."""
    lanes = torch.ones_like(got.cont) if lanes is None else lanes
    assert torch.equal(got.cont[lanes], want.cont[lanes])
    rec = {}
    for name in ("radiance_add", "o", "d", "tm", "throughput"):
        g, w = getattr(got, name)[..., lanes], getattr(want, name).detach()[..., lanes]
        assert torch.equal(torch.isnan(g), torch.isnan(w)), name
        g, w = torch.nan_to_num(g), torch.nan_to_num(w)
        norm = w.abs() if w.dim() == 1 else w.norm(dim=0)
        err = (g - w).abs() if w.dim() == 1 else (g - w).norm(dim=0)
        rel = float((err / norm.clamp_min(1e-30)).max()) if err.numel() else 0.0
        same = (g == w) if w.dim() == 1 else (g == w).all(dim=0)
        rec[name] = (rel, float(same.float().mean()) if same.numel() else 1.0)
        assert rel <= RTOL, f"{name}: {rec[name]}"
    return rec


@pytest.mark.cuda
@pytest.mark.parametrize("spawn_eps", [0.0, 1e-4], ids=["no_offset", "offset"])
@pytest.mark.parametrize("background", [(0.1, 0.2, 0.3), None], ids=["constant", "sky"])
@pytest.mark.parametrize("lights", LIGHTS)
def test_kernel_is_its_plain_version(card, lights, background, spawn_eps):
    """The kernel against its plain version on the card, on the same block
    (the kernel's vertex draws it from the generator, the plain version
    reads it replayed), over every material and texture kind; one launch
    counted."""
    scene = _scene(lights, device=card)
    cfg = TraceConfig(background=background, spawn_eps=spawn_eps)
    hit, shade, d, tm, th, alive = _wavefront(scene, seed=5, n=65_536)
    shape = (vertex.variate_rows(len(scene.stats.light_ids)), tm.shape[0])
    before = vertex.LAUNCHES
    with torch.no_grad():
        got = vertex.vertex_tail(scene, cfg, hit, shade, d, tm, th, alive, torch.Generator(device=card).manual_seed(3))
        torch.cuda.synchronize()
        assert vertex.LAUNCHES == before + 1
        u = uniform(torch.Generator(device=card).manual_seed(3), shape)
        want = vertex.vertex_tail_plain(scene, cfg, hit, shade, d, tm, th, alive, u)
    print(lights, background, spawn_eps, _compare(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["wwscene", "cornell_box_book"])
def test_first_vertex_of_the_benchmark_frames(card, name, tmp_path, monkeypatch):
    """The kernel against its plain version at the first vertex of the
    benchmark's frames (wwscene from stand-in assets, 2560x1440; book 3's
    Cornell box, 600x600), camera rays spread over the frame."""
    from raytracer2022_tpu_torch.ops.intersect import closest_hit
    from raytracer2022_tpu_torch.render.camera import make_camera
    from raytracer2022_tpu_torch.render.renderer import _regen_gen_rays
    from raytracer2022_tpu_torch.scene.library import SCENES
    from raytracer2022_tpu_torch.tools.standins import write_stand_in_assets

    write_stand_in_assets(str(tmp_path))
    monkeypatch.setenv("RT2022_SOURCE_DIR", str(tmp_path))
    bundle = SCENES[name](device=card)
    width, height = {"wwscene": (2560, 1440), "cornell_box_book": (600, 600)}[name]
    cam = make_camera(**bundle.camera_kwargs, device=card)
    cfg = TraceConfig(background=bundle.background)
    n = 261_120
    gen = torch.Generator(device=card).manual_seed(20)
    with torch.no_grad():
        pix = torch.arange(n, device=card) * max(width * height // n, 1) % (width * height)
        o, d, tm = _regen_gen_rays(cam, width, height)(gen, pix)
        hit, shade = closest_hit(bundle.scene, o, d, tm, cfg.t_min, float("inf"), gen, False)
        th = torch.ones((3, n), device=card)
        alive = torch.ones(n, dtype=torch.bool, device=card)
        state = gen.get_state()
        got = vertex.vertex_tail(bundle.scene, cfg, hit, shade, d, tm, th, alive, gen)
        u = uniform(torch.Generator(device=card).set_state(state), (vertex.variate_rows(len(bundle.scene.stats.light_ids)), n))
        want = vertex.vertex_tail_plain(bundle.scene, cfg, hit, shade, d, tm, th, alive, u)
    assert hit.hit.float().mean() > 0.1
    print(name, _compare(got, want))


@pytest.mark.cuda
def test_forward_renders_launch_once_a_vertex_and_gradient_renders_never(card):
    """A logged forward render launches the kernel once a
    ``vertex.shading`` span, with no ``vertex.sampling`` span left; a
    gradient render (its tables requiring grad) launches it never."""
    from raytracer2022_tpu_torch.render import renderer as R
    from raytracer2022_tpu_torch.render.camera import make_camera

    scene = _scene("rect", device=card)
    cam = make_camera((0, 2, -8), (0, 1, 0), (0, 1, 0), 40, 1.0, device=card)
    log: list = []
    before = vertex.LAUNCHES
    R.render_sum_n(scene, cam, R.RenderConfig(width=64, height=48, spp=8, max_depth=6), launch_log=log)
    assert vertex.LAUNCHES - before == sum(e["span_calls"]["vertex.shading"] for e in log) > 0
    assert sum(e["span_calls"].get("vertex.sampling", 0) for e in log) == 0
    color = scene.textures.color.clone().requires_grad_()
    traced = dataclasses.replace(scene, textures=dataclasses.replace(scene.textures, color=color))
    before = vertex.LAUNCHES
    img = R.render_batch(traced, cam, 5, 16, 12, 4, TraceConfig(max_depth=4))
    (grad,) = torch.autograd.grad(img.mean(), color)
    assert vertex.LAUNCHES == before and torch.isfinite(grad).all()
