"""The vertex's mixture sample in one call (``ops/mis.py``): its plain
version against a written-out composite (the sample drawn one
``torch.rand`` at a time) on the same variates, replayed in the
composite's draw order; the NaN and zero pdfs the integrator kills; the
routing (every CPU vertex, with and without gradients, runs the plain
version on one block drawn from its generator); the wrapper's refusals;
and on the card the kernel against its plain version, in the forward
render, and the plain version under gradients on the same variates.

No JAX here, so the file also runs on a card machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_mis_sample.py

Tests marked ``cuda`` skip without a CUDA device: ``csrc/mis_sample.cu`` is
CUDA C++ and has no CPU mode.
"""

import math
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from raytracer2022_tpu_torch.ops import mis, vertex  # noqa: E402
from raytracer2022_tpu_torch.ops.lights import _light_params, lights_pdf  # noqa: E402
from raytracer2022_tpu_torch.ops.sampling import cos_pdf_value, cosine_local, sphere_cone_local, uniform  # noqa: E402
from raytracer2022_tpu_torch.ops.vecmath import length_sqr, onb_from_w, onb_local, to_unit, vec3  # noqa: E402
from raytracer2022_tpu_torch.render.integrator import TraceConfig, _eval_vertex  # noqa: E402
from raytracer2022_tpu_torch.scene.builder import SceneBuilder  # noqa: E402
from raytracer2022_tpu_torch.scene.types import RECT, SPHERE, TRIANGLE  # noqa: E402

torch.set_num_threads(1)

N = 4096
CASES = ["sphere", "flipped_rect", "three_lights", "no_lights"]
LIGHT_CENTER, LIGHT_RADIUS = (0.0, 8.0, 0.0), 1.5


def _scene(case: str, device="cpu"):
    """One sphere light (wwscene's kind), one flipped rect light (the
    Cornell box's), a sphere and two rects of both axes, or none; a
    lambertian floor and a metal sphere beside them."""
    b = SceneBuilder()
    if case in ("sphere", "three_lights"):
        b.add_light(b.sphere(LIGHT_CENTER, LIGHT_RADIUS, b.diffuse_light((4.0, 4.0, 4.0))))
    if case in ("flipped_rect", "three_lights"):
        light = b.rect_xz(-1, 1, -1, 1, 3.9, b.diffuse_light((8.0, 8.0, 8.0)))
        b.flip_face(light)
        b.add_light(light)
    if case == "three_lights":
        b.add_light(b.rect_yz(0, 2, -1, 1, -4, b.diffuse_light((2.0, 2.0, 2.0))))
    b.rect_xz(-4, 4, -4, 4, 0.0, b.lambertian((0.6, 0.4, 0.3)))
    b.sphere((1.5, 1.0, 0.0), 1.0, b.metal((0.8, 0.8, 0.8), 0.3))
    return b.finalize(device=device)


def _points(seed: int, n: int = N, inside: bool = False):
    """Hit points in the room (or inside the light sphere) and unit normals."""
    rng = np.random.default_rng(seed)
    if inside:
        p = np.asarray(LIGHT_CENTER)[:, None] + rng.uniform(-0.8, 0.8, (3, n))
    else:
        p = rng.uniform((-3.5, 0.05, -3.5), (3.5, 3.5, 3.5), (n, 3)).T
    nrm = rng.normal(size=(3, n))
    nrm /= np.linalg.norm(nrm, axis=0)
    return (torch.as_tensor(np.ascontiguousarray(x), dtype=torch.float32) for x in (p, nrm))


def _replayed_block(scene, n: int, seed: int) -> torch.Tensor:
    """The variate block that gives the plain version the composite's
    numbers: the generator replayed in the composite's draw order (the
    cosine lobe's r1, r2; the light pick; the sphere cone's pair; the rect
    point's pair; the 50/50 pick), then laid out as ``mis.variate_rows``
    says, the picked light's pair by its kind and the pick as a variate
    whose ``floor(u * L)`` is the composite's integer."""
    stats = scene.stats
    n_lights = len(stats.light_ids)
    gen = torch.Generator().manual_seed(seed)
    r1, r2 = uniform(gen, (n,)), uniform(gen, (n,))
    if n_lights == 0:
        return torch.stack([r1, r2])
    pick = torch.randint(0, n_lights, (n,), generator=gen) if n_lights > 1 else torch.zeros(n, dtype=torch.int64)
    sphere_u = (uniform(gen, (n,)), uniform(gen, (n,))) if SPHERE in stats.light_kinds else None
    rect_u = (uniform(gen, (n,)), uniform(gen, (n,))) if RECT in stats.light_kinds else None
    mix = uniform(gen, (n,))
    is_sphere = torch.tensor(stats.light_kinds)[pick] == SPHERE
    pair = [torch.where(is_sphere, sphere_u[j], rect_u[j]) if sphere_u and rect_u else (sphere_u or rect_u)[j]
            for j in range(2)]
    rows = [r1, r2, mix, *pair]
    if n_lights > 1:
        rows.append((pick.float() + 0.5) / n_lights)
    u = torch.stack(rows)
    assert u.shape[0] == mis.variate_rows(n_lights)
    return u


def _composite(scene, p, nrm, seed: int):
    return _composite_sampling(scene, p, nrm, torch.Generator().manual_seed(seed))


def _assert_close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6, atol=0, equal_nan=True)


@pytest.mark.parametrize("case", CASES)
def test_plain_version_is_the_composite_on_the_same_variates(case):
    scene = _scene(case)
    p, nrm = _points(1)
    u = _replayed_block(scene, N, seed=7)
    got = mis.mis_sample(scene, p, nrm, u)
    want = _composite(scene, p, nrm, seed=7)
    _assert_close(got, want)
    new_dir, pdf = got
    assert new_dir.shape == (3, N) and pdf.shape == (N,)
    assert torch.isfinite(pdf).all() and (pdf >= 0).all() and (pdf > 0).any()
    if case != "no_lights":  # the pick is 50/50: about half the lanes take the light's direction
        assert 0.4 < float((u[2] < 0.5).float().mean()) < 0.6


def test_the_light_pick_reaches_every_light():
    scene = _scene("three_lights")
    u = _replayed_block(scene, N, seed=3)
    pick = torch.clamp(torch.floor(u[5] * 3), max=2).long()
    assert set(pick.tolist()) == {0, 1, 2}
    assert int(torch.clamp(torch.floor(torch.tensor([1.0 - 2.0**-24]) * 3), max=2)) == 2  # clamped at the top


def test_origin_inside_the_light_sphere_gives_a_nan_pdf():
    """From inside the light sphere every direction hits it and its
    solid angle is undefined: NaN on every lane, as the composite."""
    scene = _scene("sphere")
    p, nrm = _points(2, inside=True)
    u = _replayed_block(scene, N, seed=5)
    got = mis.mis_sample(scene, p, nrm, u)
    _assert_close(got, _composite(scene, p, nrm, seed=5))
    assert torch.isnan(got[1]).all() and torch.isfinite(got[0]).all()


def test_a_direction_in_the_rects_plane_has_pdf_zero():
    """Points in the light's plane, outside it, with the plane's normal: a
    light sample lies in the plane (no hit, cosine 0) and has pdf 0; a
    cosine sample leaves the plane and keeps half its cosine pdf."""
    scene = _scene("flipped_rect")
    rng = np.random.default_rng(4)
    x = rng.uniform(1.5, 3.5, N) * rng.choice([-1.0, 1.0], N)
    p = torch.as_tensor(np.stack([x, np.full(N, 3.9), rng.uniform(-3, 3, N)]), dtype=torch.float32)
    nrm = torch.zeros_like(p)
    nrm[1] = 1.0
    u = _replayed_block(scene, N, seed=9)
    got = mis.mis_sample(scene, p, nrm, u)
    _assert_close(got, _composite(scene, p, nrm, seed=9))
    light = u[2] < 0.5
    assert (got[0][1][light] == 0).all() and (got[1][light] == 0).all()
    assert (got[1][~light] > 0).all()


def test_a_killed_lane_keeps_its_radiance():
    """From inside the light sphere the pdf is NaN, and the vertex kills
    the diffuse lanes with their throughput and radiance finite and
    unchanged, with and without gradients."""
    b = SceneBuilder()
    dome = b.sphere((0, 0, 0), 10, b.diffuse_light((1.0, 1.0, 1.0)))
    b.flip_face(dome)
    b.add_light(dome)
    b.sphere((0, 0, 0), 1, b.lambertian((0.5, 0.5, 0.5)))
    scene = b.finalize(device="cpu")
    rng = np.random.default_rng(6)
    o = torch.as_tensor(np.stack([rng.uniform(-0.3, 0.3, 512), rng.uniform(-0.3, 0.3, 512), np.full(512, -5.0)]),
                        dtype=torch.float32)
    d = torch.zeros_like(o)
    d[2] = 1.0
    tm = torch.zeros(512)
    th = torch.as_tensor(rng.uniform(0.2, 1.0, (3, 512)), dtype=torch.float32)
    alive = torch.ones(512, dtype=torch.bool)
    cfg = TraceConfig(max_depth=4, background=(0.0, 0.0, 0.0))
    outs = []
    for grad in (False, True):
        with torch.set_grad_enabled(grad):
            outs.append(_eval_vertex(scene, cfg, o.requires_grad_(grad), d, tm, th, alive,
                                     torch.Generator().manual_seed(0)))
    for vx in outs:
        assert not vx.cont.any()
        assert torch.isfinite(vx.radiance_add).all() and torch.equal(vx.radiance_add, torch.zeros_like(th))
        assert torch.equal(vx.throughput.detach(), th)


# --- the composite, written out: the mixture sample drawn one ``torch.rand``
# at a time (the cosine lobe's pair, the light pick, the sphere cone's pair,
# the rect point's pair, the 50/50 pick), the plain version's reference


def _composite_lights(scene, p, gen):
    stats = scene.stats
    ids = stats.light_ids
    n = p.shape[1]
    lp_all = _light_params(scene, ids)
    if len(ids) == 1:
        prm = lp_all
        kind = scene.kind[ids[0] : ids[0] + 1]
    else:
        pick = torch.randint(0, len(ids), (n,), generator=gen, device=gen.device)
        prm = lp_all[:, pick]
        kind = torch.cat([scene.kind[i : i + 1] for i in ids])[pick]
    out = vec3(torch.ones_like(p[0]), torch.zeros_like(p[0]), torch.zeros_like(p[0]))
    if SPHERE in stats.light_kinds:
        direction = prm[0:3] - p
        u, v, w = onb_from_w(direction)
        r1, r2 = uniform(gen, (n,)), uniform(gen, (n,))
        local = sphere_cone_local(r1, r2, prm[3].expand(n), length_sqr(direction))
        out = torch.where((kind == SPHERE)[None], onb_local(u, v, w, local), out)
    if RECT in stats.light_kinds:
        ua = uniform(gen, (n,))
        ub = uniform(gen, (n,))
        a = prm[0] + ua * (prm[1] - prm[0])
        b = prm[2] + ub * (prm[3] - prm[2])
        kv = prm[4].expand(n)
        ka = prm[5].to(torch.int32)
        point = torch.where(ka == 0, vec3(kv, a, b), torch.where(ka == 1, vec3(a, kv, b), vec3(a, b, kv)))
        out = torch.where((kind == RECT)[None], point - p, out)
    return out


def _composite_sampling(scene, p, normal, gen):
    n = p.shape[1]
    r1, r2 = uniform(gen, (n,)), uniform(gen, (n,))
    cos_dir = onb_local(*onb_from_w(normal), cosine_local(r1, r2))
    if len(scene.stats.light_ids) > 0:
        light_dir = _composite_lights(scene, p, gen)
        pick_light = uniform(gen, (n,)) < 0.5
        new_dir = torch.where(pick_light[None], light_dir, cos_dir)
        pdf_val = 0.5 * lights_pdf(scene, p, new_dir, None) + 0.5 * cos_pdf_value(new_dir, to_unit(normal))
    else:
        new_dir = cos_dir
        pdf_val = cos_pdf_value(new_dir, to_unit(normal))
    return new_dir, pdf_val


@pytest.mark.parametrize("mode", ["no_grad", "grad", "requires_grad"])
@pytest.mark.parametrize("case", CASES)
def test_cpu_vertices_keep_the_parents_composite(case, mode, monkeypatch):
    """The routing of ``_eval_vertex`` on the CPU, under ``no_grad``, under
    grad, and with rays that require a gradient: the vertex draws one
    block of ``vertex.variate_rows(L)`` rows from its own generator and
    runs ``mis_sample_plain`` on its first ``mis.variate_rows(L)`` rows,
    once; every output equals, bit for bit, the vertex that calls
    ``mis_sample_plain`` directly; the kernel is never launched, and the
    throughput still requires grad."""
    scene = _scene(case)
    rng = np.random.default_rng(8)
    n = 1024
    o = torch.as_tensor(np.stack([rng.uniform(-2, 2, n), np.full(n, 3.0), rng.uniform(-2, 2, n)]), dtype=torch.float32)
    d = torch.as_tensor(np.stack([rng.normal(0, 0.3, n), np.full(n, -1.0), rng.normal(0, 0.3, n)]),
                        dtype=torch.float32)
    if mode == "requires_grad":
        o = o.requires_grad_()
    tm = torch.zeros(n)
    th = torch.ones((3, n))
    alive = torch.ones(n, dtype=torch.bool)
    cfg = TraceConfig(max_depth=4, background=(0.0, 0.0, 0.0))
    launches = mis.LAUNCHES

    def run_vertex():
        with torch.no_grad() if mode == "no_grad" else torch.enable_grad():
            return _eval_vertex(scene, cfg, o, d, tm, th, alive, torch.Generator().manual_seed(11))

    draws, blocks = [], []
    real_uniform, real_plain = vertex.uniform, mis.mis_sample_plain

    def drawn(gen, shape, *args):
        draws.append((gen.get_state(), tuple(shape)))
        return real_uniform(gen, shape, *args)

    def plain(scene, p, normal, u):
        blocks.append(u)
        return real_plain(scene, p, normal, u)

    def no_kernel(*args):
        raise AssertionError("a CPU vertex launched the kernel")

    monkeypatch.setattr(vertex, "uniform", drawn)
    monkeypatch.setattr(mis, "mis_sample_plain", plain)
    monkeypatch.setattr(mis, "_mis_sample_cuda", no_kernel)
    got = run_vertex()
    ((state, shape),) = draws
    (u,) = blocks
    n_lights = len(scene.stats.light_ids)
    assert shape == (vertex.variate_rows(n_lights), n)
    block = torch.rand(shape, generator=torch.Generator().set_state(state))
    assert torch.equal(u, block[: mis.variate_rows(n_lights)])
    monkeypatch.setattr(mis, "mis_sample", real_plain)
    want = run_vertex()
    for g, w in zip(got, want):
        assert torch.equal(g.detach(), w.detach()), "a CPU vertex left the plain version"
    assert got.cont.any() and mis.LAUNCHES == launches
    if mode == "requires_grad":
        assert got.throughput.requires_grad


def test_kernel_takes_forward_renders_on_the_card_only():
    """The routing rule on stand-ins for the tensors: a CUDA point, no
    gradient wanted through the block, sphere and rect lights only, at
    most MAX_LIGHTS of them."""
    scene = _scene("three_lights")
    card = SimpleNamespace(is_cuda=True, requires_grad=False)
    leaf = SimpleNamespace(is_cuda=True, requires_grad=True)
    assert mis.kernel_takes(scene, card, card)
    assert not mis.kernel_takes(scene, torch.zeros(3, 4), torch.zeros(3, 4))  # CPU tensors
    assert not mis.kernel_takes(scene, leaf, card) and not mis.kernel_takes(scene, card, leaf)
    with torch.no_grad():
        assert mis.kernel_takes(scene, leaf, leaf)
    assert mis.kernel_takes(_scene("no_lights"), card, card)
    other = SimpleNamespace(params=scene.params, stats=SimpleNamespace(light_kinds=(RECT, TRIANGLE)))
    assert not mis.kernel_takes(other, card, card)
    many = SimpleNamespace(params=scene.params, stats=SimpleNamespace(light_kinds=(SPHERE,) * (mis.MAX_LIGHTS + 1)))
    assert not mis.kernel_takes(many, card, card)


def test_variate_rows():
    assert [mis.variate_rows(n) for n in (0, 1, 2, 7)] == [2, 5, 6, 6]


@pytest.mark.parametrize("fault", ["f64_points", "short_normals", "rows", "strided_points", "strided_variates"])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(fault):
    scene = _scene("sphere")
    p, nrm = _points(3, n=64)
    u = torch.rand(mis.variate_rows(1), 64)
    if fault == "f64_points":
        p = p.double()
    elif fault == "short_normals":
        nrm = nrm[:, :32]
    elif fault == "rows":
        u = torch.rand(6, 64)
    elif fault == "strided_points":
        p = torch.rand(64, 3).T
    else:
        u = torch.rand(64, 5).T
    with pytest.raises(ValueError, match="mis_sample"):
        mis.mis_sample(scene, p, nrm, u)


# --- on the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: csrc/mis_sample.cu is CUDA C++ and has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("inside", [False, True], ids=["room", "inside_light"])
@pytest.mark.parametrize("case", CASES)
def test_kernel_is_its_plain_version(card, case, inside):
    """The kernel against its plain version on the card, on the same
    variates: directions within 1e-5 of their norm, pdfs within 1e-5
    relative, NaN on the same lanes; one launch counted."""
    if inside and case in ("flipped_rect", "no_lights"):
        pytest.skip("no light sphere to be inside")
    scene = _scene(case, device=card)
    p, nrm = (x.to(card) for x in _points(12, n=261_120, inside=inside))
    u = torch.rand((mis.variate_rows(len(scene.stats.light_ids)), p.shape[1]), device=card,
                   generator=torch.Generator(device=card).manual_seed(1))
    before = mis.LAUNCHES
    got = mis.mis_sample(scene, p, nrm, u)
    torch.cuda.synchronize()
    assert mis.LAUNCHES == before + 1
    want = mis.mis_sample_plain(scene, p, nrm, u)
    dir_err = (got[0] - want[0]).norm(dim=0) / want[0].norm(dim=0)
    assert float(dir_err.max()) <= 1e-5
    assert torch.equal(torch.isnan(got[1]), torch.isnan(want[1]))
    rel = (got[1] - want[1]).abs() / want[1].abs().clamp_min(1e-30)
    assert float(torch.where(torch.isnan(want[1]), 0.0, rel).max()) <= 1e-5


@pytest.mark.cuda
def test_forward_renders_on_the_card_take_the_kernel_and_gradients_do_not(card):
    """A logged forward render takes its mixture samples inside the
    vertex's kernel: ``csrc/vertex.cu`` launches once a ``vertex.shading``
    span and this kernel alone never.  A vertex whose rays require a
    gradient launches neither and runs the plain versions on the same
    variates as the forward vertex of the same seed, to the kernel's
    tolerance."""
    from raytracer2022_tpu_torch.render import renderer as R
    from raytracer2022_tpu_torch.render.camera import make_camera

    scene = _scene("flipped_rect", device=card)
    cam = make_camera((0, 2, -8), (0, 1, 0), (0, 1, 0), 40, 1.0, device=card)
    log: list = []
    before, fused = mis.LAUNCHES, vertex.LAUNCHES
    R.render_sum_n(scene, cam, R.RenderConfig(width=64, height=48, spp=8, max_depth=6), launch_log=log)
    assert mis.LAUNCHES == before
    assert vertex.LAUNCHES - fused == sum(e["span_calls"]["vertex.shading"] for e in log) > 0
    o = torch.zeros((3, 256), device=card)
    o[1] = 2.0
    o[2] = -8.0
    d = torch.randn((3, 256), device=card, generator=torch.Generator(device=card).manual_seed(1))
    d[2] = d[2].abs() + 1.0
    outs, launches = [], []
    for grad in (False, True):
        before, fused = mis.LAUNCHES, vertex.LAUNCHES
        with torch.set_grad_enabled(grad):
            outs.append(_eval_vertex(scene, TraceConfig(max_depth=4), o.clone().requires_grad_(grad), d,
                                     torch.zeros(256, device=card), torch.ones((3, 256), device=card),
                                     torch.ones(256, dtype=torch.bool, device=card),
                                     torch.Generator(device=card).manual_seed(0)))
        launches.append((vertex.LAUNCHES - fused, mis.LAUNCHES - before))
    assert launches == [(1, 0), (0, 0)] and outs[1].throughput.requires_grad
    kernel, plain = outs
    assert torch.equal(kernel.cont, plain.cont) and kernel.cont.any()
    for name in ("radiance_add", "o", "d", "tm", "throughput"):
        got, want = getattr(kernel, name), getattr(plain, name).detach()
        scale = want.abs().clamp_min(1e-30) if want.dim() == 1 else want.norm(dim=0, keepdim=True).clamp_min(1e-30)
        assert float(((got - want).abs() / scale).max()) <= 1e-5, name
    assert math.isfinite(float(kernel.radiance_add.sum()))
