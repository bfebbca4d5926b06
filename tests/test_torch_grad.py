"""Gradients of the port against the JAX package and against central
differences.

Deterministic stages (closest_hit with the t recompute, the texture
dispatch, camera rays): the same numpy inputs go through both packages and
``jax.vjp`` is held against ``torch.autograd.grad`` with one random
cotangent, at rtol 1e-4, atol 1e-6.  The JAX package on the CPU walks every
tree with its cluster walk (it runs the Pallas kernel only on a TPU); the
port walks packet trees with K1's plain version.

Monte-Carlo estimators: the port's own gradient is held against central
differences of the port's own loss at the scene, size and tolerance of the
JAX package's tests/test_grad.py and tests/test_grad_geom.py (one test
each).  The random streams are fixed by the seed, so both sides of a
difference replay the same paths.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from raytracer2022_tpu.ops import intersect as jx  # noqa: E402
from raytracer2022_tpu.ops import materials as jmat  # noqa: E402
from raytracer2022_tpu.render import camera as jcam  # noqa: E402
from raytracer2022_tpu.scene.builder import SceneBuilder as JaxBuilder  # noqa: E402
from raytracer2022_tpu_torch.ops import intersect as tx  # noqa: E402
from raytracer2022_tpu_torch.ops import materials as tmat  # noqa: E402
from raytracer2022_tpu_torch.ops.sampling import uniform  # noqa: E402
from raytracer2022_tpu_torch.render import camera as tcam  # noqa: E402
from raytracer2022_tpu_torch.render.integrator import TraceConfig  # noqa: E402
from raytracer2022_tpu_torch.render.renderer import render_batch, render_batch_regen_diff  # noqa: E402
from raytracer2022_tpu_torch.scene.builder import SceneBuilder as TorchBuilder  # noqa: E402
from raytracer2022_tpu_torch.scene.types import BOX, ISOTROPIC, SPHERE, TRIANGLE  # noqa: E402

torch.set_num_threads(1)

T_MIN = 1e-3
RTOL, ATOL = 1e-4, 1e-6  # deterministic gradients, port against JAX
# A table's gradient entry sums the terms of all the rays that reach it, in
# f32 and in another order in XLA than in torch; where those terms (~1)
# cancel, the sum carries their rounding: one entry of the tree scene's
# d p / d params is 3.7e-3 and differs by 1.4e-6.  Table gradients are held
# at this atol, per-ray gradients at ATOL.
ATOL_SUM = 1e-5
KEY = jax.random.PRNGKey(0)


# ---------------------------------------------------------------------------
# deterministic stages against JAX
# ---------------------------------------------------------------------------


def _dense_scene(b, **kw):
    """A rect floor, a box, a triangle and two spheres: the dense windows."""
    m1 = b.lambertian((0.6, 0.4, 0.3))
    m2 = b.metal((0.8, 0.8, 0.8), 0.2)
    b.rect_xz(-4, 4, -4, 4, 0.0, m1)
    b.box((1, 0, 1), (2, 1.5, 2), m1)
    b.triangle((-3, 0.2, 1), (-1, 0.3, 2), (-2, 2.0, 1.5), m2)
    b.sphere((0, 1, -1), 0.8, m2)
    b.sphere((-2, 0.6, -2), 0.5, m1)
    return b.finalize(**kw)


# (aim point, jitter, distance of the origins): spheres are aimed at from
# close by, where the JAX package's f32 quadratic is well conditioned
DENSE_TARGETS = [((0.5, 0.0, -2.5), 2.0, 9.0), ((1.5, 0.75, 1.5), 0.3, 9.0), ((-2.0, 0.8, 1.5), 0.2, 9.0),
                 ((0.0, 1.0, -1.0), 0.3, 2.5), ((-2.0, 0.6, -2.0), 0.2, 1.5)]
# hits left out of the comparison, where f32 arithmetic that rounds
# differently (JAX's XLA fuses multiply-adds) moves t's derivative by more
# than rtol: sphere hits whose discriminant is below this share of half_b^2
# (JAX solves the quadratic in f32, the port in f64; ROADMAP.md, Queue 3),
# grazing hits, |cos| between the ray and the normal below GRAZING_COS,
# and triangle hits whose plane is within asin(GRAZING_COS) of the z axis
# (both packages solve the barycentric u, v as a 2x2 system in x and y)
WELL_CONDITIONED = 1e-2
GRAZING_COS = 0.2


def _tri_tree_scene(b, **kw):
    return chip_smoke.tri64_scene(b, **kw)[0]


def _xf_box_scene(b, **kw):
    """40 rotated and translated boxes: a transformed BOX tree, which both
    packages walk with the cluster walk and recompute on object-space rays."""
    rng = np.random.default_rng(5)
    white = b.lambertian((0.73, 0.73, 0.73))
    ids = [b.box(c, c + rng.uniform(0.5, 1.5, 3), white)[0] for c in rng.uniform(-4, 4, (40, 3))]
    b.rotate_y(ids, 25.0)
    b.translate(ids, (0.5, 1.0, -0.5))
    return b.finalize(bvh_threshold=16, cluster_size=8, **kw)


def _aimed_rays(rng, targets, per: int = 128):
    """Rays from the upper half of a sphere of the given distance around
    each aim point, aimed at it within the jitter."""
    o, d = [], []
    for c, jitter, dist in targets:
        n = rng.normal(size=(3, per))
        n[1] = np.abs(n[1])
        org = np.asarray(c)[:, None] + dist * n / np.linalg.norm(n, axis=0)
        o.append(org)
        d.append(np.asarray(c)[:, None] + rng.uniform(-jitter, jitter, (3, per)) - org)
    n = per * len(targets)
    return (np.concatenate(o, 1).astype(np.float32), np.concatenate(d, 1).astype(np.float32),
            rng.uniform(0, 1, n).astype(np.float32))


def _well_conditioned(scene, hit, o, d):
    """True on the hits the comparison keeps (see WELL_CONDITIONED)."""
    prim = hit.prim.numpy()
    p = scene.params.numpy().astype(np.float64)[:, prim]
    oc = o.astype(np.float64) - p[:3]
    dd = d.astype(np.float64)
    hb = (oc * dd).sum(0)
    disc = hb * hb - (dd * dd).sum(0) * ((oc * oc).sum(0) - p[3] ** 2)
    sphere = scene.kind.numpy()[prim] == SPHERE
    normal = hit.normal.detach().numpy()
    cos = (normal * dd).sum(0) / np.linalg.norm(dd, axis=0)
    flat_xy = (scene.kind.numpy()[prim] != TRIANGLE) | (np.abs(normal[2]) > GRAZING_COS)
    return (hit.hit.numpy() & (~sphere | (disc > WELL_CONDITIONED * hb * hb)) & (np.abs(cos) > GRAZING_COS)
            & flat_xy)


OUTPUTS = ("t", "p", "normal", "u", "v")


def _closest_hit_vjp_both(build, o, d, tm):
    """``(scene, {output: (jax, torch)})``: for each of closest_hit's t, p,
    normal, u and v, both packages' VJPs with respect to the rays and
    ``scene.params`` under one random cotangent on the lanes both hit
    (well-conditioned ones).  Each output is taken alone, so no gradient
    is a difference of the others' large terms."""
    js, ts = build(JaxBuilder()), build(TorchBuilder(), device="cpu")
    leaves = [torch.tensor(o, requires_grad=True), torch.tensor(d, requires_grad=True),
              ts.params.clone().requires_grad_()]
    hit, _ = tx.closest_hit(dataclasses.replace(ts, params=leaves[2]), leaves[0], leaves[1],
                            torch.as_tensor(tm), T_MIN, float("inf"))
    outs = [getattr(hit, name) for name in OUTPUTS]
    keep = _well_conditioned(ts, hit, o, d)
    assert keep.sum() > 200
    rng = np.random.default_rng(9)
    cots = [rng.normal(size=tuple(x.shape)).astype(np.float32) * keep for x in outs]

    @jax.jit
    def jf(o, d, params):
        h, _ = jx.closest_hit(js.replace(params=params), o, d, jnp.asarray(tm), T_MIN, jnp.inf, KEY)
        return tuple(getattr(h, name) for name in OUTPUTS), h.hit

    outs_j, vjp, hit_j = jax.vjp(jf, jnp.asarray(o), jnp.asarray(d), js.params, has_aux=True)
    np.testing.assert_array_equal(hit.hit.numpy(), np.asarray(hit_j))
    pairs = {}
    for i, (name, x) in enumerate(zip(OUTPUTS, outs)):
        one = tuple(jnp.asarray(c) if j == i else jnp.zeros_like(y) for j, (c, y) in enumerate(zip(cots, outs_j)))
        ref = [np.asarray(g) for g in vjp(one)]
        if x.requires_grad:  # a box's normal is constant
            got = torch.autograd.grad(x, leaves, grad_outputs=torch.as_tensor(cots[i]), retain_graph=True,
                                      allow_unused=True)
            got = [np.zeros_like(r) if g is None else g.numpy() for g, r in zip(got, ref)]
        else:
            got = [np.zeros_like(r) for r in ref]
        pairs[name] = (ref, got)
    return ts, pairs


@pytest.fixture
def exact_jax_gathers(monkeypatch):
    """The JAX package's per-ray table fetches as plain gathers: its one-hot
    MXU fetch is exact forward (three bf16 passes) but its VJP rounds the
    table's gradient to bf16 (~3e-3), so the reference takes the gather
    path, which the JAX package itself takes for large tables."""
    from raytracer2022_tpu.ops import tables

    monkeypatch.setattr(tables, "_BUDGET_ELEMS", 0)


@pytest.mark.parametrize("scene", ["dense", "tree", "xf_tree"])
def test_closest_hit_gradients_match_jax(scene, exact_jax_gathers):
    rng = np.random.default_rng(3)
    if scene == "dense":
        build, rays = _dense_scene, _aimed_rays(rng, DENSE_TARGETS)
    elif scene == "tree":
        # the 64 triangles of tests/test_grad.py, each aimed at near its
        # centroid by a few rays: a params entry then sums few f32 terms
        build = _tri_tree_scene
        p = _tri_tree_scene(TorchBuilder(), device="cpu").params.numpy()
        tris = np.where(_tri_tree_scene(TorchBuilder(), device="cpu").kind.numpy() == TRIANGLE)[0]
        cent = (p[0:3, tris] + p[3:6, tris] + p[6:9, tris]) / 3
        rays = _aimed_rays(rng, [(c, 0.2, 9.0) for c in cent.T], per=12)
    else:
        build, rays = _xf_box_scene, _aimed_rays(rng, [((0.5, 1.0, -0.5), 3.0, 9.0)], per=768)
    ts, pairs = _closest_hit_vjp_both(build, *rays)
    if scene == "tree":
        assert ts.bvh8[0] is not None and ts.stats.trees[0][0] == TRIANGLE  # plain K1
    if scene == "xf_tree":
        assert ts.bvh8 == (None,) and ts.stats.trees[0][0] == BOX and ts.stats.trees[0][4]
    for out, (ref, got) in pairs.items():
        for name, r, g, atol in zip(("o", "d", "params"), ref, got, (ATOL, ATOL, ATOL_SUM)):
            assert np.isfinite(g).all(), (out, name)
            np.testing.assert_allclose(g, r, rtol=RTOL, atol=atol, err_msg=f"d {out} / d {name}")
    assert np.abs(pairs["t"][1][2]).max() > 1e-3  # t's geometry gradients reach the params


def _texture_scene(b, **kw):
    """Every texture kind on a primitive of its own, and a light."""
    light = b.rect_xz(-1, 1, -1, 1, 6.0, b.diffuse_light((5.0, 4.0, 3.0)))
    b.add_light(light)
    b.sphere((-3, 1, 0), 1, b.lambertian((0.6, 0.3, 0.2)))
    b.sphere((0, 1, 0), 1, b.lambertian(b.checker((0.2, 0.3, 0.1), (0.9, 0.8, 0.7))))
    b.sphere((3, 1, 0), 1, b.lambertian(b.noise(4.0)))
    b.sphere((0, 1, 3), 1, b.lambertian(b.image(np.random.default_rng(1).integers(0, 256, (6, 8, 3), np.uint8))))
    img = np.random.default_rng(2).integers(0, 256, (5, 7, 3), np.uint8)
    b.triangle((-2, 0, -3), (2, 0, -3), (0, 2, -3), b.lambertian(b.objuv(img)), uv=((0, 0), (1, 0), (0.5, 1)))
    return b.finalize(**kw)


def test_texture_and_emission_gradients_match_jax(exact_jax_gathers):
    """d(texture value, emission)/d(textures.color) through closest_hit and
    the texture dispatch, for every texture kind and a light seen from
    below."""
    rng = np.random.default_rng(4)
    targets = [((-3, 1, 0), 0.3, 2.5), ((0, 1, 0), 0.3, 2.5), ((3, 1, 0), 0.3, 2.5), ((0, 1, 3), 0.3, 2.5),
               ((0, 0.7, -3), 0.3, 9.0), ((0, 6, 0), 0.5, 9.0)]
    o, d, tm = _aimed_rays(rng, targets)
    o[:, -128:] = np.array([[0.0], [-3.0], [0.0]]) + rng.uniform(-0.5, 0.5, (3, 128))  # under the light
    d[:, -128:] = np.array([[0.0], [6.0], [0.0]]) + rng.uniform(-0.5, 0.5, (3, 128)) - o[:, -128:]
    js, ts = _texture_scene(JaxBuilder()), _texture_scene(TorchBuilder(), device="cpu")
    assert {"checker", "noise", "image", "objuv"} <= set(ts.stats.features)
    c_tex = rng.normal(size=(3, o.shape[1])).astype(np.float32)
    c_em = rng.normal(size=(3, o.shape[1])).astype(np.float32)

    def jf(color):
        s = js.replace(textures=js.textures.replace(color=color))
        hit, shade = jx.closest_hit(s, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm), T_MIN, jnp.inf, KEY)
        tv = jmat.texture_value(s.textures, shade, hit, s.stats.features)
        return jnp.sum(tv * c_tex) + jnp.sum(jmat.emitted(shade, hit, tv) * c_em)

    ref = np.asarray(jax.jit(jax.grad(jf))(js.textures.color))
    color = ts.textures.color.clone().requires_grad_()
    s = dataclasses.replace(ts, textures=dataclasses.replace(ts.textures, color=color))
    hit, shade = tx.closest_hit(s, *(torch.as_tensor(x) for x in (o, d, tm)), T_MIN, float("inf"))
    tv = tmat.texture_value(s.textures, shade, hit, s.stats.features)
    loss = (tv * torch.as_tensor(c_tex)).sum() + (tmat.emitted(shade, hit, tv) * torch.as_tensor(c_em)).sum()
    (got,) = torch.autograd.grad(loss, color)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL_SUM)
    assert (np.abs(ref) > 1e-3).sum(axis=0).astype(bool).sum() >= 4  # solid, two checker colours, light


def test_camera_ray_gradients_match_jax():
    """get_rays with respect to the seven vector leaves, at lens radius 0
    (the rays then draw no random numbers that reach o and d)."""
    kw = dict(lookfrom=(1.0, 2.0, -8.0), lookat=(0.0, 1.0, 0.0), vup=(0.0, 1.0, 0.0), vfov=40.0,
              aspect_ratio=1.5)
    jc, tc = jcam.make_camera(**kw), tcam.make_camera(**kw, device="cpu")
    rng = np.random.default_rng(6)
    s, t = rng.uniform(0, 1, (2, 256)).astype(np.float32)
    co, cd = rng.normal(size=(2, 3, 256)).astype(np.float32)
    names = ("origin", "lower_left", "horizontal", "vertical", "u", "v", "w")

    def jf(*leaves):
        o, d, _ = jcam.get_rays(jc.replace(**dict(zip(names, leaves))), jnp.asarray(s), jnp.asarray(t), KEY)
        return jnp.sum(o * co) + jnp.sum(d * cd)

    ref = jax.jit(jax.grad(jf, argnums=tuple(range(7))))(*(getattr(jc, n) for n in names))
    leaves = [getattr(tc, n).clone().requires_grad_() for n in names]
    o, d, _ = tcam.get_rays(dataclasses.replace(tc, **dict(zip(names, leaves))), torch.as_tensor(s),
                            torch.as_tensor(t), torch.Generator().manual_seed(0))
    got = torch.autograd.grad((o * torch.as_tensor(co)).sum() + (d * torch.as_tensor(cd)).sum(), leaves,
                              allow_unused=True)  # w does not reach the rays
    for n, r, g in zip(names, ref, got):
        g = torch.zeros(3) if g is None else g
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=RTOL, atol=ATOL, err_msg=n)


def test_plain_k1_and_cluster_walk_give_one_gradient():
    """The CPU/card convention: the tree search runs detached and t is
    recomputed, so K1's plain version and the cluster walk give the same
    gradients (the card's K1 is held to the same in tests/test_torch_kernels.py
    and chip_smoke.py)."""
    scene, cam_kw = chip_smoke.tri64_scene(TorchBuilder(), device="cpu")
    cam = tcam.make_camera(**cam_kw, device="cpu")
    g_k1 = chip_smoke.material_grad(scene, cam)
    g_walk = chip_smoke.material_grad(dataclasses.replace(scene, bvh8=(None,)), cam)
    assert np.isfinite(g_k1).all() and np.abs(g_k1).max() > 0
    np.testing.assert_allclose(g_k1, g_walk, rtol=chip_smoke.MAT_RTOL, atol=chip_smoke.MAT_ATOL)


# ---------------------------------------------------------------------------
# the port's estimator against central differences (tests/test_grad.py)
# ---------------------------------------------------------------------------

SEED = 3
FUZZ_JUMP = 0.02  # a pixel's sum moving more under fuzz +- eps crossed a silhouette


def _mini_cornell():
    b = TorchBuilder()
    light = b.rect_xz(-1, 1, -1, 1, 3.9, b.diffuse_light((8.0, 8.0, 8.0)))
    b.flip_face(light)
    b.add_light(light)
    b.rect_xz(-4, 4, -4, 4, 0.0, b.lambertian((0.6, 0.4, 0.3)))
    b.sphere((0, 1, 0), 1, b.lambertian((0.3, 0.5, 0.7)))
    return b.finalize(device="cpu"), tcam.make_camera((0, 2, -8), (0, 1, 0), (0, 1, 0), 40, 1.0, device="cpu")


def _with_color(scene, color):
    return dataclasses.replace(scene, textures=dataclasses.replace(scene.textures, color=color))


def _with_param(scene, param):
    return dataclasses.replace(scene, materials=dataclasses.replace(scene.materials, param=param))


def _grad_and_fd(f, x0, index, eps):
    """(autograd d f / d x0[index], central difference at ``eps``, the whole
    gradient)."""
    x = x0.clone().requires_grad_()
    (g,) = torch.autograd.grad(f(x), x)
    e = torch.zeros_like(x0)
    e[index] = eps
    with torch.no_grad():
        fd = (f(x0 + e) - f(x0 - e)) / (2 * eps)
    assert torch.isfinite(g).all()
    return float(g[index]), float(fd), g


def _mean_render(scene, cam, cfg, spp=32):
    return torch.mean(render_batch(scene, cam, SEED, 12, 12, spp, cfg)) / spp


@pytest.mark.parametrize("entry", ["albedo", "emission"])
def test_albedo_and_emission_gradients_finite_difference(entry):
    scene, cam = _mini_cornell()
    cfg = TraceConfig(max_depth=6, background=(0.0, 0.0, 0.0))
    # material order is creation order: 0 light, 1 floor, 2 sphere
    tex = int(scene.materials.tex[0 if entry == "emission" else 1])
    index, eps, atol = ((1, tex), 1e-1, 1e-6) if entry == "emission" else ((0, tex), 1e-2, 1e-5)
    g, fd, _ = _grad_and_fd(lambda c: _mean_render(_with_color(scene, c), cam, cfg), scene.textures.color,
                            index, eps)
    np.testing.assert_allclose(g, fd, rtol=2e-2, atol=atol)
    assert g > 0


def test_regen_diff_albedo_gradient_finite_difference():
    scene, cam = _mini_cornell()
    cfg = TraceConfig(max_depth=6, background=(0.0, 0.0, 0.0))

    def f(c):
        img, cnt = render_batch_regen_diff(_with_color(scene, c), cam, SEED, 12, 12, 4, 8, 4 * 6 + 1, cfg)
        return torch.mean(img / cnt[None])

    g, fd, _ = _grad_and_fd(f, scene.textures.color, (0, int(scene.materials.tex[1])), 1e-2)
    np.testing.assert_allclose(g, fd, rtol=2e-2, atol=1e-5)
    assert g > 0


def test_albedo_gradient_through_bvh_scene_finite_difference():
    """Through the 64-triangle tree: the search runs detached (plain K1),
    the winner's t is recomputed."""
    scene, cam_kw = chip_smoke.tri64_scene(TorchBuilder(), device="cpu")
    assert scene.use_bvh and scene.bvh8[0] is not None
    cam = tcam.make_camera(**cam_kw, device="cpu")
    cfg = TraceConfig(max_depth=4, background=(0.0, 0.0, 0.0))
    tri_tex = int(scene.materials.tex[int(np.argmax(scene.materials.kind.numpy() == 0))])
    g, fd, _ = _grad_and_fd(lambda c: _mean_render(_with_color(scene, c), cam, cfg), scene.textures.color,
                            (0, tri_tex), 1e-2)
    assert g > 0
    np.testing.assert_allclose(g, fd, rtol=2e-2, atol=1e-5)


def test_camera_gradient_finite_difference():
    """d(mean image)/d(lookfrom y) through make_camera, on a smooth scene
    (a marble floor under an edgeless emissive dome; tests/test_grad.py)."""
    b = TorchBuilder()
    dome = b.sphere((0, 0, 0), 50, b.diffuse_light((2.0, 2.0, 2.0)))
    b.flip_face(dome)
    b.rect_xz(-30, 30, -30, 30, 0.0, b.lambertian(b.noise(0.5)))
    scene = b.finalize(device="cpu")
    cfg = TraceConfig(max_depth=2, background=(0.0, 0.0, 0.0))

    def f(y):
        lookfrom = torch.stack([torch.zeros_like(y), y, torch.full_like(y, -2.0)])
        cam = tcam.make_camera(lookfrom, (0.0, 0.0, -1.9), (0, 1, 0), 30, 1.0, device="cpu")
        return _mean_render(scene, cam, cfg)

    g, fd, _ = _grad_and_fd(f, torch.tensor(8.0), (), 1e-3)
    assert abs(g) > 1e-6
    np.testing.assert_allclose(g, fd, rtol=5e-2, atol=1e-6)


def test_fuzz_gradient_finite_difference():
    """Metal fuzz under the sky gradient (tests/test_grad.py), over the
    pixels that the fuzz moves smoothly.  Where a jittered reflection
    crosses the sphere's self-reflection silhouette between fuzz - eps and
    + eps, its pixel's sum jumps by about a sample's radiance (0.09-0.9
    against at most 0.003 elsewhere, seeds 1-8): a step of the image that
    autograd, having no boundary term, leaves out, and that swamps the
    central difference of the whole mean on most streams (at eps 5e-4 on
    this seed -0.0065 against the gradient's 0.00066).  So the pixels
    whose sum moves by more than FUZZ_JUMP between the two sides are left
    out of both, as the ir test leaves out the lanes whose reflect/refract
    pick flips, and the sum is taken in float64, so that the difference is
    not the float32 mean's rounding (steps of 6e-5 here)."""
    b = TorchBuilder()
    b.sphere((0, 0, 0), 1, b.metal((0.9, 0.9, 0.9), 0.3))
    scene = b.finalize(device="cpu")
    cam = tcam.make_camera((0, 1.5, -4), (0, 0, 0), (0, 1, 0), 30, 1.0, device="cpu")
    cfg = TraceConfig(max_depth=3, background=None)
    metal = int(np.argmax(scene.materials.kind.numpy() == 1))
    p0, eps, spp = scene.materials.param, 5e-4, 64

    def image(p):
        return render_batch(_with_param(scene, p), cam, SEED, 12, 12, spp, cfg)

    e = torch.zeros_like(p0)
    e[metal] = eps
    with torch.no_grad():
        smooth = (image(p0 + e) - image(p0 - e)).abs().amax(dim=0) < FUZZ_JUMP
    assert smooth.float().mean() > 0.9
    g, fd, _ = _grad_and_fd(lambda p: torch.where(smooth[None], image(p), 0.0).double().mean() / spp, p0,
                            (metal,), eps)
    assert abs(g) > 1e-4
    np.testing.assert_allclose(g, fd, rtol=0.1, atol=1e-5)


def test_ir_gradient_finite_difference():
    """Dielectric IOR: d(scattered direction)/d(ir) through closest_hit and
    scatter on the lanes whose reflect/refract pick does not flip under
    +-eps (tests/test_grad.py), then the render-level gradient is finite
    and non-zero."""
    b = TorchBuilder()
    b.rect_xz(-8, 8, -8, 8, 2.0, b.dielectric(1.5))
    scene = b.finalize(device="cpu")
    diel = int(np.argmax(scene.materials.kind.numpy() == 2))
    rng = np.random.default_rng(5)
    n = 256
    o = torch.tensor(np.tile([[3.0], [6.0], [-3.0]], (1, n)), dtype=torch.float32)
    t = torch.as_tensor(rng.normal(size=(3, n)) * np.array([[2.0], [0.0], [2.0]]), dtype=torch.float32)
    d = t + torch.tensor([[0.0], [2.0], [0.5]]) - o
    tm = torch.zeros(n)
    probe = torch.as_tensor(rng.normal(size=(3, n)), dtype=torch.float32)

    def spec_dirs(param):
        s = _with_param(scene, param)
        gen = torch.Generator().manual_seed(2)
        hit, shade = tx.closest_hit(s, o, d, tm, 1e-3, float("inf"), gen)
        sc = tmat.scatter(shade, hit, tmat.texture_value(s.textures, shade, hit, s.stats.features), d, tm,
                          uniform(gen, (3, n)))
        return torch.where((hit.hit & sc.is_specular)[None], sc.spec_dir, 0.0)

    p0 = scene.materials.param
    e = torch.zeros_like(p0)
    e[diel] = 1e-3
    with torch.no_grad():
        mask = torch.linalg.norm(spec_dirs(p0 + e) - spec_dirs(p0 - e), dim=0) < 0.1
    assert int(mask.sum()) > 50
    g, fd, _ = _grad_and_fd(lambda p: torch.sum(torch.where(mask[None], spec_dirs(p) * probe, 0.0)), p0,
                            (diel,), 1e-3)
    assert abs(g) > 1e-3
    np.testing.assert_allclose(g, fd, rtol=2e-2, atol=1e-4)

    cam = tcam.make_camera((3, 6, -3), (0, 0, 0.5), (0, 1, 0), 35, 1.0, device="cpu")
    cfg = TraceConfig(max_depth=3, background=None)
    x = p0.clone().requires_grad_()
    (gr,) = torch.autograd.grad(_mean_render(_with_param(scene, x), cam, cfg), x)
    assert torch.isfinite(gr).all() and abs(float(gr[diel])) > 1e-5


def test_medium_gradient_is_finite():
    """Through a constant medium (isotropic phase function and the free
    flight of ``_medium_t``): the medium's albedo gets a finite, positive
    gradient and every other entry stays finite."""
    b = TorchBuilder()
    dome = b.sphere((0, 0, 0), 50, b.diffuse_light((2.0, 2.0, 2.0)))
    b.flip_face(dome)
    boundary = b.sphere((0, 0, 0), 1.5, b.dielectric(1.5))
    b.constant_medium([boundary], 0.8, (0.5, 0.6, 0.7))
    scene = b.finalize(device="cpu")
    assert len(scene.stats.mediums) == 1
    cam = tcam.make_camera((0, 0.5, -5), (0, 0, 0), (0, 1, 0), 35, 1.0, device="cpu")
    cfg = TraceConfig(max_depth=6, background=(0.0, 0.0, 0.0))
    iso = int(np.argmax(scene.materials.kind.numpy() == ISOTROPIC))
    assert int(scene.materials.kind[iso]) == ISOTROPIC
    color = scene.textures.color.clone().requires_grad_()
    (g,) = torch.autograd.grad(_mean_render(_with_color(scene, color), cam, cfg, spp=16), color)
    assert torch.isfinite(g).all()
    assert (g[:, int(scene.materials.tex[iso])] > 0).all()


def test_regen_diff_drain_gradient_finite_difference():
    """Through the narrow drain's gather and index_add (tests/test_grad.py)."""
    scene, cam = _mini_cornell()
    cfg = TraceConfig(max_depth=6, background=(0.0, 0.0, 0.0))

    def f(c):
        img, cnt = render_batch_regen_diff(_with_color(scene, c), cam, SEED, 12, 12, 4, 8, 18, cfg, n_drain=6)
        return torch.mean(img / torch.clamp(cnt, min=1)[None])

    g, fd, _ = _grad_and_fd(f, scene.textures.color, (0, int(scene.materials.tex[1])), 1e-2)
    np.testing.assert_allclose(g, fd, rtol=2e-2, atol=1e-5)


# ---------------------------------------------------------------------------
# geometry gradients through the packet tree (tests/test_grad_geom.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,row,eps", [(SPHERE, 1, 5e-4), (SPHERE, 3, 5e-4), (TRIANGLE, 1, 2e-3)])
def test_geometry_gradient_through_packet_tree_finite_difference(kind, row, eps):
    """d(mean image)/d(scene.params[row, col]) of a sphere's centre y and
    radius and a triangle's vertex a_y, through render_batch_regen_diff
    with K1's plain version: the search sees the baked tree, the recompute
    and the normals see the perturbed params."""
    build = chip_smoke.geom_sphere_scene if kind == SPHERE else chip_smoke.geom_triangle_scene
    scene, cam_kw, col = build(TorchBuilder(), device="cpu")
    assert scene.bvh8[0] is not None and int(scene.kind[col]) == kind
    cam = tcam.make_camera(**cam_kw, device="cpu")

    def f(params):
        return chip_smoke.geometry_loss(dataclasses.replace(scene, params=params), cam)

    g, fd, _ = _grad_and_fd(f, scene.params, (row, col), eps)
    assert abs(g) > 1e-5
    np.testing.assert_allclose(g, fd, rtol=2e-2, atol=3e-4)
