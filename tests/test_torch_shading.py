"""Shading parity: emission, solid textures, the lambertian pdf, the light
pdfs and camera rays against the JAX package, and the port's samplers by
their moments (as tests/test_sampling.py does for the JAX ones)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from raytracer2022_tpu.ops import intersect as jx  # noqa: E402
from raytracer2022_tpu.ops import lights as jlights  # noqa: E402
from raytracer2022_tpu.ops import materials as jmat  # noqa: E402
from raytracer2022_tpu.render import camera as jcam  # noqa: E402
from raytracer2022_tpu.scene.builder import SceneBuilder as JaxBuilder  # noqa: E402
from raytracer2022_tpu_torch.ops import intersect as tx  # noqa: E402
from raytracer2022_tpu_torch.ops import lights as tlights  # noqa: E402
from raytracer2022_tpu_torch.ops import materials as tmat  # noqa: E402
from raytracer2022_tpu_torch.ops import sampling as sp  # noqa: E402
from raytracer2022_tpu_torch.ops.vecmath import onb_from_w, onb_local  # noqa: E402
from raytracer2022_tpu_torch.render import camera as tcam  # noqa: E402
from raytracer2022_tpu_torch.scene.builder import SceneBuilder as TorchBuilder  # noqa: E402

torch.set_num_threads(1)

N = 50_000
T_MIN = 1e-3


def _lit_scene(b, **finalize_kw):
    """Two rect lights (one per axis family), a sphere light, and surfaces
    of all four surface materials."""
    for x0, x1, z0, z1, k in ((213, 343, 127, 232, 554.0), (100, 200, 127, 232, 300.0)):
        light = b.rect_xz(x0, x1, z0, z1, k, b.diffuse_light((15.0, 15.0, 15.0)))
        b.flip_face(light)
        b.add_light(light)
    b.add_light(b.rect_xy(100, 200, 50, 150, 500, b.diffuse_light((4.0, 5.0, 6.0))))
    b.add_light(b.sphere((400, 400, 300), 40, b.diffuse_light((8.0, 8.0, 8.0))))
    b.rect_xz(0, 555, 0, 555, 0, b.lambertian((0.73, 0.73, 0.73)))
    b.rect_yz(0, 555, 0, 555, 555, b.lambertian((0.65, 0.05, 0.05)))
    b.sphere((190, 90, 190), 90, b.dielectric(1.5))
    b.sphere((380, 90, 190), 80, b.metal((0.8, 0.85, 0.88), 0.0))
    return b.finalize(**finalize_kw)


@pytest.fixture(scope="module")
def scenes():
    return _lit_scene(JaxBuilder()), _lit_scene(TorchBuilder(), device="cpu")


def _rays(n=2048, seed=4):
    rng = np.random.default_rng(seed)
    o = rng.uniform(20, 535, (3, n)).astype(np.float32)
    d = rng.normal(size=(3, n)).astype(np.float32)
    tm = rng.uniform(0, 1, n).astype(np.float32)
    return o, d, tm


def _hits(scenes, seed=4):
    js, ts = scenes
    o, d, tm = _rays(seed=seed)
    hj, sj = jx.closest_hit(js, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm), T_MIN,
                            jnp.inf, jax.random.PRNGKey(0))
    ht, st = tx.closest_hit(ts, *(torch.as_tensor(x) for x in (o, d, tm)), T_MIN, float("inf"))
    hit = np.asarray(hj.hit)
    np.testing.assert_array_equal(ht.hit.numpy(), hit)
    same = hit & (np.asarray(hj.prim) == ht.prim.numpy())
    assert hit.mean() > 0.3 and same.sum() >= 0.99 * hit.sum()
    return (hj, sj), (ht, st), same, d


def test_texture_value_and_emitted_match_jax(scenes):
    (hj, sj), (ht, st), same, _ = _hits(scenes)
    tv_j = jmat.texture_value(scenes[0].textures, sj, hj, scenes[0].stats.features)
    tv_t = tmat.texture_value(scenes[1].textures, st, ht, scenes[1].stats.features)
    np.testing.assert_array_equal(tv_t.numpy()[:, same], np.asarray(tv_j)[:, same])
    em_j = np.asarray(jmat.emitted(sj, hj, tv_j))
    em_t = tmat.emitted(st, ht, tv_t).numpy()
    np.testing.assert_array_equal(em_t[:, same], em_j[:, same])
    assert em_t[:, same].any()  # some rays see a light's front face


def test_scatter_deterministic_parts_match_jax(scenes):
    """Attenuation and the fuzz-0 metal / lambertian flags do not depend on
    the random numbers."""
    (hj, sj), (ht, st), same, d = _hits(scenes)
    tv_j = jmat.texture_value(scenes[0].textures, sj, hj, frozenset())
    tv_t = tmat.texture_value(scenes[1].textures, st, ht, frozenset())
    sc_j = jmat.scatter(sj, hj, tv_j, jnp.asarray(d), hj.t, jax.random.PRNGKey(1))
    sc_t = tmat.scatter(st, ht, tv_t, torch.as_tensor(d), ht.t, sp.uniform(_gen(1), (3, ht.t.shape[0])))
    for f in ("has_scatter", "is_specular"):
        np.testing.assert_array_equal(getattr(sc_t, f).numpy()[same], np.asarray(getattr(sc_j, f))[same])
    np.testing.assert_array_equal(sc_t.attenuation.numpy()[:, same], np.asarray(sc_j.attenuation)[:, same])
    metal = same & (st.mat_kind.numpy() == 1)
    assert metal.any()
    np.testing.assert_allclose(sc_t.spec_dir.numpy()[:, metal], np.asarray(sc_j.spec_dir)[:, metal],
                               rtol=1e-4, atol=1e-5)


def test_scattering_pdf_lambertian_matches_jax():
    rng = np.random.default_rng(9)
    n = rng.normal(size=(3, 1000)).astype(np.float32)
    n /= np.linalg.norm(n, axis=0)
    v = rng.normal(size=(3, 1000)).astype(np.float32)
    ref = np.asarray(jmat.scattering_pdf_lambertian(jnp.asarray(n), jnp.asarray(v)))
    got = tmat.scattering_pdf_lambertian(torch.as_tensor(n), torch.as_tensor(v)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
    assert (got == 0).any() and (got > 0).any()


def test_lights_pdf_matches_jax(scenes):
    js, ts = scenes
    rng = np.random.default_rng(6)
    p = rng.uniform(20, 535, (3, 4096)).astype(np.float32)
    # aim half the directions at the lights so the pdfs are exercised
    targets = np.array([[278, 554, 180], [150, 300, 180], [150, 100, 500], [400, 400, 300]], np.float32).T
    v = rng.normal(size=(3, 4096)).astype(np.float32)
    aim = targets[:, rng.integers(0, 4, 4096)] + rng.normal(0, 20, (3, 4096)).astype(np.float32) - p
    v[:, ::2] = aim[:, ::2]
    tm = np.zeros(4096, np.float32)
    ref = np.asarray(jlights.lights_pdf(js, jnp.asarray(p), jnp.asarray(v), jnp.asarray(tm)))
    got = tlights.lights_pdf(ts, *(torch.as_tensor(x) for x in (p, v, tm))).numpy()
    assert (got > 0).mean() > 0.2
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    f = ~np.isnan(ref)
    np.testing.assert_allclose(got[f], ref[f], rtol=2e-4, atol=1e-7)


def test_sample_lights_hits_the_lights(scenes):
    """Every sampled direction leads from p onto one of the lights."""
    _, ts = scenes
    rng = np.random.default_rng(8)
    p = torch.as_tensor(rng.uniform(20, 500, (3, 4096)).astype(np.float32))
    gen = torch.Generator().manual_seed(3)
    pick = torch.randint(0, len(ts.stats.light_ids), (4096,), generator=gen)
    sphere_u, rect_u = (tuple(sp.uniform(gen, (2, 4096))) for _ in range(2))
    d = tlights.light_directions(ts, p, pick, sphere_u, rect_u)
    t = tx.candidate_t(ts, p, d, torch.zeros(4096), 1e-3, float("inf"))
    light_rows = torch.tensor(ts.stats.light_ids)
    # the sampled light is hit (possibly behind an occluder: test the lights only)
    assert torch.isfinite(t[light_rows]).any(dim=0).float().mean() > 0.99
    picks = torch.isfinite(t[light_rows]).float().mean(dim=1)
    assert (picks > 0.1).all()  # every light gets picked


def test_get_rays_match_jax_with_zero_aperture():
    kw = dict(lookfrom=(278.0, 278.0, -800.0), lookat=(278.0, 278.0, 0.0), vup=(0.0, 1.0, 0.0),
              vfov=40.0, aspect_ratio=1.5, aperture=0.0, focus_dist=10.0)
    rng = np.random.default_rng(2)
    s, t = rng.uniform(0, 1, (2, 500)).astype(np.float32)
    oj, dj, _ = jcam.get_rays(jcam.make_camera(**kw), jnp.asarray(s), jnp.asarray(t), jax.random.PRNGKey(0))
    ot, dt, tmt = tcam.get_rays(tcam.make_camera(**kw, device="cpu"), torch.as_tensor(s), torch.as_tensor(t),
                                torch.Generator().manual_seed(0))
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5, atol=1e-4)
    assert ((tmt >= 0) & (tmt < 1)).all()


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_uniform_in_unit_sphere_moments():
    v = sp.in_unit_ball_local(*sp.uniform(_gen(0), (3, N))).numpy()
    r = np.linalg.norm(v, axis=0)
    assert r.max() <= 1.0 + 1e-6
    assert abs(r.mean() - 0.75) < 5e-3
    assert np.abs(v.mean(axis=1)).max() < 5e-3
    u = r**3
    assert abs(u.mean() - 0.5) < 5e-3
    assert abs(np.var(u) - 1 / 12) < 5e-3


def test_uniform_in_unit_disk_moments():
    v = sp.uniform_in_unit_disk(_gen(1), (N,)).numpy()
    assert np.all(v[2] == 0)
    r2 = v[0] ** 2 + v[1] ** 2
    assert r2.max() <= 1.0 + 1e-6
    assert abs(r2.mean() - 0.5) < 5e-3


def test_cosine_direction_moments():
    v = sp.cosine_local(*sp.uniform(_gen(2), (2, N))).numpy()
    assert v[2].min() >= 0.0
    assert abs(v[2].mean() - 2 / 3) < 5e-3
    np.testing.assert_allclose(np.linalg.norm(v, axis=0), 1.0, rtol=1e-4)


def test_cosine_about_normal_respects_axis():
    normal = torch.zeros((3, N))
    normal[1] = 1.0
    v = onb_local(*onb_from_w(normal), sp.cosine_local(*sp.uniform(_gen(3), (2, N)))).numpy()
    assert v[1].min() >= -1e-6
    assert abs(v[1].mean() - 2 / 3) < 5e-3


def test_to_sphere_cone():
    v = sp.sphere_cone_local(*sp.uniform(_gen(4), (2, N)), torch.full((N,), 0.5), torch.full((N,), 4.0)).numpy()
    cos_max = math.sqrt(1 - 0.25 / 4.0)
    assert v[2].min() >= cos_max - 1e-5
    assert abs(v[2].mean() - (1 + cos_max) / 2) < 5e-3
    np.testing.assert_allclose(np.linalg.norm(v, axis=0), 1.0, rtol=1e-4)


def test_uniform_on_unit_sphere_moments_and_cos_pdf():
    v = sp.on_unit_sphere_local(*sp.uniform(_gen(6), (2, N))).numpy()
    np.testing.assert_allclose(np.linalg.norm(v, axis=0), 1.0, rtol=1e-4)
    assert np.abs(v.mean(axis=1)).max() < 5e-3
    assert np.abs(v.var(axis=1) - 1 / 3).max() < 5e-3
    w = torch.zeros((3, N))
    w[2] = 1.0
    pdf = sp.cos_pdf_value(torch.as_tensor(v), w).numpy()
    np.testing.assert_allclose(pdf, np.where(v[2] <= 0, 0.0, v[2] / math.pi), rtol=1e-4, atol=1e-6)


def test_generator_streams_are_reproducible():
    a = sp.in_unit_ball_local(*sp.uniform(_gen(5), (3, 64)))
    b = sp.in_unit_ball_local(*sp.uniform(_gen(5), (3, 64)))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
