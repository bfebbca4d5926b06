"""Unbaked transforms and constant media against the JAX package:
candidate_t and hit_details on cornell_smoke's rotated boxes, closest_hit
on a Cornell box with two rotated solid boxes, the media's boundary spans,
and the media's free flights by their statistics."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from raytracer2022_tpu.ops import intersect as jx  # noqa: E402
from raytracer2022_tpu.scene import library as jlib  # noqa: E402
from raytracer2022_tpu.scene.builder import SceneBuilder as JaxBuilder  # noqa: E402
from raytracer2022_tpu_torch.ops import intersect as tx  # noqa: E402
from raytracer2022_tpu_torch.scene import library as tlib  # noqa: E402
from raytracer2022_tpu_torch.scene.builder import SceneBuilder as TorchBuilder  # noqa: E402
from raytracer2022_tpu_torch.scene.types import BOX, MEDIUM  # noqa: E402

torch.set_num_threads(1)

T_MIN = 1e-3
RTOL_T = 2e-5  # f32 formulas; the XLA CPU build fuses multiply-adds
N_RAYS = 4096


def _rays(seed, n=N_RAYS):
    return chip_smoke.random_rays(np.random.default_rng(seed), n, 1.0, 554.0)


def _t(x):
    return torch.as_tensor(x)


def _assert_t_close(t_ref, t_got):
    t_ref, t_got = np.asarray(t_ref), np.asarray(t_got)
    np.testing.assert_array_equal(np.isfinite(t_ref), np.isfinite(t_got))
    f = np.isfinite(t_ref)
    np.testing.assert_allclose(t_got[f], t_ref[f], rtol=RTOL_T, atol=RTOL_T)


@pytest.fixture(scope="module")
def smoke():
    return jlib.cornell_smoke().scene, tlib.cornell_smoke(device="cpu").scene


def _box_ids(scene):
    """Global ids of the scene's BOX prims (cornell_smoke: the two rotated
    medium boundaries)."""
    return np.nonzero(np.asarray(scene.kind) == BOX)[0]


def test_candidate_t_on_rotated_boxes_matches_jax(smoke):
    js, ts = smoke
    assert ts.any_xform and ts.any_medium
    o, d, tm = _rays(1)
    for include_inactive in (False, True):
        t_ref = jx.candidate_t(js, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm), T_MIN, jnp.inf,
                               include_inactive=include_inactive)
        t_got = tx.candidate_t(ts, _t(o), _t(d), _t(tm), T_MIN, float("inf"),
                               include_inactive=include_inactive)
        _assert_t_close(t_ref, t_got.numpy())
    boxes = _box_ids(ts)
    assert len(boxes) == 2 and np.isfinite(t_got.numpy()[boxes]).mean() > 0.05


def test_hit_details_on_rotated_boxes_matches_jax(smoke):
    """The winners forced to the rotated boxes: object-space face choice,
    world-space p and normal, uv and front, as JAX's."""
    js, ts = smoke
    o, d, tm = _rays(2)
    t_all = tx.candidate_t(ts, _t(o), _t(d), _t(tm), T_MIN, float("inf"), include_inactive=True)
    boxes = _box_ids(ts)
    t_box, arg = t_all[boxes].min(dim=0)
    hit = torch.isfinite(t_box)
    best = torch.as_tensor(boxes)[arg]
    safe_t = torch.where(hit, t_box, 1.0)
    h_got, s_got = tx.hit_details(ts, _t(o), _t(d), _t(tm), safe_t, best, hit)
    h_ref, s_ref = jx.hit_details(js, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm),
                                  jnp.asarray(safe_t.numpy()), jnp.asarray(best.numpy().astype(np.int32)),
                                  jnp.asarray(hit.numpy()))
    m = hit.numpy()
    assert m.sum() > 500
    for f in ("p", "normal"):
        np.testing.assert_allclose(getattr(h_got, f).numpy()[:, m], np.asarray(getattr(h_ref, f))[:, m],
                                   rtol=1e-4, atol=1e-4)
    for f in ("u", "v"):
        np.testing.assert_allclose(getattr(h_got, f).numpy()[m], np.asarray(getattr(h_ref, f))[m],
                                   rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(h_got.front.numpy()[m], np.asarray(h_ref.front)[m])
    np.testing.assert_array_equal(s_got.mat_kind.numpy()[m], np.asarray(s_ref.mat_kind)[m])
    # the world-space normal is not axis-aligned: the rotation was undone
    n = h_got.normal.numpy()[:, m]
    assert (np.abs(n[0]) > 0.1).any() and (np.abs(n[2]) > 0.1).any() and (np.abs(n) < 0.99).any()


def _rotated_cornell(b, **finalize_kw):
    """Book3's Cornell box with its two rotated solid boxes (scene.rs)."""
    red = b.lambertian((0.65, 0.05, 0.05))
    white = b.lambertian((0.73, 0.73, 0.73))
    green = b.lambertian((0.12, 0.45, 0.15))
    light = b.rect_xz(213, 343, 227, 332, 554, b.diffuse_light((15.0, 15.0, 15.0)))
    b.flip_face(light)
    b.add_light(light)
    b.rect_yz(0, 555, 0, 555, 555, green)
    b.rect_yz(0, 555, 0, 555, 0, red)
    b.rect_xz(0, 555, 0, 555, 0, white)
    b.rect_xz(0, 555, 0, 555, 555, white)
    b.rect_xy(0, 555, 0, 555, 555, white)
    box1 = b.box((0, 0, 0), (165, 330, 165), white)
    b.rotate_y(box1, 15.0)
    b.translate(box1, (265, 0, 295))
    box2 = b.box((0, 0, 0), (165, 165, 165), b.metal((0.8, 0.85, 0.88), 0.0))
    b.rotate_y(box2, -18.0)
    b.translate(box2, (130, 0, 65))
    return b.finalize(**finalize_kw)


def test_closest_hit_with_rotated_boxes_matches_jax():
    js, ts = _rotated_cornell(JaxBuilder()), _rotated_cornell(TorchBuilder(), device="cpu")
    o, d, tm = _rays(3)
    h_ref, s_ref = jx.closest_hit(js, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm), T_MIN, jnp.inf,
                                  jax.random.PRNGKey(0))
    h_got, s_got = tx.closest_hit(ts, _t(o), _t(d), _t(tm), T_MIN, float("inf"))
    hit = np.asarray(h_ref.hit)
    np.testing.assert_array_equal(h_got.hit.numpy(), hit)
    _assert_t_close(np.where(hit, h_ref.t, np.inf), np.where(hit, h_got.t.numpy(), np.inf))
    same = hit & (np.asarray(h_ref.prim) == h_got.prim.numpy())
    assert same.sum() >= 0.99 * hit.sum()
    on_box = same & (ts.kind.numpy()[h_got.prim.numpy()] == BOX)
    assert on_box.sum() > 300
    for f in ("p", "normal"):
        np.testing.assert_allclose(getattr(h_got, f).numpy()[:, same], np.asarray(getattr(h_ref, f))[:, same],
                                   rtol=1e-4, atol=1e-4)
    for f in ("u", "v"):
        np.testing.assert_allclose(getattr(h_got, f).numpy()[same], np.asarray(getattr(h_ref, f))[same],
                                   rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(h_got.front.numpy()[same], np.asarray(h_ref.front)[same])
    np.testing.assert_array_equal(h_got.mat.numpy()[same], np.asarray(h_ref.mat)[same])


def _aimed_rays(seed, n, target_lo, target_hi):
    """Rays from the camera side aimed at points inside a box region."""
    rng = np.random.default_rng(seed)
    o = np.stack([rng.uniform(50, 500, n), rng.uniform(50, 500, n), np.full(n, -200.0)]).astype(np.float32)
    tgt = rng.uniform(target_lo, target_hi, (n, 3)).T.astype(np.float32)
    return o, (tgt - o).astype(np.float32), rng.uniform(0, 1, n).astype(np.float32)


def test_medium_boundary_spans_match_jax(smoke):
    """The deterministic parts of _medium_t: the entry in (-inf, inf) and
    the exit after it, on each medium's (rotated, inactive) boundary."""
    js, ts = smoke
    o, d, tm = _aimed_rays(4, N_RAYS, (120, 10, 60), (420, 320, 470))
    assert ts.stats.mediums == js.stats.mediums and len(ts.stats.mediums) == 2
    for _, b0, cnt in ts.stats.mediums:
        sl = slice(b0, b0 + cnt)
        args_j = (jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm))
        args_t = (_t(o), _t(d), _t(tm))
        e_ref = jnp.min(jx.candidate_t(js, *args_j, -jnp.inf, jnp.inf, prim_slice=sl, include_inactive=True), axis=0)
        e_got = tx.candidate_t(ts, *args_t, -float("inf"), float("inf"), prim_slice=sl,
                               include_inactive=True).amin(dim=0)
        _assert_t_close(e_ref, e_got.numpy())
        x_ref = jnp.min(jx.candidate_t(js, *args_j, e_ref + 1e-4, jnp.inf, prim_slice=sl, include_inactive=True), axis=0)
        x_got = tx.candidate_t(ts, *args_t, e_got + 1e-4, float("inf"), prim_slice=sl,
                               include_inactive=True).amin(dim=0)
        _assert_t_close(x_ref, x_got.numpy())
        assert np.isfinite(x_got.numpy()).mean() > 0.2  # the rays cross the boundary


def test_medium_free_flights_match_jax_in_distribution(smoke):
    """_medium_t's exponential free flight: the share of rays scattered in
    the medium and their mean t agree with JAX's within 5 standard errors
    (binomial for the share, sample standard deviation for the mean)."""
    js, ts = smoke
    n = 40_000
    o, d, tm = _aimed_rays(5, n, (150, 20, 300), (400, 300, 450))
    med, b0, cnt = ts.stats.mediums[0]
    t_ref = np.asarray(jx._medium_t(js, med, b0, cnt, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm),
                                    T_MIN, jax.random.PRNGKey(7)))
    t_got = tx._medium_t(ts, med, b0, cnt, _t(o), _t(d), _t(tm), T_MIN,
                         torch.Generator().manual_seed(7)).numpy()
    f_ref, f_got = np.isfinite(t_ref), np.isfinite(t_got)
    p = f_ref.mean()
    assert 0.05 < p < 0.95
    assert abs(f_got.mean() - p) < 5 * np.sqrt(2 * p * (1 - p) / n)
    se = np.sqrt(t_ref[f_ref].var() / f_ref.sum() + t_got[f_got].var() / f_got.sum())
    assert abs(t_got[f_got].mean() - t_ref[f_ref].mean()) < 5 * se


def test_medium_zero_uniform_is_a_miss(smoke, monkeypatch):
    """torch.rand may return 0: ln(0) = -inf must give a miss, not a hit."""
    _, ts = smoke
    o, d, tm = (_t(x) for x in _aimed_rays(6, 256, (150, 20, 300), (400, 300, 450)))
    med, b0, cnt = ts.stats.mediums[0]
    monkeypatch.setattr(torch, "rand", lambda shape, **kw: torch.zeros(shape))
    assert torch.isinf(tx._medium_t(ts, med, b0, cnt, o, d, tm, T_MIN, None)).all()


def test_closest_hit_media_follow_the_generator(smoke):
    """closest_hit draws the media's free flights from the generator it is
    given: the same seed gives the same hits, and medium hits occur."""
    _, ts = smoke
    o, d, tm = (_t(x) for x in _aimed_rays(8, 2048, (150, 20, 60), (400, 300, 450)))
    h1, s1 = tx.closest_hit(ts, o, d, tm, T_MIN, float("inf"), torch.Generator().manual_seed(3))
    h2, _ = tx.closest_hit(ts, o, d, tm, T_MIN, float("inf"), torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(h1.t.numpy(), h2.t.numpy())
    on_medium = (ts.kind[h1.prim] == MEDIUM) & h1.hit
    assert on_medium.any()
    assert (h1.front[on_medium]).all()  # media are always front
    assert (s1.mat_kind[on_medium] == 4).all()  # ISOTROPIC
