"""Intersection parity: the port's per-kind formulas, candidate_t,
closest_hit and hit_details against the JAX package on the same scene and
rays (scenes compiled by both packages, rays from a numpy seed)."""

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
from raytracer2022_tpu_torch.scene.types import BOX, MEDIUM, MSPHERE, RECT, RING, SPHERE, TRIANGLE  # noqa: E402

torch.set_num_threads(1)

T_MIN = 1e-3
N_RAYS = 512
RTOL_T = 2e-5  # as tests/test_bvh8.py: f32 formulas, XLA fuses multiply-adds
KINDS = [SPHERE, MSPHERE, RECT, TRIANGLE, RING, BOX]


def _dense_scene(builder, kinds, seed=7, n_each=24, **finalize_kw):
    """Random dense prims of the given kinds (below the tree threshold)."""
    rng = np.random.default_rng(seed)
    b = builder
    mats = [
        b.lambertian((0.5, 0.4, 0.3)),
        b.metal((0.8, 0.8, 0.9), 0.2),
        b.dielectric(1.5),
        b.diffuse_light((4.0, 4.0, 4.0)),
    ]
    for k in kinds:
        for i in range(n_each):
            m = mats[int(rng.integers(0, len(mats)))]
            c = rng.uniform(-20, 20, 3)
            if k == SPHERE:
                pid = b.sphere(c, rng.uniform(0.5, 3.0), m)
            elif k == MSPHERE:
                pid = b.moving_sphere(c, c + rng.uniform(-2, 2, 3), 0.0, 1.0, rng.uniform(0.5, 3.0), m)
            elif k == RECT:
                a0, b0 = c[0], c[1]
                pid = b._rect(a0, a0 + rng.uniform(1, 8), b0, b0 + rng.uniform(1, 8),
                              c[2], int(rng.integers(0, 3)), m)
            elif k == TRIANGLE:
                pid = b.triangle(c, c + rng.uniform(-5, 5, 3), c + rng.uniform(-5, 5, 3), m)
            elif k == RING:
                pid = b.ring(rng.uniform(2, 25), rng.uniform(0.05, 0.5), m)
            else:
                pid = b.box(c, c + rng.uniform(1, 6, 3), m)[0]
            if i % 5 == 0:
                b.flip_face(pid)
    return b.finalize(**finalize_kw)


def _both(kinds, seed=7):
    return _dense_scene(JaxBuilder(), kinds, seed), _dense_scene(TorchBuilder(), kinds, seed, device="cpu")


def _rays(seed=11, n=N_RAYS):
    return chip_smoke.random_rays(np.random.default_rng(seed), n, -30, 30)


def _assert_t_close(t_ref, t_got):
    t_ref, t_got = np.asarray(t_ref), np.asarray(t_got)
    np.testing.assert_array_equal(np.isfinite(t_ref), np.isfinite(t_got))
    f = np.isfinite(t_ref)
    np.testing.assert_allclose(t_got[f], t_ref[f], rtol=RTOL_T, atol=RTOL_T)


@pytest.mark.parametrize("kind", KINDS)
def test_per_kind_t_matches_jax(kind):
    js, ts = _both([kind])
    o, d, tm = _rays()
    p_j = js.params[:, :, None]
    p_t = ts.params[:, :, None]
    t_ref = jx._t_for_kind(kind, p_j, jnp.asarray(o)[:, None], jnp.asarray(d)[:, None],
                           jnp.asarray(tm)[None], T_MIN, jnp.inf)
    t_got = tx._t_for_kind(kind, p_t, torch.as_tensor(o)[:, None], torch.as_tensor(d)[:, None],
                           torch.as_tensor(tm)[None], T_MIN, float("inf"))
    assert np.isfinite(np.asarray(t_ref)).any()
    _assert_t_close(t_ref, t_got.numpy())


def test_candidate_t_matches_jax_on_mixed_scene():
    js, ts = _both(KINDS)
    o, d, tm = _rays()
    # per-lane t_max exercises the (N,) broadcast
    t_max = np.random.default_rng(3).uniform(10, 80, N_RAYS).astype(np.float32)
    t_ref = jx.candidate_t(js, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm), T_MIN, jnp.asarray(t_max))
    t_got = tx.candidate_t(ts, *(torch.as_tensor(x) for x in (o, d, tm)), T_MIN, torch.as_tensor(t_max))
    assert t_got.shape == (ts.n_prims, N_RAYS)
    _assert_t_close(t_ref, t_got.numpy())
    # a window straddling two kind ranges takes the masked switch
    sl = slice(10, 60)
    t_ref = jx.candidate_t(js, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm), T_MIN, jnp.inf, prim_slice=sl)
    t_got = tx.candidate_t(ts, *(torch.as_tensor(x) for x in (o, d, tm)), T_MIN, float("inf"), prim_slice=sl)
    _assert_t_close(t_ref, t_got.numpy())


def _compare_hits(h_ref, s_ref, h_got, s_got, min_same=0.99):
    hit = np.asarray(h_ref.hit)
    np.testing.assert_array_equal(h_got.hit.numpy(), hit)
    assert hit.any()
    _assert_t_close(np.where(hit, h_ref.t, np.inf), np.where(hit, h_got.t.numpy(), np.inf))
    same = (np.asarray(h_ref.prim) == h_got.prim.numpy()) & hit
    # ids differ only on exact-t ties between two prims
    assert same.sum() >= min_same * hit.sum()
    np.testing.assert_allclose(h_got.p.numpy()[:, same], np.asarray(h_ref.p)[:, same], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        h_got.normal.numpy()[:, same], np.asarray(h_ref.normal)[:, same], rtol=1e-4, atol=1e-4
    )
    np.testing.assert_array_equal(h_got.front.numpy()[same], np.asarray(h_ref.front)[same])
    np.testing.assert_array_equal(h_got.mat.numpy()[same], np.asarray(h_ref.mat)[same])
    np.testing.assert_array_equal(s_got.mat_kind.numpy()[same], np.asarray(s_ref.mat_kind)[same])
    np.testing.assert_array_equal(s_got.color.numpy()[:, same], np.asarray(s_ref.color)[:, same])
    return same


def test_dense_closest_hit_and_hit_details_match_jax():
    js, ts = _both(KINDS)
    o, d, tm = _rays(seed=12)
    h_ref, s_ref = jx.closest_hit(js, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm),
                                  T_MIN, jnp.inf, jax.random.PRNGKey(0))
    h_got, s_got = tx.closest_hit(ts, *(torch.as_tensor(x) for x in (o, d, tm)), T_MIN, float("inf"))
    same = _compare_hits(h_ref, s_ref, h_got, s_got)
    kinds_hit = set(ts.kind.numpy()[h_got.prim.numpy()[same]].tolist())
    assert {SPHERE, RECT, TRIANGLE, BOX} <= kinds_hit
    for uv in ("u", "v"):
        np.testing.assert_allclose(
            getattr(h_got, uv).numpy()[same], np.asarray(getattr(h_ref, uv))[same],
            rtol=1e-4, atol=1e-4,
        )


def test_tree_closest_hit_matches_jax_cluster_walk():
    """The stand-in mesh: the port walks the TRIANGLE tree with the 8-ary
    plain version (winner-rows branch of hit_details), the JAX package on
    the CPU with its cluster walk (table-fetch branch)."""
    jb, tb = JaxBuilder(), TorchBuilder()
    chip_smoke.stand_in_mesh_scene(jb, 24, 12)
    chip_smoke.stand_in_mesh_scene(tb, 24, 12)
    js, ts = jb.finalize(), tb.finalize(device="cpu")
    o, d, tm = chip_smoke.random_rays(np.random.default_rng(21), N_RAYS, 1.0, 554.0)
    h_ref, s_ref = jx.closest_hit(js, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm),
                                  T_MIN, jnp.inf, jax.random.PRNGKey(0))
    h_got, s_got = tx.closest_hit(ts, *(torch.as_tensor(x) for x in (o, d, tm)), T_MIN, float("inf"))
    same = _compare_hits(h_ref, s_ref, h_got, s_got)
    in_tree = h_got.prim.numpy() < ts.stats.n_in_bvh
    assert (same & in_tree).sum() > 50  # the tree branch is exercised


def test_unported_scene_parts_raise():
    """cornell_smoke (media with rotated box boundaries), which the port
    once refused, now runs closest_hit: where neither package's medium
    scattered the ray, both find the same surface hit."""
    js, smoke = jlib.cornell_smoke().scene, tlib.cornell_smoke(device="cpu").scene
    o, d, tm = _rays(n=2048)
    o = (np.abs(o) % 500 + 20).astype(np.float32)  # origins inside the box
    h_ref, _ = jx.closest_hit(js, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm), T_MIN, jnp.inf,
                              jax.random.PRNGKey(0))
    h_got, _ = tx.closest_hit(smoke, *(torch.as_tensor(x) for x in (o, d, tm)), T_MIN, float("inf"),
                              torch.Generator().manual_seed(0))
    kind = smoke.kind.numpy()
    med_ref = kind[np.asarray(h_ref.prim)] == MEDIUM
    med_got = kind[h_got.prim.numpy()] == MEDIUM
    assert med_got.any() and med_ref.any()
    surf = ~med_ref & ~med_got
    np.testing.assert_array_equal(h_got.hit.numpy()[surf], np.asarray(h_ref.hit)[surf])
    _assert_t_close(np.asarray(h_ref.t)[surf], h_got.t.numpy()[surf])
    np.testing.assert_array_equal(h_got.prim.numpy()[surf], np.asarray(h_ref.prim)[surf])
