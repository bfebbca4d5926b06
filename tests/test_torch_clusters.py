"""The cluster walk against the JAX package's ``traverse_clusters``, on a
rotated sphere cluster and a rotated (transformed) box cluster of more
than 512 prims cut into several clusters, and a mixed scene (a TRIANGLE
mesh with a packet tree plus a rotated sphere cluster) through
``closest_hit``.

Sphere t: the JAX package solves the sphere quadratic in f32 (with fused
multiply-adds on the XLA CPU build).  Its discriminant cancels to about
f32 epsilon times half_b^2, so where the discriminant is below 1e-4 of
half_b^2 (grazing rays, or small spheres seen from afar) its root moves by
more than rtol 2e-5, and below 1e-6 the hit itself may come and go.  The
port solves the quadratic in f64 (ROADMAP.md, Queue 3).  So every sphere
hit of the port is held to the f64 root at rtol 2e-5, and to JAX's hit
mask and t at rtol 2e-5 wherever JAX's own root is well conditioned."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from raytracer2022_tpu.ops import intersect as jx  # noqa: E402
from raytracer2022_tpu.scene.builder import SceneBuilder as JaxBuilder  # noqa: E402
from raytracer2022_tpu_torch.ops import bvh8  # noqa: E402
from raytracer2022_tpu_torch.ops import intersect as tx  # noqa: E402
from raytracer2022_tpu_torch.scene.builder import SceneBuilder as TorchBuilder  # noqa: E402
from raytracer2022_tpu_torch.scene.types import BOX, SPHERE, TRIANGLE  # noqa: E402

torch.set_num_threads(1)

T_MIN = 1e-3
RTOL_T = 2e-5
GRAZING = 1e-4  # disc / half_b^2 below this: JAX's f32 root is ill-conditioned
SIGN_FLIP = 1e-6  # below this JAX's f32 discriminant may even change sign


def cluster_scene(b, kind=SPHERE, n=640, cluster_size=128, floor=True, **finalize_kw):
    """``n`` rotated and translated spheres or boxes (final_scene's cluster
    transform), one tree cut into ceil(n / cluster_size)-ish clusters, and a
    floor rect in the dense tail."""
    rng = np.random.default_rng(5)
    white = b.lambertian((0.73, 0.73, 0.73))
    if kind == SPHERE:
        ids = [b.sphere(c, 10, white) for c in rng.uniform(0, 165, (n, 3))]
    else:
        ids = [b.box(c, c + rng.uniform(2, 9, 3), white)[0] for c in rng.uniform(0, 160, (n, 3))]
    b.rotate_y(ids, 15.0)
    b.translate(ids, (-100, 270, 395))
    if floor:
        b.rect_xz(-1000, 1000, -1000, 1000, 0, white)
    return b.finalize(cluster_size=cluster_size, **finalize_kw)


def _rays(seed, n=4096):
    """Rays from around and inside the cluster (which spans about
    (-100..120, 270..435, 395..600)), half of them aimed into it."""
    rng = np.random.default_rng(seed)
    lo, hi = np.array([-180.0, 190, 315]), np.array([200.0, 515, 680])
    o = rng.uniform(lo, hi, (n, 3)).T.astype(np.float32)
    d = rng.normal(size=(3, n)).astype(np.float32)
    tgt = rng.uniform((-100, 270, 395), (120, 435, 600), (n // 2, 3)).T.astype(np.float32)
    d[:, : n // 2] = tgt - o[:, : n // 2]
    return o, d, rng.uniform(0, 1, n).astype(np.float32)


def sphere_disc_ratio(params, best, o, d):
    """disc / half_b^2 of each ray's quadratic against sphere ``best``, and
    the root the sphere test takes, in f64."""
    c = params[:3, best].astype(np.float64)
    r = params[3, best].astype(np.float64)
    oc = o.astype(np.float64) - c
    dd = d.astype(np.float64)
    a = (dd * dd).sum(0)
    hb = (oc * dd).sum(0)
    disc = hb * hb - a * ((oc * oc).sum(0) - r * r)
    sq = np.sqrt(np.maximum(disc, 0))
    near = (-hb - sq) / a
    root = np.where(near >= T_MIN, near, (-hb + sq) / a)  # from inside: the far root
    return disc / np.maximum(hb * hb, 1e-300), root


def assert_hits_match(kind_of, params, o, d, t_ref, b_ref, t_got, b_got, min_same=0.99):
    """The same hit mask but for grazing sphere hits, where JAX's f32
    discriminant may change sign; t within rtol 2e-5 of JAX (of the f64
    root on grazing sphere hits); ids equal on >= ``min_same`` of the
    hits.  -> mask of the hits with equal ids."""
    t_ref, t_got = np.asarray(t_ref), np.asarray(t_got)
    b_ref, b_got = np.asarray(b_ref), np.asarray(b_got)
    hit_r, hit_g = np.isfinite(t_ref), np.isfinite(t_got)
    pid = np.where(hit_g, b_got, b_ref)
    sph = (hit_r | hit_g) & (kind_of[pid] == SPHERE)
    ratio = np.full(t_ref.shape, np.inf)
    ratio[sph], root = sphere_disc_ratio(params, pid[sph], o[:, sph], d[:, sph])
    grazing = ratio < GRAZING
    assert grazing.sum() <= 0.1 * hit_r.sum()
    # the port's sphere t is the f64 root to f32 rounding, grazing or not
    port_sph = sph & hit_g
    np.testing.assert_allclose(t_got[port_sph], root[hit_g[sph]], rtol=RTOL_T, atol=RTOL_T)
    diff = hit_r != hit_g
    flip = ratio < SIGN_FLIP
    assert (flip | ~diff).all(), f"hit masks differ on {int((diff & ~flip).sum())} rays"
    hit = hit_r & hit_g
    assert hit.sum() > 100
    same = hit & (b_ref == b_got)
    assert same.sum() >= min_same * hit.sum()
    f = hit & ~grazing
    np.testing.assert_allclose(t_got[f], t_ref[f], rtol=RTOL_T, atol=RTOL_T)
    return same


@pytest.mark.parametrize("kind", [SPHERE, BOX])
def test_cluster_walk_matches_jax(kind):
    js, ts = cluster_scene(JaxBuilder(), kind), cluster_scene(TorchBuilder(), kind, device="cpu")
    (tk, n_clusters, m, _, has_xf), = ts.stats.trees
    assert tk == kind and n_clusters >= 4 and m == 128
    assert has_xf == (kind == BOX)  # sphere transforms bake into the params
    assert ts.bvh8 == (None,)  # no packet tree: the cluster walk
    o, d, tm = _rays(1)
    t_max = np.random.default_rng(2).uniform(200, 900, o.shape[1]).astype(np.float32)
    for cap in (jnp.inf, t_max):
        t_ref, b_ref = jx.traverse_clusters(js, 0, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm), T_MIN,
                                            jnp.asarray(cap))
        cap_t = float("inf") if cap is jnp.inf else torch.as_tensor(cap)
        t_got, b_got = tx.traverse_clusters(ts, 0, *(torch.as_tensor(x) for x in (o, d, tm)), T_MIN, cap_t)
        assert_hits_match(ts.kind.numpy(), ts.params.numpy(), o, d, t_ref, b_ref, t_got.numpy(), b_got.numpy())


def test_cluster_walk_t_init_prunes():
    """A finite t_init is kept where nothing in the tree is closer, and the
    tree's hit replaces it where one is."""
    ts = cluster_scene(TorchBuilder(), SPHERE, floor=False, device="cpu")
    o, d, tm = (torch.as_tensor(x) for x in _rays(3))
    t_free, b_free = tx.traverse_clusters(ts, 0, o, d, tm, T_MIN, float("inf"))
    t_init = torch.as_tensor(np.random.default_rng(4).uniform(100, 700, o.shape[1]).astype(np.float32))
    t_got, b_got = tx.traverse_clusters(ts, 0, o, d, tm, T_MIN, float("inf"), t_init=t_init)
    closer = t_free < t_init
    assert closer.any() and (~closer).any()
    np.testing.assert_array_equal(t_got.numpy(), torch.where(closer, t_free, t_init).numpy())
    np.testing.assert_array_equal(b_got[closer].numpy(), b_free[closer].numpy())


def _mixed(b, **finalize_kw):
    """The small stand-in mesh (a TRIANGLE tree with a packet tree) plus a
    rotated sphere cluster (a SPHERE tree, cluster walk) in one scene."""
    cam = chip_smoke.stand_in_mesh_scene(b, 24, 12)
    rng = np.random.default_rng(6)
    white = b.lambertian((0.73, 0.73, 0.73))
    ids = [b.sphere(c, 8, white) for c in rng.uniform(0, 165, (600, 3))]
    b.rotate_y(ids, 15.0)
    b.translate(ids, (300, 30, 150))
    return b.finalize(cluster_size=256, **finalize_kw), cam


def test_mixed_scene_closest_hit_matches_jax():
    """closest_hit on a scene with both kinds of tree: the packet tree
    through traverse_bvh8 (its plain version here), the sphere tree through
    the cluster walk, winners fetched from the tables; JAX walks both as
    clusters."""
    (js, _), (ts, _) = _mixed(JaxBuilder()), _mixed(TorchBuilder(), device="cpu")
    kinds = [t[0] for t in ts.stats.trees]
    assert sorted(kinds) == [SPHERE, TRIANGLE]
    assert [t8 is not None for t8 in ts.bvh8] == [k == TRIANGLE for k in kinds]
    o, d, tm = chip_smoke.random_rays(np.random.default_rng(7), 4096, 1.0, 554.0)
    h_ref, s_ref = jx.closest_hit(js, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm), T_MIN, jnp.inf,
                                  jax.random.PRNGKey(0))
    before = bvh8.LAUNCHES
    h_got, s_got = tx.closest_hit(ts, *(torch.as_tensor(x) for x in (o, d, tm)), T_MIN, float("inf"))
    assert bvh8.LAUNCHES == before  # CPU tensors: the plain version, not K1
    kind_of = ts.kind.numpy()
    t_ref = np.where(h_ref.hit, h_ref.t, np.inf)
    t_got = np.where(h_got.hit.numpy(), h_got.t.numpy(), np.inf)
    same = assert_hits_match(kind_of, ts.params.numpy(), o, d, t_ref, h_ref.prim, t_got, h_got.prim.numpy())
    won = kind_of[h_got.prim.numpy()[same]]
    assert (won == TRIANGLE).sum() > 50 and (won == SPHERE).sum() > 50
    for f in ("p", "normal"):
        np.testing.assert_allclose(getattr(h_got, f).numpy()[:, same], np.asarray(getattr(h_ref, f))[:, same],
                                   rtol=2e-4, atol=2e-3)
    np.testing.assert_array_equal(h_got.front.numpy()[same], np.asarray(h_ref.front)[same])
    np.testing.assert_array_equal(h_got.mat.numpy()[same], np.asarray(h_ref.mat)[same])
    np.testing.assert_array_equal(s_got.color.numpy()[:, same], np.asarray(s_ref.color)[:, same])
