"""K1 (8-ary BVH walk): the port's plain version and its reference walk
against the JAX Pallas kernel in interpret mode.  The CUDA kernel against
the plain version and the reference walk is in tests/test_torch_kernels.py,
which runs on the card without JAX.

Parity contract (chip_smoke.check_parity): the same hit mask, t within
rtol/atol 2e-5, at least 99% of winner ids equal (RING: t only), and the
winner rows equal wherever the ids are.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from raytracer2022_tpu.ops.bvh8 import traverse_bvh8 as jax_traverse_bvh8
from raytracer2022_tpu.scene.builder import SceneBuilder as JaxBuilder
from raytracer2022_tpu.scene.types import MSPHERE, RECT, RING, SPHERE, TRIANGLE
from raytracer2022_tpu_torch.ops import bvh8
from raytracer2022_tpu_torch.ops.bvh8 import (
    FAR, SENT, traverse_bvh8, traverse_bvh8_plain, walk_bvh8_reference,
)
from raytracer2022_tpu_torch.scene.builder import SceneBuilder as TorchBuilder

torch.set_num_threads(1)

T_MIN = 1e-3
KINDS = [SPHERE, MSPHERE, RECT, TRIANGLE, RING]


def _scenes(kind, seed=1234):
    """The same generated single-kind scene through both compilers."""
    js = chip_smoke.small_tree_scene(JaxBuilder(), kind, np.random.default_rng(seed))
    ts = chip_smoke.small_tree_scene(TorchBuilder(), kind, np.random.default_rng(seed), device="cpu")
    rays = chip_smoke.random_rays(np.random.default_rng(seed + 1), 256, -30, 30)
    return js, ts, rays


def _port(tree, kind, rays, t_init=None):
    o, d, tm = (torch.as_tensor(x) for x in rays)
    ti = None if t_init is None else torch.as_tensor(t_init)
    out = traverse_bvh8(tree, kind, o, d, tm, T_MIN, t_init=ti, return_rows=True)
    return [x.cpu().numpy() for x in out]


def _jax(tree, kind, rays, t_init=None):
    o, d, tm = (jnp.asarray(x) for x in rays)
    ti = None if t_init is None else jnp.asarray(t_init)
    out = jax_traverse_bvh8(
        tree, kind, o, d, tm, T_MIN, t_init=ti, interpret=True, return_rows=True
    )
    return [np.asarray(x) for x in out]


@pytest.mark.parametrize("kind", KINDS)
def test_plain_matches_jax_interpret(kind):
    js, ts, rays = _scenes(kind)
    assert ts.bvh8[0] is not None
    ref = _jax(js.bvh8[0], kind, rays)
    got = _port(ts.bvh8[0], kind, rays)
    rep = chip_smoke.check_parity(kind, ref, got)
    assert rep["hits"] > 0


def test_plain_matches_jax_with_finite_t_init():
    """A finite running t_init (the dense windows' result on the main path)
    prunes identically: hits beyond it are dropped, t keeps t_init."""
    js, ts, rays = _scenes(TRIANGLE)
    t_init = np.random.default_rng(5).uniform(5.0, 60.0, rays[2].shape).astype(np.float32)
    ref = _jax(js.bvh8[0], TRIANGLE, rays, t_init)
    got = _port(ts.bvh8[0], TRIANGLE, rays, t_init)
    chip_smoke.check_parity(TRIANGLE, ref, got)
    np.testing.assert_array_equal(got[0][got[1] < 0], t_init[got[1] < 0])


def test_inf_t_init_equals_far_default():
    """+inf t_init (closest_hit's no-hit-yet lanes) behaves exactly like the
    FAR default: an all-miss leaf never updates."""
    _, ts, rays = _scenes(SPHERE)
    t0, b0, r0 = _port(ts.bvh8[0], SPHERE, rays)
    t1, b1, r1 = _port(ts.bvh8[0], SPHERE, rays, np.full(rays[2].shape, np.inf, np.float32))
    np.testing.assert_array_equal(b0, b1)
    np.testing.assert_array_equal(t0, t1)
    np.testing.assert_array_equal(r0, r1)
    assert (t0[b0 < 0] == np.float32(FAR)).all()


def test_t_init_prunes():
    _, ts, rays = _scenes(SPHERE)
    t8, b8, _ = _port(ts.bvh8[0], SPHERE, rays)
    # with t_init at half the found t, nothing can beat it -> best == -1
    t_half = np.where(b8 >= 0, t8 * 0.5, 1e30).astype(np.float32)
    t2, b2, rows2 = _port(ts.bvh8[0], SPHERE, rays, t_half)
    assert (b2 == -1).all()
    np.testing.assert_allclose(t2, t_half, rtol=1e-6)
    assert not rows2.any()


def test_winner_rows_are_the_scene_rows():
    """The winner row carries the prim's params, pid, material, flip, kind."""
    from raytracer2022_tpu_torch.ops.bvh8 import COL_FLIP, COL_KIND, COL_MAT, COL_PID

    _, ts, rays = _scenes(TRIANGLE)
    _, b, rows = _port(ts.bvh8[0], TRIANGLE, rays)
    hit = b >= 0
    assert hit.any()
    bb = b[hit]
    np.testing.assert_array_equal(rows[:16, hit], ts.params.numpy()[:, bb])
    np.testing.assert_array_equal(np.round(rows[COL_PID, hit]).astype(int), bb)
    np.testing.assert_array_equal(np.round(rows[COL_MAT, hit]).astype(int), ts.mat_id.numpy()[bb])
    np.testing.assert_array_equal(rows[COL_FLIP, hit] > 0.5, ts.flip.numpy()[bb])
    assert (rows[COL_KIND, hit] == TRIANGLE).all()


def test_plain_chunking_does_not_change_the_result(monkeypatch):
    """The plain version's chunk size only bounds memory."""
    from raytracer2022_tpu_torch.ops import bvh8

    _, ts, rays = _scenes(RECT)
    o, d, tm = (torch.as_tensor(x) for x in rays)
    ti = torch.full_like(tm, FAR)
    full = traverse_bvh8_plain(ts.bvh8[0], RECT, o, d, tm, T_MIN, ti)
    monkeypatch.setattr(bvh8, "_PLAIN_ELEMS", 256 * 5)  # 5-row chunks
    chunked = traverse_bvh8_plain(ts.bvh8[0], RECT, o, d, tm, T_MIN, ti)
    for a, b in zip(full, chunked):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def _walk(tree, kind, rays, t_init=None):
    n = rays[2].shape[0]
    ti = np.full(n, FAR, np.float32) if t_init is None else np.minimum(t_init, np.float32(FAR))
    return walk_bvh8_reference(tree, kind, *rays, T_MIN, ti)


def _tree_depth(tree) -> int:
    e = tree.entries.numpy().reshape(-1, 8)

    def depth(g):
        return 1 + max([depth(int(c)) for c in e[g] if 0 <= c != SENT] or [0])

    return depth(0)


@pytest.mark.parametrize("kind", KINDS)
def test_reference_walk_matches_plain_and_jax(kind):
    """The kernel's walk, ray by ray in numpy, finds the plain version's
    and the JAX kernel's hits; it visits the root first and never stacks
    deeper than the tree."""
    js, ts, rays = _scenes(kind)
    t, best, groups, leaves, deepest = _walk(ts.bvh8[0], kind, rays)
    walk = (t, best, None)
    plain = _port(ts.bvh8[0], kind, rays)
    rep = chip_smoke.check_parity(kind, (plain[0], plain[1], None), walk)
    assert rep["hits"] > 0
    chip_smoke.check_parity(kind, _jax(js.bvh8[0], kind, rays), walk)
    assert (groups >= 1).all() and (leaves[best >= 0] >= 1).all()
    assert deepest.max() <= _tree_depth(ts.bvh8[0]) <= bvh8.MAX_DEPTH


def _small_mesh_rays(cam_kw, n=384, seed=21):
    """Half camera-like rays from the camera towards the torus, half
    bounce-like rays from inside the box."""
    rng = np.random.default_rng(seed)
    o_r, d_r, tm_r = chip_smoke.random_rays(rng, n // 2, 1.0, 554.0)
    target = rng.uniform(np.array(chip_smoke.TORUS_CENTER) - 180, np.array(chip_smoke.TORUS_CENTER) + 180,
                         (n // 2, 3)).T
    o_c = np.broadcast_to(np.asarray(cam_kw["lookfrom"], np.float32)[:, None], (3, n // 2))
    d_c = (target - o_c).astype(np.float32)
    tm_c = rng.uniform(0, 1, n // 2).astype(np.float32)
    return (np.concatenate([o_c, o_r], 1).astype(np.float32), np.concatenate([d_c, d_r], 1),
            np.concatenate([tm_c, tm_r]))


@pytest.mark.parametrize("t_init", ["inf", "finite"])
def test_reference_walk_on_small_mesh(t_init):
    """The small stand-in mesh (576 triangles) with +inf and with a finite
    running t_init, as closest_hit passes the dense windows' result."""
    jb, tb = JaxBuilder(), TorchBuilder()
    cam_kw = chip_smoke.stand_in_mesh_scene(jb, 24, 12)
    chip_smoke.stand_in_mesh_scene(tb, 24, 12)
    js, ts = jb.finalize(), tb.finalize(device="cpu")
    rays = _small_mesh_rays(cam_kw)
    n = rays[2].shape[0]
    rng = np.random.default_rng(3)
    ti = {"inf": np.full(n, np.inf, np.float32),
          "finite": rng.uniform(200.0, 1200.0, n).astype(np.float32)}[t_init]
    t, best, groups, leaves, deepest = _walk(ts.bvh8[0], TRIANGLE, rays, ti)
    walk = (t, best, None)
    plain = _port(ts.bvh8[0], TRIANGLE, rays, ti)
    rep = chip_smoke.check_parity(TRIANGLE, (plain[0], plain[1], None), walk)
    assert rep["hits"] > 50 and rep["max_abs_err"] == 0.0
    chip_smoke.check_parity(TRIANGLE, _jax(js.bvh8[0], TRIANGLE, rays, ti), walk)
    np.testing.assert_array_equal(t[best < 0], np.minimum(ti, np.float32(FAR))[best < 0])
    assert groups.max() > 1 and leaves.max() > 1
    assert deepest.max() <= _tree_depth(ts.bvh8[0])


def _mesh_tree():
    tb = TorchBuilder()
    chip_smoke.stand_in_mesh_scene(tb, 24, 12)
    return tb.finalize(device="cpu").bvh8[0]


def test_build_refuses_a_tree_deeper_than_the_kernel_stack():
    """build_bvh8 checks the kernel's stack bound, one word per group
    level: a tree one level past it (the nested set one scale deeper) is
    refused, as the JAX package's stack bound refuses it."""
    assert _tree_depth(_mesh_tree()) <= bvh8.MAX_DEPTH
    jb, tb = JaxBuilder(), TorchBuilder()
    chip_smoke.nested_triangles(jb, chip_smoke.NESTED_TOO_DEEP)
    chip_smoke.nested_triangles(tb, chip_smoke.NESTED_TOO_DEEP)
    with pytest.raises(ValueError, match=f"depth {bvh8.MAX_DEPTH + 1} .*MAX_DEPTH={bvh8.MAX_DEPTH}"):
        tb.finalize(device="cpu")
    with pytest.raises(AssertionError, match=f"tree depth {bvh8.MAX_DEPTH + 1}"):
        jb.finalize()


def test_depth_cap_matches_jax():
    """MAX_DEPTH is the deepest tree the JAX package's stack bound,
    (FANOUT - 1) * depth + 1 <= MAX_STACK, admits."""
    from raytracer2022_tpu.ops import bvh8 as jax_bvh8

    admitted = [d for d in range(1, 100) if (jax_bvh8.FANOUT - 1) * d + 1 <= jax_bvh8.MAX_STACK]
    assert bvh8.MAX_DEPTH == max(admitted) == 22
    assert bvh8.tree_depth(_mesh_tree().entries.numpy()) == _tree_depth(_mesh_tree())


@pytest.fixture(scope="module")
def deep_scenes():
    """The nested triangle set at the cap (22 group levels) through both
    compilers."""
    jb, tb = JaxBuilder(), TorchBuilder()
    chip_smoke.nested_triangles(jb)
    chip_smoke.nested_triangles(tb)
    return jb.finalize(), tb.finalize(device="cpu")


def _closest(scene, rays):
    from raytracer2022_tpu_torch.ops.intersect import closest_hit

    h, _ = closest_hit(scene, *(torch.as_tensor(x) for x in rays), T_MIN, float("inf"))
    return h.hit.numpy(), h.t.numpy(), h.prim.numpy()


def test_deep_tree_compiles_equal_and_closest_hit_matches_jax(deep_scenes):
    """A tree of MAX_DEPTH levels: the same arrays from both compilers, and
    the port's closest_hit (its plain walk of the packet tree) finds JAX's
    hits (its cluster walk on the CPU) on 256 rays that walk the deepest
    paths."""
    import jax

    from raytracer2022_tpu.ops.intersect import closest_hit as jax_closest_hit

    js, ts = deep_scenes
    assert _tree_depth(ts.bvh8[0]) == bvh8.tree_depth(ts.bvh8[0].entries.numpy()) == bvh8.MAX_DEPTH
    for name in ("entries", "boxes", "prows", "axorder"):
        np.testing.assert_array_equal(getattr(ts.bvh8[0], name).numpy(), np.asarray(getattr(js.bvh8[0], name)))
    rays = chip_smoke.nested_rays(np.random.default_rng(3), 256)
    h_ref, _ = jax_closest_hit(js, *(jnp.asarray(x) for x in rays), T_MIN, jnp.inf, jax.random.PRNGKey(0))
    hit, t, prim = _closest(ts, rays)
    np.testing.assert_array_equal(hit, np.asarray(h_ref.hit))
    assert hit.sum() > 50
    np.testing.assert_allclose(t[hit], np.asarray(h_ref.t)[hit], rtol=2e-5, atol=2e-5)
    assert (prim[hit] == np.asarray(h_ref.prim)[hit]).mean() >= chip_smoke.MIN_ID_MATCH


def test_deep_jax_scene_carried_across_renders_in_the_port(deep_scenes):
    """JAX's compiled deep scene through SceneData.from_numpy: the port
    finds the same hits on it as on its own compile, and renders it."""
    from raytracer2022_tpu_torch.render.camera import make_camera
    from raytracer2022_tpu_torch.render.renderer import RenderConfig, render_sum_n
    from raytracer2022_tpu_torch.scene.types import SceneData
    from test_torch_scene import jax_scene_arrays

    js, ts = deep_scenes
    carried = SceneData.from_numpy(jax_scene_arrays(js), js.stats, "cpu")
    rays = chip_smoke.nested_rays(np.random.default_rng(4), 128)
    for a, b in zip(_closest(carried, rays), _closest(ts, rays)):
        np.testing.assert_array_equal(a, b)
    cam = make_camera(**chip_smoke.nested_triangles(TorchBuilder(), 1), device="cpu")
    total, n = render_sum_n(carried, cam, RenderConfig(width=8, height=8, spp=2, max_depth=3, background=None))
    img = (total / n).numpy()
    assert img.shape == (3, 8, 8) and np.isfinite(img).all() and img.mean() > 1e-3


@pytest.fixture(scope="module")
def too_deep_tree():
    """The nested set one scale past the cap, built with the check lifted:
    a tree of MAX_DEPTH + 1 levels."""
    tb = TorchBuilder()
    chip_smoke.nested_triangles(tb, chip_smoke.NESTED_TOO_DEEP)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bvh8, "MAX_DEPTH", bvh8.MAX_DEPTH + 1)
        scene = tb.finalize(device="cpu")
    assert _tree_depth(scene.bvh8[0]) == bvh8.MAX_DEPTH + 1
    return scene


def test_from_numpy_refuses_a_tree_deeper_than_the_kernel_stack(too_deep_tree):
    """A tree built elsewhere is checked as build_bvh8 checks its own, so
    no tree the port accepts reaches the kernel's stack guard."""
    from raytracer2022_tpu_torch.scene.types import SceneData

    arrays = too_deep_tree.to_numpy()
    with pytest.raises(ValueError, match=f"depth {bvh8.MAX_DEPTH + 1} "):
        SceneData.from_numpy(arrays, too_deep_tree.stats, "cpu")
    bad = dict(arrays, bvh8=[dict(arrays["bvh8"][0], entries=np.zeros_like(arrays["bvh8"][0]["entries"]))])
    with pytest.raises(ValueError, match="not a tree"):
        SceneData.from_numpy(bad, too_deep_tree.stats, "cpu")


def test_plain_and_reference_walk_have_no_depth_limit(too_deep_tree):
    """The plain version and the reference walk take a tree past the
    kernel's cap and agree on it."""
    rays = chip_smoke.nested_rays(np.random.default_rng(5), 64, chip_smoke.NESTED_TOO_DEEP)
    t, best, groups, _, deepest = _walk(too_deep_tree.bvh8[0], TRIANGLE, rays)
    plain = _port(too_deep_tree.bvh8[0], TRIANGLE, rays)
    rep = chip_smoke.check_parity(TRIANGLE, (plain[0], plain[1], None), (t, best, None))
    assert rep["hits"] > 10 and groups.max() > bvh8.MAX_DEPTH
    assert deepest.max() <= bvh8.MAX_DEPTH + 1


def test_visit_counts_need_the_kernel():
    _, ts, rays = _scenes(TRIANGLE)
    o, d, tm = (torch.as_tensor(x) for x in rays)
    with pytest.raises(ValueError, match="walk_bvh8_reference"):
        traverse_bvh8(ts.bvh8[0], TRIANGLE, o, d, tm, T_MIN, return_visits=True)
