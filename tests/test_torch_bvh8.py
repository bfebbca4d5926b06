"""K1 (8-ary BVH walk): the port's plain version against the JAX Pallas
kernel in interpret mode.  The CUDA kernel against the plain version is in
tests/test_torch_kernels.py, which runs on the card without JAX.

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
from raytracer2022_tpu_torch.ops.bvh8 import FAR, traverse_bvh8, traverse_bvh8_plain
from raytracer2022_tpu_torch.scene.builder import SceneBuilder as TorchBuilder

torch.set_num_threads(1)

T_MIN = 1e-3
KINDS = [SPHERE, MSPHERE, RECT, TRIANGLE, RING]


def _scenes(kind, seed=1234):
    """The same generated single-kind scene through both compilers."""
    js = chip_smoke.small_tree_scene(JaxBuilder(), kind, np.random.default_rng(seed))
    ts = chip_smoke.small_tree_scene(TorchBuilder(), kind, np.random.default_rng(seed))
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
