"""Texture parity: Perlin noise and turbulence against tests/oracle.py and
the JAX package, marble, checker, image (nearest, v-flip, clamp) and objuv
lookups, each through both packages' texture dispatch on the same numpy
inputs."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import oracle  # noqa: E402
from raytracer2022_tpu.ops import textures as jtex  # noqa: E402
from raytracer2022_tpu.ops.shade import shade_from_rows, shade_table  # noqa: E402
from raytracer2022_tpu.scene.builder import SceneBuilder as JaxBuilder  # noqa: E402
from raytracer2022_tpu_torch.ops import textures as ttex  # noqa: E402
from raytracer2022_tpu_torch.ops.shade import shade_for_mats  # noqa: E402
from raytracer2022_tpu_torch.scene.builder import SceneBuilder as TorchBuilder  # noqa: E402

torch.set_num_threads(1)

# the port indexes the Perlin tables exactly: f32 rounding of the oracle
RTOL_ORACLE, ATOL_ORACLE = 1e-5, 1e-6
# the JAX package fetches gradients in two bf16 passes (tests/test_textures.py:68,80)
RTOL_NOISE_JAX, ATOL_NOISE_JAX = 2e-3, 2e-4
RTOL_TURB_JAX, ATOL_TURB_JAX = 5e-3, 5e-4


def _scene(builder, make_tex, uv_tri=False, **finalize_kw):
    tid = make_tex(builder)
    mat = builder.lambertian(tid)
    if uv_tri:
        builder.triangle((0, 0, 0), (1, 0, 0), (0, 1, 0), mat, uv=((0, 0), (1, 0), (0, 1)))
    else:
        builder.sphere((0, 0, 0), 1, mat)
    return builder.finalize(**finalize_kw)


def _both(make_tex, uv_tri=False):
    return _scene(JaxBuilder(), make_tex, uv_tri), _scene(TorchBuilder(), make_tex, uv_tri, device="cpu")


def _eval_both(scenes, p, u=None, v=None, tex_uv=None):
    """Both packages' texture value (3, N) of prim 0's material at ``p``."""
    js, ts = scenes
    n = p.shape[1]
    u = np.zeros(n, np.float32) if u is None else np.asarray(u, np.float32)
    v = np.zeros(n, np.float32) if v is None else np.asarray(v, np.float32)
    tex_uv = np.zeros((2, n), np.float32) if tex_uv is None else np.asarray(tex_uv, np.float32)
    srows = shade_table(js)
    sj = shade_from_rows(jnp.broadcast_to(srows[:, 0:1], (srows.shape[0], n)), js.stats.features)
    ref = jtex.eval_texture_shade(js.textures, sj, jnp.asarray(u), jnp.asarray(v), jnp.asarray(p),
                                  jnp.asarray(tex_uv), js.stats.features)
    st = shade_for_mats(ts, ts.mat_id[torch.zeros(n, dtype=torch.long)].long())
    got = ttex.eval_texture_shade(ts.textures, st, torch.as_tensor(u), torch.as_tensor(v),
                                  torch.as_tensor(p), torch.as_tensor(tex_uv), ts.stats.features)
    return np.asarray(ref), got.numpy()


def _perlin_inputs(seed, n, lo, hi):
    p32 = np.random.default_rng(seed).uniform(lo, hi, (3, n)).astype(np.float32)
    return p32, p32.astype(np.float64)  # the oracle sees the same (f32) points


def test_perlin_noise_against_oracle_and_jax():
    js, ts = _both(lambda b: b.noise(4.0))
    p32, p64 = _perlin_inputs(0, 256, -10, 10)
    got = ttex.perlin_noise(ts.textures, torch.as_tensor(p32)).numpy()
    vec, perm = ts.textures.perlin_vec.numpy(), ts.textures.perlin_perm.numpy()
    expect = np.array([oracle.perlin_noise(vec, perm, p64[:, i]) for i in range(p64.shape[1])])
    np.testing.assert_allclose(got, expect, rtol=RTOL_ORACLE, atol=ATOL_ORACLE)
    ref = np.asarray(jtex.perlin_noise(js.textures, jnp.asarray(p32)))
    np.testing.assert_allclose(got, ref, rtol=RTOL_NOISE_JAX, atol=ATOL_NOISE_JAX)
    assert np.abs(got).max() > 0.1  # not a trivially flat field


def test_perlin_turb_and_marble_against_oracle_and_jax():
    scenes = _both(lambda b: b.noise(4.0))
    ts = scenes[1]
    p32, p64 = _perlin_inputs(1, 128, -5, 5)
    got = ttex.perlin_turb(ts.textures, torch.as_tensor(p32)).numpy()
    vec, perm = ts.textures.perlin_vec.numpy(), ts.textures.perlin_perm.numpy()
    expect = np.array([oracle.perlin_turb(vec, perm, p64[:, i]) for i in range(p64.shape[1])])
    np.testing.assert_allclose(got, expect, rtol=RTOL_ORACLE, atol=ATOL_ORACLE)
    ref = np.asarray(jtex.perlin_turb(scenes[0].textures, jnp.asarray(p32)))
    np.testing.assert_allclose(got, ref, rtol=RTOL_TURB_JAX, atol=ATOL_TURB_JAX)
    # marble through the dispatch (texture/mod.rs:76-78)
    ref_v, got_v = _eval_both(scenes, p32)
    marble = 0.5 * (1 + np.sin(4.0 * p64[2] + 10 * expect))
    np.testing.assert_allclose(got_v, np.broadcast_to(marble, got_v.shape), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_v, ref_v, rtol=RTOL_TURB_JAX, atol=5e-3)


def test_perlin_integer_corners():
    """Negative and lattice-aligned coordinates: floor, & 255 and the XOR on
    int32, as the reference's usize arithmetic."""
    ts = _scene(TorchBuilder(), lambda b: b.noise(1.0), device="cpu")
    pts = np.array([[-256.0, -1.0, 0.0, 255.0, 256.0, -0.5, 1e3 + 0.25],
                    [-3.0, 0.0, 1.0, -255.5, 7.0, -0.5, -1e3 - 0.75],
                    [0.0, -1.0, 2.0, 3.0, -4.0, -0.5, 0.5]], np.float32)
    got = ttex.perlin_noise(ts.textures, torch.as_tensor(pts)).numpy()
    vec, perm = ts.textures.perlin_vec.numpy(), ts.textures.perlin_perm.numpy()
    expect = [oracle.perlin_noise(vec, perm, pts[:, i].astype(np.float64)) for i in range(pts.shape[1])]
    np.testing.assert_allclose(got, expect, rtol=RTOL_ORACLE, atol=ATOL_ORACLE)


def test_checker_matches_jax():
    scenes = _both(lambda b: b.checker((0.2, 0.3, 0.1), (0.9, 0.9, 0.9)))
    p = np.random.default_rng(2).uniform(-2, 2, (3, 256)).astype(np.float32)
    ref, got = _eval_both(scenes, p)
    np.testing.assert_array_equal(got, ref)
    sines = np.sin(10 * p[0]) * np.sin(10 * p[1]) * np.sin(10 * p[2])
    assert (sines < 0).any() and (sines >= 0).any()


def _corner_image():
    img = np.zeros((2, 4, 3), dtype=np.uint8)
    img[0, 0] = [255, 0, 0]  # top-left in the file
    img[1, 3] = [0, 0, 255]  # bottom-right in the file
    img[0, 2] = [10, 200, 30]
    return img


@pytest.mark.parametrize(
    "u,v,expect",
    [
        ((0.0, 1.0), (1.0, 0.0), ((1, 0, 0), (0, 0, 1))),  # v = 1 is the file's top row
        ((-0.5, 1.5), (1.7, -0.3), ((1, 0, 0), (0, 0, 1))),  # u, v clamp to [0, 1]
        ((0.6, 0.3), (0.9, 0.2), ((10 / 255, 200 / 255, 30 / 255), (0, 0, 0))),
    ],
)
def test_image_nearest_flip_clamp(u, v, expect):
    scenes = _both(lambda b: b.image(_corner_image()))
    p = np.zeros((3, 2), np.float32)
    ref, got = _eval_both(scenes, p, u=u, v=v)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_allclose(got.T, np.asarray(expect) * 255 / 255.999, atol=1e-6)


def test_objuv_matches_jax():
    """ObjTexture: uv from the hit record's interpolated per-vertex uvs,
    indexed from the image top, nearest texel, clipped at the edges."""
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (5, 7, 3), dtype=np.uint8)
    scenes = _both(lambda b: b.objuv(img), uv_tri=True)
    tex_uv = rng.uniform(-0.2, 1.2, (2, 512)).astype(np.float32)
    p = np.zeros((3, 512), np.float32)
    ref, got = _eval_both(scenes, p, tex_uv=tex_uv)
    np.testing.assert_array_equal(got, ref)
    assert len(np.unique(got, axis=1).T) > 20  # many distinct texels
