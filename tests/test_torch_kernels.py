"""Kernel K1 on the card against its plain PyTorch version.

No JAX here, so the file also runs on a card machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

Tests marked ``cuda`` skip without a CUDA device; the parity contract is
chip_smoke.check_parity.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from raytracer2022_tpu_torch.ops.bvh8 import FAR, traverse_bvh8, traverse_bvh8_plain
from raytracer2022_tpu_torch.ops.intersect import closest_hit
from raytracer2022_tpu_torch.render.camera import get_rays, make_camera
from raytracer2022_tpu_torch.scene.builder import SceneBuilder
from raytracer2022_tpu_torch.scene.types import MEDIUM, TRIANGLE, Bvh8Tree

torch.set_num_threads(1)

T_MIN = 1e-3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 is CUDA C++ and has no CPU mode")
    return torch.device("cuda")


def _on(tree: Bvh8Tree, device) -> Bvh8Tree:
    return Bvh8Tree(*(x.to(device) for x in (tree.entries, tree.boxes, tree.prows, tree.axorder)))


def _both(tree, kind, o, d, tm, t_init, device):
    """(plain version on the CPU, kernel on the card) as numpy triples."""
    ti = torch.full_like(tm, FAR) if t_init is None else torch.clamp(t_init, max=FAR)
    ref = traverse_bvh8_plain(tree, kind, o, d, tm, T_MIN, ti)
    before = traverse_bvh8.launches
    got = traverse_bvh8(
        _on(tree, device), kind, o.to(device), d.to(device), tm.to(device), T_MIN,
        t_init=None if t_init is None else t_init.to(device), return_rows=True,
    )
    assert traverse_bvh8.launches == before + 1
    return [x.numpy() for x in ref], [x.cpu().numpy() for x in got]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("t_init", ["none", "inf", "finite"])
def test_kernel_matches_plain(cuda_device, kind, t_init):
    rng = np.random.default_rng(1234 + kind)
    scene = chip_smoke.small_tree_scene(SceneBuilder(), kind, rng)
    o, d, tm = (torch.as_tensor(x) for x in chip_smoke.random_rays(rng, 4096, -30, 30))
    ti = {
        "none": None,
        "inf": torch.full_like(tm, float("inf")),
        "finite": torch.as_tensor(rng.uniform(5, 60, 4096).astype(np.float32)),
    }[t_init]
    ref, got = _both(scene.bvh8[0], kind, o, d, tm, ti, cuda_device)
    rep = chip_smoke.check_parity(kind, ref, got)
    assert rep["hits"] > 0


@pytest.mark.cuda
def test_kernel_on_stand_in_mesh_camera_rays(cuda_device):
    b = SceneBuilder()
    cam = make_camera(**chip_smoke.stand_in_mesh_scene(b, 24, 12))
    scene = b.finalize()
    gen = torch.Generator().manual_seed(0)
    uv = torch.rand((2, 64 * 64), generator=gen)
    o, d, tm = get_rays(cam, uv[0], uv[1], gen)
    ref, got = _both(scene.bvh8[0], TRIANGLE, o, d, tm, None, cuda_device)
    rep = chip_smoke.check_parity(TRIANGLE, ref, got)
    assert rep["hits"] > 100 and rep["max_abs_err"] == 0.0


@pytest.mark.cuda
def test_closest_hit_on_the_card_goes_through_the_kernel(cuda_device):
    b = SceneBuilder()
    chip_smoke.stand_in_mesh_scene(b, 24, 12)
    rays = [torch.as_tensor(x) for x in chip_smoke.random_rays(np.random.default_rng(5), 2048, 1.0, 554.0)]
    cpu_scene = b.finalize()
    gpu_scene = b.finalize(device=cuda_device)
    h_cpu, _ = closest_hit(cpu_scene, *rays, T_MIN, float("inf"))
    before = traverse_bvh8.launches
    h_gpu, _ = closest_hit(gpu_scene, *(x.to(cuda_device) for x in rays), T_MIN, float("inf"))
    assert traverse_bvh8.launches == before + 1
    np.testing.assert_array_equal(h_gpu.hit.cpu().numpy(), h_cpu.hit.numpy())
    hit = h_cpu.hit.numpy()
    np.testing.assert_allclose(h_gpu.t.cpu().numpy()[hit], h_cpu.t.numpy()[hit], rtol=2e-5, atol=2e-5)
    assert (h_gpu.prim.cpu().numpy()[hit] == h_cpu.prim.numpy()[hit]).mean() >= 0.99


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_cannot_take(cuda_device):
    scene = chip_smoke.small_tree_scene(SceneBuilder(), TRIANGLE, np.random.default_rng(0))
    tree = _on(scene.bvh8[0], cuda_device)
    o, d, tm = (torch.as_tensor(x, device=cuda_device) for x in chip_smoke.random_rays(np.random.default_rng(1), 64, -30, 30))
    with pytest.raises(ValueError, match="float32"):
        traverse_bvh8(tree, TRIANGLE, o.double(), d, tm, T_MIN)
    with pytest.raises(ValueError, match="contiguous"):
        traverse_bvh8(tree, TRIANGLE, o.T.contiguous().T, d, tm, T_MIN)
    with pytest.raises(ValueError):
        traverse_bvh8(scene.bvh8[0], TRIANGLE, o, d, tm, T_MIN)  # tree left on the CPU


def test_unsupported_kind_is_refused():
    scene = chip_smoke.small_tree_scene(SceneBuilder(), TRIANGLE, np.random.default_rng(0))
    o, d, tm = (torch.as_tensor(x) for x in chip_smoke.random_rays(np.random.default_rng(1), 8, -30, 30))
    with pytest.raises(ValueError, match="unsupported kind"):
        traverse_bvh8(scene.bvh8[0], MEDIUM, o, d, tm, T_MIN)
