"""Kernel K1 on the card against its plain PyTorch version, its visit
counts against the reference walk, and its gradients (through the
differentiable t recompute) against the cluster walk's.

No JAX here, so the file also runs on a card machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

Tests marked ``cuda`` skip without a CUDA device; the parity contract is
chip_smoke.check_parity.  Kernel tests run both instantiations: the group
arrays in shared memory (where they fit) and in global memory.
"""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from raytracer2022_tpu_torch.ops import bvh8, intersect
from raytracer2022_tpu_torch.ops.bvh8 import FAR, traverse_bvh8, traverse_bvh8_plain, walk_bvh8_reference
from raytracer2022_tpu_torch.ops.intersect import closest_hit
from raytracer2022_tpu_torch.render.camera import get_rays, make_camera
from raytracer2022_tpu_torch.scene.builder import SceneBuilder
from raytracer2022_tpu_torch.scene.types import BOX, BVH8_ARRAYS, MEDIUM, TRIANGLE, Bvh8Tree

torch.set_num_threads(1)

T_MIN = 1e-3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 is CUDA C++ and has no CPU mode")
    return torch.device("cuda")


@pytest.fixture(params=["shared", "global"])
def tree_memory(request, monkeypatch):
    """The kernel's instantiation: ``global`` takes the global-memory one
    even where the tree fits in shared memory."""
    if request.param == "global":
        monkeypatch.setattr(bvh8, "_tree_in_shared", lambda lib, ng, depth: False)
    return request.param


def _on(tree: Bvh8Tree, device) -> Bvh8Tree:
    return dataclasses.replace(tree, **{name: getattr(tree, name).to(device) for name in BVH8_ARRAYS})


def _both(tree, kind, o, d, tm, t_init, device, plain_device="cpu"):
    """(plain version, kernel on the card) as numpy triples, and the
    kernel's visit counts."""
    ti = torch.full_like(tm, FAR) if t_init is None else torch.clamp(t_init, max=FAR)
    p = plain_device
    ref = traverse_bvh8_plain(_on(tree, p), kind, o.to(p), d.to(p), tm.to(p), T_MIN, ti.to(p))
    before = bvh8.LAUNCHES
    got = traverse_bvh8(
        _on(tree, device), kind, o.to(device), d.to(device), tm.to(device), T_MIN,
        t_init=None if t_init is None else t_init.to(device), return_rows=True, return_visits=True,
    )
    assert bvh8.LAUNCHES == before + 1
    return [x.cpu().numpy() for x in ref], [x.cpu().numpy() for x in got[:3]], got[3].cpu().numpy()


def _assert_visits(tree, kind, o, d, tm, t_init, visits, sample):
    """The kernel's visit counts equal the reference walk's on ``sample``."""
    ti = torch.full_like(tm, FAR) if t_init is None else torch.clamp(t_init, max=FAR)
    t, best, groups, leaves, _ = walk_bvh8_reference(
        tree, kind, *(x[..., sample].numpy() for x in (o, d, tm)), T_MIN, ti[sample].numpy()
    )
    np.testing.assert_array_equal(visits[0, sample], groups)
    np.testing.assert_array_equal(visits[1, sample], leaves)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("t_init", ["none", "inf", "finite"])
def test_kernel_matches_plain(cuda_device, tree_memory, kind, t_init):
    rng = np.random.default_rng(1234 + kind)
    scene = chip_smoke.small_tree_scene(SceneBuilder(), kind, rng, device="cpu")
    o, d, tm = (torch.as_tensor(x) for x in chip_smoke.random_rays(rng, 4096, -30, 30))
    ti = {
        "none": None,
        "inf": torch.full_like(tm, float("inf")),
        "finite": torch.as_tensor(rng.uniform(5, 60, 4096).astype(np.float32)),
    }[t_init]
    ref, got, visits = _both(scene.bvh8[0], kind, o, d, tm, ti, cuda_device)
    assert bvh8.TREE_MEMORY == tree_memory
    rep = chip_smoke.check_parity(kind, ref, got)
    assert rep["hits"] > 0
    _assert_visits(scene.bvh8[0], kind, o, d, tm, ti, visits, np.arange(0, 4096, 16))


@pytest.mark.cuda
def test_kernel_on_stand_in_mesh_camera_rays(cuda_device):
    b = SceneBuilder()
    cam = make_camera(**chip_smoke.stand_in_mesh_scene(b, 24, 12), device="cpu")
    scene = b.finalize(device="cpu")
    gen = torch.Generator().manual_seed(0)
    uv = torch.rand((2, 64 * 64), generator=gen)
    o, d, tm = get_rays(cam, uv[0], uv[1], gen)
    ref, got, _ = _both(scene.bvh8[0], TRIANGLE, o, d, tm, None, cuda_device)
    rep = chip_smoke.check_parity(TRIANGLE, ref, got)
    assert rep["hits"] > 100 and rep["max_abs_err"] == 0.0


@pytest.mark.cuda
def test_kernel_at_the_main_path_width(cuda_device, tree_memory):
    """262,144 rays, several per lane of the persistent grid: every ray is
    fetched once and walked as the reference walks it."""
    b = SceneBuilder()
    chip_smoke.stand_in_mesh_scene(b, 24, 12)
    scene = b.finalize(device="cpu")
    rng = np.random.default_rng(8)
    o, d, tm = (torch.as_tensor(x) for x in chip_smoke.random_rays(rng, chip_smoke.LANES, 1.0, 554.0))
    ti = torch.as_tensor(rng.uniform(100.0, 900.0, chip_smoke.LANES).astype(np.float32))
    ref, got, visits = _both(scene.bvh8[0], TRIANGLE, o, d, tm, ti, cuda_device, plain_device=cuda_device)
    assert bvh8.TREE_MEMORY == tree_memory
    rep = chip_smoke.check_parity(TRIANGLE, ref, got)
    assert rep["hits"] > 10000
    assert (visits[0] >= 1).all()
    _assert_visits(scene.bvh8[0], TRIANGLE, o, d, tm, ti, visits, rng.choice(chip_smoke.LANES, 512, replace=False))


@pytest.mark.cuda
def test_kernel_on_the_deepest_tree(cuda_device, tree_memory):
    """The nested triangle set's tree of MAX_DEPTH group levels, on rays
    that walk its deepest paths: the kernel's stack holds every level."""
    b = SceneBuilder()
    chip_smoke.nested_triangles(b)
    scene = b.finalize(device="cpu")
    assert bvh8.tree_depth(scene.bvh8[0].entries.numpy()) == bvh8.MAX_DEPTH
    rng = np.random.default_rng(9)
    o, d, tm = (torch.as_tensor(x) for x in chip_smoke.nested_rays(rng, 4096))
    ref, got, visits = _both(scene.bvh8[0], TRIANGLE, o, d, tm, None, cuda_device, plain_device=cuda_device)
    assert bvh8.TREE_MEMORY == tree_memory
    rep = chip_smoke.check_parity(TRIANGLE, ref, got)
    assert rep["hits"] > 1000
    _assert_visits(scene.bvh8[0], TRIANGLE, o, d, tm, None, visits, np.arange(0, 4096, 64))


@pytest.mark.cuda
def test_closest_hit_on_the_card_goes_through_the_kernel(cuda_device):
    b = SceneBuilder()
    chip_smoke.stand_in_mesh_scene(b, 24, 12)
    rays = [torch.as_tensor(x) for x in chip_smoke.random_rays(np.random.default_rng(5), 2048, 1.0, 554.0)]
    cpu_scene = b.finalize(device="cpu")
    gpu_scene = b.finalize(device=cuda_device)
    h_cpu, _ = closest_hit(cpu_scene, *rays, T_MIN, float("inf"))
    before = bvh8.LAUNCHES
    h_gpu, _ = closest_hit(gpu_scene, *(x.to(cuda_device) for x in rays), T_MIN, float("inf"))
    assert bvh8.LAUNCHES == before + 1
    np.testing.assert_array_equal(h_gpu.hit.cpu().numpy(), h_cpu.hit.numpy())
    hit = h_cpu.hit.numpy()
    np.testing.assert_allclose(h_gpu.t.cpu().numpy()[hit], h_cpu.t.numpy()[hit], rtol=2e-5, atol=2e-5)
    assert (h_gpu.prim.cpu().numpy()[hit] == h_cpu.prim.numpy()[hit]).mean() >= 0.99


def _mixed_scene(device):
    """The small stand-in mesh (a TRIANGLE tree with a packet tree) plus
    600 rotated and translated boxes (a transformed BOX tree, which only
    the cluster walk takes)."""
    b = SceneBuilder()
    chip_smoke.stand_in_mesh_scene(b, 24, 12)
    rng = np.random.default_rng(9)
    white = b.lambertian((0.73, 0.73, 0.73))
    ids = [b.box(c, c + rng.uniform(3, 12, 3), white)[0] for c in rng.uniform(0, 200, (600, 3))]
    b.rotate_y(ids, 20.0)
    b.translate(ids, (250, 40, 120))
    return b.finalize(cluster_size=128, device=device)


@pytest.mark.cuda
def test_mixed_scene_launches_k1_and_walks_the_transformed_tree(cuda_device, monkeypatch):
    """closest_hit on a scene with a packet tree and a transformed tree:
    one K1 launch for the mesh, one cluster walk for the boxes, and the
    same hits as the CPU (plain versions)."""
    walks = []
    walk = intersect.traverse_clusters
    monkeypatch.setattr(intersect, "traverse_clusters", lambda *a, **k: walks.append(a[1]) or walk(*a, **k))
    cpu_scene, gpu_scene = _mixed_scene("cpu"), _mixed_scene(cuda_device)
    kinds = [t[0] for t in gpu_scene.stats.trees]
    assert sorted(kinds) == [TRIANGLE, BOX] and [t[4] for t in gpu_scene.stats.trees] == [k == BOX for k in kinds]
    rays = [torch.as_tensor(x) for x in chip_smoke.random_rays(np.random.default_rng(5), 4096, 1.0, 554.0)]
    h_cpu, _ = closest_hit(cpu_scene, *rays, T_MIN, float("inf"))
    before = bvh8.LAUNCHES
    walks.clear()
    h_gpu, _ = closest_hit(gpu_scene, *(x.to(cuda_device) for x in rays), T_MIN, float("inf"))
    assert bvh8.LAUNCHES == before + 1
    assert walks == [kinds.index(BOX)]
    hit = h_cpu.hit.numpy()
    np.testing.assert_array_equal(h_gpu.hit.cpu().numpy(), hit)
    np.testing.assert_allclose(h_gpu.t.cpu().numpy()[hit], h_cpu.t.numpy()[hit], rtol=2e-5, atol=2e-5)
    same = h_gpu.prim.cpu().numpy()[hit] == h_cpu.prim.numpy()[hit]
    assert same.mean() >= 0.99
    won = cpu_scene.kind.numpy()[h_cpu.prim.numpy()[hit]]
    assert (won == BOX).sum() > 50 and (won == TRIANGLE).sum() > 50
    np.testing.assert_allclose(h_gpu.normal.cpu().numpy()[:, hit][:, same], h_cpu.normal.numpy()[:, hit][:, same],
                               rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_cannot_take(cuda_device):
    scene = chip_smoke.small_tree_scene(SceneBuilder(), TRIANGLE, np.random.default_rng(0), device="cpu")
    tree = _on(scene.bvh8[0], cuda_device)
    o, d, tm = (torch.as_tensor(x, device=cuda_device) for x in chip_smoke.random_rays(np.random.default_rng(1), 64, -30, 30))
    with pytest.raises(ValueError, match="float32"):
        traverse_bvh8(tree, TRIANGLE, o.double(), d, tm, T_MIN)
    with pytest.raises(ValueError, match="contiguous"):
        traverse_bvh8(tree, TRIANGLE, o.T.contiguous().T, d, tm, T_MIN)
    with pytest.raises(ValueError):
        traverse_bvh8(scene.bvh8[0], TRIANGLE, o, d, tm, T_MIN)  # tree left on the CPU


@pytest.mark.cuda
def test_material_gradient_k1_matches_cluster_walk(cuda_device):
    """The gradient convention on the card: K1 and the cluster walk search
    detached and the winner's t is recomputed, so the 64-triangle scene's
    texture-colour gradients agree (tests/test_bvh8.py:162-208), and K1
    really ran."""
    scene, cam_kw = chip_smoke.tri64_scene(SceneBuilder(), device=cuda_device)
    cam = make_camera(**cam_kw, device=cuda_device)
    before = bvh8.LAUNCHES
    g_k1 = chip_smoke.material_grad(scene, cam)
    assert bvh8.LAUNCHES > before
    g_walk = chip_smoke.material_grad(dataclasses.replace(scene, bvh8=(None,)), cam)
    assert np.isfinite(g_k1).all() and np.abs(g_k1).max() > 0
    np.testing.assert_allclose(g_k1, g_walk, rtol=chip_smoke.MAT_RTOL, atol=chip_smoke.MAT_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("builder", ["sphere", "triangle"])
def test_geometry_gradient_k1_matches_cluster_walk(cuda_device, builder):
    """Geometry gradients through K1's winner rows, re-fetched from
    scene.params, against the cluster walk's (tests/test_grad_geom.py:128-162)."""
    build = chip_smoke.geom_sphere_scene if builder == "sphere" else chip_smoke.geom_triangle_scene
    scene, cam_kw, _ = build(SceneBuilder(), device=cuda_device)
    cam = make_camera(**cam_kw, device=cuda_device)
    before = bvh8.LAUNCHES
    g_k1 = chip_smoke.geometry_grad(scene, cam)
    assert bvh8.LAUNCHES > before
    chip_smoke.check_geometry_parity(g_k1, chip_smoke.geometry_grad(dataclasses.replace(scene, bvh8=(None,)), cam))


def test_unsupported_kind_is_refused():
    scene = chip_smoke.small_tree_scene(SceneBuilder(), TRIANGLE, np.random.default_rng(0), device="cpu")
    o, d, tm = (torch.as_tensor(x) for x in chip_smoke.random_rays(np.random.default_rng(1), 8, -30, 30))
    with pytest.raises(ValueError, match="unsupported kind"):
        traverse_bvh8(scene.bvh8[0], MEDIUM, o, d, tm, T_MIN)
