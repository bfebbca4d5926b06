"""The shading tables' differentiable gather (``ops/shade.py``): its
forward against plain indexing, its backward against autograd of plain
indexing, where ``shade_for_mats`` takes it, the kernel's launch plan, and
on the card the kernel against its plain version.

No JAX here, so the file also runs on a card machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_table_grad.py

Tests marked ``cuda`` skip without a CUDA device: ``csrc/table_grad.cu`` is
CUDA C++ and has no CPU mode.
"""

import pytest

torch = pytest.importorskip("torch")

from raytracer2022_tpu_torch.ops import shade  # noqa: E402
from raytracer2022_tpu_torch.ops.shade import gather_table, grad_plan, shade_for_mats, table_grad  # noqa: E402
from raytracer2022_tpu_torch.scene.builder import SceneBuilder  # noqa: E402

torch.set_num_threads(1)


def _ids(case: str, n: int, t: int, gen) -> torch.Tensor:
    """Ids of one kind: ``repeats`` puts most lanes on entry 1 (a white
    wall), ``partial`` reaches only the lower half of the table,
    ``negative`` counts some from the end."""
    if case == "repeats":
        ids = torch.randint(0, t, (n,), generator=gen)
        return torch.where(torch.rand(n, generator=gen) < 0.9, torch.ones_like(ids), ids)
    if case == "partial":
        return torch.randint(0, max(1, t // 2), (n,), generator=gen)
    if case == "negative":
        return torch.randint(-t, t, (n,), generator=gen)
    return torch.randint(0, t, (n,), generator=gen)


def _table(c: int, t: int, dtype, gen) -> torch.Tensor:
    return torch.randn((c, t) if c > 1 else (t,), generator=gen, dtype=torch.float64).to(dtype)


@pytest.mark.parametrize("grad", [False, True], ids=["no_grad", "grad"])
@pytest.mark.parametrize("c", [1, 3])
def test_forward_is_plain_indexing(c, grad):
    gen = torch.Generator().manual_seed(c)
    table = _table(c, 7, torch.float32, gen).requires_grad_(grad)
    idx = _ids("repeats", 1000, 7, gen)
    plain = table[idx] if c == 1 else table[:, idx]
    out = gather_table(table, idx)
    assert out.dtype == plain.dtype and out.shape == plain.shape
    assert torch.equal(out.detach(), plain.detach())


@pytest.mark.parametrize("case", ["repeats", "partial", "negative", "empty", "noncontiguous"])
@pytest.mark.parametrize("c", [1, 3])
def test_backward_is_autograd_of_indexing(c, case):
    gen = torch.Generator().manual_seed(10 * c + len(case))
    t = 5
    n = 0 if case == "empty" else 200
    table = _table(c, t, torch.float64, gen).requires_grad_()
    idx = _ids(case, n, t, gen)
    assert torch.autograd.gradcheck(lambda x: gather_table(x, idx), (table,))
    shape = (c, n) if c > 1 else (n,)
    if case == "noncontiguous":  # every other column of a wider gradient
        g = torch.randn(shape[:-1] + (2 * n,), generator=gen, dtype=torch.float64)[..., ::2]
        assert not g.is_contiguous()
    else:
        g = torch.randn(shape, generator=gen, dtype=torch.float64)
    (ours,) = torch.autograd.grad(gather_table(table, idx), table, g)
    (plain,) = torch.autograd.grad(table[..., idx], table, g)
    torch.testing.assert_close(ours, plain, rtol=1e-12, atol=1e-12)
    if case == "partial":
        assert not ours[..., t // 2 + 1:].any()


def test_backward_saves_ids_and_shape_only():
    table = torch.ones(3, 4, requires_grad=True)
    out = gather_table(table, torch.tensor([0, 3, 3]))
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 1 and saved[0].dtype == torch.int64 and out.grad_fn.shape == (3, 4)


def test_table_grad_counts_no_cpu_launch_and_refuses_other_devices():
    before = shade.TABLE_GRAD_LAUNCHES
    g = table_grad(torch.ones(3, 6), torch.tensor([0, 1, 1, 2, 2, 2]), (3, 3))
    assert g.tolist() == [[1.0, 2.0, 3.0]] * 3
    assert shade.TABLE_GRAD_LAUNCHES == before
    with pytest.raises(ValueError, match="no kernel"):
        table_grad(torch.ones(3, device="meta"), torch.zeros(3, dtype=torch.long, device="meta"), (2,))


def _shade_scene():
    """A checker, a noise and a solid texture, so every float table is read."""
    b = SceneBuilder()
    b.sphere((0, 0, 0), 1, b.lambertian(b.checker((0.2, 0.3, 0.1), (0.9, 0.9, 0.9))))
    b.sphere((2, 0, 0), 1, b.lambertian(b.noise(4.0)))
    b.sphere((-2, 0, 0), 1, b.metal((0.8, 0.6, 0.2), 0.3))
    return b.finalize(device="cpu")


FLOAT_FIELDS = ("mat_param", "color", "scale", "odd", "even")


@pytest.mark.parametrize("mode", ["grad", "no_grad", "no_leaf"])
def test_shade_for_mats_takes_the_gather_only_under_grad(mode, monkeypatch):
    import dataclasses

    scene = _shade_scene()
    assert {"checker", "noise"} <= set(scene.stats.features)
    mt, tt = scene.materials, scene.textures
    leaves = {"param": mt.param.clone(), "color": tt.color.clone(), "scale": tt.scale.clone()}
    if mode != "no_leaf":
        for x in leaves.values():
            x.requires_grad_()
    scene = dataclasses.replace(
        scene, materials=dataclasses.replace(mt, param=leaves["param"]),
        textures=dataclasses.replace(tt, color=leaves["color"], scale=leaves["scale"]))
    calls = []
    monkeypatch.setattr(shade, "gather_table", lambda table, idx: calls.append(table) or gather_table(table, idx))
    mat = torch.tensor([0, 1, 2, 2, 1, 0, 0], dtype=torch.long)
    with torch.set_grad_enabled(mode != "no_grad"):
        out = shade_for_mats(scene, mat)
    with torch.no_grad():
        plain = shade_for_mats(scene, mat)
    for name in FLOAT_FIELDS:  # the same values whichever way they were fetched
        assert torch.equal(getattr(out, name).detach(), getattr(plain, name)), name
    if mode == "grad":
        assert len(calls) == 5
        for name in FLOAT_FIELDS:
            assert type(getattr(out, name).grad_fn).__name__ == "_GatherTableBackward", name
        loss = sum(getattr(out, name).sum() for name in FLOAT_FIELDS)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        counts = torch.bincount(mat, minlength=len(mt.param)).double()
        torch.testing.assert_close(grads[0].double(), counts)
    else:
        assert calls == []
        assert all(getattr(out, name).grad_fn is None for name in FLOAT_FIELDS)


H100 = (132, 232448 // 2)  # SMs, and half the shared memory a block may opt into


@pytest.mark.parametrize("n,c,t", [(524288, 3, 4), (524288, 1, 4), (524288, 3, 480), (524288, 1, 480),
                                   (131072, 3, 4), (32768, 3, 4), (1, 3, 4), (33, 1, 2), (4096, 3, 20000),
                                   (524288, 3, 100000)])
def test_grad_plan_covers_every_lane_and_entry(n, c, t):
    sms, smem = H100
    blocks, slices, warps, slice_, lanes = grad_plan(n, c, t, sms, smem)
    assert 1 <= blocks <= 2 * sms and lanes % 32 == 0
    assert (blocks - 1) * lanes < n <= blocks * lanes  # every block has lanes, every lane a block
    assert 1 <= warps <= shade.MAX_WARPS and warps * c * slice_ * 4 <= smem
    assert slices * slice_ >= t > (slices - 1) * slice_
    if c * t * 4 * shade.MAX_WARPS <= smem:
        assert (slices, warps, slice_) == (1, shade.MAX_WARPS, t)
    if n >= 2 * sms * shade.MAX_WARPS * shade.MIN_CHUNKS * 32 and slices == 1:
        assert blocks >= 1.9 * sms  # about two an SM, less what whole chunks a block round off


def test_grad_plan_refuses_rows_beyond_shared_memory():
    with pytest.raises(ValueError, match="shared memory"):
        grad_plan(64, 40000, 4, 132, 116224)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: csrc/table_grad.cu is CUDA C++ and has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["repeats", "partial", "negative", "noncontiguous"])
@pytest.mark.parametrize("n,c,t", [(524288, 3, 4), (524288, 1, 480), (1000, 3, 7), (4096, 3, 20000)])
def test_kernel_against_plain_version(cuda_device, n, c, t, case):
    gen = torch.Generator().manual_seed(n + c + t)
    idx = _ids(case, n, t, gen)
    shape = (c, t) if c > 1 else (t,)
    gshape = (c, n) if c > 1 else (n,)
    g = torch.rand(gshape[:-1] + (2 * n,), generator=gen)[..., ::2] if case == "noncontiguous" \
        else torch.rand(gshape, generator=gen)
    want = table_grad(g.double(), idx, shape)  # the plain version on the CPU, in float64
    before = shade.TABLE_GRAD_LAUNCHES
    gd, idd = g.to(cuda_device), idx.to(cuda_device)
    got = table_grad(gd, idd, shape)
    again = table_grad(gd, idd, shape)
    torch.cuda.synchronize()
    assert shade.TABLE_GRAD_LAUNCHES == before + 2
    assert torch.equal(got, again), "the kernel is not deterministic"
    # positive gradients: a relative bound of the f32 sums' rounding
    torch.testing.assert_close(got.cpu().double(), want, rtol=1e-5, atol=0.0)


@pytest.mark.cuda
def test_kernel_backs_the_gather(cuda_device):
    table = torch.rand(3, 4, device=cuda_device, requires_grad=True)
    idx = torch.randint(0, 4, (100000,), device=cuda_device)
    g = torch.rand(3, 100000, device=cuda_device)
    before = shade.TABLE_GRAD_LAUNCHES
    (ours,) = torch.autograd.grad(gather_table(table, idx), table, g)
    assert shade.TABLE_GRAD_LAUNCHES == before + 1
    want = table_grad(g.cpu().double(), idx.cpu(), (3, 4))
    torch.testing.assert_close(ours.cpu().double(), want, rtol=1e-5, atol=0.0)


def test_fit_backward_differentiates_every_gather_once():
    """chip_smoke's count over a regeneration fit step, on the CPU at a
    cut: each gather of the loss is recomputed once, and those that reach
    the loss are differentiated once (the last iterations' scatter
    directions, and so their ``materials.param`` gathers, reach none)."""
    import chip_smoke
    from raytracer2022_tpu_torch.render.camera import make_camera
    from raytracer2022_tpu_torch.scene.library import cornell_box

    bundle = cornell_box(device="cpu")
    cam = make_camera(**bundle.camera_kwargs, device="cpu")
    counts = chip_smoke.count_table_grads(chip_smoke.fit_loss_run(bundle, cam, (8, 8, 16), n_iters=12))
    assert counts["gathers"] == counts["recomputed"] == 24  # 12 iterations, materials.param and textures.color
    assert counts["differentiated"] == 22 and counts["launches"] == 0
    assert shade.gather_table is gather_table and shade.table_grad is table_grad
