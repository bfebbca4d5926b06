"""The port's sharded renders and fit step in one process, without a
process group: every rank's share (``render_shard``,
``render_regen_shard``) computed here and summed, against the JAX
package's sharded renders on its 8 virtual CPU devices
(tests/test_parallel.py's scene and bounds)."""

import dataclasses
import types

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from raytracer2022_tpu import RenderConfig as JaxRenderConfig  # noqa: E402
from raytracer2022_tpu import make_camera as jax_make_camera  # noqa: E402
from raytracer2022_tpu.parallel import mesh as jax_mesh  # noqa: E402
from raytracer2022_tpu.render.renderer import render_sum as jax_render_sum  # noqa: E402
from raytracer2022_tpu.scene.builder import SceneBuilder as JaxBuilder  # noqa: E402
from raytracer2022_tpu_torch.parallel import distributed as D  # noqa: E402
from raytracer2022_tpu_torch.parallel.mesh import (  # noqa: E402
    fit_step_fn,
    make_device_mesh,
    regen_split,
    render_regen_shard,
    render_shard,
)
from raytracer2022_tpu_torch.render.camera import make_camera  # noqa: E402
from raytracer2022_tpu_torch.render.renderer import RenderConfig  # noqa: E402
from raytracer2022_tpu_torch.scene.builder import SceneBuilder  # noqa: E402
from raytracer2022_tpu_torch.utils.imageio import read_png  # noqa: E402

torch.set_num_threads(1)

WORLD = 8  # the JAX package's virtual CPU devices (tests/conftest.py)


def _jax_scene():
    b = JaxBuilder()
    cam_kw = chip_smoke.two_rect_scene(b)
    return b.finalize(), jax_make_camera(**cam_kw)


def _scene():
    b = SceneBuilder()
    cam_kw = chip_smoke.two_rect_scene(b)
    return b.finalize(device="cpu"), make_camera(**cam_kw, device="cpu")


def _regen_sum(scene, cam, cfg, world=WORLD, logs=None):
    """Sum over ``world`` ranks of render_regen_shard -> (sum, n, strips per
    rank); ``logs`` receives each rank's launch log."""
    total, ns, strips = 0, set(), set()
    for r in range(world):
        log = []
        part, n = render_regen_shard(scene, cam, cfg, r, world, launch_log=log)
        total = total + part
        ns.add(n)
        strips.add(len(log))
        if logs is not None:
            logs.append(log)
    assert len(ns) == 1 and len(strips) == 1
    return total.numpy(), ns.pop(), strips.pop()


def test_regen_sample_count_matches_jax():
    """spp 108 over 8 ranks (not a divisor): the port's sharded
    regeneration render counts the samples JAX's counts on 8 devices."""
    assert len(jax.devices()) == WORLD
    kw = dict(width=4, height=4, spp=108, max_depth=2, background=(0, 0, 0))
    js, jc = _jax_scene()
    _, n_jax = jax_mesh.render_sharded_regen_sum(js, jc, JaxRenderConfig(**kw), jax_mesh.make_device_mesh())
    scene, cam = _scene()
    total, n, strips = _regen_sum(scene, cam, RenderConfig(**kw))
    assert n == n_jax and n >= 108 and n % WORLD == 0
    spp_par, spp_seq, _ = regen_split(RenderConfig(**kw), WORLD)
    assert n == WORLD * spp_par * spp_seq and strips == 1
    assert total.shape == (3, 4, 4) and np.isfinite(total).all() and total.mean() > 0


def test_sharded_render_matches_jax_statistically():
    """Sum over 8 ranks of render_shard against JAX's render_sharded_sum,
    within tests/test_parallel.py:41-46's variance-derived bound (two
    independent single-device JAX renders give the noise scale)."""
    kw = dict(width=12, height=12, spp=64, max_depth=4, background=(0, 0, 0))
    js, jc = _jax_scene()
    jcfg = JaxRenderConfig(**kw)
    jax_sharded = np.asarray(jax_mesh.render_sharded_sum(js, jc, jcfg, jax_mesh.make_device_mesh())) / 64
    single = np.asarray(jax_render_sum(js, jc, jcfg)) / 64
    var = np.asarray(jax_render_sum(js, jc, dataclasses.replace(jcfg, seed=1234))) / 64
    mad_independent = np.abs(single - var).mean() + 1e-3

    scene, cam = _scene()
    cfg = RenderConfig(**kw)
    port = sum(render_shard(scene, cam, cfg, r, WORLD) for r in range(WORLD)).numpy() / 64
    assert port.shape == jax_sharded.shape == (3, 12, 12) and np.isfinite(port).all()
    assert np.abs(port - jax_sharded).mean() < 3 * mad_independent


def test_regen_row_strips_stitch_the_one_strip_image():
    """A lane cap of 12 * 4 gives 3 row strips per rank; the stitched
    image matches the one-strip render within tests/test_parallel.py:
    97-119's bounds."""
    kw = dict(width=12, height=12, spp=64, max_depth=4, background=(0, 0, 0))
    scene, cam = _scene()
    one, n1, s1 = _regen_sum(scene, cam, RenderConfig(**kw))
    few, n2, s2 = _regen_sum(scene, cam, RenderConfig(**kw, max_rays_per_batch=12 * 4))
    assert (s1, s2) == (1, 3) and n1 == n2 == 64
    a, b = one / n1, few / n2
    assert abs(a.mean() - b.mean()) / max(a.mean(), 1e-6) < 0.1
    ra, rb = a.mean(axis=(0, 2)), b.mean(axis=(0, 2))
    assert np.all(np.abs(ra - rb) < 0.5 * np.maximum(ra, 0.2))


@pytest.mark.parametrize("shard", ["render_shard", "render_regen_shard"])
def test_ranks_draw_their_own_samples(shard):
    """Rank r draws from derive_seed(cfg.seed, r): two ranks' shares
    differ, and rank 0 of 1 is not the unsharded render of the seed (as
    fold_in(key, 0) != key in JAX)."""
    from raytracer2022_tpu_torch.render.integrator import derive_seed
    from raytracer2022_tpu_torch.render.renderer import render_batch

    scene, cam = _scene()
    cfg = RenderConfig(width=6, height=6, spp=8, max_depth=3, background=(0, 0, 0), seed=3)
    if shard == "render_shard":
        parts = [render_shard(scene, cam, cfg, r, 2) for r in range(2)]
        assert torch.equal(render_shard(scene, cam, cfg, 0, 1), render_batch(scene, cam, derive_seed(3, 0), 6, 6, 8,
                                                                             cfg.trace_cfg()))
        assert not torch.equal(render_shard(scene, cam, cfg, 0, 1), render_batch(scene, cam, 3, 6, 6, 8,
                                                                                 cfg.trace_cfg()))
    else:
        parts = [render_regen_shard(scene, cam, cfg, r, 2)[0] for r in range(2)]
    assert not torch.equal(parts[0], parts[1])
    assert torch.equal(parts[1], (render_shard if shard == "render_shard" else
                                  lambda *a: render_regen_shard(*a)[0])(scene, cam, cfg, 1, 2))


def _fake_mesh(world):
    """What fit_step_fn reads of a mesh before its first collective."""
    return types.SimpleNamespace(size=lambda: world, get_local_rank=lambda: 0)


@pytest.mark.parametrize("entry", ["render_shard", "fit_step_fn"])
def test_spp_must_divide_over_ranks(entry):
    """The scan render and the fit step split spp evenly, as JAX asserts;
    the regeneration render rounds up instead."""
    scene, cam = _scene()
    cfg = RenderConfig(width=4, height=4, spp=7, max_depth=2, background=(0, 0, 0))
    with pytest.raises(ValueError, match="divide"):
        if entry == "render_shard":
            render_shard(scene, cam, cfg, 0, 2)
        else:
            fit_step_fn(cfg, mesh=_fake_mesh(2))
    _, n, _ = _regen_sum(scene, cam, cfg, world=2)
    assert n == 8


def test_regen_shard_strips_carry_the_launch_record():
    """World 2, three strips a rank: every strip's entry carries its rank's
    host record (render_regen_shard opens it as render_sum_n does), and
    the record changes no rendered number."""
    kw = dict(width=12, height=12, spp=16, max_depth=4, background=(0, 0, 0), max_rays_per_batch=12 * 4)
    scene, cam = _scene()
    logs = []
    total, n, strips = _regen_sum(scene, cam, RenderConfig(**kw), world=2, logs=logs)
    assert len(logs) == 2 and strips == 3
    for log in logs:
        for e in log:
            iters = e["pool"] + e["drain_n4"] + e["drain_n16"]
            assert e["syncs"] >= iters > 0 and 0 < e["live_lanes"] <= e["wavefront_lanes"]
            assert sum(e["span_self_s"].values()) + e["sync_wait_s"] <= e["seconds"]
            assert e["span_calls"]["vertex.closest_hit"] == iters and e["span_calls"]["regen.accumulate"] == 1
    bare = sum(render_regen_shard(scene, cam, RenderConfig(**kw), r, 2)[0] for r in range(2)).numpy()
    np.testing.assert_array_equal(total, bare)


def test_sharded_all_reduce_runs_in_its_span():
    """A one-rank gloo group: render_sharded_regen_sum's all_reduce is a
    ``shard.all_reduce`` event under the profiler, outside every strip's
    record and inside the collective's own, the log's last, and the
    strips' entries carry their records."""
    import socket

    from torch.profiler import ProfilerActivity, profile

    from raytracer2022_tpu_torch.parallel.mesh import render_sharded_regen_sum

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    assert D.init_distributed(f"localhost:{port}", 1, 0, backend="gloo", device="cpu")
    try:
        scene, cam = _scene()
        log: list = []
        cfg = RenderConfig(width=8, height=8, spp=8, max_depth=3, background=(0, 0, 0))
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            total, n = render_sharded_regen_sum(scene, cam, cfg, make_device_mesh("cpu"), launch_log=log)
        names = {e.key for e in prof.key_averages()}
        assert "shard.all_reduce" in names and n == 8 and total.shape == (3, 8, 8)
        strips, last = log[:-1], log[-1]
        assert strips and all("shard.all_reduce" not in e["span_calls"] and e["syncs"] > 0 for e in strips)
        assert last["collective"] == "all_reduce" and last["span_calls"] == {"shard.all_reduce": 1}
    finally:
        torch.distributed.destroy_process_group()
    assert not torch.distributed.is_initialized()


def test_no_process_group():
    """Without a coordinator nothing is joined; a mesh needs a group."""
    assert D.init_distributed(None) is False
    assert D.is_primary()
    with pytest.raises(RuntimeError, match="init_distributed"):
        make_device_mesh("cpu")


def test_cli_sharded_on_one_device_renders_as_before(tmp_path):
    """--sharded without a coordinator and without several cards renders
    on the one device, the same image as without it (JAX's n_dev > 1
    guard)."""
    from raytracer2022_tpu_torch import cli

    paths = [str(tmp_path / f"{i}.png") for i in range(2)]
    base = ["--scene", "cornell_box", "--device", "cpu", "--width", "12", "--height", "12", "--spp", "4",
            "--max-depth", "3", "--quiet"]
    assert cli.main([*base, "--out", paths[0]]) == 0
    assert cli.main([*base, "--sharded", "--out", paths[1]]) == 0
    a, b = (read_png(p) for p in paths)
    assert np.array_equal(a, b) and a.shape == (12, 12, 3)
    assert not torch.distributed.is_initialized()


def test_rank_devices_and_backends():
    assert D.rank_device("cpu", 3) == torch.device("cpu")
    assert D.default_backend("cpu") == "gloo" and D.default_backend("cuda:0") == "nccl"
    if torch.cuda.is_available():
        n = torch.cuda.device_count()
        assert D.rank_device("cuda", 3) == torch.device("cuda", 3 % n)
        assert D.rank_device("cuda:0", 3) == torch.device("cuda", 0)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            D.rank_device("cuda", 0)
