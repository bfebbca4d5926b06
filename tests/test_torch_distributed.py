"""The port's multi-process path on the CPU: two ranks joined by gloo
through ``parallel/worker.py::launch_local``.  Their results equal the sum
(or mean) of the same ranks' shares computed in this process, both ranks
end with the same sums and bit-identical parameters, the sharded render
logs its collective only when given a launch log, and a rank that fails
brings the launch down within its time limit (the counterpart of
tests/test_distributed.py)."""

import json
import os
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from raytracer2022_tpu_torch.parallel.mesh import (  # noqa: E402
    CAMERA_LEAVES,
    fit_step_fn,
    render_regen_shard,
    render_shard,
)
from raytracer2022_tpu_torch.parallel.worker import launch_local, rank_path  # noqa: E402
from raytracer2022_tpu_torch.render.camera import make_camera  # noqa: E402
from raytracer2022_tpu_torch.render.film import tonemap_u8  # noqa: E402
from raytracer2022_tpu_torch.render.integrator import derive_seed  # noqa: E402
from raytracer2022_tpu_torch.render.renderer import RenderConfig  # noqa: E402
from raytracer2022_tpu_torch.scene.builder import SceneBuilder  # noqa: E402
from raytracer2022_tpu_torch.scene.library import cornell_box  # noqa: E402
from raytracer2022_tpu_torch.utils.imageio import read_png  # noqa: E402

torch.set_num_threads(1)

WORLD = 2
TIMEOUT_S = 120  # each launch of two ranks; they take a few seconds here
WORKER = [sys.executable, "-m", "raytracer2022_tpu_torch.parallel.worker", "--device", "cpu"]
SCENE = "chip_smoke:two_rect_scene"


def _scene():
    b = SceneBuilder()
    cam_kw = chip_smoke.two_rect_scene(b)
    return b.finalize(device="cpu"), make_camera(**cam_kw, device="cpu")


def _run(tmp_path, task, *extra):
    """Launch ``task`` on two CPU ranks -> each rank's results."""
    out = str(tmp_path / f"{task}.npz")
    launch_local(WORLD, [*WORKER, "--task", task, "--out", out, *extra], TIMEOUT_S)
    res = []
    for k in range(WORLD):
        with np.load(rank_path(out, k)) as f:
            res.append({key: f[key] for key in f.files})
    assert [int(r["rank"]) for r in res] == [0, 1] and all(str(r["backend"]) == "gloo" for r in res)
    return res


@pytest.mark.parametrize("task, max_rays", [("scan", 1 << 18), ("regen", 1 << 18), ("regen", 12 * 4)])
def test_sharded_render_equals_sum_of_shards(tmp_path, task, max_rays):
    """World 2 over gloo equals the sum of each rank's shard computed here
    (rtol 1e-6), on both ranks; ``max_rays`` 12 * 4 renders 3 row strips."""
    res = _run(tmp_path, task, "--scene", SCENE, "--width", "12", "--height", "12", "--spp", "8",
               "--depth", "4", "--max-rays", str(max_rays))
    scene, cam = _scene()
    cfg = RenderConfig(width=12, height=12, spp=8, max_depth=4, background=(0.0, 0.0, 0.0),
                       max_rays_per_batch=max_rays)
    if task == "scan":
        expect, n = sum(render_shard(scene, cam, cfg, r, WORLD) for r in range(WORLD)), 8
    else:
        parts = [render_regen_shard(scene, cam, cfg, r, WORLD) for r in range(WORLD)]
        expect, n = parts[0][0] + parts[1][0], parts[0][1]
        assert all(len(r["iters"]) == (3 if max_rays == 12 * 4 else 1) for r in res)
    assert np.array_equal(res[0]["sum"], res[1]["sum"])
    np.testing.assert_allclose(res[0]["sum"], expect.numpy(), rtol=1e-6, atol=0)
    assert all(int(r["n"]) == n for r in res) and expect.sum() > 0


@pytest.mark.parametrize("task", ["fit", "fit_regen"])
def test_sharded_fit_step_averages_gradients(tmp_path, task):
    """Two steps toward a black target at 8x8: after each, both ranks hold
    bit-identical parameters and losses; step 1 equals x - lr * (g_0 +
    g_1) / 2 and its loss the mean of the ranks' losses, recomputed here
    (rtol 1e-5); and the light dims (tests/test_parallel.py:83-94)."""
    lr = 0.1
    res = _run(tmp_path, task, "--scene", SCENE, "--width", "8", "--height", "8", "--spp", "8", "--depth", "4",
               "--steps", "2", "--lr", str(lr))
    assert np.array_equal(res[0]["params"], res[1]["params"]) and res[0]["params"].shape[0] == 2
    assert np.array_equal(res[0]["loss"], res[1]["loss"]) and np.isfinite(res[0]["loss"]).all()

    scene, cam = _scene()
    regen_iters = int(res[0]["regen_iters"]) if task == "fit_regen" else None
    if regen_iters is not None:
        assert int(res[1]["regen_iters"]) == regen_iters
    # one rank's step on one device: x - lr * g_r and loss_r
    local = fit_step_fn(RenderConfig(width=8, height=8, spp=4, max_depth=4, background=(0.0, 0.0, 0.0)),
                        lr=lr, regen_iters=regen_iters)
    target = torch.zeros((3, 8, 8))
    flats, losses = [], []
    for r in range(WORLD):
        s, c, loss = local(scene, cam, target, derive_seed(0, r))
        leaves = [s.materials.param, s.textures.color] + [getattr(c, f) for f in CAMERA_LEAVES]
        flats.append(np.concatenate([x.numpy().reshape(-1) for x in leaves]))
        losses.append(float(loss))
    np.testing.assert_allclose(res[0]["params"][0], np.mean(flats, axis=0), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(res[0]["loss"][0], np.mean(losses), rtol=1e-5)

    lo = scene.materials.param.numel()
    color = res[0]["params"][-1][lo : lo + scene.textures.color.numel()]
    assert color.sum() < float(scene.textures.color.sum())


RECORDS_RANK = """
import argparse, json
import numpy as np, torch
import chip_smoke
from raytracer2022_tpu_torch.parallel.distributed import init_distributed
from raytracer2022_tpu_torch.parallel.mesh import make_device_mesh, render_regen_shard, render_sharded_regen_sum
from raytracer2022_tpu_torch.parallel.worker import rank_path
from raytracer2022_tpu_torch.render.camera import make_camera
from raytracer2022_tpu_torch.render.renderer import RenderConfig
from raytracer2022_tpu_torch.scene.builder import SceneBuilder
from raytracer2022_tpu_torch.utils import profiling
import torch.distributed as dist

ap = argparse.ArgumentParser()
ap.add_argument('out'); ap.add_argument('--coordinator'); ap.add_argument('--num-processes', type=int)
ap.add_argument('--process-id', type=int)
a = ap.parse_args()
torch.set_num_threads(1)
init_distributed(a.coordinator, a.num_processes, a.process_id, device='cpu')
mesh = make_device_mesh('cpu')
b = SceneBuilder()
cam = make_camera(**chip_smoke.two_rect_scene(b), device='cpu')
scene = b.finalize(device='cpu')
cfg = RenderConfig(width=12, height=12, spp=8, max_depth=4, background=(0.0, 0.0, 0.0), max_rays_per_batch=12 * 4)
opened = []

class Counted(profiling.LaunchRecord):
    def __init__(self):
        super().__init__()
        opened.append(1)

profiling.LaunchRecord = Counted
log = []
logged, n_logged = render_sharded_regen_sum(scene, cam, cfg, mesh, launch_log=log)
records_logged = len(opened)
bare, n_bare = render_sharded_regen_sum(scene, cam, cfg, mesh)
records_bare = len(opened) - records_logged
# the shard's sum and one all_reduce with no record around it
plain, n_plain = render_regen_shard(scene, cam, cfg, a.process_id, a.num_processes)
dist.all_reduce(plain)
np.savez(rank_path(a.out, a.process_id), logged=logged.numpy(), bare=bare.numpy(), plain=plain.numpy(),
         n=[n_logged, n_bare, n_plain])
with open(rank_path(a.out, a.process_id) + '.json', 'w') as f:
    json.dump({'log': log, 'records_logged': records_logged, 'records_bare': records_bare}, f)
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def sharded_records(tmp_path_factory):
    """One launch of two ranks, each rendering 12x12 x 8 in three strips
    through ``render_sharded_regen_sum`` with a launch log, then without,
    then as the shard's sum and a bare all_reduce -> each rank's sums and
    records."""
    out = str(tmp_path_factory.mktemp("records") / "records.npz")
    launch_local(WORLD, [sys.executable, "-c", RECORDS_RANK, out], TIMEOUT_S)
    res = []
    for k in range(WORLD):
        with np.load(rank_path(out, k)) as f:
            rec = {key: f[key] for key in f.files}
        with open(rank_path(out, k) + ".json") as f:
            rec.update(json.load(f))
        res.append(rec)
    return res


def test_sharded_regen_logs_its_collective_after_the_strips(sharded_records):
    """With a launch log each rank logs its three strips, each with its
    ``rank``, and then exactly one record of the all_reduce: its bytes
    (3 x H x W x 4), the world and its seconds."""
    for k, rec in enumerate(sharded_records):
        log = rec["log"]
        assert [r.get("collective") for r in log] == [None, None, None, "all_reduce"]
        assert all(r["rank"] == k and r["lanes"] > 0 and "pool" in r for r in log[:-1])
        last = log[-1]
        assert last["bytes"] == 3 * 12 * 12 * 4 and last["world"] == WORLD and last["seconds"] > 0
        assert "pool" not in last and rec["records_logged"] == 4


def test_sharded_regen_without_a_log_is_unchanged(sharded_records):
    """Without a log no record opens, and the sum is bit-identical to the
    logged one and to the shard's sum with a bare all_reduce, the same on
    both ranks, and equal to the sum of both shards computed here (rtol
    1e-6)."""
    scene, cam = _scene()
    cfg = RenderConfig(width=12, height=12, spp=8, max_depth=4, background=(0.0, 0.0, 0.0),
                       max_rays_per_batch=12 * 4)
    parts = [render_regen_shard(scene, cam, cfg, r, WORLD) for r in range(WORLD)]
    for rec in sharded_records:
        assert rec["records_bare"] == 0
        assert np.array_equal(rec["bare"], rec["logged"]) and np.array_equal(rec["bare"], rec["plain"])
        assert np.array_equal(rec["bare"], sharded_records[0]["bare"])
        assert list(rec["n"]) == [parts[0][1]] * 3
        np.testing.assert_allclose(rec["bare"], (parts[0][0] + parts[1][0]).numpy(), rtol=1e-6, atol=0)
    assert parts[0][0].sum() > 0


def test_cli_ranks_write_one_image(tmp_path, monkeypatch):
    """The CLI as two processes on the CPU: rank 0 writes the PNG, the
    tone-mapped sum of both ranks' shares; rank 1 writes nothing."""
    out = tmp_path / "img.png"
    cmd = [sys.executable, "-m", "raytracer2022_tpu_torch.cli", "--scene", "cornell_box", "--device", "cpu",
           "--width", "16", "--height", "16", "--spp", "4", "--max-depth", "4", "--out", str(out)]
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the ranks share the host's cores
    logs = launch_local(WORLD, cmd, TIMEOUT_S)
    assert "Output image as" in logs[0] and "rank 0 of 2" in logs[0]
    assert "Output image as" not in logs[1] and "rank 1 of 2" in logs[1]
    assert sorted(os.listdir(tmp_path)) == ["img.png"]

    bundle = cornell_box(device="cpu")
    cam = make_camera(**dict(bundle.camera_kwargs, aspect_ratio=1.0), device="cpu")
    cfg = RenderConfig(width=16, height=16, spp=4, max_depth=4, background=bundle.background)
    parts = [render_regen_shard(bundle.scene, cam, cfg, r, WORLD) for r in range(WORLD)]
    expect = tonemap_u8(parts[0][0] + parts[1][0], parts[0][1]).numpy()
    assert np.array_equal(read_png(str(out)), expect)


def test_dryrun_task(tmp_path):
    """__graft_entry__.py::dryrun_multichip's four steps at world 2 run
    and pass their checks; both ranks agree."""
    res = _run(tmp_path, "dryrun")
    for key in ("scan_sum", "regen_sum", "loss", "params_regen", "params_scan"):
        assert np.array_equal(res[0][key], res[1][key]), key
    assert np.isfinite(res[0]["loss"]).all() and int(res[0]["n"]) >= WORLD


def test_failed_rank_stops_the_launch(tmp_path):
    """Rank 1 raises after joining while rank 0 waits in an all_reduce:
    launch_local raises within its time limit with rank 1's log tail, and
    no process of the launch is left."""
    marker = f"rank-failure-{os.getpid()}-{tmp_path.name}"
    code = (
        f"# {marker}\n"
        "import argparse, torch, torch.distributed as dist\n"
        "from raytracer2022_tpu_torch.parallel.distributed import init_distributed\n"
        "ap = argparse.ArgumentParser()\n"
        "ap.add_argument('--coordinator'); ap.add_argument('--num-processes', type=int)\n"
        "ap.add_argument('--process-id', type=int)\n"
        "a = ap.parse_args()\n"
        "init_distributed(a.coordinator, a.num_processes, a.process_id, device='cpu')\n"
        "if a.process_id == 1:\n"
        "    raise RuntimeError('rank 1 fails on purpose')\n"
        "dist.all_reduce(torch.zeros(1))\n"
    )
    limit = 60
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose") as err:
        launch_local(WORLD, [sys.executable, "-c", code], limit)
    assert time.monotonic() - t0 < limit
    assert "a rank failed" in str(err.value)
    left = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                if marker.encode() in f.read():
                    left.append(pid)
        except OSError:
            pass
    assert not left, f"processes left behind: {left}"
