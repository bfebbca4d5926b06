"""The launch record (``utils/profiling.py``): spans cost nothing with no
record and no profiler; a launch with a ``launch_log`` gets its host self
times by span, its counted syncs with their wait and its lane occupancy,
on every schedule and on the fixed-depth path; the record changes no
rendered number; and under the profiler every span is still a
``record_function`` of the same name."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from raytracer2022_tpu_torch.render import integrator  # noqa: E402
from raytracer2022_tpu_torch.render import renderer as R  # noqa: E402
from raytracer2022_tpu_torch.render.camera import make_camera  # noqa: E402
from raytracer2022_tpu_torch.render.integrator import Schedule  # noqa: E402
from raytracer2022_tpu_torch.scene.builder import SceneBuilder  # noqa: E402
from raytracer2022_tpu_torch.utils import profiling  # noqa: E402
from raytracer2022_tpu_torch.utils.profiling import host_sync, launch_record, span  # noqa: E402

torch.set_num_threads(1)

RECORD_KEYS = {"span_self_s", "span_calls", "syncs", "sync_wait_s", "live_lanes", "wavefront_lanes"}


def _lit_scene():
    b = SceneBuilder()
    light = b.rect_xz(-1, 1, -1, 1, 3.9, b.diffuse_light((8.0, 8.0, 8.0)))
    b.flip_face(light)
    b.add_light(light)
    b.rect_xz(-4, 4, -4, 4, 0.0, b.lambertian((0.6, 0.4, 0.3)))
    b.rect_xy(-4, 4, 0, 4, 3.0, b.metal((0.8, 0.8, 0.8), 0.3))
    return b.finalize(device="cpu"), make_camera((0, 2, -8), (0, 1, 0), (0, 1, 0), 40, 1.0, device="cpu")


def test_span_is_the_shared_no_op_without_a_record_or_a_profiler():
    assert span("vertex.shading") is profiling._NO_SPAN
    assert span("regen.update") is span("closest_hit.dense")
    assert host_sync(int, torch.tensor(3)) == 3


def test_self_time_takes_off_children_and_sync_waits(monkeypatch):
    """Nested spans on a stepped clock: each span's self time is its
    duration less its children's, a sync's duration is wait and nobody's
    self time, and entries are counted."""
    ticks = iter(range(100))
    monkeypatch.setattr(profiling.time, "perf_counter", lambda: float(next(ticks)))
    log: list = []
    with launch_record(log, torch.device("cpu")) as entry:  # t0 = 0
        with span("vertex.closest_hit"):  # 1 .. 8
            with span("closest_hit.dense"):  # 2 .. 3
                pass
            host_sync(int, torch.tensor(1))  # 4 .. 5
            with span("closest_hit.dense"):  # 6 .. 7
                pass
        profiling.count_lanes(3, 4)
        profiling.count_lanes(1, 4)
        entry["lanes"] = 4
    (e,) = log
    assert set(e) == {"lanes", "seconds"} | RECORD_KEYS and e["seconds"] == 9.0
    assert e["span_self_s"] == {"closest_hit.dense": 2.0, "vertex.closest_hit": 4.0}
    assert e["span_calls"] == {"closest_hit.dense": 2, "vertex.closest_hit": 1, "regen.sync": 1}
    assert (e["syncs"], e["sync_wait_s"], e["live_lanes"], e["wavefront_lanes"]) == (1, 1.0, 4, 8)


def test_no_launch_log_opens_no_record():
    with launch_record(None, torch.device("cpu")) as entry:
        assert span("regen.update") is profiling._NO_SPAN
        profiling.count_lanes(1, 2)  # nothing to add to
        entry["lanes"] = 1


@pytest.mark.parametrize("schedule", [Schedule.GLOBAL, Schedule.PIXEL, Schedule.QUOTA, "fixed_depth"])
def test_every_launch_carries_its_record(schedule, monkeypatch):
    """render_sum_n with a launch log: every entry has the record's keys;
    self times and waits are >= 0 and together at most the launch's
    seconds; the syncs at least the iterations; occupancy in (0, 1]; and
    the rendered sum is bit-identical without the log."""
    scene, cam = _lit_scene()
    kw = dict(width=128, height=72, spp=8, max_depth=6, background=(0.0, 0.0, 0.0))
    if schedule == "fixed_depth":
        cfg = R.RenderConfig(**dict(kw, width=16, height=12), regen=False, spp_per_batch=4)
    else:
        monkeypatch.setattr(integrator, "choose_schedule", lambda spp_seq, spp_par: schedule)
        cfg = R.RenderConfig(**kw)
    log: list = []
    total, n = R.render_sum_n(scene, cam, cfg, launch_log=log)
    bare, n_bare = R.render_sum_n(scene, cam, cfg)
    np.testing.assert_array_equal(total.numpy(), bare.numpy())
    assert n == n_bare and log
    for e in log:
        assert RECORD_KEYS <= set(e) and e["lanes"] > 0
        selfs = list(e["span_self_s"].values())
        assert all(s >= 0 for s in selfs) and e["sync_wait_s"] >= 0
        assert sum(selfs) + e["sync_wait_s"] <= e["seconds"]
        assert e["span_calls"]["regen.accumulate"] == 1
        if schedule == "fixed_depth":
            assert e["syncs"] == 0 and e["wavefront_lanes"] == 0  # no count reaches the host
            assert e["span_calls"]["vertex.closest_hit"] == cfg.max_depth
            continue
        iters = e["pool"] + e["drain_n4"] + e["drain_n16"]
        assert iters > 0 and e["drain_n4"] > 0  # 9,216 lanes: the narrow drains run
        assert e["syncs"] >= iters and e["span_calls"]["regen.sync"] == e["syncs"]
        assert 0 < e["live_lanes"] <= e["wavefront_lanes"]
        assert e["span_calls"]["vertex.closest_hit"] == iters
        assert {"regen.update", "regen.rays", "regen.compact", "vertex.update"} <= set(e["span_self_s"])


def test_the_sort_and_the_cluster_walk_feed_the_record():
    """The sorted quota schedule (600 spheres in a tree, 2,048 lanes): one
    ``regen.sort`` an iteration, and the cluster walk's compaction reads
    are counted syncs beside the loop's live counts."""
    b = SceneBuilder()
    dome = b.sphere((0, 0, 0), 50, b.diffuse_light((1.0, 0.9, 0.8)))
    b.flip_face(dome)
    for c in np.random.default_rng(1).uniform((-12, -12, -45), (12, 12, -25), (600, 3)):
        b.sphere(c, 0.4, b.lambertian((0.5, 0.5, 0.5)))
    scene = b.finalize(device="cpu")
    assert scene.use_bvh
    cam = make_camera((0, 0, 0), (0, 0, -1), (0, 1, 0), 40, 2.0, device="cpu")
    tcfg = integrator.TraceConfig(max_depth=3, background=(0.0, 0.0, 0.0), sort_rays=True)
    log: list = []
    with launch_record(log, scene.device) as entry:
        _, iters = R.render_batch_regen(scene, cam, R.step_generator(0, 0, "cpu"), 64, 32, 1, 2, tcfg,
                                        return_iters=True)
        entry.update(iters)
    (e,) = log
    assert e["span_calls"]["regen.sort"] == e["pool"] > 0 and e["drain_n4"] == 0
    assert e["syncs"] > e["pool"] + 1 and e["span_calls"]["closest_hit.cluster_walk"] == e["pool"]
    assert e["wavefront_lanes"] == e["pool"] * 64 * 32 and 0 < e["live_lanes"] <= e["wavefront_lanes"]


def test_spans_stay_record_functions_under_the_profiler():
    """With a profiler and a record both on, each span is a profiler event
    of its name and feeds the record."""
    from torch.profiler import ProfilerActivity, profile

    scene, cam = _lit_scene()
    cfg = R.RenderConfig(width=16, height=12, spp=8, max_depth=4, background=(0.0, 0.0, 0.0))
    log: list = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        R.render_sum_n(scene, cam, cfg, launch_log=log)
    names = {e.key for e in prof.key_averages()}
    (e,) = log
    assert {"vertex.closest_hit", "vertex.sampling", "regen.update", "regen.sync", "regen.accumulate"} <= names
    assert e["span_calls"]["vertex.sampling"] == e["pool"] and e["syncs"] == e["pool"] + 1
