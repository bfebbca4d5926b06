"""The readers of the launch records (``render_sum_n``'s launch log with
each launch's host record) on hand-made contexts: they read the
unprofiled launches only, give nothing where the records lack their keys
(a program without the records), and compute their ratio exactly."""

import pytest

from harness import cell as cells
from harness.cell import Context

READERS = ("syncs_per_iter.frame", "sync_wait_pct.frame", "lane_occupancy_pct.frame", "vertex_host_pct.frame",
           "scheduler_host_pct.frame")


def _unit(seconds, syncs, wait, live, width, spans, pool=6, n4=3, n16=1):
    return {"lanes": 1024, "pool": pool, "drain_n4": n4, "drain_n16": n16, "seconds": seconds,
            "span_self_s": spans, "span_calls": {name: 1 for name in spans}, "syncs": syncs, "sync_wait_s": wait,
            "live_lanes": live, "wavefront_lanes": width}


SPANS_A = {"vertex.closest_hit": 0.25, "closest_hit.dense": 0.5, "vertex.update": 0.25, "regen.update": 0.5,
           "regen.rays": 0.25}
SPANS_B = {"vertex.sampling": 1.0, "regen.accumulate": 0.25, "regen.compact": 0.5}
# unit 1 is profiled and reads wildly: a reader that counts it is off
UNITS = [_unit(2.0, 14, 0.5, 768, 1024, SPANS_A), _unit(100.0, 1000, 90.0, 1, 1000, {"vertex.shading": 99.0}),
         _unit(4.0, 26, 1.5, 256, 1024, SPANS_B, pool=12, n4=6, n16=2)]
EXACT = {
    "syncs_per_iter.frame": (14 + 26) / (10 + 20),
    "sync_wait_pct.frame": 100.0 * (0.5 + 1.5) / (2.0 + 4.0),
    "lane_occupancy_pct.frame": 100.0 * (768 + 256) / 2048,
    "vertex_host_pct.frame": 100.0 * (0.25 + 0.5 + 0.25 + 1.0) / 6.0,
    "scheduler_host_pct.frame": 100.0 * (0.5 + 0.25 + 0.25 + 0.5) / 6.0,
}


@pytest.mark.parametrize("name", READERS)
def test_a_reader_reads_the_unprofiled_records_exactly(name):
    ctx = Context(units=UNITS, profiled={1}, trace=None, setup={})
    assert cells.load_module("metrics", name).read(ctx) == pytest.approx(EXACT[name], rel=1e-12)


@pytest.mark.parametrize("name", READERS)
def test_a_reader_gives_nothing_without_the_records(name):
    bare = [{"lanes": 1024, "pool": 6, "drain_n4": 3, "drain_n16": 1, "seconds": 2.0} for _ in range(3)]
    assert cells.load_module("metrics", name).read(Context(units=bare, profiled={1}, trace=None, setup={})) is None
    # records only in the profiled launch: still nothing
    mixed = [bare[0], UNITS[1], bare[2]]
    assert cells.load_module("metrics", name).read(Context(units=mixed, profiled={1}, trace=None, setup={})) is None


@pytest.mark.parametrize("name", READERS)
def test_each_reader_is_a_frame_metric_of_the_manifest(name):
    entry = next(m for m in cells.manifest()["per_layer"] if m["name"] == name)
    assert entry["workloads"] == ["wwscene.frame", "cornell_book3.frame"] and entry["moves"] == "Mpaths_s"
