"""The four-card cell ``wwscene_x4.frame`` (mode ``sharded``): it resolves
to its files and to ``wwscene``'s scene; four ranks over gloo on the CPU
render a small frame correctly through the program's
``render_sharded_regen_sum``, and leaving one rank's share out of the sum
comes out not correct; the readers of the collective's records give
known values on hand-made logs and nothing without a collective record;
on a host with four cards (``cuda`` marker) a short run is correct."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch
from conftest import ROOT

from harness import cell as cells
from harness.cell import Context
from harness.result import judge

NAME = "wwscene_x4.frame"
READERS = ("rank_skew_pct.x4", "allreduce_ms.x4")
SMALL = dict(frame=(64, 36), describe_kw={"mesh": (8, 6), "maps": (16, 8)}, ref_spp=64)


def test_the_cell_resolves_to_its_files_and_to_wwscenes_scene():
    c = cells.load(NAME)
    cfg, scene = c.config, cells.load_module("configs", "wwscene")
    assert c.mode == "sharded" and c.chips == cfg.WORLD == 4 and cfg.BACKEND == "nccl"
    assert cfg.describe is scene.describe and (cfg.FRAME, cfg.DEPTH, cfg.SPP) == (scene.FRAME, scene.DEPTH, scene.SPP)
    assert cfg.REDUCED == ["spp"] and c.params["pass_spp"] == 128 and c.params["min_units"] == 2
    assert {m["name"] for m in c.end_to_end} == {"Mpaths_s", "setup_s"}
    assert {m["name"] for m in c.per_layer} == {"scene_build_s", "regen_iter_ms.frame", "device_idle_pct.frame",
                                                *READERS}
    assert callable(cells.load_module("modes", "sharded").run)
    assert os.path.isfile(cells.load_module("modes", "sharded").RANK)


def _cpu_run(fault=None):
    sharded = cells.load_module("modes", "sharded")
    c = cells.load(NAME)
    c.params.update(tile=16, pass_spp=32)  # 8 samples a rank
    return c, sharded.measure(c, 2**31 + 77, 0.5, True, time.perf_counter(), "cpu", fault=fault, **SMALL)


def test_four_cpu_ranks_render_the_frame_correctly():
    c, rec = _cpu_run()
    correct, checks = judge(rec["numbers"], c.limits)
    assert correct, checks
    assert rec["passes"] >= 2 and rec["numbers"]["samples_gap"] == 0 and rec["failed"] == 0
    assert rec["collective"]["bytes"] == 3 * 36 * 64 * 4 and len(rec["rank_strip_s"]) == 4
    assert set(READERS) | {"scene_build_s", "regen_iter_ms.frame"} <= set(rec["per_layer"])
    assert rec["e2e"]["Mpaths_s"] > 0 and rec["e2e"]["setup_s"] > 0


def test_a_rank_left_out_of_the_sum_is_not_correct():
    c, rec = _cpu_run(fault="rank_left_out")
    correct, checks = judge(rec["numbers"], c.limits)
    assert not correct, checks
    assert rec["numbers"]["samples_gap"] == 0  # the samples are still counted: the tiles catch it


def _log(strips, colls):
    """A rank's launch log: each pass two strips of half its seconds, then
    the collective's record."""
    out = []
    for s, a in zip(strips, colls):
        out += [{"rank": 0, "pool": 4, "drain_n4": 1, "drain_n16": 1, "seconds": s / 2}] * 2
        out.append({"collective": "all_reduce", "bytes": 44236800, "world": 4, "seconds": a})
    return out


STRIPS = [[2.0, 4.0, 3.0], [3.0, 4.0, 3.0], [2.5, 5.0, 3.0], [2.5, 3.0, 3.3]]  # rank x pass
COLLS = [[0.5, 0.010, 0.030], [0.004, 0.002, 0.020], [0.2, 0.009, 0.001], [0.3, 0.5, 0.4]]
LOGS = [_log(s, a) for s, a in zip(STRIPS, COLLS)]
# rank 0's unit 1 (pass 0) ran under the profiler: the skew leaves rank 0
# out, the collective's time leaves pass 0 out
TRACED = {"rank_skew_pct.x4": 12.5, "allreduce_ms.x4": 1e3 * (0.002 + 0.001) / 2}
UNTRACED = {"rank_skew_pct.x4": 20.0, "allreduce_ms.x4": 2.0}


def _ctx(logs, profiled):
    return Context(units=logs[0], profiled=profiled, trace=None, setup={}, probes={"ranks": lambda: logs})


@pytest.mark.parametrize("name", READERS)
def test_a_collective_reader_reads_the_records_exactly(name):
    reader = cells.load_module("metrics", name)
    assert reader.read(_ctx(LOGS, {1})) == pytest.approx(TRACED[name], rel=1e-12)
    assert reader.read(_ctx(LOGS, set())) == pytest.approx(UNTRACED[name], rel=1e-12)


@pytest.mark.parametrize("name", READERS)
def test_a_collective_reader_gives_nothing_without_the_record(name):
    reader = cells.load_module("metrics", name)
    strips_only = [[u for u in log if "collective" not in u] for log in LOGS]
    assert reader.read(_ctx(strips_only, set())) is None
    assert reader.read(_ctx(strips_only, {1})) is None
    assert reader.read(Context(units=LOGS[0], profiled=set(), trace=None, setup={})) is None


def test_the_collectives_time_leaves_out_every_profiled_pass():
    reader = cells.load_module("metrics", "allreduce_ms.x4")
    assert reader.read(_ctx(LOGS, set(range(len(LOGS[0]))))) is None
    assert reader.read(_ctx(LOGS, {4, 7})) == pytest.approx(4.0, rel=1e-12)  # pass 0 alone


@pytest.mark.cuda
def test_a_short_run_on_four_cards_is_correct():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four NVIDIA GPUs")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", NAME, "--seed", str(2**31 + 3),
                          "--seconds", "2", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["correct"] and rec["device"]["count"] == 4, rec
