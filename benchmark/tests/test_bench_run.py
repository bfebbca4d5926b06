"""Whole runs: without a card or without the program a run exits non-zero
and prints no result; a CPU rehearsal of the harness and the reference
loads no JAX and no JAX package; on a card (``cuda`` marker) a short run
of each cell is correct."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch
from conftest import BENCH, ROOT

from harness import cell as cells


def _run(cwd, *extra, timeout=300):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload", "cornell_book3.frame", "--seed",
                           str(2**31 + 11), "--seconds", "1", *extra], cwd=cwd, capture_output=True, text=True,
                          timeout=timeout)


def _results(stdout):
    out = []
    for line in stdout.splitlines():
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        if isinstance(rec, dict) and "metrics" in rec:
            out.append(rec)
    return out


def test_a_run_without_a_card_exits_nonzero_with_no_result():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    out = _run(ROOT, "--trace", "0")
    assert out.returncode != 0 and not _results(out.stdout)
    assert "CUDA card" in out.stderr


def test_a_bare_checkout_exits_nonzero_with_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path, "--trace", "1")
    assert out.returncode != 0 and not _results(out.stdout)


REHEARSAL = f"""
import sys, json, time, torch
sys.path[:0] = [{BENCH!r}, {ROOT!r}]
torch.set_num_threads(4)
from harness import cell as cells
from harness.result import forbidden_modules
frame = cells.load_module("modes", "frame")
fit = cells.load_module("modes", "fit")
dev = torch.device("cpu")
t = time.perf_counter()
c = cells.load("wwscene.frame"); c.params["tile"] = 16
r1 = frame.measure(c, 5, 0.5, True, t, dev, frame=(32, 18), describe_kw=dict(mesh=(8, 6), maps=(16, 8)), ref_spp=8)
c = cells.load("cornell_book3.fit")
r2 = fit.measure(c, 5, 0.5, True, t, dev, fit=dict(width=8, height=8, spp=4))
print(json.dumps({{"forbidden": forbidden_modules(), "frame": sorted(r1["per_layer"]), "fit": sorted(r2["per_layer"]),
                  "e2e": sorted(r1["e2e"]) + sorted(r2["e2e"])}}))
"""


def test_a_cpu_rehearsal_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", REHEARSAL], capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["forbidden"] == []
    assert "scene_build_s" in rec["frame"] and "drain_iter_pct.frame" in rec["frame"]
    assert "fit_iter_ms" in rec["fit"]
    assert {"Mpaths_s", "fit_step_s", "fit_peak_GiB", "setup_s"} <= set(rec["e2e"])


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in cells.manifest()["workloads"] if w["chips"] == 1])
def test_a_short_run_on_the_card_is_correct(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", name, "--seed", str(2**31 + 3),
                          "--seconds", "2", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    rec = _results(out.stdout)[-1]
    assert rec["correct"] and rec["device"]["platform"] == "gpu", rec
