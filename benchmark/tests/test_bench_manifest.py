"""BENCHMARK.json parses, keeps to the contract's shapes, and every cell
finds its files by name; a cell added as files and an entry is found with
no file of the harness changed."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest
from conftest import BENCH, ROOT

from harness import cell as cells

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def test_manifest_keeps_the_contracts_shapes():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        raw = f.read()
    assert len(raw.encode()) <= 64 * 1024
    b = json.loads(raw)
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"] and b["command"][1] == "benchmark/run.py"
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    names = [c["name"] for c in b["configs"]] + [w["name"] for w in b["workloads"]]
    names += [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert os.path.isfile(os.path.join(ROOT, c["file"])) and c["file"].startswith("benchmark/")
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["per_layer"]:
        assert m["source"] in SOURCES and m["moves"] in e2e and UNIT.match(m["unit"])
        assert "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
        reported = [m for m in b["end_to_end"] if "workloads" not in m or w["name"] in m["workloads"]]
        assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
        assert any("workloads" not in m or w["name"] in m["workloads"] for m in b["per_layer"])


@pytest.mark.parametrize("name", [w["name"] for w in cells.manifest()["workloads"]])
def test_every_cell_resolves_to_its_files(name):
    c = cells.load(name)
    assert c.config.FRAME and c.config.SOURCE and callable(c.config.describe)
    assert callable(cells.load_module("modes", c.mode).run)
    for m in c.per_layer:
        assert callable(cells.load_module("metrics", m["name"]).read)
    assert set(c.limits) and all(v >= 0 for v in c.limits.values())


def _tree_bytes(path):
    out = {}
    for d, _, files in os.walk(path):
        for f in files:
            if f.endswith(".py") or f.endswith(".json"):
                p = os.path.join(d, f)
                with open(p, "rb") as fh:
                    out[os.path.relpath(p, path)] = fh.read()
    return out


def test_a_new_cell_is_found_from_files_and_an_entry(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    before = _tree_bytes(tmp_path / "benchmark")
    wl = json.load(open(tmp_path / "benchmark" / "workloads" / "cornell_book3.frame.json"))
    wl["pass_spp"] = 8
    (tmp_path / "benchmark" / "workloads" / "cornell_book3.small_passes.json").write_text(json.dumps(wl))
    b = json.load(open(tmp_path / "BENCHMARK.json"))
    b["workloads"].append({"name": "cornell_book3.small_passes", "config": "cornell_book3", "traffic": "small_passes",
                           "chips": 1, "why": "passes of 8 spp"})
    for m in b["end_to_end"] + b["per_layer"]:  # the metrics its sibling cell reports
        if "cornell_book3.frame" in m.get("workloads", []):
            m["workloads"].append("cornell_book3.small_passes")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    code = ("import sys; sys.path[:0] = [sys.argv[1]]; from harness import cell; "
            "c = cell.load('cornell_book3.small_passes'); print(c.mode, c.params['pass_spp'], "
            "[m['name'] for m in c.end_to_end])")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path / "benchmark")], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[:2] == ["frame", "8"] and "Mpaths_s" in out.stdout
    after = _tree_bytes(tmp_path / "benchmark")
    assert {k: v for k, v in after.items() if k in before} == before
