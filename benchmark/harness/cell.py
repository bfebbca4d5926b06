"""Finding a cell's files by name.

``BENCHMARK.json`` (the checkout's root) names the cells and the metrics.
A cell ``<name>`` has ``workloads/<name>.json`` (its configuration, mode,
chips and parameters), its configuration ``configs/<config>.py``, its mode
``modes/<mode>.py`` (``run(cell, seed, seconds, trace, t_start)``), and
each per-layer metric ``<metric>`` it reports a reader
``metrics/<metric>.py`` (``read(ctx)`` -> a number, or None where the run
holds nothing to read).  Adding a cell, a configuration, a mode or a
metric adds files and entries; no file here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
import types
from typing import Callable, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def manifest() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def load_module(kind: str, name: str) -> types.ModuleType:
    """``<kind>/<name>.py`` of the benchmark's folder, loaded by path (a
    name may hold dots)."""
    path = os.path.join(BENCH_DIR, kind, f"{name}.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind[:-1]} {name!r}: {path} is missing")
    key = f"_bench_{kind}_{name.replace('.', '_')}"
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    mode: str
    chips: int
    params: dict  # the workload file
    end_to_end: list  # BENCHMARK.json's entries this cell reports
    per_layer: list

    @property
    def config(self) -> types.ModuleType:
        return load_module("configs", self.config_name)

    @property
    def limits(self) -> dict:
        return self.params["limits"]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(name: str, bench: Optional[dict] = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its workload file."""
    bench = manifest() if bench is None else bench
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"BENCHMARK.json has no workload {name!r}")
    path = os.path.join(BENCH_DIR, "workloads", f"{name}.json")
    with open(path) as f:
        params = json.load(f)
    if params["config"] != entry["config"] or int(params["chips"]) != int(entry["chips"]):
        raise ValueError(f"{path} disagrees with BENCHMARK.json on the configuration or the chips")
    return Cell(name=name, config_name=params["config"], mode=params["mode"], chips=int(params["chips"]),
                params=params, end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"] if _applies(m, name)])


@dataclasses.dataclass
class Context:
    """What a per-layer reader reads after the window: the mode's units
    (strip launches or steps, each a dict with its ``seconds``), the
    profiled units' indices, the trace summary (:mod:`harness.trace`), the
    set-up's record, and probes (functions run once, on demand)."""

    units: list
    profiled: set
    trace: Optional[dict]
    setup: dict
    probes: dict = dataclasses.field(default_factory=dict)
    _cache: dict = dataclasses.field(default_factory=dict)

    def probe(self, name: str):
        fn: Optional[Callable] = self.probes.get(name)
        if fn is None:
            return None
        if name not in self._cache:
            self._cache[name] = fn()
        return self._cache[name]

    def unprofiled(self) -> list:
        return [u for i, u in enumerate(self.units) if i not in self.profiled]


def read_per_layer(cell: Cell, ctx: Context) -> dict:
    """Each per-layer metric of ``cell`` that its reader finds -> {name:
    {"value", "unit"}}."""
    out = {}
    for m in cell.per_layer:
        value = load_module("metrics", m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
