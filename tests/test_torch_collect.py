"""The repository's tests collect where torch is not installed, as in its CI,
which installs the JAX package alone: every port test file is skipped with a
reason, and every JAX test file is still collected.

This file imports neither torch nor the port.  It runs pytest's collection
in a subprocess whose ``sitecustomize`` sets ``sys.modules["torch"] = None``,
so that ``import torch`` fails there as it does without the package."""

import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def test_tests_collect_without_torch(tmp_path):
    (tmp_path / "sitecustomize.py").write_text('import sys\nsys.modules["torch"] = None\n')
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [str(tmp_path), os.environ.get("PYTHONPATH")])))
    # -m "": collect the slow tests too, so that every JAX test file shows
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "tests/", "--collect-only", "-q", "-p", "no:cacheprovider", "-rs", "-m", ""],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0, f"collection failed without torch (exit {proc.returncode}):\n{out[-4000:]}"
    assert not re.search(r"\d+ errors?\b", out.splitlines()[-1]), out[-4000:]

    files = sorted(p.name for p in (ROOT / "tests").glob("test_*.py"))
    port = [f for f in files if f.startswith("test_torch_") and f != Path(__file__).name]
    jax_files = [f for f in files if not f.startswith("test_torch_")]
    assert port and jax_files
    skipped = set(re.findall(r"^SKIPPED \[\d+\] tests/(test_torch_\w+\.py):\d+: could not import 'torch'", out, re.M))
    assert skipped == set(port), f"not skipped for want of torch: {sorted(set(port) - skipped)}"
    collected = set(re.findall(r"^tests/(test_\w+\.py)::", out, re.M))
    assert set(jax_files) <= collected, f"JAX test files not collected: {sorted(set(jax_files) - collected)}"
    assert not collected & set(port)
