"""The benchmark's own tests (run with ``python -m pytest benchmark/tests``;
the repository's ``pytest tests/`` does not collect them).  The
benchmark's folder and the checkout's root go on ``sys.path``; CPU tests
run small frames with few threads."""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [BENCH, ROOT]


@pytest.fixture(autouse=True)
def _few_threads():
    import torch

    keep = torch.get_num_threads()
    torch.set_num_threads(min(4, keep))
    yield
    torch.set_num_threads(keep)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skipped without one")
