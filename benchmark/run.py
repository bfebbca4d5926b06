"""Run one cell of the benchmark once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cell's cards.  The
cell's files are found by name (``harness/cell.py``).  With ``--trace 0``
the result line holds the cell's end-to-end metrics, with ``--trace 1``
its per-layer metrics.  Exits non-zero, printing no result, without enough
CUDA cards, without the program, or where the run loaded JAX or the JAX
package.  Build caches go under ``build/`` in the checkout.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _fixed_caches() -> None:
    """Every compile cache at a fixed path inside the checkout, so that only
    a checkout's first run builds (the program builds its own kernels under
    ``build/`` in a checkout)."""
    cache = os.path.join(ROOT, "build", "bench-cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(cache, sub)
    # one host thread for the CPU's share of the work: the render is bound
    # by one thread's dispatch, which a pool of spinning threads slows
    os.environ["OMP_NUM_THREADS"] = "1"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _fixed_caches()
    sys.path[:0] = [HERE, ROOT]
    from harness import cell as cells

    cell = cells.load(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: {cell.name} needs {cell.chips} CUDA card(s); {have} found", file=sys.stderr)
        return 2
    try:
        import raytracer2022_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"benchmark: the program is not in this checkout ({e})", file=sys.stderr)
        return 2
    mode = cells.load_module("modes", cell.mode)
    return mode.run(cell, args.seed, args.seconds, bool(args.trace), T_START)


if __name__ == "__main__":
    raise SystemExit(main())
