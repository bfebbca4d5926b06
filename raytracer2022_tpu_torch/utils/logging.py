"""Styled 5-stage console logging (parity with main.rs:54-228), as in the
JAX package's ``utils/logging.py``."""

from __future__ import annotations

import sys
import time

_STAGES = [
    ("💿", "Initializing..."),
    ("🚀", "Rendering..."),
    ("🚛", "Collecting Results..."),
    ("🏭", "Generating Image..."),
    ("🥽", "Outputting Image..."),
]


def _style(text: str, code: str) -> str:
    return f"\x1b[{code}m{text}\x1b[0m" if sys.stdout.isatty() else text


def dim(text: str) -> str:
    return _style(text, "2;1")


def green(text: str) -> str:
    return _style(text, "32")


def yellow(text: str) -> str:
    return _style(text, "33")


class StageLogger:
    """5-stage render logger with elapsed-time reporting."""

    def __init__(self, quiet: bool = False):
        self.quiet = quiet
        self.t0 = time.perf_counter()
        self._p0 = None

    def stage(self, i: int, extra: str = "") -> None:
        if self.quiet:
            return
        emoji, text = _STAGES[i - 1]
        msg = f"{dim(f'[{i}/5]')} {emoji} {green(text)}"
        if extra:
            msg += f" {yellow(extra)}"
        print(msg, flush=True)

    def config_echo(self, **kv) -> None:
        if self.quiet:
            return
        for k, v in kv.items():
            print(f"{k.upper().replace('_', ' ')}: {yellow(str(v))}", flush=True)

    def progress(self, done: int, total: int) -> None:
        """In-place render progress bar with ETA (main.rs:122-127, 135, 155)."""
        if self.quiet:
            return
        if self._p0 is None:
            self._p0 = time.perf_counter()
        frac = done / max(total, 1)
        elapsed = time.perf_counter() - self._p0
        eta = elapsed / max(frac, 1e-9) * (1.0 - frac)
        width = 30
        bar = "=" * int(frac * width) + ">" + " " * (width - int(frac * width))
        end = "\n" if done >= total else "\r"
        print(
            f"      [{bar}] {done}/{total} spp  "
            f"{yellow(f'{elapsed:.0f}s')} elapsed, ETA {yellow(f'{eta:.0f}s')}   ",
            end=end,
            flush=True,
        )

    def done(self) -> None:
        if self.quiet:
            return
        elapsed = time.perf_counter() - self.t0
        print(f"\n      🎉 {green('All Work Done.')}")
        print(f"      🕒 Elapsed Time: {yellow(f'{elapsed:.1f}s')}\n", flush=True)
