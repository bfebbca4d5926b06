"""The device the port's entry points build on.

Scenes and cameras default to the card (``DEFAULT_DEVICE``).  Without one
they raise instead of building on the CPU; the CPU is used only when the
caller asks for it (``device="cpu"``), as the tests do.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device) -> torch.device:
    """``device`` as a :class:`torch.device`; a CUDA device needs a card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r}: no CUDA device is available "
            "(pass device='cpu' to build on the CPU)"
        )
    return dev


def synchronize(device) -> None:
    """Wait for ``device``'s queued work: a timed region on the card ends
    here (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
