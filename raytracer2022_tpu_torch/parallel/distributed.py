"""Multi-process execution: one process per rank, joined by torch.distributed.

Counterpart of ``raytracer2022_tpu/parallel/distributed.py``.  The JAX
package joins one process per host through ``jax.distributed`` and lets
XLA pick the transport.  Here every rank is one process on one device,
and the ranks meet through ``torch.distributed``: NCCL between cards,
gloo on the CPU and wherever the caller asks for it (two ranks sharing one
card, whose CUDA tensors gloo stages through the host).  The sharded
renderers and the fit step in :mod:`.mesh` then run on every rank.

Run one process per rank with e.g.::

    python -m raytracer2022_tpu_torch.cli --scene cornell_box ... \\
        --coordinator host0:12345 --num-processes 2 --process-id $RANK

or start all ranks of one host with :func:`.worker.launch_local`.
"""

from __future__ import annotations

import datetime
from typing import Optional

import torch
import torch.distributed as dist

from ..utils.device import resolve_device

# a rank that waits this long on its peers (to join, or in a collective)
# fails instead of hanging
DEFAULT_TIMEOUT_S = 300.0


def default_backend(device) -> str:
    """NCCL for a rank on a card, gloo for a rank on the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def rank_device(device, rank: Optional[int] = None) -> torch.device:
    """The device of rank ``rank`` (default: this process's rank, 0
    without a process group).  ``"cuda"`` without an index gives rank ``k``
    the card ``k % torch.cuda.device_count()``; an explicit index
    (``"cuda:0"``) puts every rank on that card; the CPU stays the CPU.  A
    CUDA device needs a card: without one it raises."""
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    if rank is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
    return torch.device("cuda", rank % torch.cuda.device_count())


def init_distributed(
    coordinator: Optional[str],
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device="cuda",
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> bool:
    """Join (or skip joining) a multi-process group.

    No-op returning False when ``coordinator`` (``host:port`` of rank 0)
    is None.  Otherwise this process becomes rank ``process_id`` of
    ``num_processes`` on :func:`rank_device` of ``device`` (made the
    current card for a CUDA rank), over ``backend``: None means
    :func:`default_backend` of that device; any other choice is the
    caller's.  A rank that waits ``timeout_s`` on its peers raises.
    """
    if not coordinator:
        return False
    if num_processes is None or process_id is None:
        raise ValueError("init_distributed: a coordinator needs num_processes and process_id")
    dev = rank_device(device, process_id)
    backend = default_backend(dev) if backend is None else backend
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend,
        init_method=f"tcp://{coordinator}",
        world_size=num_processes,
        rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s),
        device_id=dev if backend == "nccl" else None,
    )
    return True


def is_primary() -> bool:
    """True on the process that should write images and print reports:
    rank 0, or the only process when there is no process group."""
    return not dist.is_initialized() or dist.get_rank() == 0
