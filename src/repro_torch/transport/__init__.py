"""Byte-moving transport backends for the execution engine (port of
``repro.transport``; DESIGN.md §7).

================  ==========================================================
backend           what a transfer costs
================  ==========================================================
``inproc``        modeled link delay + measured host serialization (the
                  device tensor is synchronised and copied to the host, and
                  the same tensor goes on to the consuming stage)
``loopback``      real serialization + kernel socket copy to a worker OS
                  process and back; the consuming stage reads the
                  reconstructed tensor, back on the device it left
``multiproc``     loopback where every worker is a torch process (one per
                  node group, SNIPPETS §2) that lands the buffer on its
                  device (the card by default) before echoing
================  ==========================================================
"""

from __future__ import annotations

import numpy as np
import torch

from .base import LinkStats, ShipResult, Transport, TransportBase, WorkerStats
from .inproc import InProcTransport
from .loopback import LoopbackTransport
from .multiproc import MultiProcTransport

TRANSPORTS = ("inproc", "loopback", "multiproc")


def make_transport(name: str, *, n_workers: int = 2,
                   group_of: np.ndarray | None = None,
                   device: str | torch.device = "cuda") -> Transport:
    """Build a backend by registry name (the ``--transport`` CLI values);
    ``device`` is where ``multiproc`` workers land the bytes."""
    if name == "inproc":
        return InProcTransport()
    if name == "loopback":
        return LoopbackTransport(n_workers=n_workers)
    if name == "multiproc":
        return MultiProcTransport(
            n_workers=None if group_of is not None else n_workers,
            group_of=group_of, device=device)
    raise ValueError(f"unknown transport {name!r}; one of {TRANSPORTS}")


__all__ = [
    "InProcTransport", "LinkStats", "LoopbackTransport", "MultiProcTransport",
    "ShipResult", "TRANSPORTS", "Transport", "TransportBase", "WorkerStats",
    "make_transport",
]
