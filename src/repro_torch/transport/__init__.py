"""Transport backends for the execution engine (port of
``repro.transport``).

``inproc`` — modeled link delay + measured host serialization (the device
tensor is synchronised and copied to the host, and the same tensor goes on
to the consuming stage).  The byte-moving ``loopback`` and ``multiproc``
backends, their worker and ``make_transport`` come with a later slice
(ROADMAP).
"""

from .base import LinkStats, ShipResult, Transport, TransportBase, WorkerStats
from .inproc import InProcTransport

__all__ = ["InProcTransport", "LinkStats", "ShipResult", "Transport", "TransportBase",
           "WorkerStats"]
