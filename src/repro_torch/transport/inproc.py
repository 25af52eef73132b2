"""In-process transport: the modeled-delay path, bit-compatible default
(port of ``repro/transport/inproc.py``).

Per transfer it waits for the producer's activation (a synchronise on the
card), copies it to the host — the observable serialization cost of a U2U
shipment on this substrate — and hands the *same* device tensor to the
consuming stage.  No bytes leave the process; the link delay stays the
analytic ``nbytes × spb`` term the planner priced.  Returning the input
tensor unchanged is what keeps an engine with this transport bitwise equal
to one with no transport.
"""

from __future__ import annotations

import time

import torch

from .base import ShipResult, TransportBase


class InProcTransport(TransportBase):
    name = "inproc"

    def ship(self, src_node: int, dst_node: int, array: torch.Tensor) -> ShipResult:
        t0 = time.perf_counter()
        if array.is_cuda:
            torch.cuda.synchronize(array.device)
        host = array.detach().cpu().numpy()
        wall = time.perf_counter() - t0
        self._record(src_node, dst_node, host.nbytes, wall)
        return ShipResult(array, int(host.nbytes), wall, moved=False)
