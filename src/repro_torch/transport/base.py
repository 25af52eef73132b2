"""The Transport contract: how activation bytes cross a link (DESIGN.md §7).

The execution engine routes every :class:`~repro_torch.exec.stage_graph.Transfer`
through one of these backends.  A backend does three things per shipment:

1. **materialize** the activation off the device (real serialization),
2. **move** it — or not: the in-proc backend is the modeled-delay path —
   and hand back the array the consuming stage should read,
3. **measure** the wall of the whole hop and accumulate it per directed
   link, so :func:`repro_torch.exec.calibrate.calibrated_problem` can turn
   realized seconds/byte into calibrated rates for a planner re-solve.

The contract is deliberately synchronous and per-transfer: the engine's
topological tick loop already orders producer before consumer, and the paper
prices each boundary shipment independently (Eq. 14 sums per-link terms).
"""

from __future__ import annotations

import dataclasses
from typing import Protocol, runtime_checkable

import numpy as np

from ..obs import NULL_TRACER, TRANSPORT


@dataclasses.dataclass(frozen=True)
class ShipResult:
    """One completed shipment."""

    array: object          # what the consuming stage reads (device or host)
    nbytes: int            # payload bytes materialized for this hop
    wall_s: float          # measured wall of the whole hop
    moved: bool            # True iff the bytes left this process


@dataclasses.dataclass
class LinkStats:
    """Accumulated realized samples of one directed link."""

    n: int = 0
    nbytes: float = 0.0
    wall_s: float = 0.0

    @property
    def bytes_per_s(self) -> float:
        return self.nbytes / self.wall_s if self.wall_s > 0 else float("inf")

    @property
    def seconds_per_byte(self) -> float:
        return self.wall_s / self.nbytes if self.nbytes > 0 else 0.0


@dataclasses.dataclass
class WorkerStats:
    """Accumulated worker-side timing for one worker process, as reported
    in OP_REPLY headers: seconds draining payloads off the socket and
    seconds in the echo/device hop (durations, worker clock)."""

    n: int = 0
    recv_s: float = 0.0
    echo_s: float = 0.0


@runtime_checkable
class Transport(Protocol):
    """A byte-moving backend the engine can route transfers through."""

    name: str
    link_stats: dict[tuple[int, int], LinkStats]

    def ship(self, src_node: int, dst_node: int, array) -> ShipResult: ...

    def close(self) -> None: ...


class TransportBase:
    """Shared telemetry: per-link realized bandwidth accounting."""

    name = "base"

    def __init__(self):
        self.link_stats: dict[tuple[int, int], LinkStats] = {}
        self.moved_bytes: float = 0.0   # bytes that actually left the process
        self._tracer = NULL_TRACER

    def set_tracer(self, tracer) -> None:
        """Attach a :class:`repro_torch.obs.Tracer`: every recorded shipment emits
        one TRANSPORT span (real-time domain, ``tracer.now()``) with payload
        bytes and realized bandwidth as args.  All backends funnel through
        :meth:`_record`, so this is the single emission point — the engine
        and the swarm's substrate-sampling path never double-emit."""
        self._tracer = tracer if tracer is not None else NULL_TRACER
        if self._tracer.enabled:
            self._tracer.intern("ship", "nbytes", "bytes_per_s")
            # Worker-process backends emit these on the per-worker
            # "transport_worker" track (lane = worker index).
            self._tracer.intern("worker_recv", "recv_s")
            self._tracer.intern("worker_echo", "echo_s")

    def _record(self, src: int, dst: int, nbytes: int, wall_s: float) -> None:
        ls = self.link_stats.setdefault((src, dst), LinkStats())
        ls.n += 1
        ls.nbytes += nbytes
        ls.wall_s += wall_s
        if self._tracer.enabled:
            self._tracer.span(
                TRANSPORT, "ship", self._tracer.now() - wall_s, wall_s,
                lane=src, a0=float(nbytes),
                a1=nbytes / wall_s if wall_s > 0 else float("inf"))

    def measured_spb(self, n_nodes: int) -> np.ndarray:
        """(N, N) realized seconds/byte; NaN where the link was never
        sampled — the comm-calibration twin of ``measured_layer_seconds``."""
        spb = np.full((n_nodes, n_nodes), np.nan)
        for (s, d), ls in self.link_stats.items():
            if s < n_nodes and d < n_nodes and ls.nbytes > 0:
                spb[s, d] = ls.seconds_per_byte
        return spb

    def link_seconds_per_byte(self) -> dict[tuple[int, int], float]:
        """Sampled links only — what :func:`calibrate_rates` consumes."""
        return {k: ls.seconds_per_byte for k, ls in self.link_stats.items()
                if ls.nbytes > 0}

    def start(self) -> None:        # backends with processes override
        pass

    def close(self) -> None:
        pass

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.close()
        return False
