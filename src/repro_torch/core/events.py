"""Discrete-event primitives for the swarm serving simulator.

The paper evaluates placement policies on a *moving* swarm serving a
*stream* of inference requests (§III-C mobility, §IV scenarios).  This
module provides the event substrate the simulator in
``repro_torch.runtime.swarm`` schedules on:

* :class:`EventQueue` — a stable min-heap keyed on (time, seq) so ties
  resolve in insertion order, which keeps runs bit-reproducible.
* :func:`poisson_process` — request arrival times (the streaming-request
  workload of LLHR/DRL follow-ups; exponential inter-arrivals).
* :func:`churn_events` — node failure/rejoin pairs with exponential
  time-between-failure and repair times (the "UAV drops out of the swarm"
  disturbance OULD-MP cannot predict, unlike mobility).

Everything is driven by an externally supplied ``numpy.random.Generator``
so a fixed seed reproduces the exact event tape.
"""

from __future__ import annotations

import dataclasses
import enum
import heapq

import numpy as np


class EventKind(enum.IntEnum):
    ARRIVAL = 0        # a new inference stream starts (payload: request id)
    DEPARTURE = 1      # a stream ends and releases its reservation
    NODE_FAIL = 2      # payload: node id — capacity and links go to zero
    NODE_REJOIN = 3    # payload: node id — node restored
    MOBILITY_TICK = 4  # advance positions one step, re-sample rate matrix
    EPOCH = 5          # re-placement boundary (re-solve OULD/OULD-MP)
    QUEUE_ADVANCE = 6  # drain the tick's emitted frames through node queues


@dataclasses.dataclass(frozen=True, order=True)
class Event:
    time: float
    seq: int                     # tie-breaker: insertion order
    kind: EventKind = dataclasses.field(compare=False)
    payload: int = dataclasses.field(compare=False, default=-1)


class EventQueue:
    """Stable priority queue of :class:`Event`."""

    def __init__(self) -> None:
        self._heap: list[Event] = []
        self._seq = 0

    def push(self, time: float, kind: EventKind, payload: int = -1) -> Event:
        ev = Event(float(time), self._seq, kind, payload)
        self._seq += 1
        heapq.heappush(self._heap, ev)
        return ev

    def pop(self) -> Event:
        return heapq.heappop(self._heap)

    def peek(self) -> Event | None:
        return self._heap[0] if self._heap else None

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)


def poisson_process(rng: np.random.Generator, rate_hz: float,
                    horizon_s: float) -> np.ndarray:
    """Arrival times of a homogeneous Poisson process on [0, horizon_s)."""
    if rate_hz <= 0.0:
        return np.zeros(0)
    # Draw in blocks of the expected count + safety margin until past horizon.
    times: list[float] = []
    t = 0.0
    block = max(8, int(rate_hz * horizon_s * 1.5) + 8)
    while t < horizon_s:
        gaps = rng.exponential(1.0 / rate_hz, block)
        for g in gaps:
            t += g
            if t >= horizon_s:
                break
            times.append(t)
    return np.asarray(times)


@dataclasses.dataclass(frozen=True)
class ChurnEvent:
    time: float
    node: int
    kind: EventKind  # NODE_FAIL or NODE_REJOIN


def churn_events(rng: np.random.Generator, n_nodes: int, horizon_s: float,
                 mtbf_s: float, mttr_s: float,
                 protected: frozenset[int] = frozenset()) -> list[ChurnEvent]:
    """Exponential fail/rejoin tape per node.

    ``mtbf_s`` — mean time between failures (∞ or <=0 disables churn);
    ``mttr_s`` — mean time to repair.  ``protected`` nodes never fail
    (e.g. hotspot/source UAVs, whose loss would make every policy reject).
    """
    out: list[ChurnEvent] = []
    if mtbf_s <= 0 or not np.isfinite(mtbf_s):
        return out
    for node in range(n_nodes):
        if node in protected:
            continue
        t = float(rng.exponential(mtbf_s))
        while t < horizon_s:
            out.append(ChurnEvent(t, node, EventKind.NODE_FAIL))
            t += float(rng.exponential(mttr_s))
            if t >= horizon_s:
                break
            out.append(ChurnEvent(t, node, EventKind.NODE_REJOIN))
            t += float(rng.exponential(mtbf_s))
    out.sort(key=lambda e: (e.time, e.node))
    return out
