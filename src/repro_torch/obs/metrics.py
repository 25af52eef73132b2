"""MetricsRegistry: counters, gauges, and fixed-bucket histograms behind
one ``snapshot() -> dict`` (DESIGN.md §9).

Before this module every layer kept its own private telemetry — the
simulator's bare ``served``/``missed``/``outages`` ints, the solver's
``ResolveStats``, ``NodeQueues``' enqueue/drop tallies, the transport's
per-link byte counts.  The registry is the one place those land: a
subsystem creates named instruments once at wiring time and bumps them with
plain attribute math (no locks, no label cartesian products — one process,
one run), and ``snapshot()`` flattens everything into the dict that
``SimResult.metrics``, ``bench_swarm``, and ``launch/serve.py`` report.

Instruments are deliberately minimal:

* :class:`Counter` — monotone float/int accumulator (``inc``);
* :class:`Gauge`  — last-write-wins scalar (``set``);
* :class:`Histogram` — fixed bucket edges declared at creation
  (vectorized ``observe_many`` for per-window latency arrays; counts +
  sum + min/max, so percentile estimates stay bounded-memory).
"""

from __future__ import annotations

import numpy as np


class Counter:
    """Monotone accumulator."""

    __slots__ = ("n",)

    def __init__(self):
        self.n = 0

    def inc(self, v=1) -> None:
        self.n += v

    @property
    def value(self):
        return self.n


class Gauge:
    """Last-write-wins scalar."""

    __slots__ = ("v",)

    def __init__(self):
        self.v = 0.0

    def set(self, v) -> None:
        self.v = v

    @property
    def value(self):
        return self.v


class Histogram:
    """Fixed-bucket histogram: ``edges`` are the upper bounds of each
    bucket (an implicit +inf bucket catches the rest).  ``observe_many``
    is one ``np.searchsorted`` + ``np.bincount`` over a window's samples —
    the per-tick latency path stays vectorized."""

    __slots__ = ("edges", "counts", "total", "sum", "min", "max")

    def __init__(self, edges):
        self.edges = np.asarray(edges, float)
        if self.edges.ndim != 1 or self.edges.size == 0:
            raise ValueError("histogram needs a 1-D, non-empty edge array")
        if np.any(np.diff(self.edges) <= 0):
            raise ValueError("histogram edges must be strictly increasing")
        self.counts = np.zeros(self.edges.size + 1, np.int64)
        self.total = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def observe(self, x: float) -> None:
        self.observe_many(np.asarray([x], float))

    def observe_many(self, xs: np.ndarray) -> None:
        xs = np.asarray(xs, float)
        if xs.size == 0:
            return
        idx = np.searchsorted(self.edges, xs, side="left")
        self.counts += np.bincount(idx, minlength=self.counts.size)
        self.total += int(xs.size)
        self.sum += float(xs.sum())
        self.min = min(self.min, float(xs.min()))
        self.max = max(self.max, float(xs.max()))

    def quantile(self, q: float) -> float:
        """Bucket-resolution quantile (upper edge of the bucket holding the
        q-th sample; +inf when it lands in the overflow bucket)."""
        if self.total == 0:
            return float("inf")
        rank = q * (self.total - 1)
        cum = np.cumsum(self.counts)
        b = int(np.searchsorted(cum, rank, side="right"))
        return float(self.edges[b]) if b < self.edges.size else float("inf")

    @property
    def mean(self) -> float:
        return self.sum / self.total if self.total else float("nan")

    @property
    def value(self) -> dict:
        return {"count": self.total, "sum": self.sum,
                "min": self.min if self.total else float("nan"),
                "max": self.max if self.total else float("nan"),
                "edges": self.edges.tolist(),
                "counts": self.counts.tolist()}


class MetricsRegistry:
    """Named instruments, created on first use, snapshotted as one dict.

    Names are dotted paths (``queue.dropped``, ``transport.moved_bytes``);
    re-requesting a name returns the same instrument, re-requesting it as a
    different kind raises — one meaning per name per run.
    """

    def __init__(self):
        self._instruments: dict[str, object] = {}

    def _get(self, name: str, kind, *args):
        inst = self._instruments.get(name)
        if inst is None:
            inst = kind(*args)
            self._instruments[name] = inst
        elif type(inst) is not kind:
            raise ValueError(f"metric {name!r} already registered as "
                             f"{type(inst).__name__}, not {kind.__name__}")
        return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, edges=None) -> Histogram:
        if name not in self._instruments and edges is None:
            raise ValueError(f"histogram {name!r} needs edges on creation")
        return self._get(name, Histogram, edges)

    def names(self) -> list[str]:
        return sorted(self._instruments)

    def snapshot(self) -> dict:
        """Every instrument's current value, keyed by name — counters and
        gauges as scalars, histograms as their full bucket dicts."""
        return {name: inst.value
                for name, inst in sorted(self._instruments.items())}


# Default latency bucket edges (seconds): log-ish ladder from 1 ms to the
# multi-minute waits a saturated queue produces under sustained overload.
LATENCY_EDGES_S = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                   1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
                   1000.0)
