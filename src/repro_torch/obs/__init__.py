"""End-to-end observability (port of ``repro.obs``): a bounded
flight-recorder :class:`Tracer` with Chrome trace-event export, and a
:class:`MetricsRegistry` of counters, gauges and fixed-bucket histograms.

Copies of the reference's numpy-only modules.  :class:`NullTracer` is the
default, so the traced-off path is free.
"""

from .metrics import (LATENCY_EDGES_S, Counter, Gauge, Histogram,
                      MetricsRegistry)
from .tracer import (ADMISSION, ENGINE, FRAMES, NULL_TRACER, QUEUE, SOLVER,
                     TRANSPORT, NullTracer, Tracer)

__all__ = [
    "ADMISSION", "ENGINE", "FRAMES", "NULL_TRACER", "QUEUE", "SOLVER",
    "TRANSPORT", "Counter", "Gauge", "Histogram", "LATENCY_EDGES_S",
    "MetricsRegistry", "NullTracer", "Tracer",
]
