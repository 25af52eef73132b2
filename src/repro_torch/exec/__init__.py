"""Plan-faithful distributed execution (port of ``repro.exec``).

The optimizer stack (``core/``) *prices* a placement analytically; this
package *runs* it.  Any :class:`~repro_torch.core.planner.Plan` compiles into
a :class:`StageGraph` (contiguous layer ranges per node, shared stages
deduped across requests for batching), the :class:`ExecutionEngine` runs
each stage's layer range on the card, routing every boundary transfer
through a :mod:`repro_torch.transport` backend, and records wall-clock per
stage and per transfer.  :mod:`repro_torch.exec.calibrate` turns measured
stage timings back into profile updates for a planner re-solve.

``stage_graph`` and ``calibrate`` are copies of the reference's numpy
modules; ``engine`` is the torch rewrite.  ``compile_cache`` (what a warm
start means under torch) comes with a later slice (ROADMAP).
"""

from .calibrate import (CalibrationReport, calibrate_profile, calibrate_rates,
                        calibrated_problem, measured_layer_seconds,
                        reconcile)
from .engine import ExecutionEngine, ExecutionReport, StageTiming, layer_fns_for
from .stage_graph import (StageGraph, StageTask, Transfer, coalesce_graphs,
                          compile_plan, link_payload_bytes, stage_signature)

__all__ = [
    "CalibrationReport", "ExecutionEngine", "ExecutionReport", "StageGraph",
    "StageTask", "StageTiming", "Transfer", "calibrate_profile",
    "calibrate_rates", "calibrated_problem", "coalesce_graphs", "compile_plan",
    "layer_fns_for", "link_payload_bytes", "measured_layer_seconds",
    "reconcile", "stage_signature",
]
