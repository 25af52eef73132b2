"""Plan-faithful distributed execution (port of ``repro.exec``).

The optimizer stack (``core/``) *prices* a placement analytically; this
package *runs* it.  Any :class:`~repro_torch.core.planner.Plan` compiles into
a :class:`StageGraph` (contiguous layer ranges per node, shared stages
deduped across requests for batching), the :class:`ExecutionEngine` runs
each stage's layer range on the card, routing every boundary transfer
through a :mod:`repro_torch.transport` backend, and records wall-clock per
stage and per transfer.  :mod:`repro_torch.exec.calibrate` closes both
loops: measured stage timings update the profile's compute vector, and a
byte-moving transport's realized per-link bandwidth updates the rates
(``calibrate_rates``), so every registered planner re-solves against
realized numbers on both axes.  :mod:`repro_torch.exec.compile_cache` is
the warm-start layer: the kernels' nvcc build directory, which a later
process or a rejoining node loads from instead of compiling.

``stage_graph`` and ``calibrate`` are copies of the reference's numpy
modules; ``engine`` and ``compile_cache`` are torch rewrites.
"""

from . import compile_cache
from .calibrate import (CalibrationReport, calibrate_profile, calibrate_rates,
                        calibrated_problem, measured_layer_seconds,
                        reconcile)
from .compile_cache import WarmStartReport, measure_warm_start
from .engine import ExecutionEngine, ExecutionReport, StageTiming, layer_fns_for
from .stage_graph import (StageGraph, StageTask, Transfer, coalesce_graphs,
                          compile_plan, link_payload_bytes, stage_signature)

__all__ = [
    "CalibrationReport", "ExecutionEngine", "ExecutionReport", "StageGraph",
    "StageTask", "StageTiming", "Transfer", "WarmStartReport",
    "calibrate_profile", "calibrate_rates", "calibrated_problem",
    "coalesce_graphs", "compile_cache", "compile_plan", "layer_fns_for",
    "link_payload_bytes", "measure_warm_start", "measured_layer_seconds",
    "reconcile", "stage_signature",
]
