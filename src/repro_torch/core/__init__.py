"""The placement path's solvers and system model (port of ``repro.core``):
latency-optimal layer placement (OULD) over heterogeneous-bandwidth node
topologies, the per-layer profiles, radio link model and RPG mobility, and
the heuristic baselines.

Copies of the reference's numpy/scipy modules, kept in step with them by
``tests/test_torch_core.py``.  ``batch_dp`` is the one rewrite: its sweep
runs as a hand-written CUDA kernel on the card (``kernels/dp_sweep.py``),
and the solvers take a ``device`` for it.  Not yet ported: ``events`` and
``ould_mp`` (the swarm runtime's slice).
"""

from . import batch_dp
from .heuristics import solve_heuristic
from .latency import Evaluation, evaluate
from .mobility import MultiGroupMobility, RPGMobility, RPGParams
from .ould import (IncrementalSolver, Problem, ResolveStats, Solution,
                   default_sparse_k, improvement_bound,
                   incremental_transfer_cost, placement_drift, solve_ould,
                   transfer_cost)
from .placement import (Stage, balanced_stages, ould_pipeline_stages,
                        stage_boundaries, to_stages)
from .planner import (HorizonView, IncrementalPlanner, NoisyHorizonView,
                      Plan, Planner, SnapshotView, StaleView, TopologyView,
                      available_planners, get_planner, make_view,
                      register_planner)
from .profiles import (LayerProfile, ModelProfile, lenet_profile, lm_profile,
                       vgg16_profile)
from .radio import RadioParams, TpuLinkModel, rate_matrix, sinr_matrix

__all__ = [
    "Evaluation", "HorizonView", "IncrementalPlanner", "IncrementalSolver",
    "LayerProfile", "ModelProfile", "MultiGroupMobility", "NoisyHorizonView",
    "Plan", "Planner", "Problem", "RPGMobility", "RPGParams", "RadioParams",
    "ResolveStats", "SnapshotView", "Solution", "Stage", "StaleView",
    "TopologyView", "TpuLinkModel", "available_planners", "balanced_stages",
    "batch_dp", "default_sparse_k", "evaluate", "get_planner",
    "improvement_bound", "incremental_transfer_cost", "lenet_profile",
    "lm_profile", "make_view", "ould_pipeline_stages", "placement_drift",
    "rate_matrix", "register_planner", "sinr_matrix", "solve_heuristic",
    "solve_ould", "stage_boundaries", "to_stages", "transfer_cost",
    "vgg16_profile",
]
