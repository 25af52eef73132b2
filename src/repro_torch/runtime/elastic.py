"""Elastic scaling + degradation-aware re-placement (port of
``repro.runtime.elastic``; numpy over the port's copy of ``core``, whose
ILP is host code).

The paper's OULD-MP exists because the *topology changes under the
computation* (UAVs move, links fade, nodes drop).  The TPU analogue: chips
fail, pods get preempted, stragglers appear.  This module maps those events
onto the same machinery:

* ``plan_elastic_mesh`` — given the surviving device count, pick the largest
  valid (data, model) mesh and the re-shard plan (restore checkpoints with
  new shardings — CheckpointManager.restore does the placement).
* ``replan_placement`` — re-solve OULD with degraded capacities: a straggler
  node gets its compute capacity scaled by its observed slowdown, a failed
  node gets capacity 0, links inherit measured bandwidths.  This IS the
  paper's technique (Problem/solve_ould) driving the serving runtime's stage
  re-placement — one code path for UAVs and pods.
* ``predictive_replan`` — OULD-MP over a *forecast* of capacities (e.g. a
  node with rising ECC errors degrades over the horizon), yielding one
  placement valid across the predicted window instead of re-solving per
  event (Fig. 13/14 semantics on the pod).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core import Problem, solve_ould
from ..core.placement import Stage, to_stages
from ..core.profiles import ModelProfile
from ..core.radio import TpuLinkModel


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    data: int
    model: int

    @property
    def devices(self) -> int:
        return self.data * self.model


def plan_elastic_mesh(n_devices: int, *, model_parallel: int = 16,
                      min_data: int = 1) -> ElasticPlan:
    """Largest (data, model) grid on the survivors, keeping TP intact when
    possible (params reshard is cheap across data, expensive across model)."""
    m = model_parallel
    while m > 1 and n_devices // m < min_data:
        m //= 2
    d = n_devices // m
    if d < 1:
        raise ValueError(f"no valid mesh for {n_devices} devices")
    return ElasticPlan(data=d, model=m)


def replan_placement(profile: ModelProfile, *, n_groups: int,
                     hbm_bytes: float, flops_budget: float,
                     slowdown: np.ndarray | None = None,
                     failed: np.ndarray | None = None,
                     link: TpuLinkModel | None = None,
                     solver: str = "ilp") -> list[Stage]:
    """One-shot OULD re-solve with degraded capacities (straggler/failure)."""
    link = link or TpuLinkModel()
    comp = np.full(n_groups, flops_budget, float)
    mem = np.full(n_groups, hbm_bytes, float)
    if slowdown is not None:
        comp = comp / np.maximum(slowdown, 1.0)
    if failed is not None:
        comp[failed] = 0.0
        mem[failed] = 0.0
    coords = np.stack([np.arange(n_groups) % link.torus[0],
                       np.arange(n_groups) // link.torus[0]], -1)
    rho = link.rate_matrix(coords, np.zeros(n_groups, np.int64))
    prob = Problem(profile, mem, comp, rho * 8.0, np.zeros(1, np.int64))
    sol = solve_ould(prob, solver=solver)  # type: ignore[arg-type]
    if not sol.admitted[0]:
        raise ValueError("no feasible placement on surviving capacity")
    return to_stages(sol.assign[0])


def predictive_replan(profile: ModelProfile, *, n_groups: int,
                      hbm_bytes: float, flops_budget: float,
                      predicted_slowdown: np.ndarray,
                      link: TpuLinkModel | None = None,
                      solver: str = "ilp") -> list[Stage]:
    """OULD-MP on the pod: ``predicted_slowdown`` is (T, N) — e.g. a failing
    node's forecast degradation.  Rates are modulated per-step so the chosen
    placement avoids nodes that are *about to* degrade (the paper's
    disconnection-avoidance argument, Fig. 13)."""
    link = link or TpuLinkModel()
    T, N = predicted_slowdown.shape
    assert N == n_groups
    coords = np.stack([np.arange(n_groups) % link.torus[0],
                       np.arange(n_groups) // link.torus[0]], -1)
    base = link.rate_matrix(coords, np.zeros(n_groups, np.int64))
    rates = np.zeros((T, N, N))
    for t in range(T):
        # a slowed node drains its links' effective bandwidth too
        f = 1.0 / np.maximum(predicted_slowdown[t], 1.0)
        rates[t] = base * np.minimum(f[:, None], f[None, :])
    comp = np.full(n_groups, flops_budget) / np.maximum(
        predicted_slowdown.max(axis=0), 1.0)
    prob = Problem(profile, np.full(n_groups, hbm_bytes), comp, rates * 8.0,
                   np.zeros(1, np.int64))
    sol = solve_ould(prob, solver=solver)  # type: ignore[arg-type]
    if not sol.admitted[0]:
        raise ValueError("no feasible predictive placement")
    return to_stages(sol.assign[0])
