"""Placement → execution bridge.

OULD emits ``assign[r, j] = node``.  For a sequential model that path visits
a sequence of nodes; grouping consecutive layers hosted on the same node
yields *pipeline stages* — the unit the JAX runtime executes (shard_map
pipeline in ``parallel/pipeline.py``) and the unit the TPU placement uses
when OULD runs over an ICI/DCN topology (DESIGN.md §2).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .ould import Problem, solve_ould
from .profiles import ModelProfile
from .radio import TpuLinkModel


@dataclasses.dataclass(frozen=True)
class Stage:
    node: int
    layer_start: int  # inclusive
    layer_end: int    # exclusive


def to_stages(path: np.ndarray) -> list[Stage]:
    """Group a per-layer node path into contiguous stages."""
    stages: list[Stage] = []
    start = 0
    for j in range(1, len(path) + 1):
        if j == len(path) or path[j] != path[start]:
            stages.append(Stage(int(path[start]), start, j))
            start = j
    return stages


def stage_boundaries(path: np.ndarray) -> list[int]:
    """Layer indices where the activation crosses a link (cut points)."""
    return [j + 1 for j in range(len(path) - 1) if path[j + 1] != path[j]]


def balanced_stages(profile: ModelProfile, n_stages: int) -> list[Stage]:
    """FLOPs-balanced contiguous split — the *static* baseline the paper's
    related work uses ([32]-style offline partitioning); also the PP default
    when OULD is disabled."""
    flops = np.array(profile.compute_vector())
    stages: list[Stage] = []
    start, acc, node = 0, 0.0, 0
    remaining = float(flops.sum())
    for j, f in enumerate(flops):
        acc += f
        remaining_layers = len(flops) - (j + 1)
        remaining_stages = n_stages - (node + 1)
        target = (remaining) / (n_stages - node)  # adaptive re-balance
        nxt = flops[j + 1] if j + 1 < len(flops) else 0.0
        close = (remaining_stages > 0
                 and (acc + nxt / 2 >= target or remaining_layers <= remaining_stages))
        if close:
            stages.append(Stage(node, start, j + 1))
            remaining -= acc
            start, acc, node = j + 1, 0.0, node + 1
            if node == n_stages - 1:
                break
    stages.append(Stage(node, start, len(flops)))
    return [s for s in stages if s.layer_end > s.layer_start]


def ould_pipeline_stages(profile: ModelProfile, *, n_groups: int,
                         hbm_bytes_per_group: float,
                         flops_cap_per_group: float,
                         link: TpuLinkModel | None = None,
                         solver: str = "ilp") -> list[Stage]:
    """Run OULD on a TPU topology to derive pipeline stage placement.

    Each 'node' is a chip-group laid out along one torus row; the rate matrix
    comes from :class:`TpuLinkModel`.  This is the paper's technique applied
    as the framework's PP auto-placement (first-class feature).
    """
    link = link or TpuLinkModel()
    coords = np.stack([np.arange(n_groups) % link.torus[0],
                       np.arange(n_groups) // link.torus[0]], -1)
    pods = np.zeros(n_groups, np.int64)
    rho_bytes = link.rate_matrix(coords, pods)           # bytes/s
    prob = Problem(
        profile=profile,
        mem_cap=np.full(n_groups, hbm_bytes_per_group),
        comp_cap=np.full(n_groups, flops_cap_per_group),
        rates=rho_bytes * 8.0,                            # Problem wants bits/s
        sources=np.zeros(1, np.int64),
    )
    sol = solve_ould(prob, solver=solver)  # type: ignore[arg-type]
    if not sol.admitted[0]:
        raise ValueError(
            "OULD found no feasible pipeline placement: "
            f"{profile.name} needs more than {n_groups} groups × "
            f"{hbm_bytes_per_group:.2e} B")
    return to_stages(sol.assign[0])
