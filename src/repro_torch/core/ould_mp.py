"""OULD-MP — one-shot placement over a predicted mobility horizon (§III-C).

Thin convenience layer: builds the (T, N, N) predicted rate tensor from the
RPG mobility model and hands it to :func:`solve_ould` (the time-expanded
objective of Eq. 14 lives in ``Problem.transfer_cost``, which sums seconds/
byte over the horizon; disconnections at any predicted step price the pair
out, so the chosen placement never relies on a link about to vanish).

Also provides the *static re-solve* baseline the paper compares against
(OULD executed at every time step, Fig. 13/14) and the offline-fixed
baseline of [32] (solve once at t=0 then hold the placement).

.. deprecated::
    These mobility-model convenience wrappers are legacy shims kept for one
    release.  New code should use the planner registry —
    ``get_planner("ould-mp").plan(problem, HorizonView(predicted_rates))``
    — which needs no bespoke ``rate_fn``/mobility signature (see
    :mod:`repro_torch.core.planner` and DESIGN.md).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from .latency import Evaluation, evaluate
from .mobility import RPGMobility
from .ould import Problem, Solution, solve_ould
from .profiles import ModelProfile
from .radio import RadioParams


@dataclasses.dataclass
class MPResult:
    solution: Solution
    per_step: list[Evaluation]      # placement evaluated at each realized step
    runtime_s: float


def _step_problem(base: Problem, rates_t: np.ndarray) -> Problem:
    return Problem(base.profile, base.mem_cap, base.comp_cap, rates_t,
                   base.sources, base.compute_speed, base.rate_unit_bytes)


def solve_ould_mp(profile: ModelProfile, mem_cap: np.ndarray,
                  comp_cap: np.ndarray, sources: np.ndarray,
                  mobility: RPGMobility, horizon: int,
                  radio: RadioParams | None = None,
                  compute_speed: np.ndarray | None = None,
                  solver: str = "ilp", **kw) -> MPResult:
    """One-shot OULD-MP: a single placement optimal over t ∈ {1..T}."""
    t0 = time.perf_counter()
    rates = mobility.predicted_rates(horizon, radio)      # (T, N, N)
    prob = Problem(profile, mem_cap, comp_cap, rates, sources, compute_speed)
    sol = solve_ould(prob, solver=solver, **kw)  # type: ignore[arg-type]
    per_step = [evaluate(_step_problem(prob, rates[t]), sol)
                for t in range(horizon)]
    return MPResult(sol, per_step, time.perf_counter() - t0)


def solve_static_resolve(profile: ModelProfile, mem_cap: np.ndarray,
                         comp_cap: np.ndarray, sources: np.ndarray,
                         mobility: RPGMobility, horizon: int,
                         radio: RadioParams | None = None,
                         compute_speed: np.ndarray | None = None,
                         solver: str = "ilp", **kw) -> MPResult:
    """Baseline: re-run OULD at every time step (§III-C complexity argument —
    runtime ≈ T × single solve; Fig. 14)."""
    t0 = time.perf_counter()
    rates = mobility.predicted_rates(horizon, radio)
    per_step: list[Evaluation] = []
    last: Solution | None = None
    for t in range(horizon):
        prob_t = Problem(profile, mem_cap, comp_cap, rates[t], sources,
                         compute_speed)
        last = solve_ould(prob_t, solver=solver, **kw)  # type: ignore[arg-type]
        per_step.append(evaluate(prob_t, last))
    assert last is not None
    return MPResult(last, per_step, time.perf_counter() - t0)


def solve_offline_fixed(profile: ModelProfile, mem_cap: np.ndarray,
                        comp_cap: np.ndarray, sources: np.ndarray,
                        mobility: RPGMobility, horizon: int,
                        radio: RadioParams | None = None,
                        compute_speed: np.ndarray | None = None,
                        solver: str = "ilp", **kw) -> MPResult:
    """Baseline of [32] (Fig. 13): optimize once on the t=0 snapshot, then
    hold that placement while the swarm moves — requests served over links
    that may degrade to disconnection (evaluation returns inf latency then)."""
    t0 = time.perf_counter()
    rates = mobility.predicted_rates(horizon, radio)
    prob0 = Problem(profile, mem_cap, comp_cap, rates[0], sources,
                    compute_speed)
    sol = solve_ould(prob0, solver=solver, **kw)  # type: ignore[arg-type]
    per_step = [evaluate(_step_problem(prob0, rates[t]), sol)
                for t in range(horizon)]
    return MPResult(sol, per_step, time.perf_counter() - t0)
