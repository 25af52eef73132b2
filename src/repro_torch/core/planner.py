"""Unified placement-strategy API: ``Planner`` / ``TopologyView`` / ``Plan``.

The paper's evaluation is a bake-off between placement strategies (OULD ILP,
OULD DP, OULD-MP, three heuristics, and the warm-started incremental solver),
but each grew its own call signature.  This module is the single seam every
consumer goes through instead:

* :class:`TopologyView` — what the strategy is allowed to know about the
  network.  A :class:`SnapshotView` carries one ``(N, N)`` rate matrix (the
  information a real swarm estimates from its current links); a
  :class:`HorizonView` carries the predicted ``(T, N, N)`` sequence the
  OULD-MP objective (Eq. 14) sums over.  Both carry the optional ``alive``
  mask — a dead node's capacity and links are zeroed uniformly here instead
  of ad hoc at every call site.
* :class:`Planner` — the protocol: ``plan(problem, view) -> Plan``.  A
  planner declares the view kinds it supports (single-snapshot heuristics
  reject horizon views instead of silently using ``rates[0]``).  Planners may
  be stateful: the ``incremental`` planner caches placements and constraint
  structure across successive ``plan()`` calls.
* :class:`Plan` — a :class:`~repro_torch.core.ould.Solution` plus provenance
  (``planner_name``, ``solve_stats``, ``warm``) and the bound problem it was
  solved against, bridging directly into :func:`~repro_torch.core.placement.
  to_stages` and :func:`~repro_torch.core.latency.evaluate`.
* A string-keyed registry — ``get_planner("ould-ilp" | "ould-dp" |
  "ould-dp-sparse" | "ould-mp" | "nearest" | "hrm" | "nearest-hrm" |
  "incremental" | "incremental-sparse")`` — so runtimes and benchmarks
  iterate strategies by name and a new strategy (reliability-aware LLHR, a
  DRL policy) is a one-file plug-in: ``@register_planner("my-strategy")``
  and every consumer can run it.

``ould-dp-sparse`` / ``incremental-sparse`` pin the k-candidate pruned DP
engine (sub-quadratic in swarm size; admission-identical to the dense DP
via its fallback ladder) — the N ≥ 50 serving regime; ``sparse_k``
overrides the √N default candidate budget.

Planner constructors accept a *uniform* option set and ignore options they
do not consume (``HeuristicPlanner`` ignores ``solver=``), so registry-driven
callers can build every strategy from one option dict.

The port's copy of ``repro/core/planner.py``, with one added option:
``device`` (default ``"cuda"``) says where a ``batch_solve=True`` solve runs
its sweep; the OULD planners pass it to ``solve_ould`` / the
``IncrementalSolver``, and it is read only when ``batch_solve`` is set.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Protocol, runtime_checkable

import numpy as np

from .heuristics import solve_heuristic
from .latency import Evaluation, evaluate
from .ould import (IncrementalSolver, Problem, ResolveStats, Solution,
                   solve_ould)
from .placement import Stage, to_stages

SNAPSHOT = "snapshot"
HORIZON = "horizon"


# ---------------------------------------------------------------------------
# TopologyView — what a strategy may know about the network
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TopologyView:
    """A view of the link topology handed to a planner.

    ``rates`` is in bits/s (the :class:`Problem` convention).  ``alive`` marks
    per-node liveness: ``bind`` zeroes a dead node's capacities *and* every
    incident link (ρ = 0 ⇔ disconnected), which is the single place that
    masking rule lives now.
    """

    rates: np.ndarray                  # (N, N) or (T, N, N)
    alive: np.ndarray | None = None    # (N,) bool, None ⇒ all alive

    kind = "abstract"

    @property
    def n_nodes(self) -> int:
        return int(self.rates.shape[-1])

    @property
    def horizon(self) -> int:
        return 1 if self.rates.ndim == 2 else int(self.rates.shape[0])

    def effective_rates(self) -> np.ndarray:
        """Rates with dead nodes' links zeroed (a copy iff masking applies)."""
        alive = self.alive
        if alive is None or bool(np.all(alive)):
            return self.rates
        out = self.rates.copy()
        if out.ndim == 3:
            out[:, ~alive, :] = 0.0
            out[:, :, ~alive] = 0.0
        else:
            out[~alive, :] = 0.0
            out[:, ~alive] = 0.0
        return out

    def bind(self, problem: Problem) -> Problem:
        """The problem actually solved: this view's rates substituted in and
        dead nodes' capacities zeroed."""
        mem, comp = problem.mem_cap, problem.comp_cap
        if self.alive is not None and not bool(np.all(self.alive)):
            mem = np.where(self.alive, mem, 0.0)
            comp = np.where(self.alive, comp, 0.0)
        # replace(), not a positional rebuild: provenance fields
        # (comm_source) must survive the bind into Plan.problem.
        return dataclasses.replace(problem, mem_cap=mem, comp_cap=comp,
                                   rates=self.effective_rates())


@dataclasses.dataclass(frozen=True)
class SnapshotView(TopologyView):
    """One ``(N, N)`` rate matrix — a fixed-time-step network configuration
    (the only information the paper's heuristics are designed for)."""

    kind = SNAPSHOT

    def __post_init__(self):
        if self.rates.ndim != 2:
            raise ValueError(
                f"SnapshotView needs (N, N) rates, got {self.rates.shape}")


@dataclasses.dataclass(frozen=True)
class HorizonView(TopologyView):
    """A predicted ``(T, N, N)`` rate sequence — the OULD-MP horizon whose
    per-step seconds/byte the Eq. 14 objective sums."""

    kind = HORIZON

    def __post_init__(self):
        if self.rates.ndim != 3:
            raise ValueError(
                f"HorizonView needs (T, N, N) rates, got {self.rates.shape}")

    def snapshot(self, t: int = 0) -> SnapshotView:
        """The single-step view at predicted step ``t``."""
        return SnapshotView(self.rates[t], self.alive)


def make_view(rates: np.ndarray,
              alive: np.ndarray | None = None) -> TopologyView:
    """Snapshot or horizon view inferred from the rate array's rank."""
    cls = SnapshotView if rates.ndim == 2 else HorizonView
    return cls(rates, alive)


# ---------------------------------------------------------------------------
# Degraded views — the prediction-quality axis (ROADMAP)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StaleView(SnapshotView):
    """A snapshot the planner *believes* is current but was captured
    ``age_ticks`` earlier.  ``kind`` stays ``"snapshot"`` — staleness is
    invisible to the strategy, which is the point: serving happens on the
    realized topology, so the gap between the two prices the value of fresh
    link estimates.  The caller supplies the old rate matrix (it owns the
    history); ``age_ticks`` is provenance."""

    age_ticks: int = 0


@dataclasses.dataclass(frozen=True)
class NoisyHorizonView(HorizonView):
    """A predicted horizon whose rates carry multiplicative lognormal error
    — imperfect mobility prediction.  ``noise_std`` is the σ of the
    mean-preserving perturbation ``exp(N(−σ²/2, σ))`` applied per entry;
    the planner sees only the corrupted rates (``kind`` stays
    ``"horizon"``)."""

    noise_std: float = 0.0

    @classmethod
    def corrupt(cls, view: HorizonView, noise_std: float,
                seed: int = 0) -> "NoisyHorizonView":
        """Corrupt ``view``'s predicted rates (deterministic per seed).
        Disconnected pairs (ρ = 0) stay disconnected — noise degrades rate
        estimates, it does not invent links."""
        if noise_std <= 0.0:
            return cls(view.rates, view.alive, noise_std=0.0)
        rng = np.random.default_rng(seed)
        noise = np.exp(rng.normal(-0.5 * noise_std ** 2, noise_std,
                                  view.rates.shape))
        return cls(view.rates * noise, view.alive, noise_std=noise_std)


# ---------------------------------------------------------------------------
# Plan — a Solution with provenance
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Plan:
    """What a planner returns: the solution, who produced it, and against
    what.  ``problem`` is the *bound* problem (view applied) the numbers are
    valid for — :meth:`evaluate` and :meth:`stages` need no other context."""

    solution: Solution
    planner_name: str
    view_kind: str
    problem: Problem
    solve_stats: ResolveStats | None = None
    warm: bool = False

    # -- Solution contract pass-throughs -----------------------------------
    @property
    def assign(self) -> np.ndarray:
        return self.solution.assign

    @property
    def admitted(self) -> np.ndarray:
        return self.solution.admitted

    @property
    def objective(self) -> float:
        return self.solution.objective

    @property
    def status(self) -> str:
        return self.solution.status

    @property
    def n_admitted(self) -> int:
        return self.solution.n_admitted

    @property
    def solve_time_s(self) -> float:
        return self.solution.solve_time_s

    # -- bridges ------------------------------------------------------------
    def stages(self, r: int = 0) -> list[Stage]:
        """Pipeline stages of request ``r`` (rejects the ``-1`` sentinel)."""
        if not self.solution.admitted[r]:
            raise ValueError(f"request {r} was rejected; it has no stages")
        return to_stages(self.solution.assign[r])

    def evaluate(self) -> Evaluation:
        """Paper metrics of this plan on the problem it was solved against."""
        return evaluate(self.problem, self.solution)

    def evaluate_per_step(self,
                          rates: np.ndarray | None = None) -> list[Evaluation]:
        """The held placement judged against each step's realized snapshot
        (paper Fig. 9–13): by default the bound problem's own horizon, or an
        explicit ``(T, N, N)`` sequence (e.g. to play an offline-fixed
        snapshot plan forward while the swarm moves)."""
        r = self.problem.rates if rates is None else rates
        r3 = r[None] if r.ndim == 2 else r
        return [evaluate(dataclasses.replace(self.problem, rates=r3[t]),
                         self.solution) for t in range(r3.shape[0])]


# ---------------------------------------------------------------------------
# Planner protocol + implementations
# ---------------------------------------------------------------------------

@runtime_checkable
class Planner(Protocol):
    """A placement strategy.  ``view_kinds`` lists the view kinds accepted,
    most-preferred first (``preferred_view`` is what capability-driven
    callers build when they could offer either)."""

    name: str
    view_kinds: tuple[str, ...]

    def plan(self, problem: Problem, view: TopologyView, *,
             request_ids=None) -> Plan:
        """Place ``problem``'s requests using what ``view`` reveals.

        ``request_ids`` carries stable stream identity for stateful planners
        (placement inheritance across calls); stateless planners ignore it.
        """
        ...


class _PlannerBase:
    name: str = "?"
    view_kinds: tuple[str, ...] = (SNAPSHOT,)

    @property
    def preferred_view(self) -> str:
        return self.view_kinds[0]

    def _require_view(self, view: TopologyView) -> None:
        if view.kind not in self.view_kinds:
            raise ValueError(
                f"planner {self.name!r} supports {self.view_kinds} views, "
                f"got {view.kind!r}")


class OuldPlanner(_PlannerBase):
    """Cold OULD solve per call (paper §III-B): the exact ILP or the greedy
    sequential DP.  Registered as ``ould-ilp`` / ``ould-dp`` (snapshot) and,
    over a predicted horizon, as ``ould-mp`` (Eq. 14: one placement optimal
    over t ∈ {1..T}).  The ILP constraint structure is cached across calls on
    same-shaped instances."""

    def __init__(self, solver: str = "ilp", *, name: str | None = None,
                 view_kinds: tuple[str, ...] = (SNAPSHOT,),
                 include_compute: bool = False, tight: bool = True,
                 gamma_relaxed: bool = True, time_limit: float | None = None,
                 mip_rel_gap: float = 1e-6,
                 max_path_cost: float | None = None,
                 sparse_k: int | None = None, batch_solve: bool = False,
                 capacity_repair: str = "halve", device="cuda",
                 **_ignored: Any):
        self.name = name or f"ould-{solver}"
        self.view_kinds = view_kinds
        self.solver = solver
        self._kw = dict(include_compute=include_compute, tight=tight,
                        gamma_relaxed=gamma_relaxed, time_limit=time_limit,
                        mip_rel_gap=mip_rel_gap, max_path_cost=max_path_cost,
                        sparse_k=sparse_k, batch_solve=batch_solve,
                        capacity_repair=capacity_repair, device=device)
        self._constraint_cache: dict = {}

    def plan(self, problem: Problem, view: TopologyView, *,
             request_ids=None) -> Plan:
        self._require_view(view)
        bound = view.bind(problem)
        sol = solve_ould(bound, solver=self.solver,  # type: ignore[arg-type]
                         constraint_cache=self._constraint_cache, **self._kw)
        return Plan(sol, self.name, view.kind, bound,
                    solve_stats=sol.dp_stats)


class HeuristicPlanner(_PlannerBase):
    """The paper's greedy hand-off baselines (§IV-A).  Snapshot-only by
    construction — 'designed for a single network configuration obtained from
    a fixed time step' — so a horizon view is an error, not a truncation."""

    view_kinds = (SNAPSHOT,)

    def __init__(self, kind: str, *, name: str | None = None,
                 **_ignored: Any):
        self.kind = kind
        self.name = name or kind.replace("_", "-")

    def plan(self, problem: Problem, view: TopologyView, *,
             request_ids=None) -> Plan:
        self._require_view(view)
        bound = view.bind(problem)
        sol = solve_heuristic(bound, self.kind)  # type: ignore[arg-type]
        return Plan(sol, self.name, view.kind, bound)


class IncrementalPlanner(_PlannerBase):
    """Stateful warm-started planner wrapping :class:`IncrementalSolver`.

    Successive ``plan()`` calls on the same instance keep placements of
    requests untouched by topology drift, reuse the cached ILP constraint
    structure, and re-price only changed rows of the transfer-cost matrix.
    Request identity across calls comes from ``problem.sources`` row order by
    default; callers tracking stable stream ids pass ``request_ids``.

    The underlying solver is built lazily from the first problem's profile
    and capacities; a later problem with different capacities or profile
    resets the warm state (a new pool is a new planner, effectively).
    """

    view_kinds = (SNAPSHOT, HORIZON)

    def __init__(self, solver: str = "dp", *, name: str = "incremental",
                 view_kinds: tuple[str, ...] | None = None, warm: bool = True,
                 rel_change: float = 0.05, price_rel_change: float = 0.0,
                 max_path_cost: float | None = None,
                 include_compute: bool = False,
                 sparse_k: int | None = None, batch_solve: bool = False,
                 capacity_repair: str = "halve", device="cuda",
                 **_ignored: Any):
        self.name = name
        if view_kinds is not None:
            self.view_kinds = view_kinds
        self.solver = solver
        self.warm = warm
        self.rel_change = rel_change
        self.price_rel_change = price_rel_change
        self.max_path_cost = max_path_cost
        self.include_compute = include_compute
        self.sparse_k = sparse_k
        self.batch_solve = batch_solve
        self.capacity_repair = capacity_repair
        self.device = device
        self._inc: IncrementalSolver | None = None
        self._pool_key: tuple | None = None

    def _solver_for(self, problem: Problem) -> IncrementalSolver:
        key = (problem.profile, problem.mem_cap.tobytes(),
               problem.comp_cap.tobytes(),
               None if problem.compute_speed is None
               else problem.compute_speed.tobytes())
        if self._inc is None or key != self._pool_key:
            self._inc = IncrementalSolver(
                problem.profile, problem.mem_cap, problem.comp_cap,
                problem.compute_speed, solver=self.solver,  # type: ignore[arg-type]
                include_compute=self.include_compute,
                rel_change=self.rel_change,
                price_rel_change=self.price_rel_change,
                max_path_cost=self.max_path_cost,
                rate_unit_bytes=problem.rate_unit_bytes,
                sparse_k=self.sparse_k, batch_solve=self.batch_solve,
                capacity_repair=self.capacity_repair, device=self.device)
            self._pool_key = key
        return self._inc

    def plan(self, problem: Problem, view: TopologyView, *,
             request_ids=None, cold: bool = False) -> Plan:
        self._require_view(view)
        inc = self._solver_for(problem)
        # IncrementalSolver applies the alive mask itself (capacities AND
        # links) — hand it the raw view so its drift detection sees flips.
        step = inc.resolve if (self.warm and not cold) else inc.solve
        sol, stats = step(view.rates, problem.sources, request_ids,
                          view.alive)
        return Plan(sol, self.name, view.kind, view.bind(problem),
                    solve_stats=stats, warm=not stats.cold)

    def reset(self) -> None:
        """Drop all warm state (placements, caches, references)."""
        self._inc = None
        self._pool_key = None


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, Callable[..., Planner]] = {}


def register_planner(name: str,
                     factory: Callable[..., Planner] | None = None):
    """Register a planner factory under ``name``; usable as a decorator:

        @register_planner("my-strategy")
        class MyPlanner: ...
    """
    def _register(f: Callable[..., Planner]) -> Callable[..., Planner]:
        _REGISTRY[name] = f
        return f
    return _register(factory) if factory is not None else _register


def available_planners() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def get_planner(name: str, **options: Any) -> Planner:
    """Instantiate the registered strategy ``name``.

    Every call returns a *fresh* instance (stateful planners keep their warm
    caches per instance, not globally).  Unknown option keys are ignored by
    the planner that does not consume them, so one option dict can configure
    a whole registry sweep.
    """
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown planner {name!r}; "
                       f"available: {available_planners()}") from None
    return factory(**options)


def _fixed_solver(solver: str, name: str):
    """Factory for a fixed-engine OULD planner: a caller-supplied ``solver``
    option (from a uniform registry-sweep option dict) is ignored — the
    registry name pins the engine."""
    def factory(**o: Any) -> Planner:
        o.pop("solver", None)
        return OuldPlanner(solver, name=name, **o)
    return factory


register_planner("ould-ilp", _fixed_solver("ilp", "ould-ilp"))
register_planner("ould-dp", _fixed_solver("dp", "ould-dp"))
register_planner("ould-dp-sparse", _fixed_solver("dp-sparse", "ould-dp-sparse"))
register_planner("nearest", lambda **o: HeuristicPlanner("nearest", **o))
register_planner("hrm", lambda **o: HeuristicPlanner("hrm", **o))
register_planner(
    "nearest-hrm",
    lambda **o: HeuristicPlanner("nearest_hrm", name="nearest-hrm", **o))
register_planner(
    "incremental",
    lambda **o: IncrementalPlanner(**{"solver": "dp", **o}))


@register_planner("incremental-sparse")
def _incremental_sparse_factory(**o: Any) -> Planner:
    """Warm-started planner over the pruned k-candidate DP: the registry
    name pins the engine (a caller-supplied ``solver`` option from a uniform
    registry-sweep dict is ignored)."""
    o.pop("solver", None)
    return IncrementalPlanner("dp-sparse", name="incremental-sparse", **o)


@register_planner("ould-mp")
def _ould_mp_factory(*, warm: bool = False, solver: str | None = None,
                     **o: Any) -> Planner:
    """OULD-MP: the horizon-objective strategy (Eq. 14).  Cold by default —
    the paper's one-shot placement; ``warm=True`` yields the serving-loop
    variant that warm-starts successive horizon re-solves."""
    if warm:
        return IncrementalPlanner(solver or "dp", name="ould-mp",
                                  view_kinds=(HORIZON,), **o)
    return OuldPlanner(solver or "ilp", name="ould-mp",
                       view_kinds=(HORIZON,), **o)
