"""Plan → StageGraph compiler.

OULD emits ``assign[r, j] = node``; :func:`~repro_torch.core.placement.to_stages`
groups each admitted request's path into contiguous layer ranges.  The graph
compiled here is the *executable* form of a whole plan:

* one :class:`StageTask` per unique ``(node, layer_start, layer_end)`` —
  requests whose paths share a stage are batched into one kernel launch
  (the dedup that makes hotspot request streams cheap to execute);
* one :class:`Transfer` per request per cut point, priced from
  ``Problem.transfer_cost()`` — the same seconds/byte matrix the OULD
  objective minimized, so predicted and executed latency decompose over
  identical terms.

Tasks are topologically ordered by ``layer_start`` (ties by node id): every
transfer's producer task precedes its consumer, which is all the engine's
tick loop needs.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core.ould import Problem
from ..core.placement import to_stages
from ..core.planner import Plan


@dataclasses.dataclass(frozen=True)
class StageTask:
    """One batched kernel launch: layers [layer_start, layer_end) on ``node``
    for every request in ``requests`` (ascending request rows)."""

    node: int
    layer_start: int   # inclusive
    layer_end: int     # exclusive
    requests: tuple[int, ...]

    @property
    def key(self) -> tuple[int, int, int]:
        return (self.node, self.layer_start, self.layer_end)

    @property
    def n_layers(self) -> int:
        return self.layer_end - self.layer_start


@dataclasses.dataclass(frozen=True)
class Transfer:
    """One boundary activation shipment for one request.

    ``layer`` is the consuming layer index: the output of ``layer - 1``
    (or the source frame when ``layer == 0``) crosses the ``src_node →
    dst_node`` link.  ``delay_s`` is the analytic link delay —
    ``nbytes × spb[src, dst]`` with ``spb = Problem.transfer_cost()``.
    """

    request: int
    src_node: int
    dst_node: int
    layer: int
    nbytes: float
    delay_s: float


@dataclasses.dataclass(frozen=True)
class StageGraph:
    """The executable form of a plan: batched stage tasks in topological
    order plus every request's boundary transfers."""

    tasks: tuple[StageTask, ...]
    transfers: tuple[Transfer, ...]
    n_layers: int
    n_requests: int              # plan rows, including rejected ones
    requests: tuple[int, ...]    # admitted rows actually compiled

    @property
    def n_shared(self) -> int:
        """Stage launches saved by dedup (per-request stages − tasks)."""
        return sum(len(t.requests) for t in self.tasks) - len(self.tasks)

    def request_tasks(self, r: int) -> list[StageTask]:
        return [t for t in self.tasks if r in t.requests]

    def request_transfers(self, r: int) -> list[Transfer]:
        return [tr for tr in self.transfers if tr.request == r]

    def transfer_delay_s(self, r: int) -> float:
        return float(sum(tr.delay_s for tr in self.transfers
                         if tr.request == r))


def compile_plan(plan: Plan, *, problem: Problem | None = None,
                 requests: list[int] | None = None) -> StageGraph:
    """Compile a plan into its stage graph.

    ``problem`` defaults to the plan's bound problem (the instance its
    numbers are valid for); pass an override to re-price transfers against a
    different realized topology (the swarm simulator's per-tick snapshots).
    ``requests`` restricts compilation to a subset of admitted rows.
    """
    prob = problem if problem is not None else plan.problem
    spb = prob.transfer_cost()
    K = prob.profile.output_vector()
    Ks = prob.profile.input_bytes

    rows = [r for r in range(prob.n_requests) if plan.admitted[r]]
    if requests is not None:
        wanted = set(requests)
        rows = [r for r in rows if r in wanted]

    by_key: dict[tuple[int, int, int], list[int]] = {}
    transfers: list[Transfer] = []
    for r in rows:
        src = int(prob.sources[r])
        prev = src
        for st in to_stages(plan.assign[r]):
            by_key.setdefault((st.node, st.layer_start, st.layer_end),
                              []).append(r)
            if st.node != prev:
                nbytes = Ks if st.layer_start == 0 else K[st.layer_start - 1]
                transfers.append(Transfer(
                    r, prev, st.node, st.layer_start, float(nbytes),
                    float(nbytes * spb[prev, st.node])))
            prev = st.node

    tasks = tuple(StageTask(n, s, e, tuple(rs))
                  for (n, s, e), rs in sorted(by_key.items(),
                                              key=lambda kv: (kv[0][1],
                                                              kv[0][0])))
    return StageGraph(tasks, tuple(transfers), prob.n_layers,
                      prob.n_requests, tuple(rows))


def coalesce_graphs(graphs: list[StageGraph] | tuple[StageGraph, ...], *,
                    offsets: list[int] | None = None) -> StageGraph:
    """Batch stage launches *across arrival time*.

    ``compile_plan`` dedups shared stages within ONE plan; a serving runtime
    compiles one plan per admission round, so requests that arrive in
    different rounds but run the same ``(node, layer_start, layer_end)``
    stage still launch separately.  This merges several compiled graphs into
    one: request rows are re-identified by per-graph ``offsets`` (default:
    cumulative ``n_requests``, i.e. the graphs' plan rows stacked in order),
    tasks with equal keys coalesce into one batched launch, and transfers
    carry over with shifted request ids.  Executing the merged graph on the
    stacked frame array is exactly equivalent per request — same layer
    ranges, same link delays — but with fewer kernel launches (pinned by the
    E5 bench and the equivalence test).

    All graphs must share ``n_layers`` (one model).
    """
    if not graphs:
        raise ValueError("coalesce_graphs needs at least one graph")
    n_layers = graphs[0].n_layers
    if any(g.n_layers != n_layers for g in graphs):
        raise ValueError("cannot coalesce graphs of different models: "
                         f"n_layers {[g.n_layers for g in graphs]}")
    if offsets is None:
        offsets = list(np.cumsum([0] + [g.n_requests for g in graphs])[:-1])
    if len(offsets) != len(graphs):
        raise ValueError(f"{len(offsets)} offsets for {len(graphs)} graphs")

    by_key: dict[tuple[int, int, int], list[int]] = {}
    transfers: list[Transfer] = []
    rows: list[int] = []
    for g, off in zip(graphs, offsets):
        off = int(off)
        for t in g.tasks:
            by_key.setdefault(t.key, []).extend(r + off for r in t.requests)
        transfers.extend(dataclasses.replace(tr, request=tr.request + off)
                         for tr in g.transfers)
        rows.extend(r + off for r in g.requests)

    tasks = tuple(StageTask(n, s, e, tuple(sorted(rs)))
                  for (n, s, e), rs in sorted(by_key.items(),
                                              key=lambda kv: (kv[0][1],
                                                              kv[0][0])))
    n_requests = max(int(off) + g.n_requests
                     for g, off in zip(graphs, offsets))
    return StageGraph(tasks, tuple(transfers), n_layers, n_requests,
                      tuple(rows))


def stage_signature(graph: StageGraph) -> tuple[tuple[int, int], ...]:
    """The unique ``(layer_start, layer_end)`` ranges a graph executes —
    the warm-up footprint (one callable per range)."""
    return tuple(sorted({(t.layer_start, t.layer_end) for t in graph.tasks}))


def trace_args(graph: StageGraph) -> dict:
    """Summarize a graph for a rich (dict-args) trace span — the low-rate
    annotation the CLI attaches to its per-round execution span, so a
    Perfetto click on the round shows what actually launched."""
    return {"n_tasks": len(graph.tasks),
            "n_transfers": len(graph.transfers),
            "n_requests": len(graph.requests),
            "n_shared": graph.n_shared,
            "transfer_bytes": float(sum(tr.nbytes for tr in graph.transfers)),
            "signature": [list(rng) for rng in stage_signature(graph)]}


def link_payload_bytes(graph: StageGraph) -> dict[tuple[int, int], float]:
    """Total modeled bytes each directed link carries for this graph — the
    coverage map of a comm calibration: links listed here are the ones a
    byte-moving transport will sample when the graph executes."""
    out: dict[tuple[int, int], float] = {}
    for tr in graph.transfers:
        key = (tr.src_node, tr.dst_node)
        out[key] = out.get(key, 0.0) + tr.nbytes
    return out
