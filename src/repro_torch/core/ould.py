"""OULD — Optimal UAV-based Layer Distribution (paper §III-B, Eq. 3–13)
and OULD-MP — with mobility prediction (paper §III-C, Eq. 14–15).

The port's copy of ``repro/core/ould.py``.  It differs in one place: the
batched fast path (``batch_solve=True``) sweeps through the port's
:mod:`repro_torch.core.batch_dp` on ``device`` (the card by default), which
``solve_ould``, ``_solve_dp`` and :class:`IncrementalSolver` pass down.  The
dense DP, the fallback ladder and the ILP stay on the host.

Decision variables
------------------
``α_{r,i,j} ∈ {0,1}``  — node i executes layer j of request r (Eq. 2).
``γ_{r,i,k,j} ∈ {0,1}`` — node i runs layer j of r AND node k runs layer j+1
(Eq. 9/10), introduced to linearize the bilinear objective via the big-M
rules (Eq. 11):

    γ ≤ α_{r,i,j},   γ ≤ α_{r,k,j+1},   γ ≥ α_{r,i,j} + α_{r,k,j+1} − 1.

Objective (Eq. 12 + 13):  min Σ_r Σ_{i≠k} Σ_{j<M} γ_{r,i,k,j}·K_j/ρ_{i,k} + t_s
with t_s the source-image transfer.  Because Σ_i α_{r,i,1} = 1 (Eq. 6), the
source term is *already linear*: t_s = Σ_{k≠src(r)} α_{r,k,1}·K_s/ρ_{src,k}.

Constraints: per-node memory (Eq. 4) and compute (Eq. 5) occupancy caps, and
exactly-one placement per (request, layer) (Eq. 6); binariness (Eq. 7).

Solvers
-------
* ``solver="ilp"``   — paper-faithful ILP via HiGHS (`scipy.optimize.milp`).
  ``gamma_relaxed=True`` (default) declares γ continuous in [0,1]: with the
  big-M inequalities and binary α, γ* = α_i·α_k at every vertex, so the optimum
  is unchanged while the branch-and-bound tree only explores α.  This is an
  exactness-preserving speedup (validated against the all-binary mode in
  tests).  ``tight=True`` keeps the two ≤ inequalities the paper writes; they
  are redundant for a non-negative objective but retained by default for
  faithfulness.
* ``solver="dp"``    — exact per-request shortest-path DP through the N×M
  lattice when capacity constraints are slack; with contention it becomes a
  sequential greedy-DP (requests placed one at a time, capacities decremented)
  — our large-instance fallback, also the warm-start generator.
* ``solver="dp-sparse"`` — the same sequential greedy-DP with each layer's
  transition pruned to the ``k`` best candidate nodes (ranked by residual
  seconds/byte from the request's source plus a capacity-headroom tiebreak)
  instead of scanning all N×N transitions: O(M·(N + k²)) per request instead
  of O(M·N²).  A fallback ladder keeps each request's admission decision
  identical to ``"dp"``'s *under the same residual capacities*: whenever the
  pruned DP rejects (or only finds a path over a ``_BIG``-priced link), the
  request retries with k doubled and, as a last resort, the dense kernel —
  and at k ≥ N the two solvers are bit-identical by construction.  At k < N
  an admitted request's *path* may differ, so residuals can diverge across
  the greedy sequence and whole-solve admission equality is an empirical,
  seed-pinned property (checked by bench_swarm S5 and the equivalence
  tests), not a structural guarantee.
  This is the ROADMAP's N ≥ 50 swarm regime (bench_swarm S5).
  With ``batch_solve=True`` the per-request (M-1, k, k) min-plus sweeps of
  one solve are precomputed in a single kernel launch
  (:mod:`repro_torch.core.batch_dp`) and consumed greedily under a certification
  rule that keeps every admission decision — and every admitted path —
  bit-identical to the sequential sparse solve; requests the batched pass
  cannot certify or admit fall back to the sequential ladder (bench_swarm
  S7 locks the N = 1024 epoch re-solve speedup).

OULD-MP is the same formulation with rate coefficients summed over the
predicted horizon: cost(i,k) uses Σ_t 1/ρ_{i,k}(t) (Eq. 14).  A pair that is
predicted to *disconnect* (ρ=0 at any t) gets an infinite coefficient, which
is exactly the paper's argument for why MP avoids mid-mission outages.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable, Literal

import numpy as np
import scipy.sparse as sp
from scipy.optimize import Bounds, LinearConstraint, milp

from .profiles import ModelProfile

Solver = Literal["ilp", "dp", "dp-sparse"]

_BIG = 1e12  # stand-in for an unreachable (disconnected) pair


@dataclasses.dataclass(frozen=True)
class Problem:
    """One OULD instance (a set of concurrent requests on a topology)."""

    profile: ModelProfile
    mem_cap: np.ndarray          # (N,) m̄_i, bytes
    comp_cap: np.ndarray         # (N,) c̄_i, FLOPs budget per decision period
    rates: np.ndarray            # (N,N) ρ bits/s — or (T,N,N) for OULD-MP
    sources: np.ndarray          # (R,) source node of each request (μ_{i,r})
    compute_speed: np.ndarray | None = None  # (N,) FLOPs/s for latency eval
    rate_unit_bytes: float = 1 / 8.0  # bits/s rates → bytes = K·8/ρ
    # Provenance of the rates: "analytic" (radio model) or
    # "measured:<transport>" when a byte-moving backend calibrated them
    # (repro_torch.exec.calibrate.calibrate_rates) — rides into Plan.problem.
    comm_source: str = "analytic"

    @property
    def n_nodes(self) -> int:
        return int(self.mem_cap.shape[0])

    @property
    def n_requests(self) -> int:
        return int(self.sources.shape[0])

    @property
    def n_layers(self) -> int:
        return self.profile.num_layers

    def horizon(self) -> int:
        return 1 if self.rates.ndim == 2 else int(self.rates.shape[0])

    def transfer_cost(self) -> np.ndarray:
        """(N,N) seconds per byte between node pairs, summed over the horizon
        (Eq. 14 sums transfer latency over t ∈ {1..T})."""
        return transfer_cost(self.rates, self.rate_unit_bytes)


def transfer_cost(rates: np.ndarray,
                  rate_unit_bytes: float = 1 / 8.0) -> np.ndarray:
    """Full (N,N) seconds/byte pricing of a rate matrix or horizon stack."""
    r3 = rates[None] if rates.ndim == 2 else rates
    secs_per_byte = np.zeros(r3.shape[1:])
    for t in range(r3.shape[0]):
        r = r3[t]
        with np.errstate(divide="ignore"):
            spb = np.where(r > 0, (1.0 / rate_unit_bytes) / np.maximum(r, 1e-30), _BIG)
        np.fill_diagonal(spb, 0.0)  # same node: no transfer
        secs_per_byte = secs_per_byte + spb
    return secs_per_byte


def incremental_transfer_cost(
        rates: np.ndarray, ref_rates: np.ndarray, ref_spb: np.ndarray, *,
        rel_change: float = 0.0, rate_unit_bytes: float = 1 / 8.0,
        repriced: np.ndarray | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Re-price only entries of the seconds/byte matrix whose rates moved
    (beyond ``rel_change`` relative drift; 0.0 ⇒ exact: any change at all).

    ``ref_rates``/``ref_spb`` are the rates each entry was last priced at
    and the matching cost matrix.  Returns ``(spb, repriced)`` with
    ``repriced`` the (N, N) bool mask of re-priced pairs; entries outside it
    are carried over verbatim — at ``rel_change=0.0`` the result is
    bit-identical to :func:`transfer_cost`.

    A caller that *knows* which links moved (a churn event, one mobile
    group) passes the pair mask as ``repriced`` and skips change detection
    entirely — true O(T·P) for P changed pairs instead of O(T·N²).  Without
    the hint, detection costs one pass over the tensor (still ~2× cheaper
    than the ~5 arithmetic passes of full pricing).  The ROADMAP regime:
    large-N swarms (N ≥ 50) with localized drift.
    """
    if rates.shape != ref_rates.shape:        # topology resized: full price
        full = transfer_cost(rates, rate_unit_bytes)
        return full, np.ones(full.shape, bool)
    r3 = rates[None] if rates.ndim == 2 else rates
    if repriced is None:
        ref3 = ref_rates[None] if ref_rates.ndim == 2 else ref_rates
        if rel_change > 0.0:
            with np.errstate(invalid="ignore"):
                diff = np.abs(r3 - ref3)
            diff = np.where(np.isnan(diff), 0.0, diff)  # inf==inf: self-link
            denom = np.maximum(np.minimum(r3, ref3), 1e-30)
            moved = diff > rel_change * denom  # covers 0 ↔ connected flips
        else:
            # Exact mode: a pure equality compare (no float arithmetic)
            # keeps detection far cheaper than the divides it saves;
            # inf == inf on self-links, so the diagonal never trips it.
            moved = r3 != ref3
        repriced = moved.any(axis=0)
    else:
        repriced = repriced.copy()
    np.fill_diagonal(repriced, False)         # same node: always 0 transfer
    spb = ref_spb.copy()
    ii, kk = np.nonzero(repriced)
    if ii.size == 0:
        return spb, repriced
    unit = 1.0 / rate_unit_bytes
    vals = np.zeros(ii.size)
    for t in range(r3.shape[0]):
        rv = r3[t][ii, kk]
        vals += np.where(rv > 0, unit / np.maximum(rv, 1e-30), _BIG)
    spb[ii, kk] = vals
    return spb, repriced


@dataclasses.dataclass
class Solution:
    assign: np.ndarray           # (R, M) node index per (request, layer)
    objective: float             # communication latency (paper objective)
    status: str                  # "optimal" | "feasible" | "rejected:<n>"
    solve_time_s: float
    admitted: np.ndarray         # (R,) bool — False = request rejected
    solver: str = "ilp"
    dp_stats: "ResolveStats | None" = None  # sparse-DP provenance (k, ladder)

    @property
    def n_admitted(self) -> int:
        return int(self.admitted.sum())


# ---------------------------------------------------------------------------
# ILP construction
# ---------------------------------------------------------------------------

class _Index:
    """Flat variable indexing: α block then γ block."""

    def __init__(self, R: int, N: int, M: int):
        self.R, self.N, self.M = R, N, M
        self.n_alpha = R * N * M
        # γ over r, j ∈ {1..M-1}, ordered pairs i≠k
        self.pairs = [(i, k) for i in range(N) for k in range(N) if i != k]
        self.n_gamma = R * (M - 1) * len(self.pairs)
        self.n_vars = self.n_alpha + self.n_gamma
        self._pair_id = {p: q for q, p in enumerate(self.pairs)}

    def a(self, r: int, i: int, j: int) -> int:
        return (r * self.N + i) * self.M + j

    def g(self, r: int, j: int, i: int, k: int) -> int:
        q = self._pair_id[(i, k)]
        return self.n_alpha + (r * (self.M - 1) + j) * len(self.pairs) + q


def _build_objective(prob: Problem, idx: "_Index", *,
                     include_compute: bool,
                     spb: np.ndarray | None = None) -> np.ndarray:
    """Rate-dependent objective coefficients (Eq. 12 + 13), vectorized.

    This is the ONLY part of the ILP that depends on the rate matrix, so
    epoch re-solves rebuild just this vector and reuse the cached sparse
    constraint matrix (see :class:`IncrementalSolver`)."""
    R, N, M = idx.R, idx.N, idx.M
    if spb is None:
        spb = prob.transfer_cost()      # (N,N) seconds/byte over horizon
    K = np.asarray(prob.profile.output_vector())    # K_j bytes
    Ks = prob.profile.input_bytes
    comp = np.asarray(prob.profile.compute_vector())

    c = np.zeros(idx.n_vars)
    ca = c[: idx.n_alpha].reshape(R, N, M)          # view
    # Source term t_s (Eq. 13): linear in α_{r,k,1}.
    for r in range(R):
        src = int(prob.sources[r])
        ca[r, :, 0] = Ks * spb[src, :]
        ca[r, src, 0] = 0.0
    # Inter-layer transfers (Eq. 12): γ_{r,i,k,j} · K_j / ρ_{i,k}.
    pi = np.fromiter((p[0] for p in idx.pairs), np.int64, len(idx.pairs))
    pk = np.fromiter((p[1] for p in idx.pairs), np.int64, len(idx.pairs))
    gam = K[: M - 1, None] * spb[pi, pk][None, :]   # (M-1, n_pairs)
    c[idx.n_alpha:] = np.broadcast_to(gam, (R, M - 1, len(idx.pairs))).ravel()
    if include_compute and prob.compute_speed is not None:
        # Heterogeneous-speed extension (linear): Σ α_{r,i,j}·c_j/speed_i.
        ca += comp[None, None, :] / prob.compute_speed[None, :, None]
    return c


def _build_constraints(prob: Problem, idx: "_Index", *, tight: bool):
    """Rate-INdependent constraint matrix (Eq. 4–6, 11) as a sparse
    LinearConstraint — cacheable across epochs (topology drift only moves
    the objective, never these rows)."""
    R, N, M = idx.R, idx.N, idx.M
    mem = prob.profile.memory_vector()
    comp = prob.profile.compute_vector()

    rows, cols, vals, lo, hi = [], [], [], [], []
    row = 0

    def add_row(entries, lo_v, hi_v):
        nonlocal row
        for col, v in entries:
            rows.append(row)
            cols.append(col)
            vals.append(v)
        lo.append(lo_v)
        hi.append(hi_v)
        row += 1

    # Eq. 4 memory / Eq. 5 compute capacity per node.
    for i in range(N):
        add_row([(idx.a(r, i, j), mem[j]) for r in range(R) for j in range(M)],
                -np.inf, float(prob.mem_cap[i]))
    for i in range(N):
        add_row([(idx.a(r, i, j), comp[j]) for r in range(R) for j in range(M)],
                -np.inf, float(prob.comp_cap[i]))
    # Eq. 6 exactly-one per (r, j).
    for r in range(R):
        for j in range(M):
            add_row([(idx.a(r, i, j), 1.0) for i in range(N)], 1.0, 1.0)
    # Eq. 11 big-M linking.
    for r in range(R):
        for j in range(M - 1):
            for (i, k) in idx.pairs:
                g = idx.g(r, j, i, k)
                ai, ak = idx.a(r, i, j), idx.a(r, k, j + 1)
                add_row([(g, 1.0), (ai, -1.0), (ak, -1.0)], -1.0, np.inf)
                if tight:
                    add_row([(g, 1.0), (ai, -1.0)], -np.inf, 0.0)
                    add_row([(g, 1.0), (ak, -1.0)], -np.inf, 0.0)

    A = sp.csc_matrix((vals, (rows, cols)), shape=(row, idx.n_vars))
    return LinearConstraint(A, np.array(lo), np.array(hi))


def _build_ilp(prob: Problem, *, include_compute: bool, tight: bool,
               cache: dict | None = None):
    """Assemble (idx, c, constraints); ``cache`` (owned by the caller, e.g.
    :class:`IncrementalSolver`) memoizes the constraint structure keyed on
    instance shape + capacity vectors — valid because only the objective
    depends on the rates."""
    R, N, M = prob.n_requests, prob.n_nodes, prob.n_layers
    # The capacity rows also encode the profile's per-layer demands, so the
    # key must carry them — same-shaped instances with different profiles
    # must not share constraint structure.
    key = (R, N, M, tight, prob.mem_cap.tobytes(), prob.comp_cap.tobytes(),
           tuple(prob.profile.memory_vector()),
           tuple(prob.profile.compute_vector()))
    if cache is not None and key in cache:
        idx, constraints = cache[key]
    else:
        idx = _Index(R, N, M)
        constraints = _build_constraints(prob, idx, tight=tight)
        if cache is not None:
            cache[key] = (idx, constraints)
    c = _build_objective(prob, idx, include_compute=include_compute)
    return idx, c, constraints


def _solve_ilp_once(prob: Problem, *, include_compute: bool, tight: bool,
                    gamma_relaxed: bool, time_limit: float | None,
                    mip_rel_gap: float,
                    cache: dict | None = None) -> tuple[np.ndarray | None, float, str]:
    R, N, M = prob.n_requests, prob.n_nodes, prob.n_layers
    idx, c, constraints = _build_ilp(prob, include_compute=include_compute,
                                     tight=tight, cache=cache)
    # Normalize the objective so HiGHS tolerances (~1e-7 absolute) are far
    # below the cost scale — latencies can be microseconds on fast links.
    finite = np.abs(c[np.isfinite(c) & (np.abs(c) > 0) & (np.abs(c) < _BIG)])
    scale = 1.0 / finite.max() if finite.size else 1.0
    c = np.minimum(c * scale, 1e9)  # disconnected pairs stay priced out
    integrality = np.zeros(idx.n_vars)
    integrality[: idx.n_alpha] = 1
    if not gamma_relaxed:
        integrality[:] = 1
    opts: dict = {"mip_rel_gap": mip_rel_gap}
    if time_limit is not None:
        opts["time_limit"] = time_limit
    res = milp(c, constraints=constraints, integrality=integrality,
               bounds=Bounds(0.0, 1.0), options=opts)
    # status 0 = optimal; 1 = hit time/iteration limit (accept incumbent)
    if res.status not in (0, 1) or res.x is None:
        return None, float("inf"), "infeasible" if res.status == 2 else f"status{res.status}"
    alpha = res.x[: idx.n_alpha].reshape(R, N, M)
    assign = alpha.argmax(axis=1).astype(np.int64)  # (R, M)
    return (assign, float(res.fun) / scale,
            "optimal" if res.status == 0 else "feasible")


# ---------------------------------------------------------------------------
# Exact per-request DP (lattice shortest path) + sequential greedy-DP
# ---------------------------------------------------------------------------

def _dp_single_request(spb: np.ndarray, K: list[float], Ks: float, src: int,
                       mem: list[float], comp: list[float],
                       mem_left: np.ndarray, comp_left: np.ndarray,
                       compute_cost: np.ndarray | None) -> tuple[np.ndarray | None, float]:
    """Shortest path through the (layer, node) lattice for one request.

    State cost(j, i): min latency to have layer j's output resident on node i.
    Edge (j-1,k) → (j,i): K_{j-1}·spb[k,i] (0 if k == i).  Feasibility of
    putting layer j on node i uses *remaining* capacity — exact for a single
    request when the node never needs to split a single layer.
    """
    N, M = spb.shape[0], len(K)
    INF = float("inf")
    feas = np.zeros((M, N), bool)
    for j in range(M):
        feas[j] = (mem_left >= mem[j]) & (comp_left >= comp[j])
    cost = np.full((M, N), INF)
    back = np.full((M, N), -1, np.int64)
    for i in range(N):
        if feas[0, i]:
            cost[0, i] = 0.0 if i == src else Ks * spb[src, i]
            if compute_cost is not None:
                cost[0, i] += compute_cost[0, i]
    for j in range(1, M):
        # NOTE: single-request DP treats per-layer feasibility independently;
        # when one node hosts several layers of the SAME request the combined
        # load is checked post-hoc by the caller and repaired greedily.
        prev = cost[j - 1]
        step = prev[:, None] + np.array(K[j - 1]) * spb  # (k→i)
        if compute_cost is not None:
            step = step + compute_cost[j][None, :]
        step[:, ~feas[j]] = INF
        back[j] = step.argmin(axis=0)
        cost[j] = step[back[j], np.arange(N)]
    end = int(np.argmin(cost[-1]))
    if not np.isfinite(cost[-1, end]):
        return None, INF
    path = np.zeros(M, np.int64)
    path[-1] = end
    for j in range(M - 1, 0, -1):
        path[j - 1] = back[j, path[j]]
    return path, float(cost[-1, end])


def default_sparse_k(n_nodes: int) -> int:
    """Default per-layer candidate budget of the sparse DP: ⌈√N⌉ keeps the
    pruned transition scan O(M·N) overall (N candidates scored, √N² kept),
    with a floor so tiny swarms still see a meaningful candidate set."""
    return max(4, int(np.ceil(np.sqrt(n_nodes))))


class _SparseCounters:
    """Mutable tally of what the sparse ladder actually did (one solve)."""

    __slots__ = ("n_runs", "n_scanned", "n_dense_equiv", "n_escalations",
                 "n_dense_fallback", "n_batched", "n_jit_compiles")

    def __init__(self):
        self.n_runs = 0             # DP kernel invocations (incl. repairs)
        self.n_scanned = 0          # lattice transitions actually scanned
        self.n_dense_equiv = 0      # what the dense kernel would have scanned
        self.n_escalations = 0      # k-doubling retries
        self.n_dense_fallback = 0   # requests that hit the dense last resort
        self.n_batched = 0          # requests served by the batched fast path
        self.n_jit_compiles = 0     # first launches at a new sweep shape

    def wrap(self, kernel: Callable, per_run: int, dense_per_run: int):
        """Instrument ``kernel`` so every invocation (the repair loop re-runs
        it) is charged ``per_run`` scanned transitions."""
        def run(*args):
            self.n_runs += 1
            self.n_scanned += per_run
            self.n_dense_equiv += dense_per_run
            return kernel(*args)
        return run

    @property
    def pruned_fraction(self) -> float:
        if self.n_dense_equiv == 0:
            return 0.0
        return 1.0 - self.n_scanned / self.n_dense_equiv


def _dp_single_request_sparse(spb: np.ndarray, K: list[float], Ks: float,
                              src: int, mem: list[float], comp: list[float],
                              mem_left: np.ndarray, comp_left: np.ndarray,
                              compute_cost: np.ndarray | None, k: int,
                              head: np.ndarray | None = None,
                              consts: tuple | None = None
                              ) -> tuple[np.ndarray | None, float]:
    """Pruned lattice DP: per layer, only the ``k`` best candidate nodes.

    Candidates are ranked by seconds/byte from the request's source under the
    residual topology (cheap proxy for how expensive it is to route
    activations through the node) with a small capacity-headroom tiebreak
    (``head``; recomputed from the residual capacities when not supplied),
    feasibility-masked per layer.  Candidate lists are kept in ascending node
    order so that at k ≥ N the argmin tie-breaking — and therefore the
    returned path — is bit-identical to :func:`_dp_single_request`.

    The formulation is one vectorized pass: an (M, N) feasibility mask, one
    masked argpartition, an (M-1, k, k) gather of the transition
    sub-matrices with the infeasibility penalty and compute cost pre-added,
    and a recurrence that touches k² entries per layer instead of N².
    ``consts`` carries per-solve invariants (K vector, per-layer demands,
    score scale) so repeated calls skip their recomputation.
    """
    if consts is None:
        consts = _sparse_consts(spb, K, mem, comp)
    if head is None:
        head = (mem_left / max(float(mem_left.max()), 1e-30)
                + comp_left / max(float(comp_left.max()), 1e-30))
    cand, valid = _sparse_select(spb, src, mem_left, comp_left, head,
                                 consts, k)
    return _sparse_run(spb, Ks, src, compute_cost, cand, valid, consts)


def _sparse_consts(spb: np.ndarray, K: list[float], mem: list[float],
                   comp: list[float]) -> tuple:
    """Per-solve invariants of the sparse kernel: (K, m, c vectors and the
    candidate-score normalizer 1/max finite spb)."""
    finite = spb[(spb > 0) & (spb < _BIG)]
    scale = float(finite.max()) if finite.size else 1.0
    return (np.asarray(K, float), np.asarray(mem, float),
            np.asarray(comp, float), 1.0 / scale)


def _sparse_select(spb: np.ndarray, src: int, mem_left: np.ndarray,
                   comp_left: np.ndarray, head: np.ndarray, consts: tuple,
                   k: int) -> tuple[np.ndarray, np.ndarray]:
    """Candidate selection of the pruned DP: per layer, the k best feasible
    nodes by score, in ascending node order.  Returns (cand, valid) — the
    (M, k) candidate node ids and their per-layer feasibility bits.  The DP
    output is a pure function of these two arrays (given the fixed spb and
    compute costs), which is what makes cached stage outputs certifiable by
    an equality check on them."""
    _, mem_a, comp_a, inv_scale = consts
    N, M = spb.shape[0], mem_a.shape[0]
    kk = int(min(k, N))
    feas = ((mem_left[None, :] >= mem_a[:, None])
            & (comp_left[None, :] >= comp_a[:, None]))      # (M, N)
    score = spb[src] * inv_scale - 1e-3 * head  # cost dominates, headroom ties
    masked = np.where(feas, score[None, :], np.inf)         # (M, N)
    if kk < N:
        cand = np.argpartition(masked, kk - 1, axis=1)[:, :kk]
        cand.sort(axis=1)                   # ascending node ids (dense tie-break)
    else:
        cand = np.broadcast_to(np.arange(N), (M, N))
    valid = feas[np.arange(M)[:, None], cand]               # (M, kk)
    return cand, valid


def _sparse_select_batch(spb: np.ndarray, srcs: np.ndarray,
                         mem_left: np.ndarray, comp_left: np.ndarray,
                         head: np.ndarray, consts: tuple, k: int
                         ) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized :func:`_sparse_select` over S sources at once.

    Produces per source *exactly* the arrays the scalar selection produces —
    the feasibility mask is source-independent (computed once instead of S
    times), the score differs per source only through its ``spb`` row, and
    ``np.argpartition``/``sort`` act on each (source, layer) slice
    independently, so the (S, M, k) result rows are elementwise identical to
    S scalar calls.  This is what makes one batch dispatch's selection cost
    O(S + M·N) Python-side instead of S × O(M·N).
    """
    _, mem_a, comp_a, inv_scale = consts
    N, M = spb.shape[0], mem_a.shape[0]
    kk = int(min(k, N))
    feas = ((mem_left[None, :] >= mem_a[:, None])
            & (comp_left[None, :] >= comp_a[:, None]))      # (M, N)
    score = spb[srcs] * inv_scale - 1e-3 * head[None, :]    # (S, N)
    masked = np.where(feas[None], score[:, None, :], np.inf)  # (S, M, N)
    if kk < N:
        cand = np.argpartition(masked, kk - 1, axis=2)[:, :, :kk]
        cand.sort(axis=2)
    else:
        cand = np.broadcast_to(np.arange(N), (len(srcs), M, N)).copy()
    valid = feas[np.arange(M)[None, :, None], cand]         # (S, M, kk)
    return cand, valid


def _sparse_run(spb: np.ndarray, Ks: float, src: int,
                compute_cost: np.ndarray | None, cand: np.ndarray,
                valid: np.ndarray, consts: tuple
                ) -> tuple[np.ndarray | None, float]:
    """The pruned DP recurrence over pre-selected candidates: an (M-1, k, k)
    transition block with the infeasibility penalty (and target compute cost)
    folded in once, then a k²-per-layer min-plus sweep."""
    Kv = consts[0]
    M, kk = cand.shape
    pen = np.where(valid, 0.0, np.inf)                      # (M, kk) additive
    cost = Ks * spb[src, cand[0]] + pen[0]  # spb[src, src] == 0: free at src
    if compute_cost is not None:
        cost = cost + compute_cost[0, cand[0]]
    trans = Kv[:M - 1, None, None] * spb[cand[:-1, :, None], cand[1:, None, :]]
    trans += pen[1:, None, :]
    if compute_cost is not None:
        trans += compute_cost[np.arange(1, M)[:, None], cand[1:]][:, None, :]
    back = np.empty((M, kk), np.int64)
    rng_kk = np.arange(kk)
    for j in range(1, M):
        step = cost[:, None] + trans[j - 1]                 # (kk prev, kk cur)
        b = step.argmin(axis=0)
        back[j] = b
        cost = step[b, rng_kk]
    end = int(np.argmin(cost))
    if not np.isfinite(cost[end]):
        return None, float("inf")
    path = np.zeros(M, np.int64)
    idx = end
    path[M - 1] = cand[M - 1, idx]
    for j in range(M - 1, 0, -1):
        idx = int(back[j, idx])
        path[j - 1] = cand[j - 1, idx]
    return path, float(cost[end])


def _repair_capacity(path: np.ndarray, mem: list[float], comp: list[float],
                     mem_left: np.ndarray, comp_left: np.ndarray) -> bool:
    """Check a DP path against *joint* per-node load; True if it fits."""
    N = mem_left.shape[0]
    m_use = np.zeros(N)
    c_use = np.zeros(N)
    for j, i in enumerate(path):
        m_use[i] += mem[j]
        c_use[i] += comp[j]
    return bool(np.all(m_use <= mem_left + 1e-9) and np.all(c_use <= comp_left + 1e-9))


CAPACITY_REPAIRS = ("halve", "gentle")


def _gentle_shrink(adv: np.ndarray, busy: int, load: float,
                   demands: list[float]) -> None:
    """The gentle capacity-repair step: advertise ``load − min hosted layer``
    on the overloaded node instead of halving — the node sheds just enough
    for its smallest hosted layer to move, rather than (potentially) being
    zeroed while it could still host one layer.  When that target would not
    strictly shrink the advertisement (with ≥ 2 hosted layers it never
    excludes any of them), peel the *largest* hosted layer by advertising
    one ulp below its demand — guaranteed progress in the hosted-set
    lattice, same 4N iteration bound as halving."""
    new = min(adv[busy], load - min(demands))
    if new >= adv[busy]:
        new = np.nextafter(max(demands), 0.0)
    adv[busy] = max(new, 0.0)


def _place_request(spb: np.ndarray, K: list[float], Ks: float, src: int,
                   mem: list[float], comp: list[float],
                   mem_left: np.ndarray, comp_left: np.ndarray,
                   compute_cost: np.ndarray | None,
                   kernel: Callable = _dp_single_request,
                   capacity_repair: str = "halve") -> tuple[np.ndarray | None, float]:
    """Place ONE request against residual capacity: lattice DP + repair loop.

    The lattice DP checks per-layer feasibility, not the joint within-request
    load; the repair loop iteratively shrinks the advertised memory AND
    compute of the most-overloaded node and re-plans — forcing the DP to
    spread until the joint check passes.  Shared by the cold greedy-DP solve
    and the incremental warm re-solve.  Does NOT mutate mem_left/comp_left.

    ``kernel`` is the single-request DP — the dense N×N scan by default, or a
    pruned k-candidate kernel (the sparse solver runs the same repair loop,
    only the inner shortest-path search changes).

    ``capacity_repair`` picks the shrink rule: ``"halve"`` (default, the
    pinned-baseline rule) cuts the busiest node's advertised capacity by 2×
    and zeroes it below the smallest layer demand — which can exclude a node
    that still fit one layer; ``"gentle"`` sheds only ``load − min hosted
    layer`` (:func:`_gentle_shrink`), admitting strictly more under
    contention.
    """
    if capacity_repair not in CAPACITY_REPAIRS:
        raise ValueError(f"unknown capacity_repair {capacity_repair!r}; "
                         f"one of {CAPACITY_REPAIRS}")
    N = spb.shape[0]
    path, cost = kernel(spb, K, Ks, src, mem, comp,
                        mem_left, comp_left, compute_cost)
    mem_adv = mem_left.copy()
    comp_adv = comp_left.copy()
    for _ in range(4 * N):
        if path is None or _repair_capacity(path, mem, comp, mem_left,
                                            comp_left):
            break
        m_load = np.zeros(N)
        c_load = np.zeros(N)
        for j, i in enumerate(path):
            m_load[i] += mem[j]
            c_load[i] += comp[j]
        m_over = m_load - mem_left
        c_over = c_load - comp_left
        if m_over.max() >= c_over.max() / max(comp_left.max(), 1e-9) * \
                max(mem_left.max(), 1e-9):
            busy = int(m_over.argmax())
            if capacity_repair == "gentle":
                _gentle_shrink(mem_adv, busy, m_load[busy],
                               [mem[j] for j, i in enumerate(path)
                                if i == busy and mem[j] > 0] or [0.0])
            else:
                mem_adv[busy] = max(mem_adv[busy] / 2.0, 0.0)
                if mem_adv[busy] < min((m for m in mem if m > 0), default=0):
                    mem_adv[busy] = 0.0
        else:
            busy = int(c_over.argmax())
            if capacity_repair == "gentle":
                _gentle_shrink(comp_adv, busy, c_load[busy],
                               [comp[j] for j, i in enumerate(path)
                                if i == busy and comp[j] > 0] or [0.0])
            else:
                comp_adv[busy] = max(comp_adv[busy] / 2.0, 0.0)
                if comp_adv[busy] < min((c for c in comp if c > 0), default=0):
                    comp_adv[busy] = 0.0
        path, cost = kernel(spb, K, Ks, src, mem, comp,
                            mem_adv, comp_adv, compute_cost)
    if path is None or not _repair_capacity(path, mem, comp, mem_left,
                                            comp_left):
        return None, float("inf")
    return path, cost


class _SparsePlacer:
    """Sequential sparse placement over one priced topology.

    Owns the two levers that make the k-candidate DP fast at N ≥ 50:

    * **The fallback ladder** (admission parity with the dense DP): a request
      the pruned kernel rejects — no feasible path inside the candidate
      sets, only one riding a ``_BIG``-priced (disconnected) link, or only
      one over the ``max_path_cost`` admission bar — retries with k doubled
      and, once k ≥ N, the dense kernel.  Every request's admission
      decision is therefore identical to
      ``solver="dp"``'s under the same residual capacities; only the *path*
      of an admitted request may differ while k < N.
    * **Per-source stage memoization**: the pruned DP's output is a pure
      function of the selected (candidates, feasibility) arrays — so each
      ladder stage's unrepaired output is cached per source and *certified*
      on replay by re-running only the cheap candidate selection and
      comparing: equal arrays ⇒ the DP would reproduce the cached path
      bit-for-bit, so the k²-transition sweep is skipped.  (The headroom
      tiebreak entering the selection score is frozen per *feasibility
      epoch* — bumped whenever a commit flips any per-layer feasibility
      bit — keeping selection deterministic between flips; dense-kernel
      stages, which read the full topology, are certified by epoch equality
      instead.)  A certified path is accepted only when it passes the joint
      residual check *right now*; anything residual-dependent (a failed
      fit, a repaired path) falls back to a full ladder re-run.  Because
      residuals only shrink during a solve, a cached stage that failed its
      fit check can never start fitting again — replay is exactly what a
      fresh run would compute, minus the DP sweeps.

    Residual capacity arrays are the caller's; :meth:`commit` mutates them
    in place so the caller observes every reservation.
    """

    def __init__(self, spb: np.ndarray, K: list[float], Ks: float,
                 mem: list[float], comp: list[float],
                 mem_left: np.ndarray, comp_left: np.ndarray,
                 compute_cost: np.ndarray | None, *, k: int,
                 max_path_cost: float | None = None,
                 counters: _SparseCounters | None = None,
                 capacity_repair: str = "halve"):
        self.spb = spb
        self.K, self.Ks, self.mem, self.comp = K, Ks, mem, comp
        self.mem_left, self.comp_left = mem_left, comp_left
        self.compute_cost = compute_cost
        self.k = max(1, int(k))
        self.max_path_cost = max_path_cost
        self.capacity_repair = capacity_repair
        self.counters = counters
        self.consts = _sparse_consts(spb, K, mem, comp)
        _, self._mem_a, self._comp_a, _ = self.consts
        self._feas = self._feas_of(np.arange(spb.shape[0]))   # (M, N)
        self._head = self._headroom()
        self._epoch = 0
        # src → (epoch, [(lvl, cand, valid, p0, cost0, is_dense), ...])
        self._cache: dict[int, tuple[int, list]] = {}
        self.n_cache_hits = 0

    # -- epoch bookkeeping --------------------------------------------------

    def _feas_of(self, cols: np.ndarray) -> np.ndarray:
        return ((self.mem_left[cols][None, :] >= self._mem_a[:, None])
                & (self.comp_left[cols][None, :] >= self._comp_a[:, None]))

    def _headroom(self) -> np.ndarray:
        return (self.mem_left / max(float(self.mem_left.max()), 1e-30)
                + self.comp_left / max(float(self.comp_left.max()), 1e-30))

    def _fits(self, path: np.ndarray) -> bool:
        return _repair_capacity(path, self.mem, self.comp,
                                self.mem_left, self.comp_left)

    def commit(self, path: np.ndarray) -> None:
        """Reserve a placed path's capacity; advance the feasibility epoch
        when any (layer, node) feasibility bit flips."""
        for j, i in enumerate(path):
            self.mem_left[i] -= self.mem[j]
            self.comp_left[i] -= self.comp[j]
        cols = np.unique(path)
        fresh = self._feas_of(cols)
        if not np.array_equal(fresh, self._feas[:, cols]):
            self._feas[:, cols] = fresh
            self._head = self._headroom()
            self._epoch += 1

    # -- placement ----------------------------------------------------------

    def place(self, src: int) -> tuple[np.ndarray | None, float]:
        """Ladder placement for one request (cache replay when certified)."""
        ent = self._cache.get(src)
        if ent is None:
            return self._ladder(src)
        epoch, stages = ent
        for lvl, cand, valid, p0, cost0, is_dense in stages:
            if is_dense:
                if epoch != self._epoch:    # dense reads the full topology
                    return self._ladder(src)
            else:
                now = _sparse_select(self.spb, src, self.mem_left,
                                     self.comp_left, self._head, self.consts,
                                     lvl)
                if not (np.array_equal(now[0], cand)
                        and np.array_equal(now[1], valid)):
                    return self._ladder(src)    # selection moved: re-run
            # Stage output certified identical to a fresh kernel run.
            if p0 is None:
                continue                    # no path through the candidates
            if not is_dense and (cost0 >= _BIG
                                 or (self.max_path_cost is not None
                                     and cost0 > self.max_path_cost)):
                continue                    # repair only raises cost: the
                                            # fresh ladder would escalate too
            if self._fits(p0):
                self.n_cache_hits += 1
                return p0, cost0
            return self._ladder(src)        # residual-dependent: re-run
        # Every stage certified and skipped ⇒ the fresh ladder would reject.
        self.n_cache_hits += 1
        return None, float("inf")

    def _ladder(self, src: int) -> tuple[np.ndarray | None, float]:
        N, M = self.spb.shape[0], len(self.K)
        dense_per_run = (M - 1) * N * N
        counters = self.counters
        stages: list[tuple] = []
        result: tuple[np.ndarray | None, float] = (None, float("inf"))
        kk = self.k
        levels = []
        while kk < N:
            levels.append(kk)
            kk *= 2
        levels.append(N)                    # dense last resort
        for lvl in levels:
            if lvl >= N:                    # dense last resort
                base: Callable = _dp_single_request
                if counters is not None:
                    counters.n_dense_fallback += 1
                    base = counters.wrap(base, dense_per_run, dense_per_run)
                first: list = []

                def kernel(*args, _base=base, _first=first):
                    out = _base(*args)
                    if not _first:
                        _first.append(out)  # the unrepaired stage output p0
                    return out

                path, cost = _place_request(self.spb, self.K, self.Ks, src,
                                            self.mem, self.comp,
                                            self.mem_left, self.comp_left,
                                            self.compute_cost, kernel=kernel,
                                            capacity_repair=self.capacity_repair)
                stages.append((lvl, None, None, *first[0], True))
                result = (path, cost)
                break
            cand, valid = _sparse_select(self.spb, src, self.mem_left,
                                         self.comp_left, self._head,
                                         self.consts, lvl)
            if counters is not None:
                counters.n_runs += 1
                counters.n_scanned += (M - 1) * lvl * lvl
                counters.n_dense_equiv += dense_per_run
            p0, cost0 = _sparse_run(self.spb, self.Ks, src,
                                    self.compute_cost, cand, valid,
                                    self.consts)
            stages.append((lvl, cand, valid, p0, cost0, False))
            # Escalate off a ``_BIG``-priced path unconditionally: the pruned
            # candidate set may have missed a finite relay (e.g. the single
            # bridge node between two clusters) that a wider set — or the
            # dense last resort — still finds.  Also escalate when the path
            # is over the admission bar; repair only raises cost, so neither
            # skip can hide a path this stage could have admitted.
            too_dear = (cost0 >= _BIG
                        or (self.max_path_cost is not None
                            and cost0 > self.max_path_cost))
            if p0 is not None and not too_dear:
                if self._fits(p0):
                    result = (p0, cost0)
                    break
                # Joint within-request overload: run the full repair loop
                # with the same pruned kernel (recomputes p0, then spreads).
                base = functools.partial(_dp_single_request_sparse, k=lvl,
                                         head=self._head, consts=self.consts)
                if counters is not None:
                    base = counters.wrap(base, (M - 1) * lvl * lvl,
                                         dense_per_run)
                path, cost = _place_request(self.spb, self.K, self.Ks, src,
                                            self.mem, self.comp,
                                            self.mem_left, self.comp_left,
                                            self.compute_cost, kernel=base,
                                            capacity_repair=self.capacity_repair)
                if path is not None and (self.max_path_cost is None
                                         or cost <= self.max_path_cost):
                    result = (path, cost)
                    break
            if counters is not None:
                counters.n_escalations += 1
        self._cache[src] = (self._epoch, stages)
        return result


def _fits_joint(path: np.ndarray, mem: list[float], comp: list[float],
                mem_left: np.ndarray, comp_left: np.ndarray) -> bool:
    """Path-local equivalent of :func:`_repair_capacity`: a path loads at
    most M distinct nodes, so only those need the joint residual check —
    O(M) instead of the O(N) full-array scan (the batched fast path's
    per-request cost must not scale with swarm size)."""
    m_use: dict[int, float] = {}
    c_use: dict[int, float] = {}
    for j, i in enumerate(path):
        i = int(i)
        m_use[i] = m_use.get(i, 0.0) + mem[j]
        c_use[i] = c_use.get(i, 0.0) + comp[j]
    return all(m_use[i] <= mem_left[i] + 1e-9
               and c_use[i] <= comp_left[i] + 1e-9 for i in m_use)


def _place_batch(placer: _SparsePlacer, sources: list[int],
                 device="cuda") -> list[tuple[np.ndarray | None, float]]:
    """Greedy sequential placement with the batched kernel fast path.

    Returns per-request ``(path, cost)`` — ``(None, inf)`` for rejections —
    with commits applied, such that decisions (admission AND paths) are
    bit-identical to calling ``placer.place(src)`` + bar check + commit per
    request in order.

    One sweep launch (:func:`repro_torch.core.batch_dp.solve_batch` on
    ``device``) precomputes
    the base-ladder-level DP of every *distinct* pending source against the
    current residuals.  A request may consume its precomputed row only while
    **certified**: the feasibility epoch is unchanged since the dispatch, so
    candidate selection is provably identical (selection reads the residuals
    only through the feasibility bits — unflipped — and the headroom
    tiebreak frozen per epoch: the :class:`_SparsePlacer` certification
    argument).  A certified row is accepted exactly when the sequential base
    stage would have been (finite cost, under the admission bar, joint
    residual fit); a non-accepted row — no finite path, too dear, fit
    failure — falls back to ``placer.place``'s full ladder against the
    current residuals, just as the sequential solve escalates.  When a
    commit *does* bump the epoch, the remaining requests are re-batched in
    one fresh dispatch rather than de-certifying one by one: per bump that
    costs |distinct sources| selections + one kernel call, where the
    sequential path pays a selection per request.

    Between dispatches the fast path never touches numpy: residual updates
    live in Python *shadow dicts* overlaid on ``placer.mem_left`` /
    ``comp_left`` (Python floats are IEEE doubles, so the per-layer
    subtraction fold is bit-identical to the numpy scalar loop in
    :meth:`_SparsePlacer.commit`), and the epoch-flip test is two ``bisect``
    calls per touched node against the sorted per-layer requirement
    thresholds — the count of thresholds ≤ residual determines that node's
    feasibility bits exactly, so equal counts on both resources certify "no
    bit flipped" without building the (M, |cols|) bit arrays.  A *possible*
    flip defers to ``placer.commit`` (after flushing the shadows), which
    performs the exact joint-bit comparison and the epoch bump.
    """
    from bisect import bisect_right

    from . import batch_dp

    counters = placer.counters
    mem_l, comp_l = placer.mem, placer.comp          # per-layer demands
    mem_left, comp_left = placer.mem_left, placer.comp_left
    mem_ts = sorted(float(x) for x in placer._mem_a)   # bit-pattern keys:
    comp_ts = sorted(float(x) for x in placer._comp_a)  # count(ts <= res)
    max_cost = placer.max_path_cost
    R = len(sources)
    out: list[tuple[np.ndarray | None, float]] = []
    i = 0
    top_m, top_c = None, None
    while i < R:
        # Batch the distinct sources still pending at the current residuals.
        uniq: list[int] = []
        row_of: dict[int, int] = {}
        for s in sources[i:]:
            if s not in row_of:
                row_of[s] = len(uniq)
                uniq.append(s)
        cand, valid = _sparse_select_batch(placer.spb,
                                           np.asarray(uniq, np.int64),
                                           placer.mem_left, placer.comp_left,
                                           placer._head, placer.consts,
                                           placer.k)
        c0 = batch_dp.compile_count()
        paths0, costs0 = batch_dp.solve_batch(
            placer.spb, placer.Ks, placer.compute_cost,
            np.asarray(uniq, np.int64), cand, valid, placer.consts,
            device=device)
        batch_epoch = placer._epoch
        if counters is not None:
            _, M, kk = cand.shape
            N = placer.spb.shape[0]
            counters.n_runs += len(uniq)
            counters.n_scanned += len(uniq) * (M - 1) * kk * kk
            counters.n_dense_equiv += len(uniq) * (M - 1) * N * N
            counters.n_jit_compiles += batch_dp.compile_count() - c0
        # Per-row precomputation shared by every request on the row: the
        # layer-by-layer demand sequence (the commit fold) and the per-node
        # aggregated demand in first-visit order (the _fits_joint fold).
        row_bad, row_layers, row_agg, row_out = [], [], [], []
        for q in range(len(uniq)):
            p = paths0[q]
            bad = (p is None or costs0[q] >= _BIG
                   or (max_cost is not None and costs0[q] > max_cost))
            row_bad.append(bad)
            if bad:
                row_layers.append(None)
                row_agg.append(None)
                row_out.append(None)
                continue
            pl = p.tolist()
            row_layers.append(list(zip(pl, mem_l, comp_l)))
            agg: dict[int, list[float]] = {}
            for j, node in enumerate(pl):
                a = agg.get(node)
                if a is None:
                    agg[node] = [mem_l[j], comp_l[j]]
                else:
                    a[0] += mem_l[j]
                    a[1] += comp_l[j]
            row_agg.append([(n, a[0], a[1]) for n, a in agg.items()])
            row_out.append((p, float(costs0[q])))
        if top_m is None:
            top_m, top_c = mem_ts[-1], comp_ts[-1]
        sh_m: dict[int, float] = {}      # shadow residuals (node → value);
        sh_c: dict[int, float] = {}      # truth overlay on mem/comp_left

        def flush():
            if sh_m:
                ks = list(sh_m)
                mem_left[ks] = [sh_m[n] for n in ks]
                comp_left[ks] = [sh_c[n] for n in ks]
                sh_m.clear()
                sh_c.clear()

        while i < R:
            if placer._epoch != batch_epoch:
                break                       # stale rows: re-batch the rest
            q = row_of[sources[i]]
            if not row_bad[q]:
                # Joint fit (== _fits_joint) against the shadowed residuals.
                olds = []
                ok = True
                for node, um, uc in row_agg[q]:
                    om = sh_m.get(node)
                    if om is None:
                        om = float(mem_left[node])
                        oc = float(comp_left[node])
                    else:
                        oc = sh_c[node]
                    olds.append((node, om, oc))
                    if um > om + 1e-9 or uc > oc + 1e-9:
                        ok = False
                        break
                if ok:
                    # Commit: per-layer subtraction in path order (the exact
                    # fold _SparsePlacer.commit performs).
                    cur_m = {n: om for n, om, _ in olds}
                    cur_c = {n: oc for n, _, oc in olds}
                    for node, mj, cj in row_layers[q]:
                        cur_m[node] -= mj
                        cur_c[node] -= cj
                    flip = False
                    for node, om, oc in olds:
                        nm, nc = cur_m[node], cur_c[node]
                        # Demands only shrink residuals: new ≥ top ⇒ old ≥
                        # top ⇒ every bit stays set — skip the bisects.
                        if ((nm < top_m and bisect_right(mem_ts, nm)
                                != bisect_right(mem_ts, om))
                                or (nc < top_c and bisect_right(comp_ts, nc)
                                    != bisect_right(comp_ts, oc))):
                            flip = True
                            break
                    if flip:
                        # A bit may have flipped: take the exact path.
                        flush()
                        placer.commit(paths0[q])
                    else:
                        sh_m.update(cur_m)
                        sh_c.update(cur_c)
                    if counters is not None:
                        counters.n_batched += 1
                    out.append(row_out[q])
                    i += 1
                    continue
            # Row rejected (no finite path / too dear / fit failure): the
            # sequential solve escalates the ladder from current residuals.
            flush()
            path, cost = placer.place(int(sources[i]))
            if path is not None and (max_cost is None or cost <= max_cost):
                placer.commit(path)
                out.append((path, cost))
            else:
                out.append((None, float("inf")))
            i += 1
        flush()
    return out


def _path_cost(spb: np.ndarray, K: list[float], Ks: float, src: int,
               path: np.ndarray,
               compute_cost: np.ndarray | None = None) -> float:
    """Objective contribution of one placed path under a given spb — the same
    quantity the DP minimizes, recomputable after the rates drift."""
    cost = 0.0 if path[0] == src else Ks * spb[src, int(path[0])]
    for j in range(len(path) - 1):
        if path[j + 1] != path[j]:
            cost += K[j] * spb[int(path[j]), int(path[j + 1])]
    if compute_cost is not None:
        for j, i in enumerate(path):
            cost += compute_cost[j, int(i)]
    return float(cost)


def improvement_bound(prob: Problem, assign: np.ndarray,
                      admitted: np.ndarray, *, sparse_k: int | None = None,
                      include_compute: bool = False
                      ) -> tuple[np.ndarray, np.ndarray]:
    """Per-request slack-capacity DP lower bound on re-placement cost.

    The epoch keep rule re-places *touched* requests only; this quantifies
    what that conservatism costs.  For each admitted request the bound
    solves the single-request lattice DP against the request's **slack
    capacity** — the residual after every admitted reservation, plus the
    request's own reservation released (what a re-place of just this
    request could actually use).  The per-layer-feasibility relaxation
    means the dense DP value lower-bounds any feasible re-placement; the
    k-candidate pruned kernel (``sparse_k``; :func:`default_sparse_k` when
    None, exact at ``k ≥ N``) may miss the optimum's nodes, so the bound is
    clipped at the current path cost — drift is then never negative, only
    possibly under-reported.

    Returns ``(bound_s, current_s)`` over plan rows; non-admitted rows are
    zero.  :func:`placement_drift` is the difference the epoch hook logs.
    """
    spb = prob.transfer_cost()
    K = prob.profile.output_vector()
    Ks = prob.profile.input_bytes
    mem = prob.profile.memory_vector()
    comp = prob.profile.compute_vector()
    mem_a = np.asarray(mem, float)
    comp_a = np.asarray(comp, float)
    compute_cost = None
    if include_compute and prob.compute_speed is not None:
        compute_cost = (np.asarray(comp)[:, None]
                        / prob.compute_speed[None, :]) * prob.horizon()

    rows = [r for r in range(prob.n_requests) if admitted[r]]
    mem_left = prob.mem_cap.astype(float).copy()
    comp_left = prob.comp_cap.astype(float).copy()
    for r in rows:
        np.subtract.at(mem_left, assign[r], mem_a)
        np.subtract.at(comp_left, assign[r], comp_a)

    k = sparse_k if sparse_k is not None else default_sparse_k(prob.n_nodes)
    consts = _sparse_consts(spb, K, mem, comp)
    bound = np.zeros(prob.n_requests)
    current = np.zeros(prob.n_requests)
    for r in rows:
        path = assign[r]
        src = int(prob.sources[r])
        slack_m = mem_left.copy()
        slack_c = comp_left.copy()
        np.add.at(slack_m, path, mem_a)       # release own reservation
        np.add.at(slack_c, path, comp_a)
        cur = _path_cost(spb, K, Ks, src, path, compute_cost)
        _, cost = _dp_single_request_sparse(
            spb, K, Ks, src, mem, comp, slack_m, slack_c, compute_cost,
            k, consts=consts)
        current[r] = cur
        bound[r] = min(cost, cur)
    return bound, current


def placement_drift(prob: Problem, assign: np.ndarray, admitted: np.ndarray,
                    *, sparse_k: int | None = None,
                    include_compute: bool = False) -> np.ndarray:
    """(R,) how far each kept placement drifted from its slack-capacity
    optimum: current path cost − :func:`improvement_bound` (≥ 0; zero for
    non-admitted rows and for requests still at their bound)."""
    bound, current = improvement_bound(prob, assign, admitted,
                                       sparse_k=sparse_k,
                                       include_compute=include_compute)
    return np.maximum(current - bound, 0.0)


def _solve_dp(prob: Problem, *, include_compute: bool,
              max_path_cost: float | None = None,
              sparse_k: int | None = None, batch_solve: bool = False,
              capacity_repair: str = "halve", device="cuda"
              ) -> tuple[np.ndarray, float, np.ndarray, "ResolveStats | None"]:
    """Sequential greedy-DP: requests placed one at a time (exact per request,
    greedy across requests).  Returns (assign, total_comm_latency, admitted,
    stats); rejected rows carry the ``-1`` sentinel.  ``stats`` is None for
    the dense scan and a :class:`ResolveStats` carrying the pruning telemetry
    (k, escalations, dense fallbacks, pruned fraction) when ``sparse_k`` is
    set.

    ``max_path_cost`` rejects a request whose cheapest feasible path still
    costs more — i.e. it would ride a disconnected (``_BIG``-priced) link.
    The paper's admission semantics: serve over a dead link is an outage, so
    such requests are rejected rather than placed (§IV-A / Fig. 13)."""
    t0 = time.perf_counter()
    R, N, M = prob.n_requests, prob.n_nodes, prob.n_layers
    spb = prob.transfer_cost()
    K = prob.profile.output_vector()
    mem = prob.profile.memory_vector()
    comp = prob.profile.compute_vector()
    compute_cost = None
    if include_compute and prob.compute_speed is not None:
        per_layer = np.array(comp)[:, None] / prob.compute_speed[None, :]
        compute_cost = per_layer * prob.horizon()
    mem_left = prob.mem_cap.astype(float).copy()
    comp_left = prob.comp_cap.astype(float).copy()
    assign = np.full((R, M), -1, np.int64)
    admitted = np.zeros(R, bool)
    total = 0.0
    counters = _SparseCounters() if sparse_k is not None else None
    placer = None
    if sparse_k is not None:
        placer = _SparsePlacer(spb, K, prob.profile.input_bytes, mem, comp,
                               mem_left, comp_left, compute_cost,
                               k=sparse_k, max_path_cost=max_path_cost,
                               counters=counters,
                               capacity_repair=capacity_repair)
    if placer is not None and batch_solve and R > 0:
        for r, (path, cost) in enumerate(
                _place_batch(placer, [int(s) for s in prob.sources], device)):
            if path is None:
                continue
            assign[r] = path
            admitted[r] = True
            total += cost
    else:
        for r in range(R):
            if placer is not None:
                path, cost = placer.place(int(prob.sources[r]))
            else:
                path, cost = _place_request(
                    spb, K, prob.profile.input_bytes, int(prob.sources[r]),
                    mem, comp, mem_left, comp_left, compute_cost,
                    capacity_repair=capacity_repair)
            if path is None or (max_path_cost is not None
                                and cost > max_path_cost):
                admitted[r] = False
                continue
            if placer is not None:
                placer.commit(path)
            else:
                for j, i in enumerate(path):
                    mem_left[i] -= mem[j]
                    comp_left[i] -= comp[j]
            assign[r] = path
            admitted[r] = True
            total += cost
    stats = None
    if counters is not None:
        stats = ResolveStats(0, R, N, True, time.perf_counter() - t0,
                             k=int(sparse_k),
                             n_dense_fallback=counters.n_dense_fallback,
                             n_escalations=counters.n_escalations,
                             pruned_fraction=counters.pruned_fraction,
                             n_batched=counters.n_batched,
                             n_jit_compiles=counters.n_jit_compiles)
    return assign, total, admitted, stats


# ---------------------------------------------------------------------------
# Public entry point with admission control
# ---------------------------------------------------------------------------

def solve_ould(prob: Problem, *, solver: Solver = "ilp",
               include_compute: bool = False, tight: bool = True,
               gamma_relaxed: bool = True, time_limit: float | None = None,
               mip_rel_gap: float = 1e-6,
               constraint_cache: dict | None = None,
               max_path_cost: float | None = None,
               sparse_k: int | None = None,
               batch_solve: bool = False,
               capacity_repair: str = "halve", device="cuda") -> Solution:
    """Solve an OULD / OULD-MP instance.

    Legacy entry point (kept for one release): new code goes through the
    planner registry — ``get_planner("ould-ilp" | "ould-dp" | "ould-mp")``
    — which wraps this engine with view checking and provenance.

    When the full request set is infeasible (system over capacity), requests
    are shed from the tail until feasible — the paper's 'additional incoming
    requests are rejected' behaviour (§IV-A, shared-data plateaus).  Rejected
    rows of ``assign`` carry the ``-1`` sentinel and must never be read.

    ``constraint_cache`` (a caller-owned dict) memoizes the sparse ILP
    constraint matrix across repeated solves of same-shaped instances —
    topology drift only changes the objective coefficients.

    ``sparse_k`` is the per-layer candidate budget of the ``"dp-sparse"``
    solver (None ⇒ :func:`default_sparse_k`); ignored by the other solvers.
    ``batch_solve=True`` runs the ``"dp-sparse"`` request loop through the
    batched sweep (:mod:`repro_torch.core.batch_dp`) on ``device`` — one
    launch per solve, decisions bit-identical to the sequential pass; ignored
    by the other solvers, and ``device`` is read only then (``"cuda"``, the
    default, launches the hand-written kernel and raises without a card;
    ``"cpu"`` runs its plain version).
    """
    t0 = time.perf_counter()
    R = prob.n_requests
    if solver in ("dp", "dp-sparse"):
        k = None
        if solver == "dp-sparse":
            k = sparse_k if sparse_k is not None else default_sparse_k(prob.n_nodes)
        assign, obj, admitted, stats = _solve_dp(
            prob, include_compute=include_compute,
            max_path_cost=max_path_cost, sparse_k=k,
            batch_solve=batch_solve, capacity_repair=capacity_repair,
            device=device)
        n_rej = int(prob.n_requests - admitted.sum())
        status = "feasible" if n_rej == 0 else f"rejected:{n_rej}"
        return Solution(assign, obj, status, time.perf_counter() - t0,
                        admitted, solver=solver, dp_stats=stats)

    admitted = np.ones(R, bool)
    n_try = R
    while n_try >= 1:
        sub = Problem(prob.profile, prob.mem_cap, prob.comp_cap, prob.rates,
                      prob.sources[:n_try], prob.compute_speed,
                      prob.rate_unit_bytes)
        assign, obj, status = _solve_ilp_once(
            sub, include_compute=include_compute, tight=tight,
            gamma_relaxed=gamma_relaxed, time_limit=time_limit,
            mip_rel_gap=mip_rel_gap, cache=constraint_cache)
        if assign is not None:
            full = np.full((R, prob.n_layers), -1, np.int64)
            full[:n_try] = assign
            admitted[:] = False
            admitted[:n_try] = True
            st = "optimal" if n_try == R else f"rejected:{R - n_try}"
            return Solution(full, obj, st, time.perf_counter() - t0, admitted)
        n_try -= 1
    return Solution(np.full((R, prob.n_layers), -1, np.int64), float("inf"),
                    "infeasible", time.perf_counter() - t0,
                    np.zeros(R, bool))


# ---------------------------------------------------------------------------
# Incremental (warm-started) epoch re-solves
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ResolveStats:
    """What one solve actually did (warm re-solve and/or sparse DP)."""

    n_kept: int            # requests whose placement survived unchanged
    n_replaced: int        # requests re-placed (path touched a changed node)
    n_changed_nodes: int   # nodes incident to a materially changed link
    cold: bool             # True when the solve fell back to a full solve
    solve_time_s: float
    n_repriced: int = -1   # transfer-cost entries re-priced (-1: full price)
    # Sparse k-candidate DP telemetry (k == 0 ⇒ the dense kernel ran).
    k: int = 0             # per-layer candidate budget of the pruned DP
    n_dense_fallback: int = 0   # requests that hit the dense last resort
    n_escalations: int = 0      # k-doubling retries across requests
    pruned_fraction: float = 0.0  # share of N² transition scans avoided
    # Batched-kernel fast path (batch_solve=True): requests whose placement
    # came certified out of the single sweep launch (the rest fell back
    # to the sequential ladder).
    n_batched: int = 0
    # Sweep launches at a padded shape never launched before in this process
    # (batch_dp.compile_count).  When > 0, ``solve_time_s`` includes a first
    # launch's cost (allocation at the new shape; the kernels' nvcc build on
    # the very first) and must not be read as steady-state solve cost.
    n_jit_compiles: int = 0

    @property
    def cold_dispatch(self) -> bool:
        """True when the wall time above paid for a first launch at a shape."""
        return self.n_jit_compiles > 0


class IncrementalSolver:
    """Warm-started repeated OULD solves over a drifting topology.

    The swarm serving simulator re-solves placement every epoch; a cold solve
    repeats three kinds of work this class caches instead:

    1. **Constraint structure** — the ILP's sparse constraint matrix (Eq. 4–6,
       11) depends only on the instance shape and capacities, never on the
       rates, so it is memoized (``constraint_cache``) and only the objective
       vector is rebuilt per epoch (:func:`_build_objective`).
    2. **Previous epoch's assignment** — for the DP path, requests whose
       placement does not touch any *changed* node keep their paths and
       capacity reservations verbatim; only requests incident to a changed
       link (rate drift beyond ``rel_change``, connect/disconnect flips, node
       failure/rejoin) are re-placed against the residual capacity.
    3. **Request identity** — callers tag requests with stable ids so streams
       that persist across epochs inherit their placement; departed ids
       release capacity implicitly, new ids are placed fresh, and previously
       rejected ids retry admission every epoch.

    The warm re-solve reproduces the cold greedy-DP objective exactly when
    every request is re-placed (same order, same residual-capacity sequence),
    which is the invariant the tests pin down; when few links change it skips
    nearly all DP work — the ≥2× epoch-re-solve speedup the benchmark
    measures.  Capacities and the profile are fixed per instance; per-epoch
    node outages are expressed via the ``alive`` mask.
    """

    def __init__(self, profile: ModelProfile, mem_cap: np.ndarray,
                 comp_cap: np.ndarray,
                 compute_speed: np.ndarray | None = None, *,
                 solver: Solver = "dp", include_compute: bool = False,
                 rel_change: float = 0.05, price_rel_change: float = 0.0,
                 max_path_cost: float | None = None,
                 rate_unit_bytes: float = 1 / 8.0,
                 sparse_k: int | None = None, batch_solve: bool = False,
                 capacity_repair: str = "halve", device="cuda",
                 **ilp_kw):
        self.profile = profile
        self.mem_cap = np.asarray(mem_cap, float)
        self.comp_cap = np.asarray(comp_cap, float)
        self.compute_speed = compute_speed
        self.solver: Solver = solver
        self.include_compute = include_compute
        self.rel_change = rel_change
        # Candidate budget when solver == "dp-sparse" (None ⇒ default √N
        # rule); the warm path re-places touched requests with the SAME
        # pruned kernel + fallback ladder as the cold sparse solve.
        self.sparse_k = sparse_k
        # Epoch re-solves route the touched-request loop through the batched
        # sweep on ``device`` (decisions unchanged; dp-sparse only).
        self.batch_solve = batch_solve
        self.device = device
        # Over-capacity shrink rule for the repair loop ("halve" | "gentle").
        self.capacity_repair = capacity_repair
        # Entry re-pricing threshold for incremental_transfer_cost; 0.0 keeps
        # the cost matrix exact (only entries with *any* drift recomputed).
        # Must not exceed rel_change: _changed_nodes reads the incrementally
        # priced spb, so pricing staleness above the placement band would
        # silently disable the re-place trigger for sub-band drift.
        if price_rel_change > rel_change:
            raise ValueError(
                f"price_rel_change ({price_rel_change}) must be ≤ "
                f"rel_change ({rel_change}); coarser pricing would hide "
                f"link drift from the re-place trigger")
        self.price_rel_change = price_rel_change
        self.max_path_cost = max_path_cost
        self.rate_unit_bytes = rate_unit_bytes
        self.ilp_kw = ilp_kw
        self.constraint_cache: dict = {}
        self._paths: dict[int, np.ndarray] = {}   # request id → kept path
        self._spb: np.ndarray | None = None       # previous horizon-summed spb
        self._alive: np.ndarray | None = None
        self._price_rates: np.ndarray | None = None  # rates rows last priced at
        self._price_spb: np.ndarray | None = None    # matching cost matrix

    # -- problem assembly ---------------------------------------------------

    def _problem(self, rates: np.ndarray, sources: np.ndarray,
                 alive: np.ndarray | None) -> Problem:
        mem, comp = self.mem_cap, self.comp_cap
        if alive is not None and not alive.all():
            mem = np.where(alive, mem, 0.0)
            comp = np.where(alive, comp, 0.0)
            # A dead node's links are down too (ρ = 0 ⇔ disconnected), so a
            # request *sourced* at it cannot be admitted over phantom links —
            # the alive mask alone must be sufficient for callers.
            rates = rates.copy()
            if rates.ndim == 3:
                rates[:, ~alive, :] = 0.0
                rates[:, :, ~alive] = 0.0
            else:
                rates[~alive, :] = 0.0
                rates[:, ~alive] = 0.0
        return Problem(self.profile, mem, comp, rates,
                       np.asarray(sources, np.int64), self.compute_speed,
                       self.rate_unit_bytes)

    def _changed_nodes(self, spb: np.ndarray,
                       alive: np.ndarray | None) -> np.ndarray:
        """(N,) bool — nodes incident to a link whose seconds/byte moved by
        more than ``rel_change`` (covers connect/disconnect flips: the _BIG
        sentinel dwarfs any real value), or whose alive flag flipped.

        Drift is measured against the *reference* spb — the value each link
        had when its placements were last re-priced — not merely the previous
        epoch, so a link fading slowly (below the per-epoch threshold) still
        accumulates drift and eventually triggers a re-place.  This bounds
        the staleness of every kept placement to one ``rel_change`` band per
        link instead of letting it compound unboundedly."""
        n = spb.shape[0]
        if self._spb is None or self._spb.shape != spb.shape:
            return np.ones(n, bool)
        a, b = self._spb, spb
        denom = np.maximum(np.minimum(a, b), 1e-30)
        link_changed = np.abs(a - b) > self.rel_change * denom
        mask = link_changed.any(axis=0) | link_changed.any(axis=1)
        prev_alive = self._alive if self._alive is not None else np.ones(n, bool)
        cur_alive = alive if alive is not None else np.ones(n, bool)
        return mask | (prev_alive != cur_alive)

    def _remember(self, spb: np.ndarray, alive: np.ndarray | None,
                  request_ids, assign: np.ndarray, admitted: np.ndarray,
                  changed: np.ndarray | None = None) -> None:
        if changed is None or self._spb is None or self._spb.shape != spb.shape:
            self._spb = spb.copy()
        else:
            # Advance the reference only for links incident to a changed node
            # (their placements were just re-priced); untouched links keep
            # their old reference so slow drift accumulates.
            touched = changed[:, None] | changed[None, :]
            self._spb = np.where(touched, spb, self._spb)
        self._alive = (np.asarray(alive, bool).copy()
                       if alive is not None else np.ones(spb.shape[0], bool))
        self._paths = {int(rid): assign[r].copy()
                       for r, rid in enumerate(request_ids) if admitted[r]}

    def _priced_spb(self, prob: Problem) -> tuple[np.ndarray, int]:
        """Transfer-cost matrix via changed-entry re-pricing when a reference
        exists (ROADMAP: incremental ``transfer_cost``).  Returns the matrix
        and how many entries were re-priced (-1 ⇒ full pricing)."""
        rates = prob.rates
        if (self._price_spb is None or self._price_rates is None
                or self._price_rates.shape != rates.shape):
            spb = prob.transfer_cost()
            self._price_rates = np.asarray(rates, float).copy()
            self._price_spb = spb.copy()
            return spb, -1
        spb, repriced = incremental_transfer_cost(
            rates, self._price_rates, self._price_spb,
            rel_change=self.price_rel_change,
            rate_unit_bytes=prob.rate_unit_bytes)
        n = int(repriced.sum())
        if n:
            # Advance the pricing reference only for re-priced entries;
            # entries drifting below the threshold keep their old reference
            # so slow drift accumulates toward a re-price, never compounds.
            self._price_rates[..., repriced] = rates[..., repriced]
            self._price_spb = spb.copy()
        return spb, n

    # -- entry points -------------------------------------------------------

    def solve(self, rates: np.ndarray, sources: np.ndarray,
              request_ids=None,
              alive: np.ndarray | None = None) -> tuple[Solution, ResolveStats]:
        """Cold solve (still reusing the ILP constraint cache); primes the
        warm state for subsequent :meth:`resolve` calls."""
        t0 = time.perf_counter()
        prob = self._problem(rates, sources, alive)
        if request_ids is None:
            request_ids = list(range(prob.n_requests))
        sol = solve_ould(prob, solver=self.solver,
                         include_compute=self.include_compute,
                         constraint_cache=self.constraint_cache,
                         max_path_cost=self.max_path_cost,
                         sparse_k=self.sparse_k,
                         batch_solve=self.batch_solve,
                         capacity_repair=self.capacity_repair,
                         device=self.device, **self.ilp_kw)
        spb, n_repriced = self._priced_spb(prob)
        self._remember(spb, alive, request_ids, sol.assign, sol.admitted)
        dt = time.perf_counter() - t0
        ds = sol.dp_stats
        return sol, ResolveStats(
            0, prob.n_requests, prob.n_nodes, True, dt, n_repriced,
            k=ds.k if ds else 0,
            n_dense_fallback=ds.n_dense_fallback if ds else 0,
            n_escalations=ds.n_escalations if ds else 0,
            pruned_fraction=ds.pruned_fraction if ds else 0.0,
            n_batched=ds.n_batched if ds else 0,
            n_jit_compiles=ds.n_jit_compiles if ds else 0)

    def resolve(self, rates: np.ndarray, sources: np.ndarray,
                request_ids=None,
                alive: np.ndarray | None = None) -> tuple[Solution, ResolveStats]:
        """Warm epoch re-solve: keep unaffected placements, re-place the rest.

        Falls back to a (constraint-cached) cold solve on the first call and
        in ILP mode, where scipy's MILP cannot consume an incumbent.
        """
        t0 = time.perf_counter()
        prob = self._problem(rates, sources, alive)
        R, M = prob.n_requests, prob.n_layers
        if request_ids is None:
            request_ids = list(range(R))
        if self.solver not in ("dp", "dp-sparse") or self._spb is None:
            return self.solve(rates, sources, request_ids, alive)

        spb, n_repriced = self._priced_spb(prob)
        changed = self._changed_nodes(spb, alive)
        # A departed stream frees its nodes' reservations — a capacity event
        # as real as a link change: placements (and sources) on those nodes
        # get a chance to re-pack onto the freed capacity.
        live_ids = {int(rid) for rid in request_ids}
        for rid, prev in self._paths.items():
            if rid not in live_ids:
                changed[prev] = True
        K = self.profile.output_vector()
        Ks = self.profile.input_bytes
        mem = self.profile.memory_vector()
        comp = self.profile.compute_vector()
        compute_cost = None
        if self.include_compute and self.compute_speed is not None:
            per_layer = np.array(comp)[:, None] / self.compute_speed[None, :]
            compute_cost = per_layer * prob.horizon()

        mem_left = prob.mem_cap.astype(float).copy()
        comp_left = prob.comp_cap.astype(float).copy()
        assign = np.full((R, M), -1, np.int64)
        admitted = np.zeros(R, bool)
        todo: list[int] = []
        for r, rid in enumerate(request_ids):
            prev = self._paths.get(int(rid))
            src = int(prob.sources[r])
            if prev is not None and not changed[prev].any() and not changed[src]:
                for j, i in enumerate(prev):          # keep: reserve capacity
                    mem_left[i] -= mem[j]
                    comp_left[i] -= comp[j]
                assign[r] = prev
                admitted[r] = True
            else:
                todo.append(r)
        n_kept = R - len(todo)
        sparse = self.solver == "dp-sparse"
        counters = _SparseCounters() if sparse else None
        k = (self.sparse_k if self.sparse_k is not None
             else default_sparse_k(prob.n_nodes)) if sparse else 0
        placer = None
        if sparse:
            placer = _SparsePlacer(spb, K, Ks, mem, comp, mem_left,
                                   comp_left, compute_cost, k=k,
                                   max_path_cost=self.max_path_cost,
                                   counters=counters,
                                   capacity_repair=self.capacity_repair)
        if placer is not None and self.batch_solve and todo:
            placed = _place_batch(placer,
                                  [int(prob.sources[r]) for r in todo],
                                  self.device)
            for r, (path, cost) in zip(todo, placed):
                if path is None:
                    continue
                assign[r] = path
                admitted[r] = True
        else:
            for r in todo:
                if placer is not None:
                    path, cost = placer.place(int(prob.sources[r]))
                else:
                    path, cost = _place_request(spb, K, Ks,
                                                int(prob.sources[r]),
                                                mem, comp, mem_left,
                                                comp_left, compute_cost,
                                                capacity_repair=self.capacity_repair)
                if path is None or (self.max_path_cost is not None
                                    and cost > self.max_path_cost):
                    continue
                if placer is not None:
                    placer.commit(path)
                else:
                    for j, i in enumerate(path):
                        mem_left[i] -= mem[j]
                        comp_left[i] -= comp[j]
                assign[r] = path
                admitted[r] = True
        # Objective re-priced for EVERY admitted request — kept paths are not
        # assumed to still cost what they used to.  The spb is exact at
        # price_rel_change=0 (the default); otherwise entries may lag the
        # true rates by at most one price band (≤ rel_change by contract).
        total = sum(_path_cost(spb, K, Ks, int(prob.sources[r]), assign[r],
                               compute_cost)
                    for r in range(R) if admitted[r])
        self._remember(spb, alive, request_ids, assign, admitted, changed)
        dt = time.perf_counter() - t0
        n_rej = int(R - admitted.sum())
        status = "feasible" if n_rej == 0 else f"rejected:{n_rej}"
        sol = Solution(assign, float(total), status, dt, admitted,
                       solver="dp-sparse-warm" if sparse else "dp-warm")
        return sol, ResolveStats(
            n_kept, len(todo), int(changed.sum()), False, dt, n_repriced,
            k=k,
            n_dense_fallback=counters.n_dense_fallback if counters else 0,
            n_escalations=counters.n_escalations if counters else 0,
            pruned_fraction=counters.pruned_fraction if counters else 0.0,
            n_batched=counters.n_batched if counters else 0,
            n_jit_compiles=counters.n_jit_compiles if counters else 0)
