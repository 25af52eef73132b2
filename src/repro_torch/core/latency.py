"""Placement evaluation — the quantities the paper plots.

Given a placement (R, M) → node, reproduce the paper's two headline metrics
(§IV): *average end-to-end latency per request* split into communication and
computation components (Fig. 4a/5/6 solid vs dashed lines), and *shared data*
— total bytes exchanged between participants (Fig. 4b/7).  Also validates
capacity feasibility (Eq. 4/5), which the tests use as an invariant.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .ould import Problem, Solution


@dataclasses.dataclass(frozen=True)
class Evaluation:
    comm_latency_s: float        # paper objective value (per horizon)
    comp_latency_s: float        # Σ c_j / speed_i over placed layers
    shared_bytes: float          # total inter-node traffic (incl. source img)
    per_request_s: np.ndarray    # (R,) end-to-end latency per admitted request
    feasible: bool
    n_admitted: int

    @property
    def total_latency_s(self) -> float:
        return self.comm_latency_s + self.comp_latency_s

    @property
    def avg_latency_per_request(self) -> float:
        if self.n_admitted == 0:
            return float("inf")
        return float(self.per_request_s[np.isfinite(self.per_request_s)].sum()
                     / self.n_admitted)


def evaluate(prob: Problem, sol: Solution) -> Evaluation:
    spb = prob.transfer_cost()
    K = prob.profile.output_vector()
    Ks = prob.profile.input_bytes
    mem = prob.profile.memory_vector()
    comp = prob.profile.compute_vector()
    R, M, N = prob.n_requests, prob.n_layers, prob.n_nodes

    speed = prob.compute_speed
    if speed is None:
        speed = np.full(N, np.inf)

    mem_use = np.zeros(N)
    comp_use = np.zeros(N)
    comm_total = 0.0
    comp_total = 0.0
    shared = 0.0
    per_req = np.full(R, np.inf)
    for r in range(R):
        if not sol.admitted[r]:
            # Non-admitted rows are never read: they carry the -1 sentinel.
            continue
        path = sol.assign[r]
        assert (path >= 0).all() and (path < N).all(), \
            f"request {r} marked admitted but its row holds the rejection " \
            f"sentinel / an invalid node id: {path}"
        src = int(prob.sources[r])
        comm = 0.0
        cmp_ = 0.0
        if path[0] != src:
            comm += Ks * spb[src, path[0]]
            shared += Ks
        for j in range(M):
            i = int(path[j])
            mem_use[i] += mem[j]
            comp_use[i] += comp[j]
            cmp_ += comp[j] / speed[i] * prob.horizon()
            if j < M - 1 and path[j + 1] != i:
                comm += K[j] * spb[i, int(path[j + 1])]
                shared += K[j]
        per_req[r] = comm + cmp_
        comm_total += comm
        comp_total += cmp_
    feasible = bool(np.all(mem_use <= prob.mem_cap + 1e-6)
                    and np.all(comp_use <= prob.comp_cap + 1e-6))
    return Evaluation(comm_total, comp_total, shared, per_req, feasible,
                      int(sol.admitted.sum()))
