"""Heuristic baselines from the paper (§IV-A, Fig. 8).

* **Nearest** — the node currently holding the computation greedily executes
  layers until its residual memory/compute cannot fit the next layer, then
  hands the intermediate output to the *nearest* neighbor with enough
  residual memory for at least the next layer.
* **HRM** (High Residual Memory) — hand off to the neighbor with the highest
  residual memory.
* **Nearest-HRM** — among the nearest feasible neighbors (closest tercile),
  pick the one with the highest residual memory.

All three are single-configuration heuristics ("designed for a single network
configuration obtained from a fixed time step"), so they consume a (N, N)
rate snapshot, never the MP horizon.
"""

from __future__ import annotations

import time
from typing import Callable, Literal

import numpy as np

from .ould import Problem, Solution

Heuristic = Literal["nearest", "hrm", "nearest_hrm"]


def _pick_nearest(cands: np.ndarray, dist: np.ndarray, mem_left: np.ndarray) -> int:
    return int(cands[np.argmin(dist[cands])])


def _pick_hrm(cands: np.ndarray, dist: np.ndarray, mem_left: np.ndarray) -> int:
    return int(cands[np.argmax(mem_left[cands])])


def _pick_nearest_hrm(cands: np.ndarray, dist: np.ndarray,
                      mem_left: np.ndarray) -> int:
    order = cands[np.argsort(dist[cands])]
    near = order[: max(1, int(np.ceil(len(order) / 3)))]
    return int(near[np.argmax(mem_left[near])])


_PICKERS: dict[str, Callable[..., int]] = {
    "nearest": _pick_nearest,
    "hrm": _pick_hrm,
    "nearest_hrm": _pick_nearest_hrm,
}


def solve_heuristic(prob: Problem, kind: Heuristic) -> Solution:
    """Greedy hand-off placement (legacy entry point — new code uses
    ``get_planner("nearest" | "hrm" | "nearest-hrm")``).

    'Distance' is derived from the rate matrix
    (higher rate ⇔ nearer — §III-C: 'lower data rates correspond to distant
    UAVs and vice-versa'), so the heuristics see exactly the information a
    real swarm would estimate from its links."""
    t0 = time.perf_counter()
    rates = prob.rates if prob.rates.ndim == 2 else prob.rates[0]
    with np.errstate(divide="ignore"):
        dist = np.where(rates > 0, 1.0 / np.maximum(rates, 1e-30), np.inf)
    np.fill_diagonal(dist, 0.0)
    spb = prob.transfer_cost()

    N, M, R = prob.n_nodes, prob.n_layers, prob.n_requests
    mem = prob.profile.memory_vector()
    comp = prob.profile.compute_vector()
    K = prob.profile.output_vector()
    mem_left = prob.mem_cap.astype(float).copy()
    comp_left = prob.comp_cap.astype(float).copy()
    pick = _PICKERS[kind]

    # Rejected rows keep the -1 sentinel: a rejected request must never be
    # mistaken for "all layers on node 0" (evaluate() enforces this).
    assign = np.full((R, M), -1, np.int64)
    admitted = np.ones(R, bool)
    total = 0.0
    for r in range(R):
        cur = int(prob.sources[r])
        placed: list[int] = []
        lat = 0.0
        ok = True
        for j in range(M):
            if mem_left[cur] >= mem[j] and comp_left[cur] >= comp[j]:
                nxt = cur
            else:
                cands = np.array([
                    k for k in range(N)
                    if k != cur and np.isfinite(dist[cur, k])
                    and mem_left[k] >= mem[j] and comp_left[k] >= comp[j]
                ])
                if cands.size == 0:
                    ok = False
                    break
                nxt = pick(cands, dist[cur], mem_left)
                lat += (prob.profile.input_bytes if j == 0 else K[j - 1]) * spb[cur, nxt]
            mem_left[nxt] -= mem[j]
            comp_left[nxt] -= comp[j]
            placed.append(nxt)
            cur = nxt
        if not ok:
            admitted[r] = False
            # roll back partial reservations
            for j, i in enumerate(placed):
                mem_left[i] += mem[j]
                comp_left[i] += comp[j]
            continue
        assign[r] = placed
        total += lat
    status = "feasible" if admitted.all() else f"rejected:{int((~admitted).sum())}"
    return Solution(assign, total, status, time.perf_counter() - t0, admitted,
                    solver=kind)
