"""Serving runtime: batched prefill + greedy decode, and OULD request
admission over a serving pool (port of ``repro/runtime/serve.py``).

``Server`` is the torch rewrite of the reference's jitted loop.
``AdmissionController`` and ``schedule_requests`` are copies of the
reference's: host code over the port's planners, whose ``device`` option
(``planner_options``) says where a ``batch_solve=True`` solve runs its sweep.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core import Problem, ResolveStats
from ..core.latency import evaluate
from ..core.planner import Plan, Planner, TopologyView, get_planner, make_view
from ..core.profiles import lm_profile
from ..device import resolve_device
from ..models.transformer import check_config
from ..obs import ADMISSION, NULL_TRACER, SOLVER
from . import steps as steps_mod


@dataclasses.dataclass
class ServeConfig:
    max_len: int = 128
    batch_size: int = 4


class Server:
    """Minimal production-shaped server: prefill -> decode loop.

    ``device`` defaults to the card and must be where ``params`` live.  The
    KV cache is updated in place by each decode step (the reference donates
    it to its jitted step instead)."""

    def __init__(self, cfg: ModelConfig, params: dict, scfg: ServeConfig, *,
                 device: str | torch.device = "cuda"):
        check_config(cfg)
        self.device = resolve_device(device)
        where = params["embed"]["table"].device
        if where.type != self.device.type:
            raise ValueError(f"params on {where}, server on {self.device}")
        self.cfg = cfg
        self.scfg = scfg
        self.params = params
        self._prefill = steps_mod.make_prefill_step(cfg, max_len=scfg.max_len)
        self._decode = steps_mod.make_decode_step(cfg)

    @torch.inference_mode()
    def generate(self, tokens: np.ndarray, steps: int) -> np.ndarray:
        """tokens: (B, S) prompt -> (B, steps) generated ids (greedy).

        The first id is the argmax of the prefill logits; each loop step
        appends the current id before decoding it, so ``steps`` decode calls
        run and the last one's argmax is discarded, as in the reference."""
        B, S = tokens.shape
        if S + steps > self.scfg.max_len:
            raise ValueError(f"prompt {S} + steps {steps} > max_len {self.scfg.max_len}")
        prompt = torch.as_tensor(np.asarray(tokens, np.int64), device=self.device)
        logits, cache = self._prefill(self.params, {"tokens": prompt})
        out = []
        pos = S
        tok = torch.argmax(logits, -1)[:, None]
        for _ in range(steps):
            out.append(tok[:, 0])
            logits, cache = self._decode(self.params, tok, cache, pos)
            tok = torch.argmax(logits, -1)[:, None]
            pos += 1
        return torch.stack(out, dim=1).cpu().numpy().astype(np.int32)


# ---------------------------------------------------------------------------
# OULD request admission/placement over a serving pool
# ---------------------------------------------------------------------------

class AdmissionController:
    """Epoch-based admission + placement for a serving pool.

    Strategy-agnostic: wraps any registered :class:`~repro_torch.core.planner.
    Planner` (by name or instance) and feeds it one :class:`TopologyView`
    per admission round.  Stateful planners (``incremental``, warm
    ``ould-mp``) keep placements of persistent streams across rounds and
    cache constraint structure; stateless planners just get called.  One
    controller instance == one pool; per-round outages go through the
    view's ``alive`` mask.
    """

    def __init__(self, planner: Planner | str = "incremental",
                 tracer=None, queue_model: str = "bottleneck",
                 **planner_options):
        self.planner: Planner = (get_planner(planner, **planner_options)
                                 if isinstance(planner, str) else planner)
        # Which queueing substrate the backlog vector prices ("bottleneck":
        # (N,) per-node waits, gate at the heaviest stage's host; "perhop":
        # (N+N²,) per-server waits over compute nodes and directed links,
        # gate on the *summed* backlog along the whole candidate path).
        if queue_model not in ("bottleneck", "perhop"):
            raise ValueError(f"unknown queue_model {queue_model!r}")
        self.queue_model = queue_model
        # Observability (repro_torch.obs): solver spans + admission verdicts are
        # emitted per round when a real Tracer is attached; the NullTracer
        # default keeps this path free.
        self.tracer = tracer if tracer is not None else NULL_TRACER
        # Per-round solve stats only — a Plan pins its bound Problem (rate
        # matrices), which must not accumulate over a long-running pool.
        self.history: list[ResolveStats] = []
        # Streams the queue-depth bar turned away last round (queue-aware
        # admission only; 0 otherwise).
        self.last_queue_rejected: int = 0

    def admit(self, problem: Problem, view: TopologyView | np.ndarray,
              request_ids=None, *, backlog_s: np.ndarray | None = None,
              deadline_s: np.ndarray | float | None = None,
              now_s: float | None = None) -> Plan:
        """Place this round's active request set; returns the :class:`Plan`.

        ``view`` may be a prepared TopologyView or a raw rate array (wrapped
        via :func:`make_view`); ``request_ids`` are stable stream ids for
        placement inheritance across rounds (ignored by stateless planners).

        When ``backlog_s`` (per-node expected queue wait, seconds) and
        ``deadline_s`` (per-request, broadcastable) are both given, admission
        prices queue depth into the bar: any planner-admitted request whose
        path latency *plus* the backlog at its bottleneck node would overrun
        its deadline is turned away (admitted→False, assign→-1) before the
        plan is returned.  Path-cost-only admission can place a stream onto
        a node whose queue already guarantees a deadline miss; this gate is
        what "expected wait = queue backlog" buys.  Note the gate runs after
        the solve, so warm planners still hold capacity for gated streams
        until the next round — conservative, never over-admits.

        ``now_s`` timestamps this round's trace events (simulated seconds in
        the swarm runtime); ``None`` falls back to the tracer's real-time
        clock (``tracer.now()``) — the CLI path.
        """
        if isinstance(view, np.ndarray):
            view = make_view(view)
        plan = self.planner.plan(problem, view, request_ids=request_ids)
        self.last_queue_rejected = 0
        if (backlog_s is not None and deadline_s is not None
                and plan.n_admitted):
            plan = self._queue_gate(plan, np.asarray(backlog_s, float),
                                    deadline_s)
        self.history.append(plan.solve_stats or ResolveStats(
            0, plan.solution.n_admitted, problem.n_nodes, True,
            plan.solve_time_s))
        if self.tracer.enabled:
            self._trace_round(plan, request_ids, now_s)
        return plan

    def _trace_round(self, plan: Plan, request_ids, now_s) -> None:
        """One SOLVER span per admission round (dur = the solve's wall
        seconds, rich args from ResolveStats incl. the cold-dispatch flag)
        plus per-request admit/reject instants on the ADMISSION track."""
        tr = self.tracer
        ts = float(now_s) if now_s is not None else tr.now()
        st = plan.solve_stats
        args: dict = {"n_admitted": int(plan.n_admitted),
                      "queue_gated": int(self.last_queue_rejected)}
        if st is not None:
            # cold_dispatch=True means solve_time_s paid for ≥1 sweep launch
            # at a new shape — do not read this span's dur as steady-state
            # solve cost.
            args.update(n_kept=int(st.n_kept), n_replaced=int(st.n_replaced),
                        cold=bool(st.cold), k=int(st.k),
                        n_batched=int(st.n_batched),
                        n_jit_compiles=int(st.n_jit_compiles),
                        cold_dispatch=bool(st.cold_dispatch))
        tr.intern("solve", "n_admitted", "queue_gated")
        tr.span(SOLVER, "solve", ts, float(plan.solve_time_s),
                a0=float(plan.n_admitted),
                a1=float(self.last_queue_rejected), args=args)
        if request_ids is None:
            return
        ids = np.asarray(request_ids, np.int64)
        adm = np.asarray(plan.admitted, bool)
        tss = np.full(ids.shape[0], ts)
        if adm.any():
            tr.instant_batch(ADMISSION, "admit", tss[adm], frame=ids[adm])
        if (~adm).any():
            tr.instant_batch(ADMISSION, "reject", tss[~adm],
                             frame=ids[~adm])

    def _queue_gate(self, plan: Plan, backlog_s: np.ndarray,
                    deadline_s: np.ndarray | float) -> Plan:
        """Reject planner-admitted requests whose expected queue wait (the
        backlog at their bottleneck node) pushes them past their deadline."""
        admitted = plan.admitted.copy()
        deadline = np.broadcast_to(np.asarray(deadline_s, float),
                                   admitted.shape)
        per_req = plan.evaluate().per_request_s
        comp = np.asarray(plan.problem.profile.compute_vector(), float)
        speed = plan.problem.compute_speed
        assign = plan.assign.copy()
        n_nodes = plan.problem.n_nodes
        sources = plan.problem.sources
        gated = 0
        for r in np.flatnonzero(admitted):
            path = assign[r]
            if self.queue_model == "perhop":
                # Sum the backlog over every server the candidate path
                # occupies: source uplink, each stage's compute node, and
                # each stage boundary's directed link (queueing.link_resource
                # id layout) — the tandem network's whole expected wait.
                src = int(sources[r])
                first = int(path[0])
                total = backlog_s[first] if first == src else (
                    backlog_s[n_nodes + src * n_nodes + first]
                    + backlog_s[first])
                for j in range(path.shape[0] - 1):
                    a, b = int(path[j]), int(path[j + 1])
                    if a != b:
                        total += (backlog_s[n_nodes + a * n_nodes + b]
                                  + backlog_s[b])
                if per_req[r] + total > deadline[r]:
                    admitted[r] = False
                    assign[r] = -1
                    gated += 1
                continue
            # bottleneck node = host of the largest stage wall on the path
            best_w, best_node, cur, w = -1.0, int(path[0]), int(path[0]), 0.0
            for j in range(path.shape[0]):
                node = int(path[j])
                if node != cur:
                    if w > best_w:
                        best_w, best_node = w, cur
                    cur, w = node, 0.0
                w += comp[j] / (speed[node] if speed is not None else 1.0)
            if w > best_w:
                best_w, best_node = w, cur
            if per_req[r] + backlog_s[best_node] > deadline[r]:
                admitted[r] = False
                assign[r] = -1
                gated += 1
        self.last_queue_rejected = gated
        if not gated:
            return plan
        sol = dataclasses.replace(plan.solution, assign=assign,
                                  admitted=admitted,
                                  status=plan.solution.status
                                  + f"+queue-gated:{gated}")
        sol = dataclasses.replace(
            sol, objective=evaluate(plan.problem, sol).comm_latency_s)
        return dataclasses.replace(plan, solution=sol)

    @property
    def total_solve_time_s(self) -> float:
        return float(sum(s.solve_time_s for s in self.history))


def schedule_requests(cfg: ModelConfig, *, n_nodes: int, requests: int,
                      hbm_bytes: float, flops_budget: float,
                      rates_bits: np.ndarray, seq: int = 2048,
                      planner: str = "ould-dp",
                      **planner_options: Any) -> tuple[Plan, Any]:
    """Place R concurrent serving requests' layer groups over the pool —
    the paper's multi-request placement applied to inference serving, via
    any registered planner (``planner_options`` configure it, e.g.
    ``sparse_k`` for the pruned-DP strategies).  Returns
    (Plan, Evaluation)."""
    profile = lm_profile(
        cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
        n_heads=cfg.n_heads, n_kv=cfg.n_kv, d_ff=cfg.d_ff, vocab=cfg.vocab,
        seq=seq, moe_experts=cfg.moe.num_experts if cfg.moe else 0,
        moe_topk=cfg.moe.top_k if cfg.moe else 0, window=cfg.window)
    sources = np.arange(requests) % n_nodes
    prob = Problem(profile, np.full(n_nodes, hbm_bytes),
                   np.full(n_nodes, flops_budget), rates_bits,
                   sources.astype(np.int64),
                   compute_speed=np.full(n_nodes, 197e12))
    plan = get_planner(planner, **planner_options).plan(
        prob, make_view(rates_bits))
    return plan, plan.evaluate()
