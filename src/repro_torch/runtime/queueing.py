"""Per-node request queues: the always-on serving substrate.

The simulator used to serve every frame *within* its tick — a node could
absorb unlimited work per time step, so overload, head-of-line blocking and
tail latency were unobservable.  This module is the layer where a saturated
node exists: each frame occupies its placed node's queue for its
measured/modeled stage wall, waits behind earlier frames, and under overload
the :class:`ServicePolicy` decides what to drop, degrade, or turn away (the
``fast_mot`` skip/degrade discipline: a real-time tracker that falls behind
skips the expensive detector rather than queueing into uselessness).

Everything is struct-of-arrays over frames — numpy arrays for node id,
arrival time, service demand and absolute deadline — so scenarios with
10⁵–10⁶ frames advance through a handful of vectorized kernels instead of a
Python event loop:

* :func:`fifo_advance_kernel` — the vectorized queue-advance kernel: one
  segmented Lindley recursion (``finish_i = c_i + max(f₀, max_{j≤i}(a_j −
  c_{j−1}))`` with ``c`` the in-segment service cumsum) priced with three
  ``cumsum``/``maximum.accumulate`` passes over the frames of all nodes at
  once.  Exact for work-conserving service (policy ``none``) under any
  static per-window order — FIFO or EDF.
* :func:`policy_advance_kernel` — the reneging disciplines (``drop`` /
  ``degrade`` / ``reject``) have a data-dependent recursion (whether frame
  *i* consumes service depends on every earlier decision), so they run as an
  exact sequential sweep over the same sorted arrays; the no-policy
  vectorized kernel is its fixture in the tests.

:class:`NodeQueues` owns the persistent per-node state (``free_at_s`` — when
each node's server drains) and is advanced once per simulator tick with that
tick's emitted frames; ``backlog_s(now)`` is the expected wait a new arrival
would see, which queue-aware admission prices into the admission bar
(:class:`~repro_torch.runtime.serve.AdmissionController`).

Deadline classes (§I timeliness, one ``deadline_s`` per class) ride along as
per-frame *absolute* deadlines: EDF orders by them, the overload policies
renege against them, and the metrics layer buckets misses by class.

The port's copy of ``repro/runtime/queueing.py``.  Its "kernels" are
vectorized numpy passes on the host, in the reference as here; none of
them runs on the card.
"""

from __future__ import annotations

import dataclasses

import numpy as np

DISCIPLINES = ("fifo", "edf")
OVERLOAD_POLICIES = ("none", "drop", "degrade", "reject")


@dataclasses.dataclass(frozen=True)
class DeadlineClass:
    """One timeliness tier: frames of this class must complete within
    ``deadline_s`` of emission (the paper's surveillance deadline, split
    into tiers the way a mixed detection/tracking/alert workload needs)."""

    name: str
    deadline_s: float


DEFAULT_CLASSES: tuple[DeadlineClass, ...] = (
    DeadlineClass("interactive", 0.8),
    DeadlineClass("standard", 1.5),
    DeadlineClass("batch", 6.0),
)


@dataclasses.dataclass(frozen=True)
class ServicePolicy:
    """How a node's queue behaves, especially past saturation.

    ``discipline`` orders each advance window (``fifo``: arrival order;
    ``edf``: ascending absolute deadline).  ``overload`` is what happens to
    frames the server cannot meet:

    * ``none``   — serve everything; waits grow without bound (the baseline
      whose p99 the drop/degrade policies are measured against);
    * ``drop``   — a frame whose service would *start* past its deadline is
      dropped from the head without consuming service (drop-oldest);
    * ``degrade``— a frame whose full service would *finish* past its
      deadline is served in degraded form at ``degrade_factor`` × the
      service demand (skip-to-keep-up: run the light tracker, not the
      detector);
    * ``reject`` — a frame whose projected finish is already past its
      deadline on *arrival* never enters the queue (admission at the node).
    """

    discipline: str = "fifo"
    overload: str = "none"
    degrade_factor: float = 0.25

    def __post_init__(self):
        if self.discipline not in DISCIPLINES:
            raise ValueError(f"unknown queue discipline "
                             f"{self.discipline!r}; one of {DISCIPLINES}")
        if self.overload not in OVERLOAD_POLICIES:
            raise ValueError(f"unknown overload policy {self.overload!r}; "
                             f"one of {OVERLOAD_POLICIES}")
        if not (0.0 <= self.degrade_factor <= 1.0):
            raise ValueError(f"degrade_factor must be in [0, 1], "
                             f"got {self.degrade_factor}")

    @classmethod
    def parse(cls, spec: str) -> "ServicePolicy":
        """``"fifo"`` / ``"edf"`` / ``"fifo+drop"`` / ``"edf+degrade:0.5"``
        → a policy (discipline, then an optional overload clause)."""
        head, _, tail = spec.partition("+")
        kw: dict = {"discipline": head}
        if tail:
            overload, _, val = tail.partition(":")
            kw["overload"] = overload
            if val:
                if overload != "degrade":
                    raise ValueError(
                        f"only 'degrade' takes a parameter, got {spec!r}")
                kw["degrade_factor"] = float(val)
        return cls(**kw)


@dataclasses.dataclass(frozen=True)
class QueueOutcome:
    """Per-frame result of one queue advance (arrays aligned with the
    *caller's* frame order, not the internal sorted order)."""

    start_s: np.ndarray        # service start (emission-relative absolute s)
    finish_s: np.ndarray       # service completion (inf where not completed)
    wait_s: np.ndarray         # start − arrival for completed frames, else inf
    service_used_s: np.ndarray  # 0 where dropped/rejected; degraded × factor
    completed: np.ndarray      # bool — produced a decision
    dropped: np.ndarray        # bool — reneged at the head past deadline
    rejected: np.ndarray       # bool — turned away on arrival
    degraded: np.ndarray       # bool — served the skip/light variant


def _segment_starts(node_sorted: np.ndarray) -> np.ndarray:
    """Bool mask marking the first frame of each node's run (sorted input)."""
    starts = np.ones(node_sorted.shape[0], bool)
    starts[1:] = node_sorted[1:] != node_sorted[:-1]
    return starts


def _segmented_cumsum(x: np.ndarray, starts: np.ndarray) -> np.ndarray:
    """Inclusive cumsum of ``x`` restarting at every segment start."""
    cs = np.cumsum(x)
    base = np.where(starts, cs - x, 0.0)
    np.maximum.accumulate(base, out=base)
    return cs - base


def _segmented_cummax(x: np.ndarray, starts: np.ndarray) -> np.ndarray:
    """Running max of ``x`` restarting at every segment start (offset
    trick: segment ids are non-decreasing, so shifting each segment by
    ``seg_id × span`` makes a global cummax respect the boundaries)."""
    seg_id = np.cumsum(starts) - 1
    finite = x[np.isfinite(x)]
    span = (float(finite.max() - finite.min()) + 1.0) if finite.size else 1.0
    shifted = x + seg_id * span
    return np.maximum.accumulate(shifted) - seg_id * span


def fifo_advance_kernel(node: np.ndarray, arrival_s: np.ndarray,
                        service_s: np.ndarray,
                        free_at_s: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The vectorized queue-advance kernel (work-conserving, no reneging).

    Frames must be sorted by ``(node, serve order)``; ``free_at_s`` is each
    node's current server-busy-until time.  Returns ``(start_s, finish_s)``
    in the given order via the segmented Lindley recursion — O(n) numpy,
    ~10⁷ frames/s, which is what makes 10⁵–10⁶-frame scenarios feasible.
    """
    if node.size == 0:
        return np.zeros(0), np.zeros(0)
    starts = _segment_starts(node)
    c = _segmented_cumsum(service_s, starts)          # in-segment cumsum
    c_excl = c - service_s
    head = arrival_s - c_excl
    # The node's pre-existing backlog is a virtual zeroth frame finishing at
    # free_at_s[node]; it enters the max with an exclusive cumsum of 0.
    head = np.where(starts, np.maximum(head, free_at_s[node]), head)
    finish = c + _segmented_cummax(head, starts)
    return finish - service_s, finish


def policy_advance_kernel(node: np.ndarray, arrival_s: np.ndarray,
                          service_s: np.ndarray, deadline_abs_s: np.ndarray,
                          free_at_s: np.ndarray,
                          policy: ServicePolicy) -> QueueOutcome:
    """Exact sequential queue advance with the reneging policies.

    Same sorted-input contract as :func:`fifo_advance_kernel`.  The
    recursion is inherently data-dependent (a drop frees the very service
    time that decides the next frame's fate), so this sweeps the sorted
    arrays once in Python — O(n) with small constants; the vectorized
    kernel above takes over whenever ``policy.overload == "none"``.
    """
    n = node.shape[0]
    start = np.zeros(n)
    finish = np.full(n, np.inf)
    used = np.zeros(n)
    completed = np.zeros(n, bool)
    dropped = np.zeros(n, bool)
    rejected = np.zeros(n, bool)
    degraded = np.zeros(n, bool)
    free = free_at_s.copy()
    overload, factor = policy.overload, policy.degrade_factor
    nodes_l = node.tolist()
    arr_l = arrival_s.tolist()
    srv_l = service_s.tolist()
    ddl_l = deadline_abs_s.tolist()
    for i in range(n):
        nd = nodes_l[i]
        st = max(arr_l[i], free[nd])
        svc = srv_l[i]
        if overload == "reject" and st + svc > ddl_l[i]:
            rejected[i] = True
            continue
        if overload == "drop" and st > ddl_l[i]:
            dropped[i] = True
            start[i] = st           # when the head reached it (provenance)
            continue
        if overload == "degrade" and st + svc > ddl_l[i]:
            svc *= factor
            degraded[i] = True
        start[i] = st
        finish[i] = st + svc
        used[i] = svc
        completed[i] = True
        free[nd] = finish[i]
    wait = np.where(completed, start - arrival_s, np.inf)
    return QueueOutcome(start, finish, wait, used, completed, dropped,
                        rejected, degraded)


class NodeQueues:
    """Persistent per-node queue state, advanced one window at a time.

    One instance == one swarm run.  The simulator emits a window of frames
    per tick (struct-of-arrays) and calls :meth:`advance`; the queue carries
    ``free_at_s`` — each node's server-busy-until time — across windows, so
    backlog accumulates exactly under sustained overload.  Ordering inside a
    window follows the policy's discipline (FIFO: emission order; EDF:
    ascending absolute deadline); frames of *earlier* windows are already
    committed, which makes EDF a per-window (tick-granular) reordering —
    the honest discrete-time reading of "earliest deadline first".
    """

    def __init__(self, n_nodes: int, policy: ServicePolicy = ServicePolicy()):
        self.n_nodes = n_nodes
        self.policy = policy
        self.free_at_s = np.zeros(n_nodes)
        # offered load per node: total service seconds presented (including
        # frames a policy later drops/rejects) — max(demand_s)/horizon is
        # the realized overload factor at the hottest queue
        self.demand_s = np.zeros(n_nodes)
        self.n_enqueued = 0
        self.n_completed = 0
        self.n_dropped = 0
        self.n_rejected = 0
        self.n_degraded = 0

    def backlog_s(self, now_s: float) -> np.ndarray:
        """(N,) expected wait of a frame arriving at each node *now* — the
        queue-depth term admission prices into its bar."""
        return np.maximum(self.free_at_s - now_s, 0.0)

    def snapshot(self) -> dict:
        """Lifetime queue tallies for the metrics registry (``queue.*`` in
        ``MetricsRegistry.snapshot()``): counters plus the realized offered
        load at the hottest node."""
        return {"queue.enqueued": self.n_enqueued,
                "queue.completed": self.n_completed,
                "queue.dropped": self.n_dropped,
                "queue.rejected": self.n_rejected,
                "queue.degraded": self.n_degraded,
                "queue.max_demand_s": float(self.demand_s.max())
                if self.demand_s.size else 0.0}

    def advance(self, node: np.ndarray, arrival_s: np.ndarray,
                service_s: np.ndarray,
                deadline_abs_s: np.ndarray) -> QueueOutcome:
        """Advance all queues through one window of emitted frames.

        Inputs are parallel arrays in emission order; the outcome is
        returned in that same order.  Updates ``free_at_s`` and counters.
        """
        n = int(node.shape[0])
        if n == 0:
            empty = np.zeros(0)
            eb = np.zeros(0, bool)
            return QueueOutcome(empty, empty, empty, empty, eb, eb, eb, eb)
        node = np.asarray(node, np.int64)
        arrival_s = np.asarray(arrival_s, float)
        service_s = np.asarray(service_s, float)
        deadline_abs_s = np.asarray(deadline_abs_s, float)
        if self.policy.discipline == "edf":
            order = np.lexsort((deadline_abs_s, node))
        else:
            order = np.lexsort((np.arange(n), node))
        inv = np.empty(n, np.int64)
        inv[order] = np.arange(n)

        ns, as_, ss, ds = (node[order], arrival_s[order], service_s[order],
                           deadline_abs_s[order])
        if self.policy.overload == "none":
            start, finish = fifo_advance_kernel(ns, as_, ss, self.free_at_s)
            completed = np.ones(n, bool)
            eb = np.zeros(n, bool)
            out = QueueOutcome(start, finish, start - as_, ss.copy(),
                               completed, eb, eb.copy(), eb.copy())
        else:
            out = policy_advance_kernel(ns, as_, ss, ds, self.free_at_s,
                                        self.policy)
        # Commit per-node server state: the last completed frame per segment.
        last = np.zeros(self.n_nodes)
        np.maximum.at(last, ns[out.completed], out.finish_s[out.completed])
        self.free_at_s = np.maximum(self.free_at_s, last)

        self.demand_s += np.bincount(ns, weights=ss,
                                     minlength=self.n_nodes)
        self.n_enqueued += n
        self.n_completed += int(out.completed.sum())
        self.n_dropped += int(out.dropped.sum())
        self.n_rejected += int(out.rejected.sum())
        self.n_degraded += int(out.degraded.sum())
        return QueueOutcome(out.start_s[inv], out.finish_s[inv],
                            out.wait_s[inv], out.service_used_s[inv],
                            out.completed[inv], out.dropped[inv],
                            out.rejected[inv], out.degraded[inv])


def n_path_resources(n_nodes: int) -> int:
    """Size of the combined resource space the tandem network queues over:
    one compute server per node plus one server per *directed* link."""
    return n_nodes + n_nodes * n_nodes


def link_resource(n_nodes: int, a, b):
    """Resource id of the directed link ``a → b`` (vectorized over arrays).

    Compute node ``i`` keeps id ``i``; links occupy ``N + a·N + b`` so every
    hop of a placed path — stage walls *and* transfers — is a first-class
    server with its own FIFO/EDF queue.
    """
    return n_nodes + a * n_nodes + b


@dataclasses.dataclass(frozen=True)
class PathOutcome:
    """Per-frame, per-hop result of one tandem advance (caller's frame
    order; hop axis padded — ``res < 0`` hops carry ``wait = service = 0``).
    """

    start_s: np.ndarray         # (F, H) hop service start
    finish_s: np.ndarray        # (F, H) hop service completion
    wait_s: np.ndarray          # (F, H) start − previous hop's finish
    service_used_s: np.ndarray  # (F, H) 0 where padded/dropped; degraded ×f
    done_s: np.ndarray          # (F,) last real hop's finish (inf if not)
    lat_s: np.ndarray           # (F,) Σ_h (wait_h + service_h), hop order
    wait_total_s: np.ndarray    # (F,) Σ_h wait_h
    completed: np.ndarray       # (F,) bool
    dropped: np.ndarray         # (F,) bool — reneged at some hop's head
    rejected: np.ndarray        # (F,) bool — turned away at the first hop
    degraded: np.ndarray        # (F,) bool — any hop served the light form


def path_advance_kernel(res: np.ndarray, service_s: np.ndarray,
                        arrival_s: np.ndarray, free_at_s: np.ndarray,
                        priority: np.ndarray | None = None,
                        ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Generalized segmented-Lindley advance over a tandem of hops.

    ``res`` is ``(F, H)`` resource ids per frame and hop (compute nodes and
    directed links share one id space, ``-1`` pads shorter paths) and
    ``service_s`` the matching hop services.  A frame's arrival at hop
    ``h`` is its *finish at hop h−1* (hop 0 arrives at ``arrival_s``), so
    the whole cascade advances hop-major: for each hop level, the frames
    holding a real hop are sorted by ``(resource, readiness)`` and pushed
    through :func:`fifo_advance_kernel` against the running ``free_at_s``
    of the combined resource space — H sweeps of the same O(F) vectorized
    recursion instead of a per-frame event loop.

    ``priority`` (optional, per frame) replaces readiness as the in-wave
    serve order within a resource (EDF passes absolute deadlines).
    Returns ``(start_s, finish_s, free_out)`` with the per-hop schedule in
    the caller's frame order and the committed busy-until times;
    ``free_at_s`` itself is not mutated.
    """
    res = np.asarray(res, np.int64)
    service_s = np.asarray(service_s, float)
    n_frames, n_hops = res.shape
    start = np.zeros((n_frames, n_hops))
    finish = np.zeros((n_frames, n_hops))
    ready = np.asarray(arrival_s, float).copy()
    free = np.asarray(free_at_s, float).copy()
    for h in range(n_hops):
        r = res[:, h]
        valid = r >= 0
        start[:, h] = ready
        finish[:, h] = ready
        if not valid.any():
            continue
        idx = np.flatnonzero(valid)
        key = ready[idx] if priority is None else priority[idx]
        order = idx[np.lexsort((idx, key, r[idx]))]
        rs = r[order]
        st, fin = fifo_advance_kernel(rs, ready[order],
                                      service_s[order, h], free)
        start[order, h] = st
        finish[order, h] = fin
        np.maximum.at(free, rs, fin)
        ready[order] = fin
    return start, finish, free


def path_sweep_reference(res: np.ndarray, service_s: np.ndarray,
                         arrival_s: np.ndarray, free_at_s: np.ndarray,
                         priority: np.ndarray | None = None,
                         ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Scalar python sweep with the identical hop-major FCFS discipline —
    the exactness fixture (and the denominator of the S8 speedup lock)."""
    res = np.asarray(res, np.int64)
    service_s = np.asarray(service_s, float)
    n_frames, n_hops = res.shape
    start = np.zeros((n_frames, n_hops))
    finish = np.zeros((n_frames, n_hops))
    ready = [float(a) for a in np.asarray(arrival_s, float)]
    free = [float(f) for f in np.asarray(free_at_s, float)]
    for h in range(n_hops):
        wave = [i for i in range(n_frames) if res[i, h] >= 0]
        if priority is None:
            wave.sort(key=lambda i: (res[i, h], ready[i], i))
        else:
            wave.sort(key=lambda i: (res[i, h], priority[i], i))
        for i in range(n_frames):
            start[i, h] = finish[i, h] = ready[i]
        for i in wave:
            rid = int(res[i, h])
            st = max(ready[i], free[rid])
            fin = st + float(service_s[i, h])
            start[i, h] = st
            finish[i, h] = fin
            free[rid] = fin
            ready[i] = fin
    return start, finish, np.asarray(free)


def path_policy_sweep(res: np.ndarray, service_s: np.ndarray,
                      arrival_s: np.ndarray, deadline_abs_s: np.ndarray,
                      free_at_s: np.ndarray, policy: ServicePolicy,
                      ) -> tuple[np.ndarray, np.ndarray, np.ndarray, dict]:
    """Hop-major tandem advance with the reneging overload policies.

    Same hop-major wave order as :func:`path_advance_kernel` (EDF swaps the
    in-wave key for the absolute deadline), but sequential within each wave
    because reneging is data-dependent:

    * ``reject`` — decided once at the frame's *first* real hop: if its
      start there plus the sum of all remaining hop services (a no-wait
      lower bound on completion) already overruns the deadline, the frame
      never consumes any hop;
    * ``drop``   — at any hop whose service would *start* past the
      deadline the frame reneges and abandons the rest of its cascade;
    * ``degrade``— any hop whose full service would finish late is served
      at ``degrade_factor`` × its demand (the light variant of that stage
      or transfer).
    """
    res = np.asarray(res, np.int64)
    service_s = np.asarray(service_s, float)
    n_frames, n_hops = res.shape
    start = np.zeros((n_frames, n_hops))
    finish = np.zeros((n_frames, n_hops))
    used = np.zeros((n_frames, n_hops))
    dropped = np.zeros(n_frames, bool)
    rejected = np.zeros(n_frames, bool)
    degraded = np.zeros(n_frames, bool)
    started = np.zeros(n_frames, bool)
    ready = [float(a) for a in np.asarray(arrival_s, float)]
    free = [float(f) for f in np.asarray(free_at_s, float)]
    remaining = np.cumsum(service_s[:, ::-1], axis=1)[:, ::-1]
    ddl = np.asarray(deadline_abs_s, float)
    edf = policy.discipline == "edf"
    overload, factor = policy.overload, policy.degrade_factor
    for h in range(n_hops):
        for i in range(n_frames):
            start[i, h] = finish[i, h] = ready[i]
        wave = [i for i in range(n_frames)
                if res[i, h] >= 0 and not dropped[i] and not rejected[i]]
        if edf:
            wave.sort(key=lambda i: (res[i, h], ddl[i], i))
        else:
            wave.sort(key=lambda i: (res[i, h], ready[i], i))
        for i in wave:
            rid = int(res[i, h])
            st = max(ready[i], free[rid])
            svc = float(service_s[i, h])
            if overload == "reject" and not started[i]:
                if st + float(remaining[i, h]) > ddl[i]:
                    rejected[i] = True
                    continue
            if overload == "drop" and st > ddl[i]:
                dropped[i] = True
                start[i, h] = st        # when the head reached it
                finish[i, h] = ready[i]
                continue
            if overload == "degrade" and st + svc > ddl[i]:
                svc *= factor
                degraded[i] = True
            started[i] = True
            start[i, h] = st
            finish[i, h] = st + svc
            used[i, h] = svc
            free[rid] = st + svc
            ready[i] = st + svc
    flags = {"dropped": dropped, "rejected": rejected, "degraded": degraded,
             "served_any": started}
    return start, finish, used, {"free": np.asarray(free), **flags}


class PathQueues:
    """Persistent tandem-network state: one server per node *and* per
    directed link, advanced one window of hop schedules at a time.

    The per-hop counterpart of :class:`NodeQueues` (DESIGN.md §10): a
    frame occupies, in order, its source uplink, each placed stage's
    compute server, and each stage boundary's link server — waiting behind
    cross-traffic at every hop, which is exactly the shared-relay
    contention the bottleneck model cannot see.  ``backlog_s`` spans the
    whole resource space so queue-aware admission can price the *summed*
    backlog along a candidate path.
    """

    def __init__(self, n_nodes: int, policy: ServicePolicy = ServicePolicy()):
        self.n_nodes = n_nodes
        self.policy = policy
        self.free_at_s = np.zeros(n_path_resources(n_nodes))
        self.demand_s = np.zeros(n_nodes)          # compute offered load
        self.link_demand_s = np.zeros(n_nodes * n_nodes)
        self.n_enqueued = 0
        self.n_completed = 0
        self.n_dropped = 0
        self.n_rejected = 0
        self.n_degraded = 0

    def backlog_s(self, now_s: float) -> np.ndarray:
        """(N + N²,) expected wait at each compute/link server *now*."""
        return np.maximum(self.free_at_s - now_s, 0.0)

    def snapshot(self) -> dict:
        return {"queue.enqueued": self.n_enqueued,
                "queue.completed": self.n_completed,
                "queue.dropped": self.n_dropped,
                "queue.rejected": self.n_rejected,
                "queue.degraded": self.n_degraded,
                "queue.max_demand_s": float(self.demand_s.max())
                if self.demand_s.size else 0.0,
                "queue.max_link_demand_s": float(self.link_demand_s.max())
                if self.link_demand_s.size else 0.0}

    def advance(self, res: np.ndarray, service_s: np.ndarray,
                arrival_s: np.ndarray,
                deadline_abs_s: np.ndarray) -> PathOutcome:
        """Advance the tandem network through one window of hop schedules.

        ``res``/``service_s`` are ``(F, H)`` in emission order (rows are
        frames, columns hops, ``-1`` pads).  Latency is accumulated in hop
        order (``lat ← lat + wait_h + service_h``) so an uncontended
        single-hop path reproduces the bottleneck model's
        ``base + wait + service`` float-for-float.
        """
        res = np.asarray(res, np.int64)
        n_frames = int(res.shape[0])
        if n_frames == 0:
            e2 = np.zeros((0, res.shape[1] if res.ndim == 2 else 0))
            e1 = np.zeros(0)
            eb = np.zeros(0, bool)
            return PathOutcome(e2, e2.copy(), e2.copy(), e2.copy(), e1,
                               e1.copy(), e1.copy(), eb, eb.copy(),
                               eb.copy(), eb.copy())
        service_s = np.asarray(service_s, float)
        arrival_s = np.asarray(arrival_s, float)
        deadline_abs_s = np.asarray(deadline_abs_s, float)
        prio = deadline_abs_s if self.policy.discipline == "edf" else None
        if self.policy.overload == "none":
            start, finish, free = path_advance_kernel(
                res, service_s, arrival_s, self.free_at_s, prio)
            used = np.where(res >= 0, service_s, 0.0)
            completed = np.ones(n_frames, bool)
            eb = np.zeros(n_frames, bool)
            dropped, rejected, degraded = eb, eb.copy(), eb.copy()
        else:
            start, finish, used, info = path_policy_sweep(
                res, service_s, arrival_s, deadline_abs_s, self.free_at_s,
                self.policy)
            free = info["free"]
            dropped, rejected = info["dropped"], info["rejected"]
            degraded = info["degraded"]
            completed = ~dropped & ~rejected
        self.free_at_s = np.maximum(self.free_at_s, free)

        prev = np.concatenate([arrival_s[:, None], finish[:, :-1]], axis=1)
        # No clipping at 0: the segmented cummax can land a start an ulp
        # below its arrival, and the bottleneck model keeps that sign —
        # preserving it is what makes single-hop tapes bit-identical.
        wait = np.where(res >= 0, start - prev, 0.0)
        lat = np.zeros(n_frames)
        wait_total = np.zeros(n_frames)
        for h in range(res.shape[1]):
            lat = lat + wait[:, h] + used[:, h]
            wait_total = wait_total + wait[:, h]
        last_real = np.where((res >= 0).any(axis=1),
                             res.shape[1] - 1 -
                             np.argmax((res >= 0)[:, ::-1], axis=1), 0)
        done = finish[np.arange(n_frames), last_real]
        done = np.where(completed, done, np.inf)
        lat = np.where(completed, lat, np.inf)

        node_hops = (res >= 0) & (res < self.n_nodes)
        link_hops = res >= self.n_nodes
        self.demand_s += np.bincount(
            res[node_hops], weights=service_s[node_hops],
            minlength=self.n_nodes)
        if link_hops.any():
            self.link_demand_s += np.bincount(
                res[link_hops] - self.n_nodes,
                weights=service_s[link_hops],
                minlength=self.n_nodes * self.n_nodes)
        self.n_enqueued += n_frames
        self.n_completed += int(completed.sum())
        self.n_dropped += int(dropped.sum())
        self.n_rejected += int(rejected.sum())
        self.n_degraded += int(degraded.sum())
        return PathOutcome(start, finish, wait, used, done, lat, wait_total,
                           completed, dropped, rejected, degraded)


def tail_percentiles(latencies: np.ndarray) -> dict[str, float]:
    """p50/p99/p999 of a latency sample (inf-guarded, empty ⇒ inf) — the
    tail metrics the ROADMAP's production-traffic goal is judged on."""
    finite = latencies[np.isfinite(latencies)]
    if finite.size == 0:
        return {"p50_s": float("inf"), "p99_s": float("inf"),
                "p999_s": float("inf")}
    p50, p99, p999 = np.percentile(finite, [50.0, 99.0, 99.9])
    return {"p50_s": float(p50), "p99_s": float(p99), "p999_s": float(p999)}
