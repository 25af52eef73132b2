"""Event-driven swarm serving simulator: streaming requests on a moving
swarm, served through per-node queues.

The paper's static instances answer "where do the layers go *right now*";
this simulator answers the question the paper actually motivates OULD-MP
with: how do placement policies behave when the network changes *under* the
computation — UAVs move (link rates drift, inter-group links fade beyond
range), nodes drop out and rejoin, and classification requests arrive as a
Poisson stream instead of one batch.

Since the queueing-runtime refactor the serve path is layered, not
monolithic:

* :func:`build_event_tape` freezes the scenario's entire stochastic input —
  arrivals, holds, sources, deadline classes, churn — into an
  :class:`EventTape` before any policy runs, so every policy consumes the
  *identical* tape (same seed ⇒ paired per-request metrics) and the pairing
  is testable as data, not as a convention;
* the per-tick serve step is vectorized struct-of-arrays: one numpy pass
  prices every active stream's realized path latency for the tick and emits
  one *frame* per stream into its placed node's queue — a frame occupies
  the node hosting its heaviest stage for that stage's modeled (or
  measured, ``execute=True``) wall instead of completing instantly;
* :class:`~repro_torch.runtime.queueing.NodeQueues` advances those queues on the
  tape's ``QUEUE_ADVANCE`` events (one per tick): waits accumulate under
  overload, and the scenario's :class:`~repro_torch.runtime.queueing.
  ServicePolicy` (``service_policy="fifo" | "edf" | "fifo+drop" | ...``)
  decides what a saturated node drops, degrades, or turns away;
* admission runs per epoch through :class:`~repro_torch.runtime.serve.
  AdmissionController`; with ``queue_aware_admission=True`` the controller
  prices each stream's expected queue wait (backlog at its placed node)
  into the admission bar, not just path cost.

Simulator knobs → paper sections
--------------------------------
========================  ====================================================
knob                      paper grounding
========================  ====================================================
``n_groups``/``area_m``   §III-C RPG mobility [40]; multi-group sweeps make
                          inter-group links cross ``max_range`` (ρ→0), the
                          disconnection argument of Fig. 13
``tick_s``                §III-C time-step Δt at which positions are recorded
                          and ρ(t) re-sampled via Eq. (1) (``core/radio.py``)
``epoch_ticks``           §III-C re-optimization period: OULD re-solves on the
                          fresh snapshot, OULD-MP once per epoch over the
                          predicted horizon (Eq. 14; T = epoch_ticks)
``arrival_rate_hz``       §IV "incoming requests" axis (Fig. 4–7 sweeps load;
                          here load arrives as a Poisson stream)
``hold_ticks_mean``       §III-A each request is a surveillance stream served
                          every time step until its source stops capturing
``mem_mb``/``gflops``     §IV node calibration: {256, 512} MB, 9.5 GFLOPS
``deadline_s``            §I surveillance timeliness requirement (single
                          class; ``deadline_classes`` splits the workload
                          into tiers with distinct deadlines)
``service_policy``        overload behavior of a saturated node (the
                          ``fast_mot`` skip/degrade discipline)
``mtbf_s``/``mttr_s``     §III-C "UAVs may leave the swarm" — unpredicted
                          churn, invisible to both OULD and OULD-MP horizons
========================  ====================================================

Policies are registered *planners* (see :mod:`repro_torch.core.planner`): the
epoch loop is strategy-agnostic — it builds the richest
:class:`~repro_torch.core.planner.TopologyView` each planner prefers (a predicted
horizon for ``ould-mp``, the fresh snapshot otherwise) and calls ``plan()``
through one :class:`~repro_torch.runtime.serve.AdmissionController`.

The port's copy of ``repro/runtime/swarm.py``.  The simulation is numpy on
the host, as in the reference, and differs from it only where the card or
an unported module is involved:

* :attr:`SwarmScenario.device` (default ``"cuda"``) is read only where a run
  needs the card: the epoch re-solves' batched sweep (``batch_solve=True``:
  the hand-written ``dp_sweep`` kernel, through the planner) and executed
  mode's stage measurements (the engine and its layer functions).  A run
  with neither flag needs no card; with either, ``"cuda"`` raises where
  there is none and ``"cpu"`` runs the plain versions;
* ``compile_cache_dir`` and executed mode with a ``transport`` other than
  ``"inproc"`` raise :class:`NotImplementedError` before anything runs: the
  compile cache and the byte-moving transports are not ported yet (ROADMAP
  Queue 1).  Neither falls back to the in-process path;
* the ``solver.jit_compiles`` metric keeps its name and counts the epoch
  re-solves' sweep launches at a padded shape not launched before
  (``ResolveStats.n_jit_compiles``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core.events import (ChurnEvent, EventKind, EventQueue, churn_events,
                           poisson_process)
from ..core.latency import evaluate
from ..core.mobility import MultiGroupMobility, RPGParams
from ..core.ould import Problem, placement_drift
from ..core.placement import to_stages
from ..core.planner import (HorizonView, NoisyHorizonView, SnapshotView,
                            StaleView, available_planners, make_view)
from ..core.profiles import ModelProfile, lenet_profile
from ..core.radio import RadioParams, rate_matrix
from ..device import resolve_device
from ..obs import (FRAMES, LATENCY_EDGES_S, NULL_TRACER, QUEUE,
                   MetricsRegistry)
from .queueing import (DeadlineClass, NodeQueues, PathQueues, ServicePolicy,
                       link_resource)
from .serve import AdmissionController

# Canonical registry names for the scenario matrix.
PLANNER_POLICIES = ("incremental", "incremental-sparse", "ould-mp", "nearest",
                    "hrm", "nearest-hrm")
POLICIES = PLANNER_POLICIES

MB = 1e6


@dataclasses.dataclass(frozen=True)
class SwarmScenario:
    """One time-dynamic serving scenario (defaults ≈ paper §IV, 500 m area)."""

    n_uavs: int = 10
    n_groups: int = 2
    area_m: float = 500.0
    member_radius_m: float = 25.0
    leader_speed_mps: float = 5.0
    homogeneous: bool = False      # Fig. 2a: frozen intra-group geometry
    tick_s: float = 1.0
    duration_ticks: int = 120
    epoch_ticks: int = 15
    arrival_rate_hz: float = 0.15
    hold_ticks_mean: float = 45.0
    hotspots: int = 3              # request sources live in group 0
    mem_mb_hotspot_group: float = 192.0   # scarce: forces offload
    mem_mb_other_groups: float = 512.0    # paper's high-memory level
    comp_cap_flops: float = 95e9   # 9.5 GFLOPS × 10 s decision window
    gflops: float = 9.5e9
    deadline_s: float = 1.5
    # Timeliness tiers: None ⇒ one class at ``deadline_s`` (streams draw a
    # class uniformly from the tape rng when more than one is given, so the
    # class assignment is part of the paired event tape).
    deadline_classes: tuple[DeadlineClass, ...] | None = None
    # Queue behavior of a saturated node: "<discipline>[+<overload>]", e.g.
    # "fifo", "edf", "fifo+drop", "edf+degrade:0.25", "fifo+reject"
    # (ServicePolicy.parse).  "fifo" = work-conserving, no reneging.
    service_policy: str = "fifo"
    # Epoch admission prices queue backlog (expected wait at the placed
    # node) into the bar, not just path cost (AdmissionController).
    queue_aware_admission: bool = False
    # Queueing substrate (DESIGN.md §10): "perhop" (default) queues a frame
    # at *every* server on its placed path — source uplink, each stage's
    # compute node, each boundary's directed link — so cross-traffic on
    # shared relays is priced into waits; "bottleneck" is the PR-6
    # compatibility mode (one queue at the heaviest stage's host, the rest
    # of the path deterministic), pinned bit-identical.
    queue_model: str = "perhop"
    # Drift-triggered re-placement: when set, every non-epoch tick checks
    # the kept placements' mean drift from their slack-capacity DP optimum
    # (core.ould.placement_drift) and fires an extra epoch re-solve when it
    # exceeds this many seconds (SimResult.drift_resolves counts them).
    # None (default) keeps the fixed-epoch cadence untouched.
    resolve_on_drift: float | None = None
    # Capacity-repair rule for the single-request DP's over-capacity loop
    # ("halve": the PR-1 rule, shrink the busiest node's advertised
    # capacity by 2× — can zero a node that still fit one layer; "gentle":
    # shrink to load − min hosted layer demand, excluding as little as
    # possible — admits strictly more under contention).  Default
    # unchanged so dense baselines stay pinned.
    capacity_repair: str = "halve"
    mtbf_s: float = float("inf")   # churn off by default
    mttr_s: float = 30.0
    rel_change: float = 0.05       # incremental-solver link-drift threshold
    max_path_cost_s: float = 1e6   # admission bar: reject _BIG-priced paths
    sparse_k: int | None = None    # k-candidate budget for *-sparse planners
    # Epoch re-solves place all pending requests in one batched sweep launch
    # (core/batch_dp, on ``device``) — bit-identical admission, large-N speedup.
    batch_solve: bool = False
    # Degraded-view axis (ROADMAP): what the planner sees vs what serves.
    # None ⇒ the planner's preferred fresh view; "stale:<ticks>" ⇒ snapshot /
    # horizon captured that many ticks ago (StaleView); "noisy:<std>" ⇒
    # horizon rates with lognormal prediction error (NoisyHorizonView;
    # snapshot planners are unaffected — a snapshot is measured, not
    # predicted, so its degradation axis is staleness).
    view_degradation: str | None = None
    # Executed-latency sampling (repro_torch.exec): serve latencies use
    # measured stage wall-clock (apply_layers on ``device``) instead of the
    # analytic c_j/speed term; link delays stay priced per realized tick.
    execute: bool = False
    frame_hw: tuple[int, int, int] = (326, 595, 3)
    # Byte-moving substrate for executed mode: "inproc" keeps the
    # modeled-delay path.  The reference's "loopback"/"multiproc" (worker OS
    # processes shipping each newly-seen stage-boundary activation, so
    # SimResult carries realized substrate bandwidth per link) are not
    # ported yet: executed mode raises on them.
    transport: str = "inproc"
    # The reference's persistent compile cache dir (executed mode's engine
    # warms from disk); not ported yet: any value raises.
    compile_cache_dir: str | None = None
    # Per-epoch slack-capacity DP lower bound (core.ould.placement_drift):
    # logs how far kept placements drifted from their per-request optimum.
    track_improvement_bound: bool = False
    radio: RadioParams = RadioParams()
    # Where the card-bound parts run (batch_solve's sweep, executed mode's
    # stages): "cuda" (raises without a card) or "cpu" (plain versions).
    # Read only when batch_solve or execute is set.
    device: str = "cuda"

    def mobility(self, seed: int) -> MultiGroupMobility:
        return MultiGroupMobility(
            RPGParams(n_uavs=self.n_uavs, area_m=self.area_m,
                      member_radius_m=self.member_radius_m,
                      leader_speed_mps=self.leader_speed_mps,
                      step_s=self.tick_s, homogeneous=self.homogeneous),
            n_groups=self.n_groups, seed=seed)

    def mem_cap(self, group_of: np.ndarray) -> np.ndarray:
        return np.where(group_of == 0, self.mem_mb_hotspot_group * MB,
                        self.mem_mb_other_groups * MB)

    def classes(self) -> tuple[DeadlineClass, ...]:
        return (self.deadline_classes
                or (DeadlineClass("standard", self.deadline_s),))


@dataclasses.dataclass(frozen=True)
class StreamRequest:
    id: int
    source: int
    arrive_tick: int
    depart_tick: int
    klass: int = 0               # index into the scenario's deadline classes


# ---------------------------------------------------------------------------
# Event tape — the frozen stochastic input every policy replays
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EventTape:
    """Everything random about one scenario run, drawn once per seed.

    Policies never touch the rng: they replay this tape, which is what makes
    per-request metrics paired across policies (and what the pairing test
    pins as data — :meth:`signature`)."""

    n_ticks: int
    tick_s: float
    epoch_ticks: int
    streams: tuple[StreamRequest, ...]
    arrival_times_s: tuple[float, ...]
    churn: tuple[ChurnEvent, ...]

    def queue(self) -> EventQueue:
        """Materialize the event queue (same-time ties pop in the insertion
        order fixed here: arrivals/departures, churn, epoch, mobility tick,
        then the tick's queue advance)."""
        q = EventQueue()
        for s, t_arr in zip(self.streams, self.arrival_times_s):
            q.push(t_arr, EventKind.ARRIVAL, s.id)
            q.push(s.depart_tick * self.tick_s, EventKind.DEPARTURE, s.id)
        for ce in self.churn:
            q.push(ce.time, ce.kind, ce.node)
        for k in range(0, self.n_ticks, self.epoch_ticks):
            q.push(k * self.tick_s, EventKind.EPOCH)
        for t in range(self.n_ticks):
            q.push(t * self.tick_s, EventKind.MOBILITY_TICK, t)
        for t in range(self.n_ticks):
            q.push(t * self.tick_s, EventKind.QUEUE_ADVANCE, t)
        return q

    def signature(self) -> dict[str, np.ndarray]:
        """The tape as arrays — two runs are paired iff these are equal."""
        return {
            "arrive_tick": np.array([s.arrive_tick for s in self.streams]),
            "depart_tick": np.array([s.depart_tick for s in self.streams]),
            "source": np.array([s.source for s in self.streams]),
            "klass": np.array([s.klass for s in self.streams]),
            "churn_time": np.array([c.time for c in self.churn]),
            "churn_node": np.array([c.node for c in self.churn]),
        }


def build_event_tape(scn: SwarmScenario, seed: int) -> EventTape:
    """Draw the scenario's full stochastic input (policy-independent)."""
    rng = np.random.default_rng(seed)
    T = scn.duration_ticks
    n_classes = len(scn.classes())
    arrivals = poisson_process(rng, scn.arrival_rate_hz, T * scn.tick_s)
    streams: list[StreamRequest] = []
    for i, t_arr in enumerate(arrivals):
        hold = max(1, int(round(rng.exponential(scn.hold_ticks_mean))))
        src = int(rng.integers(0, min(scn.hotspots, scn.n_uavs)))
        # Class draw only when tiers exist: a single-class scenario's tape
        # stays bit-identical to the pre-tier simulator.
        klass = int(rng.integers(0, n_classes)) if n_classes > 1 else 0
        at = int(t_arr / scn.tick_s)
        streams.append(StreamRequest(i, src, at, min(at + hold, T), klass))
    protected = frozenset(range(min(scn.hotspots, scn.n_uavs)))
    churn = churn_events(rng, scn.n_uavs, T * scn.tick_s, scn.mtbf_s,
                         scn.mttr_s, protected=protected)
    return EventTape(T, scn.tick_s, scn.epoch_ticks, tuple(streams),
                     tuple(float(t) for t in arrivals), tuple(churn))


# ---------------------------------------------------------------------------
# Results
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class EpochLog:
    tick: int
    n_active: int
    n_admitted: int
    n_kept: int
    n_replaced: int
    solve_time_s: float
    objective: float
    feasible: bool
    n_queue_rejected: int = 0    # streams the queue-depth bar turned away
    # Improvement-bound hook (track_improvement_bound): total / worst gap
    # between kept placements and their slack-capacity DP lower bound.
    drift_total_s: float = 0.0
    drift_max_s: float = 0.0


@dataclasses.dataclass
class SimResult:
    policy: str
    n_arrivals: int
    n_never_admitted: int        # streams rejected at every epoch they lived
    served: int                  # frame serve attempts by admitted streams
    missed: int                  # over-deadline completions + outage serves
    latencies: np.ndarray        # finite realized per-frame latencies (s)
    epochs: list[EpochLog]
    outages: int = 0             # serves lost to dead nodes / faded links
    dropped: int = 0             # frames reneged by the drop policy
    degraded: int = 0            # frames served in skip/light form
    frames_rejected: int = 0     # frames turned away at the queue (reject)
    wait_total_s: float = 0.0    # total queueing delay across completions
    # (N,) offered service seconds per node over the whole run;
    # max / horizon = realized overload factor at the hottest queue
    queue_demand_s: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0))
    # Byte-moving substrate telemetry (executed mode with a non-inproc
    # transport): realized bytes/s per sampled link, worker process pids.
    transport: str = "inproc"
    link_bytes_per_s: dict = dataclasses.field(default_factory=dict)
    warm_starts: int = 0         # churn-rejoin warm_start invocations
    drift_resolves: int = 0      # re-solves fired by resolve_on_drift
    # MetricsRegistry.snapshot() of the run: every layer's telemetry
    # (sim.* counters, queue.* tallies, solver.* aggregates, the latency
    # histogram, transport link gauges) behind one dict — DESIGN.md §9.
    metrics: dict = dataclasses.field(default_factory=dict)

    @property
    def deadline_miss_rate(self) -> float:
        return self.missed / self.served if self.served else 0.0

    @property
    def over_deadline_miss_rate(self) -> float:
        """Misses that *completed* but late — ``missed`` minus outages."""
        return (self.missed - self.outages) / self.served if self.served \
            else 0.0

    @property
    def outage_rate(self) -> float:
        return self.outages / self.served if self.served else 0.0

    @property
    def loss_rate(self) -> float:
        """Frames that produced no timely decision: late completions,
        outages, policy drops, and queue rejections."""
        if not self.served:
            return 0.0
        return (self.missed + self.dropped + self.frames_rejected) / self.served

    @property
    def rejection_rate(self) -> float:
        return self.n_never_admitted / self.n_arrivals if self.n_arrivals else 0.0

    @property
    def avg_latency_s(self) -> float:
        return float(self.latencies.mean()) if self.latencies.size else float("inf")

    def _percentile(self, q: float) -> float:
        finite = self.latencies[np.isfinite(self.latencies)]
        return float(np.percentile(finite, q)) if finite.size else float("inf")

    @property
    def p50_latency_s(self) -> float:
        return self._percentile(50.0)

    @property
    def p99_latency_s(self) -> float:
        return self._percentile(99.0)

    @property
    def p999_latency_s(self) -> float:
        return self._percentile(99.9)

    @property
    def total_resolve_s(self) -> float:
        return float(sum(e.solve_time_s for e in self.epochs))

    # -- improvement-bound hook (track_improvement_bound) -------------------
    @property
    def placement_drift_s(self) -> np.ndarray:
        """Per-epoch total drift of kept placements vs their slack-capacity
        DP lower bound (zeros unless the scenario tracked the bound)."""
        return np.array([e.drift_total_s for e in self.epochs])

    @property
    def mean_placement_drift_s(self) -> float:
        d = self.placement_drift_s
        return float(d.mean()) if d.size else 0.0

    @property
    def max_placement_drift_s(self) -> float:
        return float(max((e.drift_max_s for e in self.epochs), default=0.0))


# ---------------------------------------------------------------------------
# Scalar serve references (kept as the vectorized path's ground truth)
# ---------------------------------------------------------------------------

def _masked(rates: np.ndarray, alive: np.ndarray) -> np.ndarray:
    """Zero every link touching a dead node (ρ = 0 ⇔ disconnected)."""
    if alive.all():
        return rates
    out = rates.copy()
    if out.ndim == 3:                     # (T, N, N) horizon stack
        out[:, ~alive, :] = 0.0
        out[:, :, ~alive] = 0.0
    else:
        out[~alive, :] = 0.0
        out[:, ~alive] = 0.0
    return out


def _spb(rates: np.ndarray) -> np.ndarray:
    """(N,N) realized seconds/byte of one tick's snapshot (Eq. 1 inverted;
    matches Problem.transfer_cost's bits/s convention)."""
    with np.errstate(divide="ignore"):
        s = np.where(rates > 0, 8.0 / np.maximum(rates, 1e-30), np.inf)
    np.fill_diagonal(s, 0.0)
    return s


def _serve_once(path: np.ndarray, src: int, spb_t: np.ndarray,
                alive: np.ndarray, K: list[float], Ks: float,
                comp: list[float], speed: np.ndarray) -> float:
    """Scalar reference: uncontended end-to-end latency of one frame at one
    tick (inf = outage).  The vectorized serve step must reproduce this for
    every frame when queues are empty — pinned by a test."""
    if not alive[src] or not alive[path].all():
        return float("inf")
    lat = 0.0 if path[0] == src else Ks * spb_t[src, int(path[0])]
    for j in range(len(path)):
        i = int(path[j])
        lat += comp[j] / speed[i]
        if j + 1 < len(path) and path[j + 1] != i:
            lat += K[j] * spb_t[i, int(path[j + 1])]
    return float(lat)


def _parse_degradation(spec: str | None) -> tuple[str, float] | None:
    """``"stale:3"`` / ``"noisy:0.25"`` → (mode, value)."""
    if spec is None:
        return None
    mode, _, val = spec.partition(":")
    if mode not in ("stale", "noisy"):
        raise ValueError(f"unknown view degradation {spec!r}; "
                         "use 'stale:<ticks>' or 'noisy:<std>'")
    return mode, float(val or 0.0)


def _stage_measurer(scn: SwarmScenario, profile: ModelProfile, seed: int,
                    transport=None, tracer=None):
    """Measured-seconds lookup for stage ranges: one ExecutionEngine on
    ``scn.device`` per simulation, one warm-up + one measurement per unique
    (start, end) range — hotspot plans collapse to a handful of timings.

    With a byte-moving ``transport``, each newly-seen stage-boundary
    activation is additionally shipped once through it, sampling the
    substrate's realized bandwidth at that payload size
    (SimResult.link_bytes_per_s)."""
    import torch

    from ..exec import ExecutionEngine, layer_fns_for

    dev = resolve_device(scn.device)
    engine = ExecutionEngine(layer_fns_for(profile, device=dev),
                             transport=transport, tracer=tracer, device=dev)
    rng = np.random.default_rng(seed)
    frame = rng.standard_normal((1, *scn.frame_hw)).astype(np.float32)
    # boundary activations on the engine's device, lazily
    acts: dict[int, object] = {0: torch.from_numpy(frame).to(dev)}
    cache: dict[tuple[int, int], float] = {}
    shipped: set[int] = set()

    def act_at(layer: int):
        if layer not in acts:
            acts[layer] = engine.closure(layer - 1, layer)(act_at(layer - 1))
        return acts[layer]

    def measure(layer_start: int, layer_end: int) -> float:
        key = (layer_start, layer_end)
        if key not in cache:
            cache[key] = engine.measure_range(layer_start, layer_end,
                                              act_at(layer_start))
            if (transport is not None and layer_start > 0
                    and layer_start not in shipped):
                shipped.add(layer_start)
                transport.ship(0, 1, act_at(layer_start))
        return cache[key]

    measure.engine = engine     # exposed for churn-rejoin warm starts
    measure.frame = frame
    return measure


# ---------------------------------------------------------------------------
# Placement table — struct-of-arrays over currently placed streams
# ---------------------------------------------------------------------------

class _PlacementTable:
    """The serve step's working set: parallel arrays over placed streams.

    Rebuilt whenever the placement dict changes (epoch re-solve, stream
    departure); between rebuilds the per-tick serve step is pure numpy
    gathers over these arrays.  Each stream's *queueing point* is the node
    hosting its heaviest stage (the compute bottleneck); ``service_s`` is
    that stage's wall and ``comp_s`` the whole path's compute, so
    ``base + service == uncontended latency`` exactly."""

    def __init__(self, comp: np.ndarray, speed: np.ndarray,
                 deadline_of: np.ndarray, measure=None,
                 k_bytes: np.ndarray | None = None, perhop: bool = False):
        self._comp = comp                    # (M,) FLOPs per layer
        self._speed = speed                  # (N,) FLOPs/s
        self._deadline_of = deadline_of      # (n_classes,) seconds
        self._measure = measure              # executed-mode stage wall lookup
        self._k_bytes = k_bytes              # (M,) boundary bytes per layer
        self._perhop = perhop                # also build full hop schedules
        self.clear()

    def clear(self) -> None:
        self.ids = np.zeros(0, np.int64)
        self.src = np.zeros(0, np.int64)
        self.path = np.zeros((0, self._comp.size), np.int64)
        self.arrive = np.zeros(0, np.int64)
        self.depart = np.zeros(0, np.int64)
        self.deadline_s = np.zeros(0)
        self.q_node = np.zeros(0, np.int64)
        self.service_s = np.zeros(0)
        self.comp_s = np.zeros(0)
        # Hop schedule (perhop mode): per stream, the ordered stages of its
        # placed path — stage_node[s, k] hosts stage k for stage_wall[s, k]
        # seconds, bound_bytes[s, k] bytes cross the (k → k+1) boundary.
        # -1 / 0 pad rows with fewer stages.
        self.stage_node = np.zeros((0, 1), np.int64)
        self.stage_wall = np.zeros((0, 1))
        self.bound_bytes = np.zeros((0, 1))

    def rebuild(self, placed: dict[int, np.ndarray],
                streams: dict[int, "StreamRequest"]) -> None:
        ids = sorted(placed)
        S, M = len(ids), self._comp.size
        self.ids = np.array(ids, np.int64)
        self.path = (np.stack([placed[i] for i in ids])
                     if ids else np.zeros((0, M), np.int64))
        self.src = np.array([streams[i].source for i in ids], np.int64)
        self.arrive = np.array([streams[i].arrive_tick for i in ids],
                               np.int64)
        self.depart = np.array([streams[i].depart_tick for i in ids],
                               np.int64)
        self.deadline_s = self._deadline_of[
            np.array([streams[i].klass for i in ids], np.int64)] \
            if ids else np.zeros(0)
        if not ids:
            self.q_node = np.zeros(0, np.int64)
            self.service_s = np.zeros(0)
            self.comp_s = np.zeros(0)
            self.stage_node = np.zeros((0, 1), np.int64)
            self.stage_wall = np.zeros((0, 1))
            self.bound_bytes = np.zeros((0, 1))
            return
        if self._measure is None:
            per_layer = self._comp[None, :] / self._speed[self.path]
            rows = np.arange(S)[:, None]
            stage_id = np.zeros((S, M), np.int64)
            stage_id[:, 1:] = np.cumsum(self.path[:, 1:] != self.path[:, :-1],
                                        axis=1)
            stage_sum = np.zeros((S, M))
            np.add.at(stage_sum, (np.broadcast_to(rows, (S, M)), stage_id),
                      per_layer)
            per_layer_stage = stage_sum[np.broadcast_to(rows, (S, M)),
                                        stage_id]
            j_star = np.argmax(per_layer_stage, axis=1)
            self.service_s = per_layer_stage[np.arange(S), j_star]
            self.q_node = self.path[np.arange(S), j_star]
            self.comp_s = per_layer.sum(axis=1)
            if self._perhop:
                rows_b = np.broadcast_to(rows, (S, M))
                s_max = int(stage_id[:, -1].max()) + 1
                sn = np.full((S, s_max), -1, np.int64)
                sn[rows_b, stage_id] = self.path
                # Same np.add.at accumulation order as stage_sum above, so
                # stage walls are float-identical to the bottleneck table's.
                sw = np.zeros((S, s_max))
                np.add.at(sw, (rows_b, stage_id), per_layer)
                bb = np.zeros((S, s_max))
                b_mask = self.path[:, 1:] != self.path[:, :-1]
                bb[rows_b[:, :-1][b_mask], stage_id[:, :-1][b_mask]] = \
                    np.broadcast_to(self._k_bytes[None, :-1],
                                    (S, M - 1))[b_mask]
                self.stage_node, self.stage_wall = sn, sw
                self.bound_bytes = bb
        else:                               # executed mode: measured walls
            q_node = np.zeros(S, np.int64)
            service = np.zeros(S)
            comp_s = np.zeros(S)
            stage_rows = []
            for row in range(S):
                stages = to_stages(self.path[row])
                walls = [(self._measure(st.layer_start, st.layer_end),
                          st.node) for st in stages]
                comp_s[row] = sum(w for w, _ in walls)
                service[row], q_node[row] = max(walls)
                stage_rows.append([(st.node, w, st.layer_end)
                                   for (w, _), st in zip(walls, stages)])
            self.q_node, self.service_s, self.comp_s = q_node, service, comp_s
            if self._perhop:
                s_max = max(len(sr) for sr in stage_rows)
                sn = np.full((S, s_max), -1, np.int64)
                sw = np.zeros((S, s_max))
                bb = np.zeros((S, s_max))
                for row, sr in enumerate(stage_rows):
                    for k, (node, wall, layer_end) in enumerate(sr):
                        sn[row, k] = node
                        sw[row, k] = wall
                        if k + 1 < len(sr):
                            bb[row, k] = self._k_bytes[layer_end - 1]
                self.stage_node, self.stage_wall = sn, sw
                self.bound_bytes = bb

    def active_rows(self, tick: int) -> np.ndarray:
        return np.flatnonzero((self.arrive <= tick) & (tick < self.depart))


# ---------------------------------------------------------------------------
# The simulation — tape replay over the layered runtime
# ---------------------------------------------------------------------------

class _Simulation:
    """One policy replaying one tape: epoch loop (admission + placement),
    vectorized serve step (frame emission), and queue advance (completion
    accounting) — the decomposed form of the old monolithic ``simulate``."""

    def __init__(self, scn: SwarmScenario, policy: str, seed: int,
                 profile: ModelProfile, cold_resolves: bool, tracer=None):
        if policy not in available_planners():
            raise ValueError(f"unknown policy {policy!r}; one of "
                             f"{available_planners()}")
        if scn.compile_cache_dir is not None:
            raise NotImplementedError(
                "compile_cache_dir: the compile cache (exec/compile_cache.py) "
                "is not ported yet (ROADMAP Queue 1)")
        if scn.execute and scn.transport != "inproc":
            raise NotImplementedError(
                f"transport {scn.transport!r}: the byte-moving transports "
                "are not ported yet (ROADMAP Queue 1); executed mode runs "
                "on 'inproc'")
        if scn.batch_solve or scn.execute:
            resolve_device(scn.device)   # raises where the card is missing
        self.scn = scn
        # Observability: NullTracer by default (traced-off path bit-identical
        # — every emit below is guarded by ``trace.enabled``); the registry
        # is filled once at end of run from the layers' own counters.
        self.trace = tracer if tracer is not None else NULL_TRACER
        self.metrics = MetricsRegistry()
        self._churn_track = (self.trace.track("churn")
                             if self.trace.enabled else -1)
        if self.trace.enabled:
            self.trace.intern("frame", "base_s", "service_s")
        self.policy = policy
        self.seed = seed
        self.profile = profile
        self.tape = build_event_tape(scn, seed)
        self.streams = {s.id: s for s in self.tape.streams}

        mob = scn.mobility(seed)
        T = scn.duration_ticks
        pos = mob.positions(T, seed=seed + 1)
        self.rates_t = [rate_matrix(pos[t], scn.radio) for t in range(T)]
        self.mem_cap = scn.mem_cap(mob.group_of)
        self.comp_cap = np.full(scn.n_uavs, scn.comp_cap_flops)
        self.speed = np.full(scn.n_uavs, scn.gflops)
        self.K = np.asarray(profile.output_vector())
        self.Ks = profile.input_bytes
        self.comp = np.asarray(profile.compute_vector())
        self.deadline_of = np.array([c.deadline_s for c in scn.classes()])

        if scn.queue_model not in ("perhop", "bottleneck"):
            raise ValueError(f"unknown queue_model {scn.queue_model!r}; "
                             "one of ('perhop', 'bottleneck')")
        self.perhop = scn.queue_model == "perhop"
        self.ctrl = AdmissionController(policy, solver="dp",
                                        warm=not cold_resolves,
                                        rel_change=scn.rel_change,
                                        max_path_cost=scn.max_path_cost_s,
                                        sparse_k=scn.sparse_k,
                                        batch_solve=scn.batch_solve,
                                        device=scn.device,
                                        capacity_repair=scn.capacity_repair,
                                        tracer=self.trace,
                                        queue_model=scn.queue_model)
        self.wants_horizon = getattr(self.ctrl.planner, "preferred_view",
                                     "snapshot") == "horizon"
        self.degradation = _parse_degradation(scn.view_degradation)
        self.transport = None
        measure = (_stage_measurer(scn, profile, seed,
                                   transport=self.transport,
                                   tracer=self.trace)
                   if scn.execute else None)
        self.measure = measure
        self.warm_starts = 0         # churn-rejoin warm_start invocations
        self.table = _PlacementTable(self.comp, self.speed, self.deadline_of,
                                     measure, k_bytes=self.K,
                                     perhop=self.perhop)
        queues_cls = PathQueues if self.perhop else NodeQueues
        self.queues = queues_cls(scn.n_uavs,
                                 ServicePolicy.parse(scn.service_policy))

        # mutable run state
        self.alive = np.ones(scn.n_uavs, bool)
        self.active: dict[int, StreamRequest] = {}
        self.placed: dict[int, np.ndarray] = {}
        self.ever_admitted: set[int] = set()
        self._dirty = False                  # placement arrays need rebuild
        self._pending: dict | None = None    # this tick's emitted frames
        self.epochs: list[EpochLog] = []
        self._lat_chunks: list[np.ndarray] = []
        self.served = self.missed = self.outages = 0
        self.dropped = self.degraded = self.frames_rejected = 0
        self.wait_total_s = 0.0
        # sweep launches at a padded shape new to this process (the
        # reference counts XLA compiles under the same metric name)
        self._solver_jit_compiles = 0
        self.drift_resolves = 0

    # -- epoch layer --------------------------------------------------------
    def _build_view(self, tick: int):
        """The planner's view of the network at this epoch — fresh by
        default, degraded when the scenario asks (serving always happens on
        the realized per-tick rates, so the gap is measured, not assumed)."""
        scn, T = self.scn, self.scn.duration_ticks
        stale = 0
        if self.degradation is not None and self.degradation[0] == "stale":
            stale = int(self.degradation[1])
        seen = max(0, tick - stale)
        if self.wants_horizon:  # the epoch's predicted rates (Eq. 14 horizon)
            end = min(seen + scn.epoch_ticks, T)
            view = HorizonView(np.stack(self.rates_t[seen:end]),
                               self.alive.copy())
            if self.degradation is not None and self.degradation[0] == "noisy":
                view = NoisyHorizonView.corrupt(
                    view, self.degradation[1],
                    seed=self.seed * 100003 + tick)
            return view
        if stale:
            return StaleView(self.rates_t[seen], self.alive.copy(),
                             age_ticks=stale)
        return make_view(self.rates_t[tick], self.alive.copy())

    def on_epoch(self, tick: int) -> None:
        scn = self.scn
        act = sorted(self.active.values(), key=lambda s: s.id)
        self.placed = {}
        self._dirty = True
        if not act:
            self.epochs.append(EpochLog(tick, 0, 0, 0, 0, 0.0, 0.0, True))
            return
        sources = np.array([s.source for s in act], np.int64)
        ids = [s.id for s in act]
        view = self._build_view(tick)
        backlog = (self.queues.backlog_s(tick * scn.tick_s)
                   if scn.queue_aware_admission else None)
        deadline_s = self.deadline_of[np.array([s.klass for s in act])]
        plan = self.ctrl.admit(
            Problem(self.profile, self.mem_cap, self.comp_cap, view.rates,
                    sources, self.speed), view, request_ids=ids,
            backlog_s=backlog, deadline_s=deadline_s,
            now_s=tick * scn.tick_s)
        stats = plan.solve_stats
        n_kept = stats.n_kept if stats is not None else 0
        n_rep = stats.n_replaced if stats is not None else len(act)
        if stats is not None:
            self._solver_jit_compiles += stats.n_jit_compiles
        for row, s in enumerate(act):
            if plan.admitted[row]:
                self.placed[s.id] = plan.assign[row]
                self.ever_admitted.add(s.id)
        # capacity invariant under the *snapshot* problem (Eq. 4/5)
        feas_prob = SnapshotView(self.rates_t[tick], self.alive.copy()).bind(
            Problem(self.profile, self.mem_cap, self.comp_cap,
                    self.rates_t[tick], sources, self.speed))
        ev = evaluate(feas_prob, plan.solution)
        drift_total = drift_max = 0.0
        if scn.track_improvement_bound and plan.n_admitted:
            # How far do kept placements drift from each request's own
            # slack-capacity optimum, judged on the *realized* snapshot?
            drift = placement_drift(feas_prob, plan.assign, plan.admitted,
                                    sparse_k=scn.sparse_k)
            drift_total = float(drift.sum())
            drift_max = float(drift.max())
        self.epochs.append(EpochLog(
            tick, len(act), plan.n_admitted, n_kept, n_rep,
            plan.solve_time_s, plan.objective, ev.feasible,
            self.ctrl.last_queue_rejected,
            drift_total_s=drift_total, drift_max_s=drift_max))

    def _maybe_drift_resolve(self, t: int) -> None:
        """Drift-triggered re-placement (``resolve_on_drift``): on non-epoch
        ticks, re-solve early when the kept placements' mean drift from
        their slack-capacity DP optimum (judged on the realized snapshot)
        exceeds the threshold — the improvement-bound hook promoted from
        measuring the keep rule's cost to acting on it."""
        scn = self.scn
        if (scn.resolve_on_drift is None or not self.placed
                or t % scn.epoch_ticks == 0):
            return
        ids = sorted(self.placed)
        assign = np.stack([self.placed[i] for i in ids])
        sources = np.array([self.streams[i].source for i in ids], np.int64)
        prob = SnapshotView(self.rates_t[t], self.alive.copy()).bind(
            Problem(self.profile, self.mem_cap, self.comp_cap,
                    self.rates_t[t], sources, self.speed))
        drift = placement_drift(prob, assign, np.ones(len(ids), bool),
                                sparse_k=scn.sparse_k)
        if float(drift.mean()) > scn.resolve_on_drift:
            self.drift_resolves += 1
            self.on_epoch(t)

    # -- serve layer (vectorized frame emission) ----------------------------
    def on_tick(self, t: int) -> None:
        self._maybe_drift_resolve(t)
        if self._dirty:
            self.table.rebuild(self.placed, self.streams)
            self._dirty = False
        rows = self.table.active_rows(t)
        if rows.size == 0:
            return
        if self.perhop:
            self._on_tick_perhop(t, rows)
            return
        tab, K, Ks = self.table, self.K, self.Ks
        spb_t = _spb(_masked(self.rates_t[t], self.alive))
        src, path = tab.src[rows], tab.path[rows]
        outage = ~self.alive[src] | (~self.alive[path]).any(axis=1)

        first = path[:, 0]
        with np.errstate(invalid="ignore"):
            link_s = np.where(first == src, 0.0, Ks * spb_t[src, first])
            for j in range(path.shape[1] - 1):
                a, b = path[:, j], path[:, j + 1]
                link_s = link_s + np.where(a == b, 0.0, K[j] * spb_t[a, b])
        outage |= ~np.isfinite(link_s)

        self.served += rows.size
        n_out = int(outage.sum())
        self.outages += n_out
        self.missed += n_out                 # inf > any deadline
        if self.trace.enabled and n_out:
            self.trace.instant_batch(
                FRAMES, "outage", np.full(n_out, t * self.scn.tick_s),
                lane=src[outage], frame=tab.ids[rows[outage]])
        ok = ~outage
        if not ok.any():
            return
        r = rows[ok]
        arrival = np.full(r.size, t * self.scn.tick_s)
        # base excludes the bottleneck stage: the queue adds it back as the
        # frame's service (possibly degraded), so base + service == the
        # scalar reference exactly when queues are empty.
        base = link_s[ok] + tab.comp_s[r] - tab.service_s[r]
        self._pending = {
            "node": tab.q_node[r], "arrival": arrival,
            "service": tab.service_s[r],
            "deadline_abs": arrival + tab.deadline_s[r],
            "base": base,
        }
        if self.trace.enabled:
            self._pending["ids"] = tab.ids[r]

    def _on_tick_perhop(self, t: int, rows: np.ndarray) -> None:
        """Per-hop frame emission: instead of one ``(base, service)`` pair,
        each frame carries its full hop schedule — source uplink, each
        stage's compute server, each boundary's directed link — resources
        and services aligned as ``(F, 2·S_max)`` arrays for the tandem
        kernel (hop 0 = uplink; hop 2k+1 = stage k; hop 2k+2 = boundary
        k → k+1; ``res = -1`` pads)."""
        tab, Ks, scn = self.table, self.Ks, self.scn
        n = scn.n_uavs
        spb_t = _spb(_masked(self.rates_t[t], self.alive))
        src, path = tab.src[rows], tab.path[rows]
        outage = ~self.alive[src] | (~self.alive[path]).any(axis=1)

        sn = tab.stage_node[rows]
        sw = tab.stage_wall[rows]
        bb = tab.bound_bytes[rows]
        n_frames, s_max = sn.shape
        res = np.full((n_frames, 2 * s_max), -1, np.int64)
        svc = np.zeros((n_frames, 2 * s_max))
        first = sn[:, 0]
        has_up = first != src
        with np.errstate(invalid="ignore"):
            up_s = np.where(has_up, Ks * spb_t[src, first], 0.0)
            res[:, 0] = np.where(has_up, link_resource(n, src, first), -1)
            svc[:, 0] = up_s
            link_bad = ~np.isfinite(up_s)
            for k in range(s_max):
                node = sn[:, k]
                valid = node >= 0
                res[:, 2 * k + 1] = np.where(valid, node, -1)
                svc[:, 2 * k + 1] = np.where(valid, sw[:, k], 0.0)
                if k + 1 < s_max:
                    nxt = sn[:, k + 1]
                    hop_ok = nxt >= 0
                    a = np.where(valid, node, 0)
                    b = np.where(hop_ok, nxt, 0)
                    l_s = np.where(hop_ok, bb[:, k] * spb_t[a, b], 0.0)
                    res[:, 2 * k + 2] = np.where(hop_ok,
                                                 link_resource(n, a, b), -1)
                    svc[:, 2 * k + 2] = l_s
                    link_bad |= ~np.isfinite(l_s)
        outage |= link_bad

        self.served += rows.size
        n_out = int(outage.sum())
        self.outages += n_out
        self.missed += n_out                 # inf > any deadline
        if self.trace.enabled and n_out:
            self.trace.instant_batch(
                FRAMES, "outage", np.full(n_out, t * scn.tick_s),
                lane=src[outage], frame=tab.ids[rows[outage]])
        ok = ~outage
        if not ok.any():
            return
        r = rows[ok]
        arrival = np.full(r.size, t * scn.tick_s)
        self._pending = {
            "res": res[ok], "svc": svc[ok], "arrival": arrival,
            "deadline_abs": arrival + tab.deadline_s[r],
            "node": tab.q_node[r],
        }
        if self.trace.enabled:
            self._pending["ids"] = tab.ids[r]

    # -- queue layer (completion accounting) --------------------------------
    def on_queue_advance(self, t: int) -> None:
        if self._pending is None:
            return
        p, self._pending = self._pending, None
        if self.perhop:
            out = self.queues.advance(p["res"], p["svc"], p["arrival"],
                                      p["deadline_abs"])
            self.dropped += int(out.dropped.sum())
            self.frames_rejected += int(out.rejected.sum())
            self.degraded += int(out.degraded.sum())
            done = out.completed
            if done.any():
                lat = out.lat_s[done]
                self.wait_total_s += float(out.wait_total_s[done].sum())
                self.missed += int((lat > p["deadline_abs"][done]
                                    - p["arrival"][done]).sum())
                finite = lat[np.isfinite(lat)]
                if finite.size:
                    self._lat_chunks.append(finite)
            if self.trace.enabled:
                self._trace_path_outcome(p, out)
            return
        out = self.queues.advance(p["node"], p["arrival"], p["service"],
                                  p["deadline_abs"])
        self.dropped += int(out.dropped.sum())
        self.frames_rejected += int(out.rejected.sum())
        self.degraded += int(out.degraded.sum())
        done = out.completed
        lat = None
        if done.any():
            lat = (p["base"][done] + out.wait_s[done]
                   + out.service_used_s[done])
            self.wait_total_s += float(out.wait_s[done].sum())
            self.missed += int((lat > p["deadline_abs"][done]
                                - p["arrival"][done]).sum())
            finite = lat[np.isfinite(lat)]
            if finite.size:
                self._lat_chunks.append(finite)
        if self.trace.enabled:
            self._trace_queue_outcome(p, out, lat)

    def _trace_queue_outcome(self, p: dict, out, lat) -> None:
        """Rebuild this window's per-frame spans from the Lindley kernel
        outputs — post-hoc and vectorized, never inside the kernel
        (DESIGN.md §9).  Span algebra the audit test pins:
        ``frame.dur == base_s + queue_wait.dur + service.dur``."""
        tr, ids, node, arr = self.trace, p["ids"], p["node"], p["arrival"]
        done = out.completed
        if lat is not None:
            a, ln, fr = arr[done], node[done], ids[done]
            sv = out.service_used_s[done]
            tr.span_batch(QUEUE, "queue_wait", a, out.wait_s[done],
                          lane=ln, frame=fr)
            tr.span_batch(QUEUE, "service", out.start_s[done], sv,
                          lane=ln, frame=fr)
            tr.span_batch(FRAMES, "frame", a, lat, lane=ln, frame=fr,
                          a0=p["base"][done], a1=sv)
        for name, mask in (("drop", out.dropped),
                           ("reject_queue", out.rejected)):
            if mask.any():
                tr.instant_batch(FRAMES, name, arr[mask], lane=node[mask],
                                 frame=ids[mask])

    def _trace_path_outcome(self, p: dict, out) -> None:
        """Per-hop spans reconstructed post hoc from the tandem kernel
        outputs (DESIGN.md §10): every real hop of a completed frame emits
        a ``hop_wait`` span (previous hop's finish → this hop's service
        start) plus a ``hop_service`` (compute hop) or ``link`` (transfer
        hop) span.  Audit algebra: ``frame.dur == Σ hop_wait.dur +
        Σ hop_service.dur + Σ link.dur`` per frame id."""
        tr, ids, arr = self.trace, p["ids"], p["arrival"]
        res, node = p["res"], p["node"]
        done = out.completed
        n = self.scn.n_uavs
        if done.any():
            tr.span_batch(FRAMES, "frame", arr[done], out.lat_s[done],
                          lane=node[done], frame=ids[done],
                          a0=out.wait_total_s[done],
                          a1=out.lat_s[done] - out.wait_total_s[done])
            for h in range(res.shape[1]):
                real = done & (res[:, h] >= 0)
                if not real.any():
                    continue
                is_link = real & (res[:, h] >= n)
                is_node = real & ~is_link
                st = out.start_s[:, h]
                w = out.wait_s[:, h]
                sv = out.service_used_s[:, h]
                tr.span_batch(QUEUE, "hop_wait", st[real] - w[real],
                              w[real], lane=res[real, h], frame=ids[real])
                if is_node.any():
                    tr.span_batch(QUEUE, "hop_service", st[is_node],
                                  sv[is_node], lane=res[is_node, h],
                                  frame=ids[is_node])
                if is_link.any():
                    tr.span_batch(QUEUE, "link", st[is_link], sv[is_link],
                                  lane=res[is_link, h] - n,
                                  frame=ids[is_link])
        for name, mask in (("drop", out.dropped),
                           ("reject_queue", out.rejected)):
            if mask.any():
                tr.instant_batch(FRAMES, name, arr[mask], lane=node[mask],
                                 frame=ids[mask])

    def _warm_rejoin(self) -> None:
        """Warm the live plan's stage signature on churn rejoin.

        A node that rejoins mid-scenario will be handed stages from the
        next epoch's plan; the distinct ``(layer_start, layer_end)`` ranges
        of the *current* placements are the best predictor of that
        signature, and warming them (cuDNN's algorithm choice, the caching
        allocator) keeps that cost off the serving clock
        (ExecutionEngine.warm_start; executed mode only)."""
        if self.measure is None or not self.placed:
            return
        sig = {(st.layer_start, st.layer_end)
               for path in self.placed.values() for st in to_stages(path)}
        self.measure.engine.warm_start(sorted(sig), self.measure.frame[0])
        self.warm_starts += 1

    # -- run loop -----------------------------------------------------------
    def run(self) -> SimResult:
        try:
            return self._run()
        finally:
            if self.transport is not None:
                self.transport.close()

    def _run(self) -> SimResult:
        q = self.tape.queue()
        while q:
            ev = q.pop()
            if ev.kind == EventKind.ARRIVAL:
                self.active[ev.payload] = self.streams[ev.payload]
                if self.trace.enabled:
                    self.trace.instant(
                        FRAMES, "arrival", ev.time,
                        lane=self.streams[ev.payload].source,
                        frame=ev.payload)
            elif ev.kind == EventKind.DEPARTURE:
                self.active.pop(ev.payload, None)
                if self.placed.pop(ev.payload, None) is not None:
                    self._dirty = True
            elif ev.kind == EventKind.NODE_FAIL:
                self.alive[ev.payload] = False
                if self.trace.enabled:
                    self.trace.instant(self._churn_track, "node_fail",
                                       ev.time, lane=ev.payload)
            elif ev.kind == EventKind.NODE_REJOIN:
                self.alive[ev.payload] = True
                if self.trace.enabled:
                    self.trace.instant(self._churn_track, "node_rejoin",
                                       ev.time, lane=ev.payload)
                self._warm_rejoin()
            elif ev.kind == EventKind.EPOCH:
                self.on_epoch(int(round(ev.time / self.scn.tick_s)))
            elif ev.kind == EventKind.MOBILITY_TICK:
                self.on_tick(ev.payload)
            elif ev.kind == EventKind.QUEUE_ADVANCE:
                self.on_queue_advance(ev.payload)
        lats = (np.concatenate(self._lat_chunks) if self._lat_chunks
                else np.zeros(0))
        n_never = sum(1 for s in self.streams.values()
                      if s.id not in self.ever_admitted)
        link_bw = ({k: ls.bytes_per_s
                    for k, ls in self.transport.link_stats.items()}
                   if self.transport is not None else {})
        self._fill_metrics(lats, link_bw)
        return SimResult(self.policy, len(self.streams), n_never,
                         self.served, self.missed, lats, self.epochs,
                         outages=self.outages, dropped=self.dropped,
                         degraded=self.degraded,
                         frames_rejected=self.frames_rejected,
                         wait_total_s=self.wait_total_s,
                         queue_demand_s=self.queues.demand_s.copy(),
                         transport=self.scn.transport if self.scn.execute
                         else "inproc",
                         link_bytes_per_s=link_bw,
                         warm_starts=self.warm_starts,
                         drift_resolves=self.drift_resolves,
                         metrics=self.metrics.snapshot())

    def _fill_metrics(self, lats: np.ndarray, link_bw: dict) -> None:
        """Fold every layer's private run telemetry into the registry —
        the one ``snapshot()`` SimResult/bench/CLI report (DESIGN.md §9).
        Filled once at end of run from counters the layers kept anyway, so
        the per-tick hot path is untouched."""
        m = self.metrics
        for name, v in (("sim.arrivals", len(self.streams)),
                        ("sim.served", self.served),
                        ("sim.missed", self.missed),
                        ("sim.outages", self.outages),
                        ("sim.dropped", self.dropped),
                        ("sim.degraded", self.degraded),
                        ("sim.frames_rejected", self.frames_rejected),
                        ("sim.completions", int(lats.size)),
                        ("solver.epochs", len(self.epochs)),
                        ("solver.n_kept",
                         sum(e.n_kept for e in self.epochs)),
                        ("solver.n_replaced",
                         sum(e.n_replaced for e in self.epochs)),
                        ("solver.queue_rejected",
                         sum(e.n_queue_rejected for e in self.epochs)),
                        ("solver.jit_compiles", self._solver_jit_compiles),
                        ("solver.warm_starts", self.warm_starts),
                        ("solver.drift_resolves", self.drift_resolves)):
            m.counter(name).inc(v)
        m.gauge("sim.wait_total_s").set(self.wait_total_s)
        m.gauge("solver.total_solve_s").set(
            float(sum(e.solve_time_s for e in self.epochs)))
        for name, v in self.queues.snapshot().items():
            if isinstance(v, float):
                m.gauge(name).set(v)
            else:
                m.counter(name).inc(v)
        m.histogram("sim.latency_s", LATENCY_EDGES_S).observe_many(lats)
        for link, bps in link_bw.items():
            m.gauge(f"transport.link.{link}.bytes_per_s").set(float(bps))
        if self.trace.enabled:
            m.gauge("trace.n_events").set(self.trace.n_events)
            m.gauge("trace.n_dropped").set(self.trace.n_dropped)


def simulate(scn: SwarmScenario, policy: str, seed: int = 0, *,
             profile: ModelProfile | None = None,
             cold_resolves: bool = False, tracer=None) -> SimResult:
    """Run one policy over the scenario's event tape.

    ``cold_resolves=True`` forces every epoch re-solve from scratch (the
    baseline the warm-started incremental path is measured against); it only
    affects solve *time*, never the event tape.

    ``tracer`` is an optional :class:`repro_torch.obs.Tracer`: per-frame spans are
    reconstructed from the queue kernel outputs onto it (timestamps in
    *simulated* seconds), plus solver/admission/churn events; ``None`` keeps
    the NullTracer default — the traced-off serving path is bit-identical.
    """
    return _Simulation(scn, policy, seed, profile or lenet_profile(),
                       cold_resolves, tracer).run()


def compare_policies(scn: SwarmScenario, seed: int = 0,
                     policies=POLICIES,
                     profile: ModelProfile | None = None) -> dict[str, SimResult]:
    """Run every policy over the SAME event tape (paired comparison)."""
    return {p: simulate(scn, p, seed, profile=profile) for p in policies}


def warm_vs_cold(scn: SwarmScenario, seed: int = 0,
                 profile: ModelProfile | None = None) -> dict:
    """Measure what the incremental solver buys: identical OULD runs, one
    with warm epoch re-solves, one forced cold.  The event tape and placement
    *decisions* may only differ where the warm path keeps a placement the
    cold solve would recompute identically — the objective ratio reports any
    drift."""
    warm = simulate(scn, "incremental", seed, profile=profile,
                    cold_resolves=False)
    cold = simulate(scn, "incremental", seed, profile=profile,
                    cold_resolves=True)
    ratios = [w.objective / c.objective
              for w, c in zip(warm.epochs, cold.epochs)
              if c.objective > 0 and np.isfinite(c.objective)]
    return {
        "warm_solve_s": warm.total_resolve_s,
        "cold_solve_s": cold.total_resolve_s,
        "speedup": (cold.total_resolve_s / warm.total_resolve_s
                    if warm.total_resolve_s > 0 else float("inf")),
        "objective_ratio_max": max(ratios) if ratios else 1.0,
        "warm": warm,
        "cold": cold,
    }
