"""Structured frame tracing: a bounded flight-recorder ring buffer with
Chrome trace-event export (DESIGN.md §9).

The serving path's whole objective is the latency between data collection
and decision-making, yet scenario-level aggregates (p50/p99/p999, miss
decomposition) cannot say *where inside one frame's life* the time went —
queue wait vs re-solve stall vs stage wall vs transfer.  The tracer is that
causal layer: subsystems emit **spans** (an interval with a duration) and
**instants** (a point event) onto named tracks, and the recorder keeps the
most recent ``capacity`` events in numpy struct-of-arrays — no per-event
Python object allocation on the hot path, vectorized batch appends for the
per-frame reconstruction, and a hard memory bound no matter how long the
scenario runs (older events are overwritten, counted in ``n_dropped``).

Two contracts keep the overhead honest:

* **The default is off.**  :class:`NullTracer` implements the same API as
  no-ops; every traced call site guards bulk argument preparation with
  ``tracer.enabled``, so the traced-off serving path is bit-identical to
  the pre-tracing code and costs ~one attribute check per window.
* **Reconstruct from kernel outputs, never instrument inside jit.**  The
  vectorized queue advance, the jitted DP dispatch, and the stage closures
  are never modified to emit events mid-kernel; callers rebuild each
  frame's spans *post hoc* from the arrays those kernels already return
  (Lindley start/finish, ``ResolveStats``, measured stage walls).  Tracing
  therefore cannot perturb the numbers it reports.

``export_chrome(path)`` writes the Chrome trace-event JSON array format —
loadable in Perfetto (https://ui.perfetto.dev) or ``chrome://tracing`` —
with one *process* per track (admission / solver / queue / engine /
transport / frames) and one *thread* per lane (node id), so a swarm's
per-node queues render as parallel timelines.
"""

from __future__ import annotations

import json
import math
import time

import numpy as np

# Pre-registered subsystem tracks (Chrome pid).  New subsystems register
# theirs via ``Tracer.track(name)`` — codes are allocated in call order.
ADMISSION = 0
SOLVER = 1
QUEUE = 2
ENGINE = 3
TRANSPORT = 4
FRAMES = 5

_BUILTIN_TRACKS = ("admission", "solver", "queue", "engine", "transport",
                   "frames")

# Sentinel duration marking an instant event in the ring buffer.
_INSTANT = -1.0


class Tracer:
    """Bounded structured event recorder (one instance == one trace).

    Events live in parallel numpy arrays of fixed ``capacity``; appends
    wrap around (flight recorder: the *latest* events survive).  Columns:

    ========  =======================================================
    ``ts``    event start, seconds (caller's time domain — simulated
              seconds in the swarm runtime, wall seconds in the CLI)
    ``dur``   span duration in seconds; ``-1`` marks an instant
    ``name``  interned name id (:meth:`intern`)
    ``track`` subsystem code (:meth:`track`)
    ``lane``  sub-track within the subsystem — node id, or 0
    ``frame`` stream/request id the event belongs to, or ``-1``
    ``a0/a1`` two numeric argument slots; labels are registered per
              name via :meth:`intern` (e.g. ``wait_s``/``service_s``)
    ========  =======================================================

    Rich (dict) arguments are allowed on *low-rate* events only (epoch
    solver spans, CLI placements): they are kept in a side dict keyed by
    absolute sequence number and dropped when their ring slot is
    overwritten.  Per-frame events must use the numeric slots.
    """

    enabled = True

    def __init__(self, capacity: int = 1 << 17):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        # np.full (not zeros) throughout: calloc'd pages would fault lazily
        # on first append, charging the recorder's memory cost to the hot
        # path instead of to construction.
        self._ts = np.full(capacity, 0.0)
        self._dur = np.full(capacity, 0.0)
        self._name = np.full(capacity, 0, np.int32)
        self._track = np.full(capacity, 0, np.int16)
        self._lane = np.full(capacity, 0, np.int32)
        self._frame = np.full(capacity, -1, np.int64)
        self._a0 = np.full(capacity, np.nan)
        self._a1 = np.full(capacity, np.nan)
        self.seq = 0                       # events ever appended
        self._names: list[str] = []
        self._name_ids: dict[str, int] = {}
        self._arg_labels: dict[int, tuple[str, str]] = {}
        self._tracks: list[str] = list(_BUILTIN_TRACKS)
        self._track_ids = {t: i for i, t in enumerate(self._tracks)}
        self._rich: dict[int, dict] = {}   # abs seq -> args dict (low-rate)
        self._t0 = time.perf_counter()     # origin of the real-time clock

    # -- clock --------------------------------------------------------------
    def now(self) -> float:
        """Wall seconds since this tracer was created — the real-time
        domain for engine/CLI spans (simulated runs pass sim time instead;
        the two domains never share a trace, see DESIGN.md §9)."""
        return time.perf_counter() - self._t0

    # -- registration -------------------------------------------------------
    def track(self, name: str) -> int:
        """Track code for ``name``, registering a new subsystem track on
        first use (this is how a new subsystem joins the trace)."""
        code = self._track_ids.get(name)
        if code is None:
            code = len(self._tracks)
            self._tracks.append(name)
            self._track_ids[name] = code
        return code

    def intern(self, name: str, a0_label: str = "a0",
               a1_label: str = "a1") -> int:
        """Intern an event name; the labels name the numeric arg slots in
        the exported trace.  Idempotent — call once at wiring time and keep
        the id, or pass the string to emit APIs (interned on the fly)."""
        nid = self._name_ids.get(name)
        if nid is None:
            nid = len(self._names)
            self._names.append(name)
            self._name_ids[name] = nid
            self._arg_labels[nid] = (a0_label, a1_label)
        return nid

    def _nid(self, name) -> int:
        return name if isinstance(name, int) else self.intern(name)

    # -- scalar emit --------------------------------------------------------
    def span(self, track: int, name, ts: float, dur: float, *,
             lane: int = 0, frame: int = -1, a0: float = math.nan,
             a1: float = math.nan, args: dict | None = None) -> None:
        """One interval event (Chrome complete event, phase ``X``)."""
        i = self.seq % self.capacity
        self._ts[i] = ts
        self._dur[i] = dur
        self._name[i] = self._nid(name)
        self._track[i] = track
        self._lane[i] = lane
        self._frame[i] = frame
        self._a0[i] = a0
        self._a1[i] = a1
        if args is not None:
            self._rich[self.seq] = args
        self.seq += 1

    def instant(self, track: int, name, ts: float, *, lane: int = 0,
                frame: int = -1, a0: float = math.nan, a1: float = math.nan,
                args: dict | None = None) -> None:
        """One point event (Chrome instant event, phase ``i``)."""
        self.span(track, name, ts, _INSTANT, lane=lane, frame=frame,
                  a0=a0, a1=a1, args=args)

    # -- vectorized emit ----------------------------------------------------
    def _append_batch(self, track: int, nid: int, ts, dur, lane, frame,
                      a0, a1) -> None:
        n = ts.shape[0]
        cap = self.capacity

        def _cut(v, sl):
            return v[sl] if isinstance(v, np.ndarray) else v

        if n >= cap:                    # keep the newest `capacity` events
            sl = slice(n - cap, n)
            ts = ts[sl]
            dur, lane = _cut(dur, sl), _cut(lane, sl)
            frame, a0, a1 = _cut(frame, sl), _cut(a0, sl), _cut(a1, sl)
            self.seq += n - cap
            n = cap
        start = self.seq % cap
        end = start + n
        cols = ((self._ts, ts), (self._dur, dur), (self._lane, lane),
                (self._frame, frame), (self._a0, a0), (self._a1, a1))
        if end <= cap:                  # hot path: one contiguous write
            d = slice(start, end)
            self._name[d] = nid
            self._track[d] = track
            for col, src in cols:
                col[d] = src
        else:                           # ring wrap: two writes
            k = cap - start
            for d, s in ((slice(start, cap), slice(0, k)),
                         (slice(0, end - cap), slice(k, n))):
                self._name[d] = nid
                self._track[d] = track
                for col, src in cols:
                    col[d] = _cut(src, s)
        self.seq += n

    def span_batch(self, track: int, name, ts: np.ndarray, dur, *,
                   lane=0, frame=-1, a0=math.nan, a1=math.nan) -> None:
        """Vectorized span append — the per-frame reconstruction path.

        ``ts`` is a (n,) float array; ``dur``/``lane``/``frame``/``a0``/
        ``a1`` are scalars or aligned (n,) arrays.  Scalars are written as
        slice fills (never materialized per event); one numpy slice write
        per call (two on ring wrap) — no per-event Python.
        """
        ts = np.asarray(ts, float)
        if ts.shape[0] == 0:
            return
        self._append_batch(track, self._nid(name), ts, dur, lane, frame,
                           a0, a1)

    def instant_batch(self, track: int, name, ts: np.ndarray, *, lane=0,
                      frame=-1, a0=math.nan, a1=math.nan) -> None:
        self.span_batch(track, name, ts, _INSTANT, lane=lane, frame=frame,
                        a0=a0, a1=a1)

    # -- readback -----------------------------------------------------------
    @property
    def n_events(self) -> int:
        """Events currently held (≤ capacity)."""
        return min(self.seq, self.capacity)

    @property
    def n_dropped(self) -> int:
        """Events overwritten by the flight recorder (ring wrapped)."""
        return self.seq - self.n_events

    def events(self) -> dict[str, np.ndarray]:
        """The live window as arrays, oldest-first in append order.  Names
        and tracks come back as string arrays; spans have ``dur >= 0``,
        instants ``dur == -1``."""
        n = self.n_events
        idx = (np.arange(self.seq - n, self.seq) % self.capacity
               if n else np.zeros(0, np.int64))
        names = np.array(self._names) if self._names else np.zeros(0, "U1")
        return {
            "ts": self._ts[idx].copy(),
            "dur": self._dur[idx].copy(),
            "name": names[self._name[idx]] if n else np.zeros(0, "U1"),
            "track": np.array(self._tracks)[self._track[idx]]
            if n else np.zeros(0, "U1"),
            "lane": self._lane[idx].copy(),
            "frame": self._frame[idx].copy(),
            "a0": self._a0[idx].copy(),
            "a1": self._a1[idx].copy(),
        }

    def select(self, name: str) -> dict[str, np.ndarray]:
        """Live events with this name, oldest-first (the audit test's
        join key: batch appends preserve emission order)."""
        ev = self.events()
        m = ev["name"] == name
        return {k: v[m] for k, v in ev.items()}

    # -- export -------------------------------------------------------------
    def export_chrome(self, path) -> int:
        """Write Chrome trace-event JSON (object format, ``traceEvents``)
        loadable in Perfetto; returns the number of events written.

        Mapping: track → pid (named via ``process_name`` metadata), lane →
        tid, span → phase ``X`` with ``dur``, instant → phase ``i``.
        Timestamps are exported in microseconds (the format's unit).
        """
        ev = self.events()
        out: list[dict] = []
        used = {(t, int(lane)) for t, lane in zip(ev["track"], ev["lane"])}
        for track, lane in sorted(used):
            pid = self._track_ids[track]
            out.append({"ph": "M", "pid": pid, "tid": 0,
                        "name": "process_name", "args": {"name": track}})
            out.append({"ph": "M", "pid": pid, "tid": lane,
                        "name": "thread_name",
                        "args": {"name": f"{track}/{lane}"}})
        base_seq = self.seq - self.n_events
        for i in range(ev["ts"].shape[0]):
            nid = self._name_ids[str(ev["name"][i])]
            a0l, a1l = self._arg_labels[nid]
            args: dict = {}
            if math.isfinite(ev["a0"][i]):
                args[a0l] = float(ev["a0"][i])
            if math.isfinite(ev["a1"][i]):
                args[a1l] = float(ev["a1"][i])
            if int(ev["frame"][i]) >= 0:
                args["frame"] = int(ev["frame"][i])
            args.update(self._rich.get(base_seq + i, {}))
            rec = {"name": str(ev["name"][i]),
                   "pid": self._track_ids[str(ev["track"][i])],
                   "tid": int(ev["lane"][i]),
                   "ts": float(ev["ts"][i]) * 1e6,
                   "args": args}
            if ev["dur"][i] >= 0.0:
                rec["ph"] = "X"
                rec["dur"] = float(ev["dur"][i]) * 1e6
            else:
                rec["ph"] = "i"
                rec["s"] = "t"
            out.append(rec)
        with open(path, "w") as fh:
            json.dump({"traceEvents": out,
                       "displayTimeUnit": "ms",
                       "otherData": {"n_dropped": self.n_dropped}}, fh)
        return len(out)


class NullTracer:
    """The default tracer: every emit is a no-op and ``enabled`` is False,
    so call sites guard argument preparation and the traced-off hot path
    stays bit-identical to untraced code."""

    enabled = False
    capacity = 0
    seq = 0
    n_events = 0
    n_dropped = 0

    def now(self) -> float:
        return 0.0

    def track(self, name: str) -> int:
        return -1

    def intern(self, name: str, a0_label: str = "a0",
               a1_label: str = "a1") -> int:
        return -1

    def span(self, *a, **kw) -> None:
        pass

    def instant(self, *a, **kw) -> None:
        pass

    def span_batch(self, *a, **kw) -> None:
        pass

    def instant_batch(self, *a, **kw) -> None:
        pass

    def events(self) -> dict[str, np.ndarray]:
        return {k: np.zeros(0) for k in
                ("ts", "dur", "name", "track", "lane", "frame", "a0", "a1")}

    def select(self, name: str) -> dict[str, np.ndarray]:
        return self.events()

    def export_chrome(self, path) -> int:
        with open(path, "w") as fh:
            json.dump({"traceEvents": []}, fh)
        return 0


NULL_TRACER = NullTracer()
