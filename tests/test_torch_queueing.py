"""The port's event substrate and queueing runtime (``repro_torch.core.events``,
``repro_torch.runtime.queueing``) against the reference's, on the CPU.

Both modules are numpy copies of the reference's, so every result here must
be *identical* to the reference's on the same seeded inputs: the tolerance is
exact everywhere (``np.array_equal``, infinities and NaNs in the same places).
The instances are ``tests/test_queueing.py``'s: random FIFO windows, the
one-node overloaded window, random multi-hop tapes over the combined
compute + link resource space.
"""

import ast
import dataclasses
import pathlib

import numpy as np
import pytest

pytest.importorskip("torch")  # the port's package imports torch

from repro.core import events as JE
from repro.runtime import queueing as JQ
from repro_torch.core import events as TE
from repro_torch.runtime import queueing as TQ

ROOT = pathlib.Path(__file__).resolve().parents[1]
SPECS = ("fifo", "edf", "fifo+drop", "edf+degrade:0.25", "fifo+reject",
         "edf+drop", "edf+reject", "fifo+degrade:0.5")


def _code(path: pathlib.Path) -> str:
    """The module's code with every docstring taken out."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


@pytest.mark.parametrize("rel", ["core/events.py", "core/ould_mp.py",
                                 "runtime/queueing.py"])
def test_copies_match_reference_code(rel):
    """The copies differ from their originals in docstrings only."""
    assert _code(ROOT / "src/repro_torch" / rel) == _code(ROOT / "src/repro" / rel)


def _equal(a, b):
    """Exact equality of two outcomes (dataclasses of arrays) or arrays."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__
        for f in dataclasses.fields(a):
            _equal(getattr(a, f.name), getattr(b, f.name))
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# events
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,rate,horizon", [(0, 0.5, 100.0), (7, 0.3, 120.0),
                                               (3, 4.5, 360.0), (1, 0.0, 50.0)])
def test_poisson_process_equals_reference(seed, rate, horizon):
    a = JE.poisson_process(np.random.default_rng(seed), rate, horizon)
    b = TE.poisson_process(np.random.default_rng(seed), rate, horizon)
    _equal(a, b)


@pytest.mark.parametrize("seed", [0, 3])
def test_churn_events_equal_reference(seed):
    kw = dict(n_nodes=10, horizon_s=500.0, mtbf_s=50.0, mttr_s=10.0,
              protected=frozenset({0, 1}))
    a = JE.churn_events(np.random.default_rng(seed), **kw)
    b = TE.churn_events(np.random.default_rng(seed), **kw)
    assert a and [(e.time, e.node, int(e.kind)) for e in a] == \
        [(e.time, e.node, int(e.kind)) for e in b]
    assert JE.churn_events(np.random.default_rng(seed), 5, 100.0, float("inf"), 1.0) \
        == TE.churn_events(np.random.default_rng(seed), 5, 100.0, float("inf"), 1.0) == []


def test_event_queue_order_equals_reference():
    """Same pushes (many same-time ties) pop in the same order, seq included."""
    rng = np.random.default_rng(0)
    times = rng.integers(0, 20, 300).astype(float)
    kinds = rng.integers(0, len(JE.EventKind), 300)
    qs = JE.EventQueue(), TE.EventQueue()
    for t, k in zip(times, kinds):
        for q, E in zip(qs, (JE, TE)):
            q.push(t, E.EventKind(int(k)), int(k) * 7)
    popped = [[], []]
    while qs[0]:
        for q, out in zip(qs, popped):
            ev = q.pop()
            out.append((ev.time, ev.seq, int(ev.kind), ev.payload))
    assert not qs[1] and popped[0] == popped[1]
    assert [k.name for k in JE.EventKind] == [k.name for k in TE.EventKind]


# ---------------------------------------------------------------------------
# the advance functions (tests/test_queueing.py's instances)
# ---------------------------------------------------------------------------

def _random_window(rng, n, n_nodes):
    node = np.sort(rng.integers(0, n_nodes, n))
    arrival = np.sort(rng.uniform(0, 10, n))
    service = rng.uniform(0.01, 2.0, n)
    free = rng.uniform(0, 5, n_nodes)
    return node, arrival, service, free


def _overloaded_window(n=40):
    return np.zeros(n, np.int64), np.zeros(n), np.ones(n), np.full(n, 3.0)


def _random_tape(rng, n_frames=400, n_hops=6, n_nodes=5):
    n_res = JQ.n_path_resources(n_nodes)
    res = rng.integers(0, n_res, (n_frames, n_hops))
    res[rng.random((n_frames, n_hops)) < 0.25] = -1
    service = rng.uniform(0.01, 0.5, (n_frames, n_hops))
    arrival = np.sort(rng.uniform(0, 20, n_frames))
    free = rng.uniform(0, 2, n_res)
    return res, service, arrival, free


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_fifo_advance_kernel_equals_reference(seed):
    args = _random_window(np.random.default_rng(seed), 200, 5)
    _equal(JQ.fifo_advance_kernel(*args), TQ.fifo_advance_kernel(*args))
    empty = (np.zeros(0, np.int64), np.zeros(0), np.zeros(0), np.zeros(3))
    _equal(JQ.fifo_advance_kernel(*empty), TQ.fifo_advance_kernel(*empty))


@pytest.mark.parametrize("spec", SPECS)
def test_policy_advance_kernel_equals_reference(spec):
    rng = np.random.default_rng(7)
    node, arrival, service, free = _random_window(rng, 300, 4)
    deadline = arrival + rng.uniform(0.5, 6.0, arrival.shape)
    for args in ((node, arrival, service, deadline, free),
                 (*_overloaded_window(), np.zeros(1))):
        _equal(JQ.policy_advance_kernel(*args, JQ.ServicePolicy.parse(spec)),
               TQ.policy_advance_kernel(*args, TQ.ServicePolicy.parse(spec)))


@pytest.mark.parametrize("seed,prio", [(0, False), (1, False), (2, False), (4, True)])
def test_path_advance_kernel_and_sweep_equal_reference(seed, prio):
    rng = np.random.default_rng(seed)
    res, service, arrival, free = _random_tape(rng, n_frames=200 if prio else 400)
    extra = (arrival + rng.uniform(0.5, 5.0, arrival.shape),) if prio else ()
    snap = free.copy()
    _equal(JQ.path_advance_kernel(res, service, arrival, free, *extra),
           TQ.path_advance_kernel(res, service, arrival, free, *extra))
    _equal(JQ.path_sweep_reference(res, service, arrival, free, *extra),
           TQ.path_sweep_reference(res, service, arrival, free, *extra))
    _equal(free, snap)


@pytest.mark.parametrize("spec", SPECS)
def test_path_policy_sweep_equals_reference(spec):
    rng = np.random.default_rng(11)
    res, service, arrival, free = _random_tape(rng, n_frames=150)
    ddl = arrival + rng.uniform(0.1, 1.0, arrival.shape)
    _equal(JQ.path_policy_sweep(res, service, arrival, ddl, free, JQ.ServicePolicy.parse(spec)),
           TQ.path_policy_sweep(res, service, arrival, ddl, free, TQ.ServicePolicy.parse(spec)))


# ---------------------------------------------------------------------------
# persistent queues over several advances
# ---------------------------------------------------------------------------

def _node_windows(seed, n_nodes=4, windows=5):
    """Unsorted per-tick windows: node ids, a shared arrival per window,
    service demands and absolute deadlines, arriving faster than served."""
    rng = np.random.default_rng(seed)
    out = []
    for w in range(windows):
        n = int(rng.integers(0, 60))
        arrival = np.full(n, float(w))
        out.append((rng.integers(0, n_nodes, n), arrival, rng.uniform(0.05, 0.4, n),
                    arrival + rng.uniform(0.2, 3.0, n)))
    return out


@pytest.mark.parametrize("spec", SPECS)
def test_node_queues_equal_reference_over_windows(spec):
    qs = (JQ.NodeQueues(4, JQ.ServicePolicy.parse(spec)),
          TQ.NodeQueues(4, TQ.ServicePolicy.parse(spec)))
    for w, window in enumerate(_node_windows(5)):
        _equal(qs[0].advance(*window), qs[1].advance(*window))
        _equal(qs[0].backlog_s(w + 0.5), qs[1].backlog_s(w + 0.5))
    _equal(qs[0].snapshot(), qs[1].snapshot())
    _equal(qs[0].demand_s, qs[1].demand_s)


@pytest.mark.parametrize("spec", SPECS)
def test_path_queues_equal_reference_over_windows(spec):
    n = 5
    qs = (JQ.PathQueues(n, JQ.ServicePolicy.parse(spec)),
          TQ.PathQueues(n, TQ.ServicePolicy.parse(spec)))
    rng = np.random.default_rng(9)
    for w in range(5):
        res, service, _, _ = _random_tape(rng, n_frames=int(rng.integers(0, 80)), n_nodes=n)
        arrival = np.full(res.shape[0], float(w))
        ddl = arrival + rng.uniform(0.3, 3.0, arrival.shape)
        _equal(qs[0].advance(res, service, arrival, ddl),
               qs[1].advance(res, service, arrival, ddl))
        _equal(qs[0].backlog_s(w + 0.5), qs[1].backlog_s(w + 0.5))
    _equal(qs[0].snapshot(), qs[1].snapshot())
    _equal((qs[0].demand_s, qs[0].link_demand_s), (qs[1].demand_s, qs[1].link_demand_s))


# ---------------------------------------------------------------------------
# policies, layouts, classes and percentiles
# ---------------------------------------------------------------------------

def test_service_policy_and_layout_equal_reference():
    for spec in SPECS:
        assert (dataclasses.asdict(JQ.ServicePolicy.parse(spec))
                == dataclasses.asdict(TQ.ServicePolicy.parse(spec)))
    for bad in ("lifo", "fifo+explode", "fifo+drop:0.5", "fifo+degrade:1.5"):
        with pytest.raises(ValueError):
            JQ.ServicePolicy.parse(bad)
        with pytest.raises(ValueError):
            TQ.ServicePolicy.parse(bad)
    a, b = np.meshgrid(np.arange(7), np.arange(7), indexing="ij")
    _equal(JQ.link_resource(7, a, b), TQ.link_resource(7, a, b))
    assert JQ.n_path_resources(7) == TQ.n_path_resources(7)
    assert ([dataclasses.astuple(c) for c in JQ.DEFAULT_CLASSES]
            == [dataclasses.astuple(c) for c in TQ.DEFAULT_CLASSES])


@pytest.mark.parametrize("case", ["empty", "inf", "values", "random"])
def test_tail_percentiles_equal_reference(case):
    lat = {"empty": np.zeros(0), "inf": np.array([np.inf, np.inf]),
           "values": np.concatenate([np.arange(1, 1001, dtype=float), [np.inf]]),
           "random": np.random.default_rng(2).exponential(0.3, 5000)}[case]
    assert JQ.tail_percentiles(lat) == TQ.tail_percentiles(lat)
