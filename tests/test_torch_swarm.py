"""The port's swarm serving runtime and OULD-MP (``repro_torch.runtime.swarm``,
``runtime/serve.py::AdmissionController``, ``core/ould_mp.py``) against the
reference's, on the CPU.

The simulation is numpy host code in both packages, so on the same scenario
and seed every result must be *identical*: served, missed, outages, dropped,
degraded and rejected frames, the ``latencies`` array, every epoch's log,
the queue demand and every metric, compared exactly.  What is excepted is
wall-clock only: ``EpochLog.solve_time_s`` (hence ``total_resolve_s``), the
``solver.total_solve_s`` gauge and, in a traced run, the solver span's
duration (the solve's wall).  The reference's batched path cannot run on a
jax without ``jax.experimental.enable_x64``, so the port's batched runs
(``batch_solve=True, device="cpu"``: the sweep's plain version) are held to
the reference's sequential runs, with a spy on the sweep showing it ran;
there ``solver.jit_compiles`` (sweep launches at a shape new to the
process) is excepted too, since a sequential run makes none.  Executed
mode serves on measured stage walls, so there the latencies and what is
computed from them are excepted as well, and of the realized link
bandwidths only the set of links is compared.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as JC
import repro.runtime.swarm as JS
from repro.configs import get_config as j_get_config
from repro.obs import Tracer as JTracer
from repro.runtime.queueing import DeadlineClass as JDeadlineClass
from repro.runtime.serve import AdmissionController as JAdmission
from repro.runtime.serve import schedule_requests as j_schedule
import repro_torch.core as TC
import repro_torch.runtime.swarm as TS
from repro_torch.configs import get_config as t_get_config
from repro_torch.core import batch_dp
from repro_torch.obs import SOLVER
from repro_torch.obs import Tracer as TTracer
from repro_torch.runtime.queueing import DeadlineClass as TDeadlineClass
from repro_torch.runtime.serve import AdmissionController as TAdmission
from repro_torch.runtime.serve import schedule_requests as t_schedule

MB = 1e6
# tests/test_swarm.py's SMALL, benchmarks/bench_swarm.py's CHURN, and
# tests/test_swarm.py's _overload (slow nodes under a dense stream)
SMALL = dict(duration_ticks=60, arrival_rate_hz=0.3, mtbf_s=60.0, mttr_s=20.0)
CHURN = dict(arrival_rate_hz=0.3, mtbf_s=60.0, mttr_s=20.0, queue_model="bottleneck")
OVERLOAD = dict(SMALL, mtbf_s=float("inf"), arrival_rate_hz=0.8, hold_ticks_mean=40.0,
                gflops=5e8, deadline_s=4.0)
SCENARIOS = {"small": SMALL, "churn": CHURN}
QUEUE_MODELS = ("bottleneck", "perhop")
SERVICE_POLICIES = ("fifo", "edf", "fifo+drop", "edf+degrade:0.25", "fifo+reject")
WALL_METRICS = ("solver.total_solve_s",)


def _same(a, b, where="result"):
    """Exact equality of nested results: dataclasses, dicts, sequences,
    arrays and scalars (NaN equal to NaN, dtypes equal)."""
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        assert type(a).__name__ == type(b).__name__, where
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name), f"{where}.{f.name}")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert np.asarray(a).dtype == np.asarray(b).dtype, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert type(a) is type(b), (where, type(a), type(b))
        if isinstance(a, float) and np.isnan(a):
            assert np.isnan(b), where
        else:
            assert a == b, (where, a, b)


def _same_sim(ref, port, *, batched=False):
    """Two SimResults identical, wall-clock fields excepted."""
    skip = WALL_METRICS + (("solver.jit_compiles",) if batched else ())
    for f in dataclasses.fields(ref):
        a, b = getattr(ref, f.name), getattr(port, f.name)
        if f.name == "epochs":
            assert len(a) == len(b)
            for i, (x, y) in enumerate(zip(a, b)):
                _same(dataclasses.replace(x, solve_time_s=0.0),
                      dataclasses.replace(y, solve_time_s=0.0), f"epochs[{i}]")
        elif f.name == "metrics":
            _same({k: v for k, v in a.items() if k not in skip},
                  {k: v for k, v in b.items() if k not in skip}, "metrics")
        else:
            _same(a, b, f.name)
    assert ref.served > 0 and ref.epochs


def _scn(pkg, base, **kw):
    return (JS if pkg == "ref" else TS).SwarmScenario(**{**base, **kw})


def _both(base, policy, seed=0, **kw):
    return (JS.simulate(_scn("ref", base, **kw), policy, seed),
            TS.simulate(_scn("port", base, **kw), policy, seed))


# ---------------------------------------------------------------------------
# the event tape
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("base", [SMALL, CHURN, OVERLOAD,
                                  dict(n_uavs=1024, hotspots=64, duration_ticks=60,
                                       arrival_rate_hz=34.0, hold_ticks_mean=30.0)],
                         ids=["small", "churn", "overload", "n1024"])
def test_event_tape_equals_reference(base):
    a = JS.build_event_tape(_scn("ref", base), 3)
    b = TS.build_event_tape(_scn("port", base), 3)
    _same(a.signature(), b.signature())
    _same(a.arrival_times_s, b.arrival_times_s)
    qa, qb = a.queue(), b.queue()
    while qa:
        ea, eb = qa.pop(), qb.pop()
        assert (ea.time, ea.seq, int(ea.kind), ea.payload) == \
            (eb.time, eb.seq, int(eb.kind), eb.payload)
    assert not qb


# ---------------------------------------------------------------------------
# simulate, analytic mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("queue_model", QUEUE_MODELS)
@pytest.mark.parametrize("policy", JS.PLANNER_POLICIES)
@pytest.mark.parametrize("scenario", SCENARIOS)
def test_simulate_equals_reference(scenario, policy, queue_model):
    assert TS.PLANNER_POLICIES == JS.PLANNER_POLICIES
    _same_sim(*_both(SCENARIOS[scenario], policy, queue_model=queue_model))


@pytest.mark.parametrize("queue_model", QUEUE_MODELS)
@pytest.mark.parametrize("service_policy", SERVICE_POLICIES)
def test_service_policies_equal_reference(service_policy, queue_model):
    ref, port = _both(OVERLOAD, "nearest", seed=6, service_policy=service_policy,
                      queue_model=queue_model)
    _same_sim(ref, port)
    assert ref.wait_total_s > 0                      # the overload is real


@pytest.mark.parametrize("case,policy,kw", [
    ("deadline_classes", "nearest", dict(service_policy="edf+drop")),
    ("queue_aware_bottleneck", "nearest",
     dict(queue_aware_admission=True, queue_model="bottleneck")),
    ("queue_aware_perhop", "incremental", dict(queue_aware_admission=True)),
    ("resolve_on_drift", "incremental", dict(resolve_on_drift=1e-4)),
    ("stale_view", "incremental", dict(view_degradation="stale:3")),
    ("stale_horizon", "ould-mp", dict(view_degradation="stale:3")),
    ("noisy_horizon", "ould-mp", dict(view_degradation="noisy:0.25")),
    ("improvement_bound", "incremental", dict(track_improvement_bound=True)),
    ("cold_resolves_sparse", "incremental-sparse", dict(sparse_k=3)),
], ids=lambda v: v if isinstance(v, str) else "")
def test_scenario_options_equal_reference(case, policy, kw):
    base = OVERLOAD if case.startswith(("deadline", "queue_aware")) else SMALL
    if case == "deadline_classes":
        ref = JS.simulate(_scn("ref", base, deadline_classes=(
            JDeadlineClass("interactive", 1.0), JDeadlineClass("batch", 30.0)), **kw),
            policy, 5)
        port = TS.simulate(_scn("port", base, deadline_classes=(
            TDeadlineClass("interactive", 1.0), TDeadlineClass("batch", 30.0)), **kw),
            policy, 5)
    elif case == "cold_resolves_sparse":
        ref = JS.simulate(_scn("ref", base, **kw), policy, 0, cold_resolves=True)
        port = TS.simulate(_scn("port", base, **kw), policy, 0, cold_resolves=True)
    else:
        ref, port = _both(base, policy, seed=0 if case == "improvement_bound" else 3, **kw)
    _same_sim(ref, port)
    if case.startswith("queue_aware"):
        assert sum(e.n_queue_rejected for e in ref.epochs) > 0
    if case == "resolve_on_drift":
        assert ref.drift_resolves > 0
    if case == "improvement_bound":
        assert ref.max_placement_drift_s > 0


def test_traced_run_equals_reference():
    """The simulated-time trace is identical; the solver spans' durations
    are the solves' walls and are excepted."""
    trs = JTracer(), TTracer()
    ref = JS.simulate(_scn("ref", SMALL), "incremental", 0, tracer=trs[0])
    port = TS.simulate(_scn("port", SMALL), "incremental", 0, tracer=trs[1])
    _same_sim(ref, port)
    ea, eb = trs[0].events(), trs[1].events()
    solver = ea["track"] == trs[0]._tracks[SOLVER]
    assert solver.any() and ea["name"].size > 100 and "frame" in set(ea["name"])
    for k in ea:
        if k == "dur":
            _same(ea[k][~solver], eb[k][~solver], k)
        else:
            _same(ea[k], eb[k], k)


def test_warm_vs_cold_decisions_equal_reference():
    j = JS.warm_vs_cold(_scn("ref", SMALL), 0)
    t = TS.warm_vs_cold(_scn("port", SMALL), 0)
    _same_sim(j["warm"], t["warm"])
    _same_sim(j["cold"], t["cold"])
    assert j["objective_ratio_max"] == t["objective_ratio_max"]


# ---------------------------------------------------------------------------
# batched epoch re-solves: the sweep's plain version on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture
def sweep_spy(monkeypatch):
    calls = []
    real = batch_dp.solve_batch

    def spy(*args, device="cuda", **kw):
        calls.append((args[4].shape, str(device)))
        return real(*args, device=device, **kw)

    monkeypatch.setattr(batch_dp, "solve_batch", spy)
    return calls


@pytest.mark.parametrize("policy", ["incremental-sparse", "ould-dp-sparse"])
@pytest.mark.parametrize("scenario", SCENARIOS)
def test_batched_port_equals_sequential_reference(scenario, policy, sweep_spy):
    base = SCENARIOS[scenario]
    ref = JS.simulate(_scn("ref", base), policy, 0)
    port = TS.simulate(_scn("port", base, batch_solve=True, device="cpu"), policy, 0)
    _same_sim(ref, port, batched=True)
    assert sweep_spy and all(dev == "cpu" for _, dev in sweep_spy)
    assert port.metrics["solver.jit_compiles"] >= 0


def test_batched_incremental_overload_window(sweep_spy):
    """A short OVERLOAD-like run (one group, thousands of frames, many
    epochs): batched on the CPU equals the reference's sequential run."""
    base = dict(n_groups=1, duration_ticks=72, epoch_ticks=6, arrival_rate_hz=2.0,
                hold_ticks_mean=60.0, mem_mb_hotspot_group=4096.0,
                mem_mb_other_groups=4096.0, comp_cap_flops=1e18, gflops=5e9,
                deadline_s=2.0, mtbf_s=float("inf"), queue_model="bottleneck")
    ref = JS.simulate(_scn("ref", base), "incremental-sparse", 1)
    port = TS.simulate(_scn("port", base, batch_solve=True, device="cpu"),
                       "incremental-sparse", 1)
    _same_sim(ref, port, batched=True)
    assert len(sweep_spy) >= 10 and ref.served > 2000


# ---------------------------------------------------------------------------
# executed mode on the CPU (tests/test_swarm.py's executed-mode tests)
# ---------------------------------------------------------------------------

def test_executed_latency_sampling_on_cpu():
    scn = _scn("port", SMALL, duration_ticks=20, execute=True, device="cpu")
    r = TS.simulate(scn, "incremental", seed=0)
    assert r.served > 0
    assert np.isfinite(r.latencies).all() and (r.latencies > 0).all()
    analytic = TS.simulate(dataclasses.replace(scn, execute=False), "incremental", seed=0)
    assert analytic.served == r.served
    ref = JS.simulate(_scn("ref", SMALL, duration_ticks=20), "incremental", 0)
    assert ref.served == r.served and ref.n_never_admitted == r.n_never_admitted


def test_churn_rejoin_fires_warm_start_on_cpu():
    scn = _scn("port", SMALL, mtbf_s=40.0, mttr_s=10.0, execute=True, device="cpu")
    r = TS.simulate(scn, "incremental", seed=3)
    assert r.warm_starts >= 1, "no rejoin warmed the execution engine"
    analytic = TS.simulate(dataclasses.replace(scn, execute=False), "incremental", seed=3)
    assert analytic.warm_starts == 0 and analytic.served == r.served
    assert r.metrics["solver.warm_starts"] == r.warm_starts


# ---------------------------------------------------------------------------
# entry points: the card by default; executed transports and the compile cache
# ---------------------------------------------------------------------------

def test_card_bound_runs_need_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("checks the card-less behaviour")
    for kw in (dict(batch_solve=True), dict(execute=True)):
        with pytest.raises(RuntimeError, match="cuda"):
            TS.simulate(_scn("port", SMALL, **kw), "incremental-sparse")
    # neither flag: host code, the default device is never read
    assert TS.simulate(_scn("port", SMALL, duration_ticks=10), "incremental").served >= 0


# Executed mode serves on measured stage walls: there the latencies and
# what is computed from them (over-deadline misses, queue waits, node
# demand) are wall fields too, and so are the realized link bandwidths.
EXEC_WALL_FIELDS = ("latencies", "missed", "wait_total_s", "queue_demand_s")
EXEC_WALL_METRICS = ("sim.missed", "sim.wait_total_s", "queue.max_demand_s", "sim.latency_s")
# tests/test_swarm.py's executed loopback scenario
EXEC_SMALL = dict(SMALL, n_uavs=8, duration_ticks=16, epoch_ticks=8)


def _same_executed(ref, port):
    """Two executed-mode SimResults identical but for wall fields and
    bandwidth values: the same completions, every decision and counter, and
    the same sampled links."""
    for f in dataclasses.fields(ref):
        a, b = getattr(ref, f.name), getattr(port, f.name)
        if f.name in EXEC_WALL_FIELDS:
            if f.name == "latencies":
                assert a.size == b.size and np.isfinite(b).all() and (b > 0).all()
        elif f.name == "link_bytes_per_s":
            assert a.keys() == b.keys(), (a, b)
            assert all(bw > 0 for bw in b.values())
        elif f.name == "epochs":
            _same([dataclasses.replace(e, solve_time_s=0.0) for e in a],
                  [dataclasses.replace(e, solve_time_s=0.0) for e in b], "epochs")
        elif f.name == "metrics":
            def keep(m):
                return {k: v for k, v in m.items() if k not in WALL_METRICS + EXEC_WALL_METRICS
                        and not k.startswith("transport.link.")}
            _same(keep(a), keep(b), "metrics")
            assert a["sim.latency_s"]["count"] == b["sim.latency_s"]["count"]
            assert ({k for k in a if k.startswith("transport.link.")}
                    == {k for k in b if k.startswith("transport.link.")})
        else:
            _same(a, b, f.name)
    assert ref.served > 0 and ref.epochs


@pytest.fixture
def restore_caches():
    """The reference's compile cache and the port's build directory as they
    were before the test (a scenario's compile_cache_dir re-points both for
    the process)."""
    from repro.exec import compile_cache as jcc
    from repro_torch.exec import compile_cache as tcc
    from repro_torch.kernels import build
    prev_ref, prev_port = jcc.cache_dir(), build.BUILD_DIR
    yield
    if prev_ref is None:
        jcc.disable()
    else:
        jcc.enable(prev_ref)
    build.set_build_dir(prev_port)
    assert tcc.cache_dir() is None or tcc.cache_dir() == prev_port


@pytest.mark.parametrize("case", ["cache", "cache-executed", "loopback", "multiproc",
                                  "churn-rejoin"])
def test_ported_options_equal_reference(case, tmp_path, restore_caches):
    """Each option held to the reference's run on the same scenario and
    seed: the compile cache (analytic and executed),
    executed mode over the loopback and multiproc transports
    (tests/test_swarm.py::test_executed_loopback_transport_samples_substrate)
    and the churn-rejoin warm start in executed mode
    (::test_churn_rejoin_fires_warm_start_in_executed_mode)."""
    from repro.exec import compile_cache as jcc
    from repro_torch.exec import compile_cache as tcc
    base, seed, kw = EXEC_SMALL, 0, dict(execute=True)
    if case == "cache":
        base, kw = SMALL, dict(duration_ticks=20)
    elif case in ("loopback", "multiproc"):
        kw = dict(kw, transport=case)
    elif case == "churn-rejoin":
        base, seed, kw = SMALL, 3, dict(kw, mtbf_s=40.0, mttr_s=10.0)
    caches = {}
    if case.startswith("cache"):
        caches = {pkg: str(tmp_path / pkg) for pkg in ("ref", "port")}
    ref = JS.simulate(_scn("ref", base, compile_cache_dir=caches.get("ref"), **kw),
                      "incremental", seed)
    port = TS.simulate(_scn("port", base, compile_cache_dir=caches.get("port"), device="cpu",
                            **kw), "incremental", seed)
    if case == "cache":
        _same_sim(ref, port)             # analytic: the cache is never touched
        assert not any(tmp_path.iterdir())
        return
    _same_executed(ref, port)
    twin = TS.simulate(_scn("port", base, device="cpu", **dict(kw, execute=False,
                                                                 transport="inproc")),
                       "incremental", seed)
    assert twin.served == port.served and twin.warm_starts == 0
    if case == "cache-executed":
        assert jcc.cache_dir() == tmp_path / "ref"
        assert tcc.cache_dir() == tmp_path / "port" and (tmp_path / "port").is_dir()
    elif case == "churn-rejoin":
        assert port.warm_starts >= 1 and port.metrics["solver.warm_starts"] == port.warm_starts
    else:
        assert port.transport == ref.transport == case
        assert port.link_bytes_per_s, "no substrate links sampled"
        inproc = TS.simulate(_scn("port", base, device="cpu", **dict(kw, transport="inproc")),
                             "incremental", seed)
        assert inproc.transport == "inproc" and inproc.link_bytes_per_s == {}
        assert inproc.served == port.served


def test_transport_is_ignored_without_execute_as_in_reference():
    ref, port = _both(SMALL, "nearest", transport="loopback", duration_ticks=20)
    _same_sim(ref, port)
    assert port.transport == "inproc"


# ---------------------------------------------------------------------------
# OULD-MP
# ---------------------------------------------------------------------------

def _mp_args(pkg, seed, n):
    C = JC if pkg == "ref" else TC
    mob = C.RPGMobility(C.RPGParams(n_uavs=n, area_m=300.0), seed=seed)
    mem = np.where(np.arange(n) < 3, 96 * MB, 256 * MB)
    return (C.lenet_profile(), mem, np.full(n, 95e9), np.array([0, 0, 1, 2], np.int64),
            mob, 4)


@pytest.mark.parametrize("solver", ["dp", "ilp"])
@pytest.mark.parametrize("fn", ["solve_ould_mp", "solve_static_resolve",
                                "solve_offline_fixed"])
def test_ould_mp_solvers_equal_reference(fn, solver):
    # the ILP on a smaller swarm and one seed: it takes ~0.3 s a solve here
    n, seeds = (8, (0, 1)) if solver == "dp" else (5, (1,))
    for seed in seeds:
        a = getattr(JC, fn)(*_mp_args("ref", seed, n), compute_speed=np.full(n, 9.5e9),
                            solver=solver)
        b = getattr(TC, fn)(*_mp_args("port", seed, n), compute_speed=np.full(n, 9.5e9),
                            solver=solver)
        _same(a.solution.assign, b.solution.assign)
        _same(a.solution.admitted, b.solution.admitted)
        _same(a.solution.objective, b.solution.objective)
        assert a.solution.status == b.solution.status
        assert len(a.per_step) == len(b.per_step) == 4
        for x, y in zip(a.per_step, b.per_step):
            _same(x, y)
        assert a.solution.n_admitted > 0


# ---------------------------------------------------------------------------
# AdmissionController and schedule_requests
# ---------------------------------------------------------------------------

def _rounds(pkg, n=10, rounds=4):
    """Successive admission rounds on a moving two-group swarm: rates per
    round, sources, stable stream ids (some leave, some arrive)."""
    C = JC if pkg == "ref" else TC
    mob = C.MultiGroupMobility(C.RPGParams(n_uavs=n, area_m=400.0), n_groups=2, seed=1)
    pos = mob.positions(rounds * 5, seed=2)
    rng = np.random.default_rng(4)
    out = []
    ids = list(range(6))
    for r in range(rounds):
        ids = [i for i in ids if rng.random() > 0.25] + [100 + 10 * r + j for j in range(3)]
        out.append((C.rate_matrix(pos[5 * r]), ids,
                    rng.integers(0, 3, len(ids)).astype(np.int64)))
    prof = C.lenet_profile()
    mem = np.where(mob.group_of == 0, 160 * MB, 512 * MB)
    return C, prof, mem, out


@pytest.mark.parametrize("gate", [False, True])
@pytest.mark.parametrize("queue_model", QUEUE_MODELS)
@pytest.mark.parametrize("planner", ["incremental", "incremental-sparse", "ould-dp",
                                     "nearest"])
def test_admission_controller_equals_reference(planner, queue_model, gate):
    ctrls = (JAdmission(planner, queue_model=queue_model, solver="dp", sparse_k=3),
             TAdmission(planner, queue_model=queue_model, solver="dp", sparse_k=3))
    n = 10
    width = n if queue_model == "bottleneck" else n + n * n
    rng = np.random.default_rng(8)
    setups = _rounds("ref", n), _rounds("port", n)
    gated = 0
    for r in range(len(setups[0][3])):
        backlog = rng.uniform(0.0, 0.6, width) if gate else None
        deadline = rng.uniform(0.2, 1.5, len(setups[0][3][r][1])) if gate else None
        plans = []
        for ctrl, (C, prof, mem, rounds) in zip(ctrls, setups):
            rates, ids, src = rounds[r]
            prob = C.Problem(prof, mem, np.full(n, 95e9), rates, src, np.full(n, 9.5e9))
            plans.append(ctrl.admit(prob, rates, request_ids=ids, backlog_s=backlog,
                                    deadline_s=deadline, now_s=float(r)))
        a, b = plans
        _same(a.assign, b.assign)
        _same(a.admitted, b.admitted)
        _same(a.objective, b.objective)
        assert a.status == b.status and a.planner_name == b.planner_name
        assert ctrls[0].last_queue_rejected == ctrls[1].last_queue_rejected
        gated += ctrls[0].last_queue_rejected
    for x, y in zip(ctrls[0].history, ctrls[1].history):
        _same(dataclasses.replace(x, solve_time_s=0.0),
              dataclasses.replace(y, solve_time_s=0.0))
    assert (gated > 0) == gate


@pytest.mark.parametrize("planner", ["ould-dp", "ould-dp-sparse", "hrm"])
def test_schedule_requests_equals_reference(planner):
    link = TC.TpuLinkModel()
    n = 8
    coords = np.stack([np.arange(n) % link.torus[0], np.arange(n) // link.torus[0]], -1)
    rates = link.rate_matrix(coords, np.zeros(n, np.int64)) * 8.0
    kw = dict(n_nodes=n, requests=4, hbm_bytes=16e9 * 16, flops_budget=197e12 * 10,
              rates_bits=rates, planner=planner, sparse_k=None)
    pa, ea = j_schedule(j_get_config("internlm2_1p8b"), **kw)
    pb, eb = t_schedule(t_get_config("internlm2_1p8b"), **kw)
    _same(pa.assign, pb.assign)
    _same(pa.admitted, pb.admitted)
    _same(pa.objective, pb.objective)
    _same(ea, eb)
    assert pa.n_admitted > 0
