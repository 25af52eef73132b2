"""The port's placement solvers (``src/repro_torch/core``) against the
reference's (``src/repro/core``) on the CPU.

The port's ``core`` is a copy of the reference's numpy/scipy modules, except
that the batched DP's sweep runs through ``kernels/dp_sweep.py`` (the plain
version on a CPU tensor).  So every solver here must give *identical*
results — admission, assignment and objective, bit for bit — on the same
seeded instances.  The reference's own batched path cannot run on a jax
without ``jax.experimental.enable_x64``, so the port's batched solve is held
to the reference's sequential solve and its sweep to the numpy oracle
``repro/core/ould.py::_sparse_run``, row by row.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as J
from repro.core import ould as j_ould
from repro.core.mobility import RPGMobility as JRPGMobility
from repro.core.mobility import RPGParams as JRPGParams
from repro.core.profiles import LayerProfile as JLayerProfile
from repro.core.profiles import ModelProfile as JModelProfile
from repro_torch import core as T
from repro_torch.core import batch_dp
from repro_torch.core import ould as t_ould
from repro_torch.core.mobility import RPGMobility as TRPGMobility
from repro_torch.core.mobility import RPGParams as TRPGParams
from repro_torch.core.profiles import LayerProfile as TLayerProfile
from repro_torch.core.profiles import ModelProfile as TModelProfile
from repro_torch.kernels import ref
from repro_torch.kernels.dp_sweep import dp_sweep

MB = 1e6
PKG = {"ref": (J, JRPGMobility, JRPGParams, JLayerProfile, JModelProfile),
       "port": (T, TRPGMobility, TRPGParams, TLayerProfile, TModelProfile)}


# ---------------------------------------------------------------------------
# instances (tests/test_batch_dp.py's _swarm and _tight), built by either package
# ---------------------------------------------------------------------------

def _swarm(pkg, n=50, requests=16, seed=0, area=300.0, mem_mb=512.0, comp=95e9,
           hotspots=5, profile="lenet"):
    C, Mob, Params, _, _ = PKG[pkg]
    mob = Mob(Params(n_uavs=n, area_m=area, homogeneous=True), seed=seed)
    rates = C.rate_matrix(mob.positions(1, seed=seed)[0])
    rng = np.random.default_rng(seed)
    src = rng.integers(0, min(hotspots, n), requests).astype(np.int64)
    prof = C.lenet_profile() if profile == "lenet" else C.vgg16_profile()
    return C.Problem(prof, np.full(n, mem_mb * MB), np.full(n, comp), rates, src,
                     np.full(n, 9.5e9))


def _tight(pkg, n=12, requests=12, seed=0, mem_cap=30.0):
    """Toy instance with real contention: repairs, spreads and rejections."""
    C, _, _, LP, MP = PKG[pkg]
    prof = MP("toy", tuple(LP(f"l{j}", 10.0, 1.0, [8.0, 4.0, 2.0, 1.0][j])
                           for j in range(4)), input_bytes=16.0)
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, 120, (n, 3))
    pos[:, 2] = 50.0
    src = rng.integers(0, n, requests).astype(np.int64)
    return C.Problem(prof, np.full(n, mem_cap), np.full(n, 40.0), C.rate_matrix(pos), src)


def _same(a, b):
    np.testing.assert_array_equal(a.admitted, b.admitted)
    np.testing.assert_array_equal(a.assign, b.assign)
    assert a.objective == b.objective                  # bitwise, not approx


# ---------------------------------------------------------------------------
# copies of the system model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["lenet", "vgg16", "lm"])
def test_profiles_equal_reference(name):
    def build(C):
        if name == "lm":
            return C.lm_profile("lm", n_layers=4, d_model=64, n_heads=4, n_kv=2, d_ff=128,
                                vocab=512, seq=32, window=16)
        return C.lenet_profile() if name == "lenet" else C.vgg16_profile()
    j, t = build(J), build(T)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.output_vector() == j.output_vector()
    assert t.memory_vector() == j.memory_vector()
    assert t.compute_vector() == j.compute_vector()


@pytest.mark.parametrize("seed", [0, 3])
def test_radio_and_mobility_equal_reference(seed):
    for homogeneous in (True, False):
        pj = JRPGMobility(JRPGParams(n_uavs=20, area_m=300.0, homogeneous=homogeneous),
                          seed=seed).positions(6, seed=seed)
        pt = TRPGMobility(TRPGParams(n_uavs=20, area_m=300.0, homogeneous=homogeneous),
                          seed=seed).positions(6, seed=seed)
        np.testing.assert_array_equal(pt, pj)
        np.testing.assert_array_equal(T.rate_matrix(pt[3]), J.rate_matrix(pj[3]))
        np.testing.assert_array_equal(T.sinr_matrix(pt[3], T.RadioParams()),
                                      J.sinr_matrix(pj[3], J.RadioParams()))
    assert T.available_planners() == J.available_planners()


# ---------------------------------------------------------------------------
# whole solves: identical to the reference's sequential solvers
# ---------------------------------------------------------------------------

SOLVE_CASES = [  # name, instance kwargs, solve_ould kwargs
    ("swarm-12", dict(kind="swarm", n=12, requests=8, seed=0), {}),
    ("swarm-50", dict(kind="swarm", n=50, requests=16, seed=1), {}),
    ("swarm-256", dict(kind="swarm", n=256, requests=64, seed=2), {}),
    ("tight-30", dict(kind="tight", seed=0, mem_cap=30.0), dict(max_path_cost=1e6)),
    ("tight-60", dict(kind="tight", seed=1, mem_cap=60.0), dict(max_path_cost=1e6)),
]


def _instance(pkg, kind, **kw):
    return _swarm(pkg, **kw) if kind == "swarm" else _tight(pkg, **kw)


@pytest.mark.parametrize("solver,batch", [("dp", False), ("dp-sparse", False),
                                          ("dp-sparse", True)])
@pytest.mark.parametrize("case,inst,kw", SOLVE_CASES, ids=[c[0] for c in SOLVE_CASES])
def test_solve_ould_equals_reference(case, inst, kw, solver, batch):
    want = J.solve_ould(_instance("ref", **inst), solver=solver, **kw)
    got = T.solve_ould(_instance("port", **inst), solver=solver, batch_solve=batch,
                       device="cpu", **kw)
    _same(got, want)
    assert got.status == want.status
    if batch and case.startswith("swarm"):
        assert got.dp_stats.n_batched > 0                 # the fast path engaged


@pytest.mark.parametrize("k", [2, 3])
def test_batched_ladder_fallback_equals_reference(k):
    """At tiny k the batched pass rejects requests and the ladder (k
    escalations, the dense last resort) takes over: still identical."""
    for seed in range(3):
        want = J.solve_ould(_tight("ref", seed=seed), solver="dp-sparse", sparse_k=k,
                            max_path_cost=1e6)
        got = T.solve_ould(_tight("port", seed=seed), solver="dp-sparse", sparse_k=k,
                           max_path_cost=1e6, batch_solve=True, device="cpu")
        _same(got, want)
        assert got.dp_stats.n_dense_fallback == want.dp_stats.n_dense_fallback


@pytest.mark.parametrize("seed", [0, 1])
def test_ilp_equals_reference(seed):
    kw = dict(solver="ilp", include_compute=True)
    _same(T.solve_ould(_tight("port", n=8, requests=4, seed=seed), **kw),
          J.solve_ould(_tight("ref", n=8, requests=4, seed=seed), **kw))
    _same(T.solve_ould(_swarm("port", n=8, requests=3, seed=seed), solver="ilp"),
          J.solve_ould(_swarm("ref", n=8, requests=3, seed=seed), solver="ilp"))


@pytest.mark.parametrize("kind", ["nearest", "hrm", "nearest_hrm"])
def test_heuristics_and_evaluate_equal_reference(kind):
    for inst in (dict(kind="swarm", n=30, requests=10, seed=0),
                 dict(kind="tight", seed=2)):
        pj, pt = _instance("ref", **inst), _instance("port", **inst)
        sj, st = J.solve_heuristic(pj, kind), T.solve_heuristic(pt, kind)
        _same(st, sj)
        ej, et = J.evaluate(pj, sj), T.evaluate(pt, st)
        for f in ("comm_latency_s", "comp_latency_s", "shared_bytes", "feasible",
                  "n_admitted"):
            assert getattr(et, f) == getattr(ej, f), f
        np.testing.assert_array_equal(et.per_request_s, ej.per_request_s)


@pytest.mark.parametrize("name", ["ould-dp", "ould-dp-sparse", "nearest", "hrm",
                                  "nearest-hrm", "incremental", "incremental-sparse"])
def test_registry_planners_equal_reference(name):
    pj, pt = _swarm("ref", n=40, requests=12, seed=4), _swarm("port", n=40, requests=12, seed=4)
    want = J.get_planner(name).plan(pj, J.SnapshotView(pj.rates))
    got = T.get_planner(name, device="cpu").plan(pt, T.SnapshotView(pt.rates))
    assert got.planner_name == want.planner_name and got.view_kind == want.view_kind
    _same(got, want)
    if name.endswith("sparse"):
        bat = T.get_planner(name, batch_solve=True, device="cpu").plan(
            pt, T.SnapshotView(pt.rates))
        _same(bat, want)
        assert bat.solve_stats.n_batched > 0


@pytest.mark.parametrize("solver,batch", [("dp", False), ("dp-sparse", False),
                                          ("dp-sparse", True)])
def test_incremental_resolve_equals_reference(solver, batch):
    """Epoch re-solves over a drifting RPG topology: the port's warm solver
    (batched or not) equals the reference's sequential warm solver."""
    pj, pt = (_swarm(p, n=40, requests=16, seed=2, hotspots=3) for p in ("ref", "port"))
    pos = JRPGMobility(JRPGParams(n_uavs=40, area_m=300.0, homogeneous=True),
                       seed=2).positions(40, seed=5)
    sj = J.IncrementalSolver(pj.profile, pj.mem_cap, pj.comp_cap, pj.compute_speed,
                             solver=solver, rel_change=0.0)
    st = T.IncrementalSolver(pt.profile, pt.mem_cap, pt.comp_cap, pt.compute_speed,
                             solver=solver, rel_change=0.0, batch_solve=batch, device="cpu")
    _same(st.solve(pt.rates, pt.sources)[0], sj.solve(pj.rates, pj.sources)[0])
    replaced = batched = 0
    for t in (10, 25, 39):
        wj, _ = sj.resolve(J.rate_matrix(pos[t]), pj.sources)
        wt, stats = st.resolve(T.rate_matrix(pos[t]), pt.sources)
        _same(wt, wj)
        assert wt.status == wj.status and wt.solver == wj.solver
        replaced += stats.n_replaced
        batched += stats.n_batched
    assert replaced > 0
    assert (batched > 0) == batch


# ---------------------------------------------------------------------------
# the sweep: plain version and solve_batch against the numpy oracle
# ---------------------------------------------------------------------------

def _kernel_inputs(prob, mod=t_ould):
    spb = prob.transfer_cost()
    prof = prob.profile
    consts = mod._sparse_consts(spb, prof.output_vector(), prof.memory_vector(),
                                prof.compute_vector())
    mem_left = prob.mem_cap.astype(float).copy()
    comp_left = prob.comp_cap.astype(float).copy()
    head = (mem_left / max(float(mem_left.max()), 1e-30)
            + comp_left / max(float(comp_left.max()), 1e-30))
    return spb, consts, mem_left, comp_left, head


def _compute_cost(prob):
    comp = np.array(prob.profile.compute_vector())
    return comp[:, None] / prob.compute_speed[None, :] * prob.horizon()


def _oracle_rows(spb, Ks, srcs, cc, cand, valid, Kv):
    """Per-row ``_sparse_run``'s final costs and back-pointers, recomputed
    as the oracle does (the function itself returns only the path)."""
    finals, backs = [], []
    for q, src in enumerate(srcs):
        M, kk = cand[q].shape
        pen = np.where(valid[q], 0.0, np.inf)
        cost = Ks * spb[src, cand[q][0]] + pen[0]
        if cc is not None:
            cost = cost + cc[0, cand[q][0]]
        with np.errstate(invalid="ignore"):             # 0 x inf: NaN, as in the oracle
            trans = Kv[:M - 1, None, None] * spb[cand[q][:-1, :, None], cand[q][1:, None, :]]
        trans += pen[1:, None, :]
        if cc is not None:
            trans += cc[np.arange(1, M)[:, None], cand[q][1:]][:, None, :]
        bq = np.empty((M - 1, kk), np.int64)
        for j in range(1, M):
            step = cost[:, None] + trans[j - 1]
            bq[j - 1] = step.argmin(axis=0)
            cost = step[bq[j - 1], np.arange(kk)]
        finals.append(cost)
        backs.append(bq)
    return np.stack(finals), np.stack(backs, axis=1)


SWEEP_CASES = [  # n, k, with compute cost, share of candidates made infeasible
    (40, 6, False, 0.0), (40, 6, True, 0.3), (30, 30, True, 0.0), (30, 40, False, 0.5),
    (64, 17, True, 0.2), (12, 4, True, 1.0),
    # k above the card's former cap of 64
    (160, 65, True, 0.2), (300, 128, False, 0.3)]


@pytest.mark.parametrize("n,k,with_cc,inf_share", SWEEP_CASES)
def test_plain_sweep_and_solve_batch_equal_sparse_run(n, k, with_cc, inf_share):
    """Bit for bit: the plain sweep's final costs and back-pointers equal the
    oracle's, with inf penalties, with and without compute cost, at k >= N;
    solve_batch's paths and costs equal ``_sparse_run``'s, padded rows
    dropped."""
    prob = _swarm("port", n=n, requests=12, seed=n)
    spb, consts, mem_left, comp_left, head = _kernel_inputs(prob)
    srcs = np.unique(prob.sources)
    cand, valid = t_ould._sparse_select_batch(spb, srcs, mem_left, comp_left, head, consts, k)
    valid = valid & (np.random.default_rng(k).random(valid.shape) >= inf_share)
    cc = _compute_cost(prob) if with_cc else None
    Ks = prob.profile.input_bytes
    f, b = ref.dp_sweep(torch.from_numpy(spb), torch.from_numpy(consts[0]), Ks,
                        torch.from_numpy(srcs), torch.from_numpy(cand), torch.from_numpy(valid),
                        None if cc is None else torch.from_numpy(cc))
    wf, wb = _oracle_rows(spb, Ks, srcs, cc, cand, valid, consts[0])
    assert f.numpy().tobytes() == wf.tobytes()
    np.testing.assert_array_equal(b.numpy(), wb)
    paths, costs = batch_dp.solve_batch(spb, Ks, cc, srcs, cand, valid, consts, device="cpu")
    assert len(paths) == len(srcs) == costs.shape[0] < batch_dp.bucket_rows(len(srcs))
    for q, src in enumerate(srcs):
        want_path, want_cost = j_ould._sparse_run(spb, Ks, int(src), cc, cand[q], valid[q],
                                                  consts)
        if want_path is None:
            assert paths[q] is None and costs[q] == np.inf
        else:
            np.testing.assert_array_equal(paths[q], want_path)
            assert float(costs[q]) == want_cost


def test_plain_sweep_takes_numpy_argmin_on_nan():
    """0 x inf makes a NaN (a zero-byte layer over an infinite link): the
    back-pointer is the column's first NaN, as numpy's argmin gives, and the
    carried cost is that NaN."""
    rng = np.random.default_rng(0)
    N, S, M, k = 16, 4, 5, 6
    spb = rng.uniform(0, 1e-6, (N, N))
    spb[rng.random((N, N)) < 0.2] = np.inf
    np.fill_diagonal(spb, 0.0)
    Kv = rng.uniform(1e3, 1e5, M)
    Kv[1] = 0.0
    srcs = rng.integers(0, N, S)
    cand = np.sort(rng.integers(0, N, (S, M, k)), axis=2)
    valid = rng.random((S, M, k)) > 0.2
    f, b = ref.dp_sweep(*(torch.from_numpy(a) for a in (spb, Kv)), 7.0,
                        *(torch.from_numpy(a) for a in (srcs, cand, valid)))
    wf, wb = _oracle_rows(spb, 7.0, srcs, None, cand, valid, Kv)
    assert np.isnan(wf).any()
    assert f.numpy().tobytes() == wf.tobytes()
    np.testing.assert_array_equal(b.numpy(), wb)


def test_wrapper_on_cpu_runs_the_plain_version():
    rng = np.random.default_rng(1)
    N, S, M, k = 20, 8, 4, 5
    args = (torch.from_numpy(rng.uniform(0, 1, (N, N))), torch.from_numpy(rng.uniform(1, 2, M)),
            3.0, torch.from_numpy(rng.integers(0, N, S)),
            torch.from_numpy(np.sort(rng.integers(0, N, (S, M, k)), axis=2)),
            torch.from_numpy(rng.random((S, M, k)) > 0.3))
    n0 = dp_sweep.n_launches
    for got, want in zip(dp_sweep(*args), ref.dp_sweep(*args)):
        assert torch.equal(got, want)
    assert dp_sweep.n_launches == n0
    with pytest.raises(ValueError):                  # off the CPU: never the plain path
        dp_sweep(*(a.to("meta") if isinstance(a, torch.Tensor) else a for a in args))


def test_bucket_rows():
    assert batch_dp.bucket_rows(1) == batch_dp.MIN_BUCKET
    assert batch_dp.bucket_rows(8) == 8
    assert batch_dp.bucket_rows(9) == 16
    assert batch_dp.bucket_rows(16) == 16
    assert batch_dp.bucket_rows(1000) == 1024


def test_launch_shapes_move_only_on_bucket_crossing():
    """Different row counts inside one padded bucket launch at one shape;
    crossing a power-of-two boundary adds exactly one."""
    prob = _swarm("port", n=30, requests=8, seed=0)
    spb, consts, mem_left, comp_left, head = _kernel_inputs(prob)
    Ks = prob.profile.input_bytes

    def solve(n_rows, k=13):   # k 13: launch shapes no other test uses
        srcs = np.arange(n_rows, dtype=np.int64) % 30
        cand, valid = t_ould._sparse_select_batch(spb, srcs, mem_left, comp_left, head,
                                                  consts, k)
        batch_dp.solve_batch(spb, Ks, None, srcs, cand, valid, consts, device="cpu")

    solve(3)                                     # bucket 8 (pads up)
    base = batch_dp.compile_count()
    assert base >= 1
    solve(5)                                     # still bucket 8
    solve(8)                                     # exactly at the boundary
    assert batch_dp.compile_count() == base
    solve(9)                                     # bucket 16: one new shape
    assert batch_dp.compile_count() == base + 1
    solve(16)                                    # same bucket again
    assert batch_dp.compile_count() == base + 1


def test_cold_dispatch_flag_separates_first_launch_from_solve():
    """A batched solve at a new launch shape flags its stats; the identical
    re-solve does not."""
    prob = _swarm("port", n=37, requests=11, seed=5)
    planner = T.get_planner("ould-dp-sparse", batch_solve=True, device="cpu",
                            sparse_k=11)                   # a shape no other test uses
    s1 = planner.plan(prob, T.SnapshotView(prob.rates)).solve_stats
    s2 = planner.plan(prob, T.SnapshotView(prob.rates)).solve_stats
    assert s1.n_batched > 0 and s1.n_jit_compiles >= 1 and s1.cold_dispatch
    assert s2.n_jit_compiles == 0 and not s2.cold_dispatch


def test_batched_entry_points_need_the_card_unless_asked():
    """batch_solve=True sweeps on the card by default: without one it raises
    (never a quiet CPU run); the sequential solvers never touch a device."""
    if torch.cuda.is_available():
        pytest.skip("checks the card-less behaviour")
    prob = _swarm("port", n=20, requests=6, seed=0)
    with pytest.raises(RuntimeError, match="cuda"):
        T.solve_ould(prob, solver="dp-sparse", batch_solve=True)
    with pytest.raises(RuntimeError, match="cuda"):
        T.get_planner("incremental-sparse", batch_solve=True).plan(
            prob, T.SnapshotView(prob.rates))
    T.solve_ould(prob, solver="dp-sparse")
