"""The port's byte-moving transports and warm-start layer
(``repro_torch.transport``, ``exec/compile_cache.py``) against the
reference's on the CPU: tests/test_transport.py's cases through the port,
held to the reference wherever the reference runs here, and the port's own
cases (torch dtypes numpy lacks, the device a tensor returns to, a worker
that cannot reach its device, the worker's stdlib-only start, the build
directory re-point).

The reference's multiproc workers run jax on the CPU; the port's run
``worker.py --torch --device cpu``.  Engine outputs through a byte-moving
transport must equal the in-process run's bit for bit, and the reference
engine's within 1e-4 × max|ref| (the two frameworks' convolutions sum in
other orders).  The reference's warm-start test asserts a speedup above
1.2 and a non-empty cache directory: claims about XLA's disk cache, which
the port does not have.  Its warm-start test checks the report and the
build-directory bookkeeping instead; the card's figures are printed by
``chip_smoke.py``.
"""

import ast
import os
import pathlib
import subprocess
import sys
import time
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

import repro.core as J
import repro.exec as JX
import repro.transport as JT
from repro.core.planner import Plan as JPlan
from repro.models import cnn as jcnn
from repro_torch import core as T
from repro_torch import exec as TX
from repro_torch import transport as TT
from repro_torch.core.planner import Plan as TPlan
from repro_torch.exec import compile_cache
from repro_torch.kernels import build
from repro_torch.launch import serve as launch_serve
from repro_torch.models import cnn as tcnn
from repro_torch.models import cnn_from_jax_params
from repro_torch.transport.__main__ import byte_equal

ROOT = pathlib.Path(__file__).resolve().parents[1]
MB = 1e6
REL = 1e-4
FRAME_HW = (326, 595, 3)      # lenet layer fns are input-shape-specific
PKG = {"ref": (J, JX, JPlan), "port": (T, TX, TPlan)}


def _problem(pkg, n_nodes=6, requests=2, seed=0, mem_mb=4096):
    C = PKG[pkg][0]
    mob = C.RPGMobility(C.RPGParams(n_uavs=n_nodes, area_m=120.0, homogeneous=False),
                        seed=seed)
    rates = C.rate_matrix(mob.positions(1, seed=seed)[0], C.RadioParams())
    return C.Problem(C.lenet_profile(), np.full(n_nodes, mem_mb * MB), np.full(n_nodes, 1e18),
                     rates, np.zeros(requests, np.int64), compute_speed=np.full(n_nodes, 9.5e9))


def _manual_plan(pkg, prob, sizes_per_request):
    C, _, Plan = PKG[pkg]
    M, R = prob.n_layers, len(sizes_per_request)
    assign = np.zeros((R, M), np.int64)
    for r, sizes in enumerate(sizes_per_request):
        assert sum(sizes) == M
        j = 0
        for node, size in enumerate(sizes):
            assign[r, j:j + size] = node
            j += size
    sol = C.Solution(assign, 0.0, "feasible", 0.0, np.ones(R, bool), solver="manual")
    return Plan(sol, "manual", "snapshot", prob)


def _frames(rng, n):
    return rng.standard_normal((n, *FRAME_HW)).astype(np.float32)


@pytest.fixture(scope="module")
def lenet():
    """LeNet's layer functions in both packages on the same weights: the
    reference's init (key 1), converted for the port on the CPU."""
    tree = jcnn.lenet_init(jax.random.PRNGKey(1))
    params = cnn_from_jax_params("lenet", jax.tree.map(np.asarray, tree), device="cpu")
    return jcnn.lenet_layers(tree), tcnn.lenet_layers(params)


@pytest.fixture
def restore_build_dir():
    prev = build.BUILD_DIR
    yield
    build.set_build_dir(prev)


def _close(got, want, what=""):
    err = np.abs(np.asarray(got) - np.asarray(want)).max()
    assert err <= REL * np.abs(want).max(), (what, err)


# ---------------------------------------------------------------------------
# worker protocol and backend registry
# ---------------------------------------------------------------------------

def test_loopback_workers_are_real_processes():
    """Shipments echo exactly through >= 2 distinct worker OS processes, in
    both packages, with the same link accounting."""
    rng = np.random.default_rng(0)
    arrays = [(rng.standard_normal(shape) * 10).astype(dtype)
              for shape, dtype in (((7, 5), np.float32), ((64, 64, 3), np.float32),
                                   ((11,), np.int64), ((3, 2), np.float64))]
    with JT.LoopbackTransport(n_workers=2) as jtp, TT.LoopbackTransport(n_workers=2) as tp:
        assert len(set(tp.worker_pids)) == 2
        assert os.getpid() not in tp.worker_pids
        assert not set(tp.worker_pids) & set(jtp.worker_pids)
        for arr in arrays:
            want = np.asarray(jtp.ship(0, 1, arr).array)
            res = tp.ship(0, 1, torch.from_numpy(arr))
            assert res.moved and res.nbytes == arr.nbytes
            got = res.array
            assert isinstance(got, torch.Tensor) and got.shape == arr.shape
            assert got.numpy().dtype == arr.dtype
            np.testing.assert_array_equal(got.numpy(), arr)
            np.testing.assert_array_equal(got.numpy(), want)
        assert tp.moved_bytes == jtp.moved_bytes > 0
        ls, jls = tp.link_stats[(0, 1)], jtp.link_stats[(0, 1)]
        assert ls.n == jls.n == 4 and ls.nbytes == jls.nbytes
        assert ls.wall_s > 0 and ls.bytes_per_s > 0
        assert tp.worker_stats.keys() == jtp.worker_stats.keys() == {1}
        assert tp.worker_stats[1].n == 4
    assert not tp.started         # context exit shut the workers down


def test_loopback_worker_ownership():
    node_of = {0: 0, 1: 0, 2: 1}
    tp = TT.LoopbackTransport(n_workers=2, node_of=node_of)
    jtp = JT.LoopbackTransport(n_workers=2, node_of=node_of)
    assert [tp.worker_of(n) for n in range(8)] == [jtp.worker_of(n) for n in range(8)]
    assert tp.worker_of(0) == tp.worker_of(1) == 0 and tp.worker_of(2) == 1
    assert tp.worker_of(5) == 1   # unmapped nodes fall back to round-robin
    with pytest.raises(ValueError, match="at least one"):
        TT.LoopbackTransport(n_workers=0)


def test_make_transport_registry():
    assert TT.TRANSPORTS == JT.TRANSPORTS
    assert isinstance(TT.make_transport("inproc"), TT.InProcTransport)
    assert isinstance(TT.make_transport("loopback"), TT.LoopbackTransport)
    group_of = np.array([0, 0, 1, 1, 2])
    mp = TT.make_transport("multiproc", group_of=group_of, device="cpu")
    jmp = JT.make_transport("multiproc", group_of=group_of)
    assert isinstance(mp, TT.MultiProcTransport) and mp.device == "cpu"
    assert mp.n_workers == jmp.n_workers == 3
    assert [mp.worker_of(n) for n in range(6)] == [jmp.worker_of(n) for n in range(6)]
    assert TT.make_transport("multiproc").device == "cuda"     # the card by default
    assert TT.make_transport("multiproc", n_workers=3, device="cpu").n_workers == 3
    for name in TT.TRANSPORTS:
        assert isinstance(TT.make_transport(name), TT.Transport)
    with pytest.raises(ValueError, match="unknown transport"):
        TT.make_transport("carrier-pigeon")


def test_multiproc_ships_through_torch_workers():
    """--torch workers land the buffer on their device before echoing; the
    reference's jax workers on the same groups echo the same bytes."""
    rng = np.random.default_rng(1)
    arr = rng.standard_normal((128, 64)).astype(np.float32)
    with TT.MultiProcTransport(group_of=np.array([0, 0, 1, 1]), device="cpu") as tp:
        tp.start()
        assert len(set(tp.worker_pids)) == 2 and os.getpid() not in tp.worker_pids
        assert tp.worker_backends == ["cpu", "cpu"] and tp.worker_devices == ["cpu", "cpu"]
        res = tp.ship(0, 3, torch.from_numpy(arr))
        assert res.moved and tp.worker_of(3) == 1 and tp.worker_stats[1].n == 1
        np.testing.assert_array_equal(res.array.numpy(), arr)
    with JT.MultiProcTransport(group_of=np.array([0, 0, 1, 1])) as jtp:
        assert all(jtp.worker_backends)
        np.testing.assert_array_equal(np.asarray(jtp.ship(0, 3, arr).array), arr)


# ---------------------------------------------------------------------------
# engine equivalence across backends
# ---------------------------------------------------------------------------

def test_inproc_is_bit_compatible_default():
    """The default backend hands the consuming stage the very tensor it was
    given; nothing leaves the process."""
    engine = TX.ExecutionEngine(TX.layer_fns_for(T.lenet_profile(), device="cpu"),
                                device="cpu")
    assert isinstance(engine.transport, TT.InProcTransport)
    tp = TT.InProcTransport()
    x = torch.ones((4, 4))
    res = tp.ship(0, 1, x)
    assert res.array is x and not res.moved
    assert tp.moved_bytes == 0
    assert res.wall_s >= 0 and tp.link_stats[(0, 1)].nbytes == x.numel() * 4


def test_loopback_engine_outputs_bitwise_equal_to_inproc(lenet):
    """Routing every transfer through worker OS processes changes only the
    timings, never a single output bit; the outputs match the reference
    engine's, and the modeled comm terms equal the reference's exactly."""
    jfns, tfns = lenet
    sizes = [[3, 4], [1, 4, 2]]
    graph = TX.compile_plan(_manual_plan("port", _problem("port", requests=2), sizes))
    jgraph = JX.compile_plan(_manual_plan("ref", _problem("ref", requests=2), sizes))
    assert graph.transfers, "plan must have cut points to exercise shipping"
    frames = _frames(np.random.default_rng(0), 2)

    ref = TX.ExecutionEngine(tfns, device="cpu").run(graph, frames)
    jref = JX.ExecutionEngine(jfns).run(jgraph, frames)
    with TT.LoopbackTransport(n_workers=2) as tp:
        report = TX.ExecutionEngine(tfns, transport=tp, device="cpu").run(graph, frames)
        assert len(set(tp.worker_pids)) == 2
        assert os.getpid() not in tp.worker_pids
        assert tp.moved_bytes > 0

    assert ref.transport == "inproc" and report.transport == "loopback"
    for r in graph.requests:
        assert np.array_equal(report.outputs[r], ref.outputs[r]), r
        _close(report.outputs[r], jref.outputs[r], f"request {r}")
    np.testing.assert_array_equal(report.comm_s, ref.comm_s)
    np.testing.assert_array_equal(report.comm_s, jref.comm_s)
    assert all(tr.serialize_s > 0 for tr in report.transfers)
    assert len(report.transfers) == len(graph.transfers)


def test_transport_samples_cover_graph_links(lenet):
    """Every link the graph ships on shows up in the transport's realized
    bandwidth ledger, with the bytes the reference's transport records."""
    jfns, tfns = lenet
    sizes = [[3, 4], [2, 2, 1, 2]]
    graph = TX.compile_plan(_manual_plan("port", _problem("port", requests=2), sizes))
    jgraph = JX.compile_plan(_manual_plan("ref", _problem("ref", requests=2), sizes))
    payload = TX.link_payload_bytes(graph)
    assert payload == JX.link_payload_bytes(jgraph)
    frames = _frames(np.random.default_rng(1), 2)
    with TT.LoopbackTransport(n_workers=2) as tp, JT.LoopbackTransport(n_workers=2) as jtp:
        TX.ExecutionEngine(tfns, transport=tp, device="cpu").run(graph, frames)
        JX.ExecutionEngine(jfns, transport=jtp).run(jgraph, frames)
        assert set(tp.link_stats) == set(payload) == set(jtp.link_stats)
        for link, nbytes in payload.items():
            assert tp.link_stats[link].nbytes == pytest.approx(nbytes)
            assert tp.link_stats[link].nbytes == jtp.link_stats[link].nbytes
        spb = tp.measured_spb(6)
        for s, d in payload:
            assert np.isfinite(spb[s, d]) and spb[s, d] > 0


# ---------------------------------------------------------------------------
# the warm-start layer
# ---------------------------------------------------------------------------

def test_warm_start_report_and_build_dir(lenet, tmp_path, restore_build_dir):
    """measure_warm_start times the ranges' first calls and the calls after
    clear_in_memory, with the build directory at cache_dir meanwhile and
    restored after; the outputs it chains are the model's."""
    _, tfns = lenet
    frame = _frames(np.random.default_rng(2), 1)[0]
    prev = build.BUILD_DIR
    rep = TX.measure_warm_start(tfns, [(0, 3), (3, 7)], frame, cache_dir=tmp_path / "cc",
                                device="cpu")
    assert isinstance(rep, TX.WarmStartReport) and rep.ranges == ((0, 3), (3, 7))
    assert len(rep.cold_s) == len(rep.warm_s) == 2
    assert all(w > 0 for w in rep.cold_s + rep.warm_s)
    assert rep.cold_total_s == sum(rep.cold_s) and rep.speedup > 0
    assert rep.summary().startswith("warm start: 2 ranges, cold ")
    assert (tmp_path / "cc").is_dir()
    assert build.BUILD_DIR == prev


def test_warm_start_rejects_unchained_ranges(lenet, tmp_path):
    _, tfns = lenet
    frame = np.zeros(FRAME_HW, np.float32)
    for mod, fns in ((TX, tfns), (JX, lenet[0])):
        with pytest.raises(ValueError, match="chain from layer 0"):
            kw = dict(device="cpu") if mod is TX else {}
            mod.measure_warm_start(fns, [(2, 5)], frame, cache_dir=tmp_path, **kw)


def test_compile_cache_enable_restores(tmp_path, restore_build_dir):
    prev = compile_cache.cache_dir()
    try:
        d = compile_cache.enable(tmp_path / "cc2")
        assert compile_cache.is_enabled() and compile_cache.cache_dir() == d
        assert d.is_dir() and build.BUILD_DIR == d
    finally:
        if prev is None:
            compile_cache.disable()
        else:
            compile_cache.enable(prev)
    assert compile_cache.cache_dir() == prev


def test_enable_repoints_lib_path_and_drops_loaded_handles(tmp_path, restore_build_dir,
                                                          monkeypatch):
    """A re-point that left the handle tables holding libraries of the old
    directory would be a silent no-op: enable, disable and clear_in_memory
    drop load's table and function's cache (path logic only, no nvcc)."""
    src = build.CSRC / "dp_sweep.cu"
    default = build._lib_path(src)
    assert default.parent == build.DEFAULT_BUILD_DIR
    monkeypatch.setattr(build, "load", lambda lib: types.SimpleNamespace(f=types.SimpleNamespace()))
    for step in (lambda: compile_cache.enable(tmp_path / "b"), compile_cache.clear_in_memory,
                 compile_cache.disable):
        build._libs["dp_sweep"] = object()
        build.function("dp_sweep", "f", ())
        assert build.function.cache_info().currsize == 1
        step()
        assert build._libs == {} and build.function.cache_info().currsize == 0
    compile_cache.enable(tmp_path / "b")
    moved = build._lib_path(src)
    assert moved.parent == tmp_path / "b" and moved.name == default.name
    compile_cache.disable()
    assert build._lib_path(src) == default and compile_cache.cache_dir() is None


def test_engine_warm_start_runs_signature(lenet):
    """warm_start runs a stage signature's ranges (the churn-rejoin path)."""
    _, tfns = lenet
    graph = TX.compile_plan(_manual_plan("port", _problem("port", requests=1), [[1, 4, 2]]))
    sig = TX.stage_signature(graph)
    engine = TX.ExecutionEngine(tfns, device="cpu")
    wall = engine.warm_start(sig, np.zeros(FRAME_HW, np.float32))
    assert wall > 0
    for s, e in sig:
        assert (s, e) in engine._closures


# ---------------------------------------------------------------------------
# bandwidth-calibrated re-solves
# ---------------------------------------------------------------------------

def test_comm_calibration_closes_the_loop(lenet):
    """Realized per-link bandwidth from a loopback run replaces the analytic
    rates, the provenance rides into the re-solved Plan.problem, and the
    modeled-vs-realized comm gap collapses on the re-run; the first plan is
    the reference's."""
    _, tfns = lenet
    probs = {}
    for pkg in PKG:
        C = PKG[pkg][0]
        mob = C.RPGMobility(C.RPGParams(n_uavs=8, area_m=150.0, homogeneous=False), seed=0)
        rates = C.rate_matrix(mob.positions(1)[0], C.RadioParams())
        sources = np.random.default_rng(0).integers(0, 3, 4).astype(np.int64)
        probs[pkg] = C.Problem(C.lenet_profile(), np.full(8, 128 * MB), np.full(8, 95e9),
                               rates, sources, compute_speed=np.full(8, 9.5e9))
    prob, rates = probs["port"], probs["port"].rates
    assert prob.comm_source == "analytic"
    rng = np.random.default_rng(0)
    rng.integers(0, 3, 4)
    frames = _frames(rng, 4)
    planner = T.get_planner("ould-dp")
    jplan = J.get_planner("ould-dp").plan(probs["ref"], J.SnapshotView(probs["ref"].rates))

    with TT.LoopbackTransport(n_workers=2) as tp:
        engine = TX.ExecutionEngine(tfns, transport=tp, device="cpu")
        plan = planner.plan(prob, T.SnapshotView(rates))
        np.testing.assert_array_equal(plan.assign, jplan.assign)
        graph = TX.compile_plan(plan)
        assert graph.transfers, "scenario must ship bytes to calibrate comm"
        report = engine.run(graph, frames,
                            predicted_s=np.asarray(plan.evaluate().per_request_s))

        cal_prob, recon = TX.calibrated_problem(prob, report, transport=tp)
        assert recon.transport == "loopback"
        assert recon.link_measured_spb and recon.comm_mae_s > 0
        assert "comm[loopback]" in recon.summary()
        assert cal_prob.comm_source == "measured:loopback"
        for (s, d), spb in recon.link_measured_spb.items():
            assert cal_prob.transfer_cost()[s, d] == pytest.approx(spb)
        untouched = [(s, d) for s in range(8) for d in range(8) if s != d
                     and (s, d) not in recon.link_measured_spb]
        sd = untouched[0]
        assert cal_prob.rates[sd] == pytest.approx(rates[sd])

        replan = planner.plan(cal_prob, T.SnapshotView(cal_prob.rates))
        assert replan.problem.comm_source == "measured:loopback"
        regraph = TX.compile_plan(replan)
        rereport = engine.run(regraph, frames,
                              predicted_s=np.asarray(replan.evaluate().per_request_s))
        _, recon2 = TX.calibrated_problem(cal_prob, rereport, transport=tp)
        assert regraph.requests
        # analytic radio delays are orders of magnitude off localhost
        # sockets; after substitution the modeled delays track realized
        assert recon2.comm_mae_s < recon.comm_mae_s


def test_calibrate_rates_ignores_bogus_samples():
    samples = {(0, 0): 1e-9, (0, 1): np.nan, (1, 2): -1.0, (99, 0): 1e-9}
    out = {}
    for pkg in PKG:
        prob = _problem(pkg, requests=1)
        cal = PKG[pkg][1].calibrate_rates(prob, samples, source="measured:test")
        np.testing.assert_array_equal(cal.rates, prob.rates)
        assert cal.comm_source == "measured:test"
        assert prob.comm_source == "analytic"      # never mutated in place
        out[pkg] = cal.rates
    np.testing.assert_array_equal(out["port"], out["ref"])


# ---------------------------------------------------------------------------
# the port's own cases
# ---------------------------------------------------------------------------

def _noncontiguous():
    return torch.arange(60, dtype=torch.float32).reshape(6, 10)[::2, 1::3]


@pytest.mark.parametrize("make", [
    lambda g: torch.randn(33, 17, generator=g),
    lambda g: torch.randn(5, 7, 3, generator=g).to(torch.bfloat16),
    lambda g: torch.randint(-2 ** 31, 2 ** 31 - 1, (257,), generator=g, dtype=torch.int32),
    lambda g: _noncontiguous(),
], ids=["float32", "bfloat16", "int32", "noncontiguous"])
def test_loopback_round_trip_is_byte_exact(make):
    x = make(torch.Generator().manual_seed(3))
    with TT.LoopbackTransport(n_workers=1) as tp:
        res = tp.ship(0, 1, x)
    assert res.nbytes == x.numel() * x.element_size()
    assert byte_equal(res.array, x.contiguous()) and res.array.is_contiguous()
    # the reconstruction owns writable memory: writing it leaves x alone
    before = x.clone()
    res.array.zero_()
    assert torch.equal(x, before)


def test_tensor_comes_back_on_the_device_it_left():
    x = torch.randn(4, 4)
    with TT.LoopbackTransport(n_workers=1) as tp:
        assert tp.ship(0, 0, x).array.device == x.device
    engine = TX.ExecutionEngine([], device="cpu")
    y = torch.ones(2)
    assert engine._put(y) is y            # the engine's guard: a no-op on its device


def test_cuda_worker_without_a_card_fails_start_within_seconds():
    if torch.cuda.is_available():
        pytest.skip("checks the card-less behaviour")
    t0 = time.perf_counter()
    tp = TT.MultiProcTransport(n_workers=2)          # device "cuda" by default
    with pytest.raises(RuntimeError, match=r"exited with code 1 before its hello.*cuda"):
        tp.start()
    assert time.perf_counter() - t0 < 60.0, "start() waited out its timeout"
    assert not tp.started and tp._procs == []


STDLIB = set(sys.stdlib_module_names)


def test_worker_imports_only_the_stdlib_at_top_level():
    """worker.py starts as a script by its path: stdlib imports at top level
    and no relative import anywhere (torch is imported lazily, in --torch
    mode only)."""
    tree = ast.parse((ROOT / "src/repro_torch/transport/worker.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Import):
            assert all(a.name.split(".")[0] in STDLIB for a in node.names), node.lineno
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0 and node.module.split(".")[0] in STDLIB | {"__future__"}
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.level]
    lazy = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    assert "torch" in lazy
    path = str(ROOT / "src/repro_torch/transport/worker.py")
    code = (f"import runpy, sys\n"
            f"sys.argv = [{path!r}, '--help']\n"
            f"try:\n    runpy.run_path({path!r}, run_name='__main__')\n"
            f"except SystemExit:\n    pass\n"
            f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"('torch', 'numpy', 'repro_torch', 'repro'))\n"
            f"assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=60)
    assert r.returncode == 0, r.stderr


@pytest.mark.parametrize("args", [[], ["--multiproc", "--device", "cpu"]],
                         ids=["loopback", "multiproc-cpu"])
def test_transport_cli_round_trips(args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.transport", "--workers", "2",
                        "--mb", "4", *args], env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr
    assert "byte-exact" in r.stdout and "(float32, bfloat16, int32)" in r.stdout
    line = next(s for s in r.stdout.splitlines() if "worker processes (pids" in s)
    pids = [int(p) for p in line.split("(pids [")[1].split("]")[0].split(", ")]
    parent = int(line.split("parent ")[1].rstrip(")"))
    assert len(set(pids)) == 2 and parent not in pids
    if args:
        assert "worker backends: ['cpu', 'cpu']" in r.stdout


@pytest.mark.parametrize("transport", ["loopback", "multiproc"])
def test_launcher_transport_flags_on_cpu(transport, capsys, tmp_path, restore_build_dir):
    """--transport ships the placed LeNet's transfers through workers and the
    re-solve prices comm from the realized bandwidth; --compile-cache points
    the kernels' build directory at its argument."""
    launch_serve.main(["--reduced", "--device", "cpu", "--batch", "4", "--prompt-len", "4",
                       "--steps", "2", "--execute", "--pool-nodes", "8",
                       "--transport", transport, "--transport-workers", "2",
                       "--compile-cache", str(tmp_path / "cc")])
    out = capsys.readouterr().out
    assert f"[exec] transport={transport} workers=[" in out
    assert f"re-solve priced comm from 'measured:{transport}'" in out
    assert f"comm[{transport}]" in out and "after calibrated re-solve" in out
    assert build.BUILD_DIR == tmp_path / "cc"
