"""The port's placed-execution slice (``models/cnn.py``, ``exec/``,
``transport/``, ``obs/``) against the reference on the CPU.

The same weights (drawn with numpy in the reference's layout and shapes,
converted for the port by ``cnn_from_jax_params``) and the same frames
(numpy, from seeds) go through both packages.  Tolerance
1e-4 × max|ref|: the two frameworks' convolutions and matrix products sum
in other orders in f32.  Graphs, transfer prices and calibration are numpy
in both packages and must be equal exactly.
"""

import collections

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

import repro.core as J
import repro.exec as JX
from repro.core.planner import Plan as JPlan
from repro.models import cnn as jcnn
from repro.obs import Tracer as JTracer
from repro_torch import core as T
from repro_torch import exec as TX
from repro_torch.core.planner import Plan as TPlan
from repro_torch.launch import serve as launch_serve
from repro_torch.models import cnn as tcnn
from repro_torch.models import cnn_from_jax_params
from repro_torch.obs import Tracer as TTracer
from repro_torch.transport import InProcTransport

MB = 1e6
REL = 1e-4
HW = {"lenet": (326, 595, 3), "vgg16": (48, 64, 3)}   # tests/test_exec.py's sizes
PKG = {"ref": (J, JX, JPlan, JTracer), "port": (T, TX, TPlan, TTracer)}


def _close(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= REL * np.abs(want).max(), (what, err, np.abs(want).max())


def _tree(name, head=None):
    """Weights in the reference's layout (HWIO convs, (in, out) dense) with
    its shapes (``jax.eval_shape`` of its init) and fan_in ** -0.5 scale,
    drawn with numpy; ``head`` narrows VGG's fc6/fc7/fc8 width from 4096."""
    init = jcnn.lenet_init if name == "lenet" else jcnn.vgg16_init
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(11)
    tree = {}
    for layer, p in shapes.items():
        w = tuple(p["w"].shape)
        if head is not None and layer in ("fc6", "fc7", "fc8"):
            w = (w[0] if layer == "fc6" else head, head if layer != "fc8" else w[1])
        fan_in = int(np.prod(w[:-1]))
        tree[layer] = {"w": rng.standard_normal(w, np.float32) * np.float32(fan_in ** -0.5),
                       "b": rng.standard_normal(w[-1], np.float32) * np.float32(0.1)}
    return tree


@pytest.fixture(scope="module")
def weights():
    """(reference params as jax arrays, the port's conversion) per model;
    "vgg16-narrow" has a 64-wide head for the engine runs."""
    out = {}
    for key, name, head in (("lenet", "lenet", None), ("vgg16", "vgg16", None),
                            ("vgg16-narrow", "vgg16", 64)):
        tree = _tree(name, head)
        out[key] = (jax.tree.map(jax.numpy.asarray, tree),
                    cnn_from_jax_params(name, tree, device="cpu"))
    return out


def _layers(name, params, mod):
    return (mod.lenet_layers if name == "lenet" else mod.vgg16_layers)(params)


def _frames(seed, n, hw):
    return np.random.default_rng(seed).standard_normal((n, *hw)).astype(np.float32)


# ---------------------------------------------------------------------------
# the models, unit by unit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["lenet", "vgg16"])
def test_units_and_whole_model_match_reference(name, weights):
    tree, tparams = weights[name]
    jf, tf = _layers(name, tree, jcnn), _layers(name, tparams, tcnn)
    assert len(jf) == len(tf) == (7 if name == "lenet" else 18)
    x = _frames(0, 2, HW[name])
    for j, (fj, ft) in enumerate(zip(jf, tf)):
        want = np.asarray(fj(x))
        _close(ft(torch.from_numpy(np.array(x))).numpy(), want, f"{name} unit {j}")
        x = want
    frames = _frames(1, 2, HW[name])
    _close(tcnn.apply_layers(tf, torch.from_numpy(frames)).numpy(),
           np.asarray(jcnn.apply_layers(jf, frames)), f"{name} whole")


def test_lenet_flattens_in_nhwc_order(weights):
    """Unit 3 flattens the pooled NHWC map (h, w, c), as the reference's
    ``reshape`` does: a channels-first flatten would permute fc1's input."""
    tree, tparams = weights["lenet"]
    x = np.asarray(jcnn.apply_layers(jcnn.lenet_layers(tree), _frames(2, 1, HW["lenet"]), 0, 3))
    got = tcnn.lenet_layers(tparams)[3](torch.from_numpy(np.array(x))).numpy()
    want = np.asarray(jcnn.lenet_layers(tree)[3](x))
    assert got.shape == want.shape == (1, 78 * 145 * 16)
    _close(got, want)


@pytest.mark.parametrize("h,w", [(3, 5), (7, 7), (8, 9), (15, 22)],
                         ids=["pad", "exact", "crop-1x1", "crop-2x3"])
def test_vgg_head_pads_crops_and_block_means(h, w):
    """The head alone with a small fc6 (49·C, 16): zero-pad to 7×7, crop to
    a multiple of 7, mean of each block — not adaptive_avg_pool2d."""
    C = 4
    rng = np.random.default_rng(h * w)
    p = {"fc6": {"w": rng.standard_normal((49 * C, 16)).astype(np.float32),
                 "b": rng.standard_normal(16).astype(np.float32)},
         "fc7": {"w": rng.standard_normal((16, 16)).astype(np.float32),
                 "b": rng.standard_normal(16).astype(np.float32)},
         "fc8": {"w": rng.standard_normal((16, 5)).astype(np.float32),
                 "b": rng.standard_normal(5).astype(np.float32)}}
    x = rng.standard_normal((2, h, w, C)).astype(np.float32)
    tp = {k: {n: torch.from_numpy(a) for n, a in v.items()} for k, v in p.items()}
    _close(tcnn._vgg_head(tp, torch.from_numpy(x)).numpy(),
           np.asarray(jcnn._vgg_head(p, x)), f"head {h}x{w}")


def test_init_shapes_scale_and_seed():
    g = torch.Generator().manual_seed(3)
    a = tcnn.lenet_init(g, device="cpu")
    b = tcnn.lenet_init(torch.Generator().manual_seed(3), device="cpu")
    assert a["conv1"]["w"].shape == (6, 3, 5, 5) and a["fc1"]["w"].shape == (78 * 145 * 16, 120)
    assert a["conv1"]["w"].is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(a["fc1"]["w"], b["fc1"]["w"])
    std = a["fc1"]["w"].std().item()
    assert abs(std - (78 * 145 * 16) ** -0.5) < 0.02 * (78 * 145 * 16) ** -0.5
    v = tcnn.vgg16_init(torch.Generator().manual_seed(0), device="cpu")
    assert v["conv0"]["w"].shape == (64, 3, 3, 3) and v["fc6"]["w"].shape == (7 * 7 * 512, 4096)
    assert len(tcnn.vgg16_layers(v)) == 18


# ---------------------------------------------------------------------------
# stage graphs and the engine against the reference engine
# ---------------------------------------------------------------------------

def _problem(pkg, profile, n_nodes=6, requests=2, seed=0):
    C = PKG[pkg][0]
    mob = C.RPGMobility(C.RPGParams(n_uavs=n_nodes, area_m=120.0, homogeneous=False),
                        seed=seed)
    rates = C.rate_matrix(mob.positions(1, seed=seed)[0], C.RadioParams())
    prof = C.lenet_profile() if profile == "lenet" else C.vgg16_profile()
    return C.Problem(prof, np.full(n_nodes, 4096 * MB), np.full(n_nodes, 1e18), rates,
                     np.zeros(requests, np.int64), compute_speed=np.full(n_nodes, 9.5e9))


def _manual_plan(pkg, prob, sizes_per_request):
    """Request r runs stage s's layers on node s (every cut crosses a link)."""
    C, _, Plan, _ = PKG[pkg]
    M, R = prob.n_layers, len(sizes_per_request)
    assign = np.zeros((R, M), np.int64)
    for r, sizes in enumerate(sizes_per_request):
        j = 0
        for node, size in enumerate(sizes):
            assign[r, j:j + size] = node
            j += size
    sol = C.Solution(assign, 0.0, "feasible", 0.0, np.ones(R, bool), solver="manual")
    return Plan(sol, "manual", "snapshot", prob)


def _graph_key(g):
    return ([(t.node, t.layer_start, t.layer_end, t.requests) for t in g.tasks],
            g.n_shared, g.requests,
            [(t.request, t.src_node, t.dst_node, t.layer, t.nbytes, t.delay_s)
             for t in g.transfers])


CUTS = [("lenet", [[3, 4], [1, 4, 2], [7]]), ("lenet", [[2, 2, 1, 2], [2, 2, 1, 2]]),
        ("vgg16", [[5, 13], [2, 9, 7]]), ("vgg16", [[1, 6, 4, 7], [1, 6, 4, 7]])]
# The VGG runs here use a 64-wide head: the engine, not the width, is under
# test (the full head is held by test_units_and_whole_model_match_reference).


@pytest.mark.parametrize("name,cuts", CUTS)
def test_compile_plan_equals_reference(name, cuts):
    graphs = {pkg: PKG[pkg][1].compile_plan(
        _manual_plan(pkg, _problem(pkg, name, requests=len(cuts)), cuts)) for pkg in PKG}
    assert _graph_key(graphs["port"]) == _graph_key(graphs["ref"])
    assert (TX.stage_signature(graphs["port"]) == JX.stage_signature(graphs["ref"]))
    assert TX.link_payload_bytes(graphs["port"]) == JX.link_payload_bytes(graphs["ref"])


@pytest.mark.parametrize("name,cuts", CUTS)
def test_engine_run_matches_reference_engine(name, cuts, weights):
    """Outputs of the port's engine equal the reference engine's on the same
    plan, weights and frames; the tracer sees the same spans; the modeled
    comm terms are equal exactly."""
    tree, tparams = weights["vgg16-narrow" if name == "vgg16" else name]
    frames = _frames(3, len(cuts), HW[name])
    reports, tracers = {}, {}
    for pkg in PKG:
        C, X, _, Tracer = PKG[pkg]
        graph = X.compile_plan(_manual_plan(pkg, _problem(pkg, name, requests=len(cuts)), cuts))
        tracers[pkg] = Tracer(1 << 12)
        if pkg == "ref":
            engine = X.ExecutionEngine(_layers(name, tree, jcnn), tracer=tracers[pkg])
        else:
            engine = X.ExecutionEngine(_layers(name, tparams, tcnn), tracer=tracers[pkg],
                                       device="cpu")
        reports[pkg] = engine.run(graph, frames)
        if pkg == "port":
            seq = engine.sequential_reference(frames, graph.requests)
    got, want = reports["port"], reports["ref"]
    assert sorted(got.outputs) == sorted(want.outputs)
    for r in want.outputs:
        _close(got.outputs[r], want.outputs[r], f"request {r}")
        _close(got.outputs[r], seq[r], f"request {r} vs sequential")
    np.testing.assert_array_equal(got.comm_s, want.comm_s)
    assert [(t.node, t.layer_start, t.layer_end, t.batch) for t in got.stage_timings] == \
        [(t.node, t.layer_start, t.layer_end, t.batch) for t in want.stage_timings]
    assert [(t.request, t.src_node, t.dst_node, t.layer, t.nbytes, t.delay_s)
            for t in got.transfers] == [(t.request, t.src_node, t.dst_node, t.layer,
                                         t.nbytes, t.delay_s) for t in want.transfers]
    assert all(t.wall_s > 0 for t in got.stage_timings)
    assert got.transport == want.transport == "inproc"
    spans = {pkg: collections.Counter(tr.events()["name"].tolist())
             for pkg, tr in tracers.items()}
    assert spans["port"] == spans["ref"]
    assert spans["port"]["stage"] == len(got.stage_timings)
    assert spans["port"]["ship"] == len(got.transfers)


def test_planner_plans_execute_equivalently(weights):
    """Every plan a registered planner emits executes as the sequential
    reference on the port's engine (tests/test_exec.py's matrix)."""
    tree, tparams = weights["lenet"]
    mob = T.RPGMobility(T.RPGParams(n_uavs=8, area_m=150.0, homogeneous=False), seed=0)
    rates = T.rate_matrix(mob.positions(1)[0], T.RadioParams())
    rng = np.random.default_rng(0)
    sources = rng.integers(0, 3, 5).astype(np.int64)
    prob = T.Problem(T.lenet_profile(), np.full(8, 128 * MB), np.full(8, 95e9), rates,
                     sources, compute_speed=np.full(8, 9.5e9))
    engine = TX.ExecutionEngine(TX.layer_fns_for(T.lenet_profile(), tparams, device="cpu"),
                                device="cpu")
    frames = _frames(4, 5, HW["lenet"])
    spread = 0
    for name in ("ould-dp", "ould-dp-sparse", "nearest", "hrm"):
        plan = T.get_planner(name, batch_solve=True, device="cpu").plan(
            prob, T.SnapshotView(rates))
        assert plan.n_admitted > 0, name
        graph = TX.compile_plan(plan)
        spread += len(graph.transfers)
        report = engine.run(graph, frames)
        seq = engine.sequential_reference(frames, graph.requests)
        for r in graph.requests:
            _close(report.outputs[r], seq[r], f"{name} request {r}")
    assert spread > 0


def test_calibration_equals_reference_on_the_same_timings():
    """calibrate is a copy: the same measured report gives the same
    calibrated profile, MAE and re-solve in both packages."""
    walls = [(0, 0, 3, 2, 0.004), (1, 3, 7, 2, 0.0021), (0, 0, 1, 1, 0.0013)]
    out = {}
    for pkg in PKG:
        C, X, _, _ = PKG[pkg]
        prob = _problem(pkg, "lenet", requests=2)
        plan = _manual_plan(pkg, prob, [[3, 4], [3, 4]])
        timings = tuple(X.StageTiming(*w) for w in walls)
        pred = np.asarray(plan.evaluate().per_request_s)
        rep = X.ExecutionReport({0: np.zeros(10), 1: np.zeros(10)}, timings, (),
                                np.array([0.01, 0.02]), np.array([0.01, 0.02]), np.zeros(2),
                                pred)
        cal, recon = X.calibrated_problem(prob, rep)
        replan = C.get_planner("ould-dp").plan(cal, C.SnapshotView(cal.rates))
        out[pkg] = (cal.profile.compute_vector(), recon.request_mae_s, recon.summary(),
                    replan.assign.tolist(), replan.objective)
    assert out["port"] == out["ref"]


def test_inproc_transport_hands_back_the_same_tensor():
    t = InProcTransport()
    x = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    res = t.ship(2, 5, x)
    assert res.array is x and res.nbytes == 48 and not res.moved
    assert t.link_stats[(2, 5)].n == 1 and t.link_stats[(2, 5)].nbytes == 48
    assert isinstance(TX.ExecutionEngine([], device="cpu").transport, InProcTransport)


def test_warm_start_and_measure_range_keep_warm_up_off_the_clock(weights):
    """warm_start runs each range of a signature once; a later run of those
    ranges at that shape warms nothing up, and measure_range times a range
    (min of repeats); each emits its span as the reference's does."""
    _, tparams = weights["lenet"]
    tracer = TTracer(1 << 10)
    engine = TX.ExecutionEngine(_layers("lenet", tparams, tcnn), tracer=tracer, device="cpu")
    graph = TX.compile_plan(_manual_plan("port", _problem("port", "lenet"), [[1, 4, 2]] * 2))
    frame = _frames(5, 1, HW["lenet"])[0]
    assert engine.warm_start(TX.stage_signature(graph), frame) > 0
    assert engine._warm == {(0, 1, (1, 326, 595, 3)), (1, 5, (1, 322, 591, 6)),
                            (5, 7, (1, 120))}
    wall = engine.measure_range(1, 5, np.zeros((1, 322, 591, 6), np.float32), repeats=3)
    assert wall > 0 and len(engine._warm) == 3
    names = tracer.events()["name"].tolist()
    assert names.count("warm_start") == 1 and names.count("stage_measure") == 1


def test_launcher_executes_placed_lenet_on_cpu(capsys):
    launch_serve.main(["--reduced", "--device", "cpu", "--batch", "4", "--prompt-len", "4",
                       "--steps", "2", "--execute", "--pool-nodes", "8"])
    out = capsys.readouterr().out
    assert "[exec] planner=ould-dp admitted=4/4" in out
    assert "after calibrated re-solve" in out
