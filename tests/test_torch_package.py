"""Package and device rules of the PyTorch port (``src/repro_torch``).

The port imports neither jax nor the reference package, keeps its own copies
of the reference's configs, runs on the card unless asked for the CPU, sends
a CPU tensor down the plain path, refuses the dtype mix the reference cannot
serve, and reaches every kernel dispatch point the card path reaches.
"""

import ast
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

import repro.configs as JC
from repro.launch.dryrun import production_cfg as jax_production_cfg
from repro.models import init_params as jax_init_params
from repro.runtime.serve import ServeConfig as JaxServeConfig
from repro.runtime.serve import Server as JaxServer
from repro_torch import configs as TC
from repro_torch import core as placement
from repro_torch import resolve_device
from repro_torch.core import batch_dp
from repro_torch.exec import ExecutionEngine, layer_fns_for
from repro_torch.kernels import ops, ref
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.kernels.ssm_scan import ssd_scan
from repro_torch.launch import serve as launch_serve
from repro_torch.models import from_jax_params, init_cache, init_params, prefill
from repro_torch.runtime.serve import ServeConfig, Server

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def small_cfg(**kw):
    return TC.get_config("internlm2_1p8b").reduced(n_layers=2, d_model=64, vocab=512, **kw)


def test_import_leaves_jax_and_reference_out():
    code = ("import sys, repro_torch, repro_torch.kernels.ops, repro_torch.models, "
            "repro_torch.runtime, repro_torch.launch.serve, repro_torch.core, "
            "repro_torch.exec, repro_torch.models.cnn, repro_torch.obs, "
            "repro_torch.transport, repro_torch.core.events, repro_torch.core.ould_mp, "
            "repro_torch.runtime.queueing, repro_torch.runtime.swarm, "
            "repro_torch.transport.loopback, repro_torch.transport.multiproc, "
            "repro_torch.transport.__main__, repro_torch.exec.compile_cache, "
            "repro_torch.launch.uav_surveillance, repro_torch.models.xlstm, "
            "repro_torch.optim, repro_torch.optim.compression, repro_torch.data, "
            "repro_torch.checkpointing, repro_torch.runtime.steps, "
            "repro_torch.runtime.train_loop, repro_torch.runtime.elastic, "
            "repro_torch.launch.train, repro_torch.parallel, repro_torch.parallel.collectives, "
            "repro_torch.launch.mesh, repro_torch.launch.dryrun, repro_torch.kernels.cost\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in ("jax", "jaxlib", "repro"), (path, node.lineno, n)


@pytest.mark.parametrize("arch", JC.list_archs())
def test_config_copies_match_reference(arch):
    j, t = JC.get_config(arch), TC.get_config(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(t.reduced()) == dataclasses.asdict(j.reduced())
    assert (dataclasses.asdict(TC.production_cfg(t))
            == dataclasses.asdict(jax_production_cfg(j)))
    assert t.vocab_padded == j.vocab_padded and t.hd == j.hd


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the card-less behaviour")
    cfg = small_cfg()
    with pytest.raises(RuntimeError, match="cuda"):
        init_params(0, cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        init_cache(cfg, 2, 8)
    with pytest.raises(RuntimeError, match="cuda"):
        Server(cfg, init_params(0, cfg, device="cpu"), ServeConfig())
    with pytest.raises(RuntimeError, match="cuda"):
        launch_serve.main(["--reduced", "--steps", "2", "--prompt-len", "4"])
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")
    # the placement path: the engine, its layer functions, the batched sweep
    # and a batch_solve planner
    lenet = placement.lenet_profile()
    with pytest.raises(RuntimeError, match="cuda"):
        ExecutionEngine([])
    with pytest.raises(RuntimeError, match="cuda"):
        layer_fns_for(lenet)
    prob = placement.Problem(lenet, np.full(8, 512e6), np.full(8, 95e9),
                             np.full((8, 8), 1e8), np.zeros(3, np.int64))
    with pytest.raises(RuntimeError, match="cuda"):
        placement.get_planner("ould-dp-sparse", batch_solve=True).plan(
            prob, placement.SnapshotView(prob.rates))
    with pytest.raises(RuntimeError, match="cuda"):
        batch_dp.solve_batch(np.zeros((8, 8)), 1.0, None, np.zeros(1, np.int64),
                             np.zeros((1, 7, 4), np.int64), np.ones((1, 7, 4), bool),
                             (np.ones(7),))
    # the byte-moving transports' card workers, their CLI and the scenario
    from repro_torch.launch import uav_surveillance
    from repro_torch.transport import MultiProcTransport, make_transport
    from repro_torch.transport.__main__ import main as transport_cli
    for tp in (MultiProcTransport(n_workers=1), make_transport("multiproc", n_workers=1)):
        with pytest.raises(RuntimeError, match="cuda"):
            tp.start()
    with pytest.raises(RuntimeError, match="cuda"):
        transport_cli(["--multiproc", "--workers", "1"])
    with pytest.raises(RuntimeError, match="cuda"):
        uav_surveillance.main([])
    # ... and each runs when given the CPU by name
    ExecutionEngine([], device="cpu")
    assert len(layer_fns_for(lenet, device="cpu")) == 7
    placement.get_planner("ould-dp-sparse", batch_solve=True, device="cpu").plan(
        prob, placement.SnapshotView(prob.rates))
    batch_dp.solve_batch(np.zeros((8, 8)), 1.0, None, np.zeros(1, np.int64),
                         np.zeros((1, 7, 4), np.int64), np.ones((1, 7, 4), bool),
                         (np.ones(7),), device="cpu")


def test_ab_flash_needs_the_card(tmp_path):
    """``launch/ab_flash.py`` times two builds of the flash kernel on the
    card; without one it raises before it copies or builds anything."""
    if torch.cuda.is_available():
        pytest.skip("checks the card-less behaviour")
    from repro_torch.launch import ab_flash
    other = tmp_path / "flash_attention.cu"
    other.write_text("")
    with pytest.raises(RuntimeError, match="cuda"):
        ab_flash.main(["--other", str(other)])


def test_ab_train_needs_the_card(tmp_path):
    """``launch/ab_train.py`` times two checkouts' train steps on the card;
    without one it raises before it starts a child."""
    if torch.cuda.is_available():
        pytest.skip("checks the card-less behaviour")
    from repro_torch.launch import ab_train
    with pytest.raises(RuntimeError, match="cuda"):
        ab_train.main(["--other", str(tmp_path)])


def test_launcher_runs_on_cpu_when_asked():
    out = launch_serve.main(["--reduced", "--device", "cpu", "--batch", "2",
                             "--prompt-len", "4", "--steps", "3"])
    assert out.shape == (2, 3) and out.dtype == np.int32


def test_cpu_tensors_take_the_plain_path():
    g = torch.Generator().manual_seed(0)
    x, s = torch.randn(3, 5, 64, generator=g), torch.randn(64, generator=g)
    q, k, v = (torch.randn(2, 16, h, 32, generator=g) for h in (4, 2, 2))
    qd, kc, vc = torch.randn(2, 4, 32, generator=g), torch.randn(2, 20, 2, 32, generator=g), \
        torch.randn(2, 20, 2, 32, generator=g)
    counts = (rmsnorm.n_launches, flash_attention.n_launches, decode_attention.n_launches)
    for plain in (False, True):
        assert torch.equal(ops.rmsnorm(x, s, 1e-5, plain=plain), ref.rmsnorm(x, s, 1e-5))
        assert torch.equal(ops.attention(q, k, v, window=8, plain=plain),
                           ref.attention(q, k, v, window=8))
        assert torch.equal(ops.decode_attention(qd, kc, vc, 11, plain=plain),
                           ref.decode_attention(qd, kc, vc, 11))
    assert (rmsnorm.n_launches, flash_attention.n_launches,
            decode_attention.n_launches) == counts


@pytest.fixture
def no_plain_version(monkeypatch):
    """Each wrapper's plain version replaced by one that fails; the launch
    counts checked unchanged after the test."""
    from repro_torch.kernels import decode_attention as da, flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn, ssm_scan as ss

    def refuse(*a, **k):
        raise AssertionError("the plain version ran")
    for mod in (fa, da, rn, ss):
        monkeypatch.setattr(mod, "plain", refuse)
    counts = [f.n_launches for f in (rmsnorm, flash_attention, decode_attention, ssd_scan)]
    yield
    assert [f.n_launches for f in (rmsnorm, flash_attention, decode_attention,
                                   ssd_scan)] == counts


def test_non_cpu_tensors_never_fall_back(no_plain_version):
    """A tensor off the CPU never runs the plain version: on the card it
    launches the kernel or raises; on the meta device (the dry-run's trace)
    it gets the kernel's abstract output, with no launch and no plain call;
    devices that do not match raise."""
    y = rmsnorm(torch.empty(4, 64, device="meta"), torch.empty(64, device="meta"))
    assert y.device.type == "meta" and y.shape == (4, 64) and y.dtype == torch.float32
    o = flash_attention(*(torch.empty(1, 8, 2, 32, device="meta") for _ in range(3)))
    assert o.device.type == "meta" and o.shape == (1, 8, 2, 32)
    d = decode_attention(torch.empty(1, 2, 32, device="meta"),
                         *(torch.empty(1, 8, 2, 32, device="meta") for _ in range(2)), 4)
    assert d.device.type == "meta" and d.shape == (1, 2, 32)
    with pytest.raises(ValueError):
        rmsnorm(torch.empty(4, 64, device="meta"), torch.empty(64))
    with pytest.raises(ValueError):
        flash_attention(torch.empty(1, 8, 2, 32, device="meta"),
                        *(torch.empty(1, 8, 2, 32) for _ in range(2)))


def test_unported_scans_name_their_slice(no_plain_version):
    """Both scans are ported: mLSTM runs its chunked plain form on every
    device (no kernel, as in the reference), so it returns here; the SSD
    scan on the meta device gets its kernel's abstract outputs (y in x's
    dtype, the f32 state) with no launch and no plain call."""
    q = torch.randn(1, 8, 2, 16)
    y, (C, n, m) = ops.mlstm_scan(q, q, q, torch.zeros(1, 8, 2), torch.ones(1, 8, 2), chunk=4)
    assert y.shape == q.shape and C.shape == (1, 2, 16, 16) and m.shape == (1, 2)
    x = torch.empty(1, 8, 2, 16, device="meta", dtype=torch.bfloat16)
    b = torch.empty(1, 8, 2, 4, device="meta")
    y, h = ops.ssd_scan(x, torch.empty(1, 8, 2, device="meta"), b, b)
    assert (y.device.type, y.shape, y.dtype) == ("meta", (1, 8, 2, 16), torch.bfloat16)
    assert (h.shape, h.dtype) == ((1, 2, 16, 4), torch.float32)


def test_unported_block_kinds_raise():
    """Every block kind of the reference is ported: xLSTM's mlstm/slstm, MLA
    (minicpm3) and the MoE FFN (granite) initialise; a kind the reference
    does not have raises."""
    for arch, layers in (("xlstm_1p3b", 8), ("minicpm3_4b", 2), ("granite_moe_3b", 2)):
        init_params(0, TC.get_config(arch).reduced(n_layers=layers), device="cpu")
    bad = dataclasses.replace(small_cfg(), block_pattern=("rnn",))
    with pytest.raises(ValueError, match="rnn"):
        init_params(0, bad, device="cpu")


MIXED = dict(param_dtype="float32", compute_dtype="bfloat16")


def test_training_entry_points_default_to_the_card(tmp_path):
    """The data loader, the loop and the train launcher run on the card
    unless asked for the CPU, and raise where there is none."""
    if torch.cuda.is_available():
        pytest.skip("checks the card-less behaviour")
    from repro_torch.data import DataConfig, DataLoader
    from repro_torch.launch import train as launch_train
    from repro_torch.runtime import TrainConfig, train_loop
    dcfg = DataConfig(vocab=64, seq_len=8, global_batch=2)
    with pytest.raises(RuntimeError, match="cuda"):
        DataLoader(dcfg)
    with pytest.raises(RuntimeError, match="cuda"):
        train_loop.run(small_cfg(), TrainConfig(), train_loop.LoopConfig(
            total_steps=1, ckpt_dir=str(tmp_path)), dcfg)
    with pytest.raises(RuntimeError, match="cuda"):
        launch_train.main(["--steps", "1", "--ckpt-dir", str(tmp_path)])
    assert not list(tmp_path.iterdir())  # nothing written before the refusal


def test_kernels_refuse_gradients_they_cannot_carry():
    """A kernel without a backward kernel raises NotImplementedError, naming
    itself and what brings its backward, where autograd would record it (an
    input requiring grad, grad mode on): never an output without a
    gradient.  The check itself on CPU tensors; the wrappers call it on
    their card path, before any launch (``tests/test_torch_gpu.py``).  Flash
    attention and the SSD scan have their backward kernels: their wrappers
    run their autograd Functions there instead."""
    from repro_torch.kernels import build
    x = torch.ones(2, requires_grad=True)
    why = "it serves decode steps only, and no slice of the port plans a backward for it"
    with pytest.raises(NotImplementedError, match="decode_attention.*serves decode steps only"):
        build.refuse_grad("decode_attention", why, None, x)
    with torch.no_grad():
        build.refuse_grad("decode_attention", why, x)
    with torch.inference_mode():
        build.refuse_grad("decode_attention", why, torch.ones(2))
    build.refuse_grad("decode_attention", why, x.detach(), None)
    assert not hasattr(build, "NO_BACKWARD")
    import inspect
    from repro_torch.kernels import dp_sweep
    for fn in (decode_attention, dp_sweep.dp_sweep):
        src = inspect.getsource(fn)
        assert "build.refuse_grad(" in src and src.index("build.refuse_grad(") < src.index(
            "build.function("), fn.__name__
    for fn, function in ((flash_attention, "_FlashAttentionFunction.apply("),
                         (ssd_scan, "_SsdScanFunction.apply(")):
        src = inspect.getsource(fn)
        assert "build.refuse_grad(" not in src and function in src, fn.__name__


def test_xlstm_dispatch_counts_match_the_card_path(monkeypatch):
    """xlstm-1.3B's serving at its full depth (42 mLSTM, 6 sLSTM layers):
    per prefill and per decode step, norm1 in every layer, the inner norm
    of every cell and the final norm, 97 in all: chip_smoke.py's exact
    count; no attention kernel is reached."""
    calls = {"rmsnorm": 0, "attention": 0, "decode_attention": 0}
    for name in calls:
        real = getattr(ops, name)

        def counted(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(ops, name, counted)
    cfg = TC.get_config("xlstm_1p3b").reduced(n_layers=48, d_model=32, vocab=256)
    assert cfg.pattern_for_layers().count("slstm") == 6
    srv = Server(cfg, init_params(0, cfg, device="cpu"), ServeConfig(max_len=16), device="cpu")
    steps = 3
    srv.generate(np.zeros((2, 4), np.int32), steps)
    assert calls == {"rmsnorm": (48 + 42 + 6 + 1) * (1 + steps), "attention": 0,
                     "decode_attention": 0}


def test_mixed_dtype_config_raises_in_port():
    cfg = dataclasses.replace(small_cfg(), **MIXED)
    with pytest.raises(ValueError, match="param_dtype"):
        init_params(0, cfg, device="cpu")
    params = init_params(0, small_cfg(), device="cpu")
    with pytest.raises(ValueError, match="param_dtype"):
        Server(cfg, params, ServeConfig(), device="cpu")
    with pytest.raises(ValueError, match="param_dtype"):
        prefill(params, cfg, {"tokens": torch.zeros(1, 4, dtype=torch.long)})


def test_mixed_dtype_config_fails_in_reference():
    """Why the port refuses the mix: the reference's own serve path cannot
    run it (bf16 activations meet f32 weights and its decode scan carry
    changes dtype)."""
    cfg = dataclasses.replace(JC.get_config("internlm2_1p8b").reduced(
        n_layers=2, d_model=64, vocab=512), **MIXED)
    srv = JaxServer(cfg, jax_init_params(jax.random.PRNGKey(0), cfg),
                    JaxServeConfig(max_len=16, batch_size=2))
    with pytest.raises(TypeError, match="carry"):
        srv.generate(np.zeros((2, 4), np.int32), 2)


def test_from_jax_params_unstacks_layers_in_order():
    jcfg = JC.get_config("internlm2_1p8b").reduced(n_layers=2, d_model=64, vocab=512)
    tree = jax.tree.map(np.asarray, jax_init_params(jax.random.PRNGKey(0), jcfg))
    assert not tree["embed"]["table"].flags.writeable
    tp = from_jax_params(tree, small_cfg(), device="cpu")
    assert len(tp["blocks"]) == 2
    for layer in range(2):
        for key in ("wqkv", "wo"):
            np.testing.assert_array_equal(tp["blocks"][layer]["attn"][key].numpy(),
                                          tree["blocks"][0]["attn"][key][layer])
    assert tp["lm_head"].shape == (64, 512) and tp["embed"]["table"].shape == (512, 64)


def test_init_params_shapes_and_seed():
    cfg = TC.production_cfg(TC.get_config("internlm2_1p8b")).reduced(n_layers=2)
    cfg = dataclasses.replace(cfg, vocab=1000, param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    a, b = init_params(7, cfg, device="cpu"), init_params(7, cfg, device="cpu")
    assert a["embed"]["table"].shape == (cfg.vocab_padded, cfg.d_model) == (1024, 64)
    assert a["lm_head"].shape == (cfg.d_model, cfg.vocab_padded)
    assert a["blocks"][1]["mlp"]["w_out"].dtype == torch.bfloat16
    assert torch.equal(a["blocks"][1]["attn"]["wqkv"], b["blocks"][1]["attn"]["wqkv"])
    std = a["blocks"][0]["mlp"]["w_out"].float().std().item()
    assert abs(std - cfg.d_ff ** -0.5) < 0.1 * cfg.d_ff ** -0.5
    # pad columns of the head never reach the caller
    logits, _ = prefill(a, cfg, {"tokens": torch.zeros(1, 3, dtype=torch.long)})
    assert logits.shape == (1, cfg.vocab) and torch.isfinite(logits).all()


@pytest.mark.parametrize("arch,layers,norms", [
    ("internlm2_1p8b", 24, 2), ("minicpm3_4b", 62, 4), ("granite_moe_3b", 32, 2)])
def test_dispatch_counts_match_the_card_path(monkeypatch, arch, layers, norms):
    """Every dispatch point the card path reaches is reached on the CPU too,
    at the served depth: per prefill and per decode step ``norms`` norms a
    layer (norm1 and norm2; MLA adds norm_q and norm_kv) and the final norm,
    one attention call a layer per prefill and one decode-attention call a
    layer per step: chip_smoke.py's exact launch counts."""
    calls = {"rmsnorm": 0, "attention": 0, "decode_attention": 0}
    for name in calls:
        real = getattr(ops, name)

        def counted(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(ops, name, counted)
    cfg = TC.get_config(arch).reduced(n_layers=layers, d_model=32, vocab=256)
    srv = Server(cfg, init_params(0, cfg, device="cpu"), ServeConfig(max_len=16),
                 device="cpu")
    steps = 3
    srv.generate(np.zeros((2, 4), np.int32), steps)
    assert calls == {"rmsnorm": (norms * layers + 1) * (1 + steps), "attention": layers,
                     "decode_attention": layers * steps}


def test_profile_groups_name_every_kernel():
    """``launch/profile_serve.py`` sorts device time into groups by kernel
    name: every ``__global__`` function in ``csrc/`` must fall in its own
    kernel's group, or its time would land in "other"."""
    import re

    from repro_torch.kernels import build
    from repro_torch.launch.profile_serve import _group

    decl = re.compile(r"__global__\s+void\s+"
                      r"(?:__launch_bounds__\((?:[^()]|\([^()]*\))*\)\s+)?(\w+)")
    found = {}
    for src in sorted(build.CSRC.glob("*.cu")):
        names = decl.findall(src.read_text())
        assert names, src.name
        found[src.stem] = names
    want = {"rmsnorm": "rmsnorm", "flash_attention": "flash_attention",
            "flash_attention_bwd": "flash_attention_bwd",
            "decode_attention": "decode_attention", "ssm_scan": "ssd_scan",
            "ssm_scan_bwd": "ssd_scan_bwd", "ssm_scan_bwd_tc": "ssd_scan_bwd",
            "dp_sweep": "dp_sweep"}
    backward = {"rmsnorm_bwd_kernel", "rmsnorm_dscale_kernel"}  # rmsnorm.cu's backward pair
    assert set(found) == set(want) and backward <= set(found["rmsnorm"])
    for stem, names in found.items():
        for name in names:
            assert _group(name) == ("rmsnorm_bwd" if name in backward else want[stem]), \
                (stem, name)
