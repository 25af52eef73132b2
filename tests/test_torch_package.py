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
            "repro_torch.launch.uav_surveillance\n"
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


def test_non_cpu_tensors_never_fall_back():
    """A tensor off the CPU launches the kernel or raises; here (the meta
    device) it must raise rather than quietly run the plain version."""
    x = torch.empty(4, 64, device="meta")
    with pytest.raises(ValueError):
        rmsnorm(x, torch.empty(64, device="meta"))
    with pytest.raises(ValueError):
        flash_attention(*(torch.empty(1, 8, 2, 32, device="meta") for _ in range(3)))
    with pytest.raises(ValueError):
        decode_attention(torch.empty(1, 2, 32, device="meta"),
                         *(torch.empty(1, 8, 2, 32, device="meta") for _ in range(2)), 4)


def test_unported_scans_name_their_slice():
    """mLSTM is a later slice; the SSD scan is ported, and off the CPU (here
    the meta device) it raises rather than run the plain version."""
    with pytest.raises(NotImplementedError, match="mlstm"):
        ops.mlstm_scan()
    x, b = torch.empty(1, 8, 2, 16, device="meta"), torch.empty(1, 8, 2, 4, device="meta")
    n0 = ssd_scan.n_launches
    with pytest.raises(ValueError):
        ops.ssd_scan(x, torch.empty(1, 8, 2, device="meta"), b, b)
    assert ssd_scan.n_launches == n0


def test_unported_block_kinds_raise():
    """xLSTM's mlstm/slstm blocks are the next slice; MLA (minicpm3) and the
    MoE FFN (granite) are ported and now initialise."""
    with pytest.raises(NotImplementedError, match="mlstm"):
        init_params(0, TC.get_config("xlstm_1p3b").reduced(n_layers=8), device="cpu")
    for arch in ("minicpm3_4b", "granite_moe_3b"):
        init_params(0, TC.get_config(arch).reduced(n_layers=2), device="cpu")


MIXED = dict(param_dtype="float32", compute_dtype="bfloat16")


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
            "decode_attention": "decode_attention", "ssm_scan": "ssd_scan",
            "dp_sweep": "dp_sweep"}
    assert set(found) == set(want)
    for stem, names in found.items():
        for name in names:
            assert _group(name) == want[stem], (stem, name)
