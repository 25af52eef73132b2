"""The port's example entry points (``repro_torch.launch.quickstart``,
``train_100m`` and ``serve_pipeline``) against the reference's examples
(``examples/quickstart.py``, ``train_100m.py``, ``serve_pipeline.py``) on
the CPU.

Each reference example runs as it is in a subprocess, while the port's
entry point runs here with ``--device cpu`` from the reference's initial
parameters (``init_params`` at key 0, the examples' own, converted).  The
subprocess records, beside the example's printed lines, what its calls
returned: each ``train_loop.run``'s per-step losses (``run_with_restarts``
calls it once an attempt), ``schedule_requests``' evaluation and
``Server.generate``'s tokens.  Held: the per-step losses within 1e-3
relative (the worst gap measured: quickstart 4.3e-7, train_100m 4.7e-7),
the restarts, the resume's 0 steps and the parameter count; the
placement's admitted count, comm latency and routes, the generated tokens
and the straggler-aware nodes equal; and each printed line the
reference's, its losses' last digit excepted.
"""

import io
import json
import os
import pathlib
import re
import subprocess
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

import repro.configs as JC
from repro.models import init_params as jax_init_params
from repro_torch import configs as TC
from repro_torch.launch import quickstart, serve_pipeline, train_100m
from repro_torch.models import from_jax_params

ROOT = pathlib.Path(__file__).resolve().parents[1]
REL = 1e-3
NUM = re.compile(r"-?\d+\.\d+")

# Runs a reference example as it is, recording what its calls returned.
RECORDER = """
import json, runpy, sys
import numpy as np
import repro.runtime.serve as serve
from repro.runtime import train_loop

rec = {"losses": [], "evaluation": None, "tokens": None}
run = train_loop.run
def recorded_run(*a, **k):
    try:
        out = run(*a, **k)
    except RuntimeError:
        rec["losses"].append(None)     # an attempt cut by the injected failure
        raise
    rec["losses"].append([float(x) for x in out["losses"]])
    return out
train_loop.run = recorded_run
schedule = serve.schedule_requests
def recorded_schedule(*a, **k):
    sol, ev = schedule(*a, **k)
    rec["evaluation"] = {"admitted": int(ev.n_admitted),
                         "comm_latency_s": float(ev.comm_latency_s)}
    return sol, ev
serve.schedule_requests = recorded_schedule
generate = serve.Server.generate
def recorded_generate(self, *a, **k):
    out = generate(self, *a, **k)
    rec["tokens"] = np.asarray(out).tolist()
    return out
serve.Server.generate = recorded_generate
example, out_path = sys.argv[1:3]
sys.argv = [example]                   # the example parses its own argv
runpy.run_path(example, run_name="__main__")
json.dump(rec, open(out_path, "w"))
"""


def _start(example: str, tmp: pathlib.Path) -> tuple:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = tmp / f"{example}.json"
    proc = subprocess.Popen([sys.executable, "-c", RECORDER, str(ROOT / "examples" / example),
                             str(out)], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, out


def _finish(started: tuple) -> tuple[list[str], dict]:
    proc, out = started
    try:
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, stderr[-3000:]
    return stdout.splitlines(), json.loads(out.read_text())


def _port(main, argv: list[str], cfg_name: str, cfg_kw: dict) -> tuple[dict, list[str]]:
    jcfg = JC.get_config(cfg_name).reduced(**cfg_kw)
    tree = jax.tree.map(np.asarray, jax_init_params(jax.random.PRNGKey(0), jcfg))
    tcfg = TC.get_config(cfg_name).reduced(**cfg_kw)
    buf = io.StringIO()
    with redirect_stdout(buf):
        out = main(argv + ["--device", "cpu"], params=from_jax_params(tree, tcfg, device="cpu"))
    return out, buf.getvalue().splitlines()


def _same_lines(port: list[str], ref: list[str]) -> None:
    """The same lines, numbers with decimals within REL (a loss printed at
    three decimals may round the other way)."""
    assert [NUM.sub("#", s) for s in port] == [NUM.sub("#", s) for s in ref], (port, ref)
    for p, r in zip(port, ref):
        for a, b in zip(NUM.findall(p), NUM.findall(r)):
            assert abs(float(a) - float(b)) <= REL * abs(float(b)) + 1e-3, (p, r)


def _close(got: list[float], want: list[float]) -> float:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.size
    gap = float(np.max(np.abs(got - want) / np.abs(want)))
    print(f"worst relative loss gap {gap:.3e}")
    assert gap <= REL, gap
    return gap


def test_quickstart_matches_the_reference_example(tmp_path):
    """30 steps' losses within 1e-3 relative of the reference loop's, the
    loss falling, the resume taking 0 new steps, the lines the example's."""
    ref = _start("quickstart.py", tmp_path)
    out, lines = _port(quickstart.main, [], "internlm2_1p8b",
                       dict(n_layers=2, d_model=64, vocab=512))
    ref_lines, rec = _finish(ref)
    assert len(rec["losses"]) == 2 and rec["losses"][1] == []
    _close(out["losses"], rec["losses"][0])
    assert len(out["losses"]) == 30 and out["resumed_steps"] == 0
    assert out["losses"][-1] < out["losses"][0]
    _same_lines(lines, ref_lines)
    assert lines == out["lines"] and lines[-1] == "quickstart OK"


def test_train_100m_matches_the_reference_example(tmp_path):
    """The 60-step default: the attempt the injected failure cuts at step 24
    and the restart from scratch (no checkpoint yet), each step's loss of
    the finishing attempt within 1e-3 relative of the reference's, one
    restart, ``params=`` the reference's count, the lines the example's."""
    ref = _start("train_100m.py", tmp_path)
    out, lines = _port(train_100m.main, [], "internlm2_1p8b",
                       dict(n_layers=4, d_model=128, n_heads=4, vocab=2048))
    ref_lines, rec = _finish(ref)
    assert rec["losses"][0] is None and len(rec["losses"]) == 2
    _close(out["losses"], rec["losses"][1])
    assert out["restarts"] == 1 and out["fail_step"] == 24 and len(out["losses"]) == 60
    assert out["ckpt_walls"] and len(out["walls"]) == 60
    count = re.search(r"params=([\d.]+)M", ref_lines[0]).group(1)
    assert f"{out['n_params'] / 1e6:.1f}" == count
    jcfg = JC.get_config("internlm2_1p8b").reduced(n_layers=4, d_model=128, n_heads=4,
                                                   vocab=2048)
    want = sum(x.size for x in jax.tree.leaves(
        jax.eval_shape(lambda: jax_init_params(jax.random.PRNGKey(0), jcfg))))
    assert out["n_params"] == want
    _same_lines(lines, ref_lines)
    assert lines[-1] == "train_100m OK"


def test_serve_pipeline_matches_the_reference_example(tmp_path):
    """At the reference example's group sizes (16 GB, 1.97 PFLOP/s): the
    admitted count, comm latency and routes, the generated tokens (every
    sequence) and the straggler-aware nodes equal the reference's, and the
    lines are its lines."""
    ref = _start("serve_pipeline.py", tmp_path)
    out, lines = _port(serve_pipeline.main, ["--hbm-bytes", "16e9", "--flops-budget", "1.97e15"],
                       "internlm2_1p8b", dict(n_layers=2, d_model=64, vocab=512))
    ref_lines, rec = _finish(ref)
    assert out["admitted"] == rec["evaluation"]["admitted"] == 6
    assert out["comm_latency_s"] == rec["evaluation"]["comm_latency_s"]
    np.testing.assert_array_equal(out["tokens"], np.asarray(rec["tokens"]))
    assert lines == ref_lines and lines == out["lines"]
    routes = [s for s in ref_lines if s.startswith("  request ")]
    assert len(routes) == 3 and len(out["routes"]) == 3
    assert out["nodes"] and 5 not in out["nodes"]
    assert lines[-1] == "serve_pipeline OK"


def test_serve_pipeline_defaults_to_one_h100s_group():
    """The command's groups are one H100's by default: 80 GB, and the bf16
    dense peak the rest of the port's bounds use."""
    from repro_torch.kernels.cost import PEAK_BF16
    args = serve_pipeline.parser().parse_args([])
    assert (args.hbm_bytes, args.flops_budget, args.device) == (80e9, PEAK_BF16, "cuda")
    assert PEAK_BF16 == 989e12
