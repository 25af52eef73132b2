"""The port's UAV surveillance scenario (``repro_torch.launch.uav_surveillance``)
against the reference's example (``examples/uav_surveillance.py``) on the CPU.

The reference's example runs in a subprocess while the port's scenario runs
here with ``--device cpu`` on the reference's LeNet weights (its init at key
0, converted), so the two take one wall.  Held equal: the sparse DP's plan
line, every request's class, OULD-MP's per-step latencies over the horizon,
the swarm policy table and the ``stale:10`` line (resolve walls excepted),
and the loopback run's exactness and re-solve provenance.  The OULD ILP's
plan is compared only where both runs printed the same ILP line: on this
instance HiGHS stops at the planner's 20 s time limit (status 1) and keeps
the incumbent it reached, so its plan depends on the machine's speed (a 3 s
limit gives another assignment than 20 s).
"""

import io
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

from repro.models import cnn as jcnn
from repro_torch.launch import uav_surveillance
from repro_torch.models import cnn_from_jax_params

ROOT = pathlib.Path(__file__).resolve().parents[1]
WALLS = re.compile(r" (measured|resolve_total)=[\d.]+ms")


def _by_kind(out: str) -> dict:
    lines = out.splitlines()
    return {
        "ilp": [s for s in lines if s.startswith("ould-ilp")],
        "sparse": [s for s in lines if s.startswith("ould-dp-sparse")],
        "classes": [s.split(" route=")[0] for s in lines if s.startswith("  request ")],
        "routes": [WALLS.sub("", s) for s in lines if s.startswith("  request ")],
        "horizon": [s for s in lines if s.startswith("ould-mp one-shot")],
        "swarm": [WALLS.sub("", s) for s in lines if s.startswith("swarm[")],
        "moved": [s.split(" exact=")[0].split(" moved=")[1]
                  for s in lines if s.startswith("transport[loopback]")],
        "exact": [s.split(" exact=")[1] for s in lines if s.startswith("transport[loopback]")],
        "resolve": [s for s in lines if "re-solve priced comm from" in s],
        "ok": [s for s in lines if s == "uav_surveillance OK"],
    }


def test_scenario_on_cpu_equals_reference_example():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    ref_proc = subprocess.Popen([sys.executable, str(ROOT / "examples/uav_surveillance.py")],
                                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True)
    try:
        tree = jcnn.lenet_init(jax.random.PRNGKey(0))
        params = cnn_from_jax_params("lenet", jax.tree.map(np.asarray, tree), device="cpu")
        buf = io.StringIO()
        with redirect_stdout(buf):
            uav_surveillance.main(["--device", "cpu"], params=params)
        ref_out, ref_err = ref_proc.communicate(timeout=600)
    finally:
        if ref_proc.poll() is None:
            ref_proc.kill()
            ref_proc.wait()
    assert ref_proc.returncode == 0, ref_err
    port, ref = _by_kind(buf.getvalue()), _by_kind(ref_out)
    for kind in ("sparse", "classes", "horizon", "swarm", "exact", "resolve", "ok"):
        assert port[kind] == ref[kind] and port[kind], kind
    assert len(port["swarm"]) == 4 and port["exact"] == ["True"]
    assert len(port["classes"]) == 8
    assert [s.split(": ")[1].split(",")[0:2] for s in port["ilp"]] == \
        [s.split(": ")[1].split(",")[0:2] for s in ref["ilp"]]     # status, admitted
    if port["ilp"] == ref["ilp"]:
        assert port["routes"] == ref["routes"] and port["moved"] == ref["moved"]
