"""The port's GPipe executor (``repro_torch.parallel.pipeline``) against the
sequential layer loop and the reference's ``shard_map`` pipeline, on the CPU.

The reference test's matrix (``tests/test_pipeline.py``: uniform cuts at
n_micro 4 and 8; OULD-style cuts [1,3,2,2]/2, [4,2,1,1]/4, [1,1,1,5]/8,
[1,5,1,1]/1; three bad cuts) runs in a 4-rank gloo world, three cuts in a
2-rank world (``tests/torch_ranks.py``), and the reference's pipeline on the
same seeded numpy w and x in a JAX subprocess on 4 forced host devices.
Then a reduced internlm2 block stack of 8 layers, cut [1,3,2,2], against the
port's and the reference's unpipelined stacks.  Tolerances: 1e-5 (the
reference test's) for tanh layers, f32 1e-4 for the transformer stack.
"""

import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as JC
from repro.models import init_params as jax_init_params
from repro.models import transformer as JT
from repro_torch import configs as TC
from repro_torch.models import from_jax_params, transformer
from repro_torch.parallel import pipeline

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import torch_ranks

ROOT = pathlib.Path(__file__).resolve().parents[1]
L, B, D = 8, 8, 16
STACK = dict(n_layers=8, d_model=64)

JAX_SCRIPT = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.parallel.pipeline import pipeline_forward, pipeline_forward_stages

inp = dict(np.load(sys.argv[1]))
w, x = jnp.asarray(inp["w"]), jnp.asarray(inp["x"])
def block_fn(w_l, x):
    return jnp.tanh(x @ w_l)
out = {}
for cases, n in ((PIPE4, 4), (PIPE2, 2)):
    mesh = Mesh(np.array(jax.devices()[:n]), ("stage",))
    for name, (cuts, n_micro) in cases.items():
        if cuts is None:
            fn = lambda w, x, m=n_micro: pipeline_forward(block_fn, w, x, mesh=mesh, n_micro=m)
        else:
            fn = lambda w, x, s=tuple(cuts), m=n_micro: pipeline_forward_stages(
                block_fn, w, x, mesh=mesh, stage_sizes=s, n_micro=m)
        out[name] = np.asarray(jax.jit(fn)(w, x))
np.savez(sys.argv[2], **out)
"""


def _flat_np(tree, path):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat_np(v, f"{path}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat_np(v, f"{path}/{i}").items()}
    return {path: np.asarray(tree)}


def _sequential(w, x):
    for w_l in w:
        x = torch.tanh(x @ w_l)
    return x


@pytest.fixture(scope="module")
def lm():
    """Reduced internlm2 (8 layers): the reference's parameters (numpy), the
    port's conversion, an input of embeddings, and the reference's
    unpipelined block stack on it."""
    cfg = JC.get_config("internlm2_1p8b").reduced(**STACK)
    tree = jax.tree.map(np.asarray, jax_init_params(jax.random.PRNGKey(0), cfg))
    x = np.random.default_rng(2).standard_normal((4, 16, cfg.d_model)).astype(np.float32)
    h, positions = jax.numpy.asarray(x), jax.numpy.arange(x.shape[1])
    for l in range(cfg.n_layers):
        p = jax.tree.map(lambda a: a[l], tree["blocks"][0])
        h = JT._block_apply(p, cfg, "attn", h, positions)[0]
    tcfg = TC.get_config("internlm2_1p8b").reduced(**STACK)
    return tree, from_jax_params(tree, tcfg, device="cpu"), tcfg, x, np.asarray(h)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, lm):
    tmp = tmp_path_factory.mktemp("pipeline")
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((L, D, D)) * D ** -0.5).astype(np.float32)
    x = rng.standard_normal((B, D)).astype(np.float32)
    inputs = tmp / "inputs.npz"
    np.savez(inputs, w=w, x=x, **{"stack/x": lm[3]}, **_flat_np(lm[0], "lm"))
    script = f"PIPE4 = {torch_ranks.PIPE4!r}\nPIPE2 = {torch_ranks.PIPE2!r}\n" + JAX_SCRIPT
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    ref = subprocess.Popen([sys.executable, "-c", script, str(inputs), str(tmp / "ref.npz")],
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    four = torch_ranks.collect(torch_ranks.spawn("pipeline4", 4, inputs, tmp), tmp, "pipeline4")
    two = torch_ranks.collect(torch_ranks.spawn("pipeline2", 2, inputs, tmp), tmp, "pipeline2")
    _, err = ref.communicate(timeout=300)
    assert ref.returncode == 0, err[-3000:]
    with np.load(tmp / "ref.npz") as f:
        refs = dict(f)
    return {"w": w, "x": x, "ref": refs, 4: four, 2: two}


CASES = [(4, name) for name in torch_ranks.PIPE4] + [(2, name) for name in torch_ranks.PIPE2]


@pytest.mark.parametrize("stages,name", CASES, ids=[f"{s}-stages-{n}" for s, n in CASES])
def test_pipeline_matches_sequential_and_the_reference(stages, name, worlds):
    """Every rank returns the block stack's output, within 1e-5 of the
    sequential loop and of the reference's pipeline on the same w and x."""
    want = _sequential(torch.from_numpy(worlds["w"]), torch.from_numpy(worlds["x"])).numpy()
    for out in worlds[stages]:
        got = out[f"pipe/{name}"]
        assert got.shape == want.shape
        assert np.abs(got - want).max() < 1e-5
        assert np.abs(got - worlds["ref"][name]).max() < 1e-5


@pytest.mark.parametrize("cut", list(torch_ranks.BAD_CUTS))
def test_bad_cuts_raise(cut, worlds):
    for out in worlds[4]:
        assert out[f"bad/{cut}"], torch_ranks.BAD_CUTS[cut]


def test_transformer_block_stack_pipelined_over_ould_cuts(worlds, lm):
    """Reduced internlm2, 8 layers cut [1, 3, 2, 2] at n_micro 2, on every
    rank within f32 1e-4 of the port's and the reference's unpipelined
    stacks."""
    _, params, cfg, x, want_ref = lm
    h = torch.from_numpy(x)
    fn = transformer.block_fn(cfg)
    for p in params["blocks"]:
        h = fn(p, h)
    want = h.numpy()
    assert np.abs(want - want_ref).max() < 1e-4
    for out in worlds[4]:
        got = out["stack/pipelined"]
        assert np.abs(got - want).max() < 1e-4
        assert np.abs(got - want_ref).max() < 1e-4


@pytest.mark.parametrize("n_micro", [1, 2, 4, 8])
def test_one_stage_runs_its_microbatches_without_a_group(n_micro):
    """A one-stage axis (the card's world of one) needs no process group: the
    stage runs every microbatch through all layers and sends nothing."""
    rng = np.random.default_rng(1)
    w = torch.from_numpy((rng.standard_normal((L, D, D)) * D ** -0.5).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((B, D)).astype(np.float32))
    got = pipeline.pipeline_forward_stages(lambda w_l, h: torch.tanh(h @ w_l), list(w), x,
                                           mesh={"stage": 1}, stage_sizes=[L], n_micro=n_micro)
    assert np.abs(got.numpy() - _sequential(w, x).numpy()).max() < 1e-6


def test_uneven_splits_raise():
    w = [torch.eye(D)] * L
    with pytest.raises(ValueError, match="do not split evenly"):
        pipeline.pipeline_forward(lambda w_l, h: h, w[:7], torch.zeros(B, D), mesh={"stage": 2})
    with pytest.raises(ValueError, match="microbatches"):
        pipeline.pipeline_forward_stages(lambda w_l, h: h, w, torch.zeros(B, D),
                                         mesh={"stage": 1}, stage_sizes=[L], n_micro=3)
