"""The port's parallel layer (``repro_torch.parallel.sharding``,
``launch/mesh.py``, the MoE's expert-parallel path, the engine's batch
sharding, checkpoint re-sharding) against the reference on the CPU.

The rules run in this process on plain ``{axis: size}`` meshes for every
published config; the layouts run in gloo worlds of 4 ranks (a 2 x 2
(data, model) mesh) and 2 ranks (``tests/torch_ranks.py``), beside a JAX
subprocess on 4 forced host devices that gives the reference's values for
the same seeded numpy inputs.  Tolerances are the reference test's: the
expert path within 2e-5 of the dense einsum and of the reference's shard
map, aux within 5e-2; placements, engine outputs and restored checkpoints
bit for bit.
"""

import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, distribute_tensor

import repro.configs as JC
from repro.launch.dryrun import production_cfg as jax_production_cfg
from repro.models import init_params as jax_init_params
from repro.models import transformer as JT
from repro.parallel import sharding as JS
from repro_torch import configs as TC
from repro_torch.checkpointing import CheckpointManager
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.dp_sweep import dp_sweep
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_bwd
from repro_torch.kernels.ssm_scan import ssd_scan
from repro_torch.launch import mesh as tmesh
from repro_torch.models import init_params, moe, param_shapes
from repro_torch.parallel import sharding as TS

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import torch_ranks

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESHES = {"16x16": ({"data": 16, "model": 16}, ("data",)),
          "2x16x16": ({"pod": 2, "data": 16, "model": 16}, ("pod", "data")),
          "4x2": ({"data": 4, "model": 2}, ("data",)),
          "2x2": ({"data": 2, "model": 2}, ("data",)),
          "1x1": ({"data": 1, "model": 1}, ("data",))}


class ShapeMesh:
    """What the reference's rules read of a mesh: ``shape[name]``."""

    def __init__(self, shape):
        self.shape = shape


@pytest.fixture(scope="module")
def published():
    """Per arch: (the reference's stacked param shapes, the port's
    per-layer meta tree), at published widths."""
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = (JT.param_shapes(jax_production_cfg(JC.get_config(arch))),
                           param_shapes(TC.production_cfg(TC.get_config(arch))))
        return cache[arch]
    return get


def _walk(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, f"{path}/{k}" if path else k)
    else:
        yield path, tree


@pytest.mark.parametrize("arch", TC.ARCH_IDS)
def test_param_shapes_are_the_references_per_layer_and_allocate_nothing(arch, published):
    jps, tps = published(arch)
    cfg = TC.production_cfg(TC.get_config(arch))
    period = len(cfg.block_pattern)
    assert len(tps["blocks"]) == cfg.n_layers
    for k in jps:
        if k != "blocks":
            for (pj, a), (pt, b) in zip(_walk(jps[k]), _walk(tps[k])):
                assert pj == pt and tuple(a.shape) == tuple(b.shape), (pj, pt)
                assert str(a.dtype) == str(b.dtype).removeprefix("torch."), pj
    for l, layer in enumerate(tps["blocks"]):
        stacked = dict(_walk(jps["blocks"][l % period]))
        mine = dict(_walk(layer))
        assert set(stacked) == set(mine), l
        for path, t in mine.items():
            assert t.device.type == "meta", path
            assert tuple(t.shape) == tuple(stacked[path].shape)[1:], (l, path)
            assert str(t.dtype).removeprefix("torch.") == str(stacked[path].dtype), (l, path)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", TC.ARCH_IDS)
def test_param_pspecs_equal_the_references_without_the_stack_axis(arch, mesh_name, published):
    """Every leaf at published width, fsdp on and off: a layer's spec is the
    reference's spec of the stacked leaf less its leading None."""
    jps, tps = published(arch)
    sizes, dp = MESHES[mesh_name]
    period = len(TC.get_config(arch).block_pattern)
    for fsdp in (True, False):
        js = JS.param_pspecs(jps, ShapeMesh(sizes), JS.MeshAxes(data=dp), fsdp=fsdp)
        ts = TS.param_pspecs(tps, sizes, TS.MeshAxes(data=dp), fsdp=fsdp)
        for k in js:
            if k != "blocks":
                for (pj, a), (_, b) in zip(_walk(js[k]), _walk(ts[k])):
                    assert tuple(a) == tuple(b), (fsdp, pj, a, b)
        for l, layer in enumerate(ts["blocks"]):
            stacked = dict(_walk(js["blocks"][l % period]))
            for path, spec in _walk(layer):
                want = tuple(stacked[path])
                assert want[0] is None and want[1:] == tuple(spec), (fsdp, l, path, want, spec)


def test_param_pspecs_default_rule_reads_the_stacked_shape():
    """Leaves no rule names take the reference's default rule (``model`` on
    the largest dim), which reads the stacked shape: a layer's (8,) vector
    shards as the stacked (G, 8) does, where its own shape would give an
    empty spec.  G is the layer count over the pattern's period, here two
    block kinds alternating over 8 layers (G = 4)."""
    sizes = {"data": 2, "model": 4}
    kinds = ({"a": {"v": (8,), "u": (6, 3)}}, {"b": {"v": (12,), "u": (4, 4)}})
    G = 4

    def tree(shape_of):
        return {"blocks": [{k: {n: shape_of(sh) for n, sh in leaves.items()}
                            for k, leaves in kind.items()} for kind in kinds]}

    ref = JS.param_pspecs(tree(lambda sh: jax.ShapeDtypeStruct((G, *sh), np.float32)),
                          ShapeMesh(sizes))
    port_tree = {"blocks": [tree(lambda sh: torch.empty(sh, device="meta"))["blocks"][l % 2]
                            for l in range(2 * G)]}
    port = TS.param_pspecs(port_tree, sizes)
    assert tuple(ref["blocks"][0]["a"]["v"]) == (None, "model")
    for l, layer in enumerate(port["blocks"]):
        for path, spec in _walk(layer):
            want = tuple(dict(_walk(ref["blocks"][l % 2]))[path])
            assert want[1:] == tuple(spec), (l, path, want, spec)
    assert tuple(port["blocks"][0]["a"]["v"]) == ("model",)


@pytest.mark.parametrize("arch", TC.ARCH_IDS)
def test_batch_and_cache_specs_equal_the_references(arch):
    n_kv = TC.get_config(arch).n_kv
    for sizes, dp in MESHES.values():
        for batch in (1, 4, 16, 256):
            for div in (True, False):
                for ndim in (2, 3):
                    assert tuple(TS.batch_spec(TS.MeshAxes(data=dp), batch_divisible=div,
                                               ndim=ndim)) == tuple(
                        JS.batch_spec(JS.MeshAxes(data=dp), batch_divisible=div, ndim=ndim))
            assert tuple(TS.cache_pspec(n_kv, batch, sizes, TS.MeshAxes(data=dp))) == tuple(
                JS.cache_pspec(n_kv, batch, ShapeMesh(sizes), JS.MeshAxes(data=dp)))


def test_constrain_off_a_mesh_returns_its_input_and_refuses_a_plain_tensor_on_one():
    x = torch.ones(4, 6, 8)
    assert TS.constrain(x, ("data", None, "model")) is x
    assert TS.with_dp_constraint(x) is x
    try:
        TS.set_active_mesh({"data": 1, "model": 1})
        assert TS.constrain(x, ("data", None, "model")) is x   # one device: its own shard
        assert TS.with_dp_constraint(x) is x
        TS.set_active_mesh({"data": 2, "model": 1})
        with pytest.raises(TypeError, match="DTensor"):
            TS.with_dp_constraint(x)
        with pytest.raises(TypeError, match="DTensor"):
            TS.constrain(x, (None, None, "model"))
    finally:
        TS.set_active_mesh(None)


def test_make_production_mesh_raises_on_a_small_world():
    for multi_pod, n in ((False, 256), (True, 512)):
        with pytest.raises(RuntimeError, match=f"needs {n} ranks, one a device, the world has 1"):
            tmesh.make_production_mesh(multi_pod=multi_pod, device="cpu")
    with pytest.raises(RuntimeError, match="needs 4 ranks"):
        tmesh.make_mesh((2, 2), ("data", "model"), device="cpu")
    assert not dist.is_initialized()


# --- a world of one in this process ------------------------------------------

@pytest.fixture(scope="module")
def mesh1(tmp_path_factory):
    """A gloo world of one (a file:// store) and a (1, 1) (data, model) mesh
    on it."""
    store = tmp_path_factory.mktemp("world1") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0, world_size=1)
    try:
        yield init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def _wrapper_calls():
    r = np.random.default_rng(0)

    def t(*shape, dtype=np.float32):
        return torch.from_numpy(r.standard_normal(shape).astype(dtype))

    q, k = t(1, 8, 2, 32), t(1, 8, 2, 32)
    return {
        "rmsnorm": (rmsnorm, (t(4, 16), t(16))),
        "rmsnorm_bwd": (rmsnorm_bwd, (t(4, 16), t(16), t(4, 16))),
        "flash_attention": (flash_attention, (q, k, k)),
        "decode_attention": (decode_attention, (q[:, 0], k, k, 8)),
        "ssd_scan": (ssd_scan, (t(1, 8, 2, 4), torch.full((1, 8, 2), 0.9), t(1, 8, 2, 3),
                                t(1, 8, 2, 3))),
        "dp_sweep": (dp_sweep, (t(4, 4, dtype=np.float64), t(3, dtype=np.float64), 1.0,
                                torch.zeros(3, dtype=torch.int64),
                                torch.zeros((3, 3, 2), dtype=torch.int64),
                                torch.ones((3, 3, 2), dtype=torch.bool))),
    }


@pytest.mark.parametrize("name", list(_wrapper_calls()))
def test_kernel_wrappers_refuse_a_dtensor(name, mesh1):
    """Every wrapper raises on a DTensor input, before its device dispatch
    (the plain version here); a plain tensor runs."""
    fn, args = _wrapper_calls()[name]
    fn(*args)
    first = distribute_tensor(args[0], mesh1, [Replicate(), Replicate()])
    with pytest.raises(TypeError, match="DTensor"):
        fn(first, *args[1:])


def test_checkpoint_restore_with_new_sharding(tmp_path, mesh1):
    """The reference's ``tests/test_runtime.py`` elastic case: restore onto
    explicit single-device layouts."""
    cfg = TC.get_config("internlm2_1p8b").reduced()
    params = init_params(0, cfg, device="cpu")
    mgr = CheckpointManager(tmp_path)
    mgr.save(0, params)
    shardings = TS.named_shardings(mesh1, TS.param_pspecs(params, mesh1))
    restored, _ = mgr.restore(0, params, shardings=shardings)
    a = params["embed"]["table"]
    b = restored["embed"]["table"]
    assert isinstance(b, DTensor)
    np.testing.assert_allclose(a.numpy(), b.full_tensor().numpy())
    # a DTensor leaf saves as its whole value
    mgr.save(1, restored)
    again, _ = mgr.restore(1, params)
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(torch_ranks.flat(params),
                                                          torch_ranks.flat(again)))


# --- the gloo worlds ------------------------------------------------------------

JAX_SCRIPT = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding
import repro.configs as C
from repro.models import init_params, moe as moe_mod, transformer
from repro.parallel import sharding as sh

inp = dict(np.load(sys.argv[1]))
out = {}
mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
for arch, kw in PLACED.items():
    shapes = transformer.param_shapes(C.get_config(arch).reduced(**kw))
    specs = sh.param_pspecs(shapes, mesh)
    def visit(path, node, spec, pp):
        if isinstance(node, dict):
            for k in node:
                visit(f"{path}/{k}" if path else k, node[k], spec[k], pp)
        elif isinstance(node, list):
            for i, (v, s) in enumerate(zip(node, spec)):
                visit(path, v, s, i)
        else:
            idx = NamedSharding(mesh, spec).devices_indices_map(node.shape)
            for dev, sl in idx.items():
                out[f"{arch}|{path}|{pp}|{dev.id}"] = np.array(
                    [s.indices(n)[:2] for s, n in zip(sl, node.shape)], np.int64).reshape(-1, 2)
    visit("", shapes, specs, -1)

cfg0 = C.get_config("granite_moe_3b").reduced(d_model=32, experts=4)
def moe_cfg(impl, cf):
    return dataclasses.replace(cfg0, moe=dataclasses.replace(
        cfg0.moe, num_experts=3, top_k=2, capacity_factor=cf, impl=impl))
p = {k: jnp.asarray(inp["moe/" + k]) for k in ("router", "w_in", "w_gate", "w_out")}
x = jnp.asarray(inp["moe/x"])
y, aux = moe_mod.moe_apply(p, moe_cfg("einsum", 8.0), x)
out["moe/y_einsum"], out["moe/aux_einsum"] = np.asarray(y), np.asarray(aux)
moe_mod.SHARD_MAP_MIN_TOKENS = 0
sh.set_active_mesh(mesh, sh.MeshAxes(data=("data",), model="model"))
for cf in (8.0, 1.0):
    c = moe_cfg("shard_map", cf)
    y, aux = jax.jit(lambda p, x: moe_mod.moe_apply(p, c, x))(p, x)
    out[f"moe/y_sm_cf{cf:g}"], out[f"moe/aux_sm_cf{cf:g}"] = np.asarray(y), np.asarray(aux)
    def loss(p, x):
        y, aux = moe_mod.moe_apply(p, c, x)
        return y.sum() + aux
    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(p, x)
    for k in gp:
        out[f"moe/grad_sm_cf{cf:g}/{k}"] = np.asarray(gp[k])
    out[f"moe/grad_sm_cf{cf:g}/x"] = np.asarray(gx)

# a reduced granite's prefill, every MoE layer on the expert path
pcfg = C.get_config("granite_moe_3b").reduced(**PLACED["granite_moe_3b"])
pcfg = dataclasses.replace(pcfg, moe=dataclasses.replace(pcfg.moe, impl="shard_map"),
                           param_dtype="float32", compute_dtype="float32")
params = init_params(jax.random.PRNGKey(0), pcfg)
toks = jnp.asarray(inp["prefill/tokens"])
logits, _ = jax.jit(lambda p, t: transformer.prefill(p, pcfg, {"tokens": t}))(params, toks)
out["prefill/logits"] = np.asarray(logits)
np.savez(sys.argv[2], **out)
"""


def _flat_np(tree, path):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat_np(v, f"{path}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat_np(v, f"{path}/{i}").items()}
    return {path: np.asarray(tree)}


def _moe_inputs(rng):
    cfg = TC.get_config("granite_moe_3b").reduced(d_model=32, experts=4)
    d, f, e = cfg.d_model, cfg.d_ff, 3
    return {"moe/router": rng.standard_normal((d, e), np.float32) * np.float32(d ** -0.5),
            "moe/w_in": rng.standard_normal((e, d, f), np.float32) * np.float32(d ** -0.5),
            "moe/w_gate": rng.standard_normal((e, d, f), np.float32) * np.float32(d ** -0.5),
            "moe/w_out": rng.standard_normal((e, f, d), np.float32) * np.float32(f ** -0.5),
            "moe/x": rng.standard_normal((4, 8, d), np.float32) * np.float32(0.5)}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """One run each of the JAX reference (4 host devices), the 4-rank
    (data, model) world and the 2-rank world; their outputs by name."""
    tmp = tmp_path_factory.mktemp("worlds")
    rng = np.random.default_rng(0)
    ckpt = tmp / "ckpt"
    cfg = TC.get_config("internlm2_1p8b").reduced(**torch_ranks.PLACED_ARCHS["internlm2_1p8b"])
    CheckpointManager(ckpt).save(0, init_params(0, cfg, device="cpu"), extra={"cursor": 7})
    inputs = tmp / "inputs.npz"
    jcfg = torch_ranks.prefill_cfg(JC)
    tree = jax.tree.map(np.asarray, jax_init_params(jax.random.PRNGKey(0), jcfg))
    np.savez(inputs, **_moe_inputs(rng), **_flat_np(tree, "prefill_params"), **{
        "prefill/tokens": rng.integers(0, jcfg.vocab, (4, 8)).astype(np.int32),
        "engine/frames": rng.standard_normal((7, 326, 595, 3)).astype(np.float32),
        "ckpt/dir": np.array(str(ckpt))})
    script = f"PLACED = {torch_ranks.PLACED_ARCHS!r}\n" + JAX_SCRIPT
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    ref = subprocess.Popen([sys.executable, "-c", script, str(inputs), str(tmp / "ref.npz")],
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    four = torch_ranks.spawn("parallel", 4, inputs, tmp)
    out4 = torch_ranks.collect(four, tmp, "parallel")
    out2 = torch_ranks.collect(torch_ranks.spawn("engine_ckpt", 2, inputs, tmp), tmp,
                               "engine_ckpt")
    _, err = ref.communicate(timeout=300)
    assert ref.returncode == 0, err[-3000:]
    with np.load(tmp / "ref.npz") as f:
        refs = dict(f)
    return {"ref": refs, "four": out4, "two": out2, "inputs": dict(np.load(inputs))}


@pytest.mark.parametrize("arch", list(torch_ranks.PLACED_ARCHS))
def test_each_ranks_shard_is_its_devices_slice_in_the_reference(arch, worlds):
    """``shard_params(param_pspecs(...))`` on the 2 x 2 gloo mesh: rank r's
    local shard of every leaf is the slice ``NamedSharding(mesh, spec)
    .devices_indices_map`` gives device r of the reference's 2 x 2 mesh (the
    stack axis dropped for a layer's leaf)."""
    cfg = TC.get_config(arch).reduced(**torch_ranks.PLACED_ARCHS[arch])
    params = init_params(0, cfg, device="cpu")
    period = len(cfg.block_pattern)
    n_split = 0
    for path, full in torch_ranks.flat(params):
        parts = path.split("/")
        if parts[0] == "blocks":
            key, pp = "/".join(parts[:1] + parts[2:]), int(parts[1]) % period
        else:
            key, pp = path, -1
        for rank, out in enumerate(worlds["four"]):
            sl = worlds["ref"][f"{arch}|{key}|{pp}|{rank}"]
            if pp >= 0:
                sl = sl[1:]
            want = full[tuple(slice(a, b) for a, b in sl)]
            got = out[f"{arch}|{path}"]
            assert got.shape == tuple(want.shape) and np.array_equal(got, want.numpy()), (
                path, rank)
            n_split += got.size < full.numel()
    assert n_split > 0


def test_expert_path_matches_the_dense_einsum(worlds):
    for out in worlds["four"]:
        np.testing.assert_allclose(out["moe/y_ep_cf8"], out["moe/y_einsum"], atol=2e-5, rtol=0)
        assert abs(float(out["moe/aux_ep_cf8"]) - float(out["moe/aux_einsum"])) < 5e-2
        np.testing.assert_allclose(out["moe/y_einsum"], worlds["ref"]["moe/y_einsum"],
                                   atol=2e-5, rtol=0)
        assert out["moe/calls_at_0"].tolist() == [2, 0]


@pytest.mark.parametrize("cf", ["8", "1"])
def test_expert_path_matches_the_references_shard_map(cf, worlds):
    """At cf 1.0 slots drop (the output leaves the dense einsum's); each
    rank's y and aux still equal the reference's 2 x 2 shard map."""
    ref = worlds["ref"]
    if cf == "1":
        assert np.abs(ref["moe/y_sm_cf1"] - ref["moe/y_einsum"]).max() > 1e-3
    for out in worlds["four"]:
        np.testing.assert_allclose(out[f"moe/y_ep_cf{cf}"], ref[f"moe/y_sm_cf{cf}"],
                                   atol=2e-5, rtol=0)
        np.testing.assert_allclose(out[f"moe/aux_ep_cf{cf}"], ref[f"moe/aux_sm_cf{cf}"],
                                   atol=1e-6, rtol=1e-6)


def test_expert_path_carries_gradients(worlds):
    """The gradient of y.sum() + aux with respect to the router, the expert
    weights and x: on every rank the whole gradient (``collectives``' loss
    convention), within 1e-5 of ``jax.grad`` through the reference's 2 x 2
    shard map, with and without dropped slots."""
    ref = worlds["ref"]
    for cf in ("8", "1"):
        for k in ("router", "w_in", "w_gate", "w_out", "x"):
            want = ref[f"moe/grad_sm_cf{cf}/{k}"]
            assert np.abs(want).max() > 0, (cf, k)
            for rank, out in enumerate(worlds["four"]):
                np.testing.assert_allclose(out[f"moe/grad_ep_cf{cf}/{k}"], want, atol=1e-5,
                                           rtol=0, err_msg=f"cf {cf} {k} rank {rank}")


def test_granite_prefill_under_the_mesh_matches_the_references(worlds):
    """Reduced granite (2 layers, top-2 of 4 experts, ``impl="shard_map"``)
    prefilled under the active 2 x 2 mesh with the threshold at 0: both MoE
    layers take the expert path on plain whole-value activations, and every
    rank's logits are within f32 1e-4 of the reference's jitted prefill under
    its 2 x 2 mesh."""
    want = worlds["ref"]["prefill/logits"]
    for out in worlds["four"]:
        assert int(out["prefill/expert_calls"]) == 2
        np.testing.assert_allclose(out["prefill/logits"], want, rtol=1e-4, atol=1e-4)


def test_expert_path_below_the_threshold_runs_scatter(worlds):
    """At 32 tokens, under the reference's 16,384, ``shard_map`` runs the
    scatter impl (a spy on each path), and gives scatter's output."""
    inp = worlds["inputs"]
    cfg0 = TC.get_config("granite_moe_3b").reduced(d_model=32, experts=4)
    cfg = dataclasses.replace(cfg0, moe=dataclasses.replace(
        cfg0.moe, num_experts=3, top_k=2, capacity_factor=1.0, impl="scatter"))
    p = {k: torch.from_numpy(inp[f"moe/{k}"]) for k in ("router", "w_in", "w_gate", "w_out")}
    want = moe.moe_apply(p, cfg, torch.from_numpy(inp["moe/x"]))[0].numpy()
    for out in worlds["four"]:
        assert (out["moe/calls_below"] - out["moe/calls_before_below"]).tolist() == [0, 1]
        assert np.array_equal(out["moe/y_below"], want)


def test_constrain_redistributes_a_dtensor_under_the_mesh(worlds):
    for out in worlds["four"]:
        assert out["constrain/dp_placements_ok"] and out["constrain/values_ok"]
        assert out["constrain/plain_raises"]


def test_engine_splits_a_divisible_batch_over_the_data_axis(worlds):
    """Two ranks on data: the four-request stage runs two frames a rank (its
    warm-up and its timed run), the three-request stage all three; the
    outputs equal the run without a mesh bit for bit."""
    for out in worlds["two"]:
        assert out["engine/batches_seen"].tolist() == [2, 2, 3, 3]
        for r in range(7):
            assert np.array_equal(out[f"engine/mesh/{r}"], out[f"engine/plain/{r}"]), r


def test_checkpoint_saved_at_world_one_reshards_onto_two_ranks(worlds):
    """Each rank's restored local equals its slice and ``full_tensor`` the
    saved leaf, bit for bit (asserted in the ranks); some leaves split."""
    for out in worlds["two"]:
        assert int(out["ckpt/n_split"]) > 0 and int(out["ckpt/extra_cursor"]) == 7
