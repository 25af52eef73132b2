"""The port's sharded steps (``transformer.prefill``, ``decode_step`` and the
train step on DTensors under the active mesh) against the reference on the
CPU.

One gloo world of 4 ranks on a 2 x 2 (data, model) mesh
(``tests/torch_ranks.py::case_mesh``) runs each case of
``torch_ranks.MESH_CASES`` and ``TRAIN_CASES``, beside a JAX subprocess on 4
forced host devices that runs the reference under ``set_active_mesh`` with
the dry-run's ``in_shardings`` (and the decode's ``out_shardings``), from
the same reference-initialised weights and seeded tokens.  Checked:
prefill and decode logits and the cache, assembled with ``full_tensor()``,
within f32 1e-4; each rank's local shape at every constraint site equal to
the shard ``devices_indices_map`` gives its device at the reference's (the
reference's ``with_sharding_constraint`` calls recorded as it traces); the
train step's loss and each gradient leaf against ``jax.value_and_grad``
under the mesh within 1e-4 x max|g| a leaf, the gradients and the updated
params and moments keeping their placements; and the collectives a
prefill and a decode step issue in the gloo run equal those of the
dry-run's trace of rank 0's program of the same step on a 4-rank ``fake``
group, op for op and byte for byte.  The dry-run's per-device records of the
production meshes are checked in ``tests/test_torch_dryrun.py``.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

import repro.configs as JC
from repro.models import init_params as jax_init_params
from repro_torch import configs as TC
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun as D
from repro_torch.parallel import sharding as TS

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import torch_ranks

ROOT = pathlib.Path(__file__).resolve().parents[1]
F32 = 1e-4

JAX_SCRIPT = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
import repro.configs as C
from repro.models import transformer
from repro.parallel import sharding as sh

inp = dict(np.load(sys.argv[1]))
out = {}
mesh = Mesh(np.array(jax.devices()).reshape(*MESH_SHAPE), ("data", "model"))
axes = sh.MeshAxes(data=("data",), model="model")

# every constraint the reference applies, with each device's shard shape
sites = set()
_wsc = jax.lax.with_sharding_constraint
def wsc(x, s):
    for dev, sl in s.devices_indices_map(tuple(x.shape)).items():
        local = tuple(len(range(*d.indices(n))) for d, n in zip(sl, x.shape))
        sites.add(f"{dev.id}|{tuple(x.shape)}|{local}")
    return _wsc(x, s)
jax.lax.with_sharding_constraint = wsc

def unflatten(prefix):
    tree = {}
    for key, v in inp.items():
        if not key.startswith(prefix + "/"):
            continue
        *path, leaf = key[len(prefix) + 1:].split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}
    return lists(tree)

def named(tree):
    return jax.tree.map(lambda s: NamedSharding(mesh, s), tree,
                        is_leaf=lambda x: isinstance(x, P))

def cache_pspecs(cache):   # the reference dry-run's (importing it forces 512 devices)
    def spec(s):
        out = [None] * s.ndim
        if s.ndim > 1 and s.shape[1] % MESH_SHAPE[0] == 0:
            out[1] = "data"
        for i in range(2, s.ndim):
            if s.shape[i] % MESH_SHAPE[1] == 0:
                out[i] = "model"
                break
        return P(*out)
    return jax.tree.map(spec, cache)

def mesh_cfg(case):
    arch, kw, impl = case
    kw = dict(kw)
    mla = kw.pop("mla", None)
    cfg = C.get_config(arch).reduced(**kw)
    if mla is not None:
        cfg = dataclasses.replace(cfg, mla=dataclasses.replace(cfg.mla, **mla))
    if impl is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, impl=impl))
    return cfg

def flat(tree, path, acc):
    if isinstance(tree, dict):
        for k, v in tree.items():
            flat(v, f"{path}/{k}", acc)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            flat(v, f"{path}/{i}", acc)
    else:
        acc[path] = np.asarray(tree)
    return acc

sh.set_active_mesh(mesh, axes)
rows = NamedSharding(mesh, P("data", None))
for name, case in CASES.items():
    cfg = mesh_cfg(case)
    params = unflatten(f"{name}/params")
    pshard = named(sh.param_pspecs(params, mesh, axes))
    sites.clear()
    logits, cache = jax.jit(lambda p, b: transformer.prefill(p, cfg, b, max_len=T + EXTRA),
                            in_shardings=(pshard, {"tokens": rows}))(
        params, {"tokens": jnp.asarray(inp[f"{name}/tokens"])})
    out[f"{name}/prefill"] = np.asarray(logits)
    cshard = named(cache_pspecs(cache))
    cache = jax.device_put(cache, cshard)
    dl, cache = jax.jit(lambda p, t, c, pos: transformer.decode_step(p, cfg, t, c, pos),
                        in_shardings=(pshard, rows, cshard, NamedSharding(mesh, P())),
                        out_shardings=(None, cshard))(
        params, jnp.asarray(inp[f"{name}/next"]), cache, jnp.int32(T))
    out[f"{name}/decode"] = np.asarray(dl)
    out.update(flat(cache, f"{name}/cache", {}))
    out[f"{name}/sites"] = np.array(sorted(sites))
for name, case in TRAIN.items():
    cfg = mesh_cfg(case)
    params = unflatten(f"train/{name}/params")
    pshard = named(sh.param_pspecs(params, mesh, axes))
    sites.clear()
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: transformer.loss_fn(p, cfg, b, remat=True)[0]),
        in_shardings=(pshard, {"tokens": rows}))(
        params, {"tokens": jnp.asarray(inp[f"train/{name}/tokens"])})
    out[f"train/{name}/loss"] = np.asarray(loss)
    out.update(flat(grads, f"train/{name}/grad", {}))
    out[f"train/{name}/sites"] = np.array(sorted(sites))
np.savez(sys.argv[2], **out)
"""


def _flat_np(tree, path):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat_np(v, f"{path}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat_np(v, f"{path}/{i}").items()}
    return {path: np.asarray(tree)}


def _run_world(tmp, serve_cases: dict, train_cases: dict, mesh_shape: tuple, rank_case: str
               ) -> dict:
    """One run each of the reference (4 host devices on ``mesh_shape``) and
    the 4-rank gloo world (``torch_ranks`` case ``rank_case``); their
    outputs by name."""
    rng = np.random.default_rng(0)
    arrays = {}
    for prefix, cases in (("", serve_cases), ("train/", train_cases)):
        for name, case in cases.items():
            cfg = torch_ranks.mesh_cfg(JC, case)
            tree = jax.tree.map(np.asarray, jax_init_params(jax.random.PRNGKey(0), cfg))
            arrays.update(_flat_np(tree, f"{prefix}{name}/params"))
            B, T = torch_ranks.MESH_B, torch_ranks.MESH_T
            arrays[f"{prefix}{name}/tokens"] = rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
            arrays[f"{prefix}{name}/next"] = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
    inputs = tmp / "inputs.npz"
    np.savez(inputs, **arrays)
    script = (f"CASES = {serve_cases!r}\nTRAIN = {train_cases!r}\n"
              f"MESH_SHAPE = {tuple(mesh_shape)!r}\n"
              f"T, EXTRA = {torch_ranks.MESH_T}, {torch_ranks.MESH_EXTRA}\n" + JAX_SCRIPT)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    ref = subprocess.Popen([sys.executable, "-c", script, str(inputs), str(tmp / "ref.npz")],
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    ranks = torch_ranks.collect(torch_ranks.spawn(rank_case, 4, inputs, tmp), tmp, rank_case,
                                timeout=600)
    _, err = ref.communicate(timeout=600)
    assert ref.returncode == 0, err[-3000:]
    with np.load(tmp / "ref.npz") as f:
        refs = dict(f)
    return {"ref": refs, "ranks": ranks}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """One run each of the reference (4 host devices) and the 4-rank gloo
    world on the 2 x 2 mesh; their outputs by name."""
    return _run_world(tmp_path_factory.mktemp("mesh"), torch_ranks.MESH_CASES,
                      torch_ranks.TRAIN_CASES, (2, 2), "mesh")


@pytest.fixture(scope="module")
def group_world(tmp_path_factory):
    """The head-group cases on the 1 x 4 mesh, reference and gloo world."""
    return _run_world(tmp_path_factory.mktemp("groups"), torch_ranks.GROUP_CASES,
                      torch_ranks.GROUP_TRAIN_CASES, torch_ranks.GROUP_MESH, "groups")


def _within(got, want, tol=F32):
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, scale)


@pytest.mark.parametrize("case", list(torch_ranks.MESH_CASES))
def test_sharded_prefill_and_decode_match_the_reference(case, world):
    """Prefill's and decode's logits, assembled from every rank, within f32
    1e-4 of the reference's under the mesh, the same on every rank."""
    for kind in ("prefill", "decode"):
        want = world["ref"][f"{case}/{kind}"]
        for out in world["ranks"]:
            _within(out[f"{case}/{kind}"], want)


@pytest.mark.parametrize("case", list(torch_ranks.MESH_CASES))
def test_sharded_cache_matches_the_reference(case, world):
    """The cache after prefill and one decode step (the new token's k and v
    written by the rank holding its slot), leaf by leaf: the port's layer l
    is the reference's stacked leaf l % period at group l // period (MLA's
    ``latent`` the reference's bare layer array)."""
    cfg = torch_ranks.mesh_cfg(TC, torch_ranks.MESH_CASES[case])
    period = len(cfg.block_pattern)
    out = world["ranks"][0]
    keys = [k for k in out if k.startswith(f"{case}/cache/")]
    assert keys
    for key in keys:
        l, leaf = key.split("/")[2:]
        ref_key = f"{case}/cache/{int(l) % period}" + ("" if leaf == "latent" else f"/{leaf}")
        want = world["ref"][ref_key][int(l) // period]
        _within(out[key], want)


def test_cache_layouts_are_the_programs():
    """The cases cover each decode layout: kv heads on model (internlm2's
    4), the sequence on model where the heads do not divide (3 heads:
    decode context parallelism, whose merge moves no cache), and batch over
    data."""
    sizes = {"data": 2, "model": 2}
    kinds = set()
    for case in torch_ranks.MESH_CASES.values():
        cfg = torch_ranks.mesh_cfg(TC, case)
        if "attn" not in cfg.block_pattern and "hybrid" not in cfg.block_pattern:
            continue
        spec = TS.cache_leaf_spec("k", (torch_ranks.MESH_B, torch_ranks.MESH_T + 4, cfg.n_kv,
                                        cfg.hd), cfg.n_kv, sizes)
        assert spec[0] == "data"
        kinds.add("heads" if spec[2] == "model" else "sequence" if spec[1] == "model" else "-")
    assert kinds == {"heads", "sequence"}


@pytest.mark.parametrize("case", list(torch_ranks.MESH_CASES) + ["train/" + k for k in
                                                                 torch_ranks.TRAIN_CASES])
def test_each_ranks_local_shapes_at_the_sites_are_its_devices(case, world):
    """At every constraint site the step passes (after each block, the
    loss's logits, the MoE's buffers, _row_shard's rows), rank r's local
    shape is the shard of device r at the reference's site of the same
    global shape, and the two sets of sites are the same."""
    ref = {}
    for s in world["ref"][f"{case}/sites"]:
        dev, g, loc = str(s).split("|")
        ref.setdefault(int(dev), set()).add((g, loc))
    for rank, out in enumerate(world["ranks"]):
        got = {tuple(str(s).split("|")[1:]) for s in out[f"{case}/sites"]}
        assert got == ref[rank], (rank, sorted(got ^ ref[rank]))


def test_row_shard_fires_and_moe_buffers_lie_as_the_reference_lays_them(world):
    """The cases reach the sites they are there for: q's rows on model
    (3 kv heads of 32, so 96 <= 2048), the MoE's buffers by experts (E 4) and
    over data x model (E 3)."""
    sites = {c: {str(s).split("|")[0] for s in world["ranks"][0][f"{c}/sites"]}
             for c in torch_ranks.MESH_CASES}
    assert "row_shard" in sites["row_shard"] and "row_shard" not in sites["internlm2"]
    assert {"moe_buffer", "dp"} <= sites["granite_e4"] and "moe_buffer" in sites["granite_e3"]
    e4 = [str(s) for s in world["ranks"][0]["granite_e4/sites"] if s.startswith("moe_buffer")]
    e3 = [str(s) for s in world["ranks"][0]["granite_e3/sites"] if s.startswith("moe_buffer")]
    assert all(s.split("|")[2].startswith("(2,") for s in e4)        # experts 4 / 2
    assert all(s.split("|")[2].startswith("(3,") for s in e3)        # experts whole


@pytest.mark.parametrize("case", list(torch_ranks.TRAIN_CASES))
def test_sharded_train_step_matches_value_and_grad(case, world):
    """The loss within 1e-5 and each gradient leaf within 1e-4 x its max|g|
    of ``jax.value_and_grad`` under the mesh (a layer's leaf against the
    stacked leaf's group); each gradient, and after a train step each param
    and both moments, keep their parameter's placements."""
    cfg = torch_ranks.mesh_cfg(TC, torch_ranks.TRAIN_CASES[case])
    period = len(cfg.block_pattern)
    ref = world["ref"]
    n = 0
    for out in world["ranks"]:
        assert abs(float(out[f"train/{case}/loss"]) - float(ref[f"train/{case}/loss"])) <= 1e-5
        assert float(out[f"train/{case}/step_loss"]) == pytest.approx(
            float(out[f"train/{case}/loss"]), abs=1e-6)
        assert bool(out[f"train/{case}/step_placed"])
        for key in (k for k in out if k.startswith(f"train/{case}/grad/")):
            path = key.split("/")[3:]
            if path[0] == "blocks":
                l = int(path[1])
                want = ref["/".join([f"train/{case}/grad", "blocks", str(l % period)] +
                                    path[2:])][l // period]
            else:
                want = ref[key]
            got = out[key]
            assert np.abs(got - want).max() <= 1e-4 * max(np.abs(want).max(), 1e-30), key
            assert bool(out[key.replace("/grad/", "/placed/")]), key
            n += 1
    assert n > 0


@pytest.mark.parametrize("case", list(torch_ranks.MOE_EP_CASES))
def test_expert_path_on_dtensors_matches_the_whole_value_path(case, world):
    """The MoE's expert-parallel path on DTensors (E on ``model``; E padded
    and sliced; a batch that does not divide ``data``) against the same path
    on whole plain tensors: y and aux within f32 1e-4, each gradient within
    1e-4 x max|g|; and a rank all-gathers only its column's experts over
    ``data``, the router and, where the batch lies whole, y's rows: never
    the whole experts."""
    for out in world["ranks"]:
        pre = f"moe_ep/{case}"
        for key in ("y", "aux"):
            _within(out[f"{pre}/dtensor/{key}"], out[f"{pre}/plain/{key}"])
        keys = [k for k in out if k.startswith(f"{pre}/plain/grad/")]
        assert len(keys) == 5
        for key in keys:
            want, got = out[key], out[key.replace("/plain/", "/dtensor/")]
            assert np.abs(got - want).max() <= 1e-4 * max(np.abs(want).max(), 1e-30), key
        assert int(out[f"{pre}/gathered"]) == int(out[f"{pre}/gathered_want"])
        assert int(out[f"{pre}/gathered"]) < int(out[f"{pre}/experts_whole"])


@pytest.fixture(scope="module")
def fake_traces():
    """The dry-run's trace of rank 0's program on a 4-rank fake group, for
    each counted case's prefill and decode step at the gloo run's shapes."""
    D.MESHES["mesh2x2"] = ({"data": 2, "model": 2}, TS.MeshAxes(data=("data",)))
    try:
        out = {}
        for name in torch_ranks.COUNTED:
            cfg = torch_ranks.mesh_cfg(TC, torch_ranks.MESH_CASES[name])
            for kind, S in (("prefill", torch_ranks.MESH_T),
                            ("decode", torch_ranks.MESH_T + torch_ranks.MESH_EXTRA)):
                shape = ShapeConfig(f"mesh_{kind}", S, torch_ranks.MESH_B, kind)
                out[(name, kind)] = D.trace(cfg, shape, torch_ranks.MESH_B,
                                            mesh_name="mesh2x2", mesh_device="cpu")
        return out
    finally:
        del D.MESHES["mesh2x2"]


@pytest.mark.parametrize("case", torch_ranks.COUNTED)
@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_gloo_collectives_equal_the_fake_groups_trace(case, kind, world, fake_traces):
    """Rank 0's collectives in the gloo run (counted by
    ``cost.collective_counter``) equal the dry-run's trace of the same step
    on a fake group, op for op and byte for byte, and the trace's record
    sums them."""
    res = fake_traces[(case, kind)]
    want = [f"{op}:{b}" for op, b in res["coll_log"]]
    got = [str(s) for s in world["ranks"][0][f"{case}/coll/{kind}"]]
    assert got == want
    assert len(want) > 0 and res["collectives"]["count"] == len(want)
    assert sum(int(s.split(":")[1]) for s in want) == sum(
        v for k, v in res["collectives"].items() if k != "count")


def test_mla_output_projection_takes_each_ranks_rows_of_wo(world, monkeypatch):
    """minicpm3 reduced to 23 heads of (96, 64), which the 2 x 2 mesh's
    ``model`` axis does not divide and whose rows ``_row_shard`` does not
    take (23 x 96 > 2048), as at full width on (16, 16) (wo's 1472 rows it
    divides): its prefill and decode logits match the reference's, and rank
    0's output projection, forward and backward, does a quarter of the
    step's FLOPs in the train step traced on a 4-rank fake group: y's
    columns cut to the rank's rows of wo, as the reference's rule lays wo
    out, then one all-reduce over ``model``.  wo taken whole on every rank
    would do half."""
    from repro_torch.launch import flops_by_site

    for kind in ("prefill", "decode"):
        for out in world["ranks"]:
            _within(out[f"minicpm3/{kind}"], world["ref"][f"minicpm3/{kind}"])
    monkeypatch.setitem(D.MESHES, "mesh2x2", ({"data": 2, "model": 2},
                                              TS.MeshAxes(data=("data",))))
    cfg = torch_ranks.mesh_cfg(TC, torch_ranks.MESH_CASES["minicpm3"])
    assert cfg.n_heads % 2 and (cfg.n_heads * cfg.mla.v_head_dim) % 2 == 0
    assert cfg.n_heads * (cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim) > 2048
    shape = ShapeConfig("mesh_train", torch_ranks.MESH_T, torch_ranks.MESH_B, "train")
    rank, _ = flops_by_site.by_site(cfg, shape, "mesh2x2")
    step, _ = flops_by_site.by_site(cfg, shape, None)
    for site in ("models/attention.py _out", "models/attention.py _out (backward)"):
        assert step[site] > 0 and rank[site] * 4 == step[site], (site, rank[site], step[site])


# ---------------------------------------------------------------------------
# head groups: heads that divide neither ``model`` nor its rows, on a 1 x 4 mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(torch_ranks.GROUP_CASES))
def test_head_group_prefill_decode_and_cache_match_the_reference(case, group_world):
    """On the 1 x 4 mesh: prefill's and decode's logits and the cache after
    them within f32 1e-4 of the reference's jitted run under the mesh, on
    every rank (minicpm3's attention in 2 groups of 11 heads; hymba's
    prefill scan in 2 groups of 3 heads, its state handed to the cache by P,
    and its decode scan on every head at the rank's slice of P)."""
    cfg = torch_ranks.mesh_cfg(TC, torch_ranks.GROUP_CASES[case])
    period = len(cfg.block_pattern)
    for out in group_world["ranks"]:
        for kind in ("prefill", "decode"):
            _within(out[f"{case}/{kind}"], group_world["ref"][f"{case}/{kind}"])
        keys = [k for k in out if k.startswith(f"{case}/cache/")]
        assert keys
        for key in keys:
            l, leaf = key.split("/")[2:]
            ref_key = f"{case}/cache/{int(l) % period}" + ("" if leaf == "latent" else f"/{leaf}")
            _within(out[key], group_world["ref"][ref_key][int(l) // period])


def test_head_group_scans_run_the_references_per_rank_shapes(group_world):
    """hymba's 6 SSM heads of 64 (N 8) on the 1 x 4 mesh, batch 4 x 16: each
    rank's prefill scan runs its group's 3 heads whole, from no state to
    its group's final state (4, 3, 64, 8), which lies in the cache by P,
    16 a rank, every head (the cache checks above hold its values); each
    rank's decode scan runs all 6 heads on its 16 of P, the state (4, 6,
    16, 8) in and out: the reference's compiled prefill_32k and decode_32k
    on (16, 16) cut the same way."""
    for out in group_world["ranks"]:
        assert set(out["hymba/scan/prefill"]) == {"(4, 16, 3, 64)|None|(4, 3, 64, 8)"}
        assert set(out["hymba/scan/decode"]) == {"(4, 1, 6, 16)|(4, 6, 16, 8)|(4, 6, 16, 8)"}
        assert len(out["hymba/scan/prefill"]) == len(out["hymba/scan/decode"]) == 2
        for l in range(2):
            assert tuple(out[f"hymba/cache_local/{l}/ssm"]) == (4, 6, 16, 8)


@pytest.mark.parametrize("case", list(torch_ranks.GROUP_TRAIN_CASES))
def test_head_group_train_step_matches_value_and_grad(case, group_world):
    """The train step with minicpm3's attention and hymba's scan in head
    groups: the loss within 1e-5 and each gradient leaf within 1e-4 x its
    max|g| of ``jax.value_and_grad`` under the 1 x 4 mesh, the gradients,
    and after a train step the params and moments, in their placements."""
    cfg = torch_ranks.mesh_cfg(TC, torch_ranks.GROUP_TRAIN_CASES[case])
    period = len(cfg.block_pattern)
    ref = group_world["ref"]
    n = 0
    for out in group_world["ranks"]:
        assert abs(float(out[f"train/{case}/loss"]) - float(ref[f"train/{case}/loss"])) <= 1e-5
        assert float(out[f"train/{case}/step_loss"]) == pytest.approx(
            float(out[f"train/{case}/loss"]), abs=1e-6)
        assert bool(out[f"train/{case}/step_placed"])
        for key in (k for k in out if k.startswith(f"train/{case}/grad/")):
            path = key.split("/")[3:]
            if path[0] == "blocks":
                l = int(path[1])
                want = ref["/".join([f"train/{case}/grad", "blocks", str(l % period)] +
                                    path[2:])][l // period]
            else:
                want = ref[key]
            assert np.abs(out[key] - want).max() <= 1e-4 * max(np.abs(want).max(), 1e-30), key
            assert bool(out[key.replace("/grad/", "/placed/")]), key
            n += 1
    assert n > 0


@pytest.mark.parametrize("case", list(torch_ranks.GROUP_CASES) + [
    "train/" + k for k in torch_ranks.GROUP_TRAIN_CASES])
def test_head_group_ranks_local_shapes_at_the_sites_are_its_devices(case, group_world):
    """At every constraint site of the 1 x 4 runs, rank r's local shape is
    device r's shard at the reference's site of the same global shape."""
    ref = {}
    for s in group_world["ref"][f"{case}/sites"]:
        dev, g, loc = str(s).split("|")
        ref.setdefault(int(dev), set()).add((g, loc))
    for rank, out in enumerate(group_world["ranks"]):
        got = {tuple(str(s).split("|")[1:]) for s in out[f"{case}/sites"]}
        assert got == ref[rank], (rank, sorted(got ^ ref[rank]))


@pytest.mark.parametrize("case,site,kernel", [
    ("minicpm3", "models/attention.py mla_apply", "flash_attention"),
    ("hymba", "models/ssm.py _ssm_core", "ssd_scan")])
def test_head_groups_put_each_rank_on_its_groups_heads(case, site, kernel, monkeypatch):
    """The train step of each case traced as rank 0's program on a 4-rank
    fake 1 x 4 group: its attention (minicpm3) or scan (hymba) kernel,
    forward and backward, does half the step's work (its group's heads, 2 x
    its quarter share: the reference's layout), not all of it."""
    from repro_torch.launch import flops_by_site
    monkeypatch.setitem(D.MESHES, "mesh1x4", ({"data": 1, "model": 4},
                                              TS.MeshAxes(data=("data",))))
    cfg = torch_ranks.mesh_cfg(TC, torch_ranks.GROUP_TRAIN_CASES[case])
    shape = ShapeConfig("mesh_train", torch_ranks.MESH_T, torch_ranks.MESH_B, "train")
    rank, _ = flops_by_site.by_site(cfg, shape, "mesh1x4")
    step, _ = flops_by_site.by_site(cfg, shape, None)
    for key in (f"{site} [{kernel}]", f"{site} (backward) [{kernel}_bwd]"):
        assert step[key] > 0 and rank[key] * 2 == step[key], (key, rank[key], step[key])
