"""Rank programs of the port's multi-rank CPU tests
(``tests/test_torch_parallel.py``, ``tests/test_torch_pipeline.py``,
``tests/test_torch_mesh.py``).

Each process is one rank of a gloo world opened through a ``file://`` store
(no TCP port, so test workers running side by side never collide):

    python tests/torch_ranks.py CASE RANK WORLD STORE INPUTS.npz OUT_DIR

A case reads its inputs (seeded numpy arrays) from INPUTS.npz and writes
``OUT_DIR/rank<R>.npz``; the test compares those with the reference's
values.  A rank that fails exits non-zero with its traceback on stderr.
Imports no jax.
"""

from __future__ import annotations

import contextlib
import dataclasses
import pathlib
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from torch.distributed.device_mesh import init_device_mesh  # noqa: E402
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor  # noqa: E402

from repro_torch import configs as C  # noqa: E402
from repro_torch.checkpointing import CheckpointManager  # noqa: E402
from repro_torch.exec import ExecutionEngine  # noqa: E402
from repro_torch.exec.stage_graph import StageGraph, StageTask  # noqa: E402
from repro_torch.kernels import cost  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import cnn, from_jax_params, init_params, moe, transformer  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.parallel import pipeline, sharding  # noqa: E402
from repro_torch.runtime import steps  # noqa: E402

# The reduced configs whose placements are checked against the reference's
# (a width and depth both mesh axes divide), and the pipeline cases.
PLACED_ARCHS = {"internlm2_1p8b": dict(n_layers=2, d_model=64),
                "granite_moe_3b": dict(n_layers=2, d_model=64, experts=4)}
PIPE4 = {"uniform-m4": (None, 4), "uniform-m8": (None, 8), "1322-m2": ([1, 3, 2, 2], 2),
         "4211-m4": ([4, 2, 1, 1], 4), "1115-m8": ([1, 1, 1, 5], 8), "1511-m1": ([1, 5, 1, 1], 1)}
PIPE2 = {"35-m2": ([3, 5], 2), "62-m4": ([6, 2], 4), "uniform-m2": (None, 2)}
BAD_CUTS = {"three-cuts": [2, 2, 2], "empty-stage": [3, 3, 1, 0], "sum-16": [4, 4, 4, 4]}
STACK_CUTS = [1, 3, 2, 2]
# The sharded steps' cases on a 2 x 2 (data, model) mesh: (arch, reduced()
# arguments, MoE impl or None), the counted ones at head dims the kernels'
# meta branches take (32).  internlm2's 4 kv heads split over model
# (head-parallel, its cache by heads); 3 heads of 32 fire _row_shard and
# shard the cache by sequence (decode context parallelism); hymba runs its
# scan and attention; granite's scatter MoE at E 4 (divides model: the
# experts on model) and E 3 (does not: the slots over data x model).
MESH_CASES = {"internlm2": ("internlm2_1p8b", dict(n_layers=2, d_model=128), None),
              "row_shard": ("internlm2_1p8b", dict(n_layers=2, d_model=96, n_heads=3, n_kv=3),
                            None),
              "hymba": ("hymba_1p5b", dict(n_layers=2, d_model=128), None),
              "granite_e4": ("granite_moe_3b", dict(n_layers=2, d_model=64, experts=4),
                             "scatter"),
              "granite_e3": ("granite_moe_3b", dict(n_layers=2, d_model=64, experts=3),
                             "scatter"),
              # MLA, 23 heads of (96, 64): model divides neither the heads nor (at
              # 23 x 96 > 2048) takes q's rows; wo's 1472 rows it divides
              "minicpm3": ("minicpm3_4b", dict(n_layers=2, d_model=64, n_heads=23,
                                               mla=dict(qk_nope_head_dim=64, qk_rope_head_dim=32,
                                                        v_head_dim=64)), None),
              # xLSTM's serving path: the sLSTM loop a sequence a model rank
              # (``sharding.batch_rows``, its state so in the cache), the
              # mLSTM's y cut to w_out's rows
              "xlstm": ("xlstm_1p3b", dict(n_layers=8, d_model=64), None),
              # one mLSTM head, fewer than model's 2 ranks: the cache holds C
              # and n by their k rows on model, and decode updates each
              # rank's rows where they lie (``ops._mlstm_by_rows``)
              "xlstm_one_head": ("xlstm_1p3b", dict(n_layers=8, d_model=32, n_heads=1), None)}
# xlstm_one_head: one mLSTM head on the model axis of 2, so the train step's
# cell runs the reference's layout (the head on both model ranks, each on
# half of v's columns: ``ops.mlstm_scan``), and the sLSTM loop a sequence a
# rank (``sharding.batch_rows``).  At d 32: at d 64 (a head of 128) the
# unsharded port's f32 gradient already lies 2.3e-4 x max|g| from the
# reference's, and each f32 side is as far from the port run in f64
# (``tests/xlstm_f64_gap.py``), so at that width the f32 reference is no
# 1e-4 oracle; at d 32 the two f32 sides agree within 3.6e-5.
TRAIN_CASES = {"internlm2": ("internlm2_1p8b", dict(n_layers=2, d_model=64), None),
               "xlstm": ("xlstm_1p3b", dict(n_layers=8, d_model=64), None),
               "xlstm_one_head": ("xlstm_1p3b", dict(n_layers=8, d_model=32, n_heads=1), None)}
MESH_B, MESH_T, MESH_EXTRA = 4, 16, 4   # batch, prompt, cache slots past it
# The head-group cases on a 1 x 4 (data, model) mesh, whose model axis
# shares a factor of 2 with the heads (``sharding.head_groups``: 2 groups,
# ranks 0-1 and 2-3): minicpm3's MLA at 22 heads of (96, 64) (22 x 96 > 2048,
# so ``_row_shard`` does not take q's rows: the layout of its 40 heads on
# 16 ranks) and hymba at d 192, 6 SSM heads of 64 and 3 attention heads of 64
# (the kernels' head dim; the train step's and prefill's scan in groups of
# 3, prefill's state then laid out as its cache leaf, P on model; decode's
# on every head at the rank's 16 of P).
GROUP_MESH = (1, 4)
GROUP_CASES = {"minicpm3": ("minicpm3_4b", dict(n_layers=2, d_model=64, n_heads=22,
                                                mla=dict(qk_nope_head_dim=64, qk_rope_head_dim=32,
                                                         v_head_dim=64)), None),
               "hymba": ("hymba_1p5b", dict(n_layers=2, d_model=192, n_heads=3), None)}
GROUP_TRAIN_CASES = GROUP_CASES
# the cases whose collectives the gloo run counts beside the dry-run's trace;
# and those whose decode step's collectives it counts alone (the MoE's
# experts on each rank's slice of d, the mLSTM's state updated by k rows)
COUNTED = ("internlm2", "row_shard", "hymba")
DECODE_COUNTED = ("granite_e4", "xlstm_one_head")


def mesh_cfg(configs, case: tuple):
    """A case's reduced config from either package's ``configs`` (``mla`` in
    its keywords: MLA's head dims in place of the reduced ones)."""
    arch, kw, impl = case
    kw = dict(kw)
    mla = kw.pop("mla", None)
    cfg = configs.get_config(arch).reduced(**kw)
    if mla is not None:
        cfg = dataclasses.replace(cfg, mla=dataclasses.replace(cfg.mla, **mla))
    if impl is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, impl=impl))
    return cfg


def prefill_cfg(configs):
    """The reduced granite of the prefill case, from either package's
    ``configs``: f32, its MoE on the ``shard_map`` impl."""
    cfg = configs.get_config("granite_moe_3b").reduced(**PLACED_ARCHS["granite_moe_3b"])
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, impl="shard_map"),
                               param_dtype="float32", compute_dtype="float32")


def unflatten(arrays: dict, prefix: str) -> dict:
    """Rebuild a tree saved as ``prefix/a/b`` keys (list indices as digits)."""
    tree: dict = {}
    for key, v in arrays.items():
        if not key.startswith(prefix + "/"):
            continue
        *path, leaf = key[len(prefix) + 1:].split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(tree)


def flat(tree, path=""):
    if isinstance(tree, dict):
        return [leaf for k, v in tree.items() for leaf in flat(v, f"{path}/{k}" if path else k)]
    if isinstance(tree, list):
        return [leaf for i, v in enumerate(tree) for leaf in flat(v, f"{path}/{i}")]
    return [(path, tree)]


def sharded_slice(full: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's slice of ``full`` under ``spec``, cut by hand (each named
    mesh dim splits its tensor dim evenly, outer names first)."""
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    sizes = sharding.mesh_sizes(mesh)
    out = full
    for dim, entry in enumerate(spec):
        names = entry if isinstance(entry, tuple) else (() if entry is None else (entry,))
        idx, n = 0, 1
        for a in names:
            idx, n = idx * sizes[a] + coord[a], n * sizes[a]
        out = out.chunk(n, dim)[idx] if n > 1 else out
    return out


# --- tests/test_torch_parallel.py -------------------------------------------

def case_parallel(rank: int, world: int, inp: dict) -> dict:
    """2 x 2 (data, model): placements, the MoE's expert path (outputs,
    gradients, a reduced granite's prefill), constrain."""
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    out: dict = {}

    # placements of reduced models' parameters
    for arch, kw in PLACED_ARCHS.items():
        cfg = C.get_config(arch).reduced(**kw)
        params = init_params(0, cfg, device="cpu")
        specs = sharding.param_pspecs(params, mesh)
        placed = sharding.shard_params(params, mesh, specs)
        for (path, t), (_, d) in zip(flat(params), flat(placed)):
            assert isinstance(d, DTensor), path
            assert torch.equal(d.full_tensor(), t), path
            out[f"{arch}|{path}"] = d.to_local().numpy()

    # the MoE's expert-parallel path, the reference test's case
    cfg0 = C.get_config("granite_moe_3b").reduced(d_model=32, experts=4)

    def moe_cfg(impl: str, cf: float):
        return dataclasses.replace(cfg0, moe=dataclasses.replace(
            cfg0.moe, num_experts=3, top_k=2, capacity_factor=cf, impl=impl))

    p = {k: torch.from_numpy(inp[f"moe/{k}"]).requires_grad_(True)
         for k in ("router", "w_in", "w_gate", "w_out")}
    x = torch.from_numpy(inp["moe/x"])
    calls = {"expert": 0, "scatter": 0}
    real_ep, real_sc = moe._moe_expert_parallel, moe._moe_scatter

    def spy_ep(*a):
        calls["expert"] += 1
        return real_ep(*a)

    def spy_sc(*a):
        calls["scatter"] += 1
        return real_sc(*a)

    moe._moe_expert_parallel, moe._moe_scatter = spy_ep, spy_sc
    sharding.set_active_mesh(mesh, sharding.MeshAxes())
    try:
        out["moe/y_einsum"], out["moe/aux_einsum"] = (
            t.detach().numpy() for t in moe.moe_apply(p, moe_cfg("einsum", 8.0), x))
        floor, moe.SHARD_MAP_MIN_TOKENS = moe.SHARD_MAP_MIN_TOKENS, 0
        for cf in (8.0, 1.0):
            for t in p.values():
                t.grad = None
            xg = x.clone().requires_grad_(True)
            y, aux = moe.moe_apply(p, moe_cfg("shard_map", cf), xg)
            out[f"moe/y_ep_cf{cf:g}"] = y.detach().numpy()
            out[f"moe/aux_ep_cf{cf:g}"] = aux.detach().numpy()
            (y.sum() + aux).backward()
            for k in p:
                out[f"moe/grad_ep_cf{cf:g}/{k}"] = p[k].grad.numpy()
            out[f"moe/grad_ep_cf{cf:g}/x"] = xg.grad.numpy()
        out["moe/calls_at_0"] = np.array([calls["expert"], calls["scatter"]])

        # a reduced granite's prefill on plain whole-value activations
        pcfg = prefill_cfg(C)
        params = from_jax_params(unflatten(inp, "prefill_params"), pcfg, device="cpu")
        before = calls["expert"]
        with torch.no_grad():
            logits, _ = transformer.prefill(params, pcfg,
                                            {"tokens": torch.from_numpy(inp["prefill/tokens"])})
        out["prefill/logits"] = logits.numpy()
        out["prefill/expert_calls"] = np.array(calls["expert"] - before)
        out["moe/calls_before_below"] = np.array([calls["expert"], calls["scatter"]])
        moe.SHARD_MAP_MIN_TOKENS = floor
        y_below, _ = moe.moe_apply(p, moe_cfg("shard_map", 1.0), x)
        out["moe/y_below"] = y_below.detach().numpy()
        out["moe/calls_below"] = np.array([calls["expert"], calls["scatter"]])

        # constrain / with_dp_constraint on a DTensor under the active mesh
        whole = torch.arange(4 * 6 * 8, dtype=torch.float32).reshape(4, 6, 8)
        xd = distribute_tensor(whole, mesh, [Replicate(), Replicate()])
        yd = sharding.with_dp_constraint(xd)
        zd = sharding.constrain(xd, (None, None, "model"))
        out["constrain/dp_placements_ok"] = np.array(
            tuple(yd.placements) == (Shard(0), Replicate())
            and tuple(zd.placements) == (Replicate(), Shard(2)))
        out["constrain/values_ok"] = np.array(
            torch.equal(yd.full_tensor(), whole) and torch.equal(zd.full_tensor(), whole))
        try:
            sharding.constrain(whole, (None, None, "model"))
            out["constrain/plain_raises"] = np.array(False)
        except TypeError:
            out["constrain/plain_raises"] = np.array(True)
    finally:
        sharding.set_active_mesh(None)
        moe._moe_expert_parallel, moe._moe_scatter = real_ep, real_sc
    return out


def case_engine_ckpt(rank: int, world: int, inp: dict) -> dict:
    """(2, 1) (data, model): the engine's batch sharding and a checkpoint
    saved at world one restored onto the mesh."""
    mesh = init_device_mesh("cpu", (2, 1), mesh_dim_names=("data", "model"))
    out: dict = {}

    # engine: a stage of four requests (split 2 + 2) and one of three (not)
    params = cnn.lenet_init(torch.Generator().manual_seed(0), device="cpu")
    fns = cnn.lenet_layers(params)
    seen: list[int] = []
    first = fns[0]

    def spy(x):
        seen.append(x.shape[0])
        return first(x)

    graph = StageGraph(tasks=(StageTask(0, 0, 3, (0, 1, 2, 3)), StageTask(1, 3, 7, (0, 1, 2, 3)),
                              StageTask(2, 0, 7, (4, 5, 6))),
                       transfers=(), n_layers=7, n_requests=7, requests=tuple(range(7)))
    frames = inp["engine/frames"]
    plain = ExecutionEngine(fns, device="cpu").run(graph, frames).outputs
    placed = ExecutionEngine([spy] + fns[1:], mesh=mesh, device="cpu").run(graph, frames).outputs
    out["engine/batches_seen"] = np.array(seen)
    for r in range(7):
        out[f"engine/plain/{r}"], out[f"engine/mesh/{r}"] = plain[r], placed[r]

    # checkpoint re-shard
    cfg = C.get_config("internlm2_1p8b").reduced(**PLACED_ARCHS["internlm2_1p8b"])
    template = transformer.param_shapes(cfg)
    specs = sharding.param_pspecs(template, mesh)
    shardings = sharding.named_shardings(mesh, specs)
    restored, extra = CheckpointManager(str(inp["ckpt/dir"])).restore(0, template,
                                                                      shardings=shardings)
    saved = init_params(0, cfg, device="cpu")
    n_split = 0
    for (path, want), (_, got), (_, spec) in zip(flat(saved), flat(restored), flat(specs)):
        assert isinstance(got, DTensor), path
        assert torch.equal(got.full_tensor(), want), path
        local = sharded_slice(want, spec, mesh)
        assert torch.equal(got.to_local(), local), path
        n_split += local.numel() < want.numel()
    out["ckpt/n_split"] = np.array(n_split)
    out["ckpt/extra_cursor"] = np.array(extra["cursor"])
    return out


# --- tests/test_torch_pipeline.py -------------------------------------------

def _tanh_block(w_l: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.tanh(x @ w_l)


def _pipe_cases(mesh, cases: dict, inp: dict, out: dict) -> None:
    w = torch.from_numpy(inp["w"])
    x = torch.from_numpy(inp["x"])
    layers = list(w)
    for name, (cuts, n_micro) in cases.items():
        if cuts is None:
            y = pipeline.pipeline_forward(_tanh_block, layers, x, mesh=mesh, n_micro=n_micro)
        else:
            # other stages' layers are never read: hand this rank only its own
            sid = mesh.get_local_rank("stage")
            start = sum(cuts[:sid])
            mine = [w_l if start <= i < start + cuts[sid] else None
                    for i, w_l in enumerate(layers)]
            y = pipeline.pipeline_forward_stages(_tanh_block, mine, x, mesh=mesh,
                                                 stage_sizes=cuts, n_micro=n_micro)
        out[f"pipe/{name}"] = y.numpy()


def case_pipeline4(rank: int, world: int, inp: dict) -> dict:
    mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("stage",))
    out: dict = {}
    _pipe_cases(mesh, PIPE4, inp, out)
    w = list(torch.from_numpy(inp["w"]))
    for name, cuts in BAD_CUTS.items():
        try:
            pipeline.pipeline_forward_stages(_tanh_block, w, torch.from_numpy(inp["x"]),
                                             mesh=mesh, stage_sizes=cuts)
            out[f"bad/{name}"] = np.array(False)
        except ValueError:
            out[f"bad/{name}"] = np.array(True)
    cfg = C.get_config("internlm2_1p8b").reduced(n_layers=8, d_model=64)
    params = from_jax_params(unflatten(inp, "lm"), cfg, device="cpu")
    out["stack/pipelined"] = pipeline.pipeline_forward_stages(
        transformer.block_fn(cfg), params["blocks"], torch.from_numpy(inp["stack/x"]),
        mesh=mesh, stage_sizes=STACK_CUTS, n_micro=2).numpy()
    return out


def case_pipeline2(rank: int, world: int, inp: dict) -> dict:
    mesh = init_device_mesh("cpu", (2,), mesh_dim_names=("stage",))
    out: dict = {}
    _pipe_cases(mesh, PIPE2, inp, out)
    return out


# --- tests/test_torch_mesh.py -----------------------------------------------

def _full(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


def case_mesh(rank: int, world: int, inp: dict) -> dict:
    """2 x 2 (data, model): each case's sharded prefill, decode and cache,
    the constraint sites' local shapes, the sharded train step's loss and
    gradients, and the collectives of a prefill and a decode step in order."""
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    out: dict = {}
    sharding.set_active_mesh(mesh, sharding.MeshAxes())
    try:
        _sharded_steps(mesh, MESH_CASES, TRAIN_CASES, inp, out)
        _moe_expert_parallel_dtensor(mesh, out)
    finally:
        sharding.SITES = None
        sharding.set_active_mesh(None)
    return out


def case_groups(rank: int, world: int, inp: dict) -> dict:
    """1 x 4 (data, model), the head-group cases: as ``case_mesh``."""
    mesh = init_device_mesh("cpu", GROUP_MESH, mesh_dim_names=("data", "model"))
    out: dict = {}
    sharding.set_active_mesh(mesh, sharding.MeshAxes())
    try:
        _sharded_steps(mesh, GROUP_CASES, GROUP_TRAIN_CASES, inp, out)
    finally:
        sharding.SITES = None
        sharding.set_active_mesh(None)
    return out


# The multi-pod mesh's data axes, at 2 x 2 x 1 (pod, data, model): a weight
# whose rows lie cut over (pod, data), gathered by ``sharding.gathered`` (one
# all-gather over the flattened group) against DTensor's gather axis by axis;
# and the MoE's scatter path at a decode's token count and a prefill's (cap 1
# and 5, the buffers whole over the data axes), its experts' products on each
# rank's slice of d, against the whole weights.
POD_MESH = (2, 2, 1)
POD_MOE_CASES = {"b4_s1": (4, 1), "b4_s8": (4, 8)}


def pod_moe_cfg():
    """A reduced llama4 whose MoE (8 experts, top 1) takes the scatter path
    at any token count below the expert path's floor."""
    base = C.get_config("llama4_maverick_400b").reduced()
    return dataclasses.replace(base, moe=dataclasses.replace(base.moe, num_experts=8,
                                                             impl="shard_map"))


def case_pods(rank: int, world: int, inp: dict) -> dict:
    """2 x 2 x 1 (pod, data, model): ``POD_MESH``'s two checks."""
    mesh = init_device_mesh("cpu", POD_MESH, mesh_dim_names=("pod", "data", "model"))
    axes = sharding.MeshAxes(data=("pod", "data"))
    out: dict = {}
    sharding.set_active_mesh(mesh, axes)
    try:
        rows = [Shard(0), Shard(0), Replicate()]
        w, x = torch.from_numpy(inp["pods/w"]), torch.from_numpy(inp["pods/x"])
        # the two-step form first, before a flattened group exists
        for kind in ("two", "one"):
            wd = distribute_tensor(w, mesh, rows).requires_grad_(True)
            xd = distribute_tensor(x, mesh, rows)
            counter = cost.collective_counter()
            with (sharding._axis_by_axis() if kind == "two" else contextlib.nullcontext()):
                with counter:
                    wg = (wd.redistribute(mesh, [Replicate()] * 3) if kind == "two"
                          else sharding.gathered(wd))
                ((xd @ wg) ** 2).sum().full_tensor().backward()
            out[f"pods/{kind}/value"] = wg.to_local().detach().numpy()
            out[f"pods/{kind}/grad"] = wd.grad.to_local().numpy()
            out[f"pods/{kind}/log"] = np.array([f"{op}:{b}" for op, b in counter.log])

        cfg = pod_moe_cfg()
        p = {k: torch.from_numpy(inp[f"pods/moe/{k}"]) for k in ("router", "w_in", "w_gate",
                                                                 "w_out")}
        for name in POD_MOE_CASES:
            x = torch.from_numpy(inp[f"pods/moe/{name}/x"])
            for kind in ("plain", "dtensor"):
                if kind == "plain":
                    pin, xin = dict(p), x
                else:
                    pin = sharding.shard_params({"moe": p}, mesh, sharding.param_pspecs(
                        {"moe": p}, mesh, axes))["moe"]
                    xin = sharding.place_batch({"x": x}, mesh, axes)["x"]
                pin = {k: v.detach().requires_grad_(True) for k, v in pin.items()}
                xin = xin.detach().requires_grad_(True)
                counter = cost.collective_counter()
                with counter:
                    y, aux = moe.moe_apply(pin, cfg, xin)
                y, aux = _full(y), _full(aux)
                grads = torch.autograd.grad(y.sum() + aux, [*pin.values(), xin])
                pre = f"pods/moe/{name}/{kind}"
                out[f"{pre}/y"] = y.detach().numpy()
                for k, g in zip([*pin, "x"], grads):
                    out[f"{pre}/grad/{k}"] = _full(g).numpy()
                out[f"{pre}/log"] = np.array([f"{op}:{b}" for op, b in counter.log])
    finally:
        sharding.set_active_mesh(None)
    return out


def _scan_calls() -> tuple[list, object]:
    """(a list that each SSD kernel call on this rank appends its local
    shapes to, "x|h0|state" with h0 None from no state; the kernel wrapper
    to put back): ``ops._ssd_scan`` replaced by a spy."""
    from repro_torch.kernels import ops
    calls, real = [], ops._ssd_scan

    def spy(x, a, b, c, h0=None, **kw):
        y, h = real(x, a, b, c, h0, **kw)
        calls.append(f"{tuple(x.shape)}|{None if h0 is None else tuple(h0.shape)}|"
                     f"{tuple(h.shape)}")
        return y, h
    ops._ssd_scan = spy
    return calls, real


def _sharded_steps(mesh, serve_cases: dict, train_cases: dict, inp: dict, out: dict) -> None:
    """Each serving case's prefill, decode, cache and constraint sites (and
    each SSD kernel call's local shapes), and each train case's loss,
    gradients, sites and a train step's placements, on ``mesh``."""
    from repro_torch.kernels import ops
    for name, case in serve_cases.items():
        cfg = mesh_cfg(C, case)
        params = from_jax_params(unflatten(inp, f"{name}/params"), cfg, device="cpu")
        dp = sharding.shard_params(params, mesh, sharding.param_pspecs(params, mesh))
        batch = sharding.place_batch({"tokens": torch.from_numpy(inp[f"{name}/tokens"])},
                                     mesh)
        nxt = sharding.place_batch({"t": torch.from_numpy(inp[f"{name}/next"])}, mesh)["t"]
        sharding.SITES = []
        with torch.no_grad():
            calls, real = _scan_calls()
            try:
                logits, cache = transformer.prefill(dp, cfg, batch, max_len=MESH_T + MESH_EXTRA)
                out[f"{name}/scan/prefill"] = np.array(calls[:] or [""])
                calls.clear()
                out[f"{name}/prefill"] = logits.full_tensor().numpy()
                placed = [{k: tuple(map(str, v.placements)) for k, v in c.items()}
                          for c in cache]
                dl, cache = transformer.decode_step(dp, cfg, nxt, cache, MESH_T)
                out[f"{name}/scan/decode"] = np.array(calls[:] or [""])
            finally:
                ops._ssd_scan = real
            out[f"{name}/decode"] = dl.full_tensor().numpy()
            for l, c in enumerate(cache):
                for k, v in c.items():
                    assert tuple(map(str, v.placements)) == placed[l][k], (name, l, k)
                    out[f"{name}/cache/{l}/{k}"] = v.full_tensor().numpy()
                    out[f"{name}/cache_local/{l}/{k}"] = np.array(v.to_local().shape)
        out[f"{name}/sites"] = np.array(sorted({f"{s}|{g}|{loc}"
                                               for s, g, loc in sharding.SITES}))
        sharding.SITES = None
        if name in COUNTED and serve_cases is MESH_CASES:
            for kind in ("prefill", "decode"):
                out[f"{name}/coll/{kind}"] = _counted(cfg, params, kind, mesh)
        elif name in DECODE_COUNTED and serve_cases is MESH_CASES:
            out[f"{name}/coll/decode"] = _counted(cfg, params, "decode", mesh)

    for name, case in train_cases.items():
        cfg = mesh_cfg(C, case)
        params = from_jax_params(unflatten(inp, f"train/{name}/params"), cfg, device="cpu")
        dp = sharding.shard_params(params, mesh, sharding.param_pspecs(params, mesh))
        leaves = adamw.tree_leaves(dp)
        for t in leaves:
            t.requires_grad_(True)
        sharding.SITES = []
        loss, _ = transformer.loss_fn(dp, cfg, sharding.place_batch(
            {"tokens": torch.from_numpy(inp[f"train/{name}/tokens"])}, mesh), remat=True)
        grads = torch.autograd.grad(loss, leaves)
        for t in leaves:
            t.requires_grad_(False)
        out[f"train/{name}/sites"] = np.array(sorted({f"{s}|{g}|{loc}"
                                                     for s, g, loc in sharding.SITES}))
        sharding.SITES = None
        out[f"train/{name}/loss"] = loss.full_tensor().detach().numpy()
        for (path, p), (_, g) in zip(flat(dp), flat(adamw.tree_unflatten(dp, list(grads)))):
            g = sharding.like(g, p)
            out[f"train/{name}/placed/{path}"] = np.array(
                tuple(g.placements) == tuple(p.placements))
            out[f"train/{name}/grad/{path}"] = g.full_tensor().numpy()
        # the train step: params and AdamW's moments keep their placements
        opt = steps.init_opt_state(dp, steps.TrainConfig())
        new, opt, met = steps.make_train_step(cfg, steps.TrainConfig())(
            dp, opt, sharding.place_batch(
                {"tokens": torch.from_numpy(inp[f"train/{name}/tokens"])}, mesh))
        out[f"train/{name}/step_loss"] = met["loss"].full_tensor().numpy()
        out[f"train/{name}/step_placed"] = np.array(all(
            tuple(a.placements) == tuple(b.placements) == tuple(c.placements)
            for a, b, c in zip(adamw.tree_leaves(new), adamw.tree_leaves(opt["m"]),
                               adamw.tree_leaves(opt["v"]))))


# The DTensor expert path's cases: (experts, batch, sequence); 4 experts lie
# on model, 3 are padded to 4 and sliced, and a batch of 1 does not divide
# the data axis.
MOE_EP_CASES = {"e4_b4": (4, 4, 6), "e3_b4": (3, 4, 6), "e4_b1": (4, 1, 8)}


def _moe_expert_parallel_dtensor(mesh, out: dict) -> None:
    """The expert-parallel path on DTensor params and activations against
    the same path on whole plain tensors (held to the reference's
    ``shard_map`` in ``tests/test_torch_parallel.py``): y, aux, every
    gradient, and the all-gathers' result bytes beside the experts' whole
    bytes."""
    floor, moe.SHARD_MAP_MIN_TOKENS = moe.SHARD_MAP_MIN_TOKENS, 0
    try:
        for name, (E, B, S) in MOE_EP_CASES.items():
            base = C.get_config("granite_moe_3b").reduced(d_model=32, experts=4)
            cfg = dataclasses.replace(base, moe=dataclasses.replace(
                base.moe, num_experts=E, top_k=2, capacity_factor=1.0, impl="shard_map"))
            gen = torch.Generator().manual_seed(E * 10 + B)
            p = moe.moe_init(gen, cfg, torch.float32)
            x = torch.randn((B, S, cfg.d_model), generator=gen)
            res = {}
            for kind in ("plain", "dtensor"):
                if kind == "plain":
                    pin, xin = dict(p), x
                else:
                    pin = sharding.shard_params({"moe": p}, mesh, sharding.param_pspecs(
                        {"moe": p}, mesh))["moe"]
                    xin = sharding.place_batch({"x": x}, mesh)["x"]
                pin = {k: v.detach().requires_grad_(True) for k, v in pin.items()}
                xin = xin.detach().requires_grad_(True)
                counter = cost.collective_counter()
                with counter:
                    y, aux = moe.moe_apply(pin, cfg, xin)
                y, aux = _full(y), _full(aux)
                grads = torch.autograd.grad(y.sum() + aux, [*pin.values(), xin])
                res[kind] = counter.log
                out[f"moe_ep/{name}/{kind}/y"] = y.detach().numpy()
                out[f"moe_ep/{name}/{kind}/aux"] = aux.detach().numpy()
                for k, g in zip([*pin, "x"], grads):
                    out[f"moe_ep/{name}/{kind}/grad/{k}"] = _full(g).numpy()
            out[f"moe_ep/{name}/gathered"] = np.array(
                sum(b for op, b in res["dtensor"] if op == "all-gather"))
            out[f"moe_ep/{name}/experts_whole"] = np.array(
                sum(p[k].numel() * 4 for k in ("w_in", "w_gate", "w_out")))
            # a column's 2 experts of the padded 4, the router, and y's rows
            # where the batch lies whole
            out[f"moe_ep/{name}/gathered_want"] = np.array(
                sum(p[k][:2].numel() * 4 for k in ("w_in", "w_gate", "w_out"))
                + p["router"].numel() * 4 + (x.numel() * 4 if B % 2 else 0))
    finally:
        moe.SHARD_MAP_MIN_TOKENS = floor


def _counted(cfg, params: dict, kind: str, mesh) -> np.ndarray:
    """The collectives of the dry-run's step of ``kind`` at (MESH_B, MESH_T
    (+ MESH_EXTRA for decode)), run for real on this rank: its inputs of the
    dry-run's shapes (zeros; a decode's cache at ``init_cache``), placed as
    the dry-run places them, and the step as it runs it.  In order, as
    "op:bytes"."""
    S = MESH_T if kind == "prefill" else MESH_T + MESH_EXTRA
    shape = dryrun.ShapeConfig(f"mesh_{kind}", S, MESH_B, kind)
    with torch.inference_mode():
        dp = sharding.shard_params(params, mesh, sharding.param_pspecs(params, mesh))
        if kind == "prefill":
            specs = {"params": dp, "batch": sharding.place_batch(
                {"tokens": torch.zeros((MESH_B, S), dtype=torch.int32)}, mesh)}
        else:
            cache = transformer.init_cache(cfg, MESH_B, S, device="cpu")
            specs = {"params": dp, "tokens": sharding.place_batch(
                {"t": torch.zeros((MESH_B, 1), dtype=torch.int32)}, mesh)["t"],
                "cache": sharding.place_cache(cache, cfg.n_kv, mesh), "pos": S - 1}
        counter = cost.collective_counter()
        with counter:
            dryrun._step(cfg, shape, specs)
    return np.array([f"{op}:{b}" for op, b in counter.log])


def spawn(case: str, world: int, inputs: pathlib.Path, tmp: pathlib.Path) -> list:
    """Start ``world`` rank processes of ``case``; returns their Popen
    handles (see :func:`collect`)."""
    import os
    import subprocess
    out = tmp / f"{case}-out"
    out.mkdir()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    return [subprocess.Popen([sys.executable, __file__, case, str(r), str(world),
                              str(tmp / f"{case}-store"), str(inputs), str(out)],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
            for r in range(world)]


def collect(procs: list, tmp: pathlib.Path, case: str, timeout: float = 240) -> list[dict]:
    """Wait for the ranks; every rank's outputs, or an AssertionError with
    the failing ranks' stderr."""
    import subprocess
    errs = []
    for r, proc in enumerate(procs):
        try:
            _, err = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise AssertionError(f"{case}: rank {r} timed out after {timeout} s")
        if proc.returncode:
            errs.append(f"rank {r} exit {proc.returncode}:\n{err[-3000:]}")
    assert not errs, "\n".join(errs)
    outs = []
    for r in range(len(procs)):
        with np.load(tmp / f"{case}-out" / f"rank{r}.npz") as f:
            outs.append(dict(f))
    return outs


CASES = {"parallel": case_parallel, "engine_ckpt": case_engine_ckpt, "mesh": case_mesh,
         "groups": case_groups, "pods": case_pods, "pipeline4": case_pipeline4,
         "pipeline2": case_pipeline2}


def main() -> int:
    case, rank, world, store, inputs, out_dir = sys.argv[1:]
    rank, world = int(rank), int(world)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    try:
        with np.load(inputs) as f:
            inp = dict(f)
        res = CASES[case](rank, world, inp)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    np.savez(pathlib.Path(out_dir) / f"rank{rank}.npz", **res)
    return 0


if __name__ == "__main__":
    sys.exit(main())
