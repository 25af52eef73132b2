"""Link traffic a device: the reference's counted whole, against the port's.

The reference's record (``repro.launch.dryrun.collective_bytes``) scans its
compiled HLO once, so a collective inside the scanned layer loop counts
once, not once a layer.  ``tests/ref_hlo_shards.py::whole_collectives``
counts each ``while`` body times its known trip count (nested loops
multiplied), every ``conditional`` branch and called computation, and
refuses a loop with no known trip count; it is held here on hand-written
HLO, then run on reduced cells of the reference in a JAX subprocess on 512
forced host devices.  The port's dry-run trace of the same cells on a fake
group of the cell's production mesh (rank 0's program, the card's
collectives: a Shard -> Shard redistribution as one all-to-all) moves no
more than the limits below, and no cell all-gathers the whole embedding
table.
"""

import contextlib
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from torch.distributed.tensor import DTensor, Shard

from repro_torch import configs as TC
from repro_torch.configs.base import SHAPES, production_cfg
from repro_torch.kernels import cost
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as M

ROOT = pathlib.Path(__file__).resolve().parents[1]

LINKS_SCRIPT = r'''
import json, sys
sys.path.insert(0, sys.argv[1])
import ref_hlo_shards as R   # forces 512 host devices before jax starts

job = json.load(open(sys.argv[2]))
out = {"texts": {}, "cells": {}}
for name, text in job["texts"].items():
    try:
        res = R.whole_collectives(text)
        res.pop("items")
    except ValueError as e:
        res = {"error": str(e)}
    out["texts"][name] = res
for key in job["cells"]:
    arch, shape, mesh, layers = key.split("/")
    res = R.whole_collectives(R.compiled_text(arch, shape, mesh == "multi", int(layers)))
    res.pop("items")
    out["cells"][key] = res
json.dump(out, open(sys.argv[3], "w"))
'''

# a nested loop: the outer body (3 trips) all-gathers f32[4,8] and runs an
# inner loop (5 trips) whose body all-reduces bf16[16]; the entry
# reduce-scatters f32[2] once
NESTED = """HloModule nested

%inner_body (p: (s32[], bf16[16])) -> (s32[], bf16[16]) {
  %p = (s32[], bf16[16]{0}) parameter(0)
  %x = bf16[16]{0} get-tuple-element(%p), index=1
  %ar = bf16[16]{0} all-reduce(%x), channel_id=1, replica_groups={}, to_apply=%add
  ROOT %t = (s32[], bf16[16]{0}) tuple(%i, %ar)
}

%inner_cond (p: (s32[], bf16[16])) -> pred[] {
  ROOT %lt = pred[] compare(%a, %b), direction=LT
}

%outer_body (p: (s32[], f32[4,8])) -> (s32[], f32[4,8]) {
  %ag = f32[4,8]{1,0} all-gather(%y), channel_id=2, dimensions={0}
  %w = (s32[], bf16[16]{0}) while(%t0), condition=%inner_cond, body=%inner_body, TRIP_5
  ROOT %t = (s32[], f32[4,8]{1,0}) tuple(%i, %ag)
}

%outer_cond (p: (s32[], f32[4,8])) -> pred[] {
  ROOT %lt = pred[] compare(%a, %b), direction=LT
}

ENTRY %main (a: f32[8]) -> f32[2] {
  %w = (s32[], f32[4,8]{1,0}) while(%t0), condition=%outer_cond, body=%outer_body, TRIP_3
  ROOT %rs = f32[2]{0} reduce-scatter(%a), channel_id=3, dimensions={0}, to_apply=%add
}
""".replace("TRIP_5", 'backend_config={"known_trip_count":{"n":"5"},'
                      '"known_init_step":{"init":"0","step":"1"}}').replace(
    "TRIP_3", 'backend_config={"known_trip_count":{"n":"3"}}')

# a conditional's two branches (one collective-permute each), a fusion that
# calls a computation holding an all-to-all, and a tuple-shaped all-reduce
BRANCHES = """HloModule branches

%branch_a (p: f32[6]) -> f32[6] {
  ROOT %cp = f32[6]{0} collective-permute(%p), channel_id=1, source_target_pairs={{0,1}}
}

%branch_b (p: f32[6]) -> f32[6] {
  ROOT %cp = f32[6]{0} collective-permute(%p), channel_id=2, source_target_pairs={{1,0}}
}

%fused (p: s32[10]) -> s32[10] {
  ROOT %a2a = s32[10]{0} all-to-all(%p), channel_id=3, dimensions={0}
}

ENTRY %main (a: f32[6], b: s32[10], c: f32[3]) -> f32[6] {
  %c = f32[6]{0} conditional(%i, %a, %a), branch_computations={%branch_a, %branch_b}
  %f = s32[10]{0} fusion(%b), kind=kLoop, calls=%fused
  %ar = (f32[3]{0}, bf16[4]{0}) all-reduce(%c, %d), channel_id=4, to_apply=%add
  ROOT %r = f32[6]{0} add(%c, %c)
}
"""

UNKNOWN = """HloModule unknown

%body (p: f32[4]) -> f32[4] {
  ROOT %ag = f32[4]{0} all-gather(%p), channel_id=1, dimensions={0}
}

%cond (p: f32[4]) -> pred[] {
  ROOT %lt = pred[] compare(%a, %b), direction=LT
}

ENTRY %main (a: f32[4]) -> f32[4] {
  ROOT %w = f32[4]{0} while(%a), condition=%cond, body=%body
}
"""

# cells cut in depth, each with the port's limit against the reference's
# whole count, on (16, 16) ("single") unless the key names "multi", (2, 16,
# 16): internlm2 (8 kv heads on 16 model ranks, so its attention runs by
# rows, ``ref._row_shard``), minicpm3's MLA decode, llama4's decode (its
# experts' products on each rank's slice of d) and xlstm's long_500k (the
# mLSTM's decode on each rank's k rows of the state), at 2 layers, xlstm at
# one pattern period
LAYERS = {"xlstm_1p3b": 8}
LIMITS = {"internlm2_1p8b/decode_32k": 1.0, "internlm2_1p8b/prefill_32k": 1.25,
          "internlm2_1p8b/train_4k": 1.25, "minicpm3_4b/decode_32k": 1.25,
          "llama4_maverick_400b/decode_32k": 1.25, "llama4_maverick_400b/decode_32k/multi": 1.25,
          "xlstm_1p3b/long_500k": 1.25, "xlstm_1p3b/long_500k/multi": 1.25}


def _cell(key: str) -> tuple[str, str, str, int]:
    """A ``LIMITS`` key's (arch, shape, mesh, layers)."""
    arch, shape, *mesh = key.split("/")
    return arch, shape, mesh[0] if mesh else "single", LAYERS.get(arch, 2)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's whole counts: of the hand-written texts, and of the
    cells cut in depth compiled on their production mesh."""
    tmp = tmp_path_factory.mktemp("links")
    job = {"texts": {"nested": NESTED, "branches": BRANCHES, "unknown": UNKNOWN},
           "cells": ["/".join(map(str, _cell(key))) for key in LIMITS]}
    (tmp / "job.json").write_text(json.dumps(job))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    r = subprocess.run([sys.executable, "-c", LINKS_SCRIPT, str(ROOT / "tests"),
                        str(tmp / "job.json"), str(tmp / "out.json")],
                       env=env, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads((tmp / "out.json").read_text())


def test_whole_count_multiplies_nested_loops_by_their_trip_counts(reference):
    res = reference["texts"]["nested"]
    assert res["all-gather"] == 3 * 4 * 8 * 4
    assert res["all-reduce"] == 3 * 5 * 16 * 2
    assert res["reduce-scatter"] == 2 * 4
    assert res["count"] == 3 + 15 + 1
    assert res["weighted_link_traffic"] == 3 * 128 + 2.0 * 15 * 32 + 8
    # the text scanned once: each instruction once, as the reference's record
    assert res["once"] == res["regex"] == 128 + 2.0 * 32 + 8


def test_conditional_branches_fusion_calls_and_tuple_results_are_counted(reference):
    res = reference["texts"]["branches"]
    assert res["collective-permute"] == 2 * 6 * 4
    assert res["all-to-all"] == 10 * 4
    assert res["all-reduce"] == 3 * 4 + 4 * 2
    assert res["tuples"] == 2.0 * (3 * 4 + 4 * 2)
    assert res["count"] == 4
    # the reference's regex skips the tuple-shaped all-reduce
    assert res["regex"] == res["weighted_link_traffic"] - res["tuples"]


def test_a_loop_with_no_known_trip_count_raises(reference):
    assert "no known trip count" in reference["texts"]["unknown"].get("error", "")


def test_shard_to_shard_redistribution_is_one_all_to_all_of_the_local_bytes():
    """On a 4-rank fake CPU mesh a Shard(0) -> Shard(1) redistribution is
    traced as the card runs it, one all-to-all of the rank's local bytes;
    gloo's program (the trace's ``mesh_device="cpu"``) all-gathers 4 x
    those bytes, then keeps its chunk."""
    logs = {}
    for card in (True, False):
        with M.fake_mesh((4,), ("model",), "cpu") as mesh:
            local = torch.empty(8, 12, device="meta")
            x = DTensor.from_local(local, mesh, [Shard(0)], run_check=False, shape=(32, 12),
                                   stride=(12, 1))
            mode = D.Trace(x)
            with (D._card_alltoall() if card else contextlib.nullcontext()), mode:
                y = x.redistribute(mesh, [Shard(1)])
            assert tuple(y.to_local().shape) == (32, 3)
            logs[card] = mode.coll_log
    assert logs[True] == [("all-to-all", 8 * 12 * 4)]
    assert logs[False] == [("all-gather", 4 * 8 * 12 * 4)]


def test_a_weight_cut_over_pod_and_data_is_gathered_in_one_all_gather():
    """On a (2, 4, 2) fake (pod, data, model) mesh, ``sharding.gathered`` of
    a weight (32, 24) whose rows lie on (pod, data) and columns on model is
    traced as one all-gather over the flattened (pod, data) group, of the
    rank's whole rows of its columns (32 x 12 f32); DTensor's own
    redistribution gathers over data, then pod (the pod's half, then the
    whole: 1.5 x the bytes)."""
    from torch.distributed.tensor import Replicate

    from repro_torch.parallel import sharding
    logs = {}
    for kind in ("gathered", "redistribute"):
        with M.fake_mesh((2, 4, 2), ("pod", "data", "model"), "cpu") as mesh:
            sharding.set_active_mesh(mesh, sharding.MeshAxes(data=("pod", "data")))
            try:
                local = torch.empty(4, 12, device="meta")
                w = DTensor.from_local(local, mesh, [Shard(0), Shard(0), Shard(1)],
                                       run_check=False, shape=(32, 24), stride=(24, 1))
                mode = D.Trace(w)
                with mode:
                    g = (sharding.gathered(w) if kind == "gathered" else
                         w.redistribute(mesh, [Replicate(), Replicate(), Shard(1)]))
            finally:
                sharding.set_active_mesh(None)
            assert tuple(g.to_local().shape) == (32, 12)
            assert tuple(g.placements) == (Replicate(), Replicate(), Shard(1))
            logs[kind] = mode.coll_log
    assert logs["gathered"] == [("all-gather", 32 * 12 * 4)]
    assert logs["redistribute"] == [("all-gather", 16 * 12 * 4), ("all-gather", 32 * 12 * 4)]


def _cfg(arch: str, layers: int):
    cfg = production_cfg(TC.get_config(arch))
    return dataclasses.replace(cfg, n_layers=layers)


def _table_gathers(cfg, res: dict) -> list:
    table = cfg.vocab_padded * cfg.d_model * 2
    return [b for op, b in res["coll_log"] if op == "all-gather" and b == table]


@pytest.mark.parametrize("arch", TC.ARCH_IDS)
def test_no_decode_gathers_the_whole_embedding_table(arch):
    """Rank 0's decode_32k on (16, 16), one pattern period deep: the lookup
    runs on the rank's vocab slice of the table (gathered over the data
    axes only), so no collective moves the whole table."""
    cfg = production_cfg(TC.get_config(arch))
    cfg = dataclasses.replace(cfg, n_layers=len(cfg.block_pattern))
    shape = SHAPES["decode_32k"]
    res = D.trace(cfg, shape, shape.global_batch, mesh_name="single")
    assert res["collectives"]["count"] > 0
    assert _table_gathers(cfg, res) == []


@pytest.mark.parametrize("cell", list(LIMITS))
def test_reduced_cell_moves_no_more_than_the_references_whole_count(cell, reference):
    """The port's weighted link bytes a device of rank 0's program on a fake
    group of the cell's production mesh, cut in depth (``_cell``), within
    ``LIMITS`` x the reference's whole count of the same cell; no collective
    moves the whole embedding table, and none the global batch's k (the
    row-sharded attention gathers k and v over ``model`` only, at the data
    rank's own sequences)."""
    arch, shape_name, mesh, layers = _cell(cell)
    cfg, shape = _cfg(arch, layers), SHAPES[shape_name]
    res = D.trace(cfg, shape, shape.global_batch, mesh_name=mesh)
    port = cost.collectives_record(res["collectives"],
                                   res["collectives"]["count"])["weighted_link_traffic"]
    ref_whole = reference["cells"][f"{arch}/{shape_name}/{mesh}/{layers}"][
        "weighted_link_traffic"]
    assert 0 < port <= LIMITS[cell] * ref_whole, (cell, port, ref_whole)
    assert _table_gathers(cfg, res) == []
    k_global = shape.global_batch * shape.seq_len * cfg.n_kv * cfg.hd * 2
    assert max(b for _, b in res["coll_log"]) < k_global
