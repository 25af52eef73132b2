"""The port's dry-run (``repro_torch.launch.dryrun``) and the kernel
wrappers' meta branches, against the reference on the CPU.

The layout of every supported (arch, shape) cell on both production meshes
is held leaf by leaf and byte for byte to the reference's, computed fresh by
a JAX subprocess on 512 forced host devices (``input_specs``,
``shardings_for``, ``shard_shape``; nothing compiled, the committed
artifacts not read).  Each meta branch gives the plain version's output
shapes and dtypes with no launch and no plain call, and its work from
``kernels/cost.py``; a reduced model's traced FLOPs equal the analytic count;
every reduced arch traces, with rank 0's per-device record of the sharded
step on (16, 16); a device's FLOPs times the chips are internlm2's step
within 1 % where every sharded dim divides; xLSTM's length solve and the
batch solve equal traces they did not run.
"""

import dataclasses
import functools
import math
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import repro_torch.kernels.decode_attention as DA
import repro_torch.kernels.flash_attention as FA
import repro_torch.kernels.rmsnorm as RN
import repro_torch.kernels.ssm_scan as SS
from repro_torch import configs as TC
from repro_torch.configs.base import MLAConfig, ShapeConfig, production_cfg
from repro_torch.kernels import cost, ref
from repro_torch.kernels.chunked import ssd_scan_chunked
from repro_torch.launch import dryrun as D
from repro_torch.models import transformer
from repro_torch.parallel import sharding as TS

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF_SCRIPT = r'''
import json, sys
from repro.launch import dryrun as D   # forces 512 host devices before jax starts
from repro import configs as C
from repro.configs.base import SHAPES
from repro.launch.mesh import make_production_mesh

meshes = {"single": make_production_mesh(multi_pod=False),
          "multi": make_production_mesh(multi_pod=True)}

def walk(spec, shard, path, acc):
    if isinstance(spec, dict):
        for k in spec:
            walk(spec[k], shard[k], f"{path}/{k}" if path else k, acc)
    elif isinstance(spec, (list, tuple)):
        for i, (a, b) in enumerate(zip(spec, shard)):
            walk(a, b, f"{path}/{i}", acc)
    else:
        acc[path] = [list(shard.shard_shape(tuple(spec.shape))), spec.dtype.itemsize]

out = {}
for arch in C.ARCH_IDS:
    cfg = D.production_cfg(C.get_config(arch))
    for name, shape in SHAPES.items():
        if not D.cell_supported(cfg, shape)[0]:
            continue
        specs = D.input_specs(cfg, shape)
        for mesh_name, mesh in meshes.items():
            acc = {}
            walk(specs, D.shardings_for(cfg, shape, mesh, specs), "", acc)
            out[f"{arch}__{name}__{mesh_name}"] = acc
json.dump(out, open(sys.argv[1], "w"))
'''


@pytest.fixture(scope="module")
def reference_layout(tmp_path_factory):
    """{arch__shape__mesh: {path: (per-device shape, itemsize)}} from the
    reference, computed now."""
    out = tmp_path_factory.mktemp("ref") / "layout.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    r = subprocess.run([sys.executable, "-c", REF_SCRIPT, str(out)], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    import json
    return json.loads(out.read_text())


def _ref_path(path: str, period: int) -> tuple[str, bool]:
    """The reference's leaf for a port leaf, and whether it is stacked: a
    layer l of ``blocks`` or of the cache is the stacked leaf of pattern
    position l % period, and an MLA layer's ``{"latent": array}`` is the
    reference's bare array."""
    parts = path.split("/")
    for i, p in enumerate(parts[:-1]):
        if p in ("blocks", "cache") and parts[i + 1].isdigit():
            parts[i + 1] = str(int(parts[i + 1]) % period)
            if p == "cache" and parts[-1] == "latent":
                parts.pop()
            return "/".join(parts), True
    return path, False


@pytest.mark.parametrize("mesh_name", ["single", "multi"])
@pytest.mark.parametrize("arch", TC.ARCH_IDS)
def test_layout_equals_the_references_leaf_by_leaf(arch, mesh_name, reference_layout):
    """Every supported cell: each leaf's per-device shape (a layer's leaf the
    stacked leaf's less its group axis) and the total bytes, exactly."""
    cfg = production_cfg(TC.get_config(arch))
    period = len(cfg.block_pattern)
    params = transformer.param_shapes(cfg)
    n_cells = 0
    for name, shape in TC.SHAPES.items():
        key = f"{arch}__{name}__{mesh_name}"
        if not D.cell_supported(cfg, shape)[0]:
            assert key not in reference_layout
            continue
        n_cells += 1
        want = reference_layout[key]
        specs = D.input_specs(cfg, shape, params=params)
        seen = set()
        for path, local, es in D.local_leaves(cfg, shape, mesh_name, specs):
            rp, stacked = _ref_path(path, period)
            shp, ref_es = want[rp]
            assert list(local) == (shp[1:] if stacked else shp), (key, path, local, shp)
            assert es == ref_es, (key, path)
            seen.add(rp)
        assert seen == set(want), (key, set(want) ^ seen)
        total = sum(math.prod(s) * e for s, e in want.values())
        got = D.layout(cfg, shape, mesh_name, specs)
        assert got["argument_size_in_bytes"] == total, (key, got, total)
    assert n_cells == (4 if cfg.subquadratic else 3)


# ---------------------------------------------------------------------------
# (b) the meta branches
# ---------------------------------------------------------------------------

def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def cpu(*shape, dtype=torch.float32):
    return torch.randn(shape, generator=torch.Generator().manual_seed(0)).to(dtype)


@pytest.fixture
def no_plain(monkeypatch):
    """Every wrapper's plain version replaced by one that fails, and the
    launch counts as they were before."""
    def refuse(*a, **k):
        raise AssertionError("a meta branch ran the plain version")
    for mod, names in ((FA, ("plain", "plain_bwd")), (DA, ("plain",)),
                       (SS, ("plain", "plain_bwd")), (RN, ("plain", "plain_bwd"))):
        for n in names:
            monkeypatch.setattr(mod, n, refuse)
    counts = {f: f.n_launches for f in (FA.flash_attention, FA.flash_attention_bwd,
                                        DA.decode_attention, SS.ssd_scan, SS.ssd_scan_bwd,
                                        RN.rmsnorm, RN.rmsnorm_bwd)}
    yield
    assert {f: f.n_launches for f in counts} == counts


def recorded(fn):
    """fn() under the dry-run's trace: (its result, the trace)."""
    mode = D.Trace(())
    with mode:
        out = fn()
    return out, mode


DTYPES = (torch.float32, torch.bfloat16)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dk,dv", FA.HEAD_DIMS)
def test_flash_meta_branch(dk, dv, dtype, no_plain):
    for B, sq, skv, hq, hkv, window, off in ((2, 16, 16, 4, 2, None, 0), (1, 5, 12, 6, 3, 4, 7),
                                             (3, 33, 33, 8, 8, 8, 0)):
        shp = ((B, sq, hq, dk), (B, skv, hkv, dk), (B, skv, hkv, dv))
        kw = dict(causal=True, window=window, kv_offset=off)
        o, mode = recorded(lambda: FA.flash_attention(*(meta(*s, dtype=dtype) for s in shp),
                                                      **kw))
        want = ref.attention(*(cpu(*s, dtype=dtype) for s in shp), **kw)
        assert o.device.type == "meta" and o.shape == want.shape and o.dtype == want.dtype
        work = cost.flash_attention(B, sq, skv, hq, hkv, dk, dv, o.element_size(), True,
                                    window, off)
        assert mode.kernel_calls == {"flash_attention": 1}
        assert mode.flops_by["flash_attention"] == work.flops and mode.hbm_bytes == work.bytes
    # under autograd: the Function's forward, then the backward's meta branch
    q = meta(1, 8, 2, dk, dtype=dtype).requires_grad_(True)
    k, v = meta(1, 8, 2, dk, dtype=dtype), meta(1, 8, 2, dv, dtype=dtype)

    def fwd_bwd():
        o = FA.flash_attention(q, k, v)
        return o, torch.autograd.grad(o, (q,), torch.empty_like(o))[0]
    (o, dq), mode = recorded(fwd_bwd)
    assert o.shape == (1, 8, 2, dv) and dq.shape == q.shape and dq.dtype == dtype and dq.is_meta
    assert mode.kernel_calls == {"flash_attention": 1, "flash_attention_bwd": 1}
    assert mode.flops_by["flash_attention_bwd"] == cost.flash_attention_bwd(
        1, 8, 8, 2, 2, dk, dv, q.element_size(), True, None, 0).flops


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dk,dv", DA.HEAD_DIMS)
def test_decode_meta_branch(dk, dv, dtype, no_plain):
    for B, hq, hkv, smax, length in ((2, 4, 2, 64, 40), (3, 8, 1, 4096, 4096),
                                     (1, 5, 1, 100, torch.tensor([7]))):
        shp = ((B, hq, dk), (B, smax, hkv, dk), (B, smax, hkv, dv))
        o, mode = recorded(lambda: DA.decode_attention(
            *(meta(*s, dtype=dtype) for s in shp),
            length if isinstance(length, int) else length.to("meta")))
        want = ref.decode_attention(*(cpu(*s, dtype=dtype) for s in shp), length)
        assert o.device.type == "meta" and o.shape == want.shape and o.dtype == want.dtype
        # a tensor of lengths is not read on the host: every slot counts
        valid = smax if isinstance(length, torch.Tensor) else length
        work = cost.decode_attention(B, hq, hkv, dk, dv, valid, o.element_size())
        assert mode.kernel_calls == {"decode_attention": 1}
        assert mode.flops_by["decode_attention"] == work.flops
        if isinstance(length, int):  # (a tensor's cast to int32 is an aten op, counted too)
            assert mode.hbm_bytes == work.bytes
    q = meta(1, 2, dk, dtype=dtype).requires_grad_(True)
    with pytest.raises(NotImplementedError, match="decode_attention"):
        DA.decode_attention(q, meta(1, 8, 2, dk, dtype=dtype), meta(1, 8, 2, dv, dtype=dtype), 4)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows,d", [(4, 64), (4096, 2048), (6, 3200), (3, 120)])
def test_rmsnorm_meta_branch_and_its_backward(rows, d, dtype, no_plain):
    y, mode = recorded(lambda: RN.rmsnorm(meta(rows, d, dtype=dtype), meta(d, dtype=dtype)))
    want = ref.rmsnorm(cpu(rows, d, dtype=dtype), cpu(d, dtype=dtype))
    assert y.device.type == "meta" and y.shape == want.shape and y.dtype == want.dtype
    es = torch.finfo(dtype).bits // 8
    assert mode.kernel_calls == {"rmsnorm": 1}
    assert mode.flops_by["rmsnorm"] == cost.rmsnorm(rows, d, es, es).flops
    # a grad-requiring input: the forward under its autograd Function, whose
    # backward reaches the backward kernel's meta branch
    x, s = meta(rows, d, dtype=dtype).requires_grad_(True), meta(d, dtype=dtype)
    s.requires_grad_(True)

    def step():
        out = RN.rmsnorm(x, s)
        return torch.autograd.grad(out, (x, s), meta(rows, d, dtype=dtype))

    (dx, ds), mode = recorded(step)
    assert dx.shape == x.shape and ds.shape == s.shape and dx.dtype == dtype
    assert mode.kernel_calls == {"rmsnorm": 1, "rmsnorm_bwd": 1}
    assert mode.flops_by["rmsnorm_bwd"] == cost.rmsnorm_bwd(rows, d, es, es).flops
    dxp, dsp = ref.rmsnorm_bwd(cpu(rows, d, dtype=dtype), cpu(d, dtype=dtype),
                               cpu(rows, d, dtype=dtype))
    assert (dx.shape, dx.dtype, ds.dtype) == (dxp.shape, dxp.dtype, dsp.dtype)


@pytest.mark.parametrize("S,with_h0", [(1, True), (1, False), (40, False), (64, True)])
def test_ssd_meta_branch(S, with_h0, no_plain):
    B, H, P, N, chunk = 2, 3, 64, 16, 16
    shapes = ((B, S, H, P), (B, S, H), (B, S, H, N), (B, S, H, N), (B, H, P, N))
    dts = (torch.bfloat16, torch.float32, torch.float32, torch.bfloat16, torch.float32)
    args = [meta(*s, dtype=dt) for s, dt in zip(shapes, dts)]
    if not with_h0:
        args[-1] = None
    (y, h), mode = recorded(lambda: SS.ssd_scan(*args, chunk=chunk))
    cargs = [cpu(*s, dtype=dt) for s, dt in zip(shapes, dts)]
    cargs[1] = torch.rand(shapes[1], generator=torch.Generator().manual_seed(1))
    if not with_h0:
        cargs[-1] = None
    wy, wh = ssd_scan_chunked(*cargs, chunk=chunk)
    assert (y.shape, y.dtype, h.shape, h.dtype) == (wy.shape, wy.dtype, wh.shape, wh.dtype)
    assert y.device.type == "meta"
    work = cost.ssd_scan(B, S, H, P, N, chunk, 2, 4, 4, 2, 4 if with_h0 else 0)
    assert mode.kernel_calls == {"ssd_scan": 1}
    assert mode.flops_by["ssd_scan"] == work.flops and mode.hbm_bytes == work.bytes
    # under autograd the backward's meta branch records its own work
    grad_in = [meta(*s, dtype=dt) for s, dt in zip(shapes, dts)]
    if not with_h0:
        grad_in[-1] = None
    grad_in[0].requires_grad_(True)

    def fwd_bwd():
        y, _ = SS.ssd_scan(*grad_in, chunk=chunk)
        return torch.autograd.grad(y, grad_in[0], torch.empty_like(y))[0]
    dx, mode = recorded(fwd_bwd)
    assert dx.shape == grad_in[0].shape and dx.dtype == torch.bfloat16 and dx.is_meta
    assert mode.kernel_calls == {"ssd_scan": 1, "ssd_scan_bwd": 1}
    bwd = cost.ssd_scan_bwd(B, S, H, P, N, chunk, 2, 4, 4, 2, 4 if with_h0 else 0, 0)
    assert mode.flops_by["ssd_scan_bwd"] == bwd.flops


def test_cost_formulas_are_the_chip_records():
    """``chip_smoke.py``'s bound columns at the served shapes read these
    formulas; the pair count is the causal and windowed mask's own."""
    for sq, skv, causal, window, off in ((1024, 1024, True, None, 0), (4608, 4608, True, 4096, 0),
                                         (5, 12, True, 4, 7), (9, 9, False, None, 0)):
        i = torch.arange(sq)[:, None] + off
        k = torch.arange(skv)[None, :]
        mask = torch.ones(sq, skv, dtype=torch.bool)
        if causal:
            mask &= k <= i
        if window is not None:
            mask &= k > i - window
        assert cost.attention_pairs(sq, skv, causal, window, off) == int(mask.sum())
    # internlm2's prefill record: 17.39 us of operations (PERF.md row 2)
    w = cost.flash_attention(4, 1024, 1024, 16, 8, 128, 128, 2)
    assert round(w.flops / cost.PEAK_BF16 * 1e6, 2) == 17.39
    # rmsnorm at (4096, 2048) bf16: 10.02 us of bytes (row 1)
    assert round(cost.rmsnorm(4096, 2048, 2, 2).bytes / cost.PEAK_BYTES * 1e6, 2) == 10.02


# ---------------------------------------------------------------------------
# (c)-(f) traces of reduced models
# ---------------------------------------------------------------------------

def reduced(arch: str, **kw):
    """A ModelConfig -> ModelConfig hook: ``arch`` reduced to 2 layers (one
    pattern period for xLSTM) at widths every kernel instantiates (heads of
    32; MLA's (96, 64)), in bf16."""
    def hook(c):
        base = TC.get_config(arch)
        r = base.reduced(n_layers=8 if len(base.block_pattern) == 8 else 2, d_model=128,
                         n_heads=4, **kw)
        if r.mla is not None:
            r = dataclasses.replace(r, mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                                                     qk_nope_head_dim=64, qk_rope_head_dim=32,
                                                     v_head_dim=64))
        return production_cfg(r)
    return hook


SMALL = {"train": ShapeConfig("train_small", 32, 2, "train"),
         "prefill": ShapeConfig("prefill_small", 48, 2, "prefill"),
         "decode": ShapeConfig("decode_small", 64, 2, "decode")}


@pytest.mark.parametrize("arch", ["internlm2_1p8b", "granite_moe_3b"])
def test_traced_forward_flops_equal_the_analytic_count(arch):
    """Prefill's FLOPs: 2 x each matmul's parameters x its tokens (the head
    at the last position only), the einsum MoE's combine (2 T E d), and
    2 H (DK + DV) a causal pair and query head in flash attention."""
    cfg = reduced(arch)(None)
    B, S = 3, 40
    res = D.trace(cfg, ShapeConfig("p", S, B, "prefill"), B)
    d, hq, hkv, hd, f, T = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd, cfg.d_ff, B * S
    attn = d * (hq + 2 * hkv) * hd + hq * hd * d
    if cfg.moe is None:
        layer = 2 * (attn + 3 * d * f) * T
    else:
        E = cfg.moe.num_experts
        layer = 2 * (attn + d * E + 3 * E * d * f) * T + 2 * T * E * d
    head = 2 * d * cfg.vocab_padded * B
    pairs = S * (S + 1) // 2
    want = cfg.n_layers * (layer + 2 * hq * (hd + hd) * pairs * B) + head
    assert res["flops_by"]["matmul"] + res["flops_by"]["flash_attention"] == want
    assert res["kernel_calls"]["flash_attention"] == cfg.n_layers


def _scatter_moe(hook):
    def h(c):
        cfg = hook(c)
        return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, impl="scatter"))
    return h


CELLS = [(a, reduced(a)) for a in TC.ARCH_IDS] + [("granite_moe_3b",
                                                  _scatter_moe(reduced("granite_moe_3b")))]


@functools.lru_cache(maxsize=None)
def _reduced_record(i: int, kind: str) -> dict:
    arch, hook = CELLS[i]
    return D.run_cell(arch, SMALL[kind], False, save=False, verbose=False, cfg_transform=hook)


CELL_IDS = [a for a in TC.ARCH_IDS] + ["granite_scatter"]


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
@pytest.mark.parametrize("arch,hook", CELLS, ids=CELL_IDS)
def test_every_reduced_arch_traces(arch, hook, kind):
    """prefill, decode and train trace with status ok, train through the
    backward kernels' meta branches (RMSNorm's, flash attention's and, in a
    hybrid model, the SSD scan's)."""
    rec = _reduced_record(CELLS.index((arch, hook)), kind)
    assert rec["layout"]["argument_size_in_bytes"] > 0
    assert rec["status"] == "ok", rec.get("traceback")
    calls = rec["work"]["kernel_calls"]
    cfg = hook(None)
    assert calls["rmsnorm"] > 0 and rec["work"]["flops"] > 0
    attn = "attn" in cfg.block_pattern or "hybrid" in cfg.block_pattern
    # remat: each layer's forward kernels run again in the backward pass
    runs = {"prefill": 1, "train": 2}.get(kind, 0)
    assert calls["flash_attention"] == (runs * cfg.n_layers if attn else 0)
    assert calls["flash_attention_bwd"] == (cfg.n_layers if attn and kind == "train" else 0)
    assert calls["decode_attention"] == (cfg.n_layers if attn and kind == "decode" else 0)
    scan = "hybrid" in cfg.block_pattern or "mamba" in cfg.block_pattern
    assert calls["ssd_scan"] == (max(runs, 1) * cfg.n_layers if scan else 0)
    assert calls["ssd_scan_bwd"] == (cfg.n_layers if scan and kind == "train" else 0)
    if kind == "train":  # every layer's norms again in the backward pass
        # MLA: norm_q, norm_kv; a hybrid block: the SSM's gated norm
        norms = (4 if cfg.mla is not None else 3 if scan else 2) * cfg.n_layers
        assert (calls["rmsnorm"], calls["rmsnorm_bwd"]) == (2 * norms + 1, norms + 1)
    else:
        assert calls["rmsnorm_bwd"] == 0
    oc = rec["one_card"]
    assert oc["fits"] and oc["max_batch"] >= SMALL[kind].global_batch


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
@pytest.mark.parametrize("i", range(len(CELLS)), ids=CELL_IDS)
def test_every_reduced_record_has_the_per_device_fields(i, kind):
    """Each ok record carries rank 0's program on the (16, 16) mesh under the
    reference's names: flops_per_partition and bytes_per_partition, memory
    (its argument bytes equal to the layout's for the device), and
    collectives with the reference's link weights; the FLOPs of a device
    times the chips are at least the step's, and a device does no more than
    the whole step (DTensor's sharding propagation, which runs ops at their
    global shapes, would: see the next tests); no ``collectives_reason``."""
    rec = _reduced_record(i, kind)
    assert "collectives_reason" not in rec
    if rec["status"] != "ok":
        assert kind == "train" and "collectives" not in rec
        return
    assert rec["flops_per_partition"] > 0 and rec["bytes_per_partition"] > 0
    assert rec["work"]["flops"] <= rec["flops_per_partition"] * rec["chips"]
    assert rec["flops_per_partition"] <= rec["work"]["flops"]   # no rank does more
    mem = rec["memory"]
    assert set(mem) >= {"argument_size_in_bytes", "output_size_in_bytes", "temp_size_in_bytes",
                        "peak_memory_in_bytes"}
    assert mem["argument_size_in_bytes"] == rec["layout"]["argument_size_in_bytes"]
    assert mem["peak_memory_in_bytes"] >= mem["argument_size_in_bytes"]
    c = rec["collectives"]
    assert c["count"] > 0
    assert c["weighted_link_traffic"] == sum(cost.TRAFFIC_W[op] * c[op] for op in cost.TRAFFIC_W)
    assert rec["partition"]["kernel_calls"] == rec["work"]["kernel_calls"]


SMALL_DIVISIBLE = {"internlm2_1p8b": dict(n_layers=2, d_model=128),
                   "hymba_1p5b": dict(n_layers=2, d_model=128)}


@pytest.mark.parametrize("counted", [False, True], ids=["rank", "propagation_counted"])
@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
@pytest.mark.parametrize("arch", list(SMALL_DIVISIBLE))
def test_partition_flops_are_the_steps_on_a_mesh_every_dim_divides(arch, kind, counted,
                                                                   monkeypatch):
    """Reduced internlm2 and hymba (4 heads of 32, widths 128, vocab 512) at
    batch 4 on a 2 x 2 (data, model) mesh, where every sharded dim divides:
    rank 0's FLOPs times 4 are the whole step's within 1 %, the train step's
    too (the fused qkv's weight gradient each rank's columns, the loss on
    each rank's slice of the vocab).  Counted with DTensor's sharding
    propagation (its ops at their global shapes, which the trace leaves
    out), they are several times more: so a torch whose propagation the
    trace failed to recognise fails this test, not the records silently.
    The train step's propagation runs on fake tensors, which the trace never
    counts, so there both counts are the step's.  hymba's train step runs its
    SSD scan's backward kernel on each rank's batch and heads."""
    monkeypatch.setitem(D.MESHES, "mesh2x2", ({"data": 2, "model": 2},
                                              TS.MeshAxes(data=("data",))))
    if counted:
        monkeypatch.setattr(D, "_PROPAGATION", ())
    cfg = TC.get_config(arch).reduced(**SMALL_DIVISIBLE[arch])
    shape = ShapeConfig(f"small_{kind}", 16 if kind == "prefill" else 20, 4, kind)
    step = D.trace(cfg, shape, 4)["flops"]
    rank = D.trace(cfg, shape, 4, mesh_name="mesh2x2", mesh_device="cpu")["flops"]
    if counted and kind != "train":
        assert rank * 4 > 5 * step
    else:
        assert step <= rank * 4 <= 1.01 * step


class _PeakTrace(D.Trace):
    """``dryrun.Trace`` that also keeps the largest storage live at its peak."""

    def __init__(self, args):
        self._bytes: dict = {}
        self.largest_at_peak = 0
        super().__init__(args)
        _PeakTrace.last = self

    def _track(self, t):
        key = t.untyped_storage()._cdata
        if key not in self._alive:
            self._bytes[key] = D._block_bytes(t.untyped_storage().nbytes())
        peak = self.peak
        super()._track(t)
        if self.peak > peak:
            self.largest_at_peak = max(self._bytes.values())

    def _free(self, key, n):
        self._bytes.pop(key, None)
        super()._free(key, n)


# reduced internlm2's train_4k rank-0 peak before the loss was computed on
# each rank's slice of the vocab: 20.7 GB, 17.2 of it a gradient of the
# global batch's logits
TRAIN_PEAK_BOUND = 3 * 10**9


def test_train_step_holds_no_global_logits_on_a_rank(monkeypatch):
    """Reduced internlm2 (2 layers, d 256, vocab 4096) at train_4k's global
    batch (256 x 4096) on a fake (16, 16) group: no storage live at rank
    0's peak is as large as the logits of its own 16 sequences over the
    whole vocab in f32 (a gathered vocab; the global batch's, 17.2 GB, would
    be 16 times that), and the peak is at most TRAIN_PEAK_BOUND (3 GB)."""
    monkeypatch.setattr(D, "Trace", _PeakTrace)
    cfg = production_cfg(TC.get_config("internlm2_1p8b").reduced(n_layers=2, d_model=256,
                                                                 vocab=4096))
    shape = TC.SHAPES["train_4k"]
    res = D.trace(cfg, shape, shape.global_batch, mesh_name="single", mesh_device="cpu")
    local_logits_f32 = shape.global_batch // 16 * (shape.seq_len - 1) * cfg.vocab_padded * 4
    assert _PeakTrace.last.largest_at_peak < local_logits_f32
    assert res["peak_bytes"] <= TRAIN_PEAK_BOUND, res["peak_bytes"]


class _LiveSites(D.Trace):
    """``dryrun.Trace`` that keeps, for the storages live at its peak, each
    one's shape and the model function that made it (``flops_by_site``'s
    sites: a backward op's under its forward's name with "(backward)")."""

    def __init__(self, args):
        self._made: dict = {}
        self.at_peak: list = []
        super().__init__(args)
        _LiveSites.last = self

    def _track(self, t):
        from repro_torch.launch import flops_by_site
        key = t.untyped_storage()._cdata
        if key not in self._alive:
            self._made[key] = (tuple(t.shape), flops_by_site._where()[0])
        peak = self.peak
        super()._track(t)
        if self.peak > peak:
            self.at_peak = [self._made[k] for k in self._alive if k in self._made]

    def _free(self, key, n):
        self._made.pop(key, None)
        super()._free(key, n)


def test_xlstm_train_step_runs_its_share_where_heads_do_not_divide_model(monkeypatch):
    """Reduced xlstm (one period: 7 mLSTM + 1 sLSTM layers, d 128, 4 heads,
    so d_inner 256 in heads of 64, vocab 1024) at batch 256 x 64 tokens on a
    fake (16, 16) group, train: its 4 heads divide neither ``model``'s 16 nor
    do they cut by sequence.  Rank 0's matmul FLOPs (``flops_by_site``) are
    within 1.2 x its share of the step's, and so are those of the backward of
    ``_mlstm_in``'s three products (each weight gradient on the rank's
    columns: ``sharding.own_layout_grad``; 6.63 x at xlstm-1.3B's widths
    before) and of the sLSTM's recurrence (a sequence a rank); the mLSTM
    cell runs the reference's layout (each head on 4 model ranks, by v's
    columns), its C.B^T products on each of them (under 2 x, 16 x before).
    No storage live at rank 0's peak is a gradient of those products at
    their whole width, (16, 64, 2 d_inner) or (16, 64, 3 d_inner)."""
    from repro_torch.launch import flops_by_site
    cfg = production_cfg(TC.get_config("xlstm_1p3b").reduced(n_layers=8, d_model=128, n_heads=4,
                                                              vocab=1024))
    shape = ShapeConfig("train_small", 64, 256, "train")
    rank, _ = flops_by_site.by_site(cfg, shape, "single")
    step, _ = flops_by_site.by_site(cfg, shape, None)

    def ratio(*sites):
        return 256 * sum(rank[s] for s in sites) / sum(step[s] for s in sites)
    assert ratio(*step) <= 1.2
    assert ratio("models/xlstm.py _mlstm_in (backward)") <= 1.2
    assert ratio("models/xlstm.py _slstm_step", "models/xlstm.py _slstm_step (backward)") <= 1.2
    assert ratio("models/xlstm.py mlstm_apply", "models/xlstm.py mlstm_apply (backward)") < 2
    monkeypatch.setattr(D, "Trace", _LiveSites)
    with torch.autograd.detect_anomaly(check_nan=False):
        D.trace(cfg, shape, shape.global_batch, mesh_name="single", mesh_device="cpu")
    d_inner = 2 * cfg.d_model
    whole = {(16, 64, 2 * d_inner), (16, 64, 3 * d_inner)}
    live = _LiveSites.last.at_peak
    assert live and not [s for s in live if s[0] in whole and s[1].endswith("_mlstm_in (backward)")]


@pytest.mark.parametrize("arch,site,kernel,multiple", [
    ("minicpm3_4b", "models/attention.py mla_apply", "flash_attention", 2),
    ("hymba_1p5b", "models/ssm.py _ssm_core", "ssd_scan", 8)])
def test_heads_that_divide_neither_model_nor_its_rows_run_in_the_references_groups(
        arch, site, kernel, multiple):
    """A train_4k-shaped step (batch 256 x 128 tokens, two layers) on a fake
    (16, 16) group: minicpm3 at its 40 heads of (96, 64), hymba at its 50
    SSM heads of 64 (d 1600).  The heads divide neither ``model``'s 16 nor,
    at 40 x 96 > 2048, take ``_row_shard``'s rows, so rank 0 runs the
    reference's head group (``sharding.head_groups``): minicpm3's attention
    5 of the 40 heads of its data group's 16 sequences, 2 x its share
    (the reference's per-rank ``f32[16,5,4096,4096]``), hymba's scan 25 of
    50, 8 x (``f32[16,16,25,256,256]``), forward and backward kernels alike,
    where every head on every model rank was 16 x."""
    from repro_torch.launch import flops_by_site
    base = TC.get_config(arch)
    if arch == "minicpm3_4b":
        cfg = dataclasses.replace(base.reduced(n_layers=2, d_model=256, n_heads=40, vocab=1024),
                                  mla=base.mla)
    else:
        cfg = base.reduced(n_layers=2, d_model=1600, n_heads=25, n_kv=5, vocab=1024)
    cfg = production_cfg(cfg)
    shape = ShapeConfig("train_small", 128, 256, "train")
    rank, _ = flops_by_site.by_site(cfg, shape, "single")
    step, _ = flops_by_site.by_site(cfg, shape, None)
    for key in (f"{site} [{kernel}]", f"{site} (backward) [{kernel}_bwd]"):
        assert step[key] > 0 and 256 * rank[key] == multiple * step[key], (
            key, 256 * rank[key] / step[key])


def _scan_spy(monkeypatch) -> list:
    """Each SSD kernel call's (x, h0, final state) local shapes, h0 None
    where the call starts from no state."""
    from repro_torch.kernels import ops
    calls, real = [], ops._ssd_scan

    def spy(x, a, b, c, h0=None, **kw):
        y, h = real(x, a, b, c, h0, **kw)
        calls.append((tuple(x.shape), None if h0 is None else tuple(h0.shape), tuple(h.shape)))
        return y, h
    monkeypatch.setattr(ops, "_ssd_scan", spy)
    return calls


def _placed_caches(monkeypatch) -> list:
    """Rank 0's local shape and bytes of each cache leaf ``place_cache``
    lays out, by layer and name."""
    placed, real = [], TS.place_cache

    def spy(cache, *a, **k):
        out = real(cache, *a, **k)
        placed.append([{n: (tuple(t.to_local().shape), t.to_local().nbytes)
                        for n, t in layer.items()} for layer in out])
        return out
    monkeypatch.setattr(TS, "place_cache", spy)
    return placed


@pytest.mark.parametrize("shape_name", ["prefill_32k", "decode_32k"])
def test_hymba_stateful_scans_run_in_the_references_layout(shape_name, monkeypatch,
                                                           reference_layout):
    """hymba-1.5B cut to 2 layers on a fake (16, 16) group, rank 0's program.
    prefill_32k (32 sequences, 2 a rank): the scan runs the reference's head
    group, x (2, 32768, 25, 64) and its final state (2, 25, 64, 16) a rank,
    as its compiled prefill (``chunked.py:68-92``, 25 of the 50 heads, P
    and N whole), and the state lies in the cache as the cache leaf does,
    (2, 50, 4, 16): every head, P on ``model``.  decode_32k (128, 8 a rank):
    the state update runs every head on the rank's 4 of P, x (8, 1, 50, 4),
    the state (8, 50, 4, 16) in and out, the reference's compiled decode's
    ``f32[8,50,4,16]`` (``chunked.py:82``) and its cache leaf byte for byte."""
    cfg = dataclasses.replace(production_cfg(TC.get_config("hymba_1p5b")), n_layers=2)
    shape = TC.SHAPES[shape_name]
    calls = _scan_spy(monkeypatch)
    placed = _placed_caches(monkeypatch)
    D.trace(cfg, shape, shape.global_batch, mesh_name="single", mesh_device="cpu")
    assert len(calls) == 2
    if shape_name == "prefill_32k":
        assert set(calls) == {((2, 32768, 25, 64), None, (2, 25, 64, 16))}
        (layers,) = placed
        assert [layer["ssm"] for layer in layers] == [((2, 50, 4, 16), 2 * 50 * 4 * 16 * 4)] * 2
    else:
        assert set(calls) == {((8, 1, 50, 4), (8, 50, 4, 16), (8, 50, 4, 16))}
        shp, es = reference_layout["hymba_1p5b__decode_32k__single"]["cache/0/ssm"]
        assert shp[1:] == [8, 50, 4, 16] and es == 4


def test_xlstm_train_step_cuts_the_mlstm_cells_q_and_k(monkeypatch):
    """xlstm-1.3B's widths cut to one period (8 layers) at 128 tokens, its
    train_4k batch (256) on a fake (16, 16) group: rank 0's mLSTM cell
    takes q and k at (16, S, 1, 256), its 256 of the head's 1024 columns, as
    v, the reference's ``f32[16,4096,1,256]`` a rank, and gathers them whole
    only where it contracts over them (b and q at (16, S, 1, 1024),
    ``chunked.py:73``, ``:92``)."""
    from repro_torch.kernels import chunked, ops
    cfg = dataclasses.replace(production_cfg(TC.get_config("xlstm_1p3b")), n_layers=8)
    shape = ShapeConfig("train_small", 128, 256, "train")
    seen, gathered, real = [], [], chunked.mlstm_chunked

    def spy(q, k, v, i, f, **kw):
        seen.append(tuple(tuple(t.shape) for t in (q, k, v)))
        g = kw.get("gather")

        def whole(t):
            out = g(t)
            gathered.append(tuple(out.shape))
            return out
        return real(q, k, v, i, f, **{**kw, "gather": whole if g else None})
    monkeypatch.setattr(ops, "mlstm_chunked", spy)
    D.trace(cfg, shape, shape.global_batch, mesh_name="single", mesh_device="cpu")
    assert seen and set(seen) == {((16, 128, 1, 256),) * 3}
    assert set(gathered) == {(16, 128, 1, 1024)}


def test_xlstm_train_step_keeps_the_mlstm_features_cut_on_model(monkeypatch):
    """Reduced xlstm (one period, d 128, 4 heads: d_inner 256) at batch 256 x
    64 tokens on a fake (16, 16) group, train: as the reference's compiled
    train_4k keeps d_inner cut on ``model`` from the up-projection's halves
    through the conv and the output norm (``f32[16,4099,256]``,
    ``f32[16,4096,256]`` a rank at d_inner 4096), no storage live at rank 0's
    peak is the up-projection's output at its whole 2 d_inner or the conv's
    padded input at d_inner; the conv's input lies at the rank's 16 of the
    256 features.  (The output norm's backward gathers its rows for a moment,
    so whole rows may be live there: ``ops._CutFeaturesNorm``.)"""
    cfg = production_cfg(TC.get_config("xlstm_1p3b").reduced(n_layers=8, d_model=128, n_heads=4,
                                                              vocab=1024))
    shape = ShapeConfig("train_small", 64, 256, "train")
    monkeypatch.setattr(D, "Trace", _LiveSites)
    D.trace(cfg, shape, shape.global_batch, mesh_name="single", mesh_device="cpu")
    d_inner = 2 * cfg.d_model
    live = _LiveSites.last.at_peak
    assert live
    assert not [s for s in live if s[0] in {(16, 64, 2 * d_inner), (16, 67, d_inner)}]
    assert ((16, 67, d_inner // 16), "models/ssm.py _causal_conv") in live


@pytest.mark.parametrize("mesh", ["single", "multi"])
@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
def test_partition_flops_are_the_steps_where_every_sharded_dim_divides(shape, mesh):
    """internlm2-1.8B's published cells, whose batch, rows, widths and vocab
    all divide the production mesh: the FLOPs of rank 0's program times the
    chips equal the whole step's within 1 %, and its argument bytes are the
    layout's (the reference's, 15,224,832 and 1,625,575,460 bytes a device
    on (16, 16)).  Prefill on (2, 16, 16) does more: its 8 kv heads divide
    neither model axis nor their group of 2, so ``_row_shard`` puts q's rows
    on ``model`` with the batch whole on every data rank, as the reference's
    constraint does, and rank 0 attends all 32 sequences' first 2,048 rows
    (1.5 x the step's FLOPs over 512 chips)."""
    rec = D.run_cell("internlm2_1p8b", shape, mesh == "multi", save=False, verbose=False)
    assert rec["status"] == "ok", rec.get("traceback")
    total = rec["flops_per_partition"] * rec["chips"]
    over = 1.6 if (shape, mesh) == ("prefill_32k", "multi") else 1.01
    assert rec["work"]["flops"] <= total <= over * rec["work"]["flops"]
    assert rec["memory"]["argument_size_in_bytes"] == rec["layout"]["argument_size_in_bytes"]
    if mesh == "single":
        assert rec["memory"]["argument_size_in_bytes"] == {
            "prefill_32k": 15_224_832, "decode_32k": 1_625_575_460}[shape]


@pytest.mark.parametrize("arch,whole_per_layer", [("granite_moe_3b", 3),
                                                  ("llama4_maverick_400b", 0)])
def test_moe_decode_gathers_no_expert_weight_it_does_not_use(arch, whole_per_layer):
    """Rank 0's program of a published MoE's decode_32k on (16, 16) (the
    scatter path: 4,096 tokens, under the expert path's threshold): the
    experts are gathered over the data axes only, once a layer.  granite's
    40 experts do not divide ``model``, so each of its three expert weights
    comes whole to every rank, as in the reference; llama4's 128 lie 8 to a
    column, and none comes whole."""
    cfg = production_cfg(TC.get_config(arch))
    shape = TC.SHAPES["decode_32k"]
    whole = cfg.moe.num_experts * cfg.d_model * cfg.d_ff * 2
    res = D.trace(cfg, shape, shape.global_batch, mesh_name="single")
    gathers = [b for op, b in res["coll_log"] if op == "all-gather"]
    assert gathers.count(whole) == whole_per_layer * cfg.n_layers


def test_xlstm_length_solve_equals_a_full_trace():
    """At a reduced size whose tensors all fill whole 512-byte blocks (chunk
    128), the counts and peak solved from lengths 256, 384 and 512 (and the
    batch-1 S² term) equal a trace at 1024 that the solve never ran, in
    prefill and in train, at batch 2."""
    base = TC.get_config("xlstm_1p3b").reduced(n_layers=8, d_model=128, n_heads=4)
    cfg = production_cfg(dataclasses.replace(base, ssm=dataclasses.replace(base.ssm, chunk=128)))
    params = transformer.param_shapes(cfg)
    for kind in ("prefill", "train"):
        shape = ShapeConfig("long", 1024, 2, kind)
        cell = D.CellCounts(cfg, shape, params)
        assert cell.lengths == (256, 384, 512)
        solved = cell.at(2)
        full = D.trace(cfg, shape, 2, 1024, params)
        for k in ("flops", "flops_by", "hbm_bytes", "kernel_calls", "arg_bytes", "peak_bytes",
                  "outputs"):
            assert solved[k] == full[k], (kind, k, solved[k], full[k])


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_max_batch_is_checked_against_a_third_trace(kind, monkeypatch):
    """With a card of 40 MB the solve's largest batch fits, by a trace at
    it, and the next batch, traced too, does not; the record carries both
    traces (``check``, ``next``) and the allocator its peaks assume."""
    monkeypatch.setattr(D, "CARD_BYTES", 40 * 10**6)
    monkeypatch.setattr(D, "RESERVE_BYTES", 0)
    cfg = reduced("internlm2_1p8b")(None)
    shape = ShapeConfig("s", 512, 16, kind)
    cell = D.CellCounts(cfg, shape, transformer.param_shapes(cfg))
    oc = D.one_card(cell)
    mb = oc["max_batch"]
    assert 1 < mb < 200 and oc["check"]["batch"] == mb and oc["fits"] == (16 <= mb)
    assert oc["check"]["peak_bytes"] == D.trace(cfg, shape, mb)["peak_bytes"] <= 40 * 10**6
    nxt = D.trace(cfg, shape, mb + 1)
    assert oc["next"]["batch"] == mb + 1 and oc["next"]["peak_bytes"] == nxt["peak_bytes"]
    assert nxt["peak_bytes"] > oc["capacity_bytes"] == 40 * 10**6
    assert oc["next"]["kernel_calls"] == nxt["kernel_calls"]
    assert oc["check"]["predicted_peak_bytes"] == pytest.approx(oc["check"]["peak_bytes"],
                                                                rel=1e-3)
    assert oc["allocator"] == D.ALLOCATOR and "expandable segments" in D.ALLOCATOR


def test_expandable_segments_sets_the_allocator(monkeypatch):
    """``device.expandable_segments``, which the serve and train launchers
    call on the card, hands the caching allocator the setting the dry-run's
    peaks assume, and turns it off again."""
    from repro_torch.device import expandable_segments
    seen = []
    monkeypatch.setattr(torch._C, "_accelerator_setAllocatorSettings", seen.append,
                        raising=False)
    expandable_segments()
    expandable_segments(False)
    assert seen == ["expandable_segments:True", "expandable_segments:False"]


def test_cli_writes_records_and_skips_existing(tmp_path, capsys):
    """``--arch``/``--shape``/``--mesh both`` writes one record a mesh under
    ``--out`` (a skipped cell too); ``--skip-existing`` leaves them."""
    out = tmp_path / "dry"
    argv = ["--arch", "internlm2_1p8b", "--shape", "long_500k", "--mesh", "both", "--out",
            str(out)]
    assert D.main(argv) == 0
    files = sorted(p.name for p in out.iterdir())
    assert files == ["internlm2_1p8b__long_500k__multi.json",
                     "internlm2_1p8b__long_500k__single.json"]
    assert D.main(argv + ["--skip-existing"]) == 0
    assert "0 ok, 0 skipped, 0 errors" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        D.main(["--arch", "yi_6b"])
    assert not any(p.name.startswith("yi") for p in out.iterdir())
