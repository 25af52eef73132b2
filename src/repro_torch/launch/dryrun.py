"""Dry-run of every (arch × shape × mesh) cell on meta tensors (port of
``repro.launch.dryrun``).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi_6b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh single|multi|both]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --table dryrun_out

The reference lowers and compiles each cell's step on 512 forced host
devices.  Here a cell's step runs on meta tensors, which allocate nothing,
through the kernel wrappers' meta branches (each takes its CUDA branch's
checks, plan, outputs and workspaces with no launch, and gives its work from
``kernels/cost.py`` to the trace).  One JSON record a cell, in ``--out``
(``dryrun_out/`` at the repo root by default), with three blocks:

* ``layout``: per device, exact, the bytes of params, optimizer state,
  batch, cache and ``pos`` under the production mesh's rule table
  (``parallel/sharding.py`` on ``{"data": 16, "model": 16}`` or ``{"pod": 2,
  "data": 16, "model": 16}``; no process group), their total as the
  reference's ``argument_size_in_bytes``.
* ``work``: the whole step at the cell's global batch: FLOPs (aten's
  matmul-class ops by ``torch.utils.flop_counter``'s formulas, each kernel by
  its own, two operations to a multiply-add) by group, bytes computed from
  sizes (each non-view op's inputs read and outputs written once, each kernel
  by its formula), and the calls of each kernel.
* ``one_card``: the step on one device: its peak live bytes (arguments
  included; each new storage counted once, at the CUDA caching allocator's
  512-byte blocks, and freed on its finaliser) at the cell's global batch,
  whether that fits an 80 GB H100 less ``RESERVE_BYTES``, and the largest
  batch that fits.  Peak is linear in the batch: it is solved from traces at
  two batches and checked with traces at the solved one and the next.  The
  peak is the allocator's allocated bytes, which bind on the card only with
  expandable segments (``ALLOCATOR``, stated in the record).

and, per device, the reference's fields from a trace of rank 0's program of
the sharded step on the production mesh (``launch/mesh.py::fake_mesh``: a
``fake`` process group of 256 or 512 ranks in this process, DTensor inputs
over meta shards placed as the reference's ``in_shardings``):
``flops_per_partition``, ``bytes_per_partition`` (from sizes, as ``work``'s),
``memory`` (argument, output, alias and temp bytes, and the peak) and
``collectives`` (result bytes by op under the reference's names,
``weighted_link_traffic`` by its link weights, and the count; each
collective DTensor or the MoE's expert path issues, seen by the trace's
dispatch mode).  The reference also records ``derived_*`` probe costs: XLA
counts a loop body once, so it solves whole-model costs from one- and
two-group compiles; this trace runs every layer, so its counts are whole
and no probe is needed.  The trace's mesh is a CUDA one where torch is
built with CUDA (the card's program), else a CPU one: DTensor picks some
collectives by the mesh's device type, and its program differs between
torch versions, so a record names the torch that traced it.  One of them
is counted as the card's in either case: a Shard(i) -> Shard(j)
redistribution, which DTensor sends through NCCL's all-to-all on a CUDA
mesh but runs as gloo's all-gather and chunk on a CPU one, is traced on
the CPU-typed mesh as the card runs it (``_card_alltoall``), one
all-to-all of the rank's local bytes.
Prefill and decode are traced under
``torch.inference_mode()``, as ``Server`` runs them, and train through
``steps.make_train_step``, the backward kernels' meta branches recording
their work (RMSNorm's, flash attention's and the SSD scan's); a train cell
whose forward reaches a kernel with no backward would record the wrapper's
refusal.  Any failure is recorded as data, never raised.

xLSTM's sLSTM steps through its tokens in Python, so a trace at 32,768 tokens
would take minutes.  Its prefill and train cells are traced at 2 and 3
chunks instead and every count solved as ``E + S·b``: at whole chunks its
per-token loop, its chunked mLSTM and its matmuls are all linear in S.  A
third trace at 4 chunks, at batch 1, gives the S² term the train step's
bytes have (``CellCounts``).
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import math
import pathlib
import sys
import time
import traceback
import weakref
from fractions import Fraction
from typing import Any

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from .. import configs as C
from ..configs.base import SHAPES, ModelConfig, ShapeConfig, production_cfg
from ..data.pipeline import DataConfig, batch_specs
from ..kernels import cost
from ..models import transformer, xlstm
from ..models.common import dtype_of
from ..parallel import sharding
from ..parallel.sharding import MeshAxes, Spec, param_pspecs
from ..runtime import steps
from . import mesh as mesh_mod

OUT_DIR = pathlib.Path(__file__).resolve().parents[3] / "dryrun_out"   # gitignored
MESHES = {"single": ({"data": 16, "model": 16}, MeshAxes(data=("data",))),
          "multi": ({"pod": 2, "data": 16, "model": 16}, MeshAxes(data=("pod", "data")))}
# An H100's 80 GB (data sheet).  The card reports a little more memory than
# this; chip_smoke.py's dryrun phase prints both and checks that the cap is
# free there.
CARD_BYTES = 80 * 10**9
# Held back from the card for what the trace does not see: the CUDA context
# (outside the allocator, ~0.5 GB), cuBLAS's workspace (32 MiB a handle on
# Hopper) and the allocator's fragmentation.
RESERVE_BYTES = 2 * 2**30
# What the peak counts, and so what "fits" assumes (each record states it).
ALLOCATOR = ("allocated bytes at 512-byte blocks, with the CUDA caching allocator's "
             "expandable segments on (repro_torch.device.expandable_segments; the serve and "
             "train launchers set them); on fixed segments the reserved bytes, which the "
             "trace does not predict, bind first near the cap")
BLOCK = 512                    # the CUDA caching allocator's block rounding
KERNELS = ("rmsnorm", "rmsnorm_bwd", "flash_attention", "flash_attention_bwd",
           "decode_attention", "ssd_scan", "ssd_scan_bwd")
# ops that allocate their output and write nothing
_ALLOC_ONLY = {torch.ops.aten.empty, torch.ops.aten.empty_strided, torch.ops.aten.empty_like,
               torch.ops.aten.new_empty, torch.ops.aten.new_empty_strided}


def cell_supported(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """long_500k applicability: sub-quadratic archs only (the reference's)."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "SKIP(long_500k): pure full-attention arch (O(L^2) KV)"
    return True, ""


# ---------------------------------------------------------------------------
# input specs: meta tensors, never allocated
# ---------------------------------------------------------------------------

def _meta(shape_dtype: tuple) -> torch.Tensor:
    shape, dtype = shape_dtype
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig, batch: int | None = None,
                seq: int | None = None, params: dict | None = None) -> dict:
    """The step's arguments for this shape kind as meta tensors, at the
    shape's global batch and length unless ``batch`` or ``seq`` is given.
    ``pos`` (decode) is the last slot of the cache, a Python int."""
    B = shape.global_batch if batch is None else batch
    S = shape.seq_len if seq is None else seq
    params = transformer.param_shapes(cfg) if params is None else params
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B,
                      embed_stub_dim=cfg.d_model if cfg.embed_stub else None)
    if shape.kind in ("train", "prefill"):
        out = {"params": params,
               "batch": {k: _meta(v) for k, v in batch_specs(dcfg, torch.bfloat16).items()}}
        if shape.kind == "train":
            out["opt_state"] = steps.init_opt_state(params, steps.TrainConfig())
        return out
    dt = dtype_of(cfg.compute_dtype)
    cache = [{name: _meta(sd) for name, sd in one.items()}
             for one in transformer.cache_shapes(cfg, B, S, dt)]
    return {"params": params, "tokens": torch.empty((B, 1), dtype=torch.int32, device="meta"),
            "cache": cache, "pos": S - 1}


# ---------------------------------------------------------------------------
# layout: per-device shapes under the production mesh
# ---------------------------------------------------------------------------

def _dp(axes: MeshAxes):
    return axes.dp if len(axes.dp) > 1 else axes.dp[0]


def _dsize(sizes: dict, axes: MeshAxes) -> int:
    return math.prod(sizes[a] for a in axes.dp)


def cache_pspecs(cache: list, sizes: dict, axes: MeshAxes) -> list:
    """The reference's ``cache_pspecs`` on the port's per-layer cache: batch
    over the data axes when it divides, the first later dim the model axis
    divides on ``model``.  The reference's leaves carry a leading group axis
    (batch at dim 1, model from dim 2); a layer's leaf here has none."""
    dsize, msize = _dsize(sizes, axes), sizes[axes.model]

    def spec(t: torch.Tensor) -> Spec:
        dims = t.shape
        out: list = [None] * len(dims)
        if dims and dims[0] % dsize == 0:
            out[0] = _dp(axes)
        for i in range(1, len(dims)):
            if dims[i] % msize == 0:
                out[i] = axes.model
                break
        return Spec(*out)

    return [{k: spec(v) for k, v in one.items()} for one in cache]


def shardings_for(cfg: ModelConfig, shape: ShapeConfig, sizes: dict, axes: MeshAxes,
                  specs: dict) -> dict:
    """A :class:`Spec` tree mirroring ``specs`` (``input_specs``'s), as the
    reference's ``shardings_for`` lays its inputs out."""
    pspec = param_pspecs(specs["params"], sizes, axes)
    bdiv = shape.global_batch % _dsize(sizes, axes) == 0

    def bspec(t: torch.Tensor) -> Spec:
        return Spec(_dp(axes) if bdiv else None, *([None] * (t.dim() - 1)))

    out: dict = {"params": pspec}
    if "batch" in specs:
        out["batch"] = {k: bspec(v) for k, v in specs["batch"].items()}
    if "opt_state" in specs:
        out["opt_state"] = {"m": pspec, "v": pspec, "step": Spec()}
    if shape.kind == "decode":
        out.update(tokens=bspec(specs["tokens"]),
                   cache=cache_pspecs(specs["cache"], sizes, axes), pos=Spec())
    return out


def _walk(tree: Any, path: str = ""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, f"{path}/{k}" if path else str(k))
    elif isinstance(tree, (list, tuple)) and not isinstance(tree, Spec):
        for i, v in enumerate(tree):
            yield from _walk(v, f"{path}/{i}")
    else:
        yield path, tree


def local_shape(shape: tuple, spec: Spec, sizes: dict) -> tuple:
    """A leaf's per-device shape: each dim over the product of the mesh axes
    its spec entry names (rounded up, as a padded shard would be)."""
    out = []
    for i, dim in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        names = entry if isinstance(entry, tuple) else (() if entry is None else (entry,))
        out.append(-(-dim // math.prod(sizes[a] for a in names)))
    return tuple(out)


def local_leaves(cfg: ModelConfig, shape: ShapeConfig, mesh_name: str,
                 specs: dict | None = None) -> list[tuple[str, tuple, int]]:
    """(path, per-device shape, bytes an element) of every argument leaf;
    ``pos`` is the reference's int32 scalar."""
    sizes, axes = MESHES[mesh_name]
    specs = input_specs(cfg, shape) if specs is None else specs
    shards = dict(_walk(shardings_for(cfg, shape, sizes, axes, specs)))
    out = []
    for path, leaf in _walk(specs):
        if path == "pos":
            out.append((path, (), 4))
        else:
            out.append((path, local_shape(tuple(leaf.shape), shards[path], sizes),
                        leaf.element_size()))
    return out


def layout(cfg: ModelConfig, shape: ShapeConfig, mesh_name: str,
           specs: dict | None = None) -> dict:
    """Per-device argument bytes by input, and their total."""
    by: dict = collections.Counter()
    for path, shp, es in local_leaves(cfg, shape, mesh_name, specs):
        by[path.split("/")[0]] += math.prod(shp) * es
    sizes, _ = MESHES[mesh_name]
    return {"mesh": sizes, "bytes": dict(by), "argument_size_in_bytes": sum(by.values())}


# ---------------------------------------------------------------------------
# the trace
# ---------------------------------------------------------------------------

def _block_bytes(n: int) -> int:
    return 0 if n == 0 else -(-n // BLOCK) * BLOCK


def _tensors(tree: Any, acc: list | None = None) -> list[torch.Tensor]:
    """The tensors in nested tuples, lists and dicts (an op's arguments, a
    step's inputs or outputs), in order."""
    acc = [] if acc is None else acc
    if isinstance(tree, DTensor):
        acc.append(tree._local_tensor)   # a rank's bytes are its shard's
    elif isinstance(tree, torch.Tensor):
        acc.append(tree)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _tensors(v, acc)
    elif isinstance(tree, dict):
        for v in tree.values():
            _tensors(v, acc)
    return acc


def _key(x: Any) -> Any:
    """A hashable stand-in for an op argument's metadata (shape, strides,
    dtype of a tensor; type and value otherwise), or TypeError."""
    if isinstance(x, torch.Tensor):
        return ("T", tuple(x.shape), x.stride(), x.dtype, x.device.type)
    if isinstance(x, (list, tuple)):
        return (type(x).__name__, tuple(_key(v) for v in x))
    if isinstance(x, dict):
        return ("D", tuple((k, _key(v)) for k, v in x.items()))
    hash(x)
    return (type(x).__name__, x)


def _leaves(tree: Any) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


# DTensor's sharding propagation runs ops on global-shape meta tensors to
# learn their outputs' metadata (through fake tensors, or its own
# decomposition mode); those are not the rank's work.  Recognised by the
# files it runs in: a torch that moves it elsewhere makes a rank's FLOPs
# several times the step's, which tests/test_torch_dryrun.py bounds.
_PROPAGATION = ("distributed/tensor/_sharding_prop.py", "distributed/tensor/_decompositions.py")


# functional collectives' companions, which hand their input on (a card's
# allocator sees no new block): counted as the input itself
_IDENTITY = {torch.ops._c10d_functional.wait_tensor.default,
             torch.ops._c10d_functional._wrap_tensor_autograd.default}


def _in_propagation() -> bool:
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_filename.endswith(_PROPAGATION):
            return True
        f = f.f_back
    return False


class Trace(TorchDispatchMode):
    """Counts a step's work and live bytes on meta tensors.

    Every aten op passes here: matmul-class ops add FLOPs by
    ``flop_registry``'s formulas, each non-view op adds its inputs' and
    outputs' bytes once, and each fresh output's storage joins the live bytes
    (at ``BLOCK`` rounding) until its finaliser runs.  The kernels' meta
    branches call :meth:`record_kernel` (``kernels/cost.py::record``).

    Meta ops are slow (many run as Python decompositions, ~0.1-0.8 ms each),
    and a per-token loop repeats the same few ops at the same shapes.  So the
    output metadata of an op that returns fresh contiguous tensors is
    remembered by its arguments' metadata, and a repeat makes its outputs
    with ``torch.empty_strided`` instead of running the op again."""

    def __init__(self, args: Any):
        super().__init__()
        self.flops_by: collections.Counter = collections.Counter()
        self.hbm_bytes = 0
        self.kernel_calls: collections.Counter = collections.Counter()
        self.coll_bytes: collections.Counter = collections.Counter()
        self.coll_count = 0
        self.coll_log: list[tuple[str, int]] = []
        self.live = self.peak = self._seg = 0
        self.segments: list[int] = []
        self._alive: set[int] = set()
        self._outs: dict = {}
        self._infos: dict = {}
        self.arg_exact = 0
        self.sharded = any(isinstance(t, DTensor) for t in _leaves(args))
        for t in _tensors(args):
            if t.untyped_storage()._cdata not in self._alive:
                self.arg_exact += t.untyped_storage().nbytes()
            self._track(t)
        self.arg_bytes = self.live
        self._args = set(self._alive)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._alive:
            return
        n = _block_bytes(st.nbytes())
        self._alive.add(key)
        self.live += n
        self.peak = max(self.peak, self.live)
        self._seg = max(self._seg, self.live)
        weakref.finalize(st, self._free, key, n)

    def _free(self, key: int, n: int) -> None:
        if key in self._alive:
            self._alive.discard(key)
            self.live -= n

    def record_kernel(self, kernel: str, work) -> None:
        self.segments.append(self._seg)
        self._seg = self.live
        self.kernel_calls[kernel] += 1
        self.flops_by[kernel] += work.flops
        self.hbm_bytes += work.bytes

    def _info(self, func) -> tuple:
        """What the trace needs to know of an op, read once from its schema:
        (a composite to decompose, its kind, its FLOP formula or None,
        whether it only allocates, its number of returns).  Kinds: "view"
        (aliases an input, moves nothing), "mutable" (writes in place),
        "fresh" (returns new tensors, so its outputs can be remembered) and
        "other" (outputs checked against the inputs' storages at each call)."""
        info = self._infos.get(func)
        if info is None:
            schema = func._schema
            composite = (func.overloadpacket not in flop_registry
                         and torch._C._dispatch_has_kernel_for_dispatch_key(
                             func.name(), torch._C.DispatchKey.CompositeImplicitAutograd))
            if schema.is_mutable:
                kind = "mutable"
            elif func.is_view:
                kind = "view"
            elif schema.returns and all(r.alias_info is None and str(r.type) == "Tensor"
                                        for r in schema.returns):
                kind = "fresh"
            else:
                kind = "other"
            info = self._infos[func] = (composite, kind, flop_registry.get(func.overloadpacket),
                                        func.overloadpacket in _ALLOC_ONLY, len(schema.returns))
        return info

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            # a DTensor op: DTensor runs it as local ops on each shard, which
            # come back here and are counted; its sharding propagation's fake
            # tensors are not
            return NotImplemented
        if (any(issubclass(t, FakeTensor) for t in types)
                or torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is not None
                or (self.sharded and _in_propagation())):
            return func(*args, **kwargs)
        if func in _IDENTITY:  # a collective's wait or autograd wrapper: the same bytes
            return args[0]
        coll = cost.collective(func)
        if coll is not None:  # counted, and always run
            out = func(*args, **kwargs)
            outs = _tensors(out)
            self.coll_log.append((coll, cost.result_bytes(out)))
            self.coll_bytes[coll] += self.coll_log[-1][1]
            self.coll_count += 1
            held = {t.untyped_storage()._cdata for t in _tensors((args, kwargs))}
            new = [t for t in outs if t.untyped_storage()._cdata not in held]
            self.hbm_bytes += sum(t.numel() * t.element_size()
                                  for t in _tensors((args, kwargs)) + new)
            for t in new:
                self._track(t)
            return out
        composite, kind, flop, alloc_only, n_ret = self._info(func)
        if composite:
            # a composite op (matmul, einsum: inference mode hands them over
            # whole) runs as the ops it is made of, each counted here
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        if kind == "view":
            return func(*args, **kwargs)
        flat_in = _tensors((args, kwargs))
        if self.sharded and (any(t.device.type != "meta" for t in flat_in) or (
                not flat_in and torch.device(kwargs.get("device") or "cpu").type != "meta")):
            return func(*args, **kwargs)  # a mesh's host bookkeeping, not the step's work
        key = None
        if kind == "fresh":
            try:
                key = (func, _key(args), _key(kwargs))
            except TypeError:
                pass
        made = self._outs.get(key) if key is not None else None
        if made is not None:
            outs = [torch.empty_strided(sh, st, dtype=dt, device="meta") for sh, st, dt in made]
            out = outs[0] if n_ret == 1 else tuple(outs)
            new = outs
        else:
            out = func(*args, **kwargs)
            outs = _tensors(out)
            if kind == "mutable":  # in place: reads its inputs, writes its outputs
                new = []
            else:
                held = {t.untyped_storage()._cdata for t in flat_in}
                new = [t for t in outs if t.untyped_storage()._cdata not in held]
                if key is not None and len(new) == len(outs) and all(
                        o.is_contiguous() and o.storage_offset() == 0
                        and o.untyped_storage().nbytes() == o.numel() * o.element_size()
                        for o in outs):
                    self._outs[key] = [(tuple(o.shape), o.stride(), o.dtype) for o in outs]
        if flop is not None:
            self.flops_by["matmul"] += int(flop(*args, **kwargs, out_val=out))
        if (kind == "mutable" or new) and not alloc_only:
            self.hbm_bytes += sum(t.numel() * t.element_size() for t in flat_in + outs)
        for t in new:
            self._track(t)
        return out

    def result(self, out: Any) -> dict:
        flops_by = {k: int(v) for k, v in sorted(self.flops_by.items())}
        stores: dict = {}
        for t in _tensors(out):
            st = t.untyped_storage()
            stores[st._cdata] = st.nbytes()
        aliased = sum(n for k, n in stores.items() if k in self._args)
        return {"flops": sum(flops_by.values()), "flops_by": flops_by,
                "hbm_bytes": int(self.hbm_bytes),
                "kernel_calls": {k: int(self.kernel_calls[k]) for k in KERNELS},
                "peak_bytes": int(self.peak), "arg_bytes": int(self.arg_bytes),
                "arg_exact": int(self.arg_exact), "out_exact": int(sum(stores.values())),
                "alias_exact": int(aliased),
                "collectives": {**{op: int(self.coll_bytes[op]) for op in cost.TRAFFIC_W},
                                "count": self.coll_count},
                "coll_log": list(self.coll_log),
                "segments": self.segments + [self._seg],
                "outputs": dict(collections.Counter(str(tuple(t.shape)) for t in _tensors(out)))}


def program_shardings(cfg: ModelConfig, shape: ShapeConfig, sizes: dict, axes: MeshAxes,
                      specs: dict) -> dict:
    """The layout the sharded step's inputs take: ``shardings_for``'s, the
    cache by ``sharding.cache_leaf_spec`` (k and v by ``cache_pspec``: kv
    heads on ``model`` where they divide, else the sequence), as
    ``transformer.prefill`` emits it.  A device holds the same bytes as under
    ``shardings_for``'s wherever the dims divide, as every supported cell's
    do."""
    out = shardings_for(cfg, shape, sizes, axes, specs)
    if "cache" in specs:
        out["cache"] = [{k: sharding.cache_leaf_spec(k, tuple(v.shape), cfg.n_kv, sizes, axes)
                         for k, v in one.items()} for one in specs["cache"]]
    return out


def sharded_inputs(cfg: ModelConfig, shape: ShapeConfig, mesh: Any, axes: MeshAxes,
                   specs: dict, device: str = "meta") -> dict:
    """``specs`` (``input_specs``'s meta tensors, whole) as this rank's
    inputs on ``mesh``: each leaf a DTensor over a shard of its per-device
    shape (``local_shape``) on ``device`` (meta; zeros elsewhere, as a card
    runs rank 0's program), placed by ``program_shardings``; ``pos`` and the
    optimizer's step as they are (replicated), the step a zero on
    ``device``."""
    sizes = sharding.mesh_sizes(mesh)
    shards = program_shardings(cfg, shape, sizes, axes, specs)

    def conv(node: Any, spec: Any) -> Any:
        if isinstance(node, dict):
            return {k: conv(v, spec[k]) for k, v in node.items()}
        if isinstance(node, list):
            return [conv(v, sp) for v, sp in zip(node, spec)]
        if not isinstance(node, torch.Tensor):
            return node
        if node.dim() == 0:
            return node if device == "meta" else torch.zeros((), dtype=node.dtype, device=device)
        local = torch.zeros(local_shape(tuple(node.shape), spec, sizes), dtype=node.dtype,
                            device=device)
        return DTensor.from_local(local, mesh, sharding.placements(spec, mesh),
                                  run_check=False, shape=node.shape, stride=node.stride())

    return {k: conv(v, shards[k]) for k, v in specs.items()}


def _step(cfg: ModelConfig, shape: ShapeConfig, specs: dict) -> Any:
    """Run the cell's step on ``specs``: prefill and decode in inference
    mode, as ``Server`` runs them; train through ``make_train_step``."""
    if shape.kind == "train":
        _, _, metrics = steps.make_train_step(cfg, steps.TrainConfig())(
            specs["params"], specs["opt_state"], specs["batch"])
        return metrics
    with torch.inference_mode():
        if shape.kind == "prefill":
            return steps.make_prefill_step(cfg)(specs["params"], specs["batch"])
        return steps.make_decode_step(cfg)(specs["params"], specs["tokens"], specs["cache"],
                                           specs["pos"])


@contextlib.contextmanager
def _card_alltoall():
    """DTensor's Shard(i) -> Shard(j) redistribution through its all-to-all
    op (``_dtensor.shard_dim_alltoall``, which the trace counts as one
    all-to-all) on a mesh of any device type: on a CPU-typed mesh DTensor
    would run gloo's fallback, an all-gather of ``model`` x the bytes and a
    chunk, which the card's program does not."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import placement_types

    def card(input, gather_dim, shard_dim, mesh, mesh_dim):
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim, funcol._resolve_group_name((mesh, mesh_dim)))

    gloo = placement_types.shard_dim_alltoall
    placement_types.shard_dim_alltoall = card
    try:
        yield
    finally:
        placement_types.shard_dim_alltoall = gloo


def trace(cfg: ModelConfig, shape: ShapeConfig, batch: int, seq: int | None = None,
          params: dict | None = None, mesh_name: str | None = None,
          mesh_device: str | None = None) -> dict:
    """One trace of the step at ``batch`` (and ``seq``): its counts, peak
    and argument bytes, collectives, and output shapes.  With ``mesh_name``,
    rank 0's program of the sharded step on that production mesh
    (``launch/mesh.py::fake_mesh``), its inputs placed as the reference's
    ``in_shardings`` (``sharded_inputs``): every count is rank 0's.  The
    mesh is of ``mesh_device``'s type (its shards are meta tensors either
    way): DTensor picks some collectives by it, so ``cuda`` traces the
    card's program and ``cpu`` a gloo world's.  By default the card's
    program: on a ``cuda`` mesh where this torch is built with CUDA, else on
    a ``cpu`` one with the card's all-to-all (``_card_alltoall``)."""
    specs = input_specs(cfg, shape, batch, seq, params)
    if mesh_name is None:
        mode = Trace(specs)
        with mode:
            out = _step(cfg, shape, specs)
        res = mode.result(out)
        del out, specs
        return res
    sizes, axes = MESHES[mesh_name]
    card = contextlib.nullcontext()
    if mesh_device is None:
        mesh_device = "cuda" if torch.backends.cuda.is_built() else "cpu"
        if mesh_device == "cpu":
            card = _card_alltoall()
    with mesh_mod.fake_mesh(tuple(sizes.values()), tuple(sizes), mesh_device) as mesh, card:
        sharding.set_active_mesh(mesh, axes)
        try:
            # a serving step's inputs are made in inference mode, where it
            # runs: a DTensor view (a conv weight's row, a cache's split) of
            # a tensor made outside it cannot be taken there
            with torch.inference_mode(shape.kind != "train"):
                dspecs = sharded_inputs(cfg, shape, mesh, axes, specs)
            del specs
            mode = Trace(dspecs)
            with mode:
                out = _step(cfg, shape, dspecs)
            res = mode.result(out)
            del out, dspecs
        finally:
            sharding.set_active_mesh(None)
    return res


def _length_solve(cfg: ModelConfig, shape: ShapeConfig) -> tuple[int, int, int] | None:
    """The lengths at which a cell is traced in place of its own, or None:
    xLSTM's prefill and train (the sLSTM's per-token loop), at 2, 3 and 4 of
    its chunks when its length is longer.  (At one chunk its einsums take
    another form, so no length below two chunks lies on the same line.)"""
    chunk = xlstm._chunk(cfg)
    if "slstm" not in cfg.block_pattern or shape.kind == "decode" \
            or shape.seq_len <= 4 * chunk:
        return None
    return 2 * chunk, 3 * chunk, 4 * chunk


def _leafwise(fn, *trees):
    """``fn`` over the matching numbers of dicts and lists of numbers."""
    if isinstance(trees[0], dict):
        return {k: _leafwise(fn, *(t[k] for t in trees)) for k in trees[0]}
    if isinstance(trees[0], list):
        if len({len(t) for t in trees}) != 1:
            raise ValueError(f"segments differ in number: {[len(t) for t in trees]}")
        return [_leafwise(fn, *vs) for vs in zip(*trees)]
    return fn(*trees)


# a trace's counts that the one-card record leaves out (the per-device
# record reads them from rank 0's trace)
_PER_DEVICE = ("segments", "arg_exact", "out_exact", "alias_exact", "collectives", "coll_log")
_COUNTS = ("flops", "flops_by", "hbm_bytes", "kernel_calls", "arg_bytes", "arg_exact",
           "out_exact", "alias_exact", "collectives", "segments")


class CellCounts:
    """A cell's counts (``trace``'s result) at any batch, each batch traced
    once.

    Where ``_length_solve`` names lengths (L2, L3, L4), a batch is traced at
    L2 and L3 and each count taken at the cell's length S on the line through
    them, plus b·q·(S - L2)(S - L3): q, per count, is its S² coefficient at
    batch 1, from a third trace there at L4.  Most counts are linear in S at
    whole chunks (the per-token loop, the chunked mLSTM, the matmuls); the
    train step's bytes are not, since autograd's gradient of each token's
    slice ``wx[:, t]`` is a zero tensor of the whole (B, S, 4d) input with
    the slice written in, and the sum of those is S² in every sequence.  The
    peak is solved segment by segment (the live bytes' highest between two
    kernel calls, which come in the same order at every length) and taken as
    the largest, so a peak that moves to another part of the step as the
    length grows is found where it ends up."""

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig, params: dict,
                 mesh_name: str | None = None):
        self.cfg, self.shape, self.params, self.mesh_name = cfg, shape, params, mesh_name
        self.lengths = _length_solve(cfg, shape)
        self._done: dict[int, dict] = {}
        self._quad: dict | None = None
        # the S² term is taken at one sequence a device: batch 1, or, where
        # the cell's batch is sharded, one sequence on each data rank
        self.unit = 1
        if mesh_name is not None:
            sizes, axes = MESHES[mesh_name]
            if shape.global_batch % _dsize(sizes, axes) == 0:
                self.unit = _dsize(sizes, axes)

    def at(self, batch: int) -> dict:
        if batch not in self._done:
            self._done[batch] = self._counts(batch)
        return self._done[batch]

    def _counts(self, batch: int) -> dict:
        mesh = self.mesh_name
        if self.lengths is None:
            return trace(self.cfg, self.shape, batch, params=self.params, mesh_name=mesh)
        if self._quad is None and batch != self.unit:
            self.at(self.unit)
        L2, L3, L4 = self.lengths
        S = self.shape.seq_len
        a, b = (trace(self.cfg, self.shape, batch, n, self.params, mesh) for n in (L2, L3))
        if a["outputs"] != b["outputs"]:
            raise ValueError(f"outputs differ between lengths {L2} and {L3}")

        def line(x: int) -> dict:
            return {k: _leafwise(lambda u, v: Fraction(u) + Fraction(v - u, L3 - L2) * (x - L2),
                                 a[k], b[k]) for k in _COUNTS}

        if self._quad is None:
            c = trace(self.cfg, self.shape, self.unit, L4, self.params, mesh)
            self._quad = {k: _leafwise(lambda u, v: (u - v) / ((L4 - L2) * (L4 - L3)),
                                       c[k], line(L4)[k]) for k in _COUNTS}
        n = Fraction(batch, self.unit)
        out = {k: _leafwise(lambda u, q: u + n * q * (S - L2) * (S - L3),
                            line(S)[k], self._quad[k]) for k in _COUNTS}
        if any(v.denominator != 1 for _, v in _walk(out)):
            raise ValueError(f"the counts at lengths {self.lengths} do not solve to whole "
                             f"numbers at {S}: {out}")
        out = {k: _leafwise(int, v) for k, v in out.items()}
        return {**out, "peak_bytes": max(out["segments"]), "outputs": b["outputs"],
                "lengths": list(self.lengths)}


def one_card(counts: CellCounts) -> dict:
    """Peak at the global batch, whether it fits under the cap (``ALLOCATOR``
    says what the peak counts), and the largest batch that fits, with the
    traces at it (``check``) and at the next batch (``next``).  Each
    segment's peak (``CellCounts``) is a line in the batch,
    through batch 1 and the global batch (or 2); the largest batch is the one
    the first segment to fill the card allows, checked by a trace there and
    one at the next batch (where either misses, the lines are drawn again
    through it)."""
    cap = CARD_BYTES - RESERVE_BYTES
    G = counts.shape.global_batch
    at = counts.at

    def solve(b1: int, b2: int) -> tuple[int, Fraction]:
        """(the largest batch under cap on the lines through batches b1 < b2,
        the predicted peak there)."""
        lines = []
        for p1, p2 in zip(at(b1)["segments"], at(b2)["segments"]):
            slope = Fraction(p2 - p1, b2 - b1)
            lines.append((p1 - b1 * slope, slope))
        grows = [math.floor((cap - e) / s) for e, s in lines if s > 0]
        if not grows:
            raise ValueError(f"no part of the step grows with the batch ({b1}, {b2})")
        mb = max(0, min(grows + [0 if e > cap else grows[0] for e, s in lines if s <= 0]))
        return mb, max(e + max(mb, 1) * s for e, s in lines)

    def fits(b: int) -> bool:
        return at(b)["peak_bytes"] <= cap

    mb, predicted = solve(1, G if G > 1 else 2)
    for _ in range(6):  # the check, at the solved batch and the next one
        if mb > 0 and not fits(mb):  # again, through the batch that missed
            mb, predicted = solve(1, mb) if mb > 1 else (0, Fraction(at(1)["peak_bytes"]))
        elif fits(mb + 1):  # the lines were high: again, through the two that fit
            mb, predicted = solve(max(mb, 1), max(mb, 1) + 1)
        else:
            break
    else:
        raise ValueError(f"the largest batch under {cap} B did not settle: {mb}")
    peak = at(G)["peak_bytes"]

    def traced(b: int) -> dict:
        return {"batch": b, **{k: v for k, v in at(b).items() if k not in _PER_DEVICE}}

    return {"peak_bytes": peak, "capacity_bytes": cap, "fits": peak <= cap, "max_batch": mb,
            "allocator": ALLOCATOR,
            "check": {**traced(max(mb, 1)), "predicted_peak_bytes": float(predicted)},
            "next": traced(mb + 1)}


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------

def run_cell(arch: str, shape: str | ShapeConfig, multi_pod: bool, *, save: bool = True,
             verbose: bool = True, cfg_transform=None, tag: str = "",
             out_dir: pathlib.Path | None = None, traced: dict | None = None) -> dict:
    """One cell's record.  ``cfg_transform``: a ModelConfig -> ModelConfig
    hook applied after ``production_cfg`` (the tests' reduced configs);
    ``tag`` suffixes the mesh's name in the record and its file; ``traced``,
    a dict the caller keeps, lets the other mesh of the same (arch, shape)
    reuse the trace, which does not depend on the mesh."""
    cfg = production_cfg(C.get_config(arch))
    if cfg_transform is not None:
        cfg = cfg_transform(cfg)
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    mesh = "multi" if multi_pod else "single"
    rec: dict = {"arch": arch, "shape": shape.name, "mesh": mesh + (f"__{tag}" if tag else "")}
    ok, why = cell_supported(cfg, shape)
    if not ok:
        rec.update(status="skipped", reason=why)
    else:
        t0 = time.perf_counter()
        try:
            params = transformer.param_shapes(cfg)
            sizes, _ = MESHES[mesh]
            rec["chips"] = math.prod(sizes.values())
            rec["layout"] = layout(cfg, shape, mesh, input_specs(cfg, shape, params=params))
            key = (arch, shape, cfg)
            result = traced.get(key) if traced is not None else None
            if result is None:
                cell = CellCounts(cfg, shape, params)
                result = {"work": cell.at(shape.global_batch), "one_card": one_card(cell)}
                if traced is not None:
                    traced[key] = result
            work = result["work"]
            t1 = time.perf_counter()
            part = CellCounts(cfg, shape, params, mesh).at(shape.global_batch)
            rec.update(
                status="ok",
                work={"flops": work["flops"], "flops_by": work["flops_by"],
                      "hbm_bytes": work["hbm_bytes"], "arg_bytes": work["arg_bytes"],
                      "hbm_bytes_from": "sizes: each non-view op's inputs read and outputs "
                                        "written once, each kernel by kernels/cost.py",
                      "kernel_calls": work["kernel_calls"], "outputs": work["outputs"],
                      **({"lengths": work["lengths"]} if "lengths" in work else {})},
                one_card=result["one_card"], **per_device(part, shape),
                partition_trace_s=round(time.perf_counter() - t1, 2),
            partition_traced_by=f"torch {torch.__version__}, a "
                                f"{'cuda' if torch.backends.cuda.is_built() else 'cpu'} mesh")
        except Exception as e:  # noqa: BLE001 — record failures as data
            rec.update(status="error", error=f"{type(e).__name__}: {e}",
                       traceback=traceback.format_exc()[-2000:])
        rec["trace_s"] = round(time.perf_counter() - t0, 2)
    if verbose:
        print(summary(rec), flush=True)
    if save:
        _save(rec, OUT_DIR if out_dir is None else out_dir)
    return rec


def per_device(part: dict, shape: ShapeConfig) -> dict:
    """The reference's per-device fields from rank 0's trace (``part``):
    ``flops_per_partition`` and ``bytes_per_partition`` (bytes from sizes, as
    ``work.hbm_bytes``), ``memory`` (argument, output, alias and temp bytes
    and the peak) and ``collectives``; with the trace's kernel calls, FLOPs
    by group and local output shapes (``partition``)."""
    # pos, a Python int here, is the reference's int32 scalar argument
    arg = part["arg_exact"] + (4 if shape.kind == "decode" else 0)
    fresh = part["out_exact"] - part["alias_exact"]
    return {"flops_per_partition": part["flops"], "bytes_per_partition": part["hbm_bytes"],
            "memory": {"argument_size_in_bytes": arg,
                       "output_size_in_bytes": part["out_exact"],
                       "alias_size_in_bytes": part["alias_exact"],
                       "temp_size_in_bytes": max(0, part["peak_bytes"] - part["arg_bytes"]
                                                 - fresh),
                       "peak_memory_in_bytes": part["peak_bytes"]},
            "collectives": cost.collectives_record(part["collectives"],
                                                   part["collectives"]["count"]),
            "partition": {"kernel_calls": part["kernel_calls"], "flops_by": part["flops_by"],
                          "outputs": part["outputs"],
                          **({"lengths": part["lengths"]} if "lengths" in part else {})}}


def summary(rec: dict) -> str:
    head = f"[dryrun] {rec['arch']} {rec['shape']} {rec['mesh']}: {rec['status']}"
    if rec["status"] == "skipped":
        return f"{head} ({rec['reason']})"
    lay = rec.get("layout", {}).get("argument_size_in_bytes")
    if rec["status"] == "error":
        return f"{head}: {rec['error']} (layout {lay} B a device)"
    w, oc, c = rec["work"], rec["one_card"], rec["collectives"]
    return (f"{head}: {lay} B a device; step {w['flops']:.4e} FLOPs, {w['hbm_bytes']:.4e} B "
            f"(sizes), calls {w['kernel_calls']}; one card: peak {oc['peak_bytes'] / 1e9:.3f} GB"
            f" fits {oc['fits']}, max batch {oc['max_batch']}; a device: "
            f"{rec['flops_per_partition']:.4e} FLOPs, peak "
            f"{rec['memory']['peak_memory_in_bytes'] / 1e9:.3f} GB, {c['count']} collectives "
            f"{c['weighted_link_traffic']:.4e} B weighted; {rec['trace_s']} s")


def _save(rec: dict, out_dir: pathlib.Path) -> None:
    out_dir.mkdir(parents=True, exist_ok=True)
    p = out_dir / f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json"
    p.write_text(json.dumps(rec, indent=1, default=str))


def table(out_dir: pathlib.Path) -> str:
    """The per-device columns of the records in ``out_dir`` as a markdown
    table, a row an arch: its supported cells in shape order, separated by
    ";", each "(16, 16) / (2, 16, 16)"; a cell that records a failure (a
    wrapper's refusal) reads "refused", a record not written "—"."""
    recs: dict = collections.defaultdict(dict)
    for p in sorted(out_dir.glob("*.json")):
        r = json.loads(p.read_text())
        if r["status"] != "skipped":
            recs[r["arch"]].setdefault(r["shape"], {})[r["mesh"]] = r

    def one(r: dict | None, fn) -> str:
        return "—" if r is None else fn(r) if r["status"] == "ok" else "refused"

    def col(cells: dict, fn) -> str:
        return " ; ".join(" / ".join(one(c.get(m), fn) for m in ("single", "multi"))
                          for c in cells.values())

    rows = ["| Arch: cells | FLOPs a device | × chips / step's | Peak a device, GB | "
            "Collectives | Weighted link B |", "|" + "---|" * 6]
    for arch, by_shape in sorted(recs.items()):
        cells = {sh: by_shape[sh] for sh in SHAPES if sh in by_shape}
        rows.append("| " + f"{arch}: {' / '.join(cells)}" + " | " + " | ".join((
            col(cells, lambda r: f"{r['flops_per_partition']:.3e}"),
            col(cells, lambda r: f"{r['flops_per_partition'] * r['chips'] / r['work']['flops']:.3f}"),
            col(cells, lambda r: f"{r['memory']['peak_memory_in_bytes'] / 1e9:.3f}"),
            col(cells, lambda r: str(r["collectives"]["count"])),
            col(cells, lambda r: f"{r['collectives']['weighted_link_traffic']:.3e}"))) + " |")
    return "\n".join(rows)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--table", default=None, metavar="DIR",
                    help="print the per-device columns of DIR's records and exit")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default=str(OUT_DIR))
    args = ap.parse_args(argv)
    if args.table:
        print(table(pathlib.Path(args.table)))
        return 0
    if not (args.all or (args.arch and args.shape)):
        ap.error("pass --all or both --arch and --shape")
    archs = list(C.ARCH_IDS) if args.arch is None else [args.arch]
    shapes = list(SHAPES) if args.shape is None else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    out_dir = pathlib.Path(args.out)
    n = collections.Counter()
    traced: dict = {}
    t0 = time.perf_counter()
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                name = ("multi" if mp else "single") + (f"__{args.tag}" if args.tag else "")
                path = out_dir / f"{arch}__{shape}__{name}.json"
                if args.skip_existing and path.exists() \
                        and json.loads(path.read_text()).get("status") in ("ok", "skipped"):
                    continue
                rec = run_cell(arch, shape, mp, tag=args.tag, out_dir=out_dir, traced=traced)
                n[rec["status"]] += 1
            traced.clear()
    print(f"[dryrun] done: {n['ok']} ok, {n['skipped']} skipped, {n['error']} errors in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
