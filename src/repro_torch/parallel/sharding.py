"""Sharding rules on a ``DeviceMesh`` (port of ``repro.parallel.sharding``).

Strategy, as the reference's: 2-D "fsdp x tensor".  Parameters shard their
feature dims on the ``model`` axis (tensor and expert parallelism) and, for
FSDP, a second dim on ``data`` (+ ``pod`` on the multi-pod mesh).  Every rule
is checked against the actual dim sizes: a mesh axis that does not divide its
dim is dropped, so one rule table serves every architecture.

The torch counterparts of the reference's types: a
``torch.distributed.device_mesh.DeviceMesh`` for ``jax.sharding.Mesh``,
:class:`Spec` for ``PartitionSpec`` (one entry a tensor dim: ``None``, a mesh
axis name, or a tuple of names), ``DTensor`` placements (``Shard(d)`` /
``Replicate()``, :func:`placements`) for ``NamedSharding``.  The rules read
only axis sizes (:func:`mesh_sizes`), so they also run on a plain
``{name: size}`` mapping, with no process group.

The port keeps a model's blocks as a list of per-layer trees where the
reference stacks them over pattern groups; :func:`param_pspecs` gives a
layer's leaf the reference's spec of the stacked leaf without its leading
(layer-stack) entry.

Layouts are DTensors: parameters placed by :func:`shard_params`, a step's
inputs by :func:`place_batch` and :func:`place_cache` (the reference's
``in_shardings``), checkpoints restored with ``shardings=``.  Under an
active mesh (:func:`set_active_mesh`) a model given DTensors runs each
rank's part of the step: activations are batch-sharded DTensors at the
reference's constraint sites (:func:`with_dp_constraint` after each block,
:func:`constrain` on the logits, the MoE's buffers and ``ref._row_shard``'s
rows), each weight is gathered over the data axes before its product
(:func:`gathered`, FSDP's program: column-parallel on ``model`` in,
row-parallel out), and each kernel runs on its rank's local shard through
:func:`local_call` (``local_map``), so a kernel wrapper never sees a
DTensor.  A model given plain tensors, under a mesh or not, runs as before on
tensors that hold the whole value on every rank; the modules that use a mesh
on them (the MoE's expert path, the engine, the pipeline) take their rank's
part and give back whole values.  :func:`constrain` and
:func:`with_dp_constraint` refuse a plain tensor under a mesh of more than
one device, which cannot carry the layout they name; the models call them
on DTensors only.
"""

from __future__ import annotations

import dataclasses
import re
from collections.abc import Mapping
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    """Logical axis-name bundles for the active mesh."""
    data: tuple[str, ...] = ("data",)   # ("pod","data") on the multi-pod mesh
    model: str = "model"

    @property
    def dp(self) -> tuple[str, ...]:
        return self.data


class Spec(tuple):
    """``PartitionSpec``'s counterpart: one entry a tensor dim, ``None``
    (replicated), a mesh axis name, or a tuple of names (sharded over their
    product, the first outermost)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return "Spec" + tuple.__repr__(self)


# Pattern table, the reference's: (regex on the parameter path, spec names
# per trailing dim).  d = d_model-like dim -> FSDP ('data'), f = feature/out
# dim -> TP ('model'), E = expert dim -> EP ('model').
_RULES: list[tuple[str, list[str | None]]] = [
    (r"embed/table$",          ["model", "data"]),   # (V, d)
    (r"lm_head$",              ["data", "model"]),   # (d, V)
    (r"(attn|mla)/(wq|wk|wv|wqkv|wkv|wq_a|wq_b|wkv_a|wkv_b)$",
                               ["data", "model"]),
    (r"(attn|mla)/wo$",        ["model", "data"]),
    (r"mlp/(w_in|w_gate)$",    ["data", "model"]),   # (d, f)
    (r"mlp/w_out$",            ["model", "data"]),   # (f, d)
    (r"moe/router$",           ["data", None]),      # (d, E)
    (r"moe/(w_in|w_gate)$",    ["model", "data", None]),  # (E, d, f) — EP
    (r"moe/w_out$",            ["model", None, "data"]),  # (E, f, d)
    (r"(ssm|mlstm)/(w_x|w_z|w_bc|w_dt|w_qkv|w_up|w_gates)$",
                               ["data", "model"]),
    (r"(ssm|mlstm|slstm)/w_out$", ["model", "data"]),
    (r"slstm/w$",              ["data", "model"]),
    (r"slstm/r$",              [None, None, None]),
    (r"conv$",                 [None, None]),
    (r"norm\w*/scale$",        [None]),
    (r"bias$",                 [None]),
    (r"(A_log|dt_bias|D)$",    [None]),
]


def mesh_sizes(mesh: Any) -> dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or of a plain mapping."""
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    return {name: mesh.size(i) for i, name in enumerate(mesh.mesh_dim_names)}


def _axis_size(sizes: dict[str, int], name: str | None, axes: MeshAxes) -> int:
    if name is None:
        return 1
    if name == "data":
        s = 1
        for a in axes.dp:
            s *= sizes[a]
        return s
    return sizes[axes.model]


def _to_spec(names: list[str | None], shape: tuple[int, ...], mesh: Any,
             axes: MeshAxes, fsdp: bool) -> Spec:
    """Map logical names to mesh axes, dropping non-dividing ones."""
    sizes = mesh_sizes(mesh)
    out: list[Any] = []
    offset = len(shape) - len(names)
    if offset < 0:
        raise ValueError(f"spec names {names} for a tensor of shape {tuple(shape)}")
    out.extend([None] * offset)  # leading stacked-layer dims: replicated
    for k, nm in enumerate(names):
        dim = shape[offset + k]
        if nm == "data_model":  # shard over every axis (data ∪ model)
            full = tuple(axes.dp) + (axes.model,)
            size = 1
            for a in full:
                size *= sizes[a]
            out.append(full if dim % size == 0 else None)
        elif nm == "model":
            out.append(axes.model if dim % sizes[axes.model] == 0 else None)
        elif nm == "data":
            if not fsdp:
                out.append(None)
                continue
            size = _axis_size(sizes, "data", axes)
            if dim % size == 0:
                out.append(axes.dp if len(axes.dp) > 1 else axes.dp[0])
            elif dim % sizes[axes.dp[-1]] == 0:
                out.append(axes.dp[-1])  # shard on intra-pod data only
            else:
                out.append(None)
        else:
            out.append(None)
    # A mesh axis may shard one dim only (GSPMD's rule, and a DTensor's
    # placements hold one entry a mesh dim): drop a later use.
    seen: set[str] = set()
    clean: list[Any] = []
    for s in out:
        flat = s if isinstance(s, tuple) else ((s,) if s else ())
        if any(a in seen for a in flat):
            clean.append(None)
        else:
            seen.update(flat)
            clean.append(s)
    return Spec(*clean)


def _leaf_spec(path: str, shape: tuple[int, ...], mesh: Any, axes: MeshAxes,
               fsdp: bool) -> Spec:
    for pat, names in _RULES:
        if re.search(pat, path):
            return _to_spec(list(names), shape, mesh, axes, fsdp)
    # default: try the model axis on the largest dim if it divides
    if len(shape) >= 2:
        big = max(range(len(shape)), key=lambda i: shape[i])
        specs: list[str | None] = [None] * len(shape)
        specs[big] = "model" if shape[big] % mesh_sizes(mesh)[axes.model] == 0 else None
        return _to_spec(specs, shape, mesh, axes, fsdp)
    return Spec()


def _flat_shapes(tree: Any, path: str = "") -> list[tuple[str, tuple, Any]]:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _flat_shapes(tree[k], f"{path}/{k}")]
    return [(path, tuple(tree.shape), tree.dtype)]


def _stack_len(blocks: list) -> int:
    """The reference's leading group axis G of a stacked leaf: the number of
    repeats of the shortest period of per-layer trees (``block_pattern``'s
    length where its kinds differ, as xLSTM's 7 mLSTM + 1 sLSTM)."""
    sig = [_flat_shapes(b) for b in blocks]
    n = len(blocks)
    period = next(p for p in range(1, n + 1)
                  if n % p == 0 and all(sig[i] == sig[i % p] for i in range(n)))
    return n // period


def param_pspecs(params: Any, mesh: Any, axes: MeshAxes | None = None, *,
                 fsdp: bool = True) -> Any:
    """:class:`Spec` tree mirroring ``params`` (dicts and lists whose leaves
    have a ``shape``: tensors, meta tensors from ``param_shapes``).  A leaf of
    ``params["blocks"][l]`` gets its spec from the stacked shape (G, *shape),
    as the reference computes it, without the stack's entry."""
    axes = axes or MeshAxes()

    def visit(path: str, node: Any, stack: int) -> Any:
        if isinstance(node, dict):
            return {k: visit(f"{path}/{k}" if path else k, v, stack) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            if path == "blocks" and stack == 0 and node:
                stack = _stack_len(list(node))
            out = [visit(path, v, stack) for v in node]
            return type(node)(out) if isinstance(node, tuple) else out
        shape = tuple(node.shape)
        if not stack:
            return _leaf_spec(path, shape, mesh, axes, fsdp)
        return Spec(*_leaf_spec(path, (stack,) + shape, mesh, axes, fsdp)[1:])

    return visit("", params, 0)


def batch_spec(axes: MeshAxes | None = None, *, batch_divisible: bool = True,
               ndim: int = 2) -> Spec:
    """Inputs (B, S, ...): batch over (pod, data) when divisible."""
    axes = axes or MeshAxes()
    b = (axes.dp if len(axes.dp) > 1 else axes.dp[0]) if batch_divisible else None
    return Spec(b, *([None] * (ndim - 1)))


def cache_pspec(n_kv: int, batch: int, mesh: Any, axes: MeshAxes | None = None) -> Spec:
    """KV cache (L, B, S, n_kv, hd): batch -> data when divisible, kv heads ->
    model when divisible, else sequence -> model (decode context
    parallelism)."""
    axes = axes or MeshAxes()
    sizes = mesh_sizes(mesh)
    dsize = _axis_size(sizes, "data", axes)
    b = (axes.dp if len(axes.dp) > 1 else axes.dp[0]) if batch % dsize == 0 else None
    if n_kv % sizes[axes.model] == 0:
        return Spec(None, b, None, axes.model, None)
    return Spec(None, b, axes.model, None, None)


# --- spec -> layout ---------------------------------------------------------

def placements(spec: Spec, mesh: Any) -> list:
    """One DTensor placement a mesh dim: ``Shard(d)`` on every mesh dim that
    tensor dim d's entry names (in mesh order, so ("pod", "data") shards
    pod-major, as the reference's tiling does), ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        axis_names = entry if isinstance(entry, tuple) else (() if entry is None else (entry,))
        idx = [names.index(a) for a in axis_names]
        if idx != sorted(idx) or any(isinstance(out[i], Shard) for i in idx):
            raise ValueError(f"spec {spec} does not map onto mesh dims {names}")
        for i in idx:
            out[i] = Shard(dim)
    return out


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (``jax.sharding.NamedSharding``'s counterpart)."""
    mesh: Any
    spec: Spec

    def place(self, t: torch.Tensor):
        """``t`` (the whole value, the same on every rank) as a DTensor on
        the mesh; each rank keeps its own slice, with no communication."""
        from torch.distributed.tensor import distribute_tensor
        return distribute_tensor(t.to(self.mesh.device_type), self.mesh,
                                 placements(self.spec, self.mesh), src_data_rank=None)


def named_shardings(mesh: Any, specs: Any) -> Any:
    """The tree of ``NamedSharding(mesh, spec)`` for a :class:`Spec` tree
    (``param_pspecs``): what ``CheckpointManager.restore(shardings=)``
    takes."""
    if isinstance(specs, dict):
        return {k: named_shardings(mesh, v) for k, v in specs.items()}
    if isinstance(specs, list):
        return [named_shardings(mesh, v) for v in specs]
    return NamedSharding(mesh, specs)


def _map2(tree: Any, other: Any, fn) -> Any:
    if isinstance(tree, dict):
        return {k: _map2(v, other[k], fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map2(v, o, fn) for v, o in zip(tree, other)]
    return fn(tree, other)


def shard_params(params: Any, mesh: Any, specs: Any) -> Any:
    """``params`` as DTensors placed by ``specs`` (``param_pspecs``) on
    ``mesh``: the counterpart of ``device_put(params, NamedSharding)``."""
    return _map2(params, named_shardings(mesh, specs), lambda t, s: s.place(t))


# --- active mesh context (set by the caller; absent on one device) ---------
_ACTIVE: dict[str, Any] = {"mesh": None, "axes": MeshAxes()}


def set_active_mesh(mesh: Any | None, axes: MeshAxes | None = None) -> None:
    _ACTIVE["mesh"] = mesh
    _ACTIVE["axes"] = axes or MeshAxes()


def active_mesh() -> tuple[Any | None, MeshAxes]:
    return _ACTIVE["mesh"], _ACTIVE["axes"]


def is_dtensor(x: Any) -> bool:
    """Whether ``x`` is a DTensor (the models' test for the sharded path)."""
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _layout(x: torch.Tensor, spec: Spec, mesh: Any) -> torch.Tensor:
    """``x`` redistributed to ``spec`` where it is a DTensor; a plain tensor
    passes only under a mesh of one device, where it is its own shard."""
    if is_dtensor(x):
        return x.redistribute(mesh, placements(spec, mesh))
    n = 1
    for s in mesh_sizes(mesh).values():
        n *= s
    if n > 1:
        raise TypeError(f"a plain tensor {tuple(x.shape)} under a mesh of {n} devices: its "
                        "layout is unknown; pass a DTensor")
    return x


def constrain(x: torch.Tensor, names: tuple[str | None, ...]) -> torch.Tensor:
    """Lay ``x`` out by logical names ('data'/'model'/None a dim) with the
    divisibility guards.  Returns ``x`` itself when no mesh is active."""
    mesh, axes = active_mesh()
    if mesh is None:
        return x
    return _layout(x, _to_spec(list(names), tuple(x.shape), mesh, axes, fsdp=True), mesh)


def with_dp_constraint(x: torch.Tensor, batch_divisible: bool = True) -> torch.Tensor:
    """Lay an activation (B, S, d) out batch-sharded over the data axes.
    Returns ``x`` itself when no mesh is active."""
    mesh, axes = active_mesh()
    if mesh is None:
        return x
    return _layout(x, batch_spec(axes, batch_divisible=batch_divisible, ndim=x.dim()), mesh)


# --- the sharded step: DTensor activations on the active mesh ----------------
# A recorder of the constraint sites a step passes (tests only): a list that
# takes (site, global shape, local shape) at each, or None.
SITES: list | None = None


def _record(site: str, x: Any) -> None:
    if SITES is not None and is_dtensor(x):
        SITES.append((site, tuple(x.shape), tuple(x.to_local().shape)))


def dsize(mesh: Any, axes: MeshAxes) -> int:
    """The product of the data axes' sizes."""
    return _axis_size(mesh_sizes(mesh), "data", axes)


def dp_site(x: torch.Tensor) -> torch.Tensor:
    """The reference's ``with_dp_constraint`` site after a block: a DTensor
    laid out batch-sharded (where the batch divides the data axes, else
    replicated: a padded shard's per-device shape, as GSPMD pads it);
    anything else returned as it is."""
    mesh, axes = active_mesh()
    if mesh is None or not is_dtensor(x):
        return x
    x = with_dp_constraint(x, batch_divisible=x.shape[0] % dsize(mesh, axes) == 0)
    _record("dp", x)
    return x


def site(x: torch.Tensor, names: tuple[str | None, ...], name: str) -> torch.Tensor:
    """A reference ``constrain`` site (``name`` for the record): a DTensor
    laid out by logical names; anything else returned as it is."""
    mesh, _ = active_mesh()
    if mesh is None or not is_dtensor(x):
        return x
    x = constrain(x, names)
    _record(name, x)
    return x


def _replicate_axes(x, names: set[str]):
    mesh = x.device_mesh
    from torch.distributed.tensor import Replicate
    want = [Replicate() if n in names else p
            for n, p in zip(mesh.mesh_dim_names, x.placements)]
    return x if tuple(want) == tuple(x.placements) else x.redistribute(mesh, want)


def gathered(w: torch.Tensor) -> torch.Tensor:
    """A weight at its compute placement: a DTensor gathered over the data
    axes (FSDP's all-gather before the product), its ``model`` placement
    kept (column- or row-parallel); a plain tensor as it is."""
    if not is_dtensor(w):
        return w
    _, axes = active_mesh()
    return _replicate_axes(w, set(axes.dp))


def whole(x: torch.Tensor) -> torch.Tensor:
    """A DTensor replicated on every mesh axis (a plain tensor as it is)."""
    if not is_dtensor(x):
        return x
    return _replicate_axes(x, set(x.device_mesh.mesh_dim_names))


def batch_layout(x: torch.Tensor) -> torch.Tensor:
    """A DTensor redistributed to an activation's layout (batch on the data
    axes where it divides, replicated on ``model``) with no site recorded:
    the row-parallel products' all-reduce.  A plain tensor as it is."""
    if not is_dtensor(x):
        return x
    mesh, axes = active_mesh()
    spec = batch_spec(axes, batch_divisible=x.shape[0] % dsize(mesh, axes) == 0,
                      ndim=x.dim())
    return x.redistribute(mesh, placements(spec, mesh))


def heads_whole(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """A projection's output (.., n_heads * d) ready to be cut into heads:
    where a DTensor's last dim lies on mesh axes in pieces that do not hold
    whole heads, it is gathered there first.  Under autograd a reshape runs
    as a view, which DTensor cannot unflatten over an uneven split; in
    inference mode DTensor's own reshape gathers the same way, so prefill
    and the train step run one program.  A plain tensor as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Shard
    d = x.dim() - 1
    ways = 1
    for i, pl in enumerate(x.placements):
        if isinstance(pl, Shard) and pl.dim == d:
            ways *= x.device_mesh.size(i)
    if n_heads % ways == 0:
        return x
    return x.redistribute(x.device_mesh, whole_dims(x, (d,)))


class _OwnLayoutGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.placements = x.placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(g.device_mesh, ctx.placements)


def own_layout_grad(x: torch.Tensor) -> torch.Tensor:
    """``x`` as it is, its gradient laid out as x is (a replicated gradient
    cut to each rank's part, a pending sum reduce-scattered).  On a
    column-parallel product's output, the weight's gradient is then each
    rank's columns: a split or view downstream that DTensor can only take
    whole (q, k and v out of a fused projection) hands back a gradient whole
    on ``model``, and the product's backward would run at full width on
    every rank.  A plain tensor as it is."""
    return _OwnLayoutGrad.apply(x) if is_dtensor(x) else x


def mean(x: torch.Tensor) -> torch.Tensor:
    """``x.mean()``; a DTensor's as each rank's mean of its shard weighted by
    its share of the elements (exactly 1 in a world of one), reduced to a
    replicated scalar.  Its gradient comes back in x's own layout: DTensor's
    mean hands back a gradient of x's global shape, whole on every rank."""
    if not is_dtensor(x):
        return x.mean()
    from torch.distributed.tensor import Partial, Shard
    n, mesh = x.numel(), x.device_mesh
    pl = list(x.placements)
    part = [Partial() if isinstance(p, Shard) else p for p in pl]
    return local_call(lambda t: t.mean() * (t.numel() / n), (x,), (pl,), part,
                      mesh).redistribute(mesh, replicated(x))


def like(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``x`` laid out as ``ref`` is (a decode step's new state as its
    cache's leaf, the reference's ``out_shardings``); plain tensors pass."""
    if not (is_dtensor(x) and is_dtensor(ref)):
        return x
    return x.redistribute(ref.device_mesh, ref.placements)


def replicated_like(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A plain tensor ``t`` that is the same on every rank (a mask, a
    position table) as a replicated DTensor on ``x``'s mesh where ``x`` is a
    DTensor, so the two can meet in one op; else ``t`` itself."""
    if not is_dtensor(x):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    mesh = x.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def local_call(fn, args: tuple, in_placements: tuple, out_placements, mesh: Any,
               **kwargs):
    """``fn`` on each rank's local shards: the one place a kernel call becomes
    a ``local_map`` over the placements it needs.  ``in_placements`` gives
    one entry an argument (a placement list, or None for a non-DTensor);
    DTensor arguments are redistributed to them, and the outputs wrapped as
    DTensors with ``out_placements`` (a list, or a tuple of lists for several
    outputs).  ``fn`` sees plain tensors only.

    The backward: an input replicated on a mesh axis over which an output is
    sharded met only its rank's part of the work there, so its gradient is
    a pending sum on that axis (``Partial``), as a replicated weight's is."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    outs = out_placements if isinstance(out_placements, tuple) else (out_placements,)
    split = [any(isinstance(o[i], Shard) for o in outs if o is not None)
             for i in range(mesh.ndim)]
    grads = tuple(None if pl is None else
                  [Partial() if isinstance(p, Replicate) and split[i] else p
                   for i, p in enumerate(pl)] for pl in in_placements)
    kw = {} if grads == tuple(in_placements) else {"in_grad_placements": grads}
    mapped = local_map(lambda *a: fn(*a, **kwargs), out_placements=out_placements,
                       in_placements=in_placements, device_mesh=mesh,
                       redistribute_inputs=True, **kw)
    return mapped(*args)


# --- placement lists of a DTensor's mesh (the kernels' local_call layouts) ---

def replicated(x: torch.Tensor) -> list:
    """Replicate() on every axis of x's mesh."""
    from torch.distributed.tensor import Replicate
    return [Replicate()] * x.device_mesh.ndim


def whole_dims(x: torch.Tensor, dims: tuple[int, ...]) -> list:
    """x's placements with every shard of ``dims`` (and any pending sum)
    replicated."""
    from torch.distributed.tensor import Replicate, Shard
    return [Replicate() if not isinstance(p, Shard) or p.dim in dims else p
            for p in x.placements]


def axis_placements(x: torch.Tensor, data, model) -> list:
    """A placement list on x's mesh: ``data`` on each data axis, ``model``
    on the model axis."""
    _, axes = active_mesh()
    return [model if n == axes.model else data for n in x.device_mesh.mesh_dim_names]


def data_placement(x: torch.Tensor):
    """Shard(0) where x's batch lies on every data axis, else Replicate."""
    from torch.distributed.tensor import Replicate, Shard
    _, axes = active_mesh()
    pl = dict(zip(x.device_mesh.mesh_dim_names, x.placements))
    return Shard(0) if all(pl[a] == Shard(0) for a in axes.dp) else Replicate()


def model_placement(x: torch.Tensor):
    """x's placement on the model axis."""
    _, axes = active_mesh()
    return dict(zip(x.device_mesh.mesh_dim_names, x.placements))[axes.model]


def scan_placements(x: torch.Tensor) -> tuple[list, list]:
    """The placements of a scan that runs on each rank's batch and heads, x
    (B, S, H, ...) its input: (for (B, S, H, ...) operands, for (B, H, ...)
    states).  The batch on the data axes where x has it there, the heads on
    ``model`` where x has them there, else whole."""
    from torch.distributed.tensor import Replicate, Shard
    dat = data_placement(x)
    heads = model_placement(x) == Shard(2)
    return (axis_placements(x, dat, Shard(2) if heads else Replicate()),
            axis_placements(x, dat, Shard(1) if heads else Replicate()))


def head_split(x: torch.Tensor, n_heads: int) -> int:
    """Model ranks across which each head of ``x`` (B, S, n_heads, P), whole
    on ``model``, is cut by its P, where the model axis holds a multiple of
    the heads: its size over ``n_heads`` (xLSTM's 4 heads of 1024 on 16 ranks:
    4 ranks a head, 256 of its P each, the layout the reference's partitioner
    gives the mLSTM cell).  0 where the heads divide ``model``, where they
    do not cut evenly this way, or where x is not whole there."""
    from torch.distributed.tensor import Replicate
    _, axes = active_mesh()
    m = mesh_sizes(x.device_mesh)[axes.model]
    if (m <= n_heads or m % n_heads or x.shape[-1] % (m // n_heads)
            or model_placement(x) != Replicate()):
        return 0
    return m // n_heads


def batch_rows(x: torch.Tensor) -> list:
    """The placements of a loop over time that runs on each rank's batch
    rows, x (B, ...) its input: the batch on the data axes where x has it
    there, and on ``model`` too where each data group's rows divide among
    its model ranks (xLSTM's sLSTM at train_4k on (16, 16): a sequence a
    rank), else whole on ``model``."""
    from torch.distributed.tensor import Replicate, Shard
    _, axes = active_mesh()
    dat = data_placement(x)
    m = mesh_sizes(x.device_mesh)[axes.model]
    rows = x.shape[0] // dsize(x.device_mesh, axes) if dat == Shard(0) else 0
    split = m > 1 and rows and rows % m == 0
    return axis_placements(x, dat, Shard(0) if split else Replicate())


def model_rank(mesh: Any, axes: MeshAxes | None = None) -> int:
    axes = axes or active_mesh()[1]
    return mesh.get_local_rank(axes.model)


def place_batch(batch: dict, mesh: Any, axes: MeshAxes | None = None) -> dict:
    """A step's batch (tokens, labels, embeds: (B, ...) whole on every rank)
    as DTensors: batch over the data axes where it divides, as the
    reference's ``in_shardings`` (``batch_spec``)."""
    axes = axes or MeshAxes()
    out = {}
    for k, t in batch.items():
        spec = batch_spec(axes, batch_divisible=t.shape[0] % dsize(mesh, axes) == 0,
                          ndim=t.dim())
        out[k] = NamedSharding(mesh, spec).place(t)
    return out


def cache_leaf_spec(name: str, shape: tuple[int, ...], n_kv: int, mesh: Any,
                    axes: MeshAxes | None = None) -> Spec:
    """A layer's cache leaf's spec: k and v (B, S, n_kv, hd) by
    :func:`cache_pspec` (kv heads on ``model`` where they divide, else the
    sequence: decode context parallelism), without its stack entry; every
    other leaf (an SSM's or xLSTM's state, MLA's latent) as the reference's
    dry-run lays it out: batch over the data axes where it divides, the first
    later dim the model axis divides on ``model``."""
    axes = axes or MeshAxes()
    sizes = mesh_sizes(mesh)
    if name in ("k", "v"):
        spec = Spec(*cache_pspec(n_kv, shape[0], mesh, axes)[1:])
        if spec[1] is not None and shape[1] % sizes[axes.model]:
            spec = Spec(spec[0], None, None, None)   # no even sequence split
        return spec
    dp = axes.dp if len(axes.dp) > 1 else axes.dp[0]
    out: list = [None] * len(shape)
    if shape and shape[0] % dsize(mesh, axes) == 0:
        out[0] = dp
    for i in range(1, len(shape)):
        if shape[i] % sizes[axes.model] == 0:
            out[i] = axes.model
            break
    return Spec(*out)


def place_cache(cache: list, n_kv: int, mesh: Any, axes: MeshAxes | None = None) -> list:
    """A per-layer cache (whole values, or a prefill's DTensor outputs) laid
    out by :func:`cache_leaf_spec`."""
    axes = axes or MeshAxes()
    out = []
    for layer in cache:
        one = {}
        for k, t in layer.items():
            spec = cache_leaf_spec(k, tuple(t.shape), n_kv, mesh, axes)
            one[k] = (t.redistribute(mesh, placements(spec, mesh)) if is_dtensor(t)
                      else NamedSharding(mesh, spec).place(t))
        out.append(one)
    return out
