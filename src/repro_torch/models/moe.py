"""Mixture-of-Experts FFN with top-k routing (port of ``repro.models.moe``).

Two implementations behind ``cfg.moe.impl``, as in the reference:

* ``scatter``: slots grouped by expert with a stable argsort, packed into
  per-expert capacity buffers of ``cap = max(1, int(T*K*capacity_factor/E))``
  rows by a scatter-add, run through each expert's SwiGLU as batched
  products, and combined back with the gate weights (each token's K slots
  summed in a fixed order, so a run on the card is reproducible).  A slot past its
  expert's capacity is dropped: within an expert the slots keep their flat
  order t*K + k, so the lowest ``cap`` of them are kept.
* ``einsum``: every expert on every token, masked by the summed gates: exact
  top-k, no drops (the reduced configs' choice).

``shard_map`` (both published MoE configs) is the reference's explicit-
collective expert parallelism (:func:`_moe_expert_parallel`), taken under an
active mesh (``parallel.sharding.set_active_mesh``) where the tokens divide
the data axes and number at least ``SHARD_MAP_MIN_TOKENS``; elsewhere it
runs ``scatter``, as in the reference.  The expert products are XLA einsums
in the reference, not Pallas kernels, so they stay ``torch.bmm``.

Parameters: ``router`` (d, E) in f32 whatever the model's dtype (its logits
are f32 too), ``w_in``/``w_gate`` (E, d, f), ``w_out`` (E, f, d).

Under the active mesh, on DTensors (``parallel.sharding``), ``scatter``
and ``einsum`` route every token on every rank (the tokens gathered, as the
reference's global routing is; the router gathered whole), and ``scatter``
lays its (E, cap, d) buffers out at the reference's two constraint sites,
before and after the experts: ``("model", "data", None)`` where E divides
``model`` (each rank its experts and its share of their slots), else
``(None, "data_model", None)`` (each rank its share of every expert's
slots), the expert weights gathered over the data axes only.  Where E lies
on ``model`` and moving the buffer costs fewer bytes than the weights (a
decode's few slots an expert), no expert weight moves: each rank runs the
products on its own slice of d (:func:`_expert_ffn_by_d`).  ``einsum``
takes the whole weights.  The expert-parallel path takes each rank's token
rows and its own experts' weights, gathered over the data axes as the
reference's ``shard_map`` body gathers them, and gives back its rows of y.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..parallel import collectives, sharding
from ..parallel.sharding import active_mesh, mesh_sizes
from .common import dense_init


def moe_init(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype) -> dict:
    m = cfg.moe
    d, f, e = cfg.d_model, cfg.d_ff, m.num_experts
    return {"router": dense_init(gen, d, (d, e), torch.float32),
            "w_in": dense_init(gen, d, (e, d, f), dtype),
            "w_gate": dense_init(gen, d, (e, d, f), dtype),
            "w_out": dense_init(gen, f, (e, f, d), dtype)}


def _route(p: dict, cfg: ModelConfig, x2: torch.Tensor):
    """x2 (T, d) -> gates (T, K) f32, the softmax of the top-k logits; idx
    (T, K) int64; and the Switch load-balance loss E · sum_e f_e · p_e."""
    m = cfg.moe
    logits = x2.float() @ p["router"]                      # (T, E) f32
    topv, topi = torch.topk(logits, m.top_k, dim=-1)
    gates = torch.softmax(topv, dim=-1)
    probs = torch.softmax(logits, dim=-1)
    onehot = F.one_hot(topi[:, 0], m.num_experts).float()
    aux = m.num_experts * (probs.mean(0) * onehot.mean(0)).mean()
    return gates, topi, aux


def _expert_ffn(p: dict, xe: torch.Tensor) -> torch.Tensor:
    """xe (E, C, d) -> (E, C, d): each expert's SwiGLU on its rows."""
    h = F.silu(torch.bmm(xe, p["w_gate"])) * torch.bmm(xe, p["w_in"])
    return torch.bmm(h, p["w_out"])


def _slots(topi: torch.Tensor, E: int):
    """Slots grouped by expert: (order, expert of each sorted slot, its
    source token, its place in its expert's queue).  A stable sort, so within
    an expert the slots keep their flat order t*K + k."""
    T, K = topi.shape
    flat_e = topi.reshape(T * K)                           # expert of each slot
    order = torch.argsort(flat_e, stable=True)             # slots grouped by expert
    sorted_e = flat_e[order]
    # an exact integer count of each expert's slots, shape-static: unlike
    # bincount it runs on meta tensors too (the dry-run's trace)
    counts = torch.zeros(E, dtype=flat_e.dtype, device=flat_e.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(T * K, device=topi.device) - starts[sorted_e]  # place in its queue
    return order, sorted_e, order // K, pos


def _run_slots(p: dict, x2: torch.Tensor, gates: torch.Tensor, order: torch.Tensor,
               e: torch.Tensor, sorted_t: torch.Tensor, pos: torch.Tensor,
               keep: torch.Tensor, n_exp: int, cap: int, ffn=None) -> torch.Tensor:
    """Pack the kept slots into (n_exp, cap, d) buffers at (e, pos) by a
    scatter-add, run each expert's SwiGLU (``ffn`` of the buffer, where
    given), and sum each token's K gated slot outputs.  Returns (T, d)."""
    T, d = x2.shape
    K = gates.shape[1]
    pos_c = torch.clamp(pos, max=cap - 1)
    src = x2[sorted_t] * keep[:, None].to(x2.dtype)        # dropped slots add zeros
    xe = torch.zeros((n_exp, cap, d), dtype=x2.dtype, device=x2.device)
    xe.index_put_((e, pos_c), src, accumulate=True)
    ye = _expert_ffn(p, xe) if ffn is None else ffn(xe)   # (n_exp, cap, d)
    out_slot = ye[e, pos_c] * (gates.reshape(T * K)[order] * keep)[:, None].to(x2.dtype)
    # The reference's scatter-add of the slots onto their tokens, as a sum
    # of each token's K slots in a fixed order: on the card ``index_add_``
    # adds by atomics, in an order (and so a rounding) that changes from
    # run to run.
    by_slot = torch.empty_like(out_slot)
    by_slot[order] = out_slot                              # back to flat order t*K + k
    return by_slot.view(T, K, d).sum(1)


def _moe_scatter(p: dict, cfg: ModelConfig, x2: torch.Tensor, ffn=None):
    m = cfg.moe
    T = x2.shape[0]
    E, K = m.num_experts, m.top_k
    gates, topi, aux = _route(p, cfg, x2)
    cap = max(1, int(T * K * m.capacity_factor / E))
    order, sorted_e, sorted_t, pos = _slots(topi, E)
    y = _run_slots(p, x2, gates, order, sorted_e, sorted_t, pos, pos < cap, E, cap, ffn)
    return y, aux


def _moe_dtensor(p: dict, cfg: ModelConfig, x: torch.Tensor):
    """x (B, S, d) a DTensor under the active mesh -> (y (B, S, d) laid out
    as an activation, aux replicated)."""
    mesh, axes = active_mesh()
    B, S, d = x.shape
    m = cfg.moe
    if (m.impl == "shard_map" and (B * S) % sharding.dsize(mesh, axes) == 0
            and B * S >= SHARD_MAP_MIN_TOKENS):
        return _moe_expert_parallel_dtensor(p, cfg, x, mesh, axes)
    x2 = sharding.whole(x).to_local().reshape(B * S, d)    # every token on every rank
    if m.impl in ("scatter", "shard_map"):
        ep_ok = m.num_experts % mesh_sizes(mesh)[axes.model] == 0
        buf = ("model", "data", None) if ep_ok else (None, "data_model", None)

        def ffn(xe: torch.Tensor) -> torch.Tensor:
            xe = sharding.site(sharding.replicated_like(xe, x), buf, "moe_buffer")
            cut = _d_cut(p, xe, axes) if ep_ok else ()
            if cut:
                ye = _expert_ffn_by_d(p, xe, cut)
            else:
                ye = _expert_ffn({k: sharding.gathered(p[k]) for k in ("w_in", "w_gate", "w_out")},
                                 xe)
            ye = sharding.site(ye, buf, "moe_buffer")
            return sharding.whole(ye).to_local()
        y, aux = _moe_scatter({"router": sharding.whole(p["router"]).to_local()}, cfg, x2, ffn)
    else:
        y, aux = _moe_einsum({k: sharding.whole(v).to_local() for k, v in p.items()}, cfg, x2)
    y = sharding.batch_layout(sharding.replicated_like(y.reshape(B, S, d), x))
    return y, sharding.replicated_like(aux, x)


def _d_cut(p: dict, xe: torch.Tensor, axes) -> tuple[str, ...]:
    """The data axes over which every expert weight's d lies cut (``w_in``'s
    and ``w_gate``'s dim 1, ``w_out``'s dim 2), where they hold more than
    one rank and the expert buffer xe (E, cap, d) moves fewer bytes than the
    weights would: its products then run on each rank's slice of d
    (``_expert_ffn_by_d``), moving xe's slots (gathered where they lie on
    the data axes), the f32 partial products (an all-reduce, counted twice)
    and the output's slices, cap (2 d s + 16 f) bytes an expert against the
    three weights' 3 d f s (s the weights' bytes an element; llama4's
    decode: cap 1 against 8192 x 5120).  Empty elsewhere."""
    from torch.distributed.tensor import Shard
    w_in, w_gate, w_out = (p[k] for k in ("w_in", "w_gate", "w_out"))
    if not all(sharding.is_dtensor(w) for w in (w_in, w_gate, w_out)):
        return ()
    mesh = xe.device_mesh
    names = mesh.mesh_dim_names

    def on(w: torch.Tensor, dim: int) -> tuple[str, ...]:
        return tuple(n for n, pl in zip(names, w.placements) if n in axes.dp and pl == Shard(dim))
    cut = on(w_in, 1)
    _, cap, d = xe.shape
    f, s = w_in.shape[2], w_in.element_size()
    if (not cut or on(w_gate, 1) != cut or on(w_out, 2) != cut
            or math.prod(mesh_sizes(mesh)[n] for n in cut) == 1
            or cap * (2 * d * s + 16 * f) >= 3 * d * f * s):
        return ()
    return cut


def _expert_ffn_by_d(p: dict, xe: torch.Tensor, cut: tuple[str, ...]) -> torch.Tensor:
    """xe (E, C, d), its experts on ``model`` -> (E, C, d), whole over the
    data axes ``cut`` (``_d_cut``): each expert's SwiGLU with no expert
    weight moved.  xe is taken whole over ``cut`` (its slots gathered where
    they lie there).  The rank contracts its slice of xe's d with its own
    rows of ``w_in`` and ``w_gate``; the partial products are summed over
    ``cut`` in f32 (one all-reduce, both together) and rounded to the
    compute dtype once, as the reference's compiled decode all-reduces its
    (8, 1, 8192) partial products.  h times the rank's own columns of
    ``w_out`` gives its slice of the output's d, gathered over ``cut`` (one
    all-gather of (E, C, d / ranks)) where the reference gathers ``w_out``
    whole.  The backward gives each weight shard its own gradient and every
    rank xe's whole gradient."""
    xe = sharding.gathered(xe)
    group, _, _ = collectives.axis_group(xe.device_mesh, cut)
    ws = (p["w_in"], p["w_gate"], p["w_out"])

    def ffn(xe, w_in, w_gate, w_out):
        xs = collectives.own_part(xe, 2, group).float()
        up = torch.stack([torch.bmm(xs, w.float()) for w in (w_in, w_gate)])
        a, g = collectives.all_reduce(up, group).to(xe.dtype).unbind(0)
        # h is whole on every rank and meets each rank's own columns of w_out
        h = collectives.fan_out(F.silu(g) * a, group)
        return collectives.all_gather(torch.bmm(h, w_out), 2, group)
    pls = tuple(list(t.placements) for t in (xe,) + ws)
    return sharding.local_call(ffn, (xe,) + ws, pls, pls[0], xe.device_mesh)


def _moe_einsum(p: dict, cfg: ModelConfig, x2: torch.Tensor):
    m = cfg.moe
    T = x2.shape[0]
    gates, topi, aux = _route(p, cfg, x2)
    # (T, E): the summed gate of each expert a token chose
    comb = torch.zeros((T, m.num_experts), dtype=torch.float32, device=x2.device)
    comb.scatter_add_(1, topi, gates)
    ye = _expert_ffn(p, x2[None].expand(m.num_experts, -1, -1))
    y = torch.einsum("te,etd->td", comb.to(x2.dtype), ye)
    return y, aux


# ---------------------------------------------------------------------------
# The expert-parallel path (the reference's ``_moe_shard_map``: explicit
# collectives).  Tokens are replicated across the ``model`` axis under
# DP x TP: each model column packs only its own experts' slots locally (no
# dispatch communication), runs its expert shard, and one sum over ``model``
# combines the outputs.
# ---------------------------------------------------------------------------

SHARD_MAP_MIN_TOKENS = 16_384  # below this the reference's scatter path wins


def _padded_experts(cfg: ModelConfig, mesh, axes) -> tuple[int, int]:
    """(E_pad, experts a model column): the expert dim padded up to the model
    axis (granite's 40 -> 48 on 16); dead experts hold zero weights and never
    win routing."""
    msize = mesh_sizes(mesh)[axes.model]
    E_pad = (cfg.moe.num_experts + msize - 1) // msize * msize
    return E_pad, E_pad // msize


def _moe_expert_parallel(p: dict, cfg: ModelConfig, x2: torch.Tensor, mesh, axes):
    """Every rank runs this (SPMD), as the reference's ``shard_map`` body.
    ``p`` and ``x2`` (T, d) are plain tensors holding the whole values on
    every rank, as the reference's global arrays.  Rank (data i, model j)
    takes token rows i of the data axes and experts j of the padded expert
    axis, with its FSDP slice of their d dim, which it all-gathers over
    ``data`` as the reference does.  Returns (y (T, d), aux), both whole on
    every rank: y gathered over ``data`` after one sum over ``model``, aux
    averaged over ``data``.  The backward follows ``collectives``' loss
    convention: each rank's gradient of ``p`` and ``x2`` is the whole
    gradient."""
    E = cfg.moe.num_experts
    E_pad, _ = _padded_experts(cfg, mesh, axes)
    dgroup, _, _ = collectives.axis_group(mesh, axes.dp)
    mgroup, _, _ = collectives.axis_group(mesh, axes.model)

    def shard(w: torch.Tensor, d_dim: int) -> torch.Tensor:
        """This rank's experts of a padded (E_pad, ...) weight: its FSDP
        slice of the d dim, gathered over data.  The gathered weight meets
        this rank's tokens only, so its gradient is summed over data."""
        if E_pad != E:
            w = F.pad(w, (0, 0, 0, 0, 0, E_pad - E))
        w = collectives.own_part(w, 0, mgroup)
        w = collectives.all_gather(collectives.own_part(w, d_dim, dgroup), d_dim, dgroup)
        return collectives.fan_out(w, dgroup)

    w = {"w_gate": shard(p["w_gate"], 1), "w_in": shard(p["w_in"], 1),
         "w_out": shard(p["w_out"], 2)}
    router = collectives.fan_out(p["router"], dgroup)     # meets token rows i
    y_loc, aux = _expert_rows(w, router, cfg, collectives.own_part(x2, 0, dgroup), mesh, axes)
    return collectives.all_gather(y_loc, 0, dgroup), aux


def _expert_rows(w: dict, router: torch.Tensor, cfg: ModelConfig, x_loc: torch.Tensor,
                 mesh, axes):
    """The ``shard_map`` body on rank (data i, model j): ``x_loc`` its token
    rows i, ``w`` its model column's experts of the padded expert axis (d
    whole), ``router`` whole.  Routes its rows, packs only its own experts'
    slots (no dispatch communication), runs them, and sums the columns'
    outputs over ``model``.  Returns (y rows i, aux averaged over data)."""
    m = cfg.moe
    E, K = m.num_experts, m.top_k
    _, epp = _padded_experts(cfg, mesh, axes)
    dgroup, _, _ = collectives.axis_group(mesh, axes.dp)
    mgroup, col, _ = collectives.axis_group(mesh, axes.model)
    cap = max(1, int(x_loc.shape[0] * K * m.capacity_factor / E))
    gates, topi, aux = _route({"router": router}, cfg, x_loc)
    order, sorted_e, sorted_t, pos = _slots(topi, E)
    mine = (sorted_e // epp) == col
    e_loc = torch.where(mine, sorted_e - col * epp, torch.zeros_like(sorted_e))
    # each model column packs only its own experts' slots
    y_part = _run_slots(w, collectives.fan_out(x_loc, mgroup),
                        collectives.fan_out(gates, mgroup), order, e_loc, sorted_t, pos,
                        (pos < cap) & mine, epp, cap)
    return collectives.all_reduce(y_part, mgroup), collectives.all_mean(aux, dgroup)


def _moe_expert_parallel_dtensor(p: dict, cfg: ModelConfig, x: torch.Tensor, mesh, axes):
    """The expert-parallel path on DTensors: x (B, S, d) an activation, the
    weights placed by the rule table.  Each rank gathers its own experts'
    weights over the data axes only (its shard where E lies on ``model``,
    else its slice of the padded expert axis) and takes its token
    rows i as they lie (its batch shard, or a slice of a batch that does
    not divide); nothing else is gathered.  Returns (y laid out as an
    activation, aux replicated).  The weights' and router's gradients are
    pending sums over the data axes (each rank met its rows only) and, for
    a sliced weight, over ``model``."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    B, S, d = x.shape
    E_pad, epp = _padded_experts(cfg, mesh, axes)
    dgroup, _, dsize = collectives.axis_group(mesh, axes.dp)
    _, col, _ = collectives.axis_group(mesh, axes.model)

    def pending(t):
        return t.to_local(grad_placements=[Partial() if isinstance(pl, Replicate) else pl
                                           for pl in t.placements])

    def mine(t: torch.Tensor) -> torch.Tensor:
        """Column j's experts, gathered over the data axes.  Where E does
        not lie on ``model``, the rank first slices them from its shard of
        the padded expert axis, so that only they are gathered (the
        reference's ``shard_map`` in_specs), the slice's gradient pending
        over ``model``."""
        names = mesh.mesh_dim_names
        if t.placements[names.index(axes.model)] != Shard(0):   # E does not divide model
            loc = t.to_local(grad_placements=[Partial() if n == axes.model else pl
                                              for n, pl in zip(names, t.placements)])
            loc = F.pad(loc, (0, 0, 0, 0, 0, E_pad - loc.shape[0]))[col * epp:(col + 1) * epp]
            t = DTensor.from_local(loc, mesh, [Shard(0) if n == axes.model else pl
                                               for n, pl in zip(names, t.placements)],
                                   run_check=False)
        return pending(sharding.gathered(t))

    w = {k: mine(p[k]) for k in ("w_gate", "w_in", "w_out")}
    router = sharding.whole(p["router"])
    router = router.to_local(grad_placements=[
        Partial() if name in axes.dp else Replicate() for name in mesh.mesh_dim_names])
    xb = sharding.batch_layout(x)
    if B % dsize == 0:                                      # rows i are its batch shard
        y_loc, aux = _expert_rows(w, router, cfg, xb.to_local().reshape(-1, d), mesh, axes)
        y = DTensor.from_local(y_loc.reshape(B // dsize, S, d), mesh, xb.placements,
                               run_check=False)
    else:                                                   # the batch lies whole
        x_loc = collectives.own_part(xb.to_local().reshape(B * S, d), 0, dgroup)
        y_loc, aux = _expert_rows(w, router, cfg, x_loc, mesh, axes)
        y = sharding.batch_layout(sharding.replicated_like(
            collectives.all_gather(y_loc, 0, dgroup).reshape(B, S, d), x))
    return y, sharding.replicated_like(aux, x)


def moe_apply(p: dict, cfg: ModelConfig, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (y (B, S, d), aux loss (f32 scalar))."""
    if sharding.is_dtensor(x):
        return _moe_dtensor(p, cfg, x)
    B, S, d = x.shape
    x2 = x.reshape(B * S, d)
    mesh, axes = active_mesh()
    if cfg.moe.impl == "shard_map" and mesh is not None:
        sizes = mesh_sizes(mesh)
        dsize = 1
        for a in axes.dp:
            dsize *= sizes[a]
        # At decode-scale token counts the FSDP weight gather dominates (the
        # reference's measurement); scatter moves tokens instead.
        if (B * S) % dsize == 0 and B * S >= SHARD_MAP_MIN_TOKENS:
            y, aux = _moe_expert_parallel(p, cfg, x2, mesh, axes)
            return y.reshape(B, S, d), aux
    fn = _moe_scatter if cfg.moe.impl in ("scatter", "shard_map") else _moe_einsum
    y, aux = fn(p, cfg, x2)
    return y.reshape(B, S, d), aux
