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
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..parallel import collectives
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
               keep: torch.Tensor, n_exp: int, cap: int) -> torch.Tensor:
    """Pack the kept slots into (n_exp, cap, d) buffers at (e, pos) by a
    scatter-add, run each expert's SwiGLU, and sum each token's K gated slot
    outputs.  Returns (T, d)."""
    T, d = x2.shape
    K = gates.shape[1]
    pos_c = torch.clamp(pos, max=cap - 1)
    src = x2[sorted_t] * keep[:, None].to(x2.dtype)        # dropped slots add zeros
    xe = torch.zeros((n_exp, cap, d), dtype=x2.dtype, device=x2.device)
    xe.index_put_((e, pos_c), src, accumulate=True)
    ye = _expert_ffn(p, xe)                                # (n_exp, cap, d)
    out_slot = ye[e, pos_c] * (gates.reshape(T * K)[order] * keep)[:, None].to(x2.dtype)
    # The reference's scatter-add of the slots onto their tokens, as a sum
    # of each token's K slots in a fixed order: on the card ``index_add_``
    # adds by atomics, in an order (and so a rounding) that changes from
    # run to run.
    by_slot = torch.empty_like(out_slot)
    by_slot[order] = out_slot                              # back to flat order t*K + k
    return by_slot.view(T, K, d).sum(1)


def _moe_scatter(p: dict, cfg: ModelConfig, x2: torch.Tensor):
    m = cfg.moe
    T = x2.shape[0]
    E, K = m.num_experts, m.top_k
    gates, topi, aux = _route(p, cfg, x2)
    cap = max(1, int(T * K * m.capacity_factor / E))
    order, sorted_e, sorted_t, pos = _slots(topi, E)
    y = _run_slots(p, x2, gates, order, sorted_e, sorted_t, pos, pos < cap, E, cap)
    return y, aux


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
    m = cfg.moe
    E, K = m.num_experts, m.top_k
    msize = mesh_sizes(mesh)[axes.model]
    # Pad the expert dim up to the model axis (granite's 40 -> 48 on 16):
    # dead experts hold zero weights and never win routing.
    E_pad = (E + msize - 1) // msize * msize
    epp = E_pad // msize
    dgroup, _, dsize = collectives.axis_group(mesh, axes.dp)
    mgroup, col, _ = collectives.axis_group(mesh, axes.model)
    T = x2.shape[0]
    cap = max(1, int(T // dsize * K * m.capacity_factor / E))
    x_loc = collectives.own_part(x2, 0, dgroup)            # token rows i

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
    gates, topi, aux = _route({"router": router}, cfg, x_loc)
    order, sorted_e, sorted_t, pos = _slots(topi, E)
    mine = (sorted_e // epp) == col
    e_loc = torch.where(mine, sorted_e - col * epp, torch.zeros_like(sorted_e))
    # each model column packs only its own experts' slots
    y_part = _run_slots(w, collectives.fan_out(x_loc, mgroup),
                        collectives.fan_out(gates, mgroup), order, e_loc, sorted_t, pos,
                        (pos < cap) & mine, epp, cap)
    y_loc = collectives.all_reduce(y_part, mgroup)          # combine expert columns
    return collectives.all_gather(y_loc, 0, dgroup), collectives.all_mean(aux, dgroup)


def moe_apply(p: dict, cfg: ModelConfig, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (y (B, S, d), aux loss (f32 scalar))."""
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
