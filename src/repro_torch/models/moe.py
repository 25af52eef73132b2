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
collective expert parallelism; off a mesh the reference runs ``scatter``
for it, and so does the port on one card.  The expert products are XLA
einsums in the reference, not Pallas kernels, so they stay ``torch.bmm``.

Parameters: ``router`` (d, E) in f32 whatever the model's dtype (its logits
are f32 too), ``w_in``/``w_gate`` (E, d, f), ``w_out`` (E, f, d).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
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


def _moe_scatter(p: dict, cfg: ModelConfig, x2: torch.Tensor):
    m = cfg.moe
    T, d = x2.shape
    E, K = m.num_experts, m.top_k
    gates, topi, aux = _route(p, cfg, x2)
    cap = max(1, int(T * K * m.capacity_factor / E))

    flat_e = topi.reshape(T * K)                           # expert of each slot
    flat_g = gates.reshape(T * K)
    order = torch.argsort(flat_e, stable=True)             # slots grouped by expert
    sorted_e = flat_e[order]
    sorted_t = order // K                                  # source token of each slot
    counts = torch.bincount(flat_e, minlength=E)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(T * K, device=x2.device) - starts[sorted_e]  # place in its queue
    keep = pos < cap
    pos_c = torch.clamp(pos, max=cap - 1)

    src = x2[sorted_t] * keep[:, None].to(x2.dtype)        # dropped slots add zeros
    xe = torch.zeros((E, cap, d), dtype=x2.dtype, device=x2.device)
    xe.index_put_((sorted_e, pos_c), src, accumulate=True)
    ye = _expert_ffn(p, xe)                                # (E, cap, d)
    out_slot = ye[sorted_e, pos_c] * (flat_g[order] * keep)[:, None].to(x2.dtype)
    # The reference's scatter-add of the slots onto their tokens, as a sum
    # of each token's K slots in a fixed order: on the card ``index_add_``
    # adds by atomics, in an order (and so a rounding) that changes from
    # run to run.
    by_slot = torch.empty_like(out_slot)
    by_slot[order] = out_slot                              # back to flat order t*K + k
    y = by_slot.view(T, K, d).sum(1)
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


def moe_apply(p: dict, cfg: ModelConfig, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (y (B, S, d), aux loss (f32 scalar))."""
    B, S, d = x.shape
    fn = _moe_scatter if cfg.moe.impl in ("scatter", "shard_map") else _moe_einsum
    y, aux = fn(p, cfg, x.reshape(B * S, d))
    return y.reshape(B, S, d), aux
