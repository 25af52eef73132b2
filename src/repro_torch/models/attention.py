"""Attention variants (port of ``repro.models.attention``): GQA with an
optional sliding window, and MLA (multi-head latent attention, minicpm3).

Caches per layer:
  gqa/swa: k and v, each (B, Smax, n_kv, hd); a sliding-window (SWA) cache is
           a ring buffer of Smax = window slots.
  mla:     the latent, (B, Smax, kv_lora_rank + qk_rope_head_dim): the
           normalised compressed KV beside the roped shared key part.  The
           reference's layer cache is this bare array; the port keeps it as
           ``{"latent": array}`` so every layer's cache is a dict.

Under the active mesh, on DTensors (``parallel.sharding``): the projections
run on each rank's batch rows with their weights gathered over the data
axes, attention as ``ops.attention`` lays it out (head-parallel where
``model`` divides the kv heads or the group, row-parallel where
``ref._row_shard`` fires), and the output projection row-parallel with one
all-reduce over ``model``.  Decode reads a cache laid out by
``sharding.cache_leaf_spec``: a new token's k and v (MLA: its latent) are
written by the rank that holds its slot only (:func:`write_slot`), and
attention runs on each rank's kv heads or, over a cache sharded by
sequence, on its slice of the slots (``ops.decode_attention``).
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import Replicate, Shard

from ..configs.base import ModelConfig
from ..kernels import ops
from ..parallel import sharding
from .common import dense_init, rmsnorm, rope


def gqa_init(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype) -> dict:
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd
    return {"wqkv": dense_init(gen, d, (d, (hq + 2 * hkv) * hd), dtype),
            "wo": dense_init(gen, hq * hd, (hq * hd, d), dtype)}


def _split_qkv(p: dict, cfg: ModelConfig, x: torch.Tensor):
    """Fused projection split as [q | k | v] of widths hq*hd, hkv*hd, hkv*hd."""
    B, S, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv, cfg.hd
    qkv = sharding.batch_layout_grad(x @ sharding.gathered(p["wqkv"]))
    q, k, v = torch.split(qkv, [hq * hd, hkv * hd, hkv * hd], dim=-1)
    return (sharding.heads_whole(q, hq).reshape(B, S, hq, hd),
            sharding.heads_whole(k, hkv).reshape(B, S, hkv, hd),
            sharding.heads_whole(v, hkv).reshape(B, S, hkv, hd))


def _window(cfg: ModelConfig) -> int | None:
    return cfg.window if cfg.attn == "swa" else None


def gqa_apply(p: dict, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor, *,
              plain: bool = False) -> tuple[torch.Tensor, tuple]:
    """Full-sequence causal attention (prefill).  Returns (y, (k, v))."""
    B, S, _ = x.shape
    q, k, v = _split_qkv(p, cfg, x)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    y = ops.attention(q, k, v, causal=True, window=_window(cfg), plain=plain)
    return _out(p, y.reshape(B, S, cfg.n_heads * cfg.hd), cfg.n_heads), (k, v)


def _out(p: dict, y: torch.Tensor, n_heads: int) -> torch.Tensor:
    """The output projection: row-parallel under a mesh (one all-reduce)
    where ``model`` divides the heads, so each rank's rows of ``wo`` are its
    heads' rows; else ``wo`` whole.  Where attention ran by rows
    (``ref._row_shard``: y's sequence on ``model``, its batch whole), each
    rank's rows of its data slice of the batch take ``wo`` whole through
    ``local_call``: under autograd a product runs as a view flattening
    (batch, seq), which DTensor refuses over a sequence shard on some torch
    versions (2.11)."""
    w = p["wo"]
    if sharding.is_dtensor(y) and sharding.model_placement(y) == Shard(1):
        mesh, axes = sharding.active_mesh()
        split = y.shape[0] % sharding.dsize(mesh, axes) == 0
        rows = sharding.axis_placements(y, Shard(0) if split else Replicate(), Shard(1))
        w = sharding.whole(w)
        return sharding.batch_layout(sharding.local_call(
            torch.matmul, (y, w), (rows, sharding.replicated(w)), rows, y.device_mesh))
    if sharding.is_dtensor(w):
        mesh, axes = sharding.active_mesh()
        w = (sharding.gathered(w) if n_heads % sharding.mesh_sizes(mesh)[axes.model] == 0
             else sharding.whole(w))
    return sharding.batch_layout(y @ w)


def write_slot(cache: torch.Tensor, new: torch.Tensor, slot: int) -> None:
    """``cache[:, slot] = new`` in place: cache (B, Smax, ...), new (B, ...).
    On a DTensor cache only the rank holding the slot writes, into its local
    shard (the slots sharded on a mesh axis: the rank whose slice holds it;
    else every rank its own rows and heads)."""
    if not sharding.is_dtensor(cache):
        cache[:, slot] = new.to(cache.dtype)
        return
    mesh = cache.device_mesh
    want = [Replicate() if p == Shard(1) else
            Shard(p.dim - 1) if isinstance(p, Shard) and p.dim > 1 else p
            for p in cache.placements]
    local, new = cache.to_local(), new.redistribute(mesh, want).to_local()
    seq = [i for i, p in enumerate(cache.placements) if p == Shard(1)]
    if seq:
        sl = local.shape[1]
        r = mesh.get_local_rank(seq[0])
        if slot // sl == r:
            local[:, slot - r * sl] = new.to(local.dtype)
    else:
        local[:, slot] = new.to(local.dtype)


def gqa_decode(p: dict, cfg: ModelConfig, x: torch.Tensor, cache: tuple, pos: int, *,
               plain: bool = False) -> torch.Tensor:
    """x: (B, 1, d); cache: (k, v) each (B, Smax, hkv, hd); pos: the current
    cache length.  Writes the new k and v into the cache in place (the
    reference donates the cache to its decode step instead) and returns y."""
    B = x.shape[0]
    k_cache, v_cache = cache
    smax = k_cache.shape[1]
    q, k, v = _split_qkv(p, cfg, x)
    positions = torch.arange(pos, pos + 1, device=x.device)
    q = rope(q, positions, cfg.rope_theta)[:, 0]                   # (B, hq, hd)
    k = rope(k, positions, cfg.rope_theta)
    slot = pos % smax if cfg.attn == "swa" else pos                # ring buffer for SWA
    write_slot(k_cache, k[:, 0], slot)
    write_slot(v_cache, v[:, 0], slot)
    y = ops.decode_attention(q, k_cache, v_cache, min(pos + 1, smax), window=_window(cfg),
                             plain=plain)
    return _out(p, y.reshape(B, 1, cfg.n_heads * cfg.hd), cfg.n_heads)


def gqa_cache_shape(cfg: ModelConfig, batch: int, seq: int) -> tuple[int, ...]:
    smax = min(seq, cfg.window) if cfg.attn == "swa" and cfg.window else seq
    return (batch, smax, cfg.n_kv, cfg.hd)


# ---------------------------------------------------------------------------
# MLA: multi-head latent attention (MiniCPM3 / DeepSeek-V2 style)
# ---------------------------------------------------------------------------

def mla_init(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype) -> dict:
    m = cfg.mla
    d, hq = cfg.d_model, cfg.n_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    dev = gen.device
    return {"wq_a": dense_init(gen, d, (d, m.q_lora_rank), dtype),
            "wq_b": dense_init(gen, m.q_lora_rank, (m.q_lora_rank, hq * qk), dtype),
            "wkv_a": dense_init(gen, d, (d, m.kv_lora_rank + m.qk_rope_head_dim), dtype),
            "wkv_b": dense_init(gen, m.kv_lora_rank,
                                (m.kv_lora_rank, hq * (m.qk_nope_head_dim + m.v_head_dim)),
                                dtype),
            "wo": dense_init(gen, hq * m.v_head_dim, (hq * m.v_head_dim, d), dtype),
            "norm_q": {"scale": torch.ones(m.q_lora_rank, dtype=dtype, device=dev)},
            "norm_kv": {"scale": torch.ones(m.kv_lora_rank, dtype=dtype, device=dev)}}


def _mla_scale(cfg: ModelConfig) -> float:
    return (cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim) ** -0.5


def _expand_kv(p: dict, cfg: ModelConfig, c_kv: torch.Tensor, k_rope: torch.Tensor):
    """k (B, S, hq, nope + rope) and v (B, S, hq, v_head_dim) from the
    normalised latent c_kv (B, S, kv_lora) and the roped shared key part
    k_rope (B, S, rope).  v stays a slice of the ``wkv_b`` product: both
    attention kernels take its strides."""
    m = cfg.mla
    B, S, _ = c_kv.shape
    w = p["wkv_b"]
    # over a cache sharded by sequence the latent's slots stay where they
    # lie (each rank expands its own): the weight goes whole
    w = sharding.whole(w) if _model_sharded(c_kv, 1) else sharding.gathered(w)
    kvb = sharding.heads_whole(sharding.batch_layout_grad(c_kv @ w), cfg.n_heads).reshape(
        B, S, cfg.n_heads, m.qk_nope_head_dim + m.v_head_dim)
    k_nope, v = torch.split(kvb, [m.qk_nope_head_dim, m.v_head_dim], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(-1, -1, cfg.n_heads, -1)], dim=-1)
    return k, v


def _model_sharded(x: torch.Tensor, dim: int) -> bool:
    """Whether DTensor x's dim ``dim`` lies on a mesh axis."""
    return sharding.is_dtensor(x) and Shard(dim) in tuple(x.placements)


def _mla_q_latent(p: dict, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor,
                  plain: bool):
    """q (B, S, hq, nope + rope) for x's positions, the normalised latent
    c_kv (B, S, kv_lora), the roped shared key part k_rope (B, S, rope), and
    the latent (B, S, kv_lora + rope) the cache keeps.  Both low-rank norms
    (norm_q over q_lora_rank, norm_kv over kv_lora_rank) go through the
    RMSNorm kernel; c_kv, a slice of the ``wkv_a`` product, is made
    contiguous for it."""
    m = cfg.mla
    B, S, _ = x.shape
    wq_a, wq_b, wkv_a = (sharding.gathered(p[k]) for k in ("wq_a", "wq_b", "wkv_a"))
    lay = sharding.batch_layout_grad
    q = rmsnorm(lay(x @ wq_a), p["norm_q"]["scale"], cfg.norm_eps, plain=plain) @ wq_b
    q = sharding.heads_whole(lay(q), cfg.n_heads).reshape(
        B, S, cfg.n_heads, m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_rope = torch.split(q, [m.qk_nope_head_dim, m.qk_rope_head_dim], dim=-1)
    q = torch.cat([q_nope, rope(q_rope, positions, cfg.rope_theta)], dim=-1)

    c_kv, k_rope = torch.split(lay(x @ wkv_a), [m.kv_lora_rank, m.qk_rope_head_dim], dim=-1)
    c_kv = rmsnorm(c_kv.contiguous(), p["norm_kv"]["scale"], cfg.norm_eps, plain=plain)
    k_rope = rope(k_rope[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    return q, c_kv, k_rope, torch.cat([c_kv, k_rope], dim=-1)


def mla_apply(p: dict, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor, *,
              plain: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence causal MLA (prefill).  Returns (y, latent)."""
    B, S, _ = x.shape
    q, c_kv, k_rope, latent = _mla_q_latent(p, cfg, x, positions, plain)
    k, v = _expand_kv(p, cfg, c_kv, k_rope)
    y = ops.attention(q, k, v, causal=True, scale=_mla_scale(cfg), plain=plain)
    return _out(p, y.reshape(B, S, cfg.n_heads * cfg.mla.v_head_dim), cfg.n_heads), latent


def mla_decode(p: dict, cfg: ModelConfig, x: torch.Tensor, cache: torch.Tensor, pos: int, *,
               plain: bool = False) -> torch.Tensor:
    """x: (B, 1, d); cache: the latent (B, Smax, kv_lora + rope); pos: the
    current cache length.  Writes the new latent into slot ``pos`` in place,
    then re-expands k and v from the whole latent cache, as the reference
    does (``wkv_b`` is not absorbed into q), and attends over its first
    pos + 1 slots.  Returns y."""
    m = cfg.mla
    B = x.shape[0]
    positions = torch.arange(pos, pos + 1, device=x.device)
    q, _, _, latent = _mla_q_latent(p, cfg, x, positions, plain)
    write_slot(cache, latent[:, 0], pos)
    c_kv, k_rope = torch.split(cache, [m.kv_lora_rank, m.qk_rope_head_dim], dim=-1)
    k_all, v_all = _expand_kv(p, cfg, c_kv, k_rope)
    y = ops.decode_attention(q[:, 0], k_all, v_all, pos + 1, scale=_mla_scale(cfg),
                             plain=plain)
    return _out(p, y.reshape(B, 1, cfg.n_heads * m.v_head_dim), cfg.n_heads)


def mla_cache_shape(cfg: ModelConfig, batch: int, seq: int) -> tuple[int, ...]:
    m = cfg.mla
    return (batch, seq, m.kv_lora_rank + m.qk_rope_head_dim)
