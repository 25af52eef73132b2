"""GQA attention, with an optional sliding window (port of the GQA half of
``repro.models.attention``; MLA is a later slice).

KV caches per layer: k and v, each (B, Smax, n_kv, hd); a sliding-window
(SWA) cache is a ring buffer of Smax = window slots.
"""

from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..kernels import ops
from .common import dense_init, rope


def gqa_init(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype) -> dict:
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd
    return {"wqkv": dense_init(gen, d, (d, (hq + 2 * hkv) * hd), dtype),
            "wo": dense_init(gen, hq * hd, (hq * hd, d), dtype)}


def _split_qkv(p: dict, cfg: ModelConfig, x: torch.Tensor):
    """Fused projection split as [q | k | v] of widths hq*hd, hkv*hd, hkv*hd."""
    B, S, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv, cfg.hd
    q, k, v = torch.split(x @ p["wqkv"], [hq * hd, hkv * hd, hkv * hd], dim=-1)
    return q.reshape(B, S, hq, hd), k.reshape(B, S, hkv, hd), v.reshape(B, S, hkv, hd)


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
    return y.reshape(B, S, cfg.n_heads * cfg.hd) @ p["wo"], (k, v)


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
    k_cache[:, slot] = k[:, 0].to(k_cache.dtype)
    v_cache[:, slot] = v[:, 0].to(v_cache.dtype)
    y = ops.decode_attention(q, k_cache, v_cache, min(pos + 1, smax), window=_window(cfg),
                             plain=plain)
    return y.reshape(B, 1, cfg.n_heads * cfg.hd) @ p["wo"]


def gqa_cache_shape(cfg: ModelConfig, batch: int, seq: int) -> tuple[int, ...]:
    smax = min(seq, cfg.window) if cfg.attn == "swa" and cfg.window else seq
    return (batch, smax, cfg.n_kv, cfg.hd)
