"""Decoder LM for serving (port of the ``attn``-block half of
``repro.models.transformer``).

The reference stores blocks stacked over pattern groups and runs them with
``lax.scan``; the port keeps one dict of tensors per layer and runs a Python
loop over layers (``models/convert.py`` unstacks reference parameters).
Only ``attn`` blocks with GQA attention and a dense MLP are ported in this
slice:

    attn : x + Attn(norm1(x));   x + MLP(norm2(x))

Parameters are plain dicts of tensors in the reference's (in, out) layout:
``embed.table`` (vocab_padded, d), ``lm_head`` (d, vocab_padded),
``final_norm.scale`` (d,), and ``blocks[l]`` with ``norm1``, ``attn``
(``wqkv``, ``wo``), ``norm2`` and ``mlp`` (``w_in``, ``w_gate``, ``w_out``).

``plain=True`` routes every norm and attention through the plain PyTorch
versions; only the parity checks pass it.
"""

from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from . import attention as attn_mod
from .common import dense_init, dtype_of, mlp_apply, mlp_init, rmsnorm


def check_config(cfg: ModelConfig) -> None:
    """Raise on what this slice does not run.

    The reference runs two dtype forms: f32/f32 (``reduced()``) and bf16/bf16
    (``production_cfg``).  With f32 weights and bf16 compute its decode scan
    fails on a carry whose dtype changes, so the port refuses that mix
    rather than invent a promotion rule the reference lacks."""
    if cfg.param_dtype != cfg.compute_dtype:
        raise ValueError(
            f"{cfg.name}: param_dtype {cfg.param_dtype} != compute_dtype "
            f"{cfg.compute_dtype}; the reference serves only matching forms "
            "(use production_cfg(cfg) for bf16 or cfg.reduced() for f32)")
    kinds = set(cfg.block_pattern)
    if kinds != {"attn"}:
        raise NotImplementedError(
            f"{cfg.name}: block kinds {sorted(kinds)}; only 'attn' blocks are ported "
            "(hybrid/mamba come with the ssd_scan slice, mlstm/slstm later)")
    if cfg.attn not in ("gqa", "swa"):
        raise NotImplementedError(f"{cfg.name}: attention {cfg.attn!r} is a later slice")
    if cfg.moe is not None:
        raise NotImplementedError(f"{cfg.name}: MoE blocks are a later slice")


def init_params(seed: int, cfg: ModelConfig, device: str | torch.device = "cuda") -> dict:
    """Random weights from a ``torch.Generator`` seeded with ``seed`` on the
    target device, with the reference's shapes and fan_in^-0.5 scale."""
    check_config(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = dtype_of(cfg.param_dtype)
    d = cfg.d_model

    def ones():
        return {"scale": torch.ones(d, dtype=dt, device=dev)}

    params: dict = {"embed": {"table": dense_init(gen, d, (cfg.vocab_padded, d), dt)},
                    "final_norm": ones()}
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, d, (d, cfg.vocab_padded), dt)
    params["blocks"] = [
        {"norm1": ones(), "attn": attn_mod.gqa_init(gen, cfg, dt), "norm2": ones(),
         "mlp": mlp_init(gen, d, cfg.d_ff, dt)}
        for _ in range(cfg.n_layers)]
    return params


def _embed_in(params: dict, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    x = batch["embeds"] if "embeds" in batch else params["embed"]["table"][batch["tokens"]]
    return x.to(dtype_of(cfg.compute_dtype))


def _lm_logits(params: dict, cfg: ModelConfig, x: torch.Tensor, plain: bool) -> torch.Tensor:
    """f32 logits over the vocab: pad columns get -1e30, then are sliced off."""
    x = rmsnorm(x, params["final_norm"]["scale"], cfg.norm_eps, plain=plain)
    head = params["embed"]["table"].T if cfg.tie_embeddings else params["lm_head"]
    logits = (x @ head).float()
    if cfg.vocab_padded != cfg.vocab:
        pad = torch.arange(cfg.vocab_padded, device=x.device) >= cfg.vocab
        logits = logits + pad.float() * -1e30
    return logits[..., :cfg.vocab]


def _ffn(p: dict, cfg: ModelConfig, x: torch.Tensor, plain: bool) -> torch.Tensor:
    return mlp_apply(p["mlp"], rmsnorm(x, p["norm2"]["scale"], cfg.norm_eps, plain=plain))


def _to_cache(t: torch.Tensor, cfg: ModelConfig, max_len: int) -> torch.Tensor:
    """Pad a prefill k or v (B, S', hkv, hd) to the cache's slot count."""
    swa = cfg.attn == "swa" and cfg.window
    if t.shape[1] >= max_len or (swa and t.shape[1] >= cfg.window):
        return t.contiguous()
    smax = min(max_len, cfg.window) if swa else max_len
    out = torch.zeros((t.shape[0], smax, *t.shape[2:]), dtype=t.dtype, device=t.device)
    out[:, :t.shape[1]] = t
    return out


def init_cache(cfg: ModelConfig, batch: int, seq: int, device: str | torch.device = "cuda",
               dtype: torch.dtype | None = None) -> list[dict]:
    """Zero KV cache, one ``{"k", "v"}`` dict per layer."""
    dev = resolve_device(device)
    dt = dtype or dtype_of(cfg.compute_dtype)
    shape = attn_mod.gqa_cache_shape(cfg, batch, seq)
    return [{"k": torch.zeros(shape, dtype=dt, device=dev),
             "v": torch.zeros(shape, dtype=dt, device=dev)} for _ in range(cfg.n_layers)]


def prefill(params: dict, cfg: ModelConfig, batch: dict, max_len: int | None = None, *,
            plain: bool = False) -> tuple[torch.Tensor, list[dict]]:
    """Full-sequence forward that also emits the serving cache, padded to
    ``max_len`` slots.  Returns (logits (B, V) f32 of the last position, cache)."""
    check_config(cfg)
    x = _embed_in(params, cfg, batch)
    S = x.shape[1]
    max_len = max_len if max_len is not None else S
    positions = torch.arange(S, device=x.device)
    cache = []
    for p in params["blocks"]:
        h = rmsnorm(x, p["norm1"]["scale"], cfg.norm_eps, plain=plain)
        y, (k, v) = attn_mod.gqa_apply(p["attn"], cfg, h, positions, plain=plain)
        if cfg.attn == "swa" and cfg.window and cfg.window < S:
            # ring-buffer layout: slot = abs_pos % window
            k = torch.roll(k[:, -cfg.window:], S % cfg.window, dims=1)
            v = torch.roll(v[:, -cfg.window:], S % cfg.window, dims=1)
        cache.append({"k": _to_cache(k, cfg, max_len), "v": _to_cache(v, cfg, max_len)})
        x = x + y
        x = x + _ffn(p, cfg, x, plain)
    logits = _lm_logits(params, cfg, x[:, -1:].contiguous(), plain)
    return logits[:, 0], cache


def decode_step(params: dict, cfg: ModelConfig, tokens: torch.Tensor, cache: list[dict],
                pos: int, *, plain: bool = False) -> tuple[torch.Tensor, list[dict]]:
    """One new token per sequence.  tokens: (B, 1); pos: the current cache
    length.  Updates ``cache`` in place; returns (logits (B, V) f32, cache)."""
    check_config(cfg)
    x = _embed_in(params, cfg, {"tokens": tokens})
    for p, c in zip(params["blocks"], cache):
        h = rmsnorm(x, p["norm1"]["scale"], cfg.norm_eps, plain=plain)
        x = x + attn_mod.gqa_decode(p["attn"], cfg, h, (c["k"], c["v"]), pos, plain=plain)
        x = x + _ffn(p, cfg, x, plain)
    return _lm_logits(params, cfg, x, plain)[:, 0], cache
