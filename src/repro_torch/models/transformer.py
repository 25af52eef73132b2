"""Decoder LM for serving (port of the ``attn``, ``hybrid`` and ``mamba``
block kinds of ``repro.models.transformer``).

The reference stores blocks stacked over pattern groups and runs them with
``lax.scan``; the port keeps one dict of tensors per layer and runs a Python
loop over layers (``models/convert.py`` unstacks reference parameters).
Ported block kinds (Attn is GQA, SWA or MLA; FFN is the SwiGLU MLP or,
where ``cfg.moe`` is set, the MoE):

    attn   : x + Attn(norm1(x));             x + FFN(norm2(x))
    hybrid : x + 0.5 (Attn + SSM)(norm1(x)); x + MLP(norm2(x))   (hymba)
    mamba  : x + SSM(norm1(x));             [x + MLP(norm2(x)) if d_ff > 0]

Parameters are plain dicts of tensors in the reference's (in, out) layout:
``embed.table`` (vocab_padded, d), ``lm_head`` (d, vocab_padded),
``final_norm.scale`` (d,), and ``blocks[l]`` with ``norm1``, ``attn``
(``wqkv``, ``wo``) or ``mla`` (``models/attention.py``), ``ssm``
(``models/ssm.py``), ``norm2``, and ``mlp`` (``w_in``, ``w_gate``,
``w_out``) or ``moe`` (``models/moe.py``) as its kind has them.  A layer's
cache is a dict: ``k``, ``v`` (GQA/SWA attention; a ring of ``window`` slots
under SWA), ``latent`` (MLA; the reference's bare array), ``conv`` and
``ssm`` (the SSM's carried states).

``plain=True`` routes every norm, attention and scan through the plain
PyTorch versions; only the parity checks pass it.
"""

from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from . import attention as attn_mod
from . import moe as moe_mod
from . import ssm as ssm_mod
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
    if not kinds <= {"attn", "hybrid", "mamba"}:
        raise NotImplementedError(
            f"{cfg.name}: block kinds {sorted(kinds)}; 'attn', 'hybrid' and 'mamba' "
            "blocks are ported (mlstm/slstm come with the xLSTM slice)")
    if "hybrid" in kinds and cfg.attn not in ("gqa", "swa"):
        raise ValueError(f"{cfg.name}: hybrid blocks take GQA or SWA, not {cfg.attn!r}")
    if "attn" in kinds and cfg.attn not in ("gqa", "swa", "mla"):
        raise ValueError(f"{cfg.name}: attention {cfg.attn!r}")
    if cfg.attn == "mla" and cfg.mla is None:
        raise ValueError(f"{cfg.name}: MLA attention needs an mla config")
    if kinds & {"hybrid", "mamba"} and cfg.ssm is None:
        raise ValueError(f"{cfg.name}: block kinds {sorted(kinds)} need an ssm config")


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

    def block(kind: str) -> dict:
        p = {"norm1": ones()}
        if kind == "attn" and cfg.attn == "mla":
            p["mla"] = attn_mod.mla_init(gen, cfg, dt)
        elif kind in ("attn", "hybrid"):
            p["attn"] = attn_mod.gqa_init(gen, cfg, dt)
        if kind in ("hybrid", "mamba"):
            p["ssm"] = ssm_mod.ssm_init(gen, cfg, dt)
        if kind != "mamba" or cfg.d_ff > 0:
            p["norm2"] = ones()
            if kind == "attn" and cfg.moe is not None:
                p["moe"] = moe_mod.moe_init(gen, cfg, dt)
            else:
                p["mlp"] = mlp_init(gen, d, cfg.d_ff, dt)
        return p

    params: dict = {"embed": {"table": dense_init(gen, d, (cfg.vocab_padded, d), dt)},
                    "final_norm": ones()}
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, d, (d, cfg.vocab_padded), dt)
    params["blocks"] = [block(kind) for kind in cfg.pattern_for_layers()]
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
    """FFN(norm2(x)): the MoE where the block has one (its aux loss is
    dropped at serving, as in the reference), else the MLP."""
    h = rmsnorm(x, p["norm2"]["scale"], cfg.norm_eps, plain=plain)
    if "moe" in p:
        return moe_mod.moe_apply(p["moe"], cfg, h)[0]
    return mlp_apply(p["mlp"], h)


def _to_cache(t: torch.Tensor, cfg: ModelConfig, max_len: int) -> torch.Tensor:
    """Pad a prefill k or v (B, S', hkv, hd), or an MLA latent (B, S', r),
    to the cache's slot count."""
    swa = cfg.attn == "swa" and cfg.window
    if t.shape[1] >= max_len or (swa and t.shape[1] >= cfg.window):
        return t.contiguous()
    smax = min(max_len, cfg.window) if swa else max_len
    out = torch.zeros((t.shape[0], smax, *t.shape[2:]), dtype=t.dtype, device=t.device)
    out[:, :t.shape[1]] = t
    return out


def cache_shapes(cfg: ModelConfig, batch: int, seq: int, dtype: torch.dtype | None = None
                 ) -> list[dict]:
    """Per layer, ``{name: (shape, dtype)}`` of its cache: ``k``/``v`` for
    GQA/SWA attention (ring of ``window`` slots under SWA), ``latent`` for
    MLA, ``conv``/``ssm`` for the SSM (the scan state in f32)."""
    dt = dtype or dtype_of(cfg.compute_dtype)
    out = []
    for kind in cfg.pattern_for_layers():
        one = {}
        if kind == "attn" and cfg.attn == "mla":
            one["latent"] = (attn_mod.mla_cache_shape(cfg, batch, seq), dt)
        elif kind in ("attn", "hybrid"):
            kv = attn_mod.gqa_cache_shape(cfg, batch, seq)
            one.update(k=(kv, dt), v=(kv, dt))
        if kind in ("hybrid", "mamba"):
            one["conv"], one["ssm"] = ssm_mod.ssm_cache_shape(cfg, batch, dt)
        out.append(one)
    return out


def init_cache(cfg: ModelConfig, batch: int, seq: int, device: str | torch.device = "cuda",
               dtype: torch.dtype | None = None) -> list[dict]:
    """Zero cache, one dict per layer (``cache_shapes``)."""
    dev = resolve_device(device)
    return [{name: torch.zeros(shape, dtype=dt, device=dev)
             for name, (shape, dt) in one.items()}
            for one in cache_shapes(cfg, batch, seq, dtype)]


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
        c = {}
        if "mla" in p:
            y, latent = attn_mod.mla_apply(p["mla"], cfg, h, positions, plain=plain)
            c["latent"] = _to_cache(latent, cfg, max_len)
        if "attn" in p:
            y, (k, v) = attn_mod.gqa_apply(p["attn"], cfg, h, positions, plain=plain)
            if cfg.attn == "swa" and cfg.window and cfg.window < S:
                # ring-buffer layout: slot = abs_pos % window
                k = torch.roll(k[:, -cfg.window:], S % cfg.window, dims=1)
                v = torch.roll(v[:, -cfg.window:], S % cfg.window, dims=1)
            c.update(k=_to_cache(k, cfg, max_len), v=_to_cache(v, cfg, max_len))
        if "ssm" in p:
            ys, (c["conv"], c["ssm"]) = ssm_mod.ssm_prefill(p["ssm"], cfg, h, plain=plain)
            y = 0.5 * (y + ys) if "attn" in p else ys
        cache.append(c)
        x = x + y
        if "norm2" in p:  # a mamba block with d_ff 0 has no FFN
            x = x + _ffn(p, cfg, x, plain)
    logits = _lm_logits(params, cfg, x[:, -1:].contiguous(), plain)
    return logits[:, 0], cache


def decode_step(params: dict, cfg: ModelConfig, tokens: torch.Tensor, cache: list[dict],
                pos: int, *, plain: bool = False) -> tuple[torch.Tensor, list[dict]]:
    """One new token per sequence.  tokens: (B, 1); pos: the current cache
    length.  Updates ``cache`` in place (the attention caches' slot is
    written, the SSM states are replaced); returns (logits (B, V) f32, cache)."""
    check_config(cfg)
    x = _embed_in(params, cfg, {"tokens": tokens})
    for p, c in zip(params["blocks"], cache):
        h = rmsnorm(x, p["norm1"]["scale"], cfg.norm_eps, plain=plain)
        if "mla" in p:
            y = attn_mod.mla_decode(p["mla"], cfg, h, c["latent"], pos, plain=plain)
        if "attn" in p:
            y = attn_mod.gqa_decode(p["attn"], cfg, h, (c["k"], c["v"]), pos, plain=plain)
        if "ssm" in p:
            ys, (c["conv"], c["ssm"]) = ssm_mod.ssm_decode(p["ssm"], cfg, h,
                                                           (c["conv"], c["ssm"]), plain=plain)
            y = 0.5 * (y + ys) if "attn" in p else ys
        x = x + y
        if "norm2" in p:  # a mamba block with d_ff 0 has no FFN
            x = x + _ffn(p, cfg, x, plain)
    return _lm_logits(params, cfg, x, plain)[:, 0], cache
