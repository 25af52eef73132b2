"""Decoder LM (port of ``repro.models.transformer``): serving (``prefill``,
``decode_step``) and training (``forward``, ``loss_fn``) for every block
kind of the reference.

The reference stores blocks stacked over pattern groups and runs them with
``lax.scan``; the port keeps one dict of tensors per layer and runs a Python
loop over layers (``models/convert.py`` unstacks reference parameters).
Ported block kinds (Attn is GQA, SWA or MLA; FFN is the SwiGLU MLP or,
where ``cfg.moe`` is set, the MoE):

    attn   : x + Attn(norm1(x));             x + FFN(norm2(x))
    hybrid : x + 0.5 (Attn + SSM)(norm1(x)); x + MLP(norm2(x))   (hymba)
    mamba  : x + SSM(norm1(x));             [x + MLP(norm2(x)) if d_ff > 0]
    mlstm  : x + mLSTM(norm1(x))                                      (xLSTM, no FFN)
    slstm  : x + sLSTM(norm1(x))

Parameters are plain dicts of tensors in the reference's (in, out) layout:
``embed.table`` (vocab_padded, d), ``lm_head`` (d, vocab_padded),
``final_norm.scale`` (d,), and ``blocks[l]`` with ``norm1``, ``attn``
(``wqkv``, ``wo``) or ``mla`` (``models/attention.py``), ``ssm``
(``models/ssm.py``), ``norm2``, and ``mlp`` (``w_in``, ``w_gate``,
``w_out``) or ``moe`` (``models/moe.py``), or ``mlstm`` / ``slstm``
(``models/xlstm.py``) as its kind has them.  A layer's cache is a dict:
``k``, ``v`` (GQA/SWA attention; a ring of ``window`` slots under SWA),
``latent`` (MLA; the reference's bare array), ``conv`` and ``ssm`` (the
SSM's carried states), ``conv``, ``C``, ``n``, ``m`` (mLSTM) or ``h``,
``c``, ``n``, ``m`` (sLSTM).

``forward(..., remat=True)`` recomputes each pattern group in the backward
pass (``torch.utils.checkpoint``), as the reference wraps its group body in
``jax.checkpoint``.  ``param_shapes`` is the parameter tree as meta tensors
at any width, and ``block_fn`` one layer in the form the pipeline executor
(``parallel.pipeline``) takes.

Sharded steps: given DTensor parameters (``sharding.shard_params``) and
inputs (``sharding.place_batch`` / ``place_cache``) under the active mesh,
each function runs each rank's part of the step.  Activations are DTensors
laid out at the reference's constraint sites: batch-sharded after every
block (``sharding.dp_site``, the reference's ``with_dp_constraint``), and the
loss's padded logits ``("data", None, "model")``; the cache a prefill emits
is laid out as a decode step takes it (``sharding.cache_leaf_spec``), and a
decode step's new states keep their cache leaves' layout.  Given plain
tensors, under a mesh or not, every path runs as on one device.

``plain=True`` routes every norm, attention and scan through the plain
PyTorch versions; only the parity checks pass it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..device import resolve_device
from ..parallel import sharding
from . import attention as attn_mod
from . import moe as moe_mod
from . import ssm as ssm_mod
from . import xlstm as xlstm_mod
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
    if not kinds <= {"attn", "hybrid", "mamba", "mlstm", "slstm"}:
        raise ValueError(f"{cfg.name}: unknown block kinds {sorted(kinds)}")
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
        if kind == "mlstm":
            p["mlstm"] = xlstm_mod.mlstm_init(gen, cfg, dt)
        elif kind == "slstm":
            p["slstm"] = xlstm_mod.slstm_init(gen, cfg, dt)
        elif kind != "mamba" or cfg.d_ff > 0:
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


def param_shapes(cfg: ModelConfig) -> dict:
    """``init_params``'s tree for ``cfg`` as meta tensors: every leaf's shape
    and dtype at any width (llama4-maverick's published config among them),
    with nothing allocated and nothing drawn."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        fake = init_params(0, cfg, device="cpu")

    def meta(tree):
        if isinstance(tree, dict):
            return {k: meta(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [meta(v) for v in tree]
        return torch.empty(tree.shape, dtype=tree.dtype, device="meta")

    return meta(fake)


def _embed_in(params: dict, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    # F.embedding, not indexing: its backward sums a repeated token's rows in
    # a fixed order on both devices (indexing's scatter-add does not on the
    # CPU), so a resumed training run repeats the uninterrupted one exactly
    if "embeds" in batch:
        x = batch["embeds"]
    elif sharding.is_dtensor(params["embed"]["table"]):
        x = _embed_sharded(batch["tokens"], params["embed"]["table"])
    else:
        x = F.embedding(batch["tokens"], params["embed"]["table"])
    return x.to(dtype_of(cfg.compute_dtype))


def _embed_sharded(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """The lookup under a mesh, as the reference's partitioner runs it where
    the table (V, d) lies with its vocab on ``model``: the table gathered
    over the data axes only, each rank looking its tokens up in its own
    vocab slice (the other tokens' rows zero), the rows summed over
    ``model`` (one all-reduce of (B, S, d), each row one rank's and exact).
    The table's gradient stays on each rank's slice.  A table whose vocab
    does not lie on ``model`` is gathered whole."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    if sharding.model_placement(table) != Shard(0):
        return F.embedding(tokens, sharding.whole(table))
    mesh = table.device_mesh
    own = sharding.data_placement(tokens)
    rank = sharding.model_rank(mesh)

    def lookup(tok: torch.Tensor, tab: torch.Tensor) -> torch.Tensor:
        idx = tok - rank * tab.shape[0]
        inside = (idx >= 0) & (idx < tab.shape[0])
        rows = F.embedding(torch.where(inside, idx, 0), tab)
        return torch.where(inside[..., None], rows, 0)
    x = sharding.local_call(lookup, (tokens, sharding.gathered(table)),
                            (sharding.axis_placements(tokens, own, Replicate()),
                             sharding.axis_placements(table, Replicate(), Shard(0))),
                            sharding.axis_placements(tokens, own, Partial()), mesh)
    return x.redistribute(mesh, sharding.axis_placements(tokens, own, Replicate()))


def _lm_logits(params: dict, cfg: ModelConfig, x: torch.Tensor, plain: bool,
               keep_padded: bool = False) -> torch.Tensor:
    """f32 logits over the vocab: pad columns get -1e30, then are sliced off
    (kept with ``keep_padded``, as the reference's loss keeps them)."""
    x = rmsnorm(x, params["final_norm"]["scale"], cfg.norm_eps, plain=plain)
    head = params["embed"]["table"].T if cfg.tie_embeddings else params["lm_head"]
    logits = (x @ sharding.gathered(head)).float()
    if cfg.vocab_padded != cfg.vocab:
        pad = torch.arange(cfg.vocab_padded, device=x.device) >= cfg.vocab
        logits = logits + sharding.replicated_like(pad.float() * -1e30, logits)
    return logits if keep_padded else logits[..., :cfg.vocab]


def _ffn(p: dict, cfg: ModelConfig, x: torch.Tensor, plain: bool) -> torch.Tensor:
    """FFN(norm2(x)): the MoE where the block has one (its aux loss is
    dropped at serving, as in the reference), else the MLP."""
    h = rmsnorm(x, p["norm2"]["scale"], cfg.norm_eps, plain=plain)
    if "moe" in p:
        return moe_mod.moe_apply(p["moe"], cfg, h)[0]
    return mlp_apply(p["mlp"], h)


def _block_apply(p: dict, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor,
                 plain: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """The training (cache-free) path of one layer.  Returns (x, aux loss)."""
    aux = sharding.replicated_like(torch.zeros((), dtype=torch.float32, device=x.device), x)
    h = rmsnorm(x, p["norm1"]["scale"], cfg.norm_eps, plain=plain)
    if "mlstm" in p:
        return sharding.dp_site(x + xlstm_mod.mlstm_apply(p["mlstm"], cfg, h, plain=plain)), aux
    if "slstm" in p:
        return sharding.dp_site(x + xlstm_mod.slstm_apply(p["slstm"], cfg, h, plain=plain)), aux
    if "mla" in p:
        y = attn_mod.mla_apply(p["mla"], cfg, h, positions, plain=plain)[0]
    if "attn" in p:
        y = attn_mod.gqa_apply(p["attn"], cfg, h, positions, plain=plain)[0]
    if "ssm" in p:
        ys = ssm_mod.ssm_apply(p["ssm"], cfg, h, plain=plain)
        y = 0.5 * (y + ys) if "attn" in p else ys
    x = x + y
    if "norm2" in p:
        h2 = rmsnorm(x, p["norm2"]["scale"], cfg.norm_eps, plain=plain)
        if "moe" in p:
            y2, aux = moe_mod.moe_apply(p["moe"], cfg, h2)
        else:
            y2 = mlp_apply(p["mlp"], h2)
        x = x + y2
    return sharding.dp_site(x), aux


def block_fn(cfg: ModelConfig, *, plain: bool = False):
    """``fn(layer_params, x) -> x``: one layer of the training path on
    x (B, S, d) at positions 0..S-1, its aux loss dropped; the form
    ``parallel.pipeline`` runs a block stack in."""
    def fn(p: dict, x: torch.Tensor) -> torch.Tensor:
        return _block_apply(p, cfg, x, torch.arange(x.shape[1], device=x.device), plain)[0]
    return fn


def forward(params: dict, cfg: ModelConfig, batch: dict, remat: bool = False,
            keep_padded: bool = False, *, plain: bool = False
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward.  Returns (logits f32 (B, S, V), aux loss).

    Layers run in pattern groups of ``len(cfg.block_pattern)``, as the
    reference's scan body; with ``remat`` each layer of a group is
    checkpointed (non-reentrant), so its activations are recomputed in the
    backward pass and only the layers' inputs are kept.  The reference
    checkpoints the group; per layer, the same recompute holds one layer's
    activations at a time, not a whole group's (with xLSTM's groups of 8
    layers, rank 0's train_4k on (16, 16) traced at a 58 GB peak, against
    the reference's record of 36.8)."""
    check_config(cfg)
    x = _embed_in(params, cfg, batch)
    positions = torch.arange(x.shape[1], device=x.device)
    period = len(cfg.block_pattern)
    blocks = params["blocks"]

    def layer(x: torch.Tensor, p: dict) -> tuple[torch.Tensor, torch.Tensor]:
        return _block_apply(p, cfg, x, positions, plain)

    auxs = []
    for g in range(0, len(blocks), period):
        aux = sharding.replicated_like(torch.zeros((), dtype=torch.float32, device=x.device), x)
        for p in blocks[g:g + period]:
            x, a = checkpoint(layer, x, p, use_reentrant=False) if remat else layer(x, p)
            aux = aux + a
        auxs.append(aux)
    return _lm_logits(params, cfg, x, plain, keep_padded), torch.stack(auxs).sum()


def loss_fn(params: dict, cfg: ModelConfig, batch: dict, remat: bool = False, *,
            plain: bool = False) -> tuple[torch.Tensor, dict]:
    """Next-token NLL (tokens) or NLL of ``labels`` (embedding inputs), plus
    0.01 x the MoE's aux loss.  Returns (loss, {"loss", "nll", "aux"})."""
    logits, aux = forward(params, cfg, batch, remat=remat, keep_padded=True, plain=plain)
    # the padded logits keep the head product and the softmax sharded on model
    logits = sharding.site(logits, ("data", None, "model"), "logits")
    labels = batch.get("labels")
    if labels is None:
        labels = batch["tokens"][:, 1:]
        logits = logits[:, :-1]
    nll = sharding.mean(_sharded_nll(logits, labels) if sharding.is_dtensor(logits)
                        else _nll(logits, labels))
    loss = nll + 0.01 * aux
    return loss, {"loss": loss, "nll": nll, "aux": aux}


def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Each token's NLL from logits holding the whole vocab."""
    return -F.log_softmax(logits, dim=-1).gather(-1, labels.long()[..., None])[..., 0]


class _VocabNLL(torch.autograd.Function):
    """Each token's NLL from one rank's slice of the vocab (x: (b, s, v)
    logits, its first column the vocab's ``v0``): the log-sum-exp from the
    row max and the sum of exponentials reduced over ``group``, minus the
    label's logit, taken by the rank that holds it and reduced the same way.
    The backward, softmax minus the label's one-hot, is each rank's own
    columns and needs no collective."""

    @staticmethod
    def forward(ctx, x, labels, group, v0):
        import torch.distributed._functional_collectives as fc

        def reduce(t, op):
            return fc.wait_tensor(fc.all_reduce(t, op, group))
        m = reduce(x.amax(-1), "max")
        lse = m + torch.log(reduce(torch.exp(x - m[..., None]).sum(-1), "sum"))
        idx = labels.long() - v0
        hit = (idx >= 0) & (idx < x.shape[-1])
        idx = idx.clamp(0, x.shape[-1] - 1)
        picked = reduce(torch.where(hit, x.gather(-1, idx[..., None])[..., 0], 0.0), "sum")
        ctx.save_for_backward(x, lse, idx, hit)
        return lse - picked

    @staticmethod
    def backward(ctx, g):
        x, lse, idx, hit = ctx.saved_tensors
        grad = torch.exp(x - lse[..., None])
        grad.scatter_add_(-1, idx[..., None], -hit.to(grad.dtype)[..., None])
        return grad * g[..., None], None, None, None


def _sharded_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The NLL (B, S) of DTensor logits (B, S, V) laid out as the loss's
    site lays them (batch on the data axes, the vocab on ``model`` where it
    divides) on each rank's shard: no rank gathers the vocab, and the
    logits' gradient comes back in their own layout.  Where each rank holds
    the whole vocab (``model`` of one, or a vocab it does not divide), the
    plain program runs on the shard, so a world of one repeats the
    unsharded step bit for bit."""
    from torch.distributed.tensor import Replicate, Shard
    mesh, axes = logits.device_mesh, sharding.active_mesh()[1]
    lpl = list(logits.placements)
    rows = sharding.axis_placements(logits, sharding.data_placement(logits), Replicate())
    fn = _nll
    if sharding.model_placement(logits) == Shard(2) and sharding.mesh_sizes(mesh)[axes.model] > 1:
        group = (mesh, mesh.mesh_dim_names.index(axes.model))
        v0 = sharding.model_rank(mesh) * logits.to_local().shape[-1]

        def fn(x, y):
            return _VocabNLL.apply(x, y, group, v0)
    return sharding.local_call(fn, (logits, labels),
                               (lpl, rows if sharding.is_dtensor(labels) else None), rows, mesh)


def _to_cache(t: torch.Tensor, cfg: ModelConfig, max_len: int) -> torch.Tensor:
    """Pad a prefill k or v (B, S', hkv, hd), or an MLA latent (B, S', r),
    to the cache's slot count."""
    swa = cfg.attn == "swa" and cfg.window
    if t.shape[1] >= max_len or (swa and t.shape[1] >= cfg.window):
        return t.contiguous()
    smax = min(max_len, cfg.window) if swa else max_len
    if sharding.is_dtensor(t):
        return F.pad(t, (0, 0) * (t.dim() - 2) + (0, smax - t.shape[1]))
    out = torch.zeros((t.shape[0], smax, *t.shape[2:]), dtype=t.dtype, device=t.device)
    out[:, :t.shape[1]] = t
    return out


def _ring(t: torch.Tensor, shift: int) -> torch.Tensor:
    """``torch.roll`` of a prefill's last ``window`` keys or values by
    ``shift`` slots; a DTensor's (its slots whole on every rank) on each
    rank's shard."""
    if sharding.is_dtensor(t):
        pl = list(t.placements)
        return sharding.local_call(lambda x: torch.roll(x, shift, dims=1), (t,), (pl,), pl,
                                   t.device_mesh)
    return torch.roll(t, shift, dims=1)


def cache_shapes(cfg: ModelConfig, batch: int, seq: int, dtype: torch.dtype | None = None
                 ) -> list[dict]:
    """Per layer, ``{name: (shape, dtype)}`` of its cache: ``k``/``v`` for
    GQA/SWA attention (ring of ``window`` slots under SWA), ``latent`` for
    MLA, ``conv``/``ssm`` for the SSM (the scan state in f32),
    ``conv``/``C``/``n``/``m`` for the mLSTM and ``h``/``c``/``n``/``m`` for
    the sLSTM (their states in f32)."""
    dt = dtype or dtype_of(cfg.compute_dtype)
    out = []
    for kind in cfg.pattern_for_layers():
        one = {}
        if kind == "mlstm":
            one.update(zip(("conv", "C", "n", "m"),
                           xlstm_mod.mlstm_cache_shape(cfg, batch, dt)))
        elif kind == "slstm":
            one.update(zip(("h", "c", "n", "m"), xlstm_mod.slstm_cache_shape(cfg, batch, dt)))
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
    """Zero cache, one dict per layer (``cache_shapes``); the xLSTM cells'
    m-states start at -30, as in the reference."""
    dev = resolve_device(device)
    return [{name: torch.full(shape, -30.0 if name == "m" else 0.0, dtype=dt, device=dev)
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
                k = _ring(k[:, -cfg.window:], S % cfg.window)
                v = _ring(v[:, -cfg.window:], S % cfg.window)
            c.update(k=_to_cache(k, cfg, max_len), v=_to_cache(v, cfg, max_len))
        if "ssm" in p:
            ys, (c["conv"], c["ssm"]) = ssm_mod.ssm_prefill(p["ssm"], cfg, h, plain=plain)
            y = 0.5 * (y + ys) if "attn" in p else ys
        if "mlstm" in p:
            y, c = xlstm_mod.mlstm_prefill(p["mlstm"], cfg, h, plain=plain)
        if "slstm" in p:
            y, c = xlstm_mod.slstm_prefill(p["slstm"], cfg, h, plain=plain)
        cache.append(c)
        x = x + y
        if "norm2" in p:  # a mamba block with d_ff 0 has no FFN
            x = x + _ffn(p, cfg, x, plain)
        x = sharding.dp_site(x)
    if sharding.is_dtensor(x):
        mesh, axes = sharding.active_mesh()
        cache = sharding.place_cache(cache, cfg.n_kv, mesh, axes)
    logits = _lm_logits(params, cfg, x[:, -1:].contiguous(), plain)
    return logits[:, 0], cache


def decode_step(params: dict, cfg: ModelConfig, tokens: torch.Tensor, cache: list[dict],
                pos: int, *, plain: bool = False) -> tuple[torch.Tensor, list[dict]]:
    """One new token per sequence.  tokens: (B, 1); pos: the current cache
    length.  Updates ``cache`` in place (the attention caches' slot is
    written, the SSM and xLSTM states are replaced); returns (logits (B, V)
    f32, cache)."""
    check_config(cfg)
    x = _embed_in(params, cfg, {"tokens": tokens})
    for p, c in zip(params["blocks"], cache):
        h = rmsnorm(x, p["norm1"]["scale"], cfg.norm_eps, plain=plain)
        if "mla" in p:
            y = attn_mod.mla_decode(p["mla"], cfg, h, c["latent"], pos, plain=plain)
        if "attn" in p:
            y = attn_mod.gqa_decode(p["attn"], cfg, h, (c["k"], c["v"]), pos, plain=plain)
        if "ssm" in p:
            ys, state = ssm_mod.ssm_decode(p["ssm"], cfg, h, (c["conv"], c["ssm"]),
                                           plain=plain)
            _keep(c, ("conv", "ssm"), state)
            y = 0.5 * (y + ys) if "attn" in p else ys
        if "mlstm" in p:
            names = ("conv", "C", "n", "m")
            y, state = xlstm_mod.mlstm_decode(p["mlstm"], cfg, h, tuple(c[k] for k in names),
                                              plain=plain)
            _keep(c, names, state)
        if "slstm" in p:
            names = ("h", "c", "n", "m")
            y, state = xlstm_mod.slstm_decode(p["slstm"], cfg, h, tuple(c[k] for k in names),
                                              plain=plain)
            _keep(c, names, state)
        x = x + y
        if "norm2" in p:  # a mamba block with d_ff 0 has no FFN
            x = x + _ffn(p, cfg, x, plain)
        x = sharding.dp_site(x)
    return _lm_logits(params, cfg, x, plain)[:, 0], cache


def _keep(c: dict, names: tuple[str, ...], state: tuple) -> None:
    """A layer's new states into its cache, each laid out as the leaf it
    replaces (a DTensor cache keeps its layout step to step)."""
    c.update((k, sharding.like(t, c[k])) for k, t in zip(names, state))
