"""xLSTM blocks (port of ``repro.models.xlstm``): the mLSTM (matrix memory,
chunk-parallel) and the sLSTM (scalar memory, strictly recurrent), after
arXiv:2405.04517 as the reference adapts them.

xlstm-1.3b runs them 7:1 (period 8) with d_ff = 0: the blocks carry their
own up and down projections and no separate FFN.  Neither cell has a kernel
in the reference (its mLSTM rides on the chunked SSD form, its sLSTM is a
``lax.scan``), so both are plain PyTorch here on every device; every RMSNorm
goes through ``ops.rmsnorm`` (the kernel on the card, ``plain=`` for the
parity checks).  ``gate_bias`` and ``bias`` stay f32 in every config, as in
the reference.

Caches: the mLSTM's (conv, C, n, m), C in the sequential form's (k, v)
layout and in f32; the sLSTM's (h, c, n, m), each (B, nh, ph) f32.

Under the active mesh, on DTensors: the projections run with their weights
gathered over the data axes, each product's gradient in its own layout
(``sharding.own_layout_grad``); the mLSTM's cell on each rank's batch and
heads where ``model`` divides them, and in the train step, where the model
axis is a multiple of the heads, each head on several model ranks by v's
columns (the reference's layout: ``ops.mlstm_scan``); the sLSTM's time loop
on each rank's batch rows, over ``model`` too where they divide
(``sharding.local_call``); the norms through the kernel on each rank's
rows.  In the train step the mLSTM's d_inner stays cut on ``model`` from the
up-projection's two halves through the conv, the SiLU, the output norm and
its gate, as the reference's partitioner keeps it (``_cut_features``); the
q/k/v and gate products take it whole, as the reference all-gathers it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Replicate, Shard

from ..configs.base import ModelConfig
from ..kernels import ops
from ..parallel import sharding
from .common import dense_init, rmsnorm
from .ssm import _causal_conv


def _mlstm_dims(cfg: ModelConfig) -> tuple[int, int, int]:
    d_inner = 2 * cfg.d_model
    nh = cfg.n_heads
    return d_inner, nh, d_inner // nh


def _chunk(cfg: ModelConfig) -> int:
    return cfg.ssm.chunk if cfg.ssm else 256


def mlstm_init(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype) -> dict:
    d = cfg.d_model
    d_inner, nh, _ = _mlstm_dims(cfg)
    dev = gen.device
    return {
        "w_up": dense_init(gen, d, (d, 2 * d_inner), dtype),          # [x | z]
        "conv": dense_init(gen, 4, (4, d_inner), dtype),
        "w_qkv": dense_init(gen, d_inner, (d_inner, 3 * d_inner), dtype),
        "w_gates": dense_init(gen, d_inner, (d_inner, 2 * nh), dtype),
        "gate_bias": torch.cat([torch.zeros(nh), 3.0 * torch.ones(nh)]).to(dev),  # [i | f]
        "norm": {"scale": torch.ones(d_inner, dtype=dtype, device=dev)},
        "w_out": dense_init(gen, d_inner, (d_inner, d), dtype),
    }


def _cut_features(x: torch.Tensor, d_inner: int) -> bool:
    """Whether the mLSTM keeps d_inner cut on ``model`` for this activation:
    under autograd (the train step) on a mesh of more than one model rank
    that divides d_inner.  The reference's compiled train_4k on (16, 16)
    holds the up-projection's product at f32[65536,512] a rank, then each
    half, the conv (f32[16,4099,256]) and the output norm (f32[16,4096,256])
    at 256 of the 4096 features, all-gathering the conv's output only for
    the q/k/v product.  Serving keeps its layout (a batch-1 decode's product
    DTensor splits over data x model itself)."""
    if not (sharding.is_dtensor(x) and torch.is_grad_enabled() and x.requires_grad):
        return False
    mesh, axes = sharding.active_mesh()
    m = sharding.mesh_sizes(mesh)[axes.model]
    return m > 1 and d_inner % m == 0


def _up_halves(x: torch.Tensor, w_up: torch.Tensor, d_inner: int, cut: bool):
    """(xs, z), the two d_inner halves of ``x @ w_up``, the product's
    gradient in its own layout (``sharding.own_layout_grad``: the halves'
    split takes the column-parallel output whole, and would hand back a
    whole gradient).  ``cut``, where the product lies column-parallel on an
    even model axis: each model rank's 1 / model of each half's features,
    moved to it by one all-to-all over ``model`` (the reference's collective
    permutes): rank r's 2 d_inner / model columns are two pieces of one
    half, for ranks 2 (r mod model / 2) and the next."""
    up = sharding.own_layout_grad(x @ w_up)
    mesh, axes = sharding.active_mesh() if cut else (None, None)
    m = sharding.mesh_sizes(mesh)[axes.model] if cut else 0
    if not cut or m % 2 or sharding.model_placement(up) != Shard(2):
        return up.chunk(2, dim=-1)
    import torch.distributed._functional_collectives as fc
    h, c, r = m // 2, d_inner // m, sharding.model_rank(mesh, axes)
    to, frm = [0] * m, [0] * m
    to[2 * (r % h)] = to[2 * (r % h) + 1] = 1       # its two pieces, in order
    frm[r // 2] = frm[h + r // 2] = 1                # its xs piece, then its z piece
    group = (mesh, mesh.mesh_dim_names.index(axes.model))

    def exchange(u):
        t = u.reshape(*u.shape[:2], 2, c).permute(2, 0, 1, 3).contiguous()
        o = fc.all_to_all_single_autograd(t, frm, to, group)
        return o[0], o[1]
    pl = list(up.placements)
    return sharding.local_call(exchange, (up,), (pl,), (pl, pl), mesh)


def _mlstm_in(p: dict, cfg: ModelConfig, x: torch.Tensor, conv_state: torch.Tensor | None):
    """Up-projection, causal conv, SiLU, q/k/v and the f32 gates."""
    B, S, _ = x.shape
    d_inner, nh, ph = _mlstm_dims(cfg)
    w = {k: sharding.gathered(p[k]) for k in ("w_up", "w_qkv", "w_gates")}
    # each product's gradient in its own layout: the chunks below take the
    # column-parallel outputs whole, and would hand back whole gradients
    lay = sharding.own_layout_grad
    cut = _cut_features(x, d_inner)
    xs, z = _up_halves(x, w["w_up"], d_inner, cut)
    xc, conv_state_new = _causal_conv(xs, p["conv"], conv_state)
    xc = F.silu(xc)
    if cut:  # whole for the products, as the reference all-gathers it
        xc = xc.redistribute(xc.device_mesh, sharding.whole_dims(xc, (2,)))
    q, k, v = (t.reshape(B, S, nh, ph) for t in lay(xc @ w["w_qkv"]).chunk(3, dim=-1))
    gates = lay(xc @ w["w_gates"]).float() + p["gate_bias"]
    i_gate, f_gate = gates.chunk(2, dim=-1)                                  # (B,S,nh)
    return q, k, v, i_gate, f_gate, z, conv_state_new


def _mlstm_out(p: dict, cfg: ModelConfig, y: torch.Tensor, z: torch.Tensor,
               plain: bool) -> torch.Tensor:
    B, S = y.shape[:2]
    y = y.reshape(B, S, -1)
    if _cut_features(y, y.shape[-1]) and sharding.model_placement(z) == Shard(2):
        # the norm on each rank's features (its mean of squares summed over
        # model), gated by its features of z: the reference's layout
        y = y.redistribute(y.device_mesh, sharding.axis_placements(
            y, sharding.data_placement(y), Shard(2)))
        y = ops.rmsnorm(y, p["norm"]["scale"], cfg.norm_eps, plain=plain, keep_cut=True)
    else:
        y = rmsnorm(y, p["norm"]["scale"], cfg.norm_eps, plain=plain)
    y = y * F.silu(z)
    w = sharding.gathered(p["w_out"])
    if (y.requires_grad and sharding.is_dtensor(w) and sharding.model_placement(w) == Shard(0)
            and sharding.model_placement(y) == Replicate()):
        # row-parallel under autograd: y's columns cut to the rank's rows of
        # w_out, so the backward's dy = g w_out^T runs on those rows only, not
        # the whole w_out.  Without a backward DTensor's own choice is kept
        # (a batch-1 decode splits the product over data x model)
        _, axes = sharding.active_mesh()
        y = y.redistribute(y.device_mesh, [Shard(2) if n == axes.model else pl for n, pl in
                                           zip(y.device_mesh.mesh_dim_names, y.placements)])
    return sharding.batch_layout(y @ w)


def mlstm_apply(p: dict, cfg: ModelConfig, x: torch.Tensor, *, plain: bool = False
                ) -> torch.Tensor:
    """The training / cache-free forward: the chunked cell."""
    q, k, v, i_gate, f_gate, z, _ = _mlstm_in(p, cfg, x, None)
    y, _ = ops.mlstm_scan(q, k, v, i_gate, f_gate, chunk=_chunk(cfg), with_state=False)
    return _mlstm_out(p, cfg, y, z, plain)


def mlstm_prefill(p: dict, cfg: ModelConfig, x: torch.Tensor, *, plain: bool = False
                  ) -> tuple[torch.Tensor, dict]:
    """Chunked forward and the state handed to decode.

    The chunked cell returns (C, n) scaled by exp(-m) with m the sequence's
    input-gate max, the invariant (state = true state * exp(-m)) that the
    sequential form keeps with its running max, so decode carries on from
    it once C is transposed to the sequential (k, v) layout."""
    q, k, v, i_gate, f_gate, z, conv_state = _mlstm_in(p, cfg, x, None)
    y, (C, n, m) = ops.mlstm_scan(q, k, v, i_gate, f_gate, chunk=_chunk(cfg))
    cache = {"conv": conv_state, "C": C.transpose(-1, -2).contiguous(), "n": n, "m": m}
    return _mlstm_out(p, cfg, y, z, plain), cache


def mlstm_decode(p: dict, cfg: ModelConfig, x: torch.Tensor, cache: tuple, *,
                 plain: bool = False) -> tuple[torch.Tensor, tuple]:
    """x: (B, S, d) with the carried (conv, C, n, m): the sequential cell."""
    conv, C, n, m = cache
    q, k, v, i_gate, f_gate, z, conv_new = _mlstm_in(p, cfg, x, conv)
    y, (C, n, m) = ops.mlstm_recurrent(q, k, v, i_gate, f_gate, C, n, m)
    return _mlstm_out(p, cfg, y, z, plain), (conv_new, C, n, m)


def mlstm_cache_shape(cfg: ModelConfig, batch: int, dtype: torch.dtype
                      ) -> tuple[tuple[tuple[int, ...], torch.dtype], ...]:
    """((shape, dtype) of conv, C, n, m): the conv context in the compute
    dtype, the cell's state in f32."""
    d_inner, nh, p = _mlstm_dims(cfg)
    return (((batch, 3, d_inner), dtype), ((batch, nh, p, p), torch.float32),
            ((batch, nh, p), torch.float32), ((batch, nh), torch.float32))


# ---------------------------------------------------------------------------
# sLSTM: scalar memory with exponential gating, sequential over time
# ---------------------------------------------------------------------------

def slstm_init(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype) -> dict:
    d = cfg.d_model
    nh = cfg.n_heads
    p = d // nh
    dev = gen.device
    return {
        "w": dense_init(gen, d, (d, 4 * d), dtype),          # i f z o pre-activations
        "r": dense_init(gen, p, (nh, p, 4 * p), dtype),      # block-diagonal recurrence
        "bias": torch.cat([torch.zeros(d), 3.0 * torch.ones(d), torch.zeros(2 * d)]).to(dev),
        "norm": {"scale": torch.ones(d, dtype=dtype, device=dev)},
        "w_out": dense_init(gen, d, (d, d), dtype),
    }


def _slstm_step(p: dict, carry: tuple, wx_t: torch.Tensor) -> tuple:
    """One step.  carry: (h, c, n, m), each (B, nh, ph) f32; wx_t: (B, 4d)
    the step's input pre-activations."""
    h, c, n, m = carry
    B, nh, ph = h.shape
    rh = torch.einsum("bhp,hpq->bhq", h.to(p["r"].dtype), p["r"])          # (B,nh,4ph)
    pre = wx_t.reshape(B, nh, 4 * ph).float() + rh.float()
    i_, f_, z_, o_ = pre.chunk(4, dim=-1)
    logf = F.logsigmoid(f_)
    m_new = torch.maximum(logf + m, i_)
    i_act = torch.exp(i_ - m_new)
    f_act = torch.exp(logf + m - m_new)
    c_new = f_act * c + i_act * torch.tanh(z_)
    n_new = f_act * n + i_act
    # torch.maximum, not clamp: at a tie (n = 1 exactly on a fresh
    # sequence's first step) it splits the gradient as jnp.maximum does
    h_new = torch.sigmoid(o_) * c_new / torch.maximum(n_new, torch.ones((), device=n.device))
    return h_new, c_new, n_new, m_new


def _slstm_loop(r: torch.Tensor, wx: torch.Tensor, state: tuple | None, dtype: torch.dtype
                ) -> tuple[torch.Tensor, tuple]:
    """The time loop over wx (B, S, 4d) f32 from ``state`` (or, for a fresh
    sequence, from m = -1e30): y (B, S, d) in ``dtype`` and the last state."""
    B, S, d4 = wx.shape
    nh = r.shape[0]
    ph = d4 // 4 // nh
    if state is None:
        z = torch.zeros((B, nh, ph), dtype=torch.float32, device=wx.device)
        state = (z, z, z, torch.full((B, nh, ph), -1e30, dtype=torch.float32, device=wx.device))
    hs = []
    for t in range(S):
        state = _slstm_step({"r": r}, state, wx[:, t])
        hs.append(state[0])
    return torch.stack(hs, dim=1).reshape(B, S, nh * ph).to(dtype), state


def _slstm_core(p: dict, cfg: ModelConfig, x: torch.Tensor, state: tuple | None,
                plain: bool) -> tuple[torch.Tensor, tuple]:
    """The time loop, one step of Python a token (the reference's
    ``lax.scan``).  A fresh sequence starts from m = -1e30.  Under a mesh the
    loop runs on each rank's batch rows (``sharding.batch_rows``: over
    ``model`` too where they divide, else whole there)."""
    wx = (x @ sharding.gathered(p["w"])).float() + p["bias"]                   # (B,S,4d)
    if sharding.is_dtensor(x):
        rows = sharding.batch_rows(x)
        whole = sharding.replicated(x)
        st = () if state is None else tuple(state)

        def loop(r, wx, *st):
            y, s = _slstm_loop(r, wx, st or None, x.dtype)
            return (y, *s)
        y, *state = sharding.local_call(loop, (p["r"], wx, *st), (whole, rows) + (rows,) * len(st),
                                        (rows,) * 5, x.device_mesh)
        state = tuple(state)
    else:
        y, state = _slstm_loop(p["r"], wx, state, x.dtype)
    y = rmsnorm(y, p["norm"]["scale"], cfg.norm_eps, plain=plain)
    return sharding.batch_layout(y @ sharding.gathered(p["w_out"])), state


def slstm_apply(p: dict, cfg: ModelConfig, x: torch.Tensor, *, plain: bool = False
                ) -> torch.Tensor:
    return _slstm_core(p, cfg, x, None, plain)[0]


def slstm_prefill(p: dict, cfg: ModelConfig, x: torch.Tensor, *, plain: bool = False
                  ) -> tuple[torch.Tensor, dict]:
    y, (h, c, n, m) = _slstm_core(p, cfg, x, None, plain)
    return y, {"h": h, "c": c, "n": n, "m": m}


def slstm_decode(p: dict, cfg: ModelConfig, x: torch.Tensor, cache: tuple, *,
                 plain: bool = False) -> tuple[torch.Tensor, tuple]:
    return _slstm_core(p, cfg, x, cache, plain)


def slstm_cache_shape(cfg: ModelConfig, batch: int, dtype: torch.dtype
                      ) -> tuple[tuple[tuple[int, ...], torch.dtype], ...]:
    """((shape, dtype) of h, c, n, m), each (B, nh, ph) f32."""
    s = ((batch, cfg.n_heads, cfg.d_model // cfg.n_heads), torch.float32)
    return (s, s, s, s)
