"""Dispatch for the perf-critical ops (port of ``repro.kernels.ops``).

A tensor's device picks the path: a CPU tensor runs the plain PyTorch
version (``ref.py``; ``chunked.py`` for the SSD scan), a CUDA tensor launches
the hand-written kernel or the call raises.  There is no environment override
and no fallback.  ``plain=True`` runs the plain version on any device; only
the parity checks (the tests and ``chip_smoke.py``) pass it, to hold the
kernel path against the plain one.

Under the active mesh (``parallel.sharding``) a DTensor input runs the op on
each rank's local shard (``sharding.local_call``): the norm on its rows with
d whole; attention head-parallel where ``model`` divides the kv heads or the
group, row-parallel where ``ref._row_shard`` fires (each rank's call takes
``kv_offset`` advanced by its rows' start), else replicated on ``model``;
decode attention on its kv heads, or, over a cache sharded by sequence, on
its slice of the slots, the ranks' outputs merged by their row max and sum
(decode context parallelism); the scans on their batch and heads (a train
step's mLSTM cell, whose heads ``model`` does not divide, a head on several
model ranks by v's columns).  Each wrapper sees plain tensors only.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import Replicate, Shard

from ..parallel import sharding
from . import ref
from .chunked import mlstm_chunked, ssd_scan_chunked
from .decode_attention import decode_attention as _decode_attention
from .flash_attention import flash_attention as _flash_attention
from .rmsnorm import rmsnorm as _rmsnorm
from .ssm_scan import ssd_scan as _ssd_scan


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
              window: int | None = None, scale: float | None = None,
              kv_offset: int = 0, plain: bool = False) -> torch.Tensor:
    fn = ref.attention if plain else _flash_attention
    if sharding.is_dtensor(q):
        return _sharded_attention(fn, q, k, v, causal=causal, window=window, scale=scale,
                                  kv_offset=kv_offset)
    return fn(q, k, v, causal=causal, window=window, scale=scale, kv_offset=kv_offset)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     cache_len: torch.Tensor | int, *, window: int | None = None,
                     scale: float | None = None, plain: bool = False) -> torch.Tensor:
    fn = ref.decode_attention if plain else _decode_attention
    if sharding.is_dtensor(q):
        return _sharded_decode(fn, q, k_cache, v_cache, cache_len, window=window, scale=scale)
    return fn(q, k_cache, v_cache, cache_len, window=window, scale=scale)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5, *,
            plain: bool = False) -> torch.Tensor:
    fn = ref.rmsnorm if plain else _rmsnorm
    if sharding.is_dtensor(x):
        # rows as they lie, d whole on every rank
        pl = sharding.whole_dims(x, (x.dim() - 1,))
        return sharding.local_call(fn, (x, scale, eps), (pl, sharding.replicated(x), None), pl,
                                   x.device_mesh)
    return fn(x, scale, eps)


def ssd_scan(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
             h0: torch.Tensor | None = None, *, chunk: int = 256,
             plain: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    fn = ssd_scan_chunked if plain else _ssd_scan
    if sharding.is_dtensor(x):
        # x (B, S, H, P), a (B, S, H), b, c (B, S, H, N), h0 (B, H, P, N)
        seq, st = sharding.scan_placements(x)
        return sharding.local_call(lambda *t: fn(*t, chunk=chunk), (x, a, b, c, h0),
                                   (seq, seq, seq, seq, None if h0 is None else st),
                                   (seq, st), x.device_mesh)
    return fn(x, a, b, c, h0, chunk=chunk)


def mlstm_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, i_gate: torch.Tensor,
               f_gate: torch.Tensor, *, chunk: int = 256, with_state: bool = True
               ) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor, torch.Tensor] | None]:
    """The chunked mLSTM cell (``chunked.mlstm_chunked``): y (B, S, H, P) and,
    ``with_state``, its (C, n, m).  Under a mesh, on each rank's batch and
    heads; a train step's call (``with_state=False``) whose heads do not
    divide ``model`` but whose model axis is a multiple of them runs as the
    reference's partitioner lays it out: each head on model // H ranks, each
    rank on its slice of v's P (C = k v^T and y cut by v's columns; the
    normaliser needs q and k only), y returned as (B, S, H * P) with its
    features on ``model``.  No state is returned then: a rank's C would be
    one head's slice of v's columns, a split of one mesh axis over two of
    C's dims (H and v's P) that no DTensor placement holds, and its n and m
    would repeat on the head's ranks.  So a call that keeps the state
    (prefill's, whose (C, n, m) become cache leaves laid out by heads as the
    reference's) runs on each rank's batch and heads as above, whole on
    ``model`` where the heads do not divide it."""
    # mLSTM rides on the chunked SSD form on every device, as in the reference
    if sharding.is_dtensor(q) and not with_state and sharding.head_split(q, q.shape[2]):
        return _mlstm_head_split(q, k, v, i_gate, f_gate, chunk), None
    if sharding.is_dtensor(q):
        # q, k, v (B, S, H, P), gates (B, S, H); C (B, H, P, P), n (B, H, P), m (B, H)
        seq, st = sharding.scan_placements(q)

        def fn(*t):
            y, (C, n, mm) = mlstm_chunked(*t, chunk=chunk)
            return y, C, n, mm
        y, C, n, mm = sharding.local_call(fn, (q, k, v, i_gate, f_gate), (seq,) * 5,
                                          (seq, st, st, st),
                                          q.device_mesh)
        return y, (C, n, mm)
    return mlstm_chunked(q, k, v, i_gate, f_gate, chunk=chunk)


def mlstm_recurrent(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, i_gate: torch.Tensor,
                    f_gate: torch.Tensor, c0: torch.Tensor, n0: torch.Tensor, m0: torch.Tensor
                    ) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """The sequential mLSTM cell (``ref.mlstm_scan``, decode's form; no
    kernel on any device), on each rank's batch and heads under a mesh."""
    if sharding.is_dtensor(q):
        seq, st = sharding.scan_placements(q)

        def fn(*t):
            y, (C, n, mm) = ref.mlstm_scan(*t)
            return y, C, n, mm
        y, C, n, mm = sharding.local_call(fn, (q, k, v, i_gate, f_gate, c0, n0, m0),
                                          (seq,) * 5 + (st,) * 3, (seq, st, st, st),
                                          q.device_mesh)
        return y, (C, n, mm)
    return ref.mlstm_scan(q, k, v, i_gate, f_gate, c0, n0, m0)


# --- the sharded forms ----------------------------------------------------------

def _mlstm_head_split(q, k, v, i_gate, f_gate, chunk):
    """q, k, v (B, S, H, P), gates (B, S, H), whole on ``model``: model rank
    r computes head r // w on columns (r % w) P / w .. of v, w =
    ``sharding.head_split`` ranks a head; y (B, S, H * P) with its features
    on ``model`` (rank r's slice of the flattened heads is its own piece)."""
    from torch.distributed.tensor import Replicate, Shard
    B, S, H, P = q.shape
    _, axes = sharding.active_mesh()
    ways = sharding.head_split(q, H)
    dat = sharding.data_placement(q)
    whole = sharding.axis_placements(q, dat, Replicate())
    feat = sharding.axis_placements(q, dat, Shard(2))
    rank = sharding.model_rank(q.device_mesh, axes)

    def fn(q, k, v, i, f):
        h = rank // ways
        one = slice(h, h + 1)
        y, _ = mlstm_chunked(q[:, :, one], k[:, :, one], v.reshape(*v.shape[:2], 1, P // ways),
                             i[:, :, one], f[:, :, one], chunk=chunk)
        return y.reshape(*v.shape)
    return sharding.local_call(fn, (q, k, v.reshape(B, S, H * P), i_gate, f_gate),
                               (whole, whole, feat, whole, whole), feat, q.device_mesh)


def _sharded_attention(fn, q, k, v, *, causal, window, scale, kv_offset):
    """q (B, S, Hq, D), k, v (B, Skv, Hkv, D*) DTensors -> (B, S, Hq, Dv)."""
    mesh, axes = sharding.active_mesh()
    msize = sharding.mesh_sizes(mesh)[axes.model]
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    g = Hq // Hkv
    dat = sharding.data_placement(q)
    kw = dict(causal=causal, window=window, scale=scale)
    if Hkv % msize == 0:  # each rank's kv heads and their query groups
        pl = sharding.axis_placements(q, dat, Shard(2))
        return sharding.local_call(lambda *t: fn(*t, kv_offset=kv_offset, **kw), (q, k, v),
                                   (pl, pl, pl), pl, mesh)
    q5 = q.reshape(B, Sq, Hkv, g, D)
    if g % msize == 0:  # each rank's slice of every group, k and v whole on model
        kvp = sharding.axis_placements(q, dat, Replicate())
        qp = sharding.axis_placements(q, dat, Shard(3))

        def grouped(q5, k, v):
            b, s, h, gl, d = q5.shape
            y = fn(q5.reshape(b, s, h * gl, d), k, v, kv_offset=kv_offset, **kw)
            return y.reshape(b, s, h, gl, y.shape[-1])
        y = sharding.local_call(grouped, (q5, k, v), (qp, kvp, kvp), qp, mesh)
        return y.reshape(B, Sq, Hq, y.shape[-1])
    banded = (causal and window is not None and kv_offset == 0 and Sq == k.shape[1]
              and Sq > 2 * window)
    if not banded:
        q5 = ref._row_shard(q5, Hkv, g, seq_dim=1)
        if sharding.model_placement(q5) == Shard(1):  # rows on model: k and v whole on every rank
            rows = list(q5.placements)
            whole = sharding.replicated(q5)

            def by_rows(q5, k, v):
                b, s, h, gl, d = q5.shape
                off = kv_offset + sharding.model_rank(mesh) * s
                return fn(q5.reshape(b, s, h * gl, d), k, v, kv_offset=off, **kw)
            return sharding.local_call(by_rows, (q5, k, v), (rows, whole, whole), rows, mesh)
    pl = sharding.axis_placements(q, dat, Replicate())  # every head on every model rank
    return sharding.local_call(lambda *t: fn(*t, kv_offset=kv_offset, **kw),
                               (q5.reshape(B, Sq, Hq, D), k, v), (pl, pl, pl), pl, mesh)


def _sharded_decode(fn, q, k_cache, v_cache, cache_len, *, window, scale):
    """q (B, Hq, D) and the caches (B, Smax, Hkv, D*) DTensors, laid out as
    ``sharding.cache_leaf_spec`` gives: kv heads on ``model`` (each rank its
    heads), the slots on ``model`` (each rank its slice, merged), or
    neither.  -> (B, Hq, Dv)."""
    mesh, axes = sharding.active_mesh()
    msize = sharding.mesh_sizes(mesh)[axes.model]
    dat, cm = sharding.data_placement(k_cache), sharding.model_placement(k_cache)
    kw = dict(window=window, scale=scale)
    cpl = list(k_cache.placements)
    if cm == Shard(1) and msize > 1:
        qpl = sharding.axis_placements(q, dat, Replicate())
        group = (mesh, mesh.mesh_dim_names.index(axes.model))

        def ctx(q, kc, vc):
            sl = kc.shape[1]
            n = min(max(int(cache_len) - sharding.model_rank(mesh) * sl, 0), sl)
            o, m, l = fn(q, kc, vc, n, return_ml=True, **kw)
            return merge_partials(o, m, l, group)
        return sharding.local_call(ctx, (q, k_cache, v_cache), (qpl, cpl, cpl), qpl, mesh)
    qpl = sharding.axis_placements(q, dat, Shard(1) if cm == Shard(2) else Replicate())
    return sharding.local_call(lambda *t: fn(*t, cache_len, **kw), (q, k_cache, v_cache),
                               (qpl, cpl, cpl), qpl, mesh)


def merge_partials(o: torch.Tensor, m: torch.Tensor, l: torch.Tensor, group) -> torch.Tensor:
    """The attention output over the union of the ranks' slots of a cache
    from each rank's output over its own slots ``o`` (B, H, Dv) with its row
    max ``m`` and sum ``l`` (B, H): the max all-reduced, then the rescaled
    sums (the split-K combine across ranks; no cache moves)."""
    import torch.distributed._functional_collectives as fc
    mg = fc.all_reduce(m, "max", group)
    w = l * torch.exp(m - mg)
    num = fc.all_reduce(o.float() * w[..., None], "sum", group)
    den = fc.all_reduce(w, "sum", group)
    return (num / torch.clamp(den, min=1e-30)[..., None]).to(o.dtype)
