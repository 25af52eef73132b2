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
``kv_offset`` advanced by its rows' start), in head groups where the kv
heads and ``model`` share a factor (``sharding.head_groups``: each rank its
group's heads, its piece of their flattened output), else replicated on
``model``;
decode attention on its kv heads, or, over a cache sharded by sequence, on
its slice of the slots, the ranks' outputs merged by their row max and sum
(decode context parallelism; MLA's latent cache so, each rank expanding its
own slots); the scans on their batch and heads (a train
step's mLSTM cell, whose heads ``model`` does not divide, a head on several
model ranks by v's columns; decode's mLSTM cell on the rank's k rows of the
state, where the cache holds them; a call of the SSD scan that keeps no
state in head groups, as attention).  Each wrapper sees plain tensors only.
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
from .rmsnorm import rmsnorm_bwd as _rmsnorm_bwd
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


def latent_decode_attention(q: torch.Tensor, latent: torch.Tensor, w: torch.Tensor,
                            cache_len: torch.Tensor | int, expand, *, scale: float | None = None,
                            plain: bool = False) -> torch.Tensor:
    """Decode attention of q (B, Hq, D) over the k (B, Smax, Hq, D) and v
    (B, Smax, Hq, Dv) that ``expand(latent, w)`` makes from a latent cache
    (B, Smax, c) and a weight: MLA's, ``wkv_b`` not absorbed into q.  Under
    a mesh whose ``model`` axis holds the latent's slots, each rank expands
    its own slots with w whole and attends over them, the ranks' outputs
    merged (``_own_slots``), as the reference's compiled decode does: no k
    or v crosses a link.  Elsewhere k and v are expanded, then attended as
    ``decode_attention`` lays them out."""
    if sharding.is_dtensor(latent) and _slots_on_model(latent):
        fn = ref.decode_attention if plain else _decode_attention
        return _own_slots(fn, q, (latent, sharding.whole(w)),
                          (list(latent.placements), sharding.replicated(w)), cache_len, expand,
                          window=None, scale=scale)
    k, v = expand(latent, w)
    return decode_attention(q, k, v, cache_len, scale=scale, plain=plain)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5, *,
            plain: bool = False, keep_cut: bool = False) -> torch.Tensor:
    """RMSNorm over the last dim.  Under a mesh, rows as they lie with d
    whole on every rank; ``keep_cut``, where x's features lie cut on
    ``model``, the output stays cut the same way and each rank keeps only its
    features for the backward (``_CutFeaturesNorm``: the norm on whole
    rows, gathered for the forward and again for the backward)."""
    fn = ref.rmsnorm if plain else _rmsnorm
    if sharding.is_dtensor(x):
        if keep_cut and sharding.model_placement(x) == Shard(x.dim() - 1):
            mesh, axes = sharding.active_mesh()
            group = (mesh, mesh.mesh_dim_names.index(axes.model))
            rank = sharding.model_rank(mesh, axes)
            pl = list(x.placements)
            return sharding.local_call(
                lambda t, sc: _CutFeaturesNorm.apply(t, sc, eps, group, rank, plain), (x, scale),
                (pl, sharding.replicated(x)), pl, mesh)
        # rows as they lie, d whole on every rank
        pl = sharding.whole_dims(x, (x.dim() - 1,))
        return sharding.local_call(fn, (x, scale, eps), (pl, sharding.replicated(x), None), pl,
                                   x.device_mesh)
    return fn(x, scale, eps)


class _CutFeaturesNorm(torch.autograd.Function):
    """RMSNorm of a rank's local x whose features are its ``model`` rank's
    slice of each row: the forward all-gathers the rows over ``model``,
    normalises them whole (the kernel, or ``plain``), and keeps the rank's
    features; the backward all-gathers x and the output's gradient and runs
    the norm's backward on the whole rows.  Only the rank's slice of x is
    saved, and every value is the whole-row norm's, bit for bit.  scale's
    gradient comes back on the rank's features only (zero elsewhere), a
    pending sum over ``model``."""

    @staticmethod
    def forward(ctx, x, scale, eps, group, rank, plain):
        import torch.distributed._functional_collectives as fc
        c = x.shape[-1]
        rows = fc.wait_tensor(fc.all_gather_tensor(x.contiguous(), x.dim() - 1, group))
        y = (ref.rmsnorm if plain else _rmsnorm)(rows, scale, eps)
        ctx.save_for_backward(x, scale)
        ctx.eps, ctx.group, ctx.rank, ctx.plain = eps, group, rank, plain
        return y[..., rank * c:(rank + 1) * c].contiguous()

    @staticmethod
    def backward(ctx, g):
        import torch.distributed._functional_collectives as fc
        x, scale = ctx.saved_tensors
        c = x.shape[-1]
        rows, grows = (fc.wait_tensor(fc.all_gather_tensor(t.contiguous(), t.dim() - 1,
                                                           ctx.group)) for t in (x, g))
        dx, dscale = (ref.rmsnorm_bwd if ctx.plain else _rmsnorm_bwd)(rows, scale, grows,
                                                                      ctx.eps)
        own = slice(ctx.rank * c, (ctx.rank + 1) * c)
        ds = torch.zeros_like(dscale)
        ds[own] = dscale[own]
        return dx[..., own].contiguous(), ds, None, None, None, None


def ssd_scan(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
             h0: torch.Tensor | None = None, *, chunk: int = 256, plain: bool = False,
             with_state: bool = True, skip: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The chunked SSD scan: y (B, S, H, P), plus ``x skip`` (``skip`` (H,),
    each head's skip weight, in y's dtype) where given, and, ``with_state``,
    the final state (B, H, P, N) (else None).  Under a mesh, on each rank's
    batch and heads; a call from no h0 whose heads share a factor with
    ``model`` (``sharding.head_groups``) runs in the reference's head
    groups, the skip term on each rank's own piece, y returned as (B, S,
    H * P) with its features on ``model``: the train step's, and prefill's,
    whose final state is then handed to the cache leaf's layout, P on
    ``model`` (``_ssd_head_groups_state``).  A call from an h0 whose P lies
    on ``model`` (decode's, the cache leaf so laid out) runs every head on
    the rank's slice of P (``_ssd_by_p``): y[..., p] and h[..., p, :]
    depend on x[..., p] alone."""
    fn = ssd_scan_chunked if plain else _ssd_scan
    if sharding.is_dtensor(x):
        if h0 is not None and sharding.model_placement(h0) == Shard(2):
            return _ssd_by_p(fn, x, a, b, c, h0, skip, chunk, with_state)
        groups = 0 if h0 is not None else sharding.head_groups(x, x.shape[2], x.shape[3])
        if groups and not with_state:
            return _ssd_head_groups(fn, x, a, b, c, skip, groups, chunk), None
        m = sharding.mesh_sizes(x.device_mesh)[sharding.active_mesh()[1].model]
        if groups and x.shape[3] % m == 0:  # the state by P, as its cache leaf lies
            return _ssd_head_groups_state(fn, x, a, b, c, skip, groups, chunk)
        # x (B, S, H, P), a (B, S, H), b, c (B, S, H, N), h0 (B, H, P, N)
        seq, st = sharding.scan_placements(x)
        y, h = sharding.local_call(lambda *t: fn(*t, chunk=chunk), (x, a, b, c, h0),
                                   (seq, seq, seq, seq, None if h0 is None else st),
                                   (seq, st), x.device_mesh)
    else:
        y, h = fn(x, a, b, c, h0, chunk=chunk)
    if skip is not None:
        y = y + x * skip[None, None, :, None].to(y.dtype)
    return y, h if with_state else None


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
    kernel on any device), on each rank's batch and heads under a mesh; where
    the state's k rows lie on ``model`` (the cache leaf's layout where the
    heads do not divide the model axis), on each rank's rows of every head
    (``_mlstm_by_rows``)."""
    if sharding.is_dtensor(q) and _rows_on_model(c0, n0, m0):
        return _mlstm_by_rows(q, k, v, i_gate, f_gate, c0, n0, m0)
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

def _rows_on_model(c0, n0, m0) -> bool:
    """Whether an mLSTM state (C (B, H, P, P), n (B, H, P), m (B, H)) lies
    with k's rows on a ``model`` axis of more than one rank: C's and n's dim
    2 there, m whole there."""
    if not all(sharding.is_dtensor(t) for t in (c0, n0, m0)):
        return False
    mesh, axes = sharding.active_mesh()
    return (sharding.mesh_sizes(mesh)[axes.model] > 1 and sharding.model_placement(c0) == Shard(2)
            and sharding.model_placement(n0) == Shard(2)
            and sharding.model_placement(m0) == Replicate())


def _mlstm_by_rows(q, k, v, i_gate, f_gate, c0, n0, m0):
    """The sequential mLSTM cell on a state whose k rows lie on ``model``
    (``_rows_on_model``): each rank updates its rows of every head's C and n
    where the cache holds them (C[h, r, :] <- f C + i k[r] v^T, from the
    step's whole q, k, v and gates), m whole on every rank; the partial sums
    C^T q and n^T q over its rows are added over ``model`` in one f32
    all-reduce of (B, H, P + 1) a step, then normalised.  No collective
    moves C (xlstm-1.3B's long_500k on (16, 16): 64 of 1024 rows a rank,
    where gathering the state moved (1, 4, 1024, 1024) f32 a layer; the
    reference gathers one head's).  y comes back whole on ``model``; C, n
    and m in the cache's layout."""
    import torch.distributed._functional_collectives as fc
    mesh, axes = sharding.active_mesh()
    dat = sharding.data_placement(c0)
    whole = sharding.axis_placements(q, dat, Replicate())
    st = [list(t.placements) for t in (c0, n0, m0)]
    group = (mesh, mesh.mesh_dim_names.index(axes.model))
    r = sharding.model_rank(mesh, axes)

    def fn(q, k, v, i, f, c, n, m):
        rows = slice(r * c.shape[2], (r + 1) * c.shape[2])
        y, (c, n, m) = ref.mlstm_scan(q, k, v, i, f, c, n, m, rows=rows,
                                      psum=lambda t: fc.all_reduce(t, "sum", group))
        return y, c, n, m
    y, C, n, mm = sharding.local_call(fn, (q, k, v, i_gate, f_gate, c0, n0, m0),
                                      (whole,) * 5 + tuple(st), (whole, *st), mesh)
    return y, (C, n, mm)


def _mlstm_head_split(q, k, v, i_gate, f_gate, chunk):
    """q, k, v (B, S, H, P), gates (B, S, H), whole on ``model``: model rank
    r computes head r // w on columns (r % w) P / w .. of v, w =
    ``sharding.head_split`` ranks a head; y (B, S, H * P) with its features
    on ``model`` (rank r's slice of the flattened heads is its own piece).
    q and k lie as v does, each rank holding its P / w columns of its head
    (xlstm-1.3B's train_4k on (16, 16): (B_r, S, 1, 256) of 1024, the
    reference's layout), and are gathered whole over the head's w ranks
    where the cell contracts over them (``_head_columns``), as the
    reference's compiled cell all-gathers its b and c over each head's
    ranks (``chunked.py:73``, ``:92``); their gradients come back as the
    head's partial sums, reduced over its ranks in rank order."""
    B, S, H, P = q.shape
    mesh, axes = sharding.active_mesh()
    ways = sharding.head_split(q, H)
    dat = sharding.data_placement(q)
    whole = sharding.axis_placements(q, dat, Replicate())
    feat = sharding.axis_placements(q, dat, Shard(2))
    rank = sharding.model_rank(q.device_mesh, axes)
    m = sharding.mesh_sizes(mesh)[axes.model]
    group = (mesh, mesh.mesh_dim_names.index(axes.model))

    def fn(q, k, v, i, f):
        h = rank // ways
        one = slice(h, h + 1)

        def cut(t):
            return t.reshape(*t.shape[:2], 1, P // ways)
        y, _ = mlstm_chunked(cut(q), cut(k), cut(v), i[:, :, one], f[:, :, one], chunk=chunk,
                             gather=lambda t: _head_columns(t, ways, rank, m, group))
        return y.reshape(*v.shape)
    return sharding.local_call(fn, tuple(t.reshape(B, S, H * P) for t in (q, k, v))
                               + (i_gate, f_gate), (feat, feat, feat, whole, whole), feat,
                               q.device_mesh)


def _head_columns(t, ways: int, rank: int, m: int, group):
    """t (.., c), model rank ``rank``'s slice of its head's last dim ->
    (.., ways * c), the head's ``ways`` ranks' slices in rank order: one
    all-to-all over ``model``, each rank sending its slice to its head's
    ranks only.  The backward sends each rank the others' gradients of its
    slice and sums the ``ways`` of them in rank order."""
    import torch.distributed._functional_collectives as fc
    first = rank // ways * ways
    peers = [1 if first <= j < first + ways else 0 for j in range(m)]
    out = t.unsqueeze(0).expand(ways, *t.shape).contiguous()
    got = fc.all_to_all_single_autograd(out, peers, peers, group)      # (ways, .., c)
    return got.movedim(0, -2).reshape(*t.shape[:-1], ways * t.shape[-1])


def _head_group_call(fn, ins: tuple, n_heads: int, width: int, groups: int,
                     replicated: int = 0):
    """``fn`` on model rank r's head group of ``ins`` (each (B, S, H_i, ..),
    whole on ``model``, its heads cut into ``groups`` equal groups; the last
    ``replicated`` of them (1, 1, H_i) weights, whole on every rank), group
    r // w of the w = model // groups ranks a group; fn returns (B, S, H_0 /
    groups, width) for its group's ``n_heads / groups`` heads, and the rank
    keeps its piece, 1 / w of them flattened: (B, S, n_heads * width) with
    its features on ``model`` (``sharding.head_groups``)."""
    mesh, axes = sharding.active_mesh()
    ways = sharding.mesh_sizes(mesh)[axes.model] // groups
    dat = sharding.data_placement(ins[0])
    whole = sharding.axis_placements(ins[0], dat, Replicate())
    feat = sharding.axis_placements(ins[0], dat, Shard(2))
    rank = sharding.model_rank(mesh, axes)
    grp, piece = rank // ways, rank % ways
    cols = n_heads // groups * width // ways

    def one(*ts):
        y = fn(*(t[:, :, grp * (t.shape[2] // groups):(grp + 1) * (t.shape[2] // groups)]
                 for t in ts))
        return y.reshape(*y.shape[:2], -1)[..., piece * cols:(piece + 1) * cols]
    pls = (whole,) * (len(ins) - replicated) + (sharding.replicated(ins[0]),) * replicated
    return sharding.local_call(one, ins, pls, feat, mesh)


def _ssd_head_groups(fn, x, a, b, c, skip, groups, chunk):
    """The SSD scan of x (B, S, H, P), a (B, S, H), b, c (B, S, H, N), whole on
    ``model``, from no state, in head groups, plus x skip (H,) where given:
    y (B, S, H * P), features on ``model``."""
    def one(x, a, b, c, *sk):
        y = fn(x, a, b, c, chunk=chunk)[0]
        return y + x * sk[0][..., None].to(y.dtype) if sk else y
    ins = (x, a, b, c) + (() if skip is None else (skip[None, None, :],))
    return _head_group_call(one, ins, x.shape[2], x.shape[3], groups,
                            replicated=int(skip is not None))


def _ssd_head_groups_state(fn, x, a, b, c, skip, groups, chunk):
    """The SSD scan of x (B, S, H, P), a (B, S, H), b, c (B, S, H, N), whole on
    ``model``, from no state, in head groups, keeping the final state:
    y as ``_ssd_head_groups`` gives it, and the state (B, H, P, N) laid out
    as the cache leaf lies (``sharding.cache_leaf_spec``: P on ``model``,
    rank j its P / model columns of every head).  Model rank r = g w + i
    (group g of k, piece i of the w = model / k ranks a group) holds its
    group's whole state; one all-to-all over ``model`` hands rank j's
    columns of group g from rank g w + j mod w, so each rank sends k
    pieces and receives one a group, in the groups' order (prefill_32k on
    (16, 16): 2 groups of 25 heads, the state (B_r, 25, 64, 16) a rank,
    then (B_r, 50, 4, 16) in the cache)."""
    import torch.distributed._functional_collectives as fc
    mesh, axes = sharding.active_mesh()
    m = sharding.mesh_sizes(mesh)[axes.model]
    ways = m // groups
    B, S, H, P = x.shape
    hg, cp = H // groups, P // m
    rank = sharding.model_rank(mesh, axes)
    grp, piece = divmod(rank, ways)
    cols = hg * P // ways
    peers = [1 if j % ways == piece else 0 for j in range(m)]   # sent to and received from
    group = (mesh, mesh.mesh_dim_names.index(axes.model))
    dat = sharding.data_placement(x)
    whole = sharding.axis_placements(x, dat, Replicate())
    feat = sharding.axis_placements(x, dat, Shard(2))   # y's features; the state's P

    def one(x, a, b, c, *sk):
        own = slice(grp * hg, (grp + 1) * hg)
        xs = x[:, :, own]
        y, h = fn(xs, a[:, :, own], b[:, :, own], c[:, :, own], chunk=chunk)
        if sk:
            y = y + xs * sk[0][..., own, None].to(y.dtype)
        y = y.reshape(*y.shape[:2], -1)[..., piece * cols:(piece + 1) * cols]
        out = torch.stack([h[:, :, j * cp:(j + 1) * cp] for j in range(m) if peers[j]])
        got = fc.wait_tensor(fc.all_to_all_single(out, peers, peers, group))
        return y, got.transpose(0, 1).reshape(h.shape[0], H, cp, h.shape[3])
    ins = (x, a, b, c) + (() if skip is None else (skip[None, None, :],))
    pls = (whole,) * 4 + (() if skip is None else (sharding.replicated(x),))
    return sharding.local_call(one, ins, pls, (feat, feat), mesh)


def _ssd_by_p(fn, x, a, b, c, h0, skip, chunk, with_state):
    """The SSD scan from h0 (B, H, P, N) whose P lies on ``model`` (the cache
    leaf's layout): every head on the rank's slice of P, x cut the same way,
    a, b and c whole (decode_32k on (16, 16): the state update at (B_r, 50,
    4, 16) a rank).  The scan is exact column by column.  y is returned
    whole on ``model``, its P gathered for the (B, S, H * P) view that
    follows; the state stays in h0's layout."""
    dat = sharding.data_placement(h0)
    whole = sharding.axis_placements(x, dat, Replicate())
    xp = sharding.axis_placements(x, dat, Shard(3))
    st = list(h0.placements)

    def one(x, a, b, c, h, *sk):
        y, h = fn(x, a, b, c, h, chunk=chunk)
        return (y + x * sk[0][..., None].to(y.dtype) if sk else y), h
    ins = (x, a, b, c, h0) + (() if skip is None else (skip[None, None, :],))
    pls = (xp, whole, whole, whole, st) + (() if skip is None else (sharding.replicated(x),))
    y, h = sharding.local_call(one, ins, pls, (xp, st), x.device_mesh)
    return y.redistribute(y.device_mesh, whole), h if with_state else None


def _sharded_attention(fn, q, k, v, *, causal, window, scale, kv_offset):
    """q (B, S, Hq, D), k, v (B, Skv, Hkv, D*) DTensors -> (B, S, Hq, Dv), or
    (B, S, Hq * Dv) with its features on ``model`` where the kv heads run in
    groups (``sharding.head_groups``)."""
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
        if sharding.model_placement(q5) == Shard(1):
            # rows on model, k and v whole there: each rank at its data rank's
            # own sequences, q (which the row shard leaves whole over the
            # data axes, as the reference's) among them, so k and v are
            # gathered over model only
            own = sharding.data_placement(k)
            rows = sharding.axis_placements(q5, own, Shard(1))
            kvp = sharding.axis_placements(k, own, Replicate())

            def by_rows(q5, k, v):
                b, s, h, gl, d = q5.shape
                off = kv_offset + sharding.model_rank(mesh) * s
                return fn(q5.reshape(b, s, h * gl, d), k, v, kv_offset=off, **kw)
            return sharding.local_call(by_rows, (sharding.narrowed(q5, rows), k, v),
                                       (rows, kvp, kvp), rows, mesh)
        groups = sharding.head_groups(q, Hkv, g * v.shape[-1])
        if groups:  # each rank its kv head group's, the reference's layout
            return _head_group_call(lambda *t: fn(*t, kv_offset=kv_offset, **kw), (q, k, v),
                                    Hq, v.shape[-1], groups)
    pl = sharding.axis_placements(q, dat, Replicate())  # every head on every model rank
    return sharding.local_call(lambda *t: fn(*t, kv_offset=kv_offset, **kw),
                               (q5.reshape(B, Sq, Hq, D), k, v), (pl, pl, pl), pl, mesh)


def _sharded_decode(fn, q, k_cache, v_cache, cache_len, *, window, scale):
    """q (B, Hq, D) and the caches (B, Smax, Hkv, D*) DTensors, laid out as
    ``sharding.cache_leaf_spec`` gives: kv heads on ``model`` (each rank its
    heads), the slots on ``model`` (each rank its slice, merged), or
    neither.  -> (B, Hq, Dv)."""
    mesh = k_cache.device_mesh
    dat, cm = sharding.data_placement(k_cache), sharding.model_placement(k_cache)
    kw = dict(window=window, scale=scale)
    cpl = list(k_cache.placements)
    if _slots_on_model(k_cache):
        return _own_slots(fn, q, (k_cache, v_cache), (cpl, cpl), cache_len, lambda kc, vc: (kc, vc),
                          **kw)
    qpl = sharding.axis_placements(q, dat, Shard(1) if cm == Shard(2) else Replicate())
    return sharding.local_call(lambda *t: fn(*t, cache_len, **kw), (q, k_cache, v_cache),
                               (qpl, cpl, cpl), qpl, mesh)


def _slots_on_model(cache: torch.Tensor) -> bool:
    """Whether a DTensor cache (B, Smax, ..) holds its slots on a ``model``
    axis of more than one rank (decode context parallelism)."""
    mesh, axes = sharding.active_mesh()
    return (sharding.model_placement(cache) == Shard(1)
            and sharding.mesh_sizes(mesh)[axes.model] > 1)


def _own_slots(fn, q, ins: tuple, pls: tuple, cache_len, kv, *, window, scale):
    """Decode attention of q (B, Hq, D), whole on ``model``, over caches
    whose slots lie on ``model``: each rank makes its k and v from its own
    slots (``kv`` of its local ``ins``, laid out by ``pls``), attends over
    those of them below ``cache_len``, and the ranks' outputs are merged by
    their row max and sum (``merge_partials``).  -> (B, Hq, Dv)."""
    mesh, axes = sharding.active_mesh()
    qpl = sharding.axis_placements(q, sharding.data_placement(ins[0]), Replicate())
    group = (mesh, mesh.mesh_dim_names.index(axes.model))

    def ctx(q, *local):
        sl = local[0].shape[1]
        n = min(max(int(cache_len) - sharding.model_rank(mesh) * sl, 0), sl)
        o, m, l = fn(q, *kv(*local), n, return_ml=True, window=window, scale=scale)
        return merge_partials(o, m, l, group)
    return sharding.local_call(ctx, (q,) + ins, (qpl,) + pls, qpl, mesh)


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
