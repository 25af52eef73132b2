"""The placement path's batched min-plus DP sweep: the hand-written CUDA
kernel ``csrc/dp_sweep.cu`` and its wrapper.

Replaces the jitted XLA kernel ``repro/core/batch_dp.py::_build_kernel.sweep``
(the one kernel of the placement path; it is not a Pallas kernel).  All
arithmetic is f64 and bit-identical to the numpy oracle
``repro/core/ould.py::_sparse_run``: the kernel writes each product and sum
with ``__dmul_rn`` / ``__dadd_rn`` in the oracle's order, so nvcc contracts
nothing into an FMA, and takes each argmin under a total order whose
minimum is numpy's first argmin however the predecessors are split among
lanes.  One launch runs the whole M-layer sweep: the transitions are staged
into shared memory ahead of the serial pass (a layer that repeats the
previous layer's candidates gathers nothing), and the pass spreads each
column's predecessors over ``lanes`` lanes and merges them with warp
shuffles.  ``sweep_plan`` sizes the launch on the host.  See the source
note in the ``.cu`` file.

The kernel takes every k from 1 to ``MAX_K`` = 1024, at any M.  A row's
candidates, feasibility bytes and Kv (5·M·k + 8·M bytes) sit in shared
memory as far as they fit beside the staged tiles (with or without a
compute cost, M up to 666 at k 65, 339 at k 128, 80 at k 512 and 35 at k
1024); past that the plan leaves them in device memory (``resident``
off) and the kernel reads them from there.

A CPU tensor goes to the plain version (``ref.dp_sweep``); a CUDA tensor
launches the kernel or raises, at every k.  The kernel does not check
candidate ids against N: the caller (``core/batch_dp.solve_batch``) hands
it the candidate selection's node ids, all below N.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import build
from .ref import dp_sweep as plain

MAX_THREADS = 1024    # a block's threads
MAX_K = MAX_THREADS   # candidates a layer: every column needs a thread of its own
MAX_LANES = 32        # a column's lanes stay within one warp (the shuffle merge)
SMALL_BLOCK = 544     # csrc kSmallBlock: the most threads a block whose threads still get
                      # 120 registers each (65,536 an SM / 120 = 546, down to a whole warp)
LANE_SPAN = 8         # predecessors a lane folds in the pass, about
SMEM_BYTES = 232_448  # H100: the dynamic shared memory a block can opt into
ROW_THREADS = 256     # narrow rows share a block up to about this many threads
STAGE_THREADS = 256   # a row's staging threads, at most (more only where its pass needs them)

# spb, n, kv, ks, srcs, cand, valid, cc, n rows, m, k, rows, stagers, lanes,
# tile, slots, ahead, resident, threads, smem, final, backs, stream
_ARGTYPES = ((ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_double)
             + (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 11 + (ctypes.c_longlong,)
             + (ctypes.c_void_p,) * 3)


class SweepPlan(NamedTuple):
    threads: int  # a block: rows * k * stagers, rounded up to a whole warp
    rows: int     # rows a block, each on k * stagers threads
    stagers: int  # threads a column while staging: thread q takes a = q, q + stagers, ...
    lanes: int    # lanes a column in the pass, a row's first k * lanes threads: l folds
                  # a = l, l + lanes, ...
    tile: int     # predecessors a staged tile holds, for all k columns (k: whole layers)
    slots: int    # tiles the ring in shared memory holds
    ahead: int    # tiles staged before the serial pass (all (M-1)·⌈k/tile⌉ where they fit)
    resident: bool  # a row's candidates, feasibility bytes and Kv in shared memory
    smem: int     # dynamic shared bytes a block
    grid: int     # blocks


def stagers_for(k: int) -> int:
    """Threads a column while staging: the most (a power of two, at most a
    warp, no more than k needs) that fit all k columns in
    ``STAGE_THREADS``, so that a row's gathers and transitions spread over
    several warps; at least ``lanes_for(k)``, the pass's threads."""
    q = 1
    while q * 2 <= MAX_LANES and q * 2 * k <= STAGE_THREADS and q < k:
        q *= 2
    return max(q, lanes_for(k))


def lanes_for(k: int) -> int:
    """A column's lanes: a power of two near k / ``LANE_SPAN``, so that a
    lane folds ~8 predecessors one after another and the group merges in
    few shuffle rounds; all k columns within ``SMALL_BLOCK`` threads
    (above k 272, one lane a column)."""
    lanes = 1
    while lanes * 2 * LANE_SPAN <= k and lanes * 2 <= MAX_LANES and lanes * 2 * k <= SMALL_BLOCK:
        lanes *= 2
    return lanes  # 1, 2, 4 or 8 here (k / 8 and 544 / k bound it); csrc takes any power
                  # of two up to stagers


def smem_bytes(M: int, k: int, rows: int, stagers: int, tile: int, slots: int,
               with_cc: bool, resident: bool = True) -> int:
    """Dynamic shared bytes of a block (``csrc/dp_sweep.cu::smem_bytes``):
    Kv; per row the double-buffered costs, ``slots`` tiles of k columns at an
    odd pitch (and each staging thread's compute-cost term a tile), a word of
    which layers' candidates change, the candidates as int32 and the
    feasibility bytes (Kv, candidates and bytes only where ``resident``)."""
    per_slot = k * (tile | 1) + (k * stagers if with_cc else 0)
    mm = M if resident else 0
    return 8 * (mm + rows * (2 * k + 1 + slots * per_slot)) + rows * mm * 5 * k


@functools.lru_cache(maxsize=None)
def sweep_plan(S: int, M: int, k: int, with_cc: bool, n_sm: int) -> SweepPlan:
    """The launch for S rows of M layers of k candidates on a card of
    ``n_sm`` SMs.

    A row runs on k * ``stagers_for(k)`` threads, the first k *
    ``lanes_for(k)`` of them in the serial pass; rows of fewer than
    ``ROW_THREADS`` threads share a block, but only as far as the rows
    outnumber the SMs.  The transitions are staged in tiles of ``tile``
    predecessors: whole layers, all of them before the serial pass, where
    they fit in shared memory (the placement path's shapes); else the
    largest even split of a layer of which a ring of at least two tiles
    fits, with all but one staged ahead.  A row's candidates, feasibility
    bytes and Kv are resident in shared memory where some such launch fits
    with them (at k 1024, M up to 38 without a compute cost and 35 with
    one); else the ring runs without them, which fits at any M.  Raises
    ``ValueError`` naming the cap where k is above ``MAX_K``."""
    if not 1 <= k <= MAX_K or M < 1 or S < 0:
        raise ValueError(f"dp_sweep: k {k} outside 1..{MAX_K} (the kernel's cap: a thread "
                         f"at least a column, within one block's {MAX_THREADS} threads), "
                         f"or M {M} < 1, or S {S} < 0")
    stagers, lanes = stagers_for(k), lanes_for(k)
    row_threads = k * stagers
    for resident in (True, False):
        rows = max(1, min(ROW_THREADS // row_threads, -(-max(S, 1) // n_sm)))
        while rows >= 1:
            def plan(tile: int, slots: int, ahead: int) -> SweepPlan:
                return SweepPlan(-(-rows * row_threads // 32) * 32, rows, stagers, lanes, tile,
                                 slots, ahead, resident,
                                 smem_bytes(M, k, rows, stagers, tile, slots, with_cc, resident),
                                 -(-S // rows))
            if M == 1:
                return plan(k, 0, 0)
            fixed = smem_bytes(M, k, rows, stagers, k, 0, with_cc, resident)
            for split in range(1, k + 1):
                tile = -(-k // split)
                if -(-k // tile) != split:
                    continue  # the same tiles as a smaller split
                n_tiles = (M - 1) * split
                if resident and smem_bytes(M, k, rows, stagers, tile, n_tiles, with_cc
                                           ) <= SMEM_BYTES:
                    return plan(tile, n_tiles, n_tiles)
                per_slot = smem_bytes(M, k, rows, stagers, tile, 1, with_cc, resident) - fixed
                slots = min((SMEM_BYTES - fixed) // per_slot, n_tiles)
                if slots >= 2:
                    return plan(tile, slots, slots - 1)
            rows //= 2
    raise AssertionError("dp_sweep: a ring of two one-predecessor tiles always fits")


@functools.lru_cache(maxsize=None)
def sm_count(device: int) -> int:
    """The SMs of card ``device``: the plan spreads rows over them."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def dp_sweep(spb: torch.Tensor, Kv: torch.Tensor, Ks: float, srcs: torch.Tensor,
             cand: torch.Tensor, valid: torch.Tensor, cc: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """final (S, k) f64 costs and backs (M-1, S, k) int64 first-argmin
    back-pointers of S rows' min-plus sweeps; shapes and order as
    ``ref.dp_sweep``.  After a launch ``dp_sweep.last_grid`` holds the plan
    as launched: (blocks, threads a block, rows a block, staging threads a
    column, lanes a column in the pass, tile, slots, tiles staged ahead,
    candidates resident in shared memory, dynamic shared bytes)."""
    ts = [spb, Kv, srcs, cand, valid] + ([cc] if cc is not None else [])
    build.refuse_dtensor("dp_sweep", *ts)
    if not all(t.is_cuda for t in ts):
        if all(t.device.type == "cpu" for t in ts):
            return plain(spb, Kv, Ks, srcs, cand, valid, cc)
        raise ValueError(f"dp_sweep: tensors on {sorted({str(t.device) for t in ts})}")
    if len({t.get_device() for t in ts}) != 1:
        raise ValueError("dp_sweep: tensors on more than one card")
    build.refuse_grad("dp_sweep", "a min-plus sweep with argmin back-pointers; no slice of "
                      "the port plans a backward for it", *ts)
    want = [(spb, torch.float64), (Kv, torch.float64), (srcs, torch.int64),
            (cand, torch.int64), (valid, torch.bool)] + ([(cc, torch.float64)] if cc is not None
                                                         else [])
    for t, dt in want:
        if t.dtype != dt:
            raise TypeError(f"dp_sweep: got {t.dtype} where the kernel takes {dt}")
        if not t.is_contiguous():
            raise ValueError("dp_sweep: inputs must be contiguous")
    if cand.dim() != 3 or spb.dim() != 2 or spb.shape[0] != spb.shape[1]:
        raise ValueError(f"dp_sweep: spb {tuple(spb.shape)}, cand {tuple(cand.shape)}")
    S, M, k = cand.shape
    N = spb.shape[0]
    plan = sweep_plan(S, M, k, cc is not None, sm_count(spb.get_device()))  # raises past the cap
    if (valid.shape != cand.shape or srcs.shape != (S,) or Kv.numel() < M - 1
            or (cc is not None and (cc.dim() != 2 or cc.shape[0] < M or cc.shape[1] != N))):
        raise ValueError(f"dp_sweep: srcs {tuple(srcs.shape)}, valid {tuple(valid.shape)}, "
                         f"Kv {tuple(Kv.shape)}, cc {None if cc is None else tuple(cc.shape)} "
                         f"do not fit cand {tuple(cand.shape)} and N {N}")
    final = torch.empty((S, k), dtype=torch.float64, device=spb.device)
    backs = torch.empty((max(M - 1, 0), S, k), dtype=torch.int64, device=spb.device)
    if S == 0:
        return final, backs
    kernel = build.function("dp_sweep", "dp_sweep_f64", _ARGTYPES)
    rc = kernel(spb.data_ptr(), N, Kv.data_ptr(), float(Ks), srcs.data_ptr(), cand.data_ptr(),
                valid.data_ptr(), None if cc is None else cc.data_ptr(), S, M, k, plan.rows,
                plan.stagers, plan.lanes, plan.tile, plan.slots, plan.ahead, int(plan.resident),
                plan.threads, plan.smem,
                final.data_ptr(), backs.data_ptr(), build.stream_of(spb))
    build.check(rc, "dp_sweep")
    dp_sweep.n_launches += 1
    dp_sweep.last_grid = (plan.grid, plan.threads, plan.rows, plan.stagers, plan.lanes,
                          plan.tile, plan.slots, plan.ahead, plan.resident, plan.smem)
    return final, backs


dp_sweep.n_launches = 0
dp_sweep.last_grid = None
