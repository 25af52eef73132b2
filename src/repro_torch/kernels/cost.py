"""The work of each hand-written kernel as a function of its shapes: the
operations it must do (two to a multiply-add) and the bytes it must move
(each input read once, each output written once), whatever implements it.

Two readers share these formulas, so that a roofline reads the same work
whichever of them counts it: the wrappers' meta branches, which give a call's
work to the trace that is recording (``launch/dryrun.py``), and
``chip_smoke.py``'s bound columns.  Where the work depends on the data, a
formula counts what the call's own arguments need: flash attention the
(query, key) pairs its causal and window masks leave, decode attention the
valid slots of an int length (a tensor of lengths lives on the device and is
not read, so every slot counts), the SSD scan the causal form of this call's
chunks.

Also here: the H100 SXM's published peaks (NVIDIA's data sheet, dense) and
SM count, which the meta branches plan with in place of a card's; and the
dry-run's collective accounting (the reference's names and link weights).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np

# NVIDIA H100 SXM (data sheet, dense): bf16 tensor cores, f32 on the CUDA
# cores, HBM3 bytes a second; and its SMs, which the plans read on the card.
PEAK_BF16, PEAK_F32, PEAK_BYTES = 989e12, 67e12, 3.35e12
H100_SMS = 132


class Work(NamedTuple):
    flops: int  # operations, two to a multiply-add
    bytes: int  # each input read once, each output written once


def rmsnorm(rows: int, d: int, x_bytes: int, scale_bytes: int) -> Work:
    """x read and y written, the scale read once; about 4 f32 operations an
    element (square, sum, scale twice)."""
    n = rows * d
    return Work(4 * n, 2 * n * x_bytes + d * scale_bytes)


def rmsnorm_bwd(rows: int, d: int, x_bytes: int, scale_bytes: int) -> Work:
    """x and g read and dx written, the scale read and dscale written once
    (the kernel's f32 partials are its own and not counted); about 10 f32
    operations an element."""
    n = rows * d
    return Work(10 * n, 3 * n * x_bytes + 2 * d * scale_bytes)


@functools.lru_cache(maxsize=256)
def attention_pairs(sq: int, skv: int, causal: bool, window: int | None,
                    kv_offset: int = 0) -> int:
    """The (query, key) pairs the masks leave: query i at absolute position
    i + kv_offset sees keys k < skv with k <= that position (causal) and
    k > that position - window."""
    pos = np.arange(sq, dtype=np.int64) + kv_offset
    hi = np.minimum(pos, skv - 1) if causal else np.full(sq, skv - 1, dtype=np.int64)
    lo = np.maximum(pos - window + 1, 0) if window is not None else np.zeros(sq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_attention(B: int, sq: int, skv: int, hq: int, hkv: int, dk: int, dv: int,
                    elem_bytes: int, causal: bool = True, window: int | None = None,
                    kv_offset: int = 0) -> Work:
    """q, k, v read and o written once; Q·Kᵀ over dk and P·V over dv for
    each unmasked pair and query head."""
    pairs = attention_pairs(sq, skv, causal, window, kv_offset)
    return Work(2 * B * hq * (dk + dv) * pairs,
                B * (sq * hq * dk + skv * hkv * dk + skv * hkv * dv + sq * hq * dv) * elem_bytes)


def flash_attention_bwd(B: int, sq: int, skv: int, hq: int, hkv: int, dk: int, dv: int,
                        elem_bytes: int, causal: bool = True, window: int | None = None,
                        kv_offset: int = 0) -> Work:
    """q, k, v, o and dO read with the f32 lse, dq, dk and dv written once;
    for each unmasked pair and query head five products: S and dQ and dK
    over dk, dP and dV over dv."""
    pairs = attention_pairs(sq, skv, causal, window, kv_offset)
    q, kk, vv, o = B * sq * hq * dk, B * skv * hkv * dk, B * skv * hkv * dv, B * sq * hq * dv
    return Work(2 * B * hq * (3 * dk + 2 * dv) * pairs,
                (2 * (q + kk + vv) + 2 * o) * elem_bytes + B * hq * sq * 4)


def decode_attention(B: int, hq: int, hkv: int, dk: int, dv: int, valid: int,
                     elem_bytes: int) -> Work:
    """The valid K and V slots read, q read and o written once, and a 4-byte
    length a sequence; q·k over dk and p·v over dv a valid slot and query
    head."""
    return Work(2 * B * hq * (dk + dv) * valid,
                (B * valid * hkv * (dk + dv) + B * hq * (dk + dv)) * elem_bytes + B * 4)


def ssd_scan(B: int, S: int, H: int, P: int, N: int, chunk: int, x_bytes: int, a_bytes: int,
             b_bytes: int, c_bytes: int, h0_bytes: int) -> Work:
    """x, a, b, c and h0 (``h0_bytes`` 0: none) read, y (x's dtype) and the
    f32 final state written once.  Operations of the causal form this call's
    chunks need: per (batch, head) and chunk of L steps, L(L+1)/2 gate entries
    of 2N operations and their product with x (2P each), and 2LPN each for the
    inter-chunk term and the state update."""
    q = min(chunk, S)
    lens = [min(q, S - s0) for s0 in range(0, S, q)]
    flops = B * H * sum(L * (L + 1) * (N + P) + 4 * L * P * N for L in lens)
    reads = B * S * H * (P * x_bytes + a_bytes + N * (b_bytes + c_bytes)) + B * H * P * N * h0_bytes
    return Work(flops, reads + B * S * H * P * x_bytes + B * H * P * N * 4)


def ssd_scan_bwd(B: int, S: int, H: int, P: int, N: int, chunk: int, x_bytes: int,
                 a_bytes: int, b_bytes: int, c_bytes: int, h0_bytes: int,
                 dh_final_bytes: int) -> Work:
    """x, a, b, c, dy (x's dtype), h0 and dh_final (``*_bytes`` 0: none)
    read, dx, da, db, dc and dh0 written once, each in its input's dtype (the
    forward's saved workspace is the kernel's own and not counted).
    Operations of the causal form this call's chunks need: per (batch, head)
    and chunk of L steps, L(L+1)/2 (t, s) pairs of five products, DY.X^T
    and dx's over P, C.B^T, db's and dc's over N; and per step 8PN for the
    state's four terms (the chunk sums, dx's and db's injection, dc's
    inter-chunk term)."""
    q = min(chunk, S)
    lens = [min(q, S - s0) for s0 in range(0, S, q)]
    flops = B * H * sum(L * (L + 1) * (2 * P + 3 * N) + 8 * L * P * N for L in lens)
    per_step = 3 * P * x_bytes + 2 * a_bytes + 2 * N * (b_bytes + c_bytes)
    return Work(flops, B * S * H * per_step
                + B * H * P * N * (2 * h0_bytes + dh_final_bytes))


# The collectives by the reference's names (its dry-run parses them from the
# partitioned HLO), and its per-chip link traffic a result byte (ring
# algorithms, n >> 1), copied from ``repro.launch.dryrun._TRAFFIC_W``.
TRAFFIC_W = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
             "all-to-all": 1.0, "collective-permute": 1.0}
# aten's collective ops (functional, as DTensor issues them, and c10d's in-place
# ones, as ``parallel.collectives`` calls them) by those names
_COLLECTIVES = {"all_reduce": "all-reduce", "all_reduce_": "all-reduce",
                "allreduce_": "all-reduce", "all_gather_into_tensor": "all-gather",
                "allgather_": "all-gather", "_allgather_base_": "all-gather",
                "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_": "reduce-scatter",
                "_reduce_scatter_base_": "reduce-scatter", "all_to_all_single": "all-to-all",
                "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
                "broadcast_": "collective-permute", "send": "collective-permute",
                "recv_": "collective-permute",
                # DTensor's Shard(i) -> Shard(j) on one mesh dim (NCCL's all-to-all)
                "shard_dim_alltoall": "all-to-all"}


def collective(func) -> str | None:
    """The reference's name of an aten collective op, or None."""
    ns = func.namespace
    if ns not in ("_c10d_functional", "c10d", "_dtensor"):
        return None
    return _COLLECTIVES.get(func._opname)


def result_bytes(out) -> int:
    """The bytes of a collective's result tensors (a tensor, or the nested
    lists c10d's ops return)."""
    import torch
    if isinstance(out, torch.Tensor):
        return out.numel() * out.element_size()
    if isinstance(out, (list, tuple)):
        return sum(result_bytes(o) for o in out)
    return 0


def collective_counter():
    """A dispatch mode that logs each collective a block issues as (the
    reference's name, result bytes), in order (``.log``), and lets every op
    run as it would: the count of a real multi-rank run, beside which the
    dry-run's trace of the same step is held."""
    import torch
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode

    class CollectiveCount(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.log: list[tuple[str, int]] = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented  # DTensor issues its collectives on local shards
            out = func(*args, **(kwargs or {}))
            name = collective(func)
            if name is not None:
                self.log.append((name, result_bytes(out)))
            return out

        def record(self) -> dict:
            by: dict = {}
            for name, b in self.log:
                by[name] = by.get(name, 0) + b
            return collectives_record(by, len(self.log))

    del torch
    return CollectiveCount()


def collectives_record(by_op: dict, count: int) -> dict:
    """The reference's ``collectives`` block: result bytes by op, their
    weighted per-chip link traffic, and the number of collectives."""
    out = {op: int(by_op.get(op, 0)) for op in TRAFFIC_W}
    out["weighted_link_traffic"] = float(sum(TRAFFIC_W[op] * b for op, b in out.items()))
    out["count"] = int(count)
    return out


def record(kernel: str, work: Work) -> None:
    """Give a meta call's work to every active dispatch mode that records
    kernels (one with a ``record_kernel`` method: the dry-run's trace).  The
    dispatch-mode stack is thread-local state that autograd carries into its
    backward, so a backward kernel's call reaches the same trace."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
    for mode in _get_current_dispatch_mode_stack():
        rec = getattr(mode, "record_kernel", None)
        if rec is not None:
            rec(kernel, work)
