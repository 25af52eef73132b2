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
SM count, which the meta branches plan with in place of a card's.
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
