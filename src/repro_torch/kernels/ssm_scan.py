"""Chunked SSD scan: the hand-written CUDA kernels ``csrc/ssm_scan.cu`` and
their wrapper.

Replaces the Pallas TPU kernel ``repro/kernels/ssm_scan.py::ssd_scan_pallas``.
Its bound on the card is bytes: ~110 MB a call at the serving shape, against
~7.6 GFLOP of causal work.  The TPU kernel carries the state across chunks
on its in-order grid.  Here a call runs the SSD's chunk-parallel form in
three launches, each with many more blocks than (batch, head) pairs: the
chunks' states (and cumulative decays) in parallel, the carry of the state
across chunks, then the outputs, one block per 64-row tile of a chunk.  A
single step (S = 1, every decode step) runs one small kernel instead.
``ssd_plan`` sizes the grids on the host.  Inputs are read in place through
their strides, and a ragged last chunk ends at S instead of being padded.
See the source note in the ``.cu`` file.

A CPU tensor goes to the plain version (``chunked.ssd_scan_chunked``); a CUDA
tensor launches the kernels or raises.  Meta tensors take the CUDA branch's
checks, plan, outputs and workspace without a launch, and give their work to
the trace that is recording (``cost.record``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import build, cost
from .chunked import ssd_scan_chunked as plain

MAX_P, MAX_N = 128, 64  # csrc: kMaxP, kMaxN
TILE = 64               # csrc: T, rows of an output tile
THREADS = 256           # csrc: kThreads
# x, a, b, c, h0, y, h_out, cum workspace, state workspace, B, S, H, P, N, Q,
# (b, s, h) strides of x, a, b and c, dtype codes of x, a, b, c and h0, the
# three grids, the step's team, stream
_ARGTYPES = ((ctypes.c_void_p,) * 9 + (ctypes.c_int,) * 6 + (ctypes.c_longlong,) * 12
             + (ctypes.c_int,) * 9 + (ctypes.c_void_p,))


class ScanPlan(NamedTuple):
    step: bool   # S = 1: the single-step kernel, no chunks
    chunk: int   # Q, steps per chunk
    chunks: int  # G
    tiles: int   # output tiles of TILE rows per chunk
    grid: tuple[int, int, int]  # blocks of (chunk states, carry, outputs); (0, 0, n) for a step
    team: int    # the step kernel's threads on one state row (0 when chunked)


def step_team(N: int) -> int:
    """Threads of the step kernel on one state row, 4 entries each (a power
    of two: csrc instantiates the step kernel for 1 to 16)."""
    team = 1
    while 4 * team < N:
        team *= 2
    return team


@functools.lru_cache(maxsize=256)
def ssd_plan(B: int, S: int, H: int, P: int, N: int, chunk: int) -> ScanPlan:
    """The launches of one call.  S = 1 takes the step kernel, a team of
    ``step_team(N)`` threads per (batch, head, p).  Otherwise Q = min(chunk,
    S) and G = ceil(S / Q): pass A runs a block per (batch, head, chunk),
    pass B a thread per state entry, pass C a block per (batch, head, chunk,
    output tile)."""
    if S == 1:
        team = step_team(N)
        return ScanPlan(True, 1, 1, 1, (0, 0, -(-B * H * P * team // THREADS)), team)
    Q = min(chunk, S)
    G, nt = -(-S // Q), -(-Q // TILE)
    return ScanPlan(False, Q, G, nt, (B * H * G, -(-B * H * P * N // THREADS), B * H * G * nt), 0)


def ssd_scan(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
             h0: torch.Tensor | None = None, *, chunk: int = 256
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B,S,H,P); a: (B,S,H) decay in (0,1); b, c: (B,S,H,N); h0: (B,H,P,N)
    or None.  Returns (y (B,S,H,P) in x's dtype, h_final (B,H,P,N) f32).

    Each input may be f32 or bf16 and any strides are taken as long as its
    last dim is contiguous (c may be a slice of a fused projection)."""
    build.refuse_dtensor("ssd_scan", x, a, b, c, h0)
    dev = x.device
    rest = (a, b, c) + (() if h0 is None else (h0,))
    if not (x.is_cuda and all(t.is_cuda and t.get_device() == x.get_device() for t in rest)
            or x.is_meta and all(t.is_meta for t in rest)):
        if dev.type == "cpu":
            return plain(x, a, b, c, h0, chunk=chunk)
        raise ValueError(f"ssd_scan: x on {dev}, a {a.device}, b {b.device}, c {c.device}"
                         + ("" if h0 is None else f", h0 {h0.device}"))
    build.refuse_grad("ssd_scan", build.NO_BACKWARD, x, a, b, c, h0)
    if x.dim() != 4 or b.dim() != 4 or b.shape != c.shape:
        raise ValueError(f"ssd_scan: shapes x {tuple(x.shape)}, b {tuple(b.shape)}, "
                         f"c {tuple(c.shape)}")
    B, S, H, P = x.shape
    N = b.shape[-1]
    if a.shape != (B, S, H) or b.shape[:3] != (B, S, H):
        raise ValueError(f"ssd_scan: a {tuple(a.shape)} and b {tuple(b.shape)} do not fit "
                         f"x {tuple(x.shape)}")
    if h0 is not None and (h0.shape != (B, H, P, N) or not h0.is_contiguous()):
        raise ValueError(f"ssd_scan: h0 must be a contiguous ({B}, {H}, {P}, {N}), "
                         f"got {tuple(h0.shape)}")
    if P > MAX_P or N > MAX_N:
        raise ValueError(f"ssd_scan: head dim {P} (max {MAX_P}) or state {N} "
                         f"(max {MAX_N}) exceeds the kernel's")
    if x.stride(-1) != 1 or b.stride(-1) != 1 or c.stride(-1) != 1:
        raise ValueError("ssd_scan: the last dim of x, b and c must be contiguous")
    if chunk < 1 or S < 1:
        raise ValueError(f"ssd_scan: chunk {chunk} and length {S} must be positive")
    plan = ssd_plan(B, S, H, P, N, chunk)
    y = torch.empty((B, S, H, P), dtype=x.dtype, device=dev)
    h_out = torch.empty((B, H, P, N), dtype=torch.float32, device=dev)
    cum_ws = hs_ws = None
    if not plan.step:  # the running decays (B,H,G,Q), then the chunks' states (B,H,G,P,N)
        n_cum = B * H * plan.chunks * plan.chunk
        ws = torch.empty(n_cum + B * H * plan.chunks * P * N, dtype=torch.float32, device=dev)
        cum_ws, hs_ws = ws[:n_cum], ws[n_cum:]
    if x.is_meta:
        cost.record("ssd_scan", cost.ssd_scan(
            B, S, H, P, N, chunk, x.element_size(), a.element_size(), b.element_size(),
            c.element_size(), 0 if h0 is None else h0.element_size()))
        return y, h_out
    kernel = build.function("ssm_scan", "ssd_scan_fwd", _ARGTYPES)
    rc = kernel(x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
                0 if h0 is None else h0.data_ptr(), y.data_ptr(), h_out.data_ptr(),
                None if cum_ws is None else cum_ws.data_ptr(),
                None if hs_ws is None else hs_ws.data_ptr(),
                B, S, H, P, N, plan.chunk, *x.stride()[:3], *a.stride(), *b.stride()[:3],
                *c.stride()[:3], build.dtype_code(x), build.dtype_code(a),
                build.dtype_code(b), build.dtype_code(c),
                0 if h0 is None else build.dtype_code(h0), *plan.grid, plan.team,
                build.stream_of(x))
    build.check(rc, "ssd_scan")
    ssd_scan.n_launches += 1  # one per call, however many kernels it ran
    ssd_scan.last_grid = plan.grid  # the blocks of each launch, as made
    return y, h_out


ssd_scan.n_launches = 0
ssd_scan.last_grid = None
