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

The gradient: with grad mode on and an input requiring grad, a CUDA call runs
under ``_SsdScanFunction``, which keeps the forward's workspace (each chunk's
running log decays and start state) and whose backward launches
``ssd_scan_bwd`` (``csrc/ssm_scan_bwd.cu``; plain version
``ref.ssd_scan_bwd``, the closed form).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import build, cost
from .chunked import ssd_scan_chunked as plain
from .ref import ssd_scan_bwd as plain_bwd

MAX_P, MAX_N = 128, 64  # csrc: kMaxP, kMaxN
TILE = 64               # csrc: T, rows of an output tile
THREADS = 256           # csrc: kThreads
# x, a, b, c, h0, y, h_out, cum workspace, state workspace, B, S, H, P, N, Q,
# (b, s, h) strides of x, a, b and c, dtype codes of x, a, b, c and h0, the
# three grids, the step's team, stream
_ARGTYPES = ((ctypes.c_void_p,) * 9 + (ctypes.c_int,) * 6 + (ctypes.c_longlong,) * 12
             + (ctypes.c_int,) * 9 + (ctypes.c_void_p,))
# the backward: x, a, b, c, dy, dh_final, cum, hs, dx, da, db, dc, dh0, the two
# workspaces, B, S, H, P, N, Q, the (b, s, h) strides of x, a, b and c, dtype
# codes of x, a, b, c, dy, dh_final and h0, the four grids, stream
_BWD_ARGTYPES = ((ctypes.c_void_p,) * 15 + (ctypes.c_int,) * 6 + (ctypes.c_longlong,) * 12
                 + (ctypes.c_int,) * 11 + (ctypes.c_void_p,))


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
    last dim is contiguous (c may be a slice of a fused projection).  With
    grad mode on and an input requiring grad, the call runs under
    ``_SsdScanFunction``, whose backward launches ``ssd_scan_bwd``."""
    build.refuse_dtensor("ssd_scan", x, a, b, c, h0)
    dev = x.device
    rest = (a, b, c) + (() if h0 is None else (h0,))
    if not (x.is_cuda and all(t.is_cuda and t.get_device() == x.get_device() for t in rest)
            or x.is_meta and all(t.is_meta for t in rest)):
        if dev.type == "cpu":
            return plain(x, a, b, c, h0, chunk=chunk)
        raise ValueError(f"ssd_scan: x on {dev}, a {a.device}, b {b.device}, c {c.device}"
                         + ("" if h0 is None else f", h0 {h0.device}"))
    _check(x, a, b, c, h0, chunk, "ssd_scan")
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (x, a, b, c, h0)):
        return _SsdScanFunction.apply(x, a, b, c, h0, chunk)
    return _forward(x, a, b, c, h0, chunk, False)[:2]


def _check(x, a, b, c, h0, chunk: int, what: str) -> None:
    if x.dim() != 4 or b.dim() != 4 or b.shape != c.shape:
        raise ValueError(f"{what}: shapes x {tuple(x.shape)}, b {tuple(b.shape)}, "
                         f"c {tuple(c.shape)}")
    B, S, H, P = x.shape
    N = b.shape[-1]
    if a.shape != (B, S, H) or b.shape[:3] != (B, S, H):
        raise ValueError(f"{what}: a {tuple(a.shape)} and b {tuple(b.shape)} do not fit "
                         f"x {tuple(x.shape)}")
    if h0 is not None and (h0.shape != (B, H, P, N) or not h0.is_contiguous()):
        raise ValueError(f"{what}: h0 must be a contiguous ({B}, {H}, {P}, {N}), "
                         f"got {tuple(h0.shape)}")
    if P > MAX_P or N > MAX_N:
        raise ValueError(f"{what}: head dim {P} (max {MAX_P}) or state {N} "
                         f"(max {MAX_N}) exceeds the kernel's")
    if x.stride(-1) != 1 or b.stride(-1) != 1 or c.stride(-1) != 1:
        raise ValueError(f"{what}: the last dim of x, b and c must be contiguous")
    if chunk < 1 or S < 1:
        raise ValueError(f"{what}: chunk {chunk} and length {S} must be positive")


def _forward(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
             h0: torch.Tensor | None, chunk: int, keep: bool
             ) -> tuple[torch.Tensor, torch.Tensor, tuple | None]:
    """One launch of the forward kernels on checked CUDA tensors (on meta
    tensors, its outputs and work with no launch): y, h_final and, ``keep``,
    what the backward reads, (cum (B*H*G*Q), hs (B*H*G*P*N)): each chunk's
    running log decays and start state, the workspace of passes A and B.  A
    single step (S = 1) has no workspace; kept, it is formed here: log
    max(a, 1e-37) and the start state h0 (or zeros)."""
    B, S, H, P = x.shape
    N = b.shape[-1]
    dev = x.device
    plan = ssd_plan(B, S, H, P, N, chunk)
    y = torch.empty((B, S, H, P), dtype=x.dtype, device=dev)
    h_out = torch.empty((B, H, P, N), dtype=torch.float32, device=dev)
    cum_ws = hs_ws = None
    if not plan.step:  # the running decays (B,H,G,Q), then the chunks' states (B,H,G,P,N)
        n_cum = B * H * plan.chunks * plan.chunk
        ws = torch.empty(n_cum + B * H * plan.chunks * P * N, dtype=torch.float32, device=dev)
        cum_ws, hs_ws = ws[:n_cum], ws[n_cum:]
    elif keep:
        cum_ws = torch.log(torch.clamp(a.float(), min=1e-37)).reshape(B, H).contiguous().flatten()
        hs_ws = (torch.zeros(B * H * P * N, dtype=torch.float32, device=dev) if h0 is None
                 else h0.float().flatten())
    saved = (cum_ws, hs_ws) if keep else None
    if x.is_meta:
        cost.record("ssd_scan", cost.ssd_scan(
            B, S, H, P, N, chunk, x.element_size(), a.element_size(), b.element_size(),
            c.element_size(), 0 if h0 is None else h0.element_size()))
        return y, h_out, saved
    kernel = build.function("ssm_scan", "ssd_scan_fwd", _ARGTYPES)
    rc = kernel(x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
                0 if h0 is None else h0.data_ptr(), y.data_ptr(), h_out.data_ptr(),
                None if plan.step else cum_ws.data_ptr(),
                None if plan.step else hs_ws.data_ptr(),
                B, S, H, P, N, plan.chunk, *x.stride()[:3], *a.stride(), *b.stride()[:3],
                *c.stride()[:3], build.dtype_code(x), build.dtype_code(a),
                build.dtype_code(b), build.dtype_code(c),
                0 if h0 is None else build.dtype_code(h0), *plan.grid, plan.team,
                build.stream_of(x))
    build.check(rc, "ssd_scan")
    ssd_scan.n_launches += 1  # one per call, however many kernels it ran
    ssd_scan.last_grid = plan.grid  # the blocks of each launch, as made
    return y, h_out, saved


ssd_scan.n_launches = 0
ssd_scan.last_grid = None


class _SsdScanFunction(torch.autograd.Function):
    """The forward kernels under autograd: they keep their workspace (the
    chunks' running log decays and start states), saved with x, a, b, c and
    h0, and the backward launches ``ssd_scan_bwd``, with h_final's gradient
    where the caller used h_final.  Under ``torch.utils.checkpoint``
    the forward runs again in the backward pass, a second forward launch.  A
    double backward raises: the backward kernel has no backward of its own."""

    @staticmethod
    def forward(ctx, x, a, b, c, h0, chunk):
        y, h_out, saved = _forward(x, a, b, c, h0, chunk, True)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, a, b, c, h0, *saved)
        ctx.chunk = chunk
        return y, h_out

    @staticmethod
    def backward(ctx, dy, dh):
        if torch.is_grad_enabled():
            raise NotImplementedError(
                "ssd_scan: a double backward (create_graph=True) through the hand-written "
                "backward kernel, which has no backward of its own")
        x, a, b, c, h0, cum, hs = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        grads = ssd_scan_bwd(x, a, b, c, h0, dy, None if dh is None else dh.contiguous(),
                             chunk=ctx.chunk, saved=(cum, hs))
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad[:5])) + (None,)


class BwdPlan(NamedTuple):
    chunk: int   # Q
    chunks: int  # G
    tiles: int   # tiles of TILE rows per chunk
    grid: tuple[int, int, int, int]  # blocks of (A' chunk sums, B' carry, C' tiles, D' da)


@functools.lru_cache(maxsize=256)
def ssd_bwd_plan(B: int, S: int, H: int, P: int, N: int, chunk: int) -> BwdPlan:
    """The backward's four launches: a block per (batch, head, chunk) for
    the chunks' sums of exp(cum_t) dy_t (x) c_t, a thread per state entry for
    the reverse carry, a block per (batch, head, chunk, tile) for dx, db, dc
    and dcum, a block per (batch, head, chunk) for da."""
    Q = min(chunk, S)
    G, nt = -(-S // Q), -(-Q // TILE)
    return BwdPlan(Q, G, nt, (B * H * G, -(-B * H * P * N // THREADS), B * H * G * nt, B * H * G))


def ssd_scan_bwd(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                 h0: torch.Tensor | None, dy: torch.Tensor, dh_final: torch.Tensor | None, *,
                 chunk: int = 256, saved: tuple | None = None) -> tuple:
    """The gradients (dx, da, db, dc, dh0) of ``ssd_scan(x, a, b, c, h0,
    chunk=chunk)`` for the cotangents ``dy`` (y's shape, contiguous) and
    ``dh_final`` (f32 (B,H,P,N) contiguous, or None: zero); each in its
    input's shape and dtype, contiguous, dh0 None without h0.  ``saved`` is
    the forward's (cum, hs), ``_forward(..., keep=True)``'s workspace, which
    a CUDA call reads (the CPU's plain version recomputes it)."""
    ts = (x, a, b, c, h0, dy, dh_final)
    build.refuse_dtensor("ssd_scan_bwd", *ts)
    if all(t is None or t.device.type == "cpu" for t in ts):
        return plain_bwd(x, a, b, c, h0, dy, dh_final, chunk=chunk)
    if any(t is not None and t.device != x.device for t in ts):
        raise ValueError("ssd_scan_bwd: x, a, b, c, h0, dy and dh_final on "
                         f"{[None if t is None else str(t.device) for t in ts]}")
    _check(x, a, b, c, h0, chunk, "ssd_scan_bwd")
    B, S, H, P = x.shape
    N = b.shape[-1]
    plan = ssd_bwd_plan(B, S, H, P, N, chunk)
    if dy.shape != x.shape or not dy.is_contiguous():
        raise ValueError(f"ssd_scan_bwd: dy must be a contiguous {tuple(x.shape)}, "
                         f"got {tuple(dy.shape)}")
    if dh_final is not None and (dh_final.shape != (B, H, P, N) or not dh_final.is_contiguous()):
        raise ValueError(f"ssd_scan_bwd: dh_final must be a contiguous ({B}, {H}, {P}, {N})")
    if saved is None:
        raise ValueError("ssd_scan_bwd: a CUDA call needs the forward's saved workspace")
    cum, hs = saved
    n_chunks = B * H * plan.chunks
    if (cum.numel() != n_chunks * plan.chunk or hs.numel() != n_chunks * P * N
            or any(t.dtype != torch.float32 or not t.is_contiguous() for t in saved)):
        raise ValueError("ssd_scan_bwd: the saved workspace does not fit this call")
    dx, da, db, dc = (torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in (x, a, b, c))
    dh0 = None if h0 is None else torch.empty(h0.shape, dtype=h0.dtype, device=h0.device)
    ws = torch.empty(n_chunks * (P * N + 2 * plan.chunk), dtype=torch.float32, device=x.device)
    dh_ws, dcum_ws = ws[:n_chunks * P * N], ws[n_chunks * P * N:]
    if x.is_meta:
        cost.record("ssd_scan_bwd", cost.ssd_scan_bwd(
            B, S, H, P, N, chunk, *(t.element_size() for t in (x, a, b, c)),
            0 if h0 is None else h0.element_size(), 0 if dh_final is None else 4))
        return dx, da, db, dc, dh0
    kernel = build.function("ssm_scan_bwd", "ssd_scan_bwd", _BWD_ARGTYPES)
    ptr = (lambda t: None if t is None else t.data_ptr())
    rc = kernel(x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(), dy.data_ptr(),
                ptr(dh_final), cum.data_ptr(), hs.data_ptr(),
                dx.data_ptr(), da.data_ptr(), db.data_ptr(), dc.data_ptr(), ptr(dh0),
                dh_ws.data_ptr(), dcum_ws.data_ptr(), B, S, H, P, N, plan.chunk,
                *x.stride()[:3], *a.stride(), *b.stride()[:3], *c.stride()[:3],
                build.dtype_code(x), build.dtype_code(a), build.dtype_code(b),
                build.dtype_code(c), build.dtype_code(dy),
                0 if dh_final is None else build.dtype_code(dh_final),
                0 if h0 is None else build.dtype_code(h0), *plan.grid, build.stream_of(x))
    build.check(rc, "ssd_scan_bwd")
    ssd_scan_bwd.n_launches += 1  # one per call: A', B', C', D'
    ssd_scan_bwd.last_grid = plan.grid
    return dx, da, db, dc, dh0


ssd_scan_bwd.n_launches = 0
ssd_scan_bwd.last_grid = None
