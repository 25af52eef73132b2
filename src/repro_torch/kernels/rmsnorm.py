"""Fused RMSNorm: the hand-written CUDA kernels ``csrc/rmsnorm.cu`` (forward
and backward) and their wrappers.

Replaces the Pallas TPU kernel ``repro/kernels/rmsnorm.py::rmsnorm``.  Bound
on the card by bytes (each row is read and written once; the arithmetic is a
few f32 operations an element).  The vector path moves 16 bytes a thread and
keeps each thread's part of the row in registers between the sum of squares
and the normalise, so x is read from device memory once; ``rmsnorm_plan``
sizes the launch on the host.  Where a 16-byte vector cannot be used, the
plan takes the kernel's scalar path.  See the source note in the ``.cu``
file.

A CPU tensor goes to the plain version (``ref.rmsnorm``); a CUDA tensor
launches the kernel or raises.  A meta tensor takes the CUDA branch's checks,
plan and outputs without a launch, and gives its work to the trace that is
recording (``cost.record``; ``launch/dryrun.py``).  Where autograd records
the call (grad mode on and x or scale requiring grad), the forward kernel
runs inside a ``torch.autograd.Function`` whose backward launches the
backward kernel (``rmsnorm_bwd``: dx and dscale in f32, dscale summed over
rows in a fixed order, so it repeats bit for bit).  The backward has no TPU counterpart: the
Pallas kernel has no VJP, and the reference trains through XLA's autodiff of
``ref.rmsnorm``, which ``ref.rmsnorm_bwd`` (the plain version) repeats.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import build, cost
from .ref import rmsnorm as plain
from .ref import rmsnorm_bwd as plain_bwd

VPT_CHOICES = (1, 2, 4, 8, 16)  # csrc: the instantiated vectors per thread
TARGET_VPT = 8                  # a thread holds at most this many when it can
MAX_TEAM = 256                  # threads on one row (csrc: kMaxVecThreads)
BLOCK_THREADS = 128             # a block's threads when a row needs fewer
SCALAR_THREADS = 256            # csrc: kScalarThreads, one row a block
FEW_ROWS = 128                  # up to this many rows (decode), one wide block a row

# x, scale, y, n rows, d, eps, x dtype, scale dtype, vec, vpt, threads, rows,
# stream
_ARGTYPES = ((ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 2 + (ctypes.c_float,)
             + (ctypes.c_int,) * 6 + (ctypes.c_void_p,))


class RmsnormPlan(NamedTuple):
    vec: int      # elements a thread moves per access (1: the scalar path)
    vpt: int      # 16-byte vectors a thread holds (0 on the scalar path)
    threads: int  # per block
    rows: int     # per block; threads / rows threads share a row


@functools.lru_cache(maxsize=None)
def rmsnorm_plan(d: int, elem_bytes: int, aligned: bool,
                 n_rows: int | None = None) -> RmsnormPlan:
    """The launch for ``n_rows`` rows (None: many) of ``d`` elements of
    ``elem_bytes`` bytes.

    The vector path needs ``aligned`` (x, y and scale 16-byte aligned) and d a
    multiple of the vector width.  A row's team is the fewest threads (a
    power of two) that hold it in at most ``TARGET_VPT`` vectors each, but at
    least a warp when the row has that many vectors, so that each access is
    coalesced; narrow rows share a block of ``BLOCK_THREADS``.  With up to
    ``FEW_ROWS`` rows (a decode step's) the card would sit idle on so few
    blocks, so each row gets a block of its own (a warp's worth of narrow
    rows share one) with the widest team, up to ``MAX_TEAM`` threads.  A row
    too wide for ``MAX_TEAM`` threads of 16 vectors takes the scalar path."""
    vec = 16 // elem_bytes
    if not aligned or d <= 0 or d % vec:
        return RmsnormPlan(1, 0, SCALAR_THREADS, 1)
    nv = d // vec
    few = n_rows is not None and n_rows <= FEW_ROWS
    team = 1
    while team < min(nv, 32) or team * (1 if few else TARGET_VPT) < nv:
        team *= 2
    team = min(team, MAX_TEAM)
    need = -(-nv // team)
    vpt = next((k for k in VPT_CHOICES if k >= need), None)
    if vpt is None:
        return RmsnormPlan(1, 0, SCALAR_THREADS, 1)
    rows = max(1, (32 if few else BLOCK_THREADS) // team)  # a block is at least a warp
    return RmsnormPlan(vec, vpt, team * rows, rows)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """y = x * rsqrt(mean(x^2, -1) + eps) * scale, in x's dtype."""
    build.refuse_dtensor("rmsnorm", x, scale)
    if not (x.is_cuda and scale.is_cuda and scale.get_device() == x.get_device()
            or x.is_meta and scale.is_meta):
        if x.device.type == "cpu":
            return plain(x, scale, eps)
        raise ValueError(f"rmsnorm: x on {x.device}, scale on {scale.device}")
    d = x.shape[-1]
    if scale.shape != (d,):
        raise ValueError(f"rmsnorm: scale shape {tuple(scale.shape)} != ({d},)")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm: x and scale must be contiguous")
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return _RmsnormFunction.apply(x, scale, eps)
    return _forward(x, scale, eps)


def _forward(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """One launch of the forward kernel on checked CUDA tensors (on meta
    tensors, its output and work with no launch)."""
    d = x.shape[-1]
    y = torch.empty_like(x)
    xp, sp, yp = x.data_ptr(), scale.data_ptr(), y.data_ptr()
    n = x.numel() // max(d, 1)
    plan = rmsnorm_plan(d, x.element_size(), not (xp | sp | yp) % 16,
                        n if n <= FEW_ROWS else None)
    if x.is_meta:
        cost.record("rmsnorm", cost.rmsnorm(n, d, x.element_size(), scale.element_size()))
        return y
    kernel = build.function("rmsnorm", "rmsnorm_fwd", _ARGTYPES)
    rc = kernel(xp, sp, yp, n, d, float(eps), build.dtype_code(x), build.dtype_code(scale),
                *plan, build.stream_of(x))
    build.check(rc, "rmsnorm")
    rmsnorm.n_launches += 1
    rmsnorm.last_plan = plan  # the launch as made
    return y


rmsnorm.n_launches = 0
rmsnorm.last_plan = None


class _RmsnormFunction(torch.autograd.Function):
    """The forward kernel under autograd: saves x and scale, and its backward
    launches ``rmsnorm_bwd``.  Under ``torch.utils.checkpoint`` the forward
    runs again in the backward pass, a second forward launch."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _forward(x, scale, eps)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, scale = ctx.saved_tensors
        dx, dscale = rmsnorm_bwd(x, scale, g.contiguous(), ctx.eps)
        return (dx if ctx.needs_input_grad[0] else None,
                dscale if ctx.needs_input_grad[1] else None, None)


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------

BWD_THREADS = 512       # csrc: kBwdThreads, a block of BWD_THREADS / tpr teams
BWD_VPT_CHOICES = (1, 2, 4)  # csrc: the instantiated accesses a thread holds (kBwdMaxVpt 4)
BWD_TARGET_VPT = 2      # accesses a thread holds where the team may widen (see the plan)
BWD_BLOCKS_PER_SM = 1   # the backward's grid: at most this many blocks an SM

# x, g, scale, dx, dscale, partials, n rows, d, eps, x dtype, scale dtype,
# vec, vpt, tpr, blocks, stream
_BWD_ARGTYPES = ((ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 2 + (ctypes.c_float,)
                 + (ctypes.c_int,) * 6 + (ctypes.c_void_p,))


class RmsnormBwdPlan(NamedTuple):
    vec: int     # elements a thread moves per access (1: the scalar path)
    vpt: int     # accesses of a row a thread holds in registers
    tpr: int     # threads on a row (a team); a block holds BWD_THREADS / tpr teams
    blocks: int  # grid; also the rows of the dscale partials


def max_bwd_d(vec: int) -> int:
    """The widest row the backward takes at ``vec`` elements an access: a
    block's ``BWD_THREADS`` threads on one row, each holding the most
    accesses, ``max(BWD_VPT_CHOICES)`` (16384 bf16 or 8192 f32 elements on
    the vector path, 2048 on the scalar path)."""
    return BWD_THREADS * max(BWD_VPT_CHOICES) * vec


@functools.lru_cache(maxsize=None)
def rmsnorm_bwd_plan(d: int, elem_bytes: int, aligned: bool, n_rows: int,
                     sms: int) -> RmsnormBwdPlan | None:
    """The backward's launch for ``n_rows`` rows of ``d`` elements of
    ``elem_bytes`` bytes on a card of ``sms`` SMs, or None where the row is
    wider than ``max_bwd_d``.

    16-byte vectors where ``aligned`` (x, g, dx and scale 16-byte aligned)
    and d is a multiple of the vector width, else the scalar path.  A row's
    team is the fewest threads (a power of two, a warp at least, a block at
    most) that hold it in ``BWD_TARGET_VPT`` accesses each, and each thread
    holds the fewest accesses of ``BWD_VPT_CHOICES`` that cover the row, so
    x and g stay in registers from the load to the dx store.  Wide teams
    mean few of them: on an H100 at (2048, 2048) bf16, 528 teams of 128
    threads (4 rows each, the next row's loads in flight) took 12.4 µs where
    1056 teams of 64 (2 rows each, 4 accesses a thread) took 14.9.  The grid
    is at most ``BWD_BLOCKS_PER_SM`` blocks an SM, and no more than the rows
    need: each block's teams step through the rows, and its dscale partial
    (a row of f32) is what the second kernel sums, so fewer blocks move
    fewer partial bytes."""
    vec = 16 // elem_bytes if aligned and d % (16 // elem_bytes) == 0 else 1
    if d > max_bwd_d(vec):
        return None
    nv = max(d // vec, 1)
    tpr = 32
    while tpr * BWD_TARGET_VPT < nv and tpr < BWD_THREADS:
        tpr *= 2
    vpt = next(k for k in BWD_VPT_CHOICES if k * tpr >= nv)
    blocks = min(-(-n_rows // (BWD_THREADS // tpr)), BWD_BLOCKS_PER_SM * sms)
    return RmsnormBwdPlan(vec, vpt, tpr, max(1, blocks))


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def rmsnorm_bwd(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
                eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """The gradients of ``rmsnorm(x, scale, eps)`` for an output gradient
    ``g`` (x's shape and dtype): (dx in x's dtype, dscale in scale's)."""
    ts = (x, scale, g)
    build.refuse_dtensor("rmsnorm_bwd", *ts)
    if not (all(t.is_cuda and t.get_device() == x.get_device() for t in ts)
            or all(t.is_meta for t in ts)):
        if all(t.device.type == "cpu" for t in ts):
            return plain_bwd(x, scale, g, eps)
        raise ValueError(f"rmsnorm_bwd: x on {x.device}, scale on {scale.device}, "
                         f"g on {g.device}")
    d = x.shape[-1]
    if scale.shape != (d,) or g.shape != x.shape or g.dtype != x.dtype:
        raise ValueError(f"rmsnorm_bwd: x {tuple(x.shape)} {x.dtype}, scale "
                         f"{tuple(scale.shape)}, g {tuple(g.shape)} {g.dtype}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("rmsnorm_bwd: x, scale and g must be contiguous")
    n = x.numel() // max(d, 1)
    dx = torch.empty_like(x)
    ptrs = (x.data_ptr(), g.data_ptr(), scale.data_ptr(), dx.data_ptr())
    plan = rmsnorm_bwd_plan(d, x.element_size(), not any(p % 16 for p in ptrs), max(n, 1),
                            cost.H100_SMS if x.is_meta else _sm_count(x.get_device()))
    if plan is None:
        raise ValueError(f"rmsnorm_bwd: d {d} exceeds the kernel's "
                         f"{max_bwd_d(16 // x.element_size())} (16-byte vectors) or "
                         f"{max_bwd_d(1)} (the scalar path, where x is unaligned or d is "
                         "not a multiple of the vector width)")
    if n == 0 or d == 0:
        return dx, torch.zeros_like(scale)
    dscale = torch.empty_like(scale)
    part = torch.empty((plan.blocks, d), dtype=torch.float32, device=x.device)
    if x.is_meta:
        cost.record("rmsnorm_bwd", cost.rmsnorm_bwd(n, d, x.element_size(),
                                                    scale.element_size()))
        return dx, dscale
    kernel = build.function("rmsnorm", "rmsnorm_bwd", _BWD_ARGTYPES)
    rc = kernel(*ptrs[:3], dx.data_ptr(), dscale.data_ptr(), part.data_ptr(), n, d,
                float(eps), build.dtype_code(x), build.dtype_code(scale), *plan,
                build.stream_of(x))
    build.check(rc, "rmsnorm_bwd")
    rmsnorm_bwd.n_launches += 1  # one per call: the row kernel and the dscale sum
    rmsnorm_bwd.last_plan = plan  # the launch as made
    return dx, dscale


rmsnorm_bwd.n_launches = 0
rmsnorm_bwd.last_plan = None
