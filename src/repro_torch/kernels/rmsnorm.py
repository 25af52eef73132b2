"""Fused RMSNorm: the hand-written CUDA kernel ``csrc/rmsnorm.cu`` and its
wrapper.

Replaces the Pallas TPU kernel ``repro/kernels/rmsnorm.py::rmsnorm``.  Bound
on the card by bytes (each row is read and written once; the arithmetic is a
few f32 operations an element).  The vector path moves 16 bytes a thread and
keeps each thread's part of the row in registers between the sum of squares
and the normalise, so x is read from device memory once; ``rmsnorm_plan``
sizes the launch on the host.  Where a 16-byte vector cannot be used, the
plan takes the kernel's scalar path.  See the source note in the ``.cu``
file.

A CPU tensor goes to the plain version (``ref.rmsnorm``); a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import build
from .ref import rmsnorm as plain

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
    if not (x.is_cuda and scale.is_cuda and scale.get_device() == x.get_device()):
        if x.device.type == "cpu":
            return plain(x, scale, eps)
        raise ValueError(f"rmsnorm: x on {x.device}, scale on {scale.device}")
    d = x.shape[-1]
    if scale.shape != (d,):
        raise ValueError(f"rmsnorm: scale shape {tuple(scale.shape)} != ({d},)")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm: x and scale must be contiguous")
    y = torch.empty_like(x)
    xp, sp, yp = x.data_ptr(), scale.data_ptr(), y.data_ptr()
    n = x.numel() // max(d, 1)
    plan = rmsnorm_plan(d, x.element_size(), not (xp | sp | yp) % 16,
                        n if n <= FEW_ROWS else None)
    kernel = build.function("rmsnorm", "rmsnorm_fwd", _ARGTYPES)
    rc = kernel(xp, sp, yp, n, d, float(eps), build.dtype_code(x), build.dtype_code(scale),
                *plan, build.stream_of(x))
    build.check(rc, "rmsnorm")
    rmsnorm.n_launches += 1
    rmsnorm.last_plan = plan  # the launch as made
    return y


rmsnorm.n_launches = 0
rmsnorm.last_plan = None
