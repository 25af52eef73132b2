"""The placement path's batched min-plus DP sweep: the hand-written CUDA
kernel ``csrc/dp_sweep.cu`` and its wrapper.

Replaces the jitted XLA kernel ``repro/core/batch_dp.py::_build_kernel.sweep``
(the one kernel of the placement path; it is not a Pallas kernel).  All
arithmetic is f64 and bit-identical to the numpy oracle
``repro/core/ould.py::_sparse_run``: the kernel writes each product and sum
with ``__dmul_rn`` / ``__dadd_rn`` in the oracle's order, so nvcc contracts
nothing into an FMA.  One launch runs the whole M-layer sweep; a block holds
``rows_per_block(k)`` rows of k threads.  See the source note in the ``.cu``
file.

A CPU tensor goes to the plain version (``ref.dp_sweep``); a CUDA tensor
launches the kernel or raises.  The kernel does not check candidate ids
against N: the caller (``core/batch_dp.solve_batch``) hands it the
candidate selection's node ids, all below N.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .ref import dp_sweep as plain

MAX_K = 64          # candidates a layer: the sparse DP's k, up to sparse_k overrides
ROW_THREADS = 64    # a block holds max(1, ROW_THREADS // k) rows of k threads

# spb, n, kv, ks, srcs, cand, valid, cc, n rows, m, k, rows a block, final,
# backs, stream
_ARGTYPES = ((ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_double)
             + (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 4 + (ctypes.c_void_p,) * 3)


def rows_per_block(k: int) -> int:
    """Rows a block sweeps side by side: a narrow k still fills two warps."""
    return max(1, ROW_THREADS // k)


def dp_sweep(spb: torch.Tensor, Kv: torch.Tensor, Ks: float, srcs: torch.Tensor,
             cand: torch.Tensor, valid: torch.Tensor, cc: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """final (S, k) f64 costs and backs (M-1, S, k) int64 first-argmin
    back-pointers of S rows' min-plus sweeps; shapes and order as
    ``ref.dp_sweep``."""
    ts = [spb, Kv, srcs, cand, valid] + ([cc] if cc is not None else [])
    if not all(t.is_cuda for t in ts):
        if all(t.device.type == "cpu" for t in ts):
            return plain(spb, Kv, Ks, srcs, cand, valid, cc)
        raise ValueError(f"dp_sweep: tensors on {sorted({str(t.device) for t in ts})}")
    if len({t.get_device() for t in ts}) != 1:
        raise ValueError("dp_sweep: tensors on more than one card")
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
    if not 1 <= k <= MAX_K or M < 1:
        raise ValueError(f"dp_sweep: k {k} outside 1..{MAX_K} or M {M} < 1")
    if (valid.shape != cand.shape or srcs.shape != (S,) or Kv.numel() < M - 1
            or (cc is not None and (cc.dim() != 2 or cc.shape[0] < M or cc.shape[1] != N))):
        raise ValueError(f"dp_sweep: srcs {tuple(srcs.shape)}, valid {tuple(valid.shape)}, "
                         f"Kv {tuple(Kv.shape)}, cc {None if cc is None else tuple(cc.shape)} "
                         f"do not fit cand {tuple(cand.shape)} and N {N}")
    final = torch.empty((S, k), dtype=torch.float64, device=spb.device)
    backs = torch.empty((max(M - 1, 0), S, k), dtype=torch.int64, device=spb.device)
    if S == 0:
        return final, backs
    rows = rows_per_block(k)
    kernel = build.function("dp_sweep", "dp_sweep_f64", _ARGTYPES)
    rc = kernel(spb.data_ptr(), N, Kv.data_ptr(), float(Ks), srcs.data_ptr(), cand.data_ptr(),
                valid.data_ptr(), None if cc is None else cc.data_ptr(), S, M, k, rows,
                final.data_ptr(), backs.data_ptr(), build.stream_of(spb))
    build.check(rc, "dp_sweep")
    dp_sweep.n_launches += 1
    dp_sweep.last_grid = (-(-S // rows), k, rows)  # blocks, threads x, rows a block
    return final, backs


dp_sweep.n_launches = 0
dp_sweep.last_grid = None
