"""Chunked SSD scan: the hand-written CUDA kernel ``csrc/ssm_scan.cu`` and its
wrapper.

Replaces the Pallas TPU kernel ``repro/kernels/ssm_scan.py::ssd_scan_pallas``.
Its bound on the card is bytes: ~110 MB a call at the serving shape, against
~7.6 GFLOP of causal work.  The TPU kernel carries the state across chunks
on its in-order grid.  Here one block per (batch, head) loops over the
chunks with the state in shared memory, and forms the chunk's gate 64 x 64
at a time, below the diagonal only.  It reads the inputs in place through
their strides, and ends a ragged last chunk at S instead of padding.  See
the source note in the ``.cu`` file.

A CPU tensor goes to the plain version (``chunked.ssd_scan_chunked``); a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .chunked import ssd_scan_chunked as plain

MAX_P, MAX_N = 128, 64  # csrc: kMaxP, kMaxN
# x, a, b, c, h0, y, h_out, B, S, H, P, N, Q, (b, s, h) strides of x, a, b
# and c, dtype codes of x, a, b, c and h0, stream
_ARGTYPES = ((ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 6 + (ctypes.c_longlong,) * 12
             + (ctypes.c_int,) * 5 + (ctypes.c_void_p,))


def ssd_scan(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
             h0: torch.Tensor | None = None, *, chunk: int = 256
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B,S,H,P); a: (B,S,H) decay in (0,1); b, c: (B,S,H,N); h0: (B,H,P,N)
    or None.  Returns (y (B,S,H,P) in x's dtype, h_final (B,H,P,N) f32).

    Each input may be f32 or bf16 and any strides are taken as long as its
    last dim is contiguous (c may be a slice of a fused projection)."""
    if x.device.type == "cpu":
        return plain(x, a, b, c, h0, chunk=chunk)
    dev = x.device
    if dev.type != "cuda" or any(t is not None and t.device != dev for t in (a, b, c, h0)):
        raise ValueError(f"ssd_scan: x on {dev}, a {a.device}, b {b.device}, c {c.device}"
                         + ("" if h0 is None else f", h0 {h0.device}"))
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
    y = torch.empty((B, S, H, P), dtype=x.dtype, device=dev)
    h_out = torch.empty((B, H, P, N), dtype=torch.float32, device=dev)
    kernel = build.function("ssm_scan", "ssd_scan_fwd", _ARGTYPES)
    rc = kernel(x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
                0 if h0 is None else h0.data_ptr(), y.data_ptr(), h_out.data_ptr(),
                B, S, H, P, N, min(chunk, S), *x.stride()[:3], *a.stride(), *b.stride()[:3],
                *c.stride()[:3], build.dtype_code(x), build.dtype_code(a),
                build.dtype_code(b), build.dtype_code(c),
                0 if h0 is None else build.dtype_code(h0), build.stream_of(x))
    build.check(rc, "ssd_scan")
    ssd_scan.n_launches += 1
    return y, h_out


ssd_scan.n_launches = 0
