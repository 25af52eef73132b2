"""Fused RMSNorm: the hand-written CUDA kernel ``csrc/rmsnorm.cu`` and its
wrapper.

Replaces the Pallas TPU kernel ``repro/kernels/rmsnorm.py::rmsnorm``.  Bound
on the card by bytes (each row is read and written once; the arithmetic is a
few f32 operations an element); one block per row keeps the feature dim whole
and reduces the sum of squares in f32 with warp shuffles.  See the source
note in the ``.cu`` file.

A CPU tensor goes to the plain version (``ref.rmsnorm``); a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .ref import rmsnorm as plain

# x, scale, y, n rows, d, eps, x dtype, scale dtype, stream
_ARGTYPES = ((ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 2 + (ctypes.c_float,)
             + (ctypes.c_int,) * 2 + (ctypes.c_void_p,))


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """y = x * rsqrt(mean(x^2, -1) + eps) * scale, in x's dtype."""
    if x.device.type == "cpu":
        return plain(x, scale, eps)
    if x.device.type != "cuda" or scale.device != x.device:
        raise ValueError(f"rmsnorm: x on {x.device}, scale on {scale.device}")
    d = x.shape[-1]
    if scale.shape != (d,):
        raise ValueError(f"rmsnorm: scale shape {tuple(scale.shape)} != ({d},)")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm: x and scale must be contiguous")
    y = torch.empty_like(x)
    kernel = build.function("rmsnorm", "rmsnorm_fwd", _ARGTYPES)
    rc = kernel(x.data_ptr(), scale.data_ptr(), y.data_ptr(), x.numel() // max(d, 1), d,
                float(eps), build.dtype_code(x), build.dtype_code(scale), build.stream_of(x))
    build.check(rc, "rmsnorm")
    rmsnorm.n_launches += 1
    return y


rmsnorm.n_launches = 0
