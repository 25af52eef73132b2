"""Decode attention (flash-decode): the hand-written CUDA kernel
``csrc/decode_attention.cu`` and its wrapper.

Replaces the Pallas TPU kernel
``repro/kernels/decode_attention.py::decode_attention``.  Bound on the card by
bytes (the valid part of the cache is read once); one block per (batch, KV
head) lets the g query heads of a KV head share one pass over its cache, and
tiles past the valid length are not read.  See the source note in the
``.cu`` file.

A CPU tensor goes to the plain version (``ref.decode_attention``); a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .ref import decode_attention as plain

HEAD_DIMS = (32, 64, 128)
MAX_GROUP_WIDTH = 2048  # g * D accumulators per block (csrc: kMaxAcc * kThreads)
# q, k_cache, v_cache, lens, o, B, Hq, Hkv, Smax, D, scale, dtype, stream
_ARGTYPES = ((ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 5 + (ctypes.c_float, ctypes.c_int)
             + (ctypes.c_void_p,))


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     cache_len: torch.Tensor | int, *, window: int | None = None,
                     scale: float | None = None) -> torch.Tensor:
    """q: (B,Hq,D); caches: (B,Smax,Hkv,D); cache_len: valid slots, a scalar
    or (B,) -> (B,Hq,D) in q's dtype.  ``window`` is accepted and unused, as
    in the reference: validity is by slot."""
    if q.device.type == "cpu":
        return plain(q, k_cache, v_cache, cache_len, window=window, scale=scale)
    dev = q.device
    if dev.type != "cuda" or k_cache.device != dev or v_cache.device != dev:
        raise ValueError(f"decode_attention: q {dev}, caches {k_cache.device}, "
                         f"{v_cache.device}")
    if q.dim() != 3 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"decode_attention: shapes q {tuple(q.shape)}, "
                         f"caches {tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    B, Hq, D = q.shape
    _, Smax, Hkv, Dk = k_cache.shape
    if k_cache.shape[0] != B or Dk != D or Hkv == 0 or Hq % Hkv or Smax == 0:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} does not fit "
                         f"cache {tuple(k_cache.shape)}")
    if D not in HEAD_DIMS or (Hq // Hkv) * D > MAX_GROUP_WIDTH:
        raise ValueError(f"decode_attention: head dim {D} (in {HEAD_DIMS}) with group "
                         f"{Hq // Hkv} exceeds the kernel's {MAX_GROUP_WIDTH} accumulators")
    if not (q.dtype == k_cache.dtype == v_cache.dtype):
        raise ValueError(f"decode_attention: dtypes {q.dtype}, {k_cache.dtype}, "
                         f"{v_cache.dtype}")
    if not (q.is_contiguous() and k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError("decode_attention: q and caches must be contiguous")
    if isinstance(cache_len, torch.Tensor):
        lens = cache_len.to(device=dev, dtype=torch.int32).broadcast_to((B,)).contiguous()
    else:  # a fill on the card; copying a host scalar would wait for the stream
        lens = torch.full((B,), int(cache_len), dtype=torch.int32, device=dev)
    scale = scale if scale is not None else D ** -0.5
    o = torch.empty_like(q)
    kernel = build.function("decode_attention", "decode_attention_fwd", _ARGTYPES)
    rc = kernel(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lens.data_ptr(),
                o.data_ptr(), B, Hq, Hkv, Smax, D, float(scale), build.dtype_code(q),
                build.stream_of(q))
    build.check(rc, "decode_attention")
    decode_attention.n_launches += 1
    return o


decode_attention.n_launches = 0
