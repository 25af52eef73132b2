"""Flash-attention forward: the hand-written CUDA kernel
``csrc/flash_attention.cu`` and its wrapper.

Replaces the Pallas TPU kernel
``repro/kernels/flash_attention.py::flash_attention``.  Bound on the card by
operations at prefill sizes (~17 GFLOP on ~50 MB at B 4, S 1024).  bf16
inputs run on the bf16 tensor cores (``mma.sync``, K and V staged by
``cp.async`` in a two-stage ring, P as a bf16 high part plus the bf16 of its
remainder for P·V); f32 inputs keep exact f32 arithmetic on the CUDA cores.  Both read KV head ``h // g`` in
place instead of copying K and V per group, mask the ragged edges in the
kernel instead of padding, and skip key tiles the mask empties.  See the
source note in the ``.cu`` file.  The K head dim and the V head dim may
differ: MLA's q and k have 96 (qk_nope 64 + qk_rope 32) and its v 64.  A
head dim need not be a multiple of the tensor cores' k-step of 16: at 120
the bf16 kernel zero-pads its shared tiles to 128 and stores 120 columns.

A CPU tensor goes to the plain version (``ref.attention``); a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .ref import attention as plain

# (K head dim, V head dim) pairs the kernel is instantiated for (csrc:
# flash_attention_fwd's switch): the GQA models' (120: h2o-danube3, whose
# bf16 tiles are padded to 128 in shared memory; 96: phi3-vision) and MLA's.
HEAD_DIMS = ((32, 32), (64, 64), (128, 128), (120, 120), (96, 96), (96, 64))
# q, k, v, o, B, Sq, Skv, Hq, Hkv, DK, DV, (b, s, h) strides of q, k and v,
# scale, causal, window, kv_offset, dtype, stream
_ARGTYPES = ((ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 7 + (ctypes.c_longlong,) * 9
             + (ctypes.c_float,) + (ctypes.c_int,) * 4 + (ctypes.c_void_p,))


def head_dims(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> tuple[int, int]:
    """(DK, DV) of q (B,Sq,Hq,DK), k (B,Skv,Hkv,DK) and v (B,Skv,Hkv,DV), or a
    ValueError where the shapes do not fit together or the kernel has no
    instantiation for the pair."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or k.shape[:3] != v.shape[:3]:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    B, _, Hq, DK = q.shape
    _, Skv, Hkv, Dk = k.shape
    if k.shape[0] != B or Dk != DK or Hkv == 0 or Hq % Hkv or Skv == 0:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not fit k {tuple(k.shape)}")
    if (DK, v.shape[-1]) not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dims (k {DK}, v {v.shape[-1]}) not in "
                         f"{HEAD_DIMS}")
    return DK, v.shape[-1]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    scale: float | None = None, kv_offset: int = 0) -> torch.Tensor:
    """q: (B,Sq,Hq,DK); k: (B,Skv,Hkv,DK); v: (B,Skv,Hkv,DV) -> (B,Sq,Hq,DV)
    in q's dtype, (DK, DV) one of ``HEAD_DIMS``.

    Any strides are taken as long as the head dim is contiguous (v may be a
    slice of a fused qkv projection); bf16 operands are copied 16 bytes at a
    time, so their base must be 16-byte aligned and their strides multiples
    of 8 elements."""
    build.refuse_dtensor("flash_attention", q, k, v)
    if q.device.type == "cpu":
        return plain(q, k, v, causal=causal, window=window, scale=scale,
                     kv_offset=kv_offset)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention: q {q.device}, k {k.device}, v {v.device}")
    build.refuse_grad("flash_attention", build.NO_BACKWARD, q, k, v)
    DK, DV = head_dims(q, k, v)
    B, Sq, Hq, _ = q.shape
    _, Skv, Hkv, _ = k.shape
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, {v.dtype}")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("flash_attention: the head dim must be contiguous")
    if q.dtype == torch.bfloat16 and any(
            t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3]) for t in (q, k, v)):
        raise ValueError("flash_attention: bf16 q, k and v need 16-byte aligned bases and "
                         "(batch, seq, head) strides that are multiples of 8")
    if window is not None and window <= 0:
        raise ValueError(f"flash_attention: window {window} must be positive")
    scale = scale if scale is not None else DK ** -0.5
    if scale == 0 and q.dtype == torch.bfloat16:  # the bf16 kernel keeps its row max unscaled
        raise ValueError("flash_attention: a bf16 scale must be non-zero")
    o = torch.empty((B, Sq, Hq, DV), dtype=q.dtype, device=q.device)
    kernel = build.function("flash_attention", "flash_attention_fwd", _ARGTYPES)
    rc = kernel(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, Sq, Skv, Hq, Hkv,
                DK, DV, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], float(scale),
                int(causal), -1 if window is None else int(window), int(kv_offset),
                build.dtype_code(q), build.stream_of(q))
    build.check(rc, "flash_attention")
    flash_attention.n_launches += 1
    return o


flash_attention.n_launches = 0
