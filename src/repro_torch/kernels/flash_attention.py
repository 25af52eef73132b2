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
launches the kernel or raises.  A meta tensor takes the CUDA branch's checks
and output without a launch, and gives its work to the trace that is
recording (``cost.record``).  Where autograd records the call (grad mode on
and q, k or v requiring grad), the forward kernel runs inside
``_FlashAttentionFunction``: it also writes each row's log-sum-exp, and the
Function's backward launches ``flash_attention_bwd``, the hand-written
backward (``csrc/flash_attention_bwd.cu``: in bf16 Hopper's wgmma fed by TMA
in warp-specialised blocks, dQ a block of queries, which also forms D =
rowsum(dO∘O), then dK/dV a block of keys; in f32 the CUDA cores; P
recomputed from the lse, no float atomics, so the gradient repeats bit for
bit).  The backward has no
TPU counterpart: the Pallas kernel has no VJP, and the reference trains
through XLA's autodiff of ``ref.attention``, whose closed form
``ref.attention_bwd`` (the plain version) is.
"""

from __future__ import annotations

import ctypes

import torch

from . import build, cost
from .ref import attention as plain
from .ref import attention_bwd as plain_bwd

# (K head dim, V head dim) pairs the kernel is instantiated for (csrc:
# flash_attention_fwd's switch): the GQA models' (120: h2o-danube3, whose
# bf16 tiles are padded to 128 in shared memory; 96: phi3-vision) and MLA's.
HEAD_DIMS = ((32, 32), (64, 64), (128, 128), (120, 120), (96, 96), (96, 64))
# q, k, v, o, lse (null: none), B, Sq, Skv, Hq, Hkv, DK, DV, (b, s, h) strides
# of q, k and v, scale, causal, window, kv_offset, dtype, stream
_ARGTYPES = ((ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 7 + (ctypes.c_longlong,) * 9
             + (ctypes.c_float,) + (ctypes.c_int,) * 4 + (ctypes.c_void_p,))
# q, k, v, o, lse, dO, dq, dk, dv, dsum, then as the forward from B on
_BWD_ARGTYPES = ((ctypes.c_void_p,) * 10 + (ctypes.c_int,) * 7 + (ctypes.c_longlong,) * 9
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


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int | None,
           scale: float | None, what: str) -> float:
    """The kernels' checks on q, k and v (CUDA or meta); the scale to use."""
    if q.device.type not in ("cuda", "meta") or k.device != q.device or v.device != q.device:
        raise ValueError(f"{what}: q {q.device}, k {k.device}, v {v.device}")
    DK, _ = head_dims(q, k, v)
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"{what}: dtypes {q.dtype}, {k.dtype}, {v.dtype}")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError(f"{what}: the head dim must be contiguous")
    if q.dtype == torch.bfloat16 and any(
            t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3]) for t in (q, k, v)):
        raise ValueError(f"{what}: bf16 q, k and v need 16-byte aligned bases and "
                         "(batch, seq, head) strides that are multiples of 8")
    if window is not None and window <= 0:
        raise ValueError(f"{what}: window {window} must be positive")
    scale = scale if scale is not None else DK ** -0.5
    if scale == 0 and q.dtype == torch.bfloat16:  # the bf16 kernel keeps its row max unscaled
        raise ValueError(f"{what}: a bf16 scale must be non-zero")
    return scale


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    scale: float | None = None, kv_offset: int = 0) -> torch.Tensor:
    """q: (B,Sq,Hq,DK); k: (B,Skv,Hkv,DK); v: (B,Skv,Hkv,DV) -> (B,Sq,Hq,DV)
    in q's dtype, (DK, DV) one of ``HEAD_DIMS``.

    Any strides are taken as long as the head dim is contiguous (v may be a
    slice of a fused qkv projection); bf16 operands are copied 16 bytes at a
    time, so their base must be 16-byte aligned and their strides multiples
    of 8 elements.  With grad mode on and an input requiring grad, the call
    runs under ``_FlashAttentionFunction``, whose backward launches
    ``flash_attention_bwd``."""
    build.refuse_dtensor("flash_attention", q, k, v)
    if q.device.type == "cpu":
        return plain(q, k, v, causal=causal, window=window, scale=scale,
                     kv_offset=kv_offset)
    scale = _check(q, k, v, window, scale, "flash_attention")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttentionFunction.apply(q, k, v, causal, window, scale, kv_offset)
    return _forward(q, k, v, causal, window, scale, kv_offset, False)[0]


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
             window: int | None, scale: float, kv_offset: int, with_lse: bool
             ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """One launch of the forward kernel on checked CUDA tensors (on meta
    tensors, its outputs and work with no launch): o and, ``with_lse``, the
    f32 (B, Hq, Sq) log-sum-exp of each row (the kernel writes it after o,
    so o is the same to the bit either way)."""
    DK, DV = head_dims(q, k, v)
    B, Sq, Hq, _ = q.shape
    _, Skv, Hkv, _ = k.shape
    o = torch.empty((B, Sq, Hq, DV), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device) if with_lse
           else None)
    if q.is_meta:
        cost.record("flash_attention", cost.flash_attention(
            B, Sq, Skv, Hq, Hkv, DK, DV, q.element_size(), causal, window, kv_offset))
        return o, lse
    kernel = build.function("flash_attention", "flash_attention_fwd", _ARGTYPES)
    rc = kernel(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                None if lse is None else lse.data_ptr(), B, Sq, Skv, Hq, Hkv,
                DK, DV, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], float(scale),
                int(causal), -1 if window is None else int(window), int(kv_offset),
                build.dtype_code(q), build.stream_of(q))
    build.check(rc, "flash_attention")
    flash_attention.n_launches += 1
    return o, lse


flash_attention.n_launches = 0


class _FlashAttentionFunction(torch.autograd.Function):
    """The forward kernel under autograd: it also writes the rows'
    log-sum-exp, saves q, k, v, o and lse, and its backward launches
    ``flash_attention_bwd``.  Under ``torch.utils.checkpoint`` the forward
    runs again in the backward pass, a second forward launch.  A double
    backward raises: the backward kernel has no backward of its own."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, kv_offset):
        o, lse = _forward(q, k, v, causal, window, scale, kv_offset, True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kw = dict(causal=causal, window=window, scale=scale, kv_offset=kv_offset)
        return o

    @staticmethod
    def backward(ctx, do):
        if torch.is_grad_enabled():
            raise NotImplementedError(
                "flash_attention: a double backward (create_graph=True) through the "
                "hand-written backward kernel, which has no backward of its own")
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        if not do.is_meta and do.data_ptr() % 16:  # the kernel copies 16 bytes at a time
            do = do.clone()
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, **ctx.kw)
        need = ctx.needs_input_grad
        return (dq if need[0] else None, dk if need[1] else None, dv if need[2] else None,
                None, None, None, None)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                        lse: torch.Tensor, do: torch.Tensor, *, causal: bool = True,
                        window: int | None = None, scale: float | None = None,
                        kv_offset: int = 0) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradients (dq, dk, dv) of ``flash_attention(q, k, v, ...)`` for
    an output gradient ``do``, from the forward's output ``o`` and its f32
    (B, Hq, Sq) ``lse``; each in its input's shape and dtype, contiguous.
    o and do must be contiguous (B, Sq, Hq, DV); q, k and v are taken as the
    forward takes them."""
    ts = (q, k, v, o, lse, do)
    build.refuse_dtensor("flash_attention_bwd", *ts)
    if all(t.device.type == "cpu" for t in ts):
        return plain_bwd(q, k, v, o, lse, do, causal=causal, window=window, scale=scale,
                         kv_offset=kv_offset)
    if any(t.device != q.device for t in ts):
        raise ValueError("flash_attention_bwd: q, k, v, o, lse and do on "
                         f"{[str(t.device) for t in ts]}")
    scale = _check(q, k, v, window, scale, "flash_attention_bwd")
    DK, DV = head_dims(q, k, v)
    B, Sq, Hq, _ = q.shape
    _, Skv, Hkv, _ = k.shape
    if (o.shape != (B, Sq, Hq, DV) or do.shape != o.shape or lse.shape != (B, Hq, Sq)
            or o.dtype != q.dtype or do.dtype != q.dtype or lse.dtype != torch.float32):
        raise ValueError(f"flash_attention_bwd: o {tuple(o.shape)} {o.dtype}, do "
                         f"{tuple(do.shape)} {do.dtype}, lse {tuple(lse.shape)} {lse.dtype} "
                         f"for q {tuple(q.shape)} {q.dtype}, v {tuple(v.shape)}")
    if not (o.is_contiguous() and do.is_contiguous() and lse.is_contiguous()):
        raise ValueError("flash_attention_bwd: o, do and lse must be contiguous")
    if q.dtype == torch.bfloat16 and (o.data_ptr() % 16 or do.data_ptr() % 16):
        raise ValueError("flash_attention_bwd: bf16 o and do need 16-byte aligned bases")
    dq, dk, dv = (torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in (q, k, v))
    dsum = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    if q.is_meta:
        cost.record("flash_attention_bwd", cost.flash_attention_bwd(
            B, Sq, Skv, Hq, Hkv, DK, DV, q.element_size(), causal, window, kv_offset))
        return dq, dk, dv
    kernel = build.function("flash_attention_bwd", "flash_attention_bwd", _BWD_ARGTYPES)
    rc = kernel(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dsum.data_ptr(),
                B, Sq, Skv, Hq, Hkv, DK, DV, *q.stride()[:3], *k.stride()[:3],
                *v.stride()[:3], float(scale), int(causal),
                -1 if window is None else int(window), int(kv_offset), build.dtype_code(q),
                build.stream_of(q))
    build.check(rc, "flash_attention_bwd")
    flash_attention_bwd.n_launches += 1  # one per call: D, then dK/dV, then dQ
    return dq, dk, dv


flash_attention_bwd.n_launches = 0
