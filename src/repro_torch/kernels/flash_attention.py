"""Flash-attention forward: the hand-written CUDA kernel
``csrc/flash_attention.cu`` and its wrapper.

Replaces the Pallas TPU kernel
``repro/kernels/flash_attention.py::flash_attention``.  Bound on the card by
operations at prefill sizes (~17 GFLOP on ~50 MB at B 4, S 1024).  bf16
inputs run on Hopper's tensor cores: ``wgmma`` fed by TMA in warp-specialised
blocks (a producer warpgroup streaming K and V tiles of ``key_tile`` keys
through mbarrier rings beside two consumer warpgroups of 64 query rows; P as
a bf16 high part plus the bf16 of its remainder for P·V, from registers;
``launch_plan`` gives a launch's grid, tiles and shared bytes).  f32 inputs
keep exact f32 arithmetic on the CUDA cores.  Both read KV head ``h // g`` in
place instead of copying K and V per group, mask the ragged edges in the
kernel instead of padding, and skip key tiles the mask empties.  See the
source note in the ``.cu`` file.  The K head dim and the V head dim may
differ: MLA's q and k have 96 (qk_nope 64 + qk_rope 32) and its v 64.  A
head dim need not be a multiple of 64: at 120 and 96 the bf16 kernel's TMA
zero-fills a second 64-column panel, and DV columns are stored.

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
from typing import NamedTuple

import torch

from . import build, cost
from .ref import attention as plain
from .ref import attention_bwd as plain_bwd

# (K head dim, V head dim) pairs the kernel is instantiated for (csrc:
# flash_attention_fwd's switch): the GQA models' (120: h2o-danube3, whose
# bf16 tiles are padded to 128 in shared memory; 96: phi3-vision) and MLA's.
HEAD_DIMS = ((32, 32), (64, 64), (128, 128), (120, 120), (96, 96), (96, 64))
# Pairs the f32 kernels alone are instantiated for, forward and backward:
# the reduced configs' heads of 16 (the reference's examples train and serve
# internlm2 cut to d 64 over 4 heads in f32).
F32_HEAD_DIMS = ((16, 16),)
# q, k, v, o, lse (null: none), B, Sq, Skv, Hq, Hkv, DK, DV, (b, s, h) strides
# of q, k and v, scale, causal, window, kv_offset, dtype, stream
_ARGTYPES = ((ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 7 + (ctypes.c_longlong,) * 9
             + (ctypes.c_float,) + (ctypes.c_int,) * 4 + (ctypes.c_void_p,))
# q, k, v, o, lse, dO, dq, dk, dv, dsum, then as the forward from B on
_BWD_ARGTYPES = ((ctypes.c_void_p,) * 10 + (ctypes.c_int,) * 7 + (ctypes.c_longlong,) * 9
                 + (ctypes.c_float,) + (ctypes.c_int,) * 4 + (ctypes.c_void_p,))


# The bf16 kernel's launch (csrc/flash_attention.cu, namespace hop): a block
# of 128 query rows (two consumer warpgroups of 64 beside a producer
# warpgroup), K and V tiles of ``key_tile`` keys, each in a ring of STAGES
# stages, at most SMEM_LIMIT shared bytes a block (an H100's 227 KB).
BLOCK_Q = 128
STAGES = 2
SMEM_LIMIT = 232_448
_BOX = 64 * 128  # bytes of a TMA box: 64 rows of one 64-column bf16 panel


class FlashPlan(NamedTuple):
    grid: tuple[int, int]   # (B * Hq, query blocks)
    block_q: int            # query rows a block
    key_tile: int           # keys a streamed K or V tile
    stages: int             # stages of the K ring and of the V ring
    smem_bytes: int         # dynamic shared memory a block asks for


def key_tile(dk: int, dv: int) -> int:
    """Keys a K or V tile of the bf16 kernel at head dims (dk, dv): S's N,
    the tiles of the online softmax (``ref.attention_bf16_scheme``'s ``bk``).
    A consumer thread holds S (key_tile / 2 floats), P's two bf16 parts
    (key_tile / 2 registers) and O (32 a 64-column panel of v): 128 keys,
    or 64 where v takes two panels (dv > 64)."""
    head_dims_known(dk, dv)
    return 64 if dv > 64 else 128


def launch_plan(B: int, Sq: int, Hq: int, dk: int, dv: int) -> FlashPlan:
    """The bf16 kernel's launch at q (B, Sq, Hq, dk) and v's head dim dv,
    as csrc/flash_attention.cu's ``flash_attention_fwd_plan`` and launch
    compute it: shared memory holds Q's two 64-row boxes, then STAGES K
    tiles and STAGES V tiles, each 64-column panel of a tile key_tile rows
    of 128 bytes (head dims 120 and 96 take two panels), the mbarriers, and
    1024 bytes to align the base."""
    bk = key_tile(dk, dv)
    npk, npv = -(-dk // 64), -(-dv // 64)
    smem = 2 * npk * _BOX + STAGES * (npk + npv) * bk * 128 + (1 + 4 * STAGES) * 8 + 1024
    return FlashPlan((B * Hq, -(-Sq // BLOCK_Q)), BLOCK_Q, bk, STAGES, smem)


def device_plan(dk: int, dv: int) -> tuple[int, int, int, int]:
    """(block_q, key_tile, stages, smem_bytes) as the built library computes
    them (``flash_attention_fwd_plan``); needs the card's toolchain."""
    head_dims_known(dk, dv)
    out = (ctypes.c_int * 4)()
    fn = build.function("flash_attention", "flash_attention_fwd_plan",
                        (ctypes.c_int, ctypes.c_int, ctypes.c_void_p))
    build.check(fn(dk, dv, ctypes.addressof(out)), "flash_attention_fwd_plan")
    return tuple(out)


def head_dims_known(dk: int, dv: int) -> None:
    """Raise unless the bf16 kernel is instantiated at (dk, dv)."""
    if (dk, dv) not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dims (k {dk}, v {dv}) not in {HEAD_DIMS}")


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
    if (DK, v.shape[-1]) not in HEAD_DIMS and not (
            q.dtype == torch.float32 and (DK, v.shape[-1]) in F32_HEAD_DIMS):
        raise ValueError(f"flash_attention: head dims (k {DK}, v {v.shape[-1]}) not in "
                         f"{HEAD_DIMS} (nor, in f32, {F32_HEAD_DIMS})")
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
