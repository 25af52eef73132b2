"""Decode attention (split-K flash-decode): the hand-written CUDA kernels
``csrc/decode_attention.cu`` and their wrapper.

Replaces the Pallas TPU kernel
``repro/kernels/decode_attention.py::decode_attention``.  Bound on the card by
bytes (the valid part of the cache is read once).  The cache is split along
its slots across a grid of (B*Hkv, splits) blocks that stream K and V with
16-byte loads and write partial softmax sums; a second kernel, launched by
the same C entry point, combines them.  The number of splits comes from the
host alone (``num_splits``): the device lengths are never read back.  See the
source note in the ``.cu`` file.  The K head dim and the V head dim may
differ (MLA: 96 and 64), a row need not split evenly over a slot's lanes
(120: ``lane_split``), and the caches are read through their strides, so
MLA's v stays a slice of its re-expanded latent: a contiguous copy would move
about 22 MB a layer a step at B 4, 1089 slots, about as much again as the
kernel reads.

A CPU tensor goes to the plain version (``ref.decode_attention``); a CUDA
tensor launches the kernels or raises.  A meta tensor takes the CUDA
branch's checks, plan (on ``cost.H100_SMS`` SMs), output and workspace
without a launch, and gives its work to the trace that is recording
(``cost.record``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import build, cost
from .ref import decode_attention as plain

# (K head dim, V head dim) pairs (csrc: dispatch_d): the GQA models' (120:
# h2o-danube3, 96: phi3-vision) and MLA's.
HEAD_DIMS = ((32, 32), (64, 64), (128, 128), (120, 120), (96, 96), (96, 64))
# and in f32 only: the reduced configs' heads of 16
F32_HEAD_DIMS = ((16, 16),)
MAX_GROUP = 8      # query heads per KV head (csrc: kMaxGroup)
GROUPS = (1, 2, 4, 5, 8)  # csrc: dispatch_g's instantiations; g is rounded up to one
MAX_HELD = 96      # floats of q and acc a lane may hold (csrc: kMaxHeld)
MIN_SPLIT = 64     # slots: no split is shorter when the length allows
BLOCKS_PER_SM = 4  # the grid's target: four blocks per SM
# q, k_cache, v_cache, lens, len_all, o, part, ml, B, Hq, Hkv, Smax, DK, DV,
# splits, chunk, (b, s, h) strides of k_cache and v_cache, scale, dtype, stream
_ARGTYPES = ((ctypes.c_void_p,) * 4 + (ctypes.c_int,) + (ctypes.c_void_p,) * 3
             + (ctypes.c_int,) * 8 + (ctypes.c_longlong,) * 6
             + (ctypes.c_float, ctypes.c_int, ctypes.c_void_p))


class LaneSplit(NamedTuple):
    lanes: int    # lanes that read one slot's K and V rows (a power of two, <= 32)
    k_chunks: int  # 16-byte chunks of the K row a lane holds (the last may be off)
    v_chunks: int  # of the V row
    held: int     # floats of q and acc a lane holds over the group's rows


def lane_split(dk: int, dv: int, elem_bytes: int, g: int) -> LaneSplit:
    """How ``decode_split_kernel`` cuts a slot's rows over lanes at head dims
    (dk, dv), ``elem_bytes`` an element and a group of ``g`` query heads
    (rounded up to its instantiation): csrc's ``lanes_per_slot``, mirrored.
    The lanes are the largest power of two dividing both rows' chunk
    counts, unless a lane would then hold more than ``MAX_HELD`` floats of
    q and acc; then the power of two at or above the longer row's chunks
    (at most 32), each lane taking one chunk and the lanes past a row's end
    none: a row of 120 bf16 is 15 chunks over 16 lanes."""
    nv = 16 // elem_bytes
    ck, cv = dk // nv, dv // nv
    G = next(x for x in GROUPS if x >= g)
    p = 1
    while p < 32 and ck % (2 * p) == 0 and cv % (2 * p) == 0:
        p *= 2
    if G * (ck + cv) // p * nv > MAX_HELD:
        p = 1
        while p < 32 and p < max(ck, cv):
            p *= 2
    kpl, vpl = -(-ck // p), -(-cv // p)
    return LaneSplit(p, kpl, vpl, G * (kpl + vpl) * nv)


def num_splits(bh: int, length: int, n_sm: int) -> int:
    """Splits of the cache for ``bh`` = B*Hkv sequence-heads of ``length``
    slots: enough for the grid to fill ``n_sm`` SMs four times over (a block's
    chain of dependent loads, not the bytes, sets the time of a short cache),
    but no split shorter than ``MIN_SPLIT`` slots (one split if the length is
    shorter than that)."""
    want = -(-BLOCKS_PER_SM * n_sm // max(bh, 1))
    return max(1, min(want, length // MIN_SPLIT))


def split_plan(B: int, Hkv: int, Smax: int, cache_len: torch.Tensor | int,
               n_sm: int) -> tuple[int, int]:
    """(splits, chunk) for a launch: split s covers slots [s*chunk,
    (s+1)*chunk).  An int length sizes the splits by the slots that are
    valid (all Smax when none is: then every slot counts); a tensor of
    lengths lives on the device and is not read here, so the splits cover
    Smax and a split past a sequence's length contributes nothing."""
    n = Smax
    if not isinstance(cache_len, torch.Tensor) and 0 < int(cache_len) < Smax:
        n = int(cache_len)
    chunk = -(-n // num_splits(B * Hkv, n, n_sm))
    return -(-n // chunk), chunk  # no split starts past n


def head_dims(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor
              ) -> tuple[int, int]:
    """(DK, DV) of q (B,Hq,DK), k_cache (B,Smax,Hkv,DK) and v_cache
    (B,Smax,Hkv,DV), or a ValueError where the shapes do not fit together, the
    kernel has no instantiation for the pair, or the group exceeds
    ``MAX_GROUP``."""
    if q.dim() != 3 or k_cache.dim() != 4 or v_cache.dim() != 4 \
            or k_cache.shape[:3] != v_cache.shape[:3]:
        raise ValueError(f"decode_attention: shapes q {tuple(q.shape)}, "
                         f"caches {tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    B, Hq, DK = q.shape
    _, Smax, Hkv, Dk = k_cache.shape
    if k_cache.shape[0] != B or Dk != DK or Hkv == 0 or Hq % Hkv or Smax == 0:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} does not fit "
                         f"cache {tuple(k_cache.shape)}")
    DV = v_cache.shape[-1]
    f32_only = q.dtype == torch.float32 and (DK, DV) in F32_HEAD_DIMS
    if ((DK, DV) not in HEAD_DIMS and not f32_only) or Hq // Hkv > MAX_GROUP:
        raise ValueError(f"decode_attention: head dims (k {DK}, v {DV}) (in {HEAD_DIMS}; "
                         f"in f32 also {F32_HEAD_DIMS}) or "
                         f"group {Hq // Hkv} exceeds the kernel's {MAX_GROUP} query heads "
                         "per KV head")
    return DK, DV


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     cache_len: torch.Tensor | int, *, window: int | None = None,
                     scale: float | None = None, return_ml: bool = False):
    """q: (B,Hq,DK); k_cache: (B,Smax,Hkv,DK); v_cache: (B,Smax,Hkv,DV);
    cache_len: valid slots, an int or a (B,) tensor -> (B,Hq,DV) in q's
    dtype, (DK, DV) one of ``HEAD_DIMS``.  ``window`` is accepted and
    unused, as in the reference: validity is by slot.  q must be contiguous;
    the caches may have any (batch, slot, head) strides that are multiples
    of 16 bytes, the head dim contiguous.

    ``return_ml`` also returns each row's logit max m and sum l (B, Hq) f32,
    as the plain version gives them: the combine kernel's own M (in natural
    units) and denominator, which it then writes out, with which outputs over
    disjoint slices of a cache merge."""
    build.refuse_dtensor("decode_attention", q, k_cache, v_cache, cache_len)
    if q.device.type == "cpu":
        return plain(q, k_cache, v_cache, cache_len, window=window, scale=scale,
                     return_ml=return_ml)
    dev = q.device
    if dev.type not in ("cuda", "meta") or k_cache.device != dev or v_cache.device != dev:
        raise ValueError(f"decode_attention: q {dev}, caches {k_cache.device}, "
                         f"{v_cache.device}")
    build.refuse_grad("decode_attention", "it serves decode steps only, and no slice of the "
                      "port plans a backward for it", q, k_cache, v_cache)
    DK, DV = head_dims(q, k_cache, v_cache)
    B, Hq, _ = q.shape
    _, Smax, Hkv, _ = k_cache.shape
    if not (q.dtype == k_cache.dtype == v_cache.dtype):
        raise ValueError(f"decode_attention: dtypes {q.dtype}, {k_cache.dtype}, "
                         f"{v_cache.dtype}")
    if not q.is_contiguous() or k_cache.stride(-1) != 1 or v_cache.stride(-1) != 1:
        raise ValueError("decode_attention: q must be contiguous and the caches' head dim "
                         "contiguous")
    per16 = 16 // q.element_size()
    if any(t.data_ptr() % 16 for t in (q, k_cache, v_cache)) or any(
            st % per16 for t in (k_cache, v_cache) for st in t.stride()[:3]):
        raise ValueError("decode_attention: q and caches must be 16-byte aligned, and the "
                         "caches' (batch, slot, head) strides multiples of 16 bytes")
    if isinstance(cache_len, torch.Tensor):
        lens = cache_len.to(device=dev, dtype=torch.int32).broadcast_to((B,)).contiguous()
        lens_ptr, len_all = lens.data_ptr(), 0
    else:  # one length for the batch, passed by value: no tensor, no fill
        lens_ptr, len_all = None, max(min(int(cache_len), Smax), 0)
    n_sm = cost.H100_SMS if dev.type == "meta" else _sm_count(dev.index or 0)
    splits, chunk = split_plan(B, Hkv, Smax, cache_len, n_sm)
    scale = scale if scale is not None else DK ** -0.5
    o = torch.empty((B, Hq, DV), dtype=q.dtype, device=dev)
    part = torch.empty(B * Hq * splits * (DV + 2), dtype=torch.float32, device=dev)
    ml = torch.empty((B, Hq, 2), dtype=torch.float32, device=dev) if return_ml else None
    if dev.type == "meta":
        valid = Smax if isinstance(cache_len, torch.Tensor) else len_all
        cost.record("decode_attention", cost.decode_attention(
            B, Hq, Hkv, DK, DV, valid, q.element_size()))
        return (o, ml[..., 0], ml[..., 1]) if return_ml else o
    kernel = build.function("decode_attention", "decode_attention_fwd", _ARGTYPES)
    rc = kernel(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lens_ptr, len_all,
                o.data_ptr(), part.data_ptr(), None if ml is None else ml.data_ptr(),
                B, Hq, Hkv, Smax, DK, DV, splits, chunk,
                *k_cache.stride()[:3], *v_cache.stride()[:3], float(scale),
                build.dtype_code(q), build.stream_of(q))
    build.check(rc, "decode_attention")
    decode_attention.n_launches += 1
    decode_attention.last_grid = (B * Hkv, splits)  # the split kernel's grid, as launched
    return (o, ml[..., 0], ml[..., 1]) if return_ml else o


decode_attention.n_launches = 0
decode_attention.last_grid = None
