"""Decode attention (split-K flash-decode): the hand-written CUDA kernels
``csrc/decode_attention.cu`` and their wrapper.

Replaces the Pallas TPU kernel
``repro/kernels/decode_attention.py::decode_attention``.  Bound on the card by
bytes (the valid part of the cache is read once).  The cache is split along
its slots across a grid of (B*Hkv, splits) blocks that stream K and V with
16-byte loads and write partial softmax sums; a second kernel, launched by
the same C entry point, combines them.  The number of splits comes from the
host alone (``num_splits``): the device lengths are never read back.  See the
source note in the ``.cu`` file.

A CPU tensor goes to the plain version (``ref.decode_attention``); a CUDA
tensor launches the kernels or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .ref import decode_attention as plain

HEAD_DIMS = (32, 64, 128)
MAX_GROUP = 8      # query heads per KV head (csrc: kMaxGroup)
MIN_SPLIT = 64     # slots: no split is shorter when the length allows
BLOCKS_PER_SM = 4  # the grid's target: four blocks per SM
# q, k_cache, v_cache, lens, len_all, o, part, B, Hq, Hkv, Smax, D, splits,
# chunk, scale, dtype, stream
_ARGTYPES = ((ctypes.c_void_p,) * 4 + (ctypes.c_int,) + (ctypes.c_void_p,) * 2
             + (ctypes.c_int,) * 7 + (ctypes.c_float, ctypes.c_int, ctypes.c_void_p))


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


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     cache_len: torch.Tensor | int, *, window: int | None = None,
                     scale: float | None = None) -> torch.Tensor:
    """q: (B,Hq,D); caches: (B,Smax,Hkv,D); cache_len: valid slots, an int
    or a (B,) tensor -> (B,Hq,D) in q's dtype.  ``window`` is accepted and
    unused, as in the reference: validity is by slot."""
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
    if D not in HEAD_DIMS or Hq // Hkv > MAX_GROUP:
        raise ValueError(f"decode_attention: head dim {D} (in {HEAD_DIMS}) or group "
                         f"{Hq // Hkv} exceeds the kernel's {MAX_GROUP} query heads per KV head")
    if not (q.dtype == k_cache.dtype == v_cache.dtype):
        raise ValueError(f"decode_attention: dtypes {q.dtype}, {k_cache.dtype}, "
                         f"{v_cache.dtype}")
    if not (q.is_contiguous() and k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError("decode_attention: q and caches must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k_cache, v_cache)):
        raise ValueError("decode_attention: q and caches must be 16-byte aligned")
    if isinstance(cache_len, torch.Tensor):
        lens = cache_len.to(device=dev, dtype=torch.int32).broadcast_to((B,)).contiguous()
        lens_ptr, len_all = lens.data_ptr(), 0
    else:  # one length for the batch, passed by value: no tensor, no fill
        lens_ptr, len_all = None, max(min(int(cache_len), Smax), 0)
    splits, chunk = split_plan(B, Hkv, Smax, cache_len, _sm_count(dev.index or 0))
    scale = scale if scale is not None else D ** -0.5
    o = torch.empty_like(q)
    part = torch.empty(B * Hq * splits * (D + 2), dtype=torch.float32, device=dev)
    kernel = build.function("decode_attention", "decode_attention_fwd", _ARGTYPES)
    rc = kernel(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lens_ptr, len_all,
                o.data_ptr(), part.data_ptr(), B, Hq, Hkv, Smax, D, splits, chunk, float(scale),
                build.dtype_code(q), build.stream_of(q))
    build.check(rc, "decode_attention")
    decode_attention.n_launches += 1
    decode_attention.last_grid = (B * Hkv, splits)  # the split kernel's grid, as launched
    return o


decode_attention.n_launches = 0
decode_attention.last_grid = None
