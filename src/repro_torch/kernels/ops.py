"""Dispatch for the perf-critical ops (port of ``repro.kernels.ops``).

A tensor's device picks the path: a CPU tensor runs the plain PyTorch
version (``ref.py``; ``chunked.py`` for the SSD scan), a CUDA tensor launches
the hand-written kernel or the call raises.  There is no environment override
and no fallback.  ``plain=True`` runs the plain version on any device; only
the parity checks (the tests and ``chip_smoke.py``) pass it, to hold the
kernel path against the plain one.
"""

from __future__ import annotations

import torch

from . import ref
from .chunked import mlstm_chunked, ssd_scan_chunked
from .decode_attention import decode_attention as _decode_attention
from .flash_attention import flash_attention as _flash_attention
from .rmsnorm import rmsnorm as _rmsnorm
from .ssm_scan import ssd_scan as _ssd_scan


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
              window: int | None = None, scale: float | None = None,
              kv_offset: int = 0, plain: bool = False) -> torch.Tensor:
    fn = ref.attention if plain else _flash_attention
    return fn(q, k, v, causal=causal, window=window, scale=scale, kv_offset=kv_offset)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     cache_len: torch.Tensor | int, *, window: int | None = None,
                     scale: float | None = None, plain: bool = False) -> torch.Tensor:
    fn = ref.decode_attention if plain else _decode_attention
    return fn(q, k_cache, v_cache, cache_len, window=window, scale=scale)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5, *,
            plain: bool = False) -> torch.Tensor:
    return (ref.rmsnorm if plain else _rmsnorm)(x, scale, eps)


def ssd_scan(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
             h0: torch.Tensor | None = None, *, chunk: int = 256,
             plain: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    return (ssd_scan_chunked if plain else _ssd_scan)(x, a, b, c, h0, chunk=chunk)


def mlstm_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, i_gate: torch.Tensor,
               f_gate: torch.Tensor, *, chunk: int = 256
               ) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    # mLSTM rides on the chunked SSD form on every device, as in the reference
    return mlstm_chunked(q, k, v, i_gate, f_gate, chunk=chunk)
