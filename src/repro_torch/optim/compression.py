"""Gradient compression for the cross-pod all-reduce: int8 quantisation with
error feedback (port of ``repro.optim.compression``).

Quantise (grads + error) per tensor to int8; the residual goes back into the
error buffer.  Enabled by ``TrainConfig.grad_compression``.
"""

from __future__ import annotations

from typing import Any

import torch

from .adamw import tree_leaves, tree_map, tree_unflatten


def quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8.  Returns (q, scale)."""
    amax = x.abs().max().float()
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x.float() / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def compress_with_feedback(grads: Any, error: Any) -> tuple[Any, Any]:
    """Quantise (grads + error); returns (dequantised grads in each grad's
    dtype, new error in f32)."""
    out = []
    for g, e in zip(tree_leaves(grads), tree_leaves(error)):
        target = g.float() + e
        deq = dequantize(*quantize(target))
        out.append((deq.to(g.dtype), target - deq))
    return (tree_unflatten(grads, [o[0] for o in out]),
            tree_unflatten(grads, [o[1] for o in out]))


def init_error(params: Any) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                    params)
