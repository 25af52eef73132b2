"""Shared building blocks (port of ``repro.models.common``): init helper,
RMSNorm, RoPE, SwiGLU MLP.  Weights keep the reference's (in, out) layout, so
a projection is ``x @ w``.  Each takes DTensors under the active mesh too
(``parallel.sharding``): the norm through its kernel on each rank's rows,
the MLP with its weights gathered over the data axes (column-parallel in,
row-parallel out, one all-reduce over ``model``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import ops
from ..parallel import sharding


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


def dense_init(gen: torch.Generator, fan_in: int, shape: tuple[int, ...],
               dtype: torch.dtype) -> torch.Tensor:
    """Normal(0, 1) * fan_in^-0.5, drawn in f32 on ``gen``'s device."""
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
    return (w * fan_in ** -0.5).to(dtype)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float, *,
            plain: bool = False) -> torch.Tensor:
    return ops.rmsnorm(x, scale, eps, plain=plain)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding in the half-split layout (``x[..., :half]`` pairs with
    ``x[..., half:]``), computed in f32 and cast back.  x: (B, S, H, D);
    positions: (S,)."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = positions.to(torch.float32)[:, None] * freqs            # (S, half)
    cos, sin = (sharding.replicated_like(t(ang)[:, None, :], x)    # (S, 1, half)
                for t in (torch.cos, torch.sin))
    xf = x.float()
    x1, x2 = xf[..., :half], xf[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


def mlp_init(gen: torch.Generator, d: int, f: int, dtype: torch.dtype) -> dict:
    return {"w_in": dense_init(gen, d, (d, f), dtype),
            "w_gate": dense_init(gen, d, (d, f), dtype),
            "w_out": dense_init(gen, f, (f, d), dtype)}


def mlp_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: (silu(x @ w_gate) * (x @ w_in)) @ w_out."""
    w = {k: sharding.gathered(v) for k, v in p.items()}
    return sharding.batch_layout((F.silu(x @ w["w_gate"]) * (x @ w["w_in"])) @ w["w_out"])
