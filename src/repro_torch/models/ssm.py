"""Mamba-2-style selective SSM block (port of ``repro.models.ssm``): hymba's
parallel SSM head and the generic ``mamba`` block kind.

Per block: in-projections -> short causal depthwise conv -> SiLU -> selective
scan (chunked SSD; ``csrc/ssm_scan.cu`` on the card, its gradient
``csrc/ssm_scan_bwd.cu``) -> gated RMSNorm -> out-projection.  Decode
carries (conv_state, ssm_state) instead of a KV cache.  ``dt_bias``, ``A_log`` and ``D`` stay f32 in every config, as in the
reference, so under bf16 the scan receives x and c in bf16 and a and b in
f32 (``b * dt`` promotes).

Under the active mesh, on DTensors: the in-projections are column-parallel
on ``model`` (d_inner, and with it the heads, where ``model`` divides them),
the scan runs on each rank's batch and heads (``ops.ssd_scan``; where the
heads share a factor with ``model`` and no state is kept, in the
reference's head groups, its output then cut by features), the gated
norm over the whole d_inner of each rank's rows, and the out-projection
row-parallel with one all-reduce.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels import ops
from ..parallel import sharding
from .common import dense_init, rmsnorm


def _dims(cfg: ModelConfig) -> tuple[int, int, int, int]:
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = max(1, d_inner // 64)          # P = 64 per SSM head
    p = d_inner // n_heads
    return d_inner, n_heads, p, s.d_state


def ssm_init(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype) -> dict:
    s = cfg.ssm
    d = cfg.d_model
    d_inner, nh, _, n = _dims(cfg)
    dev = gen.device
    return {
        "w_x": dense_init(gen, d, (d, d_inner), dtype),
        "w_z": dense_init(gen, d, (d, d_inner), dtype),
        "w_bc": dense_init(gen, d, (d, 2 * nh * n), dtype),
        "w_dt": dense_init(gen, d, (d, nh), dtype),
        "dt_bias": torch.zeros(nh, dtype=torch.float32, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, dtype=torch.float32, device=dev)),
        "D": torch.ones(nh, dtype=torch.float32, device=dev),
        "conv": dense_init(gen, s.conv_kernel, (s.conv_kernel, d_inner), dtype),
        "norm": {"scale": torch.ones(d_inner, dtype=dtype, device=dev)},
        "w_out": dense_init(gen, d_inner, (d_inner, d), dtype),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, state: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv over time.  x: (B, S, D); w: (K, D); state:
    (B, K-1, D) trailing context (decode).  Returns (y, new_state).

    The sum of K shifted products is taken in the reference's order, each
    partial sum rounded to x's dtype (``F.conv1d`` would accumulate in f32
    and differ in bf16)."""
    K = w.shape[0]
    if state is None:
        state = sharding.replicated_like(
            torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype, device=x.device), x)
    xp = torch.cat([state, x], dim=1)
    y = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(K))
    # a copy: a view would keep the whole padded prompt alive in the cache
    new_state = xp[:, -(K - 1):].clone() if K > 1 else state
    return y, new_state


def _ssm_core(p: dict, cfg: ModelConfig, x: torch.Tensor, conv_state: torch.Tensor | None,
              ssm_state: torch.Tensor | None, plain: bool, with_state: bool = True
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """Shared by the forward (``with_state`` False: no scan state kept),
    prefill (states None) and decode (states carried)."""
    B, S, _ = x.shape
    d_inner, nh, ph, n = _dims(cfg)
    w = {k: sharding.gathered(p[k]) for k in ("w_x", "w_z", "w_bc", "w_dt", "w_out")}
    xs, conv_state_new = _causal_conv(x @ w["w_x"], p["conv"], conv_state)
    xs = F.silu(xs)
    z = x @ w["w_z"]

    bc = sharding.heads_whole(x @ w["w_bc"], nh)
    b, c = torch.split(bc.reshape(B, S, nh, 2 * n), n, dim=-1)
    # jax.nn.softplus is logaddexp(x, 0); F.softplus turns linear above 20.
    dt_ = torch.logaddexp((x @ w["w_dt"]).float() + p["dt_bias"],
                          torch.zeros((), device=x.device))        # (B, S, nh) f32
    a = torch.exp(-dt_ * torch.exp(p["A_log"]))                     # decay in (0, 1)
    xh = sharding.heads_whole(xs, nh).reshape(B, S, nh, ph)
    b = b * dt_[..., None]                                          # dt-weighted input, f32
    y, ssm_state_new = ops.ssd_scan(xh, a, b, c, h0=ssm_state, chunk=cfg.ssm.chunk,
                                    plain=plain, with_state=with_state, skip=p["D"])
    y = y.reshape(B, S, d_inner)
    y = rmsnorm(y, p["norm"]["scale"], cfg.norm_eps, plain=plain) * F.silu(z)
    return sharding.batch_layout(y @ w["w_out"]), conv_state_new, ssm_state_new


def ssm_apply(p: dict, cfg: ModelConfig, x: torch.Tensor, *, plain: bool = False
              ) -> torch.Tensor:
    return _ssm_core(p, cfg, x, None, None, plain, with_state=False)[0]


def ssm_prefill(p: dict, cfg: ModelConfig, x: torch.Tensor, *, plain: bool = False
                ) -> tuple[torch.Tensor, tuple]:
    """Returns (y, (conv_state, ssm_state)) so decode can continue."""
    y, cs, hs = _ssm_core(p, cfg, x, None, None, plain)
    return y, (cs, hs)


def ssm_decode(p: dict, cfg: ModelConfig, x: torch.Tensor, cache: tuple, *,
               plain: bool = False) -> tuple[torch.Tensor, tuple]:
    """x: (B, 1, d); cache: (conv_state, ssm_state).  Returns (y, new cache)."""
    y, cs, hs = _ssm_core(p, cfg, x, *cache, plain)
    return y, (cs, hs)


def ssm_cache_shape(cfg: ModelConfig, batch: int, dtype: torch.dtype
                    ) -> tuple[tuple[tuple[int, ...], torch.dtype], ...]:
    """((conv shape, dtype), (ssm shape, dtype)): the conv context in the
    compute dtype, the scan state in f32."""
    d_inner, nh, ph, n = _dims(cfg)
    return (((batch, cfg.ssm.conv_kernel - 1, d_inner), dtype),
            ((batch, nh, ph, n), torch.float32))
