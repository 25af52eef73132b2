"""Plain PyTorch versions of the hand-written kernels (port of
``repro.kernels.ref``).

These are the semantics of record for the port: the CPU path runs them, and
each CUDA kernel is held against them on the card.  Conventions kept from the
reference: masks use -1e30 (not -inf), math is f32 with a cast back to the
input dtype, and query head h reads KV head ``h // g``.  ``ssd_scan`` is the
sequential oracle of the SSD scan; the plain version the CPU path runs is
``chunked.ssd_scan_chunked``.
"""

from __future__ import annotations

import torch

_NEG_INF = -1e30
_LOG2E = 1.4426950408889634


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * scale.float()).to(x.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int | None = None,
              scale: float | None = None, kv_offset: int = 0) -> torch.Tensor:
    """Full attention with GQA head broadcast.

    q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D) with Hq % Hkv == 0.
    ``kv_offset``: absolute position of q[0] minus that of k[0].
    window: sliding-window size (attend to positions in (i-window, i]).
    The reference routes long sliding-window inputs to a banded form that
    equals this masked form on the band; the port keeps the masked form.
    """
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, _ = k.shape
    g = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    qf = q.float().mul(scale).reshape(B, Sq, Hkv, g, D)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float())
    q_pos = torch.arange(Sq, device=q.device)[:, None] + kv_offset
    k_pos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    logits = logits.masked_fill(~mask, _NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(B, Sq, Hq, v.shape[-1]).to(q.dtype)


def attention_bf16_scheme(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, window: int | None = None,
                          kv_offset: int = 0, bk: int = 64) -> torch.Tensor:
    """``attention`` in the arithmetic of the flash kernel's bf16 path, in
    f32: Q.K^T of the operands accumulated in f32, the scale (times log2 e)
    applied to S in f32, an online softmax over ``bk``-key tiles with l
    summed from the f32 p, and P split into a bf16 high part and the bf16 of
    its remainder for P.V.  Returns f32, before the kernel's one rounding of
    the output to bf16, so the kernel can be held to it within that rounding.
    """
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, _ = k.shape
    g = Hq // Hkv
    qf = q.float().reshape(B, Sq, Hkv, g, D)
    kf, vf = k.float(), v.float()
    q_pos = torch.arange(Sq, device=q.device)[:, None] + kv_offset
    k_pos = torch.arange(Skv, device=q.device)[None, :]
    valid = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        valid &= k_pos <= q_pos
    if window is not None:
        valid &= k_pos > q_pos - window
    m = torch.full((B, Hkv, g, Sq), _NEG_INF, device=q.device)
    l = torch.zeros((B, Hkv, g, Sq), device=q.device)
    acc = torch.zeros((B, Hkv, g, Sq, D), device=q.device)
    for k0 in range(0, Skv, bk):
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf[:, k0:k0 + bk]) * (D ** -0.5 * _LOG2E)
        s = s.masked_fill(~valid[:, k0:k0 + bk], _NEG_INF)
        mx = torch.maximum(m, s.amax(-1))
        alpha, p = torch.exp2(m - mx), torch.exp2(s - mx[..., None])
        l = l * alpha + p.sum(-1)
        hi = p.bfloat16().float()
        acc = acc * alpha[..., None] + torch.einsum(
            "bhgqk,bkhd->bhgqd", hi + (p - hi).bfloat16().float(), vf[:, k0:k0 + bk])
        m = mx
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, D)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     cache_len: torch.Tensor | int, *, window: int | None = None,
                     scale: float | None = None) -> torch.Tensor:
    """Single-token attention over a (possibly ring-buffered) KV cache.

    q: (B, Hq, D); caches: (B, Smax, Hkv, D); cache_len: number of valid
    slots (scalar or (B,)).  Validity is by slot, so ring order does not
    matter; ``window`` is accepted and unused, as in the reference.
    """
    B, Hq, D = q.shape
    _, Smax, Hkv, _ = k_cache.shape
    g = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    qf = q.float().mul(scale).reshape(B, Hkv, g, D)
    logits = torch.einsum("bhgd,bkhd->bhgk", qf, k_cache.float())
    lens = torch.as_tensor(cache_len, device=q.device).broadcast_to((B,))
    valid = (torch.arange(Smax, device=q.device)[None, :]
             < torch.clamp(lens, max=Smax)[:, None])
    logits = logits.masked_fill(~valid[:, None, None, :], _NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float())
    return out.reshape(B, Hq, v_cache.shape[-1]).to(q.dtype)


def ssd_scan(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
             h0: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Selective-state-space scan (Mamba-2 SSD form), one step at a time.

    Recurrence per head: h_t = a_t * h_{t-1} + x_t ⊗ b_t;  y_t = h_t @ c_t.
      x: (B, S, H, P); a: (B, S, H) decay in (0, 1); b, c: (B, S, H, N);
      h0: (B, H, P, N) initial state (zeros if None).
    Returns y (B, S, H, P) in x's dtype and the final state (B, H, P, N) in f32.
    """
    B, S, H, P = x.shape
    N = b.shape[-1]
    xf, af, bf, cf = (t.float() for t in (x, a, b, c))
    h = (torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device) if h0 is None
         else h0.float())
    ys = []
    for t in range(S):
        h = h * af[:, t, :, None, None] + xf[:, t, :, :, None] * bf[:, t, :, None, :]
        ys.append(torch.einsum("bhpn,bhn->bhp", h, cf[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype), h
