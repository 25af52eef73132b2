"""Plain PyTorch versions of the hand-written kernels (port of
``repro.kernels.ref``).

These are the semantics of record for the port: the CPU path runs them, and
each CUDA kernel is held against them on the card.  Conventions kept from the
reference: masks use -1e30 (not -inf), math is f32 with a cast back to the
input dtype, and query head h reads KV head ``h // g``.  ``ssd_scan`` is the
sequential oracle of the SSD scan; the plain version the CPU path runs is
``chunked.ssd_scan_chunked``.  The ``*_bf16_scheme`` functions are the
arithmetic of a kernel's bf16 tensor-core path, in f32, to hold that kernel
to within its output rounding.
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


def _split_bf16(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """A bf16 high part and the bf16 of the remainder, both as f32."""
    hi = t.bfloat16().float()
    return hi, (t - hi).bfloat16().float()


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
        hi, lo = _split_bf16(p)
        acc = acc * alpha[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", hi + lo, vf[:, k0:k0 + bk])
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


def ssd_scan_bf16_scheme(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                         h0: torch.Tensor | None = None, *, chunk: int = 256, tile: int = 64
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """The SSD scan in the arithmetic of the kernel's bf16-x path (the output
    pass on the tensor cores), in f32.  As ``chunked.ssd_scan_chunked``
    (chunk states and the carry in f32), except that each product of the
    output pass takes bf16 operands: an f32 operand is a bf16 high part plus
    the bf16 of its remainder, and the low-by-low product is dropped:
    C.B^T = C_hi B_hi + C_hi B_lo + C_lo B_hi, the inter-chunk C.h likewise
    with the chunk's start state, and the gate G (f32) times X as
    (G_hi + G_lo) X.  The output pass works in tiles of ``tile`` steps.  On
    a t row's own tile the gate is (C.B^T) exp(cum_t - cum_s).  For an
    earlier s tile the decay goes through that tile's last step r: B's row
    is first scaled by exp(cum_r - cum_s), then split, and the product is
    scaled by exp(cum_t - cum_r).  Returns y in f32, before the kernel's one
    rounding to x's dtype, and h_final (f32)."""
    B, S, H, P = x.shape
    N = b.shape[-1]
    Q = min(chunk, S)
    xf, af, bf, cf = (t.float() for t in (x, a, b, c))
    pad = -S % Q
    if pad:  # a = 1 and zeros past S: what a chunk that ends at S computes
        xf, bf, cf = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad)) for t in (xf, bf, cf))
        af = torch.nn.functional.pad(af, (0, 0, 0, pad), value=1.0)
    G = xf.shape[1] // Q
    xf, bf, cf = (t.reshape(B, G, Q, H, -1) for t in (xf, bf, cf))
    cum = torch.cumsum(torch.log(torch.clamp(af, min=1e-37)).reshape(B, G, Q, H), dim=2)
    total = cum[:, :, -1]
    w = torch.exp(total[:, :, None] - cum)
    h_in = torch.einsum("bgqh,bgqhn,bgqhp->bghpn", w, bf, xf)
    h = (torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device) if h0 is None
         else h0.float())
    starts = []
    for g in range(G):
        starts.append(h)
        h = h * torch.exp(total[:, g])[..., None, None] + h_in[:, g]

    def dots(bv):  # C.B^T of split operands: (B,G,t,s,H)
        (c_hi, c_lo), (b_hi, b_lo) = _split_bf16(cf), _split_bf16(bv)
        return sum(torch.einsum("bgthn,bgshn->bgtsh", u, v)
                   for u, v in ((c_hi, b_hi), (c_hi, b_lo), (c_lo, b_hi)))

    i = torch.arange(Q, device=x.device)
    same = (i[:, None] // tile == i[None, :] // tile) & (i[None, :] <= i[:, None])
    earlier = i[:, None] // tile > i[None, :] // tile
    ref_s = cum[:, :, torch.clamp((i // tile + 1) * tile - 1, max=Q - 1)]  # cum_r for each s
    gate = dots(bf) * torch.exp((cum[:, :, :, None] - cum[:, :, None, :]).masked_fill(
        ~same[None, None, :, :, None], float("-inf")))
    gate = gate + dots(bf * torch.exp(ref_s - cum)[..., None]) * torch.exp(
        (cum[:, :, :, None] - ref_s[:, :, None, :]).masked_fill(
            ~earlier[None, None, :, :, None], float("-inf")))
    g_hi, g_lo = _split_bf16(gate)
    (c_hi, c_lo), (h_hi, h_lo) = _split_bf16(cf), _split_bf16(torch.stack(starts, dim=1))
    y = (torch.einsum("bgtsh,bgshp->bgthp", g_hi, xf) + torch.einsum("bgtsh,bgshp->bgthp", g_lo, xf)
         + sum(torch.einsum("bgthn,bghpn->bgthp", u, v)
               for u, v in ((c_hi, h_hi), (c_hi, h_lo), (c_lo, h_hi))) * torch.exp(cum)[..., None])
    return y.reshape(B, -1, H, P)[:, :S], h
