"""Plain PyTorch versions of the hand-written kernels (port of
``repro.kernels.ref``).

These are the semantics of record for the port: the CPU path runs them, and
each CUDA kernel is held against them on the card.  Conventions kept from the
reference: masks use -1e30 (not -inf), math is f32 with a cast back to the
input dtype, and query head h reads KV head ``h // g``.  ``ssd_scan`` is the
sequential oracle of the SSD scan; the plain version the CPU path runs is
``chunked.ssd_scan_chunked``.  ``mlstm_scan`` is the sequential, stabilised
mLSTM cell (XLA code in the reference, no kernel; decode runs it a step at
a time).  The ``*_bf16_scheme`` functions are the
arithmetic of a kernel's bf16 tensor-core path, in f32, to hold that kernel
to within its output rounding.  ``attention_lse`` and ``attention_bwd``
are the plain versions of the flash forward's log-sum-exp output and of its
backward kernel (the closed form of ``attention``'s gradient).
``dp_sweep`` is the placement path's
batched min-plus sweep, in f64 and in the numpy oracle's operation order.
"""

from __future__ import annotations

import torch

_NEG_INF = -1e30
_LOG2E = 1.4426950408889634


def _row_shard(qf: torch.Tensor, n_kv: int, group: int, seq_dim: int = 1) -> torch.Tensor:
    """Sequence-parallel attention guard, the reference's: when no head dim
    divides the model axis, q's row dim goes onto ``model`` (each rank's
    flash call then takes ``kv_offset`` advanced by its rows' start), so the
    logits are row-sharded and attention needs no collective of its own.
    Row-sharding q replicates k and v across ``model``, so it is taken only
    when the k/v head volume is modest (``n_kv * d <= 2048``: the reference
    measured MLA's 40 x 96 twice as slow).  ``qf`` (B, S, n_kv, group, d),
    a DTensor under the active mesh; returned as it is elsewhere and where
    a gate refuses."""
    from ..parallel.sharding import active_mesh, mesh_sizes, site
    mesh, axes = active_mesh()
    if mesh is None:
        return qf
    msize = mesh_sizes(mesh)[axes.model]
    if n_kv % msize == 0 or group % msize == 0:
        return qf  # head parallelism already available
    d = qf.shape[-1]
    if n_kv * d > 2048:
        return qf
    names: list[str | None] = [None] * qf.dim()
    names[seq_dim] = "model"
    return site(qf, tuple(names), "row_shard")


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * scale.float()).to(x.dtype)


def rmsnorm_bwd(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor, eps: float = 1e-5
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the RMSNorm backward kernel: autograd through
    :func:`rmsnorm` (as the reference's gradient is XLA's autodiff of its
    ``ref.rmsnorm``).  Returns (dx in x's dtype, dscale in scale's)."""
    with torch.enable_grad():
        xr = x.detach().requires_grad_(True)
        sr = scale.detach().requires_grad_(True)
        dx, dscale = torch.autograd.grad(rmsnorm(xr, sr, eps), (xr, sr), g)
    return dx, dscale


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int | None = None,
              scale: float | None = None, kv_offset: int = 0) -> torch.Tensor:
    """Full attention with GQA head broadcast.

    q: (B, Sq, Hq, D); k: (B, Skv, Hkv, D); v: (B, Skv, Hkv, Dv) with
    Hq % Hkv == 0 (MLA: D 96, Dv 64).  Returns (B, Sq, Hq, Dv).
    ``kv_offset``: absolute position of q[0] minus that of k[0].
    window: sliding-window size (attend to positions in (i-window, i]).
    Causal sliding-window prefill longer than twice the window (Sq == Skv,
    kv_offset 0) goes to :func:`attention_banded`, O(S·window) instead of
    O(S²), as in the reference.
    """
    if (causal and window is not None and kv_offset == 0
            and q.shape[1] == k.shape[1] and q.shape[1] > 2 * window):
        return attention_banded(q, k, v, window=window, scale=scale)
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, _ = k.shape
    g = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    qf = q.float().mul(scale).reshape(B, Sq, Hkv, g, D)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float())
    mask = _attention_mask(Sq, Skv, causal, window, kv_offset, q.device)
    logits = logits.masked_fill(~mask, _NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(B, Sq, Hq, v.shape[-1]).to(q.dtype)


def _attention_mask(sq: int, skv: int, causal: bool, window: int | None, kv_offset: int,
                    device) -> torch.Tensor:
    """(sq, skv) bool: the pairs :func:`attention` keeps."""
    q_pos = torch.arange(sq, device=device)[:, None] + kv_offset
    k_pos = torch.arange(skv, device=device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    return mask


def attention_lse(q: torch.Tensor, k: torch.Tensor, *, causal: bool = True,
                  window: int | None = None, scale: float | None = None,
                  kv_offset: int = 0) -> torch.Tensor:
    """Each row's log-sum-exp of the scaled, masked logits of
    :func:`attention` (masked pairs at -1e30, the sum clamped at 1e-30), f32
    (B, Hq, Sq): what the flash forward kernel writes beside o for its
    backward.  A row with no valid key gets -1e30."""
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, _ = k.shape
    scale = scale if scale is not None else D ** -0.5
    qf = q.float().mul(scale).reshape(B, Sq, Hkv, Hq // Hkv, D)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float())
    mask = _attention_mask(Sq, Skv, causal, window, kv_offset, q.device)
    logits = logits.masked_fill(~mask, _NEG_INF)
    m = logits.amax(dim=-1)
    lse = m + torch.log(torch.exp(logits - m[..., None]).sum(-1).clamp_min(1e-30))
    return lse.reshape(B, Hq, Sq)


def attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                  lse: torch.Tensor, do: torch.Tensor, *, causal: bool = True,
                  window: int | None = None, scale: float | None = None,
                  kv_offset: int = 0) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of the flash backward kernel: the gradients of
    :func:`attention` for an output gradient ``do`` (o's shape), in closed
    form and f32, from the forward's output ``o`` and its ``lse``
    (:func:`attention_lse`).  P = exp(S·scale - lse), D = rowsum(dO∘O),
    dV = Pᵀ dO, dS = P∘(dO Vᵀ - D) on the kept pairs (a masked logit is a
    constant), dQ = scale·dS K, dK = scale·dSᵀ Q, dK and dV summed over
    each KV head's g query heads.  A row with no valid key weighs every key
    1/Skv, as the forward's uniform softmax over -1e30 does.  Returns (dq,
    dk, dv) in q's, k's and v's dtypes.  (The reference's gradient is XLA's
    autodiff of its ``ref.attention``; its Pallas kernel has no VJP.)"""
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, Dv = v.shape
    g = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    qf = q.float().reshape(B, Sq, Hkv, g, D)
    kf, vf = k.float(), v.float()
    dof = do.float().reshape(B, Sq, Hkv, g, Dv)
    mask = _attention_mask(Sq, Skv, causal, window, kv_offset, q.device)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf) * scale
    p = torch.exp(s.masked_fill(~mask, float("-inf"))
                  - lse.float().reshape(B, Hkv, g, Sq)[..., None])
    p = torch.where(mask.any(-1)[:, None], p, 1.0 / Skv)
    dsum = (dof * o.float().reshape(B, Sq, Hkv, g, Dv)).sum(-1).permute(0, 2, 3, 1)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dof, vf)
    ds = torch.where(mask, p * (dp - dsum[..., None]), 0.0)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dof)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kf).mul(scale).reshape(B, Sq, Hq, D)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qf).mul(scale)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def attention_banded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     window: int, scale: float | None = None) -> torch.Tensor:
    """Causal sliding-window attention in O(S·window) (the reference's
    ``attention_banded``): the sequence, zero-padded to whole blocks of
    ``window``, is cut into such blocks, and each query block attends to its
    own block and the one before it, which hold its whole (i-window, i]
    band.  Keys outside the band, and block -1's zeros, are masked to -1e30;
    each row has its own key, so they weigh exactly 0 and the result is the
    masked form's up to summation order.  No :func:`_row_shard` here, as in
    the reference: banded logits are O(S·w), and it measured the q/k/v
    re-shard costing more than it saves."""
    B, S, Hq, D = q.shape
    _, _, Hkv, Dv = v.shape
    g = Hq // Hkv
    w = window
    scale = scale if scale is not None else D ** -0.5
    pad = -S % w
    if pad:
        q, k, v = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
    nc = (S + pad) // w
    qf = q.float().mul(scale).reshape(B, nc, w, Hkv, g, D)
    kc = k.float().reshape(B, nc, w, Hkv, D)
    vc = v.float().reshape(B, nc, w, Hkv, Dv)

    def prev(t):  # block c-1 beside block c; block -1 is zeros
        return torch.cat([torch.zeros_like(t[:, :1]), t[:, :-1]], dim=1)

    kb = torch.cat([prev(kc), kc], dim=2)                      # (B, nc, 2w, Hkv, D)
    vb = torch.cat([prev(vc), vc], dim=2)
    logits = torch.einsum("bcqhgd,bckhd->bchgqk", qf, kb)      # (B, nc, Hkv, g, w, 2w)
    q_pos = torch.arange(w, device=q.device)[:, None] + w      # within-band positions
    k_pos = torch.arange(2 * w, device=q.device)[None, :]
    first = torch.arange(nc, device=q.device)[:, None, None] == 0
    mask = ((k_pos <= q_pos) & (k_pos > q_pos - w))[None] & ~(first & (k_pos < w))
    logits = logits.masked_fill(~mask[None, :, None, None], _NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bchgqk,bckhd->bcqhgd", p, vb)
    return out.reshape(B, nc * w, Hq, Dv)[:, :S].to(q.dtype)


def _split_bf16(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """A bf16 high part and the bf16 of the remainder, both as f32."""
    hi = t.bfloat16().float()
    return hi, (t - hi).bfloat16().float()


def attention_bf16_scheme(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, window: int | None = None,
                          scale: float | None = None, kv_offset: int = 0,
                          bk: int = 64) -> torch.Tensor:
    """``attention`` in the arithmetic of the flash kernel's bf16 path, in
    f32: Q.K^T of the operands accumulated in f32, the scale (times log2 e)
    applied to S in f32, an online softmax over ``bk``-key tiles with l
    summed from the f32 p, and P split into a bf16 high part and the bf16 of
    its remainder for P.V.  v may be narrower than q and k (MLA's 64 against
    96): the output has v's head dim.  Returns f32, before the kernel's one
    rounding of the output to bf16, so the kernel can be held to it within
    that rounding.  A negative ``scale`` is the kernel's sign-flipped Q times
    |scale|: the same products.
    """
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, _ = k.shape
    Dv = v.shape[-1]
    g = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
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
    acc = torch.zeros((B, Hkv, g, Sq, Dv), device=q.device)
    for k0 in range(0, Skv, bk):
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf[:, k0:k0 + bk]) * (scale * _LOG2E)
        s = s.masked_fill(~valid[:, k0:k0 + bk], _NEG_INF)
        mx = torch.maximum(m, s.amax(-1))
        alpha, p = torch.exp2(m - mx), torch.exp2(s - mx[..., None])
        l = l * alpha + p.sum(-1)
        hi, lo = _split_bf16(p)
        acc = acc * alpha[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", hi + lo, vf[:, k0:k0 + bk])
        m = mx
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, Dv)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     cache_len: torch.Tensor | int, *, window: int | None = None,
                     scale: float | None = None, return_ml: bool = False):
    """Single-token attention over a (possibly ring-buffered) KV cache.

    q: (B, Hq, D); k_cache: (B, Smax, Hkv, D); v_cache: (B, Smax, Hkv, Dv);
    cache_len: number of valid slots (scalar or (B,)).  Returns (B, Hq, Dv).
    Validity is by slot, so ring order does not matter; ``window`` is
    accepted and unused, as in the reference.  ``return_ml`` also returns
    each row's logit max m and sum l = sum exp(logit - m), (B, Hq) f32, with
    which the outputs over disjoint slices of one cache merge (decode context
    parallelism).
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
    out = out.reshape(B, Hq, v_cache.shape[-1]).to(q.dtype)
    if not return_ml:
        return out
    m = logits.amax(-1)
    return out, m.reshape(B, Hq), torch.exp(logits - m[..., None]).sum(-1).reshape(B, Hq)


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


def mlstm_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, i_gate: torch.Tensor,
               f_gate: torch.Tensor, c0: torch.Tensor | None = None,
               n0: torch.Tensor | None = None, m0: torch.Tensor | None = None, *,
               rows: slice | None = None, psum=None
               ) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """The mLSTM (xLSTM matrix-memory cell), sequential and stabilised.

    q, k, v: (B, S, H, P); i_gate, f_gate: (B, S, H) pre-activation log
    gates.  C_t = f C_{t-1} + i k v^T; n_t = f n_{t-1} + i k;
    y = C^T q / max(|n^T q|, exp(-m)), with the m-state log-stabiliser of
    the xLSTM paper (m0 defaults to -inf, as in the reference).  Returns y
    (B, S, H, P) in q's dtype and the final (C (B,H,P,P), n (B,H,P),
    m (B,H)) in f32.

    ``rows``: c0 (B, H, R, P) and n0 (B, H, R) hold only those rows of k
    (a rank's slice under a mesh), which the step updates as the whole
    state's; C^T q and n^T q are then partial sums over k, which ``psum``
    (their (B, H, P + 1) concatenation -> its sum over the ranks) completes
    before the normaliser."""
    B, S, H, P = q.shape
    qf, kf, vf, i_f, f_f = (t.float() for t in (q, k, v, i_gate, f_gate))
    scale = P ** -0.5
    dev = q.device
    C = torch.zeros((B, H, P, P), dtype=torch.float32, device=dev) if c0 is None else c0.float()
    n = torch.zeros((B, H, P), dtype=torch.float32, device=dev) if n0 is None else n0.float()
    m = (torch.full((B, H), float("-inf"), dtype=torch.float32, device=dev) if m0 is None
         else m0.float())
    ys = []
    for t in range(S):
        qt, kt, vt, it, ft = qf[:, t], kf[:, t], vf[:, t], i_f[:, t], f_f[:, t]
        logf = torch.nn.functional.logsigmoid(ft)
        m_new = torch.maximum(logf + m, it)
        i_act = torch.exp(it - m_new)
        f_act = torch.exp(logf + m - m_new)
        kt = kt * scale
        if rows is not None:
            kt, qt = kt[..., rows], qt[..., rows]
        C = C * f_act[..., None, None] + i_act[..., None, None] * (
            kt[..., :, None] * vt[..., None, :])
        n = n * f_act[..., None] + i_act[..., None] * kt
        num = torch.einsum("bhpk,bhp->bhk", C, qt)
        dot = torch.einsum("bhp,bhp->bh", n, qt)
        if psum is not None:
            both = psum(torch.cat([num, dot[..., None]], dim=-1))
            num, dot = both[..., :P], both[..., P]
        # clamp at exp(-m): 1.0 in the unstabilised ("true") space
        den = torch.maximum(dot.abs(), torch.exp(-m_new))
        ys.append(num / den[..., None])
        m = m_new
    return torch.stack(ys, dim=1).to(q.dtype), (C, n, m)


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


def ssd_scan_bwd(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                 h0: torch.Tensor | None, dy: torch.Tensor, dh_final: torch.Tensor | None, *,
                 chunk: int = 256) -> tuple[torch.Tensor, ...]:
    """The plain version of the SSD scan's backward kernel: the gradients
    (dx, da, db, dc, dh0) of ``chunked.ssd_scan_chunked(x, a, b, c, h0,
    chunk=chunk)`` for the cotangents ``dy`` of y and ``dh_final`` of the
    final state (None: zero), in closed form and f32, chunk by chunk as the
    forward is.  With cum_t the running log decay within a chunk, W_ts =
    exp(cum_t - cum_s) for s <= t, and each chunk's start state h_s and its
    end state's gradient dh_e:
      dh_start = exp(total) dh_e + sum_t exp(cum_t) dy_t (x) c_t  (the reverse
                 carry, from dh_final; dh0 is the first chunk's),
      dx_s = sum_t (c_t.b_s) W_ts dy_t + exp(total - cum_s) dh_e b_s,
      db_s = sum_t (dy_t.x_s) W_ts c_t + exp(total - cum_s) dh_eᵀ x_s,
      dc_t = sum_s (dy_t.x_s) W_ts b_s + exp(cum_t) h_sᵀ dy_t,
    and the gradient of log a_u within the chunk
      dla_u = sum_{t>=u} dcum_t + sum_{s<u} q_s + exp(total) <dh_e, h_s>,
      dcum_t = (the pairs' row t) - (their column t) + c_t.(dc_t's inter term),
      q_s = b_s.(db_s's injection term),
    divided by a: the total's gradient <dh_e, h_end> spread over the chunk
    with the injection terms it cancels taken out, so a gradient that is
    zero (no state before a step) comes out zero, not rounding noise.  The
    clamp max(a, 1e-37) passes half the gradient at a tie, as
    ``jnp.maximum``'s does.  Returns each gradient in its input's dtype;
    dh0 is None without h0.  (The reference trains the scan through XLA's
    autodiff of its ``chunked.ssd_scan_chunked``; its Pallas kernel has no
    VJP.)"""
    out = _ssd_bwd_closed_form(x, a, b, c, h0, dy, dh_final, chunk, torch.einsum, lambda t: t)
    return tuple(None if g is None else g.to(t.dtype) for g, t in zip(out, (x, a, b, c, h0)))


def ssd_scan_bwd_bf16_scheme(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                             h0: torch.Tensor | None, dy: torch.Tensor,
                             dh_final: torch.Tensor | None, *, chunk: int = 256
                             ) -> tuple[torch.Tensor, ...]:
    """The SSD scan's backward in the arithmetic of the kernel's bf16 path
    (``csrc/ssm_scan_bwd.cu``'s tensor-core passes), in f32: as
    ``ssd_scan_bwd`` (the carry, the decays W, the sums of M and da in f32),
    except that each product the kernel runs on the tensor cores takes bf16
    operands.  An operand is a bf16 high part plus the bf16 of its remainder
    and the low-by-low product is dropped (x, dy and a bf16 c have no
    remainder): the chunk sums' exp(cum_t) dy_t with c; C.B^T; dy.x; the
    masked and weighted E and F with dy, c and b; the states h_start and
    dh_end with dy, x and b.  Where the kernel reads b or c back as f32 (q
    and c's part of dcum), it reads the high part plus the low part.
    Returns (dx, da, db, dc, dh0) in f32, before the kernel's one rounding
    of each to its input's dtype; dh0 is None without h0."""
    def mm(eq, u, v):
        (uh, ul), (vh, vl) = _split_bf16(u), _split_bf16(v)
        return torch.einsum(eq, uh, vh) + torch.einsum(eq, uh, vl) + torch.einsum(eq, ul, vh)

    def hl(t):
        hi, lo = _split_bf16(t)
        return hi + lo
    return _ssd_bwd_closed_form(x, a, b, c, h0, dy, dh_final, chunk, mm, hl)


def _ssd_bwd_closed_form(x, a, b, c, h0, dy, dh_final, chunk, mm, hl):
    """``ssd_scan_bwd``'s closed form in f32 with its products as ``mm(eq,
    u, v)`` and b and c, where they are read back whole, as ``hl(t)``."""
    F = torch.nn.functional
    B, S, H, P = x.shape
    N = b.shape[-1]
    Q = min(chunk, S)
    xf, af, bf, cf, dyf = (t.float() for t in (x, a, b, c, dy))
    pad = -S % Q
    if pad:  # a = 1 and zeros past S, as the forward pads
        xf, bf, cf, dyf = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (xf, bf, cf, dyf))
        af = F.pad(af, (0, 0, 0, pad), value=1.0)
    G = xf.shape[1] // Q
    xf, bf, cf, dyf = (t.reshape(B, G, Q, H, -1) for t in (xf, bf, cf, dyf))
    lim = torch.tensor(1e-37, dtype=torch.float32, device=x.device)
    ac = torch.maximum(af, lim)
    cum = torch.cumsum(torch.log(ac).reshape(B, G, Q, H), dim=2)     # (B,G,Q,H)
    total = cum[:, :, -1]                                            # (B,G,H)
    w_end = torch.exp(total[:, :, None] - cum)                       # exp(total - cum_s)
    e_cum = torch.exp(cum)

    # the forward's chunk start states, and each chunk's end state
    h_in = torch.einsum("bgqhn,bgqhp->bghpn", bf * w_end[..., None], xf)
    h = (torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device) if h0 is None
         else h0.float())
    starts = []
    for g in range(G):
        starts.append(h)
        h = h * torch.exp(total[:, g])[..., None, None] + h_in[:, g]
    h_start = torch.stack(starts, dim=1)                             # (B,G,H,P,N)

    # the reverse carry of the state's gradient
    u = mm("bgthp,bgthn->bghpn", dyf * e_cum[..., None], cf)
    dh = (torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device) if dh_final is None
          else dh_final.float())
    ends = [None] * G
    for g in reversed(range(G)):
        ends[g] = dh
        dh = dh * torch.exp(total[:, g])[..., None, None] + u[:, g]
    dh_end = torch.stack(ends, dim=1)                                # (B,G,H,P,N)

    # within each chunk
    tri = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()[None, None, :, :, None]
    W = torch.exp((cum[:, :, :, None] - cum[:, :, None]).masked_fill(~tri, float("-inf")))
    cb = mm("bgthn,bgshn->bgtsh", cf, bf)                            # c_t . b_s
    e = mm("bgthp,bgshp->bgtsh", dyf, xf) * W                        # (dy_t . x_s) W_ts
    dx_state = mm("bghpn,bgshn->bgshp", dh_end, bf) * w_end[..., None]
    db_state = mm("bghpn,bgshp->bgshn", dh_end, xf) * w_end[..., None]
    dc_inter = mm("bghpn,bgthp->bgthn", h_start, dyf) * e_cum[..., None]
    dx = mm("bgtsh,bgthp->bgshp", cb * W, dyf) + dx_state
    db = mm("bgtsh,bgthn->bgshn", e, cf) + db_state
    dc = mm("bgtsh,bgshn->bgthn", e, bf) + dc_inter
    m = e * cb
    dcum = m.sum(3) - m.sum(2) + (hl(cf) * dc_inter).sum(-1)         # (B,G,Q,H)
    q = (hl(bf) * db_state).sum(-1)
    dla = (dcum.flip(2).cumsum(2).flip(2) + q.cumsum(2) - q
           + (torch.exp(total) * (dh_end * h_start).sum((-1, -2)))[:, :, None])
    dla = dla.reshape(B, -1, H)[:, :S]
    at = af[:, :S]
    da = dla / ac[:, :S] * torch.where(at > lim, 1.0, torch.where(at == lim, 0.5, 0.0))

    def out(t):
        return t.reshape(B, -1, H, t.shape[-1])[:, :S]
    return out(dx), da, out(db), out(dc), None if h0 is None else dh


def dp_sweep(spb: torch.Tensor, Kv: torch.Tensor, Ks: float, srcs: torch.Tensor,
             cand: torch.Tensor, valid: torch.Tensor, cc: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The pruned DP's min-plus sweep for S rows at once, all in f64.

    spb (N, N) seconds per byte; Kv (>= M-1,) the bytes each layer ships;
    Ks the source frame's bytes; srcs (S,) int64; cand (S, M, k) int64
    candidate nodes in ascending order; valid (S, M, k) bool; cc (M, N)
    per-layer compute cost or None.  Returns final (S, k) costs and backs
    (M-1, S, k) int64 back-pointers.

    Each element is formed in the order of ``repro/core/ould.py::_sparse_run``
    (``c0 = (Ks·spb + pen) + cc``, ``step = c[a] + ((Kv·spb + pen) + cc)``,
    each operation its own rounding), with pen = 0 where valid and +inf
    where not.  A back-pointer is numpy's ``argmin``: the first minimum, or
    the first NaN where a column holds one; the carried cost is the element
    it points at."""
    N = spb.shape[0]
    S, M, k = cand.shape
    flat = spb.reshape(-1)
    pen = torch.where(valid, 0.0, float("inf")).to(torch.float64)
    c = Ks * flat[srcs[:, None] * N + cand[:, 0, :]] + pen[:, 0]
    if cc is not None:
        c = c + cc[0, cand[:, 0, :]]
    backs = torch.empty((max(M - 1, 0), S, k), dtype=torch.int64, device=spb.device)
    for j in range(1, M):
        tr = Kv[j - 1] * flat[cand[:, j - 1, :, None] * N + cand[:, j, None, :]]
        tr = tr + pen[:, j, None, :]
        if cc is not None:
            tr = tr + cc[j, cand[:, j, :]][:, None, :]
        step = c[:, :, None] + tr                      # (S, k prev, k cur)
        nan = step.isnan()
        b = torch.where(nan.any(dim=1), nan.to(torch.int8).argmax(dim=1),
                        step.argmin(dim=1))
        backs[j - 1] = b
        c = step.gather(1, b[:, None, :])[:, 0, :]
    return c, backs
