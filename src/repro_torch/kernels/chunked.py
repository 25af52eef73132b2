"""Chunked SSD scan, the plain PyTorch version of ``csrc/ssm_scan.cu``, and
the chunked mLSTM built on it (port of ``repro.kernels.chunked``).

O(S·Q) instead of the sequential scan's S steps: within a chunk of Q steps
the output is a masked quadratic form, and a state (B, H, P, N) carries from
chunk to chunk.  Numerics as in the reference: per-chunk log-space cumulative
decays (log a clamped at 1e-37), the upper triangle masked to -inf *before*
the exp, f32 accumulation, y cast back to x's dtype and the final state kept
in f32.  ``mlstm_chunked`` maps the xLSTM matrix-memory cell onto two SSD
scans that share their decays; it is XLA code in the reference on every
backend (``repro/kernels/ops.py:69-71``), so it stays plain PyTorch here on
every device too, at mLSTM's P = N = 1024 (the CUDA scan takes P <= 128).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _chunk(t: torch.Tensor, q: int) -> torch.Tensor:
    return t.reshape(t.shape[0], t.shape[1] // q, q, *t.shape[2:])


def ssd_scan_chunked(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                     h0: torch.Tensor | None = None, *, chunk: int = 256
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked evaluation of ``ref.ssd_scan`` (same signature plus ``chunk``).

    x: (B,S,H,P), a: (B,S,H) in (0,1), b/c: (B,S,H,N).  A ragged last chunk
    is padded: a with 1.0 (log a = 0), x, b and c with zeros.
    """
    B, S, H, P = x.shape
    N = b.shape[-1]
    Q = min(chunk, S)
    xf, af, bf, cf = (t.float() for t in (x, a, b, c))
    if S % Q:
        pad = Q - S % Q
        xf, bf, cf = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (xf, bf, cf))
        af = F.pad(af, (0, 0, 0, pad), value=1.0)
    xf, bf, cf = _chunk(xf, Q), _chunk(bf, Q), _chunk(cf, Q)        # (B,G,Q,H,·)
    cum = torch.cumsum(_chunk(torch.log(torch.clamp(af, min=1e-37)), Q), dim=2)  # (B,G,Q,H)
    total = cum[:, :, -1]                                          # (B,G,H)

    # Intra-chunk: the s-th injection reaches t >= s decayed by
    # prod_{u=s+1..t} a_u = exp(cum_t - cum_s).  Mask before the exp: the
    # upper triangle's differences are positive and exp would overflow.
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]           # (B,G,Q,Q,H) t,s
    tri = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()[None, None, :, :, None]
    gate = torch.exp(diff.masked_fill(~tri, float("-inf")))
    dots = torch.einsum("bgthn,bgshn->bgtsh", cf, bf)               # c_t · b_s
    y_intra = torch.einsum("bgtsh,bgshp->bgthp", dots * gate, xf)

    # Chunk summaries: injected state sum_s exp(total - cum_s) b_s ⊗ x_s.
    # b is scaled by w before the contraction over q, so the (B,G,Q,H,N,P)
    # outer product is never formed (mLSTM's N = P = 1024 would make it 64
    # GiB at batch 4, prompt 1024), whatever order einsum would pick.
    w = torch.exp(total[:, :, None] - cum)                          # (B,G,Q,H)
    h_in = torch.einsum("bgqhn,bgqhp->bghpn", bf * w[..., None], xf)

    # Carry the state across chunks; h_starts[g] is the state before chunk g.
    h = (torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device) if h0 is None
         else h0.float())
    starts = []
    for g in range(h_in.shape[1]):
        starts.append(h)
        h = h * torch.exp(total[:, g])[..., None, None] + h_in[:, g]
    h_starts = torch.stack(starts, dim=1)                           # (B,G,H,P,N)

    # Inter-chunk: y_t += exp(cum_t) · (c_t · h_start).
    y_inter = torch.einsum("bgthn,bghpn->bgthp", cf, h_starts) * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(B, -1, H, P)[:, :S]
    return y.to(x.dtype), h


def mlstm_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, i_gate: torch.Tensor,
                  f_gate: torch.Tensor, *, chunk: int = 256, gather=None
                  ) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """Chunked mLSTM forward (prefill and training).

    The matrix-memory cell as two SSD scans sharing their decays:
      C_t = f C_{t-1} + i k v^T  ->  ssd(x=v, a=f, b=i*k, c=q)   (numerator)
      n_t = f n_{t-1} + i k      ->  ssd(x=1, ...)               (denominator)
    The forget gates enter as log-sigmoid decays (exponents <= 0) and the
    input gates are stabilised by one max per sequence and head, m =
    max(max_t i_t, 0); the denominator is clamped at exp(-m).  Returns y
    (B,S,H,P) in q's dtype and (C (B,H,P_v,P_k), n (B,H,P), m (B,H)) in f32,
    C and n scaled by exp(-m) (the sequential form's invariant; C is in the
    scan's (v, k) layout, which decode transposes).

    ``gather``, where q, k and v hold one slice of their head's P (a
    sharded train step's cell, ``ops._mlstm_head_split``), makes a slice of
    q or k whole, (.., c) -> (.., P): b is formed on k's slice, then b and q
    are gathered for the scans, and y and C come out at v's slice."""
    B, S, H, P = q.shape
    if gather is not None:
        q = gather(q)
        P = q.shape[-1]
    scale = P ** -0.5
    logf = F.logsigmoid(f_gate.float())                                       # <= 0
    li = i_gate.float()
    m = torch.maximum(torch.amax(li, dim=1, keepdim=True), torch.zeros((), device=q.device))
    i_act = torch.exp(li - m)                                                 # (B,S,H)
    a = torch.exp(logf)                                                       # decay
    b = k.float() * scale * i_act[..., None]
    if gather is not None:
        b = gather(b)
    num, C = ssd_scan_chunked(v, a, b, q, chunk=chunk)                        # (B,S,H,P)
    ones = torch.ones((B, S, H, 1), dtype=torch.float32, device=q.device)
    den, n = ssd_scan_chunked(ones, a, b, q, chunk=chunk)                     # (B,S,H,1)
    den = torch.maximum(den[..., 0].abs(), torch.exp(-m))                     # unscaled >= 1
    y = num.float() / den[..., None]
    return y.to(q.dtype), (C, n[:, :, 0, :], m[:, 0])
