"""The SSD scan's gradient in the port against the reference, on the CPU.

The reference trains hybrid blocks through XLA's autodiff of its chunked scan
(``repro.kernels.chunked.ssd_scan_chunked``; its Pallas kernel has no VJP).
The port's card path runs the scan under ``_SsdScanFunction``, whose backward
launches a hand-written kernel (``csrc/ssm_scan_bwd.cu``) whose plain version
is ``ref.ssd_scan_bwd``, the closed form.  Here:

- ``ref.ssd_scan_bwd`` against ``jax.vjp`` of the reference's chunked scan
  over x, a, b, c and h0 with h_final's cotangent: a ragged last chunk, a
  chunk at or past S, S = 1, h0 absent or present, a clamped decay; f32
  within 5e-5 x max|g| a leaf, the production dtype mix (bf16 x and c, f32 a
  and b) within the reference's bf16 2e-2;
- the kernel's four passes (chunk sums, the reverse carry, 64-row tiles
  paired with the tiles before and after them, da by a reverse scan),
  emulated in plain PyTorch, against ``ref.ssd_scan_bwd``, and their host
  plan;
- ``_SsdScanFunction`` with its launches faked by the plain versions: its
  gradient against autograd through ``ssd_scan_chunked``, launch counts under
  ``torch.utils.checkpoint``, ``needs_input_grad``, h_final's gradient, a
  double backward raising;
- the wrappers' meta branch: shapes, dtypes and ``cost.ssd_scan_bwd``'s work,
  no launch;
- reduced hymba's loss and every leaf's gradient, the scan under the Function
  (launches faked), against ``jax.value_and_grad`` of the reference, remat on
  and off, each leaf within 1e-4 x its max|g|.

The CUDA kernel is held against the plain version on the card in
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
from torch.utils._python_dispatch import TorchDispatchMode

import repro.configs as JC
from repro.kernels import chunked as jax_chunked
from repro.models import init_params as jax_init_params
from repro.models import transformer as jax_transformer
from repro_torch import configs as TC
from repro_torch.kernels import cost, ref
from repro_torch.kernels import ssm_scan as ss
from repro_torch.kernels.chunked import ssd_scan_chunked
from repro_torch.models import from_jax_params
from repro_torch.models import transformer as torch_transformer
from repro_torch.optim import tree_leaves

TOL = {"float32": 5e-5, "bfloat16": 2e-2}
NAMES = ("dx", "da", "db", "dc", "dh0")

# (B, S, H, P, N, chunk): whole chunks, a ragged last chunk, a chunk past S,
# one step, several ragged tiles of the kernel's 64 rows in a chunk of 160.
CASES = {
    "whole": (2, 12, 3, 8, 4, 4),
    "ragged": (1, 10, 2, 16, 8, 4),
    "chunk_past_s": (2, 7, 2, 8, 4, 16),
    "one_step": (2, 1, 3, 8, 4, 4),
    "tiles": (1, 300, 2, 8, 4, 160),
}


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def draw(case, seed=0, clamp=False):
    B, S, H, P, N, _ = CASES[case]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    a = rng.uniform(0.6, 1.0, (B, S, H)).astype(np.float32)
    if clamp:  # a tie with the clamp's 1e-37, and a decay below it
        a[0, 0, 0], a[-1, -1, -1] = np.float32(1e-37), 0.0
    b, c = (rng.standard_normal((B, S, H, N)).astype(np.float32) for _ in range(2))
    h0 = rng.standard_normal((B, H, P, N)).astype(np.float32)
    dy = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dh = rng.standard_normal((B, H, P, N)).astype(np.float32)
    return x, a, b, c, h0, dy, dh


def jax_grads(case, arrs, with_h0, dtype):
    """jax.vjp of the reference's chunked scan over (x, a, b, c[, h0]), x, c
    and dy in ``dtype``, a, b, h0 and dh_final in f32."""
    x, a, b, c, h0, dy, dh = arrs
    chunk = CASES[case][-1]
    jdt = getattr(jnp, dtype)
    args = [jnp.asarray(x, jdt), jnp.asarray(a), jnp.asarray(b), jnp.asarray(c, jdt)]
    if with_h0:
        args.append(jnp.asarray(h0))
    _, vjp = jax.vjp(lambda *t: jax_chunked.ssd_scan_chunked(*t, chunk=chunk), *args)
    return vjp((jnp.asarray(dy, jdt), jnp.asarray(dh)))


def torch_args(arrs, with_h0, dtype):
    x, a, b, c, h0, dy, dh = arrs
    tdt = getattr(torch, dtype)
    t = torch.from_numpy
    return (t(x).to(tdt), t(a), t(b), t(c).to(tdt), t(h0) if with_h0 else None,
            t(dy).to(tdt), t(dh))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_h0", [False, True], ids=["no_h0", "h0"])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_backward_matches_jax_vjp(case, with_h0, dtype):
    arrs = draw(case)
    want = jax_grads(case, arrs, with_h0, dtype)
    x, a, b, c, h0, dy, dh = torch_args(arrs, with_h0, dtype)
    got = ref.ssd_scan_bwd(x, a, b, c, h0, dy, dh, chunk=CASES[case][-1])
    assert (got[4] is None) == (not with_h0)
    for name, g, w, t in zip(NAMES, got, want, (x, a, b, c, h0)):
        assert g.dtype == t.dtype and g.shape == t.shape, name
        if case == "one_step" and not with_h0 and name == "da":
            # a single step's decay multiplies a zero state: its gradient is
            # zero, exactly here and up to rounding (1e-7 of dx) in the
            # reference's autodiff
            assert not g.any()
            assert np.abs(np.asarray(w, np.float32)).max() <= 1e-6 * np.abs(
                np.asarray(want[0], np.float32)).max()
            continue
        assert rel(g.float().numpy(), w) <= TOL[dtype], name


@pytest.mark.parametrize("case", ["ragged", "one_step"])
def test_plain_backward_takes_the_clamps_gradient(case):
    """A decay below the clamp's 1e-37 gets no gradient, as
    ``jnp.maximum``'s; every other gradient f32 at 5e-5.  At a decay of
    exactly 1e-37 both pass half (``jnp.maximum``'s tie), of a gradient of
    log a that is rounding noise of O(1) terms in both frameworks (what it
    measures is scaled by that decay): divided by 1e-37, that element's
    value is compared by its half factor alone, not to the reference's."""
    arrs = draw(case, seed=1, clamp=True)
    want = jax_grads(case, arrs, True, "float32")
    args = torch_args(arrs, True, "float32")
    got = ref.ssd_scan_bwd(*args, chunk=CASES[case][-1])
    assert float(want[1][-1, -1, -1]) == 0.0 and float(got[1][-1, -1, -1]) == 0.0
    tie = (0, 0, 0)
    a = args[1].clone()
    a[tie] = torch.nextafter(a[tie], torch.tensor(1.0))  # just above the clamp: the full share
    full = ref.ssd_scan_bwd(args[0], a, *args[2:], chunk=CASES[case][-1])[1][tie]
    assert abs(float(got[1][tie]) * 2 - float(full) * float(a[tie]) / 1e-37) <= (
        1e-3 * abs(float(full) * float(a[tie]) / 1e-37) + 1e-30)
    want_da, got_da = np.array(want[1]), got[1].numpy().copy()
    want_da[tie] = got_da[tie] = 0.0
    for name, g, w in zip(NAMES, (got[0], got_da, *got[2:]), (want[0], want_da, *want[2:])):
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        assert rel(g, w) <= TOL["float32"], name


def test_plain_backward_without_a_final_gradient_is_dh_final_zero():
    """dh_final None is a zero cotangent of the final state."""
    x, a, b, c, h0, dy, dh = torch_args(draw("ragged", seed=2), True, "float32")
    got = ref.ssd_scan_bwd(x, a, b, c, h0, dy, None, chunk=4)
    want = ref.ssd_scan_bwd(x, a, b, c, h0, dy, torch.zeros_like(dh), chunk=4)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# the kernel's passes, emulated
# ---------------------------------------------------------------------------

def tile_parallel_bwd(x, a, b, c, h0, dy, dh_final, *, chunk, tile=ss.TILE):
    """csrc/ssm_scan_bwd.cu's algorithm, from the forward's workspace (each
    chunk's running log decays, clamped at 1e-37, and start states), a
    ragged last chunk simply shorter:
      A'. each chunk on its own: U = sum_t exp(cum_t) dy_t (x) c_t;
      B'. the reverse carry from dh_final: each chunk's dh_end, then
          dh = dh exp(total) + U; dh0;
      C'. each ``tile``-row tile on its own, as t rows paired with the tiles
          at or before it (dc, the rows' sums of M) and as s rows with the
          tiles at or after it (dx, db, the columns' sums of M), each pair's
          products masked to s <= t; then the state terms and the tile's
          rows' dcum and injection sums q;
      D'. each chunk: exp(total) <dh_end, h_start>, and da from the reverse
          cumulative sum of dcum and the exclusive cumulative sum of q."""
    B, S, H, P = x.shape
    N = b.shape[-1]
    xf, af, bf, cf, dyf = (t.float() for t in (x, a, b, c, dy))
    Q = min(chunk, S)
    bounds = [(c0, min(c0 + Q, S)) for c0 in range(0, S, Q)]
    lim = torch.tensor(1e-37)
    cums = [torch.cumsum(torch.log(torch.maximum(af[:, c0:c1], lim)), dim=1)
            for c0, c1 in bounds]                                           # (B,L,H)
    h = torch.zeros(B, H, P, N) if h0 is None else h0.float()               # the forward's
    starts = []
    for (c0, c1), cum in zip(bounds, cums):
        starts.append(h)
        w = torch.exp(cum[:, -1:] - cum)
        h = h * torch.exp(cum[:, -1])[..., None, None] + torch.einsum(
            "bshp,bshn->bhpn", xf[:, c0:c1], bf[:, c0:c1] * w[..., None])
    us = [torch.einsum("bthp,bthn->bhpn", dyf[:, c0:c1] * torch.exp(cum)[..., None],
                       cf[:, c0:c1]) for (c0, c1), cum in zip(bounds, cums)]  # pass A'
    dh = torch.zeros(B, H, P, N) if dh_final is None else dh_final.float()
    dh_end = [None] * len(bounds)
    for g in reversed(range(len(bounds))):                                   # pass B'
        dh_end[g] = dh
        dh = dh * torch.exp(cums[g][:, -1])[..., None, None] + us[g]
    dx, db, dc = torch.zeros_like(xf), torch.zeros_like(bf), torch.zeros_like(cf)
    da = torch.zeros_like(af)
    for g, (c0, c1) in enumerate(bounds):
        cum, L = cums[g], c1 - c0
        tiles = [(r0, min(r0 + tile, L)) for r0 in range(0, L, tile)]
        dcum, qs = torch.zeros(B, L, H), torch.zeros(B, L, H)
        for i, (r0, r1) in enumerate(tiles):                                 # pass C'
            rows = slice(c0 + r0, c0 + r1)
            own = torch.arange(r0, r1)
            dc_t, rs = torch.zeros(B, r1 - r0, H, N), torch.zeros(B, r1 - r0, H)
            for s0, s1 in tiles[:i + 1]:          # the tile's rows as t, earlier s tiles
                oth = torch.arange(s0, s1)
                cols = slice(c0 + s0, c0 + s1)
                d = torch.einsum("bthp,bshp->btsh", dyf[:, rows], xf[:, cols])
                cb = torch.einsum("bthn,bshn->btsh", cf[:, rows], bf[:, cols])
                mask = (oth[None, :] <= own[:, None])[None, :, :, None]
                w = torch.exp((cum[:, r0:r1, None] - cum[:, None, s0:s1]).masked_fill(
                    ~mask, float("-inf")))
                e = d * w
                rs += (e * cb).sum(2)
                dc_t += torch.einsum("btsh,bshn->bthn", e, bf[:, cols])
            inter = torch.einsum("bhpn,bthp->bthn", starts[g], dyf[:, rows]) * torch.exp(
                cum[:, r0:r1])[..., None]
            dc[:, rows] = dc_t + inter
            dq = rs + (cf[:, rows] * inter).sum(-1)
            dx_s, db_s, cs = (torch.zeros(B, r1 - r0, H, P), torch.zeros(B, r1 - r0, H, N),
                              torch.zeros(B, r1 - r0, H))
            for t0, t1 in tiles[i:]:              # the tile's rows as s, later t tiles
                oth = torch.arange(t0, t1)
                cols = slice(c0 + t0, c0 + t1)
                d = torch.einsum("bshp,bthp->bsth", xf[:, rows], dyf[:, cols])
                cb = torch.einsum("bshn,bthn->bsth", bf[:, rows], cf[:, cols])
                mask = (own[:, None] <= oth[None, :])[None, :, :, None]
                w = torch.exp((cum[:, None, t0:t1] - cum[:, r0:r1, None]).masked_fill(
                    ~mask, float("-inf")))
                e, f = d * w, cb * w
                cs += (e * cb).sum(2)
                dx_s += torch.einsum("bsth,bthp->bshp", f, dyf[:, cols])
                db_s += torch.einsum("bsth,bthn->bshn", e, cf[:, cols])
            wend = torch.exp(cum[:, -1:] - cum[:, r0:r1])[..., None]
            inj_x = torch.einsum("bhpn,bshn->bshp", dh_end[g], bf[:, rows]) * wend
            inj_b = torch.einsum("bhpn,bshp->bshn", dh_end[g], xf[:, rows]) * wend
            dx[:, rows], db[:, rows] = dx_s + inj_x, db_s + inj_b
            dcum[:, r0:r1] = dq - cs
            qs[:, r0:r1] = (bf[:, rows] * inj_b).sum(-1)
        z = torch.exp(cum[:, -1]) * (dh_end[g] * starts[g]).sum((-1, -2))   # pass D'
        dla = dcum.flip(1).cumsum(1).flip(1) + qs.cumsum(1) - qs + z[:, None]
        at = af[:, c0:c1]
        da[:, c0:c1] = dla / torch.maximum(at, lim) * torch.where(
            at > lim, 1.0, torch.where(at == lim, 0.5, 0.0))
    return (dx.to(x.dtype), da, db, dc.to(c.dtype),
            None if h0 is None else dh)


@pytest.mark.parametrize("tile", [64, 3], ids=["tile64", "tile3"])
@pytest.mark.parametrize("case", list(CASES))
def test_tile_parallel_bwd_matches_plain(case, tile):
    """The kernel's passes at its own 64-row tiles and at tiles of 3 (so
    small cases pair several tiles, the last ragged), f32 within 5e-5 x
    max|g| of ``ref.ssd_scan_bwd``."""
    x, a, b, c, h0, dy, dh = torch_args(draw(case, seed=3), True, "float32")
    chunk = CASES[case][-1]
    want = ref.ssd_scan_bwd(x, a, b, c, h0, dy, dh, chunk=chunk)
    got = tile_parallel_bwd(x, a, b, c, h0, dy, dh, chunk=chunk, tile=tile)
    for name, g, w in zip(NAMES, got, want):
        assert rel(g.numpy(), w.numpy()) <= TOL["float32"], name


def chunk_pairs_bwd(x, a, b, c, h0, dy, dh_final, *, chunk, tile=ss.TILE):
    """csrc/ssm_scan_bwd.cu's tensor-core schedule (bf16 x and dy) in f32,
    without the operand splits (``ref.ssd_scan_bwd_bf16_scheme`` carries
    those): A' and B' as ``tile_parallel_bwd``; C' a block per chunk that
    walks its lower-triangle ``tile``-row tile pairs (t tile i, s tile j),
    i >= j, in the order j = 0.., i = j.., forming each pair's C.B^T, DY.X^T
    and W once.  dx_s and db_s sum over the s tile's pairs in order and take
    the injection terms at its last pair; dc_t starts from the inter-chunk
    term at j = 0 and sums over the s tiles in order, final at the diagonal
    pair (i = j), the t tile's last; dcum_t collects each pair's sums of M
    over s (and c_t . the inter term), dcum_s loses the s tile's sums of M
    over t at its last pair; D' as ``tile_parallel_bwd``."""
    B, S, H, P = x.shape
    N = b.shape[-1]
    xf, af, bf, cf, dyf = (t.float() for t in (x, a, b, c, dy))
    Q = min(chunk, S)
    bounds = [(c0, min(c0 + Q, S)) for c0 in range(0, S, Q)]
    lim = torch.tensor(1e-37)
    cums = [torch.cumsum(torch.log(torch.maximum(af[:, c0:c1], lim)), dim=1)
            for c0, c1 in bounds]                                           # (B,L,H)
    h = torch.zeros(B, H, P, N) if h0 is None else h0.float()               # the forward's
    starts = []
    for (c0, c1), cum in zip(bounds, cums):
        starts.append(h)
        w = torch.exp(cum[:, -1:] - cum)
        h = h * torch.exp(cum[:, -1])[..., None, None] + torch.einsum(
            "bshp,bshn->bhpn", xf[:, c0:c1], bf[:, c0:c1] * w[..., None])
    us = [torch.einsum("bthp,bthn->bhpn", dyf[:, c0:c1] * torch.exp(cum)[..., None],
                       cf[:, c0:c1]) for (c0, c1), cum in zip(bounds, cums)]  # pass A'
    dh = torch.zeros(B, H, P, N) if dh_final is None else dh_final.float()
    dh_end = [None] * len(bounds)
    for g in reversed(range(len(bounds))):                                   # pass B'
        dh_end[g] = dh
        dh = dh * torch.exp(cums[g][:, -1])[..., None, None] + us[g]
    dx, db, dc = torch.zeros_like(xf), torch.zeros_like(bf), torch.zeros_like(cf)
    da = torch.zeros_like(af)
    for g, (c0, c1) in enumerate(bounds):                                    # pass C'
        cum, L = cums[g], c1 - c0
        tiles = [(r0, min(r0 + tile, L)) for r0 in range(0, L, tile)]
        dcum, qs = torch.zeros(B, L, H), torch.zeros(B, L, H)
        dcs = [None] * len(tiles)                  # each t tile's dc sums
        for j, (s0, s1) in enumerate(tiles):       # s tiles outer
            srows, sidx = slice(c0 + s0, c0 + s1), torch.arange(s0, s1)
            dx_s, db_s, cs = (torch.zeros(B, s1 - s0, H, P), torch.zeros(B, s1 - s0, H, N),
                              torch.zeros(B, s1 - s0, H))
            for i in range(j, len(tiles)):         # t tiles at or after it, inner
                t0, t1 = tiles[i]
                trows, tidx = slice(c0 + t0, c0 + t1), torch.arange(t0, t1)
                d = torch.einsum("bthp,bshp->btsh", dyf[:, trows], xf[:, srows])  # once a pair
                cb = torch.einsum("bthn,bshn->btsh", cf[:, trows], bf[:, srows])
                mask = (sidx[None, :] <= tidx[:, None])[None, :, :, None]
                w = torch.exp((cum[:, t0:t1, None] - cum[:, None, s0:s1]).masked_fill(
                    ~mask, float("-inf")))
                e, f = d * w, cb * w
                m = e * cb
                dx_s += torch.einsum("btsh,bthp->bshp", f, dyf[:, trows])
                db_s += torch.einsum("btsh,bthn->bshn", e, cf[:, trows])
                cs += m.sum(1)
                if j == 0:                         # dc from the inter-chunk term
                    inter = torch.einsum("bhpn,bthp->bthn", starts[g], dyf[:, trows]
                                         ) * torch.exp(cum[:, t0:t1])[..., None]
                    dcs[i] = inter
                    dcum[:, t0:t1] = (cf[:, trows] * inter).sum(-1)
                dcs[i] = dcs[i] + torch.einsum("btsh,bshn->bthn", e, bf[:, srows])
                dcum[:, t0:t1] += m.sum(2)
                if i == j:                         # the diagonal pair: dc is final
                    dc[:, trows] = dcs[i]
            wend = torch.exp(cum[:, -1:] - cum[:, s0:s1])[..., None]
            inj_x = torch.einsum("bhpn,bshn->bshp", dh_end[g], bf[:, srows]) * wend
            inj_b = torch.einsum("bhpn,bshp->bshn", dh_end[g], xf[:, srows]) * wend
            dx[:, srows], db[:, srows] = dx_s + inj_x, db_s + inj_b
            dcum[:, s0:s1] -= cs
            qs[:, s0:s1] = (bf[:, srows] * inj_b).sum(-1)
        z = torch.exp(cum[:, -1]) * (dh_end[g] * starts[g]).sum((-1, -2))   # pass D'
        dla = dcum.flip(1).cumsum(1).flip(1) + qs.cumsum(1) - qs + z[:, None]
        at = af[:, c0:c1]
        da[:, c0:c1] = dla / torch.maximum(at, lim) * torch.where(
            at > lim, 1.0, torch.where(at == lim, 0.5, 0.0))
    return (dx.to(x.dtype), da, db, dc.to(c.dtype),
            None if h0 is None else dh)


@pytest.mark.parametrize("tile", [64, 3], ids=["tile64", "tile3"])
@pytest.mark.parametrize("case", list(CASES))
def test_chunk_pairs_bwd_matches_plain(case, tile):
    """The tensor-core schedule (a block per chunk, each tile pair once) at
    its 64-row tiles and at tiles of 3 (several pairs a chunk, the last tile
    ragged), f32 within 5e-5 x max|g| of ``ref.ssd_scan_bwd``."""
    x, a, b, c, h0, dy, dh = torch_args(draw(case, seed=3), True, "float32")
    chunk = CASES[case][-1]
    want = ref.ssd_scan_bwd(x, a, b, c, h0, dy, dh, chunk=chunk)
    got = chunk_pairs_bwd(x, a, b, c, h0, dy, dh, chunk=chunk, tile=tile)
    for name, g, w in zip(NAMES, got, want):
        assert rel(g.numpy(), w.numpy()) <= TOL["float32"], name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_h0", [False, True], ids=["no_h0", "h0"])
@pytest.mark.parametrize("case", list(CASES))
def test_bf16_scheme_matches_the_closed_form(case, with_h0, dtype):
    """``ref.ssd_scan_bwd_bf16_scheme`` (the kernel's bf16 path: every
    tensor-core product's f32 operand a bf16 high part plus its remainder)
    against the closed form on the same values in f32, within the f32 5e-5
    x max|g| a gradient: the split keeps ~16 bits, far below bf16's 8.  In
    the bf16 mix (x, c and dy bf16) the closed form takes their f32 values.
    The scheme returns f32, before the kernel's rounding to each input's
    dtype."""
    x, a, b, c, h0, dy, dh = torch_args(draw(case, seed=5), with_h0, dtype)
    chunk = CASES[case][-1]
    got = ref.ssd_scan_bwd_bf16_scheme(x, a, b, c, h0, dy, dh, chunk=chunk)
    want = ref.ssd_scan_bwd(x.float(), a, b, c.float(), h0, dy.float(), dh, chunk=chunk)
    assert all(g is None or g.dtype == torch.float32 for g in got)
    for name, g, w in zip(NAMES, got, want):
        if w is None:
            assert g is None
            continue
        assert rel(g.numpy(), w.numpy()) <= TOL["float32"], name


@pytest.mark.parametrize("P,N,chunk", [(64, 16, 256), (16, 8, 32), (100, 32, 64), (128, 32, 256),
                                       (64, 64, 256), (128, 64, 256), (128, 64, 64)])
def test_backward_plan_takes_the_tensor_cores_for_bf16(P, N, chunk):
    """``ssd_bwd_plan(..., bf16=True)``: C' a block per (batch, head, chunk)
    on the tensor cores at every width (the library refuses a chunk whose
    block does not fit the card's shared memory, ``test_torch_gpu``); f32 x
    never takes the tensor cores: C' a block per (batch, head, chunk, tile).
    The other three launches do not depend on the route."""
    B, S, H = 2, 300, 3
    tc, f32 = ss.ssd_bwd_plan(B, S, H, P, N, chunk, True), ss.ssd_bwd_plan(B, S, H, P, N, chunk)
    G = -(-S // min(chunk, S))
    assert tc.tc and not f32.tc
    assert tc.grid[2] == B * H * G and f32.grid[2] == B * H * G * f32.tiles
    assert tc.grid[0] == tc.grid[3] == B * H * G
    assert (tc.grid[0], tc.grid[1], tc.grid[3]) == (f32.grid[0], f32.grid[1], f32.grid[3])


@pytest.mark.parametrize("B,S,H,P,N,chunk", [(2, 4096, 50, 64, 16, 256), (4, 1536, 50, 64, 16, 256),
                                             (2, 300, 3, 128, 64, 160), (1, 1, 2, 16, 8, 256)])
def test_backward_plan_covers_every_chunk_tile_and_entry(B, S, H, P, N, chunk):
    """``ssd_bwd_plan``: a block per (batch, head, chunk) for A' and D', a
    thread per state entry for B', a block per (batch, head, chunk, tile)
    for C'; hymba's train shape fills the card's 132 SMs many times over."""
    plan = ss.ssd_bwd_plan(B, S, H, P, N, chunk)
    Q = min(chunk, S)
    G = -(-S // Q)
    assert (plan.chunk, plan.chunks, plan.tiles) == (Q, G, -(-Q // ss.TILE))
    assert plan.grid[0] == plan.grid[3] == B * H * G
    assert plan.grid[1] * ss.THREADS >= B * H * P * N > (plan.grid[1] - 1) * ss.THREADS
    assert plan.grid[2] == B * H * G * plan.tiles
    if S == 4096:
        assert plan.grid[2] > 40 * cost.H100_SMS


# ---------------------------------------------------------------------------
# the autograd Function, its launches faked
# ---------------------------------------------------------------------------

class FakeLaunches:
    """Stands in for the two launches of ``kernels/ssm_scan.py`` (the
    forward's ``_forward`` and ``ssd_scan_bwd``) with their plain versions,
    counting calls, so the autograd plumbing runs on the CPU."""

    def __init__(self, monkeypatch):
        self.fwd = self.bwd = 0
        self.kept = []
        self.dh = []

        def fwd(x, a, b, c, h0, chunk, keep):
            self.fwd += 1
            self.kept.append(keep)
            y, h = ssd_scan_chunked(x, a, b, c, h0, chunk=chunk)
            return y, h, ((torch.zeros(1), torch.zeros(1)) if keep else None)

        def bwd(x, a, b, c, h0, dy, dh_final, *, chunk, saved):
            self.bwd += 1
            self.dh.append(dh_final is not None)
            assert dy.is_contiguous() and len(saved) == 2
            return ref.ssd_scan_bwd(x, a, b, c, h0, dy, dh_final, chunk=chunk)

        monkeypatch.setattr(ss, "_forward", fwd)
        monkeypatch.setattr(ss, "ssd_scan_bwd", bwd)


def scan_inputs(requires=(True,) * 5, seed=0, S=11, chunk=4):
    rng = np.random.default_rng(seed)
    B, H, P, N = 2, 3, 8, 4
    ts = [torch.from_numpy(rng.standard_normal((B, S, H, P)).astype(np.float32)),
          torch.from_numpy(rng.uniform(0.6, 1.0, (B, S, H)).astype(np.float32)),
          torch.from_numpy(rng.standard_normal((B, S, H, N)).astype(np.float32)),
          torch.from_numpy(rng.standard_normal((B, S, H, N)).astype(np.float32)),
          torch.from_numpy(rng.standard_normal((B, H, P, N)).astype(np.float32))]
    return [t.requires_grad_(r) for t, r in zip(ts, requires)]


def apply(x, a, b, c, h0, chunk=4):
    return ss._SsdScanFunction.apply(x, a, b, c, h0, chunk)


def test_function_carries_gradients_and_counts_launches(monkeypatch):
    """The Function's outputs carry gradients to x, a, b, c and h0 equal to
    autograd through ``ssd_scan_chunked`` (f32 5e-5 x max|g|), with h_final's
    used; its forward keeps the workspace.  Under ``torch.utils.checkpoint``
    each call launches its forward twice (run, recompute) and its backward
    once, with the same gradients bit for bit."""
    from torch.utils.checkpoint import checkpoint
    fake = FakeLaunches(monkeypatch)
    ts = scan_inputs()

    def two(x, a, b, c, h0, fn):
        y, h = fn(x, a, b, c, h0)
        y2, h2 = fn(y, a, b, c, h)
        return (y2 * y2).sum() + (h2 * h2).sum() + (y * y).sum()

    got = torch.autograd.grad(two(*ts, apply), ts)
    assert (fake.fwd, fake.bwd) == (2, 2) and all(fake.kept) and all(fake.dh)
    want = torch.autograd.grad(two(*ts, lambda *t: ssd_scan_chunked(*t, chunk=4)), ts)
    for name, g, w in zip(NAMES, got, want):
        assert rel(g.numpy(), w.numpy()) <= TOL["float32"], name
    fake.fwd = fake.bwd = 0
    loss = checkpoint(lambda *t: two(*t, apply), *ts, use_reentrant=False)
    again = torch.autograd.grad(loss, ts)
    assert (fake.fwd, fake.bwd) == (4, 2)
    for g, w in zip(again, got):
        assert torch.equal(g, w)


def test_function_passes_no_final_gradient_where_h_final_is_unused(monkeypatch):
    """Where only y is used, the backward gets dh_final None (no zeros
    made), and the gradients equal autograd's through the plain scan."""
    fake = FakeLaunches(monkeypatch)
    ts = scan_inputs(seed=1)
    y, _ = apply(*ts)
    got = torch.autograd.grad((y * y).sum(), ts)
    assert fake.dh == [False]
    want = torch.autograd.grad((ssd_scan_chunked(*ts, chunk=4)[0] ** 2).sum(), ts)
    for name, g, w in zip(NAMES, got, want):
        assert rel(g.numpy(), w.numpy()) <= TOL["float32"], name


@pytest.mark.parametrize("requires", [(True, False, False, False, False),
                                      (False, True, True, False, False),
                                      (False, False, False, True, True)],
                         ids=["x", "ab", "c_h0"])
def test_function_returns_only_the_gradients_asked_for(monkeypatch, requires):
    """``needs_input_grad``: an input that does not require grad gets None,
    the others the plain gradient."""
    FakeLaunches(monkeypatch)
    ts = scan_inputs(requires, seed=2)
    seen = []

    class Spy(ss._SsdScanFunction):
        @staticmethod
        def backward(ctx, dy, dh):
            out = ss._SsdScanFunction.backward(ctx, dy, dh)
            seen.append([o is not None for o in out[:5]])
            return out

    asked = [t for t in ts if t.requires_grad]
    y, h = Spy.apply(*ts, 4)
    got = torch.autograd.grad(y.sum() + h.sum(), asked)
    assert seen == [list(requires)]
    y, h = ssd_scan_chunked(*ts, chunk=4)
    want = torch.autograd.grad(y.sum() + h.sum(), asked)
    for g, w in zip(got, want):
        assert rel(g.numpy(), w.numpy()) <= TOL["float32"]


def test_function_refuses_a_double_backward(monkeypatch):
    """A backward that would record a graph raises before the backward
    kernel runs; the same graph then still gives its first derivative."""
    fake = FakeLaunches(monkeypatch)
    ts = scan_inputs(seed=3)
    y, _ = apply(*ts)
    with pytest.raises(NotImplementedError, match="double backward"):
        torch.autograd.grad(y.sum(), ts[:1], create_graph=True, retain_graph=True)
    assert fake.bwd == 0
    (gx,) = torch.autograd.grad(y.sum(), ts[:1])
    assert fake.bwd == 1 and gx.shape == ts[0].shape


def test_wrapper_cpu_paths_launch_nothing():
    """On the CPU the wrappers run the plain versions (no Function, no
    launch): ``ssd_scan`` autograd's through ``ssd_scan_chunked``,
    ``ssd_scan_bwd`` is ``ref.ssd_scan_bwd`` whatever is saved."""
    n0 = (ss.ssd_scan.n_launches, ss.ssd_scan_bwd.n_launches)
    ts = scan_inputs(seed=4)
    y, h = ss.ssd_scan(*ts, chunk=4)
    assert type(y.grad_fn).__name__ != "BackwardCFunction"
    dy = torch.ones_like(y)
    got = ss.ssd_scan_bwd(*(t.detach() for t in ts), dy, None, chunk=4)
    want = torch.autograd.grad(y, ts, dy)
    for g, w in zip(got, want):
        assert rel(g.numpy(), w.numpy()) <= TOL["float32"]
    assert (ss.ssd_scan.n_launches, ss.ssd_scan_bwd.n_launches) == n0


# ---------------------------------------------------------------------------
# the meta branch
# ---------------------------------------------------------------------------

class Record(TorchDispatchMode):
    """Runs every op as it is and logs each kernel's recorded work."""

    def __init__(self):
        super().__init__()
        self.log = []

    def record_kernel(self, kernel, work):
        self.log.append((kernel, work))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("S", [300, 1], ids=["chunked", "one_step"])
@pytest.mark.parametrize("with_h0", [False, True], ids=["no_h0", "h0"])
def test_meta_branch_shapes_and_work(with_h0, S):
    """On meta tensors under autograd, in the production dtype mix: the
    forward records ``cost.ssd_scan`` and the backward ``cost.ssd_scan_bwd``
    (with h_final's gradient where it is used), the gradients come back in
    the inputs' shapes and dtypes, nothing launches."""
    B, H, P, N, chunk = 2, 5, 64, 16, 128

    def m(shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta").requires_grad_(True)
    x, a = m((B, S, H, P), torch.bfloat16), m((B, S, H))
    b, c = m((B, S, H, N)), m((B, S, H, N), torch.bfloat16)
    h0 = m((B, H, P, N)) if with_h0 else None
    ins = [t for t in (x, a, b, c, h0) if t is not None]
    n0 = (ss.ssd_scan.n_launches, ss.ssd_scan_bwd.n_launches)
    with Record() as rec:
        y, h = ss.ssd_scan(x, a, b, c, h0, chunk=chunk)
        grads = torch.autograd.grad((y, h), ins, (torch.empty_like(y), torch.empty_like(h)))
    assert y.shape == x.shape and y.dtype == torch.bfloat16 and h.dtype == torch.float32
    for g, t in zip(grads, ins):
        assert g.shape == t.shape and g.dtype == t.dtype and g.is_meta
    sizes = (2, 4, 4, 2, 4 if with_h0 else 0)
    assert rec.log == [("ssd_scan", cost.ssd_scan(B, S, H, P, N, chunk, *sizes)),
                       ("ssd_scan_bwd", cost.ssd_scan_bwd(B, S, H, P, N, chunk, *sizes, 4))]
    assert (ss.ssd_scan.n_launches, ss.ssd_scan_bwd.n_launches) == n0


def test_backward_work_counts_five_products_a_pair_and_each_tensor_once():
    """``cost.ssd_scan_bwd`` at hymba's train shape: L(L+1)/2 pairs a
    chunk of 2 (2P + 3N) operations and 8PN a step; x, dy and dx (bf16),
    a and da, b and db (f32), c and dc (bf16) once: ~22 GFLOP against
    ~240 MB, so the f32 rate, not the bytes, bounds it."""
    B, S, H, P, N, Q = 2, 4096, 50, 64, 16, 256
    w = cost.ssd_scan_bwd(B, S, H, P, N, Q, 2, 4, 4, 2, 0, 0)
    assert w.flops == B * H * (S // Q) * (Q * (Q + 1) * (2 * P + 3 * N) + 8 * Q * P * N)
    assert w.bytes == B * S * H * (3 * P * 2 + 2 * 4 + 2 * N * 4 + 2 * N * 2)
    assert 2.0e10 < w.flops < 2.3e10 and 2.3e8 < w.bytes < 2.5e8
    assert w.flops / cost.PEAK_F32 > w.bytes / cost.PEAK_BYTES
    ragged = cost.ssd_scan_bwd(1, 10, 1, 8, 4, 4, 4, 4, 4, 4, 4, 4)
    pairs = sum(L * (L + 1) for L in (4, 4, 2))
    assert ragged.flops == pairs * (2 * 8 + 3 * 4) + 8 * 10 * 8 * 4
    assert ragged.bytes == 10 * (3 * 8 * 4 + 2 * 4 + 2 * 4 * 8) + 8 * 4 * (2 * 4 + 4)


# ---------------------------------------------------------------------------
# reduced hymba's gradient through the Function
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("remat", [False, True], ids=["no_remat", "remat"])
def test_reduced_hymba_grads_through_the_function_match_reference(remat, monkeypatch):
    """Reduced hymba (2 layers, d 64, vocab 512, chunk 16; 24 tokens, so a
    ragged last chunk), the reference's weights converted, its SSD scan run
    under ``_SsdScanFunction`` with the launches faked: ``loss_fn`` at 1e-5
    and its gradient over every parameter against ``jax.value_and_grad`` of
    the reference's, each leaf within 1e-4 x its max|g|.  Each layer's scan
    launches its forward once (twice with remat) and its backward once."""
    from repro_torch.kernels import ops
    fake = FakeLaunches(monkeypatch)
    monkeypatch.setattr(ops, "_ssd_scan", lambda x, a, b, c, h0=None, *, chunk: (
        ss._SsdScanFunction.apply(x, a, b, c, h0, chunk)))
    kw = dict(n_layers=2, d_model=64, vocab=512)
    jcfg = JC.get_config("hymba_1p5b").reduced(**kw)
    tcfg = TC.get_config("hymba_1p5b").reduced(**kw)
    assert tcfg.ssm.chunk == 16
    jp = jax_init_params(jax.random.PRNGKey(0), jcfg)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    batch = {"tokens": np.random.default_rng(5).integers(0, jcfg.vocab, (2, 24), dtype=np.int32)}
    (jloss, _), jg = jax.value_and_grad(
        lambda p: jax_transformer.loss_fn(p, jcfg, {"tokens": jnp.asarray(batch["tokens"])},
                                          remat=remat), has_aux=True)(jp)
    leaves = tree_leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    loss, _ = torch_transformer.loss_fn(tp, tcfg, {"tokens": torch.from_numpy(batch["tokens"])},
                                        remat=remat)
    got = torch.autograd.grad(loss, leaves)
    assert (fake.fwd, fake.bwd) == ((2 if remat else 1) * 2, 2)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5, atol=1e-5)
    want = tree_leaves(from_jax_params(jax.tree.map(np.asarray, jg), tcfg, device="cpu"))
    assert len(want) == len(got)
    for g, w in zip(got, want):
        g, w = g.numpy(), w.numpy()
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= 1e-4 * max(np.abs(w).max(), 1e-30)


def test_reduced_hymba_bf16_step_through_the_function_matches_plain(monkeypatch):
    """In bf16 (the train step's dtype mix at the scan: bf16 x and c, f32 a
    and b), the loss and gradient through the Function with the launches
    faked are autograd's through the plain scan within the bf16 2e-2 (the
    closed form and autograd round differently in f32), and the scan is
    handed the mix the kernels take."""
    from repro_torch.kernels import ops
    kw = dict(n_layers=2, d_model=64, vocab=512)
    cfg = dataclasses.replace(TC.get_config("hymba_1p5b").reduced(**kw),
                              param_dtype="bfloat16", compute_dtype="bfloat16")
    from repro_torch.models import init_params
    params = init_params(0, cfg, device="cpu")
    batch = {"tokens": torch.from_numpy(
        np.random.default_rng(6).integers(0, cfg.vocab, (2, 20)).astype(np.int64))}

    def grads():
        leaves = tree_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        loss, _ = torch_transformer.loss_fn(params, cfg, batch)
        return [loss] + list(torch.autograd.grad(loss, leaves))

    want = grads()
    FakeLaunches(monkeypatch)
    seen = []

    def via_function(x, a, b, c, h0=None, *, chunk):
        seen.append((x.dtype, a.dtype, b.dtype, c.dtype))
        return ss._SsdScanFunction.apply(x, a, b, c, h0, chunk)
    monkeypatch.setattr(ops, "_ssd_scan", via_function)
    got = grads()
    assert seen and all(s == (torch.bfloat16, torch.float32, torch.float32, torch.bfloat16)
                        for s in seen)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        assert rel(g.detach().float().numpy(), w.detach().float().numpy()) <= TOL["bfloat16"]
