"""The SSD scan kernel's chunk-parallel algorithm against the reference.

``csrc/ssm_scan.cu`` runs the scan as three passes (chunk states in
parallel, the carry across chunks, outputs by 64-row tile) and a single
step at S = 1.  That CUDA code runs only on the card (``tests/test_torch_gpu.py``
holds it to the plain versions there); here the same algorithm, emulated in
plain PyTorch, is held against the reference's Pallas kernel in interpret
mode and its sequential oracle, over the reference's sweep and tolerances
(f32 5e-5; y at 2e-2 when x is bf16).  The host plan of the launches is
checked here too.  Inputs come from a seeded numpy generator.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels import ref as jax_ref
from repro.kernels.ssm_scan import ssd_scan_pallas
from repro_torch.kernels import ref
from repro_torch.kernels.chunked import ssd_scan_chunked
from repro_torch.kernels.ssm_scan import TILE, ssd_plan, step_team

SSD = dict(rtol=5e-5, atol=5e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
H100_SMS = 132


def chunk_parallel_scan(x, a, b, c, h0=None, *, chunk=256, tile=TILE):
    """csrc/ssm_scan.cu's algorithm.  S = 1: h = a h0 + x (x) b, y = h . c.
    Otherwise, with Q = min(chunk, S) and a ragged last chunk that is simply
    shorter (not padded):
      A. each chunk on its own: its running log decay cum (log a clamped at
         1e-37) and its injected state sum_s exp(cum_last - cum_s) x_s (x) b_s;
      B. the carry: h = h exp(cum_last) + h_in over the chunks from h0, each
         chunk's start state kept;
      C. each ``tile``-row t tile of a chunk on its own: exp(cum_t) (c_t .
         h_start), plus, for each s tile at or below it, the gate (c_t . b_s)
         exp(cum_t - cum_s) formed only for s <= t, times x_s."""
    B, S, H, P = x.shape
    xf, af, bf, cf = (t.float() for t in (x, a, b, c))
    h = torch.zeros(B, H, P, b.shape[-1]) if h0 is None else h0.float()
    if S == 1:
        h = h * af[:, 0, :, None, None] + xf[:, 0, :, :, None] * bf[:, 0, :, None, :]
        return torch.einsum("bhpn,bhn->bhp", h, cf[:, 0])[:, None].to(x.dtype), h
    Q = min(chunk, S)
    bounds = [(c0, min(c0 + Q, S)) for c0 in range(0, S, Q)]
    cums, h_in = [], []
    for c0, c1 in bounds:                                               # pass A
        cum = torch.cumsum(torch.log(torch.clamp(af[:, c0:c1], min=1e-37)), dim=1)  # (B,L,H)
        w = torch.exp(cum[:, -1:] - cum)
        h_in.append(torch.einsum("bshp,bshn->bhpn", xf[:, c0:c1], bf[:, c0:c1] * w[..., None]))
        cums.append(cum)
    starts = []
    for cum, inj in zip(cums, h_in):                                    # pass B
        starts.append(h)
        h = h * torch.exp(cum[:, -1])[..., None, None] + inj
    y = torch.empty(B, S, H, P)
    for (c0, c1), cum, h_start in zip(bounds, cums, starts):            # pass C
        for t0 in range(0, c1 - c0, tile):
            t1 = min(t0 + tile, c1 - c0)
            ct = cf[:, c0 + t0:c0 + t1]
            acc = torch.exp(cum[:, t0:t1])[..., None] * torch.einsum("bthn,bhpn->bthp", ct, h_start)
            for s0 in range(0, t0 + 1, tile):
                s1 = min(s0 + tile, c1 - c0)
                dots = torch.einsum("bthn,bshn->btsh", ct, bf[:, c0 + s0:c0 + s1])
                below = (torch.arange(s0, s1)[None, :] <= torch.arange(t0, t1)[:, None])
                diff = cum[:, t0:t1, None] - cum[:, None, s0:s1]        # (B,Lt,Ls,H)
                gate = torch.exp(diff.masked_fill(~below[None, :, :, None], float("-inf")))
                acc = acc + torch.einsum("btsh,bshp->bthp", dots * gate, xf[:, c0 + s0:c0 + s1])
            y[:, c0 + t0:c0 + t1] = acc
    return y.to(x.dtype), h


def ssd_inputs(B, S, H, P, N, seed=0):
    """The reference test's distributions: a = sigmoid(normal + 2) in (0, 1),
    b and c scaled by 0.3, h0 by 0.2."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    a = (1 / (1 + np.exp(-(rng.standard_normal((B, S, H)) + 2.0)))).astype(np.float32)
    b = (rng.standard_normal((B, S, H, N)) * 0.3).astype(np.float32)
    c = (rng.standard_normal((B, S, H, N)) * 0.3).astype(np.float32)
    h0 = (rng.standard_normal((B, H, P, N)) * 0.2).astype(np.float32)
    return x, a, b, c, h0


def f32(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


# (B, S, H, P, N), chunk: the reference's sweep, a ragged last chunk, S = Q + 1,
# S < Q, one step, and chunks of several output tiles.
SWEEP = ([(shape, chunk) for shape in [(2, 96, 3, 16, 8), (1, 64, 1, 8, 4)]
          for chunk in (16, 32, 40, 96)]
         + [((2, 100, 3, 16, 8), 32), ((1, 65, 2, 16, 8), 64), ((2, 50, 3, 16, 8), 64),
            ((2, 1, 3, 16, 8), 256), ((1, 200, 2, 24, 8), 96)])


@pytest.mark.parametrize("tile", [TILE, 16])
@pytest.mark.parametrize("with_h0", [True, False])
@pytest.mark.parametrize("shape,chunk", SWEEP, ids=str)
def test_chunk_parallel_scan_matches_pallas_and_sequential(shape, chunk, with_h0, tile):
    x, a, b, c, h0 = ssd_inputs(*shape)
    h0 = h0 if with_h0 else None
    jargs = [jnp.asarray(v) for v in (x, a, b, c)]
    jh0 = None if h0 is None else jnp.asarray(h0)
    y, h = chunk_parallel_scan(*(torch.from_numpy(v) for v in (x, a, b, c)),
                               None if h0 is None else torch.from_numpy(h0),
                               chunk=chunk, tile=tile)
    assert y.dtype == torch.float32 and y.shape == shape[:4]
    assert h.dtype == torch.float32 and h.shape == (shape[0], shape[2], shape[3], shape[4])
    for want_y, want_h in (ssd_scan_pallas(*jargs, jh0, chunk=chunk, interpret=True),
                           jax_ref.ssd_scan(*jargs, jh0)):
        np.testing.assert_allclose(f32(y), f32(want_y), **SSD)
        np.testing.assert_allclose(f32(h), f32(want_h), **SSD)


@pytest.mark.parametrize("with_h0", [True, False])
@pytest.mark.parametrize("shape,chunk", [((2, 96, 3, 16, 8), 32), ((2, 100, 3, 64, 16), 32),
                                         ((2, 65, 3, 64, 16), 64), ((2, 1, 3, 64, 16), 256)],
                         ids=str)
def test_chunk_parallel_scan_production_dtype_mix(shape, chunk, with_h0):
    """x and c bf16, a and b f32, h0 f32, as the bf16 model hands them over:
    y (bf16) at 2e-2, h_final (f32) at 5e-5."""
    x, a, b, c, h0 = ssd_inputs(*shape)
    h0 = h0 if with_h0 else None
    jh0 = None if h0 is None else jnp.asarray(h0)
    y_pal, h_pal = ssd_scan_pallas(jnp.asarray(x, jnp.bfloat16), jnp.asarray(a), jnp.asarray(b),
                                   jnp.asarray(c, jnp.bfloat16), jh0, chunk=chunk, interpret=True)
    y, h = chunk_parallel_scan(torch.from_numpy(x).bfloat16(), torch.from_numpy(a),
                               torch.from_numpy(b), torch.from_numpy(c).bfloat16(),
                               None if h0 is None else torch.from_numpy(h0), chunk=chunk)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    np.testing.assert_allclose(f32(y), f32(y_pal), **BF16)
    np.testing.assert_allclose(f32(h), f32(h_pal), **SSD)


@pytest.mark.parametrize("with_h0", [True, False])
@pytest.mark.parametrize("shape,chunk", [((2, 96, 3, 16, 8), 32), ((2, 100, 3, 64, 16), 32),
                                         ((2, 65, 3, 64, 16), 64), ((1, 70, 2, 100, 32), 256),
                                         ((1, 300, 2, 64, 16), 256)],  # four tiles a chunk
                         ids=str)
@pytest.mark.parametrize("c_dtype", ["bfloat16", "float32"])
def test_ssd_bf16_scheme_matches_pallas(shape, chunk, with_h0, c_dtype):
    """The tensor-core output pass's arithmetic (``ref.ssd_scan_bf16_scheme``)
    for bf16 x: rounded to bf16 it holds the Pallas kernel and the
    sequential oracle at the reference's 2e-2, its h_final at 5e-5; before
    that rounding it lies within y's own rounding (2^-8 of the value plus
    2^-12 of max|y|) of the f32 chunked scan on the same values."""
    x, a, b, c, h0 = ssd_inputs(*shape)
    x = torch.from_numpy(x).bfloat16().float().numpy()  # values a bf16 x holds
    if c_dtype == "bfloat16":
        c = torch.from_numpy(c).bfloat16().float().numpy()
    h0 = h0 if with_h0 else None
    jh0 = None if h0 is None else jnp.asarray(h0)
    tx = torch.from_numpy(x).bfloat16()
    targs = (torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c))
    th0 = None if h0 is None else torch.from_numpy(h0)
    y32, h = ref.ssd_scan_bf16_scheme(tx, *targs, th0, chunk=chunk)
    assert y32.dtype == torch.float32 and y32.shape == shape[:4] and h.dtype == torch.float32
    jargs = [jnp.asarray(v) for v in (x, a, b, c)]
    for want_y, want_h in (ssd_scan_pallas(*jargs, jh0, chunk=chunk, interpret=True),
                           jax_ref.ssd_scan(*jargs, jh0)):
        np.testing.assert_allclose(f32(y32.bfloat16()), f32(want_y), **BF16)
        np.testing.assert_allclose(f32(h), f32(want_h), **SSD)
    exact, _ = ssd_scan_chunked(tx.float(), *targs, th0, chunk=chunk)
    lim = 2.0 ** -8 * exact.abs() + 2.0 ** -12 * exact.abs().max()
    assert ((y32 - exact).abs() <= lim).all()


# ---- the host plan ----------------------------------------------------------

@pytest.mark.parametrize("B,S,H,P,N,chunk", [(4, 1536, 50, 64, 16, 256),   # hymba's prefill
                                             (4, 1024, 50, 64, 16, 256)])
def test_plan_fills_the_card_at_serving_shapes(B, S, H, P, N, chunk):
    plan = ssd_plan(B, S, H, P, N, chunk)
    states, carry, outputs = plan.grid
    assert not plan.step and B * H < 2 * H100_SMS
    assert states == B * H * plan.chunks > 2 * H100_SMS
    assert outputs == states * plan.tiles > 2 * H100_SMS
    assert carry * 256 >= B * H * P * N


@pytest.mark.parametrize("S", [1, 2, 63, 64, 65, 256, 257, 1536])
@pytest.mark.parametrize("chunk", [1, 16, 256])
def test_plan_takes_the_step_kernel_only_at_one_step(S, chunk):
    B, H, P, N = 4, 50, 64, 16
    plan = ssd_plan(B, S, H, P, N, chunk)
    assert plan.step == (S == 1)
    if plan.step:
        assert plan.grid[:2] == (0, 0) and plan.grid[2] * 256 >= B * H * P * step_team(N)
        assert plan.team == step_team(N)
        return
    assert plan.team == 0
    assert plan.chunk == min(chunk, S) and (plan.chunks - 1) * plan.chunk < S
    assert plan.chunks * plan.chunk >= S and plan.tiles * TILE >= plan.chunk
    assert plan.grid == (B * H * plan.chunks, -(-B * H * P * N // 256),
                         B * H * plan.chunks * plan.tiles)


@pytest.mark.parametrize("N,team", [(1, 1), (4, 1), (5, 2), (8, 2), (16, 4), (17, 8), (64, 16)])
def test_step_team_covers_the_state_row(N, team):
    assert step_team(N) == team and 4 * team >= N and (team == 1 or 4 * team < 2 * N + 4)
