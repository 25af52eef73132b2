"""The port's hand-written CUDA kernels against their plain versions, on the
card (the flash backward among them, against ``ref.attention_bwd``).  Every
test here carries the ``gpu`` marker and skips where there is no CUDA
device; the file imports neither jax nor the reference, so it runs on a
machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Shapes and tolerances are the reference's sweep (``tests/test_kernels.py``:
f32 3e-5, bf16 2e-2, SSD 5e-5), plus rows and caches with no valid key, and
for the SSD scan a ragged last chunk, one decode step, no initial state and
the production dtype mix.  The placement path's f64 DP sweep must equal its
plain version bit for bit, and a batched solve the sequential one; the
byte-moving transports echo tensors on the card byte for byte.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as C
from repro_torch import core as placement
from repro_torch.device import resolve_device
from repro_torch.kernels import ref
from repro_torch.kernels.chunked import ssd_scan_chunked
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.dp_sweep import MAX_K, dp_sweep, sm_count, sweep_plan
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_bwd
from repro_torch.kernels import ssm_scan as ss
from repro_torch.kernels.ssm_scan import ssd_scan, ssd_scan_bwd
from repro_torch.exec import ExecutionEngine, compile_plan, layer_fns_for
from repro_torch.models import init_params
from repro_torch.runtime import ServeConfig, Server, make_decode_step, make_prefill_step

pytestmark = pytest.mark.gpu

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
FLASH_CASES = [  # B, Sq, Skv, Hq, Hkv, D, causal, window, kv_offset
    (2, 128, 128, 4, 2, 64, True, None, 0),
    (1, 100, 100, 3, 1, 32, True, None, 0),
    (2, 64, 192, 4, 4, 64, True, None, 128),
    (1, 256, 256, 8, 2, 64, True, 64, 0),
    (2, 128, 128, 4, 2, 64, False, None, 0),
    (1, 64, 64, 2, 2, 128, True, None, 0),
    # rows with no valid key: the plain version's uniform softmax over -1e30
    (1, 64, 64, 2, 1, 64, True, 8, 100),
    (1, 70, 70, 2, 1, 32, True, None, -5),
    # served head layouts at length: the cp.async ring over many tiles, causal
    # and window band skipping, and a ragged Sq
    (1, 1024, 1024, 16, 8, 128, True, None, 0),
    (1, 1536, 1536, 25, 5, 64, True, 1024, 0),
    (1, 1000, 1000, 4, 2, 128, True, None, 0),
    # h2o-danube3's head dim 120 (the bf16 tiles padded to 128), g = 4: a
    # ragged Sq under a window, a kv_offset, rows with no valid key, and the
    # window binding at length; phi3-vision's 96/96, g = 1
    (1, 100, 100, 8, 2, 120, True, 32, 0),
    (2, 48, 176, 8, 2, 120, True, None, 128),
    (1, 64, 64, 4, 1, 120, True, 8, 100),
    (1, 1100, 1100, 8, 2, 120, True, 1024, 0),
    (2, 130, 130, 4, 4, 96, True, None, 0),
    (1, 1024, 1024, 8, 8, 96, True, None, 0),
]
DECODE_CASES = [  # B, Smax, Hq, Hkv, D, valid length
    (2, 256, 4, 2, 64, 100), (3, 100, 6, 6, 32, 100),
    (2, 512, 8, 2, 128, 511), (1, 64, 4, 1, 64, 64),
    (2, 96, 4, 2, 64, 0),
    # split-K at length: few (b, kvh) pairs, no valid slot, hymba's ring
    (1, 4096, 8, 1, 128, 4000), (1, 4096, 4, 2, 64, 0), (4, 1024, 25, 5, 64, 1024),
    # head dim 120 (15 16-byte chunks in bf16 over 16 lanes, 30 in f32 over
    # 32, the last lanes' chunks off) at g 4, danube's ring, no valid slot;
    # phi3-vision's 96/96 at g 1
    (2, 300, 8, 2, 120, 290), (2, 4096, 32, 8, 120, 4096), (2, 96, 8, 2, 120, 0),
    (2, 1089, 4, 4, 96, 1088), (1, 200, 8, 1, 96, 150),
]
RMSNORM_SHAPES = [(4, 37, 256), (2, 8, 64), (1, 1, 512), (4096, 2048), (4, 3200),
                  # the scalar path (d = 100 in bf16), the served widths, a row
                  # shared by several warps
                  (5, 100), (6144, 1600), (6144, 3200), (3, 7, 8192)]
SSD_CASES = ([(shape, chunk) for shape in [(2, 96, 3, 16, 8), (1, 64, 1, 8, 4)]
              for chunk in (16, 32, 40, 96)]   # (B, S, H, P, N), chunk
             + [((2, 100, 3, 16, 8), 32), ((2, 1, 3, 16, 8), 256), ((2, 300, 3, 64, 16), 256),
                ((1, 70, 2, 100, 32), 64),
                # S = Q + 1, many chunks, the widest head and state, S < Q
                ((2, 257, 3, 64, 16), 256), ((1, 1000, 2, 64, 16), 64),
                ((1, 130, 2, 128, 64), 64), ((1, 70, 2, 100, 32), 256)])


def tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" else dict(rtol=3e-5, atol=3e-5)


def normal(seed, *shape, dtype=torch.float32, device="cuda"):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(a).to(device=device, dtype=dtype)


def f32(t):
    return t.float().cpu().numpy()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only there")
    return resolve_device("cuda")


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,D,causal,window,off", FLASH_CASES)
def test_flash_attention_kernel_matches_plain(cuda, B, Sq, Skv, Hq, Hkv, D, causal, window,
                                              off, name):
    dt = DTYPES[name]
    q, k, v = (normal(i, B, s, h, D, dtype=dt)
               for i, (s, h) in enumerate([(Sq, Hq), (Skv, Hkv), (Skv, Hkv)]))
    kw = dict(causal=causal, window=window, kv_offset=off)
    n0 = flash_attention.n_launches
    got = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.n_launches == n0 + 1
    assert got.dtype == dt and got.shape == q.shape
    np.testing.assert_allclose(f32(got), f32(ref.attention(q, k, v, **kw)), **tol(name))


@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,D,causal,window,off", FLASH_CASES)
def test_flash_attention_bf16_kernel_matches_its_scheme(cuda, B, Sq, Skv, Hq, Hkv, D, causal,
                                                        window, off):
    """The bf16 kernel against its own arithmetic in f32
    (``ref.attention_bf16_scheme``), within the kernel's one rounding of the
    output to bf16: far tighter than the bf16 sweep's 2e-2."""
    q, k, v = (normal(i, B, s, h, D, dtype=torch.bfloat16)
               for i, (s, h) in enumerate([(Sq, Hq), (Skv, Hkv), (Skv, Hkv)]))
    kw = dict(causal=causal, window=window, kv_offset=off)
    got = flash_attention(q, k, v, **kw)
    want = ref.attention_bf16_scheme(q, k, v, **kw)
    np.testing.assert_allclose(f32(got), f32(want), rtol=2.0 ** -8,
                               atol=2.0 ** -12 * want.abs().max().item())


def test_flash_attention_kernel_takes_strided_v(cuda):
    """v as a slice of a fused projection, as the model passes it."""
    qkv = normal(0, 2, 96, 4 + 2 * 2, 64)
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
    assert not v.is_contiguous()
    got = flash_attention(q, k, v)
    np.testing.assert_allclose(f32(got), f32(ref.attention(q, k, v)), **tol("float32"))


@pytest.mark.parametrize("name", list(DTYPES))
def test_flash_attention_kernel_negative_scale(cuda, name):
    """The bf16 kernel keeps its row max unscaled and takes |scale|, flipping
    the sign of Q for a negative one."""
    dt = DTYPES[name]
    q, k, v = (normal(i, 1, 96, 4, 64, dtype=dt) for i in range(3))
    kw = dict(window=40, scale=-0.2)
    np.testing.assert_allclose(f32(flash_attention(q, k, v, **kw)),
                               f32(ref.attention(q, k, v, **kw)), **tol(name))


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("B,Smax,Hq,Hkv,D,ln", DECODE_CASES)
def test_decode_attention_kernel_matches_plain(cuda, B, Smax, Hq, Hkv, D, ln, name):
    dt = DTYPES[name]
    q, kc, vc = (normal(0, B, Hq, D, dtype=dt), normal(1, B, Smax, Hkv, D, dtype=dt),
                 normal(2, B, Smax, Hkv, D, dtype=dt))
    got = decode_attention(q, kc, vc, ln)
    torch.cuda.synchronize()
    np.testing.assert_allclose(f32(got), f32(ref.decode_attention(q, kc, vc, ln)), **tol(name))


def test_decode_attention_kernel_per_seq_lengths(cuda):
    q, kc, vc = normal(0, 3, 4, 32), normal(1, 3, 128, 2, 32), normal(2, 3, 128, 2, 32)
    lens = torch.tensor([5, 77, 128], dtype=torch.int32, device=cuda)
    got = decode_attention(q, kc, vc, lens)
    np.testing.assert_allclose(f32(got), f32(ref.decode_attention(q, kc, vc, lens)),
                               rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("D", [128, 120, 96])
@pytest.mark.parametrize("name", list(DTYPES))
def test_decode_attention_kernel_per_seq_lengths_split_k(cuda, name, D):
    """Device lengths size the splits from Smax: the short sequences' later
    splits lie wholly past their lengths and must weigh nothing."""
    dt = DTYPES[name]
    q, kc, vc = (normal(0, 3, 8, D, dtype=dt), normal(1, 3, 4096, 2, D, dtype=dt),
                 normal(2, 3, 4096, 2, D, dtype=dt))
    lens = torch.tensor([1, 700, 4096], dtype=torch.int32, device=cuda)
    n0 = decode_attention.n_launches
    got = decode_attention(q, kc, vc, lens)
    torch.cuda.synchronize()
    assert decode_attention.n_launches == n0 + 1
    np.testing.assert_allclose(f32(got), f32(ref.decode_attention(q, kc, vc, lens)), **tol(name))


# MLA's split head dims: q and k of 96 (qk_nope 64 + qk_rope 32), v of 64.
MLA_FLASH_CASES = [  # B, Sq, Skv, Hq, Hkv, causal, window, kv_offset
    (2, 128, 128, 4, 4, True, None, 0),
    (1, 100, 100, 3, 3, True, None, 0),        # ragged Sq
    (2, 64, 192, 4, 4, False, None, 0),
    (1, 256, 256, 4, 2, True, 64, 0),          # windowed, g = 2
    (1, 64, 64, 2, 1, True, 8, 100),           # rows with no valid key
    (1, 1024, 1024, 8, 8, True, None, 0),      # the served layout at length
]
MLA_SCALE = 96 ** -0.5


def mla_qkv(B, Sq, Skv, Hq, Hkv, dtype, seed=0):
    """q and k of 96, and v of 64 as MLA passes it: a strided slice of the
    (B, Skv, Hkv, 64 + 64) wkv_b product."""
    q = normal(seed, B, Sq, Hq, 96, dtype=dtype)
    k = normal(seed + 1, B, Skv, Hkv, 96, dtype=dtype)
    v = normal(seed + 2, B, Skv, Hkv, 128, dtype=dtype)[..., 64:]
    assert not v.is_contiguous()
    return q, k, v


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,causal,window,off", MLA_FLASH_CASES)
def test_flash_attention_kernel_mla_head_dims_match_plain(cuda, B, Sq, Skv, Hq, Hkv, causal,
                                                          window, off, name):
    """(DK, DV) = (96, 64) at MLA's scale: f32 3e-5, bf16 2e-2 against the
    plain version, and bf16 within its output rounding of its own
    arithmetic in f32."""
    q, k, v = mla_qkv(B, Sq, Skv, Hq, Hkv, DTYPES[name])
    kw = dict(causal=causal, window=window, kv_offset=off, scale=MLA_SCALE)
    n0 = flash_attention.n_launches
    got = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.n_launches == n0 + 1
    assert got.shape == (B, Sq, Hq, 64) and got.dtype == q.dtype
    np.testing.assert_allclose(f32(got), f32(ref.attention(q, k, v, **kw)), **tol(name))
    if name == "bfloat16":
        want = ref.attention_bf16_scheme(q, k, v, **kw)
        np.testing.assert_allclose(f32(got), f32(want), rtol=2.0 ** -8,
                                   atol=2.0 ** -12 * want.abs().max().item())


@pytest.mark.parametrize("D,DV", [(64, 64), (96, 64), (120, 120), (96, 96)])
def test_flash_attention_bf16_kernel_matches_its_scheme_at_a_given_scale(cuda, D, DV):
    """``attention_bf16_scheme`` takes the caller's scale (here neither
    D^-0.5 nor positive) and v's own head dim."""
    q, k = normal(0, 1, 200, 4, D, dtype=torch.bfloat16), normal(1, 1, 200, 2, D,
                                                                 dtype=torch.bfloat16)
    v = normal(2, 1, 200, 2, DV, dtype=torch.bfloat16)
    for scale in (0.37, -0.2):
        got = flash_attention(q, k, v, window=90, scale=scale)
        want = ref.attention_bf16_scheme(q, k, v, window=90, scale=scale)
        assert want.shape == got.shape == (1, 200, 4, DV)
        np.testing.assert_allclose(f32(got), f32(want), rtol=2.0 ** -8,
                                   atol=2.0 ** -12 * want.abs().max().item())


MLA_DECODE_CASES = [  # B, Smax, Hq, Hkv, DK, DV, valid length
    (2, 256, 4, 4, 96, 64, 100), (1, 64, 2, 1, 96, 64, 64), (2, 96, 4, 2, 96, 64, 0),
    (4, 1089, 40, 40, 96, 64, 1088),           # minicpm3's last step, g = 1
    (2, 256, 6, 2, 64, 64, 100),               # g = 3 on the G = 4 instantiation
    (4, 1089, 24, 8, 64, 64, 1088),            # granite's last step, g = 3
]


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("B,Smax,Hq,Hkv,DK,DV,ln", MLA_DECODE_CASES)
def test_decode_attention_kernel_mla_and_group_3_match_plain(cuda, B, Smax, Hq, Hkv, DK, DV,
                                                             ln, name):
    """MLA's (96, 64) with v a strided slice of the re-expanded latent, and
    granite's g = 3, against the plain version."""
    dt = DTYPES[name]
    q, kc = normal(0, B, Hq, DK, dtype=dt), normal(1, B, Smax, Hkv, DK, dtype=dt)
    vc = normal(2, B, Smax, Hkv, DK + DV, dtype=dt)[..., DK:] if DK != DV else \
        normal(2, B, Smax, Hkv, DV, dtype=dt)
    scale = DK ** -0.5 if DK == DV else MLA_SCALE
    n0 = decode_attention.n_launches
    got = decode_attention(q, kc, vc, ln, scale=scale)
    torch.cuda.synchronize()
    assert decode_attention.n_launches == n0 + 1
    assert got.shape == (B, Hq, DV) and got.dtype == dt
    np.testing.assert_allclose(f32(got), f32(ref.decode_attention(q, kc, vc, ln, scale=scale)),
                               **tol(name))


@pytest.mark.parametrize("name", list(DTYPES))
def test_decode_attention_kernel_mla_per_seq_lengths(cuda, name):
    dt = DTYPES[name]
    q, kc = normal(0, 3, 8, 96, dtype=dt), normal(1, 3, 2048, 8, 96, dtype=dt)
    vc = normal(2, 3, 2048, 8, 128, dtype=dt)[..., 64:]
    lens = torch.tensor([1, 700, 2048], dtype=torch.int32, device=cuda)
    got = decode_attention(q, kc, vc, lens)
    np.testing.assert_allclose(f32(got), f32(ref.decode_attention(q, kc, vc, lens)), **tol(name))


def test_mla_kernel_path_matches_plain_at_served_widths(cuda):
    """One minicpm3 layer's shapes end to end (prefill then a decode step)
    with bf16 weights: kernel path against plain within 2e-2 of max|plain|."""
    cfg = dataclasses.replace(C.production_cfg(C.get_config("minicpm3_4b")), n_layers=1,
                              vocab=1000)
    params = init_params(0, cfg, device=cuda)
    B, S = 2, 96
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (B, S))).to(cuda)
    with torch.inference_mode():
        (kl, kc), (pl, pc) = [make_prefill_step(cfg, S + 2, plain=p)(params, {"tokens": toks})
                              for p in (False, True)]
        assert kc[0]["latent"].shape == (B, S + 2, 288)
        assert (kl - pl).abs().max() <= 2e-2 * pl.abs().max()
        tok = toks[:, -1:]
        (kl, _), (pl, _) = [make_decode_step(cfg, plain=p)(params, tok, c, S)
                            for p, c in ((False, kc), (True, pc))]
        assert (kl - pl).abs().max() <= 2e-2 * pl.abs().max()


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("shape", RMSNORM_SHAPES)
def test_rmsnorm_kernel_matches_plain(cuda, shape, name):
    x = normal(0, *shape, dtype=DTYPES[name])
    s = normal(1, shape[-1]) * 0.1 + 1
    got = rmsnorm(x, s)
    torch.cuda.synchronize()
    assert got.dtype == x.dtype
    np.testing.assert_allclose(f32(got), f32(ref.rmsnorm(x, s)), **tol(name))


@pytest.mark.parametrize("name", list(DTYPES))
def test_rmsnorm_kernel_takes_scale_in_the_other_dtype(cuda, name):
    x = normal(0, 64, 2048, dtype=DTYPES[name])
    s = (normal(1, 2048) * 0.1 + 1).to(torch.bfloat16 if name == "float32" else torch.float32)
    got = rmsnorm(x, s)
    assert rmsnorm.last_plan.vec == 16 // x.element_size()
    np.testing.assert_allclose(f32(got), f32(ref.rmsnorm(x, s)), **tol(name))


@pytest.mark.parametrize("name", list(DTYPES))
def test_rmsnorm_kernel_offset_view_takes_the_scalar_path(cuda, name):
    """A contiguous view with a storage offset is not 16-byte aligned."""
    flat = normal(0, 1 + 6 * 2048, dtype=DTYPES[name])
    x, s = flat[1:].view(6, 2048), normal(1, 2048) * 0.1 + 1
    got = rmsnorm(x, s)
    assert rmsnorm.last_plan.vec == 1
    np.testing.assert_allclose(f32(got), f32(ref.rmsnorm(x, s)), **tol(name))


# ---------------------------------------------------------------------------
# the RMSNorm backward kernel and the gradient refusals
# ---------------------------------------------------------------------------

RMSNORM_BWD_SHAPES = [(4, 37, 256), (2, 8, 64), (1, 1, 512), (4, 3200), (5, 100), (3, 7, 8192),
                      (2048, 2048), (2048, 4096), (4, 4096),
                      # rows a team covers with lanes to spare (1600 bf16: 200 of
                      # 256 vectors), more rows than the grid's teams hold at once
                      # (each team takes several, the next row's loads in flight),
                      # and a block whose teams run out of rows
                      (2048, 1600), (9000, 256), (300, 768), (3, 2048)]


@pytest.mark.parametrize("sname", list(DTYPES))
@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("shape", RMSNORM_BWD_SHAPES)
def test_rmsnorm_bwd_kernel_matches_plain_autograd(cuda, shape, name, sname):
    """dx and dscale against autograd through the plain ``ref.rmsnorm``, each
    at its dtype's tolerance (f32 3e-5, bf16 2e-2) of max|plain|; a second
    launch gives bitwise-equal outputs (dscale's fixed-order sum)."""
    x, g = normal(0, *shape, dtype=DTYPES[name]), normal(2, *shape, dtype=DTYPES[name])
    s = (normal(1, shape[-1]) * 0.1 + 1).to(DTYPES[sname])
    dx, ds = rmsnorm_bwd(x, s, g)
    torch.cuda.synchronize()
    px, ps = ref.rmsnorm_bwd(x, s, g)
    assert dx.dtype == x.dtype and ds.dtype == s.dtype
    for got, want, n in ((dx, px, name), (ds, ps, sname)):
        err = (got.float() - want.float()).abs().max() / want.float().abs().max()
        assert err <= tol(n)["rtol"], (n, err.item())
    dx2, ds2 = rmsnorm_bwd(x, s, g)
    assert torch.equal(ds, ds2) and torch.equal(dx, dx2)


@pytest.mark.parametrize("d,dtype", [(16392, torch.bfloat16), (8196, torch.float32)])
def test_rmsnorm_bwd_refuses_rows_wider_than_a_block_holds(cuda, d, dtype):
    """A row is held in registers by at most 512 threads of 4 accesses each:
    16384 bf16 or 8192 f32 elements on the vector path; wider rows raise
    before any launch."""
    x = normal(0, 2, d, dtype=dtype)
    n0 = rmsnorm_bwd.n_launches
    with pytest.raises(ValueError, match="exceeds"):
        rmsnorm_bwd(x, normal(1, d).to(dtype), x)
    assert rmsnorm_bwd.n_launches == n0


def test_rmsnorm_bwd_kernel_matches_finite_differences(cuda):
    """The gradients the autograd Function returns (the backward kernel)
    against central differences of the forward kernel in f32 at a tiny
    shape, h = 1e-2: truncation ~1e-4 and rounding ~1e-5 of the scale, so
    within 1e-2 of max|grad|."""
    x = normal(0, 3, 16) * 2
    s = normal(1, 16) * 0.1 + 1
    w = normal(2, 3, 16)

    def loss(xx, ss):
        return (rmsnorm(xx, ss) * w).sum()

    xr, sr = x.clone().requires_grad_(True), s.clone().requires_grad_(True)
    gx, gs = torch.autograd.grad(loss(xr, sr), (xr, sr))
    h = 1e-2
    for t, g in ((x, gx), (s, gs)):
        fd = torch.zeros_like(t)
        for i in range(t.numel()):
            e = torch.zeros_like(t).view(-1)
            e[i] = h
            e = e.view_as(t)
            up = loss(x + e, s) if t is x else loss(x, s + e)
            dn = loss(x - e, s) if t is x else loss(x, s - e)
            fd.view(-1)[i] = (up - dn) / (2 * h)
        assert (fd - g).abs().max() <= 1e-2 * g.abs().max()


def test_rmsnorm_launch_counts_under_checkpoint(cuda):
    """Through ``torch.utils.checkpoint`` (non-reentrant) each norm launches
    its forward kernel twice (run and recompute) and its backward once;
    without grad, the forward once and no Function."""
    from torch.utils.checkpoint import checkpoint
    x = normal(0, 64, 256).requires_grad_(True)
    s = (normal(1, 256) * 0.1 + 1).requires_grad_(True)
    rmsnorm.n_launches = rmsnorm_bwd.n_launches = 0
    y = checkpoint(lambda a, b: rmsnorm(rmsnorm(a, b), b) * 2, x, s, use_reentrant=False)
    got = torch.autograd.grad(y.sum(), (x, s))
    assert (rmsnorm.n_launches, rmsnorm_bwd.n_launches) == (4, 2)
    want = torch.autograd.grad((ref.rmsnorm(ref.rmsnorm(x, s), s) * 2).sum(), (x, s))
    for a, b in zip(got, want):
        np.testing.assert_allclose(f32(a), f32(b), rtol=3e-5, atol=3e-5 * f32(b).max())
    with torch.no_grad():
        out = rmsnorm(x, s)
    assert out.grad_fn is None and rmsnorm.n_launches == 5 and rmsnorm_bwd.n_launches == 2


def test_forward_only_kernels_refuse_gradients(cuda):
    """Decode attention and the DP sweep have no backward kernel: given an
    input that requires grad, with grad mode on, each wrapper raises
    NotImplementedError naming itself, before any launch; under no_grad the
    same call runs.  (Flash attention and the SSD scan have their backward
    kernels: ``test_flash_attention_function_launches_the_backward``,
    ``test_ssd_scan_function_launches_the_backward``.)"""
    qd, kc = normal(1, 1, 2, 32).requires_grad_(True), normal(2, 1, 8, 2, 32)
    calls = {
        "decode_attention": (decode_attention, lambda: decode_attention(qd, kc, kc, 4)),
    }
    spb = torch.rand(8, 8, dtype=torch.float64, device="cuda").requires_grad_(True)
    cand = torch.zeros((1, 3, 4), dtype=torch.int64, device="cuda")
    calls["dp_sweep"] = (dp_sweep, lambda: dp_sweep(
        spb, torch.ones(2, dtype=torch.float64, device="cuda"), 1.0,
        torch.zeros(1, dtype=torch.int64, device="cuda"), cand, torch.ones_like(cand, dtype=bool)))
    for name, (wrapper, call) in calls.items():
        n0 = wrapper.n_launches
        with pytest.raises(NotImplementedError, match=name):
            call()
        assert wrapper.n_launches == n0, name
        with torch.no_grad():
            call()
        assert wrapper.n_launches == n0 + 1, name


# the flash-attention backward kernel

BWD_CASES = [  # B, Sq, Skv, Hq, Hkv, causal, window, kv_offset
    (2, 100, 100, 4, 2, True, None, 0),     # GQA, a ragged last tile
    (1, 70, 130, 6, 2, True, None, 60),     # Skv past Sq, a kv_offset, g 3
    (1, 77, 77, 3, 1, True, 20, 0),         # a window
    (1, 40, 90, 4, 4, False, None, 0),      # non-causal, ragged
    (1, 50, 60, 4, 1, True, 16, -10),       # rows with no valid key (leading)
    (1, 33, 40, 2, 2, False, 8, 45),        # rows with no valid key (trailing)
    (1, 300, 300, 8, 2, True, None, 0),     # several tiles each way
]


def bwd_inputs(B, Sq, Skv, Hq, Hkv, dk, dv, dtype, seed=0):
    q, k = normal(seed, B, Sq, Hq, dk, dtype=dtype), normal(seed + 1, B, Skv, Hkv, dk, dtype=dtype)
    v = (normal(seed + 2, B, Skv, Hkv, dv, dtype=dtype) if dk == dv else
         normal(seed + 2, B, Skv, Hkv, dk + dv, dtype=dtype)[..., dk:])  # MLA: v strided
    return q, k, v, normal(seed + 3, B, Sq, Hq, dv, dtype=dtype)


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("case", BWD_CASES, ids=str)
@pytest.mark.parametrize("dk,dv", [(32, 32), (64, 64), (128, 128), (120, 120), (96, 96),
                                   (96, 64)], ids=str)
def test_flash_attention_bwd_kernel_matches_plain(cuda, dk, dv, case, name):
    """dq, dk and dv against ``ref.attention_bwd`` on the forward kernel's
    own o and lse: f32 within 3e-5 x max|plain|; bf16 within 1.25 x the
    plain bf16 path's distance from the plain f32 closed form (both round
    the same f32 values to bf16).  Two launches are bitwise equal (no
    atomics), and o is the same to the bit with and without the lse."""
    from repro_torch.kernels import flash_attention as fa
    B, Sq, Skv, Hq, Hkv, causal, window, off = case
    dt = DTYPES[name]
    q, k, v, do = bwd_inputs(B, Sq, Skv, Hq, Hkv, dk, dv, dt)
    kw = dict(causal=causal, window=window, kv_offset=off)
    o0, _ = fa._forward(q, k, v, causal, window, dk ** -0.5, off, False)
    o, lse = fa._forward(q, k, v, causal, window, dk ** -0.5, off, True)
    assert torch.equal(o0, o)
    torch.testing.assert_close(lse, ref.attention_lse(q, k, **kw), rtol=1e-5, atol=1e-5)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    again = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    plain = ref.attention_bwd(q, k, v, o, lse, do, **kw)
    want = ref.attention_bwd(*(t.float() for t in (q, k, v, o)), lse, do.float(), **kw)
    for g, pl, w, t in zip(got, plain, want, (q, k, v)):
        assert g.shape == t.shape and g.dtype == dt and g.is_contiguous()
        err = float(np.abs(f32(g) - f32(w)).max())
        scale = max(float(np.abs(f32(w)).max()), 1e-30)
        if name == "float32":
            assert err <= 3e-5 * scale
        else:
            assert err <= 1.25 * float(np.abs(f32(pl) - f32(w)).max()) + 1e-7 * scale


def test_flash_attention_function_launches_the_backward(cuda):
    """A grad-requiring CUDA input runs the forward kernel under the
    autograd Function (no refusal) and its backward launches the backward
    kernel, never the plain version; under ``torch.utils.checkpoint`` two
    forward launches and one backward; the gradients are autograd's through
    ``ref.attention``; a double backward raises."""
    from torch.utils.checkpoint import checkpoint
    from repro_torch.kernels import flash_attention as fa
    q, k, v = (normal(i, 2, 96, h, 64).requires_grad_(True) for i, h in enumerate((6, 2, 2)))
    fa.flash_attention.n_launches = fa.flash_attention_bwd.n_launches = 0
    y = checkpoint(lambda a, b, c: fa.flash_attention(a, b, c, window=40) ** 2, q, k, v,
                   use_reentrant=False)
    got = torch.autograd.grad(y.sum(), (q, k, v))
    assert (fa.flash_attention.n_launches, fa.flash_attention_bwd.n_launches) == (2, 1)
    want = torch.autograd.grad((ref.attention(q, k, v, window=40) ** 2).sum(), (q, k, v))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=3e-5, atol=3e-5 * float(np.abs(f32(b)).max()))
    y = fa.flash_attention(q, k, v)
    with pytest.raises(NotImplementedError, match="double backward"):
        torch.autograd.grad(y.sum(), (q,), create_graph=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reduced_internlm2_trains_on_the_card(cuda, dtype):
    """internlm2 reduced (2 layers, d 256) trains on the card: with remat,
    per step two forward and one backward launch of flash attention a
    layer, the norms likewise; the loss and gradient of the kernel path
    against the plain path (f32 at 1e-4 x max|g| a leaf, bf16 finite)."""
    from repro_torch.models import transformer
    from repro_torch.optim import tree_leaves
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.runtime import TrainConfig, init_opt_state, make_train_step
    cfg = C.get_config("internlm2_1p8b").reduced(n_layers=2, d_model=256, vocab=1000)
    cfg = dataclasses.replace(cfg, param_dtype=dtype, compute_dtype=dtype)
    params = init_params(0, cfg, device="cuda")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 1000, (2, 64))).cuda()

    def grads(plain):
        leaves = tree_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        loss, _ = transformer.loss_fn(params, cfg, {"tokens": tokens}, remat=True, plain=plain)
        out = torch.autograd.grad(loss, leaves)
        for t in leaves:
            t.requires_grad_(False)
        return loss, out

    (lk, gk), (lp, gp) = grads(False), grads(True)
    assert torch.isfinite(lk) and all(bool(torch.isfinite(g).all()) for g in gk)
    if dtype == "float32":
        torch.testing.assert_close(lk, lp, rtol=1e-5, atol=1e-5)
        for a, b in zip(gk, gp):
            assert (a - b).abs().max().item() <= 1e-4 * max(b.abs().max().item(), 1e-30)
    step = make_train_step(cfg, TrainConfig())
    opt = init_opt_state(params, TrainConfig())
    fa.flash_attention.n_launches = fa.flash_attention_bwd.n_launches = 0
    for _ in range(2):
        _, opt, m = step(params, opt, {"tokens": tokens})
        assert np.isfinite(m["loss"].item())
    assert (fa.flash_attention.n_launches, fa.flash_attention_bwd.n_launches) == (8, 4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reduced_xlstm_serves_and_trains_on_the_card(cuda, dtype):
    """xLSTM (8 layers, the published 7:1 pattern, d 256) on the card: the
    kernel path's prefill and decode against the plain path (f32 at 1e-4;
    bf16 at 2e-2 of max|logit| with 2 layers, since the cells amplify
    rounding), then two train steps with remat: finite losses, exact norm
    launches (forward 2 x 16 + 1 a step, backward 17)."""
    from repro_torch.runtime import TrainConfig, init_opt_state, make_train_step
    layers = 8 if dtype == "float32" else 2
    cfg = C.get_config("xlstm_1p3b").reduced(n_layers=layers, d_model=256, vocab=1000)
    cfg = dataclasses.replace(cfg, param_dtype=dtype, compute_dtype=dtype)
    params = init_params(0, cfg, device=cuda)
    B, S, steps = 2, 40, 3
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (B, S))).to(cuda)
    out = Server(cfg, params, ServeConfig(max_len=S + steps), device=cuda).generate(
        toks.cpu().numpy(), steps)
    assert out.shape == (B, steps)
    with torch.inference_mode():
        (kl, kc), (pl, pc) = [make_prefill_step(cfg, S + steps, plain=p)(params, {"tokens": toks})
                              for p in (False, True)]
        for i in range(steps + 1):
            if dtype == "float32":
                np.testing.assert_allclose(f32(kl), f32(pl), rtol=1e-4, atol=1e-4)
            else:
                assert (kl - pl).abs().max() <= 2e-2 * pl.abs().max()
            if i == steps:
                break
            ids = torch.from_numpy(out[:, i:i + 1].astype(np.int64)).to(cuda)
            kl, kc = make_decode_step(cfg)(params, ids, kc, S + i)
            pl, pc = make_decode_step(cfg, plain=True)(params, ids, pc, S + i)
    if dtype == "bfloat16":
        return
    tcfg = TrainConfig()
    opt = init_opt_state(params, tcfg)
    step = make_train_step(cfg, tcfg)
    rmsnorm.n_launches = rmsnorm_bwd.n_launches = 0
    for _ in range(2):
        params, opt, m = step(params, opt, {"tokens": toks})
        assert torch.isfinite(m["loss"])
    assert (rmsnorm.n_launches, rmsnorm_bwd.n_launches) == (2 * (2 * 16 + 1), 2 * 17)


def ssd_inputs(B, S, H, P, N, seed=0, device="cuda"):
    """tests/test_kernels.py's distributions: a = sigmoid(normal + 2)."""
    x, a, b, c, h0 = (normal(seed + i, *shape, device=device) for i, shape in
                      enumerate([(B, S, H, P), (B, S, H), (B, S, H, N), (B, S, H, N),
                                 (B, H, P, N)]))
    return x, torch.sigmoid(a + 2.0), b * 0.3, c * 0.3, h0 * 0.2


@pytest.mark.parametrize("with_h0", [True, False])
@pytest.mark.parametrize("shape,chunk", SSD_CASES, ids=str)
def test_ssd_scan_kernel_matches_both_plain_versions(cuda, shape, chunk, with_h0):
    x, a, b, c, h0 = ssd_inputs(*shape)
    h0 = h0 if with_h0 else None
    n0 = ssd_scan.n_launches
    y, h = ssd_scan(x, a, b, c, h0, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_scan.n_launches == n0 + 1
    assert y.dtype == torch.float32 and h.dtype == torch.float32 and y.shape == x.shape
    for want_y, want_h in (ssd_scan_chunked(x, a, b, c, h0, chunk=chunk),
                           ref.ssd_scan(x, a, b, c, h0)):
        np.testing.assert_allclose(f32(y), f32(want_y), rtol=5e-5, atol=5e-5)
        np.testing.assert_allclose(f32(h), f32(want_h), rtol=5e-5, atol=5e-5)


@pytest.mark.parametrize("with_h0", [True, False])
@pytest.mark.parametrize("B,S,H", [(2, 1, 3), (2, 300, 3), (2, 257, 3), (4, 1536, 50)])
def test_ssd_scan_kernel_production_dtype_mix(cuda, B, S, H, with_h0):
    """x and c bf16 (c a strided slice of a fused projection, as the model
    passes it), a and b f32, h0 f32: y at bf16's 2e-2, h_final at 5e-5.  The
    last shape is hymba's served prefill, held to both plain versions."""
    x, a, b, c, h0 = ssd_inputs(B, S, H, 64, 16)
    h0 = h0 if with_h0 else None
    bc = torch.cat([b, c], dim=-1).bfloat16()
    c = bc[..., 16:]
    assert not c.is_contiguous()
    x = x.bfloat16()
    y, h = ssd_scan(x, a, b, c, h0, chunk=256)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    assert (ssd_scan.last_grid[:2] == (0, 0)) == (S == 1)
    for want_y, want_h in (ssd_scan_chunked(x, a, b, c, h0, chunk=256),
                           ref.ssd_scan(x, a, b, c, h0)):
        np.testing.assert_allclose(f32(y), f32(want_y), rtol=2e-2, atol=2e-2)
        np.testing.assert_allclose(f32(h), f32(want_h), rtol=5e-5, atol=5e-5)


@pytest.mark.parametrize("with_h0", [True, False])
@pytest.mark.parametrize("shape,chunk", [((2, 300, 3, 64, 16), 256), ((2, 257, 3, 64, 16), 256),
                                         ((1, 130, 2, 128, 64), 64), ((1, 70, 2, 100, 32), 64),
                                         ((2, 96, 3, 16, 8), 32), ((4, 1536, 50, 64, 16), 256)],
                         ids=str)
def test_ssd_scan_bf16_kernel_matches_its_scheme(cuda, shape, chunk, with_h0):
    """bf16 x runs the output pass on the tensor cores: y against that
    arithmetic in f32 (``ref.ssd_scan_bf16_scheme``), within the kernel's
    one rounding of y to bf16; c both bf16 and f32."""
    x, a, b, c, h0 = ssd_inputs(*shape)
    h0 = h0 if with_h0 else None
    x = x.bfloat16()
    for cc in (c.bfloat16(), c):
        y, _ = ssd_scan(x, a, b, cc, h0, chunk=chunk)
        want, _ = ref.ssd_scan_bf16_scheme(x, a, b, cc, h0, chunk=chunk)
        np.testing.assert_allclose(f32(y), f32(want), rtol=2.0 ** -8,
                                   atol=2.0 ** -12 * want.abs().max().item())


def ssd_bwd_call(x, a, b, c, h0, dy, dh, chunk):
    """The forward kernels with their workspace kept, then the backward
    kernel on it."""
    _, _, saved = ss._forward(x, a, b, c, h0, chunk, True)
    return ssd_scan_bwd(x, a, b, c, h0, dy, dh, chunk=chunk, saved=saved)


@pytest.mark.parametrize("with_dh", [True, False], ids=["dh_final", "no_dh_final"])
@pytest.mark.parametrize("with_h0", [True, False], ids=["h0", "no_h0"])
@pytest.mark.parametrize("shape,chunk", SSD_CASES, ids=str)
def test_ssd_scan_bwd_kernel_matches_plain(cuda, shape, chunk, with_h0, with_dh):
    """The backward kernel in f32 against ``ref.ssd_scan_bwd`` at the scan's
    sweep (a ragged last chunk, one step, S < Q, the widest head and state),
    each gradient within 5e-5 x its max|g|; a second call equal bit for bit
    (no atomics, fixed-order sums)."""
    x, a, b, c, h0 = ssd_inputs(*shape)
    h0 = h0 if with_h0 else None
    dy = normal(9, *x.shape)
    dh = normal(10, shape[0], shape[2], shape[3], shape[4]) if with_dh else None
    n0 = ssd_scan_bwd.n_launches
    got = ssd_bwd_call(x, a, b, c, h0, dy, dh, chunk)
    again = ssd_bwd_call(x, a, b, c, h0, dy, dh, chunk)
    torch.cuda.synchronize()
    assert ssd_scan_bwd.n_launches == n0 + 2
    want = ref.ssd_scan_bwd(x, a, b, c, h0, dy, dh, chunk=chunk)
    for name, g, w, g2 in zip(("dx", "da", "db", "dc", "dh0"), got, want, again):
        if w is None:
            assert g is None and g2 is None
            continue
        assert g.shape == w.shape and g.dtype == w.dtype and torch.equal(g, g2), name
        assert (g - w).abs().max().item() <= 5e-5 * max(w.abs().max().item(), 1e-30), name


@pytest.mark.parametrize("B,S,H", [(2, 1, 3), (2, 300, 3), (1, 4096, 8)])
def test_ssd_scan_bwd_kernel_production_dtype_mix(cuda, B, S, H):
    """bf16 x, c (a strided slice) and dy, f32 a, b and h0, as the train step
    hands them: each gradient in its input's dtype, within the bf16 2e-2 of
    the plain version on the same inputs."""
    x, a, b, c, h0 = ssd_inputs(B, S, H, 64, 16)
    c = torch.cat([b, c], dim=-1).bfloat16()[..., 16:]
    x, dy = x.bfloat16(), normal(11, *x.shape, dtype=torch.bfloat16)
    got = ssd_bwd_call(x, a, b, c, h0, dy, None, 256)
    want = ref.ssd_scan_bwd(x, a, b, c, h0, dy, None, chunk=256)
    for name, g, w in zip(("dx", "da", "db", "dc", "dh0"), got, want):
        assert g.dtype == w.dtype and g.is_contiguous(), name
        assert (g.float() - w.float()).abs().max().item() <= 2e-2 * max(
            w.float().abs().max().item(), 1e-30), name


def test_ssd_scan_function_launches_the_backward(cuda):
    """A grad-requiring input on the card runs ``_SsdScanFunction``: two
    chained scans launch the forward twice and the backward twice, four and
    two under ``torch.utils.checkpoint``, with the same gradients bit for
    bit, which equal autograd through the plain scan (f32 5e-5 x max|g|)."""
    from torch.utils.checkpoint import checkpoint
    x, a, b, c, h0 = (t.requires_grad_(True) for t in ssd_inputs(2, 300, 3, 64, 16))

    def loss(fn, *t):
        y, h = fn(*t)
        y2, h2 = fn(y, t[1], t[2], t[3], h)
        return (y2 ** 2).sum() + (h2 ** 2).sum()

    def kernel(*t):
        return ssd_scan(*t, chunk=128)

    n0 = (ssd_scan.n_launches, ssd_scan_bwd.n_launches)
    got = torch.autograd.grad(loss(kernel, x, a, b, c, h0), (x, a, b, c, h0))
    assert (ssd_scan.n_launches - n0[0], ssd_scan_bwd.n_launches - n0[1]) == (2, 2)
    again = torch.autograd.grad(checkpoint(lambda *t: loss(kernel, *t), x, a, b, c, h0,
                                           use_reentrant=False), (x, a, b, c, h0))
    assert (ssd_scan.n_launches - n0[0], ssd_scan_bwd.n_launches - n0[1]) == (6, 4)
    want = torch.autograd.grad(loss(lambda *t: ssd_scan_chunked(*t, chunk=128), x, a, b, c, h0),
                               (x, a, b, c, h0))
    for g, g2, w in zip(got, again, want):
        assert torch.equal(g, g2)
        assert (g - w).abs().max().item() <= 5e-5 * max(w.abs().max().item(), 1e-30)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reduced_hymba_trains_on_the_card(cuda, dtype):
    """hymba reduced (2 layers, d 128: 4 SSM heads of 64, N 16, chunk 16)
    trains on the card: with remat, per step two forward and one backward
    launch of the SSD scan and of flash attention a layer; the loss and
    gradient of the kernel path against the plain path (f32 at 1e-4 x
    max|g| a leaf, bf16 finite)."""
    from repro_torch.models import transformer
    from repro_torch.optim import tree_leaves
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.runtime import TrainConfig, init_opt_state, make_train_step
    cfg = C.get_config("hymba_1p5b").reduced(n_layers=2, d_model=128, vocab=1000)
    cfg = dataclasses.replace(cfg, param_dtype=dtype, compute_dtype=dtype)
    params = init_params(0, cfg, device="cuda")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 1000, (2, 70))).cuda()

    def grads(plain):
        leaves = tree_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        loss, _ = transformer.loss_fn(params, cfg, {"tokens": tokens}, remat=True, plain=plain)
        out = torch.autograd.grad(loss, leaves)
        for t in leaves:
            t.requires_grad_(False)
        return loss, out

    (lk, gk), (lp, gp) = grads(False), grads(True)
    assert torch.isfinite(lk) and all(bool(torch.isfinite(g).all()) for g in gk)
    if dtype == "float32":
        torch.testing.assert_close(lk, lp, rtol=1e-5, atol=1e-5)
        for a, b in zip(gk, gp):
            assert (a - b).abs().max().item() <= 1e-4 * max(b.abs().max().item(), 1e-30)
    step = make_train_step(cfg, TrainConfig())
    opt = init_opt_state(params, TrainConfig())
    ssd_scan.n_launches = ssd_scan_bwd.n_launches = 0
    fa.flash_attention.n_launches = fa.flash_attention_bwd.n_launches = 0
    for _ in range(2):
        _, opt, m = step(params, opt, {"tokens": tokens})
        assert np.isfinite(m["loss"].item())
    assert (ssd_scan.n_launches, ssd_scan_bwd.n_launches) == (8, 4)
    assert (fa.flash_attention.n_launches, fa.flash_attention_bwd.n_launches) == (8, 4)


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(*(normal(0, 1, 8, 2, 48) for _ in range(3)))
    with pytest.raises(ValueError, match="head dims"):
        flash_attention(normal(0, 1, 8, 2, 64), normal(1, 1, 8, 2, 64), normal(2, 1, 8, 2, 96))
    with pytest.raises(ValueError, match="head dims"):  # (96, 96) and (120, 120) launch
        decode_attention(normal(0, 1, 2, 80), normal(1, 1, 8, 2, 80), normal(2, 1, 8, 2, 80), 4)
    with pytest.raises(ValueError, match="head dims"):
        decode_attention(normal(0, 1, 2, 120), normal(1, 1, 8, 2, 120), normal(2, 1, 8, 2, 64),
                         4)
    with pytest.raises(ValueError, match="contiguous"):
        rmsnorm(normal(0, 8, 64)[:, ::2], normal(1, 32))
    with pytest.raises(TypeError):
        rmsnorm(normal(0, 8, 64, dtype=torch.float16), normal(1, 64))
    with pytest.raises(ValueError, match="caches"):
        decode_attention(normal(0, 1, 2, 32), normal(1, 1, 8, 2, 32, device="cpu"),
                         normal(2, 1, 8, 2, 32), 4)
    with pytest.raises(ValueError, match="exceeds"):
        decode_attention(normal(0, 1, 9, 32), normal(1, 1, 8, 1, 32), normal(2, 1, 8, 1, 32), 4)
    qkv = normal(0, 1, 8, 3 * 2 * 32 + 4, dtype=torch.bfloat16)[..., 4:]
    q, k, v = (t.reshape(1, 8, 2, 32) for t in qkv.split(64, dim=-1))
    with pytest.raises(ValueError, match="aligned"):
        flash_attention(q, k, v)
    with pytest.raises(ValueError, match="scale"):
        flash_attention(*(normal(0, 1, 8, 2, 32, dtype=torch.bfloat16) for _ in range(3)),
                        scale=0.0)
    x, a, b, c, h0 = ssd_inputs(1, 8, 2, 16, 4)
    with pytest.raises(ValueError, match="a "):
        ssd_scan(x, a.cpu(), b, c)
    with pytest.raises(ValueError, match="h0"):
        ssd_scan(x, a, b, c, h0[:, :1])
    with pytest.raises(ValueError, match="contiguous"):
        ssd_scan(x, a, b, normal(0, 1, 8, 2, 8)[..., ::2])
    with pytest.raises(ValueError, match="exceeds"):
        ssd_scan(*ssd_inputs(1, 8, 2, 16, 72)[:4])
    with pytest.raises(TypeError):
        ssd_scan(x.half(), a, b, c)


# Reduced widths a path serves at: h2o-danube3 and phi3-vision keep their
# published head dims (120 at g 4, and 96 at g 1), which the kernels take.
SERVED_REDUCED = {"h2o_danube3_4b": dict(d_model=960, n_heads=8, n_kv=2),
                  "phi3_vision_4p2b": dict(d_model=384, n_heads=4)}


@pytest.mark.parametrize("arch", ["internlm2_1p8b", "hymba_1p5b", "minicpm3_4b",
                                  "granite_moe_3b", "h2o_danube3_4b", "phi3_vision_4p2b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_server_kernel_path_matches_plain(cuda, dtype, arch):
    """A small model end to end on the card: the kernel path's logits against
    the plain path's.  f32 at 1e-4 (summation order only); bf16 at 2e-2 of
    the logits' magnitude (an ulp flip compounds through the layers).  The
    reduced hymba has a window of 32 and chunks of 16, so the 40-token
    prompt rolls the ring, ends in a ragged chunk, and decode wraps.  MLA
    keeps its published head dims (96 for q and k, 64 for v) over narrower
    low ranks, since the kernels take no others; the MoE runs its published
    impl (``scatter`` on one card), and its decode drops slots (cap 1).
    The kernel path's MoE layers dispatch to the plain path's experts
    (``PinnedRoutes``): in bf16 a near-tie among the router's logits sends a
    token to another expert, a discrete jump (0.137 against 0.077 once in
    four card runs), not the kernels' arithmetic.  h2o-danube3 (window 32
    after ``reduced``) rolls its ring at head dim 120, and phi3-vision
    serves token prompts through its embedding table at 96."""
    kw = SERVED_REDUCED.get(arch, dict(d_model=256, n_heads=4))
    cfg = C.get_config(arch).reduced(n_layers=4, vocab=1000, **kw)
    cfg = dataclasses.replace(cfg, param_dtype=dtype, compute_dtype=dtype)
    if cfg.mla is not None:
        cfg = dataclasses.replace(cfg, mla=C.MLAConfig(q_lora_rank=64, kv_lora_rank=32))
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=C.get_config(arch).moe)
    params = init_params(0, cfg, device=cuda)
    B, S, steps = 2, 40, 5
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (B, S))).to(cuda)
    out = Server(cfg, params, ServeConfig(max_len=S + steps), device=cuda).generate(
        toks.cpu().numpy(), steps)
    assert out.shape == (B, steps)
    (kp, kd), (pp, pd) = [(make_prefill_step(cfg, S + steps, plain=p),
                           make_decode_step(cfg, plain=p)) for p in (False, True)]

    def check(a, b):
        if dtype == "float32":
            np.testing.assert_allclose(f32(a), f32(b), rtol=1e-4, atol=1e-4)
        else:
            assert (a - b).abs().max() <= 2e-2 * b.abs().max()

    with torch.inference_mode(), PinnedRoutes() as pin:
        pl, pc = pin.lead(pp, params, {"tokens": toks})
        kl, kc = pin.follow(kp, params, {"tokens": toks})
        check(kl, pl)
        ids = torch.from_numpy(out.astype(np.int64)).to(cuda)
        for i in range(steps):
            pl, pc = pin.lead(pd, params, ids[:, i:i + 1], pc, S + i)
            kl, kc = pin.follow(kd, params, ids[:, i:i + 1], kc, S + i)
            check(kl, pl)


class PinnedRoutes:
    """While active, ``lead(step, ...)`` runs a step and records each MoE
    layer's top-k experts; ``follow(step, ...)`` runs another path's step
    with each MoE layer dispatching to the recorded experts, in order, with
    gates from its own router logits at them.  A model without an MoE runs
    both steps unchanged."""

    def __enter__(self):
        from repro_torch.models import moe
        self._moe, self._real, self._topi, self._next = moe, moe._route, [], None

        def route(p, cfg, x2):
            gates, topi, aux = self._real(p, cfg, x2)
            if self._next is None:
                self._topi.append(topi)
                return gates, topi, aux
            forced = self._topi[self._next]
            self._next += 1
            return torch.softmax((x2.float() @ p["router"]).gather(-1, forced), -1), forced, aux

        moe._route = route
        return self

    def __exit__(self, *exc):
        self._moe._route = self._real

    def lead(self, step, *args):
        self._topi, self._next = [], None
        return step(*args)

    def follow(self, step, *args):
        self._next = 0
        out = step(*args)
        assert self._next == len(self._topi)
        self._next = None
        return out


# ---------------------------------------------------------------------------
# the placement path: the DP sweep kernel, a batched solve, a placed run
# ---------------------------------------------------------------------------

def sweep_inputs(seed, N, S, M, k, with_cc, inf_share, device="cuda", same=()):
    """spb with _BIG-priced (disconnected) pairs and a zero diagonal, sorted
    candidates (the layers in ``same`` keep the previous layer's),
    infeasible candidates in ``inf_share``, compute cost or None."""
    rng = np.random.default_rng(seed)
    spb = rng.uniform(0, 1e-6, (N, N))
    spb[rng.random((N, N)) < 0.05] = 1e12
    np.fill_diagonal(spb, 0.0)
    cand = np.sort(rng.integers(0, N, (S, M, k)), axis=2)
    for x in same:
        cand[:, x] = cand[:, x - 1]
    arrays = (spb, rng.uniform(1e3, 1e7, M), rng.integers(0, N, S), cand,
              rng.random((S, M, k)) >= inf_share,
              rng.uniform(0, 1e-3, (M, N)) if with_cc else None)
    t = [None if a is None else torch.from_numpy(a).to(device) for a in arrays]
    return t[0], t[1], float(rng.uniform(1e5, 1e6)), t[2], t[3], t[4], t[5]


SWEEP_SETS = ((8, 1024, 0.0), (64, 1024, 0.2), (1024, 256, 0.5), (16, 48, 1.0),
              (64, 4097, 0.3))  # S, N, infeasible share; spb at N 4097 outgrows the L2
WIDE_SETS = ((8, 1024, 0.2), (4, 4097, 0.3))  # fewer rows where k >= 257


@pytest.mark.parametrize("with_cc", [False, True])
@pytest.mark.parametrize("k", [4, 17, 32, 64, 65, 128, 257, 1024])
@pytest.mark.parametrize("M", [7, 18])
def test_dp_sweep_kernel_equals_plain_bit_for_bit(cuda, M, k, with_cc):
    for S, N, inf_share in (SWEEP_SETS if k < 257 else WIDE_SETS):
        args = sweep_inputs(S + k, N, S, M, k, with_cc, inf_share)
        n0 = dp_sweep.n_launches
        got = dp_sweep(*args)
        want = ref.dp_sweep(*args)
        torch.cuda.synchronize()
        assert dp_sweep.n_launches == n0 + 1
        p = sweep_plan(S, M, k, with_cc, sm_count(torch.cuda.current_device()))
        assert dp_sweep.last_grid == (p.grid, p.threads, p.rows, p.stagers, p.lanes, p.tile,
                                      p.slots, p.ahead, p.resident, p.smem)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (S, N, inf_share)


@pytest.mark.parametrize("with_cc", [False, True])
@pytest.mark.parametrize("M,k,same", [(7, 32, (1, 2, 3, 4, 5, 6)), (18, 16, tuple(range(1, 18))),
                                      (7, 65, (1, 2, 3, 4, 5, 6)), (7, 9, (1, 2, 4, 5)),
                                      (8, 6, (2, 3, 4, 7)), (18, 64, (5, 6, 7, 8, 12, 17)),
                                      (70, 5, tuple(range(1, 70)))])
def test_dp_sweep_kernel_with_repeated_candidates_equals_plain(cuda, M, k, same, with_cc):
    """Layers that repeat the previous layer's candidates gather nothing in
    the kernel; their transitions are formed from the repeated entries."""
    for S, N, inf_share in ((64, 1024, 0.3), (8, 4097, 0.0)):
        args = sweep_inputs(S + k + M, N, S, M, k, with_cc, inf_share, same=same)
        got, want = dp_sweep(*args), ref.dp_sweep(*args)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (S, N, inf_share)


@pytest.mark.parametrize("M,k,with_cc", [(39, 1024, False), (36, 1024, True),
                                          (692, 65, False), (667, 65, True), (4816, 8, True)])
def test_dp_sweep_kernel_past_the_resident_envelope_equals_plain(cuda, M, k, with_cc):
    """One layer past what fits in shared memory beside the ring (and far
    past it at k 8): the ring reads candidates, feasibility and Kv from
    device memory."""
    S = 8
    n_sm = sm_count(torch.cuda.current_device())
    assert not sweep_plan(S, M, k, with_cc, n_sm).resident
    assert sweep_plan(S, M - 1, k, with_cc, n_sm).resident
    args = sweep_inputs(M + k, 300, S, M, k, with_cc, 0.2)
    got, want = dp_sweep(*args), ref.dp_sweep(*args)
    torch.cuda.synchronize()
    assert dp_sweep.last_grid[8] is False
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def assert_sweep_bits(got, want):
    """final's NaNs where the plain version has them and every other entry
    bit for bit (a NaN's payload is the platform's), backs equal."""
    nan = want[0].isnan()
    assert torch.equal(got[0].isnan(), nan)
    assert torch.equal(got[0].masked_fill(nan, 0.0).view(torch.int64),
                       want[0].masked_fill(nan, 0.0).view(torch.int64))
    assert torch.equal(got[1], want[1])


@pytest.mark.parametrize("with_cc", [False, True])
@pytest.mark.parametrize("k", [8, 32, 64, 65, 257])
@pytest.mark.parametrize("M", [7, 18])
def test_dp_sweep_kernel_takes_numpy_argmin_on_nan(cuda, M, k, with_cc):
    """NaNs from layer 3 on (0 x inf), so the pass turns to order keys
    mid-sweep: one lane a column (k 8), the lanes' shuffle merges (k 32-65:
    4 and 8 lanes), and the ring build (k 257)."""
    spb, Kv, Ks, srcs, cand, valid, cc = sweep_inputs(3 + k + M, 300, 16, M, k, with_cc, 0.2)
    spb[torch.rand(spb.shape, device=cuda, generator=torch.Generator(cuda).manual_seed(k))
        < 0.2] = float("inf")
    spb.fill_diagonal_(0.0)
    Kv[2] = 0.0
    got, want = dp_sweep(spb, Kv, Ks, srcs, cand, valid, cc), \
        ref.dp_sweep(spb, Kv, Ks, srcs, cand, valid, cc)
    assert bool(want[0].isnan().any())
    assert_sweep_bits(got, want)


@pytest.mark.parametrize("with_cc", [False, True])
@pytest.mark.parametrize("k", [8, 32, 65, 257])
def test_dp_sweep_kernel_orders_negative_and_signed_zero_values(cuda, k, with_cc):
    """A negative Kv entry makes negative transitions (and -inf, and NaN
    beside an infeasible penalty), so the pass's order keys flip a
    negative's magnitude bits; -0.0 spb entries sit beside +0.0 ones (their
    products meet the feasible penalty's +0.0 and tie as +0)."""
    spb, Kv, Ks, srcs, cand, valid, cc = sweep_inputs(7 + k, 300, 16, 18, k, with_cc, 0.2)
    g = torch.Generator(cuda).manual_seed(k)
    u = torch.rand(spb.shape, device=cuda, generator=g)
    spb[u < 0.1] = -0.0
    spb[(u >= 0.1) & (u < 0.15)] = 0.0
    spb[u > 0.97] = float("inf")
    Kv[1] = -Kv[1]
    Kv[4] = -0.0
    got, want = dp_sweep(spb, Kv, Ks, srcs, cand, valid, cc), \
        ref.dp_sweep(spb, Kv, Ks, srcs, cand, valid, cc)
    assert bool((want[0] < 0).any() or want[0].isnan().any())
    assert_sweep_bits(got, want)


def test_dp_sweep_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    spb, Kv, Ks, srcs, cand, valid, cc = sweep_inputs(0, 32, 8, 7, 4, True, 0.0)
    with pytest.raises(TypeError):
        dp_sweep(spb.float(), Kv, Ks, srcs, cand, valid, cc)
    over = MAX_K + 1  # the plan's cap + 1
    with pytest.raises(ValueError, match=f"k {over} outside 1..{MAX_K}"):
        dp_sweep(spb, Kv, Ks, srcs, cand[:, :, :1].expand(8, 7, over).contiguous(),
                 valid[:, :, :1].expand(8, 7, over).contiguous(), cc)
    with pytest.raises(ValueError):
        dp_sweep(spb, Kv, Ks, srcs.cpu(), cand, valid, cc)


def test_batched_solve_on_the_card_equals_sequential(cuda):
    """N = 256 LeNet swarm: the card's batched solve admits and places
    exactly as the sequential sparse solve, through the kernel."""
    n = 256
    mob = placement.RPGMobility(placement.RPGParams(n_uavs=n, area_m=300.0, homogeneous=True),
                                seed=0)
    rates = placement.rate_matrix(mob.positions(1, seed=0)[0])
    src = np.random.default_rng(0).integers(0, 16, 128).astype(np.int64)
    prob = placement.Problem(placement.lenet_profile(), np.full(n, 512e6), np.full(n, 95e9),
                             rates, src, np.full(n, 9.5e9))
    seq = placement.solve_ould(prob, solver="dp-sparse")
    n0 = dp_sweep.n_launches
    bat = placement.solve_ould(prob, solver="dp-sparse", batch_solve=True, device=cuda)
    assert dp_sweep.n_launches > n0 and bat.dp_stats.n_batched > 0
    np.testing.assert_array_equal(bat.admitted, seq.admitted)
    np.testing.assert_array_equal(bat.assign, seq.assign)
    assert bat.objective == seq.objective


def test_batched_solve_above_k_64_on_the_card_equals_sequential(cuda):
    """LeNet over 4097 nodes (spb 134 MB, past the L2), 512 requests from 64
    hotspots: the default budget is k = 65, above the kernel's former cap,
    and the card's batched solve still places as the sequential one."""
    n = 4097
    mob = placement.RPGMobility(placement.RPGParams(n_uavs=n, area_m=300.0, homogeneous=True),
                                seed=0)
    rates = placement.rate_matrix(mob.positions(1, seed=0)[0])
    src = np.random.default_rng(0).integers(0, 64, 512).astype(np.int64)
    prob = placement.Problem(placement.lenet_profile(), np.full(n, 8 * 512e6),
                             np.full(n, 95e9), rates, src, np.full(n, 9.5e9))
    seq = placement.solve_ould(prob, solver="dp-sparse")
    n0 = dp_sweep.n_launches
    bat = placement.solve_ould(prob, solver="dp-sparse", batch_solve=True, device=cuda)
    assert dp_sweep.n_launches > n0 and bat.dp_stats.n_batched > 0 and bat.dp_stats.k == 65
    np.testing.assert_array_equal(bat.admitted, seq.admitted)
    np.testing.assert_array_equal(bat.assign, seq.assign)
    assert bat.objective == seq.objective


def test_placed_lenet_run_equals_sequential_on_the_card(cuda):
    """LeNet placed by ould-dp over ten 96 MB nodes (its 108 MB cannot sit on
    one, so every request crosses a link) runs on the card as the whole
    model run on one node."""
    n = 10
    mob = placement.RPGMobility(placement.RPGParams(n_uavs=n, area_m=100.0, homogeneous=True),
                                seed=0)
    rates = placement.rate_matrix(mob.positions(1, seed=0)[0])
    prob = placement.Problem(placement.lenet_profile(), np.full(n, 96e6), np.full(n, 1e13),
                             rates, np.arange(4) % 2, compute_speed=np.full(n, 9.5e9))
    plan = placement.get_planner("ould-dp").plan(prob, placement.SnapshotView(rates))
    graph = compile_plan(plan)
    assert plan.n_admitted == 4 and all(len(set(a)) >= 2 for a in plan.assign)
    engine = ExecutionEngine(layer_fns_for(placement.lenet_profile(),
                                           generator=torch.Generator(cuda).manual_seed(0),
                                           device=cuda), device=cuda)
    frames = np.random.default_rng(0).standard_normal((4, 326, 595, 3)).astype(np.float32)
    report = engine.run(graph, frames)
    seq = engine.sequential_reference(frames, graph.requests)
    for r in graph.requests:
        assert np.abs(report.outputs[r] - seq[r]).max() <= 1e-4 * np.abs(seq[r]).max()


def test_churn_swarm_batched_on_the_card_equals_sequential(cuda):
    """benchmarks/bench_swarm.py's CHURN scenario (10 UAVs in two RPG groups,
    churn, bottleneck queues) under incremental-sparse: the epoch re-solves
    batched through the kernel serve exactly as the sequential ones, wall
    fields and the first-launch count excepted."""
    from repro_torch.runtime.swarm import SwarmScenario, simulate
    churn = dict(arrival_rate_hz=0.3, mtbf_s=60.0, mttr_s=20.0, queue_model="bottleneck")
    seq = simulate(SwarmScenario(**churn), "incremental-sparse", 0)
    n0 = dp_sweep.n_launches
    bat = simulate(SwarmScenario(**churn, batch_solve=True, device="cuda"),
                   "incremental-sparse", 0)
    assert dp_sweep.n_launches > n0
    for f in ("n_arrivals", "n_never_admitted", "served", "missed", "outages", "dropped",
              "degraded", "frames_rejected", "wait_total_s"):
        assert getattr(bat, f) == getattr(seq, f), f
    np.testing.assert_array_equal(bat.latencies, seq.latencies)
    np.testing.assert_array_equal(bat.queue_demand_s, seq.queue_demand_s)
    assert ([dataclasses.replace(e, solve_time_s=0.0) for e in bat.epochs]
            == [dataclasses.replace(e, solve_time_s=0.0) for e in seq.epochs])
    skip = ("solver.total_solve_s", "solver.jit_compiles")
    assert ({k: v for k, v in bat.metrics.items() if k not in skip}
            == {k: v for k, v in seq.metrics.items() if k not in skip})


def test_multiproc_ship_lands_on_the_card(cuda):
    """Two torch workers on the card (a CUDA context each) echo a bf16 and
    an int32 tensor byte for byte, back on the card."""
    from repro_torch.transport import MultiProcTransport
    gen = torch.Generator(cuda).manual_seed(0)
    xs = [torch.randn(256, 1024, generator=gen, device=cuda).to(torch.bfloat16),
          torch.randint(-2 ** 31, 2 ** 31 - 1, (4099,), generator=gen, device=cuda,
                        dtype=torch.int32)]
    with MultiProcTransport(n_workers=2, device=cuda) as tp:
        assert tp.worker_backends == ["cuda", "cuda"]
        assert tp.worker_devices == [torch.cuda.get_device_name(cuda)] * 2
        for i, x in enumerate(xs):
            res = tp.ship(0, i, x)
            assert res.array.device == x.device and res.array.dtype == x.dtype
            assert torch.equal(res.array, x)
        assert set(tp.worker_stats) == {0, 1}


def test_placed_lenet_over_loopback_on_the_card_equals_inproc(cuda):
    """The placed LeNet run with every transfer shipped through worker
    processes gives the in-process run's outputs bit for bit."""
    from repro_torch.transport import LoopbackTransport
    n = 10
    mob = placement.RPGMobility(placement.RPGParams(n_uavs=n, area_m=100.0, homogeneous=True),
                                seed=0)
    rates = placement.rate_matrix(mob.positions(1, seed=0)[0])
    prob = placement.Problem(placement.lenet_profile(), np.full(n, 96e6), np.full(n, 1e13),
                             rates, np.arange(4) % 2, compute_speed=np.full(n, 9.5e9))
    graph = compile_plan(placement.get_planner("ould-dp").plan(prob,
                                                               placement.SnapshotView(rates)))
    assert graph.transfers
    fns = layer_fns_for(placement.lenet_profile(),
                        generator=torch.Generator(cuda).manual_seed(0), device=cuda)
    frames = np.random.default_rng(0).standard_normal((4, 326, 595, 3)).astype(np.float32)
    ref = ExecutionEngine(fns, device=cuda).run(graph, frames)
    with LoopbackTransport(n_workers=2) as tp:
        report = ExecutionEngine(fns, transport=tp, device=cuda).run(graph, frames)
        assert tp.moved_bytes > 0
    assert report.transport == "loopback" and len(report.transfers) == len(graph.transfers)
    for r in graph.requests:
        assert np.array_equal(report.outputs[r], ref.outputs[r]), r


# ---------------------------------------------------------------------------
# The parallel layer on the card: a world of one over NCCL
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def nccl1():
    """A world-one NCCL group on the card, (data, model) = (1, 1) and
    (stage,) = (1,) meshes on it; destroyed after the module's tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only there")
    import torch.distributed as dist
    from repro_torch.launch import mesh as launch_mesh
    launch_mesh.init_process_group("cuda")
    try:
        yield (launch_mesh.make_mesh((1, 1), ("data", "model")),
               launch_mesh.make_mesh((1,), ("stage",)))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_one_stage_pipeline_matches_the_block_stack_on_the_card(nccl1, dtype):
    """Reduced internlm2 through ``pipeline_forward_stages`` on a one-stage
    mesh at n_micro 2: the kernels run (two norms and one flash attention a
    layer a microbatch) and the output matches the unpipelined stack (f32
    1e-4; bf16 2e-2 of its magnitude, microbatches changing the products'
    batch)."""
    from repro_torch.models import transformer
    from repro_torch.parallel import pipeline_forward_stages
    cfg = C.get_config("internlm2_1p8b").reduced(n_layers=4, d_model=256, n_heads=4)
    cfg = dataclasses.replace(cfg, param_dtype=dtype, compute_dtype=dtype)
    params = init_params(0, cfg, device="cuda")
    x = normal(3, 4, 64, cfg.d_model, dtype=DTYPES[dtype])
    fn = transformer.block_fn(cfg)
    with torch.inference_mode():
        want = x
        for p in params["blocks"]:
            want = fn(p, want)
        rmsnorm.n_launches = flash_attention.n_launches = 0
        got = pipeline_forward_stages(fn, params["blocks"], x, mesh=nccl1[1], stage_sizes=[4],
                                      n_micro=2)
    assert (rmsnorm.n_launches, flash_attention.n_launches) == (2 * 4 * 2, 4 * 2)
    if dtype == "float32":
        np.testing.assert_allclose(f32(got), f32(want), rtol=1e-4, atol=1e-4)
    else:
        assert (got.float() - want.float()).abs().max() <= 2e-2 * want.float().abs().max()


def test_moe_expert_path_matches_scatter_on_a_1x1_mesh(nccl1, monkeypatch):
    """granite's published MoE (top-8 of 40) at reduced width on the (1, 1)
    mesh with the token threshold lowered: the expert path (NCCL all-gather
    and all-reduce over groups of one) runs and gives scatter's y and aux,
    and, through the collectives' backward on NCCL, scatter's gradients."""
    from repro_torch.models import moe
    from repro_torch.parallel import sharding
    cfg = dataclasses.replace(C.get_config("granite_moe_3b").reduced(d_model=256),
                              moe=C.get_config("granite_moe_3b").moe)
    p = moe.moe_init(torch.Generator("cuda").manual_seed(0), cfg, torch.float32)
    x = normal(4, 2, 64, cfg.d_model)
    calls = []
    real = moe._moe_expert_parallel
    monkeypatch.setattr(moe, "_moe_expert_parallel", lambda *a: calls.append(1) or real(*a))
    monkeypatch.setattr(moe, "SHARD_MAP_MIN_TOKENS", 0)
    def run(c):
        leaves = {k: v.clone().requires_grad_(True) for k, v in {**p, "x": x}.items()}
        y, aux = moe.moe_apply({k: v for k, v in leaves.items() if k != "x"}, c, leaves["x"])
        (y.sum() + aux).backward()
        return (y, aux), {k: v.grad for k, v in leaves.items()}

    want, want_g = run(dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, impl="scatter")))
    sharding.set_active_mesh(nccl1[0])
    try:
        got, got_g = run(cfg)
    finally:
        sharding.set_active_mesh(None)
    assert calls == [1]
    for a, b in zip(got, want):
        np.testing.assert_allclose(f32(a.detach()), f32(b.detach()), rtol=1e-5, atol=1e-5)
    for k in want_g:
        np.testing.assert_allclose(f32(got_g[k]), f32(want_g[k]), rtol=1e-4, atol=1e-4,
                                   err_msg=k)


def test_shard_params_round_trip_on_the_card(nccl1):
    from repro_torch.parallel import param_pspecs, shard_params
    cfg = C.get_config("granite_moe_3b").reduced(d_model=256)
    params = init_params(0, cfg, device="cuda")
    placed = shard_params(params, nccl1[0], param_pspecs(params, nccl1[0]))
    flat = [(params["embed"]["table"], placed["embed"]["table"])] + [
        (a, b) for pa, pb in zip(params["blocks"], placed["blocks"])
        for a, b in zip(_leaves(pa), _leaves(pb))]
    for a, b in flat:
        assert b.device_mesh is nccl1[0] and b.to_local().is_cuda
        assert torch.equal(b.full_tensor(), a) and torch.equal(b.to_local(), a)


def _leaves(tree):
    return [leaf for v in tree.values() for leaf in (_leaves(v) if isinstance(v, dict) else [v])]


def test_kernel_wrappers_refuse_a_dtensor_on_the_card(nccl1):
    from torch.distributed.tensor import Replicate, distribute_tensor

    def dt(t):
        return distribute_tensor(t, nccl1[0], [Replicate(), Replicate()])

    q, kc = normal(0, 1, 16, 2, 32), normal(1, 1, 8, 2, 32)
    x, a, b, c, _ = ssd_inputs(1, 8, 2, 16, 4)
    cand = torch.zeros((1, 3, 4), dtype=torch.int64, device="cuda")
    calls = {
        "rmsnorm": lambda: rmsnorm(dt(normal(2, 4, 64)), normal(3, 64)),
        "rmsnorm_bwd": lambda: rmsnorm_bwd(dt(normal(2, 4, 64)), normal(3, 64), normal(4, 4, 64)),
        "flash_attention": lambda: flash_attention(dt(q), q, q),
        "decode_attention": lambda: decode_attention(dt(q[:, 0]), kc, kc, 4),
        "ssd_scan": lambda: ssd_scan(dt(x), a, b, c),
        "dp_sweep": lambda: dp_sweep(dt(torch.rand(8, 8, dtype=torch.float64, device="cuda")),
                                     torch.ones(2, dtype=torch.float64, device="cuda"), 1.0,
                                     torch.zeros(1, dtype=torch.int64, device="cuda"), cand,
                                     torch.ones_like(cand, dtype=bool)),
    }
    for name, call in calls.items():
        with pytest.raises(TypeError, match=f"{name}: got a DTensor"):
            call()


@pytest.mark.parametrize("arch", ["internlm2_1p8b", "hymba_1p5b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_world_one_sharded_steps_equal_the_unsharded_bit_for_bit(nccl1, arch, dtype):
    """Reduced internlm2 and hymba on the (1, 1) mesh: DTensor params
    (``shard_params``) and placed inputs under the active mesh, every kernel
    through ``sharding.local_call``: prefill and four decode steps give the
    unsharded path's logits and cache bit for bit, with the same launches."""
    from repro_torch.models import transformer
    from repro_torch.parallel import sharding
    cfg = C.get_config(arch).reduced(n_layers=2, d_model=256, n_heads=4)
    cfg = dataclasses.replace(cfg, param_dtype=dtype, compute_dtype=dtype)
    params = init_params(0, cfg, device="cuda")
    B, S, n = 2, 96, 4
    toks = torch.randint(0, cfg.vocab, (B, S + n), device="cuda", dtype=torch.int32,
                         generator=torch.Generator("cuda").manual_seed(1))

    def run(p, place):
        rmsnorm.n_launches = flash_attention.n_launches = decode_attention.n_launches = 0
        ssd_scan.n_launches = 0
        with torch.no_grad():
            lg, cache = transformer.prefill(p, cfg, place({"tokens": toks[:, :S]}),
                                            max_len=S + n)
            outs = [lg]
            for i in range(n):
                lg, cache = transformer.decode_step(
                    p, cfg, place({"tokens": toks[:, S + i:S + i + 1]})["tokens"], cache, S + i)
                outs.append(lg)
        counts = (rmsnorm.n_launches, flash_attention.n_launches, decode_attention.n_launches,
                  ssd_scan.n_launches)
        return outs, cache, counts

    want, want_cache, want_n = run(params, lambda b: b)
    mesh = nccl1[0]
    placed = sharding.shard_params(params, mesh, sharding.param_pspecs(params, mesh))
    sharding.set_active_mesh(mesh)
    try:
        got, got_cache, got_n = run(placed, lambda b: sharding.place_batch(b, mesh))
    finally:
        sharding.set_active_mesh(None)
    assert got_n == want_n and want_n[0] > 0
    for g, w in zip(got, want):
        assert torch.equal(g.full_tensor(), w)
    for g, w in zip(got_cache, want_cache):
        for k in w:
            assert torch.equal(g[k].full_tensor(), w[k]), k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_row_max_and_sum_match_the_plain_version(cuda, dtype):
    """``return_ml``: the kernel's (o, m, l), m and l written by its combine
    kernel, against the plain version's, over a full cache, a
    partly valid one and one with no valid slot (both a uniform row over
    every slot at m -1e30, which weighs 0 in a merge); two slices' outputs
    merged by them equal the whole cache's."""
    dt = DTYPES[dtype]
    B, S, hq, hkv, hd = 2, 512, 8, 2, 64
    q, kc, vc = (normal(0, B, hq, hd, dtype=dt), normal(1, B, S, hkv, hd, dtype=dt),
                 normal(2, B, S, hkv, hd, dtype=dt))
    for n in (S, 300):
        o, m, l = decode_attention(q, kc, vc, n, return_ml=True)
        po, pm, pl = ref.decode_attention(q, kc, vc, n, return_ml=True)
        np.testing.assert_allclose(f32(o), f32(po), **tol(dtype))
        assert (m - pm).abs().max() <= 1e-4 * pm.abs().max()
        assert ((l - pl).abs() / pl).max() <= 1e-3
    _, m0, l0 = decode_attention(q, kc, vc, 0, return_ml=True)
    _, pm0, pl0 = ref.decode_attention(q, kc, vc, 0, return_ml=True)
    assert torch.equal(l0, pl0) and bool((m0 < -1e29).all()) and bool((pm0 < -1e29).all())
    # two halves of the slots, merged by their (m, l), against the whole
    h = S // 2
    parts = [decode_attention(q, kc[:, a:b], vc[:, a:b], b - a, return_ml=True)
             for a, b in ((0, h), (h, S))]
    mg = torch.maximum(parts[0][1], parts[1][1])
    w = [pl_ * torch.exp(pm_ - mg) for _, pm_, pl_ in parts]
    merged = sum(po_.float() * wi[..., None] for (po_, _, _), wi in zip(parts, w)) / sum(w)[..., None]
    whole = decode_attention(q, kc, vc, S)
    np.testing.assert_allclose(f32(merged), f32(whole), **tol(dtype))
