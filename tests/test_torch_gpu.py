"""The port's hand-written CUDA kernels against their plain versions, on the
card.  Every test here carries the ``gpu`` marker and skips where there is no
CUDA device; the file imports neither jax nor the reference, so it runs on a
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
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.kernels.ssm_scan import ssd_scan
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
]
DECODE_CASES = [  # B, Smax, Hq, Hkv, D, valid length
    (2, 256, 4, 2, 64, 100), (3, 100, 6, 6, 32, 100),
    (2, 512, 8, 2, 128, 511), (1, 64, 4, 1, 64, 64),
    (2, 96, 4, 2, 64, 0),
    # split-K at length: few (b, kvh) pairs, no valid slot, hymba's ring
    (1, 4096, 8, 1, 128, 4000), (1, 4096, 4, 2, 64, 0), (4, 1024, 25, 5, 64, 1024),
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


@pytest.mark.parametrize("name", list(DTYPES))
def test_decode_attention_kernel_per_seq_lengths_split_k(cuda, name):
    """Device lengths size the splits from Smax: the short sequences' later
    splits lie wholly past their lengths and must weigh nothing."""
    dt = DTYPES[name]
    q, kc, vc = (normal(0, 3, 8, 128, dtype=dt), normal(1, 3, 4096, 2, 128, dtype=dt),
                 normal(2, 3, 4096, 2, 128, dtype=dt))
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


@pytest.mark.parametrize("D,DV", [(64, 64), (96, 64)])
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


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(*(normal(0, 1, 8, 2, 48) for _ in range(3)))
    with pytest.raises(ValueError, match="head dims"):
        flash_attention(normal(0, 1, 8, 2, 64), normal(1, 1, 8, 2, 64), normal(2, 1, 8, 2, 96))
    with pytest.raises(ValueError, match="head dims"):
        decode_attention(normal(0, 1, 2, 96), normal(1, 1, 8, 2, 96), normal(2, 1, 8, 2, 96), 4)
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


@pytest.mark.parametrize("arch", ["internlm2_1p8b", "hymba_1p5b", "minicpm3_4b",
                                  "granite_moe_3b"])
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
    four card runs), not the kernels' arithmetic."""
    cfg = C.get_config(arch).reduced(n_layers=4, d_model=256, n_heads=4, vocab=1000)
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
