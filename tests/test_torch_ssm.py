"""The port's SSD scan, SSM block and hybrid/mamba serving slice against the
reference, on the CPU.

Inputs come from a seeded numpy generator and go to both packages.  The SSD
scan's plain version (what the wrapper runs for a CPU tensor) is held
against the reference's Pallas kernel in interpret mode and its sequential
oracle at the reference's 5e-5 (``tests/test_kernels.py``); the bf16 inputs
of the production dtype mix at bf16's 2e-2.  Whole-model f32 parity is 1e-4
(the frameworks' CPU matmuls sum in different orders).  The CUDA kernel is
held against these plain versions on the card in ``tests/test_torch_gpu.py``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import repro.configs as JC
from repro.kernels import chunked as jax_chunked
from repro.kernels import ref as jax_ref
from repro.kernels.ssm_scan import ssd_scan_pallas
from repro.models import decode_step as jax_decode_step
from repro.models import init_params as jax_init_params
from repro.models import prefill as jax_prefill
from repro.models import ssm as jax_ssm
from repro.runtime.serve import ServeConfig as JaxServeConfig
from repro.runtime.serve import Server as JaxServer
from repro_torch import configs as TC
from repro_torch.kernels import ops
from repro_torch.kernels import ref as torch_ref
from repro_torch.kernels.chunked import ssd_scan_chunked
from repro_torch.kernels.ssm_scan import ssd_scan
from repro_torch.launch import serve as launch_serve
from repro_torch.models import decode_step, from_jax_params, init_cache, init_params, prefill
from repro_torch.models import ssm as torch_ssm
from repro_torch.runtime.serve import ServeConfig, Server

SSD = dict(rtol=5e-5, atol=5e-5)
F32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=2e-2, atol=2e-2)

# (B, S, H, P, N), chunk: the reference's sweep (tests/test_kernels.py), a
# ragged last chunk, one decode step, and the prefill of the reduced model.
SWEEP = ([(shape, chunk) for shape in [(2, 96, 3, 16, 8), (1, 64, 1, 8, 4)]
          for chunk in (16, 32, 40, 96)]
         + [((2, 100, 3, 16, 8), 32), ((2, 1, 3, 16, 8), 256), ((2, 40, 2, 64, 8), 16)])


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


def t_(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# the SSD scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_h0", [True, False])
@pytest.mark.parametrize("shape,chunk", SWEEP, ids=str)
def test_ssd_scan_plain_matches_pallas_and_sequential(shape, chunk, with_h0):
    x, a, b, c, h0 = ssd_inputs(*shape)
    h0 = h0 if with_h0 else None
    jargs = [jnp.asarray(v) for v in (x, a, b, c)]
    jh0 = None if h0 is None else jnp.asarray(h0)
    y_pal, h_pal = ssd_scan_pallas(*jargs, jh0, chunk=chunk, interpret=True)
    y_seq, h_seq = jax_ref.ssd_scan(*jargs, jh0)
    targs = [t_(v) for v in (x, a, b, c)]
    th0 = None if h0 is None else t_(h0)
    n0 = ssd_scan.n_launches
    y, h = ssd_scan(*targs, th0, chunk=chunk)           # a CPU tensor: the plain version
    assert ssd_scan.n_launches == n0
    assert y.dtype == torch.float32 and h.dtype == torch.float32
    assert y.shape == shape[:4] and h.shape == (shape[0], shape[2], shape[3], shape[4])
    for want_y, want_h in ((y_pal, h_pal), (y_seq, h_seq)):
        np.testing.assert_allclose(f32(y), f32(want_y), **SSD)
        np.testing.assert_allclose(f32(h), f32(want_h), **SSD)
    # the port's own sequential oracle, which the card checks use
    ys, hs = torch_ref.ssd_scan(*targs, th0)
    np.testing.assert_allclose(f32(ys), f32(y_seq), **SSD)
    np.testing.assert_allclose(f32(hs), f32(h_seq), **SSD)


@pytest.mark.parametrize("shape,chunk", [((2, 96, 3, 16, 8), 32), ((2, 100, 3, 64, 16), 32),
                                         ((2, 1, 3, 64, 16), 256)], ids=str)
def test_ssd_scan_production_dtype_mix_matches_pallas(shape, chunk):
    """x and c in bf16, a and b in f32, h0 in f32: what the bf16 model hands
    the scan.  y is bf16 (2e-2); h_final is f32 and depends only on the f32
    values of the inputs, so it holds 5e-5."""
    x, a, b, c, h0 = ssd_inputs(*shape)
    y_pal, h_pal = ssd_scan_pallas(jnp.asarray(x, jnp.bfloat16), jnp.asarray(a), jnp.asarray(b),
                                   jnp.asarray(c, jnp.bfloat16), jnp.asarray(h0), chunk=chunk,
                                   interpret=True)
    y, h = ops.ssd_scan(t_(x).bfloat16(), t_(a), t_(b), t_(c).bfloat16(), t_(h0), chunk=chunk)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    np.testing.assert_allclose(f32(y), f32(y_pal), **BF16)
    np.testing.assert_allclose(f32(h), f32(h_pal), **SSD)


@pytest.mark.parametrize("chunk", [7, 16, 48, 64])
def test_ssd_scan_chunked_matches_reference_chunked(chunk):
    """The reference's own XLA chunked sweep (tests/test_kernels.py)."""
    x, a, b, c, _ = ssd_inputs(2, 48, 3, 8, 4, seed=1)
    want_y, want_h = jax_chunked.ssd_scan_chunked(*(jnp.asarray(v) for v in (x, a, b, c)),
                                                  chunk=chunk)
    y, h = ssd_scan_chunked(*(t_(v) for v in (x, a, b, c)), chunk=chunk)
    np.testing.assert_allclose(f32(y), f32(want_y), **SSD)
    np.testing.assert_allclose(f32(h), f32(want_h), **SSD)


def test_ssd_scan_chunked_masks_before_the_exp():
    """Decays near the 1e-37 clamp make the upper triangle's differences
    huge: masking after the exp would give inf * 0 = nan."""
    x, a, b, c, _ = ssd_inputs(1, 32, 2, 8, 4)
    a[:, ::3] = 1e-30
    y, h = ssd_scan_chunked(*(t_(v) for v in (x, a, b, c)), chunk=32)
    ys, hs = torch_ref.ssd_scan(*(t_(v) for v in (x, a, b, c)))
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    np.testing.assert_allclose(f32(y), f32(ys), **SSD)
    np.testing.assert_allclose(f32(h), f32(hs), **SSD)


# ---------------------------------------------------------------------------
# models/ssm.py
# ---------------------------------------------------------------------------

def ssm_configs(dtype="float32"):
    kw = dict(n_layers=2, d_model=64, vocab=512)
    dt = dict(param_dtype=dtype, compute_dtype=dtype)
    return (dataclasses.replace(JC.get_config("hymba_1p5b").reduced(**kw), **dt),
            dataclasses.replace(TC.get_config("hymba_1p5b").reduced(**kw), **dt))


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, np.float32, copy=True))


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(with_state):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32)
    st = rng.standard_normal((2, 3, 24)).astype(np.float32) if with_state else None
    jy, js = jax_ssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                  None if st is None else jnp.asarray(st))
    ty, ts = torch_ssm._causal_conv(t_(x), t_(w), None if st is None else t_(st))
    np.testing.assert_allclose(f32(ty), f32(jy), **F32)
    np.testing.assert_allclose(f32(ts), f32(js), **F32)


def test_causal_conv_sums_in_the_reference_order_in_bf16():
    """Each partial sum rounds to bf16, as the reference's Python ``sum``
    does; the port's result equals that rounding exactly."""
    rng = np.random.default_rng(1)
    x = t_(rng.standard_normal((2, 9, 32)).astype(np.float32)).bfloat16()
    w = t_(rng.standard_normal((4, 32)).astype(np.float32)).bfloat16()
    y, _ = torch_ssm._causal_conv(x, w)
    xp = torch.cat([torch.zeros(2, 3, 32, dtype=torch.bfloat16), x], dim=1)
    want = xp[:, 0:9] * w[0]
    for i in range(1, 4):
        want = want + xp[:, i:i + 9] * w[i]
    assert y.dtype == torch.bfloat16 and torch.equal(y, want)


def test_ssm_prefill_then_decode_matches_reference():
    """Prefill a 40-token prompt (a ragged chunk of 16), then hand the conv
    and scan states to three decode steps."""
    jcfg, tcfg = ssm_configs()
    jp = jax_ssm.ssm_init(jax.random.PRNGKey(3), jcfg)
    tp = to_torch(jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 40, 64)).astype(np.float32)
    jy, jcache = jax_ssm.ssm_prefill(jp, jcfg, jnp.asarray(x))
    ty, tcache = torch_ssm.ssm_prefill(tp, tcfg, t_(x))
    np.testing.assert_allclose(f32(ty), f32(jy), **F32)
    for got, want in zip(tcache, jcache):
        assert got.shape == want.shape
        np.testing.assert_allclose(f32(got), f32(want), **F32)
    shapes = torch_ssm.ssm_cache_shape(tcfg, 2, torch.float32)
    assert [(tuple(t.shape), t.dtype) for t in tcache] == list(shapes)
    for i in range(3):
        xt = rng.standard_normal((2, 1, 64)).astype(np.float32)
        jy, jcache = jax_ssm.ssm_decode(jp, jcfg, jnp.asarray(xt), jcache, jnp.int32(40 + i))
        ty, tcache = torch_ssm.ssm_decode(tp, tcfg, t_(xt), tcache)
        np.testing.assert_allclose(f32(ty), f32(jy), **F32)
        for got, want in zip(tcache, jcache):
            np.testing.assert_allclose(f32(got), f32(want), **F32)


# ---------------------------------------------------------------------------
# the slice end to end: reduced hymba (window 32, chunk 16) and a mamba variant
# ---------------------------------------------------------------------------

def converted(jcfg, tcfg):
    jp = jax_init_params(jax.random.PRNGKey(0), jcfg)
    return jp, from_jax_params(jax.tree.map(np.asarray, jp), tcfg, device="cpu")


def tokens(a):
    return torch.from_numpy(np.asarray(a, np.int64))


@pytest.fixture(scope="module", params=["hybrid", "mamba"])
def f32_model(request):
    jcfg, tcfg = ssm_configs()
    if request.param == "mamba":
        jcfg, tcfg = (dataclasses.replace(c, block_pattern=("mamba",)) for c in (jcfg, tcfg))
    return (jcfg, tcfg, *converted(jcfg, tcfg))


def test_prefill_caches_and_decode_match_reference(f32_model):
    """Prompt 40 > window 32: a ring roll of the attention cache and a ragged
    last scan chunk; then 8 decode steps wrap the ring."""
    jcfg, tcfg, jp, tp = f32_model
    assert tcfg.window == 32 and tcfg.ssm.chunk == 16
    B, S, steps = 2, 40, 8
    toks = np.random.default_rng(0).integers(0, tcfg.vocab, (B, S), dtype=np.int32)
    jl, jc = jax_prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, max_len=S + steps)
    tl, tc = prefill(tp, tcfg, {"tokens": tokens(toks)}, max_len=S + steps)
    np.testing.assert_allclose(f32(tl), f32(jl), **F32, err_msg="prefill")
    kinds = {"hybrid": {"k", "v", "conv", "ssm"}, "mamba": {"conv", "ssm"}}
    for layer, c in enumerate(tc):
        assert set(c) == kinds[tcfg.block_pattern[0]]
        for name, got in c.items():
            want = np.asarray(jc[0][name][layer], np.float32)
            assert got.shape == want.shape, (layer, name)
            np.testing.assert_allclose(f32(got), want, **F32, err_msg=f"cache {layer} {name}")
    assert tc[0]["ssm"].dtype == torch.float32
    rng = np.random.default_rng(1)
    for i in range(steps):
        tok = rng.integers(0, tcfg.vocab, (B, 1), dtype=np.int32)
        jl, jc = jax_decode_step(jp, jcfg, jnp.asarray(tok), jc, jnp.int32(S + i))
        tl, tc = decode_step(tp, tcfg, tokens(tok), tc, S + i)
        assert tl.shape == (B, tcfg.vocab) and tl.dtype == torch.float32
        np.testing.assert_allclose(f32(tl), f32(jl), **F32, err_msg=f"decode {i}")


def test_generate_tokens_equal_reference(f32_model):
    jcfg, tcfg, jp, tp = f32_model
    toks = np.random.default_rng(3).integers(0, tcfg.vocab, (2, 40), dtype=np.int32)
    want = JaxServer(jcfg, jp, JaxServeConfig(max_len=48, batch_size=2)).generate(toks, 6)
    got = Server(tcfg, tp, ServeConfig(max_len=48, batch_size=2), device="cpu").generate(toks, 6)
    assert got.dtype == np.int32 and got.shape == (2, 6)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_bf16_prefill_logits_match_reference():
    """bf16 weights and compute (production_cfg's form); dt_bias, A_log and D
    stay f32.  Tolerance: bf16's 2e-2 of the logits' magnitude."""
    jcfg, tcfg = ssm_configs("bfloat16")
    jp, tp = converted(jcfg, tcfg)
    toks = np.random.default_rng(0).integers(0, tcfg.vocab, (2, 40), dtype=np.int32)
    jl, _ = jax_prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, max_len=44)
    tl, tc = prefill(tp, tcfg, {"tokens": tokens(toks)}, max_len=44)
    want = f32(jl)
    err = np.abs(f32(tl) - want).max()
    assert err <= 2e-2 * np.abs(want).max(), (err, np.abs(want).max())
    assert tc[0]["conv"].dtype == torch.bfloat16 and tc[0]["ssm"].dtype == torch.float32


def test_from_jax_params_unstacks_a_hybrid_tree():
    jcfg, tcfg = ssm_configs("bfloat16")
    tree = jax.tree.map(np.asarray, jax_init_params(jax.random.PRNGKey(0), jcfg))
    tp = from_jax_params(tree, tcfg, device="cpu")
    assert len(tp["blocks"]) == 2
    for layer in range(2):
        blk = tp["blocks"][layer]
        assert set(blk) == {"norm1", "attn", "ssm", "norm2", "mlp"}
        for key in ("dt_bias", "A_log", "D"):
            assert blk["ssm"][key].dtype == torch.float32
            np.testing.assert_array_equal(blk["ssm"][key].numpy(),
                                          tree["blocks"][0]["ssm"][key][layer])
        for key in ("w_x", "w_bc", "conv", "w_out"):
            assert blk["ssm"][key].dtype == torch.bfloat16
            np.testing.assert_array_equal(blk["ssm"][key].float().numpy(),
                                          tree["blocks"][0]["ssm"][key][layer].astype(np.float32))
        assert blk["ssm"]["norm"]["scale"].shape == (128,)


def test_init_params_and_cache_follow_the_block_kinds():
    _, tcfg = ssm_configs("bfloat16")
    p = init_params(0, tcfg, device="cpu")
    ssm = p["blocks"][0]["ssm"]
    assert ssm["w_x"].dtype == torch.bfloat16 and ssm["dt_bias"].dtype == torch.float32
    assert ssm["w_bc"].shape == (64, 2 * 2 * 8) and ssm["conv"].shape == (4, 128)
    cache = init_cache(tcfg, 3, 50, device="cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in cache[1].items()} == {
        "k": ((3, 32, 4, 16), torch.bfloat16), "v": ((3, 32, 4, 16), torch.bfloat16),
        "conv": ((3, 3, 128), torch.bfloat16), "ssm": ((3, 2, 64, 8), torch.float32)}
    mamba = dataclasses.replace(tcfg, block_pattern=("mamba",), d_ff=0)
    blk = init_params(0, mamba, device="cpu")["blocks"][1]
    assert set(blk) == {"norm1", "ssm"}
    assert set(init_cache(mamba, 1, 8, device="cpu")[0]) == {"conv", "ssm"}
    logits, _ = prefill(init_params(0, mamba, device="cpu"), mamba,
                        {"tokens": torch.zeros(1, 5, dtype=torch.long)})
    assert torch.isfinite(logits).all()


def test_dispatch_counts_match_the_card_path(monkeypatch):
    """A hybrid layer runs three norms (norm1, the SSM's inner norm, norm2),
    one attention and one scan: for 32 layers, 97 norms and 32 scans per
    prefill and per decode step, 32 attention calls per prefill and 32
    decode-attention calls per step."""
    calls = {"rmsnorm": 0, "attention": 0, "decode_attention": 0, "ssd_scan": 0}
    for name in calls:
        real = getattr(ops, name)

        def counted(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(ops, name, counted)
    cfg = TC.get_config("hymba_1p5b").reduced(n_layers=32, d_model=32, vocab=256)
    srv = Server(cfg, init_params(0, cfg, device="cpu"), ServeConfig(max_len=16),
                 device="cpu")
    steps = 3
    srv.generate(np.zeros((2, 4), np.int32), steps)
    assert calls == {"rmsnorm": 97 * (1 + steps), "attention": 32,
                     "decode_attention": 32 * steps, "ssd_scan": 32 * (1 + steps)}


def test_launcher_serves_hymba_on_cpu_when_asked():
    out = launch_serve.main(["--arch", "hymba_1p5b", "--reduced", "--device", "cpu",
                             "--batch", "2", "--prompt-len", "40", "--steps", "3"])
    assert out.shape == (2, 3) and out.dtype == np.int32
