"""The port's serving slice against the reference, end to end on the CPU.

The reference's parameters (``repro.models.init_params``) are converted with
``from_jax_params``; prompts come from a seeded numpy generator and go to
both packages.  f32 tolerance 1e-4: the two frameworks' CPU matmuls sum in
different orders.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import repro.configs as JC
from repro.models import decode_step as jax_decode_step
from repro.models import init_params as jax_init_params
from repro.models import prefill as jax_prefill
from repro.runtime.serve import ServeConfig as JaxServeConfig
from repro.runtime.serve import Server as JaxServer
from repro_torch import configs as TC
from repro_torch.kernels import ref
from repro_torch.models import decode_step, from_jax_params, prefill
from repro_torch.runtime.serve import ServeConfig, Server

F32 = dict(rtol=1e-4, atol=1e-4)


def configs(arch="internlm2_1p8b", dtype="float32"):
    """The same reduced config from each package (tests/test_runtime.py's)."""
    kw = dict(n_layers=2, d_model=64, vocab=512)
    jcfg, tcfg = JC.get_config(arch).reduced(**kw), TC.get_config(arch).reduced(**kw)
    dt = dict(param_dtype=dtype, compute_dtype=dtype)
    return dataclasses.replace(jcfg, **dt), dataclasses.replace(tcfg, **dt)


def converted(jcfg, tcfg):
    jp = jax_init_params(jax.random.PRNGKey(0), jcfg)
    return jp, from_jax_params(jax.tree.map(np.asarray, jp), tcfg, device="cpu")


def prompts(B, S, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, S), dtype=np.int32)


def tokens(a):
    return torch.from_numpy(np.asarray(a, np.int64))


@pytest.fixture(scope="module")
def f32_model():
    jcfg, tcfg = configs()
    return (jcfg, tcfg, *converted(jcfg, tcfg))


def _prefill_and_decode(jcfg, tcfg, jp, tp, B, S, steps, check):
    toks = prompts(B, S, tcfg.vocab)
    max_len = S + steps
    jl, jc = jax_prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, max_len=max_len)
    tl, tc = prefill(tp, tcfg, {"tokens": tokens(toks)}, max_len=max_len)
    check(tl, jl, "prefill")
    pat = len(jcfg.block_pattern)
    for layer, c in enumerate(tc):
        for kv in ("k", "v"):
            want = np.asarray(jc[layer % pat][kv][layer // pat], np.float32)
            assert c[kv].shape == want.shape
            check(c[kv], want, f"cache {layer} {kv}")
    rng = np.random.default_rng(1)
    for i in range(steps):
        tok = rng.integers(0, tcfg.vocab, (B, 1), dtype=np.int32)
        jl, jc = jax_decode_step(jp, jcfg, jnp.asarray(tok), jc, jnp.int32(S + i))
        tl, tc = decode_step(tp, tcfg, tokens(tok), tc, S + i)
        assert tl.shape == (B, tcfg.vocab) and tl.dtype == torch.float32
        check(tl, jl, f"decode {i}")


def _f32_check(got, want, what):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **F32,
                               err_msg=what)


def test_prefill_logits_caches_and_decode_match_reference(f32_model):
    _prefill_and_decode(*f32_model, B=2, S=8, steps=4, check=_f32_check)


def test_sliding_window_ring_cache_matches_reference():
    """h2o-danube3's sliding window (32 after reduced()): a 40-token prompt
    rolls the prefill cache into a ring buffer and decode wraps its slot."""
    jcfg, tcfg = configs("h2o_danube3_4b")
    assert tcfg.attn == "swa" and tcfg.window == 32
    _prefill_and_decode(jcfg, tcfg, *converted(jcfg, tcfg), B=2, S=40, steps=3,
                        check=_f32_check)


def test_long_sliding_window_prompt_takes_the_banded_form_as_the_reference():
    """A 90-token prompt past twice h2o-danube3's reduced window (32): both
    packages' prefill attention takes the banded O(S·window) form, the ring
    cache rolls, and decode wraps it."""
    jcfg, tcfg = configs("h2o_danube3_4b")
    calls = []
    real = ref.attention_banded

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    ref.attention_banded = spy
    try:
        _prefill_and_decode(jcfg, tcfg, *converted(jcfg, tcfg), B=2, S=90, steps=3,
                            check=_f32_check)
    finally:
        ref.attention_banded = real
    assert calls == [(2, 90, tcfg.n_heads, tcfg.hd)] * tcfg.n_layers


def test_generate_tokens_equal_reference(f32_model):
    jcfg, tcfg, jp, tp = f32_model
    toks = prompts(2, 8, tcfg.vocab, seed=3)
    want = JaxServer(jcfg, jp, JaxServeConfig(max_len=16, batch_size=2)).generate(toks, 6)
    srv = Server(tcfg, tp, ServeConfig(max_len=16, batch_size=2), device="cpu")
    got = srv.generate(toks, 6)
    assert got.dtype == np.int32 and got.shape == (2, 6)
    np.testing.assert_array_equal(got, np.asarray(want))


# The published head dims at reduced widths: h2o-danube3's 3840 / 32 = 120
# (window 32 after ``reduced``) and phi3-vision's 3072 / 32 = 96, which the
# port's attention kernels take on the card.
HEAD_DIM_CONFIGS = {"h2o_danube3_4b": (dict(d_model=240, n_heads=2), 120),
                    "phi3_vision_4p2b": (dict(d_model=192, n_heads=2), 96)}


def head_dim_configs(arch):
    kw, hd = HEAD_DIM_CONFIGS[arch]
    kw = dict(n_layers=2, vocab=512, **kw)
    jcfg, tcfg = JC.get_config(arch).reduced(**kw), TC.get_config(arch).reduced(**kw)
    assert tcfg.hd == jcfg.hd == hd
    return jcfg, tcfg


@pytest.mark.parametrize("arch", list(HEAD_DIM_CONFIGS))
def test_published_head_dims_prefill_caches_and_decode_match_reference(arch):
    """A 40-token prompt (past danube's window: the ring rolls, decode
    wraps) through each model at its published head dim, in f32."""
    jcfg, tcfg = head_dim_configs(arch)
    _prefill_and_decode(jcfg, tcfg, *converted(jcfg, tcfg), B=2, S=40, steps=3,
                        check=_f32_check)


@pytest.mark.parametrize("arch", list(HEAD_DIM_CONFIGS))
def test_published_head_dims_generate_tokens_equal_reference(arch):
    jcfg, tcfg = head_dim_configs(arch)
    jp, tp = converted(jcfg, tcfg)
    toks = prompts(2, 36, tcfg.vocab, seed=3)
    want = JaxServer(jcfg, jp, JaxServeConfig(max_len=44, batch_size=2)).generate(toks, 6)
    got = Server(tcfg, tp, ServeConfig(max_len=44, batch_size=2), device="cpu").generate(toks, 6)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_bf16_prefill_logits_match_reference():
    """bf16 weights and compute (production_cfg's form).  Tolerance: bf16's
    2e-2 scaled by the logits' magnitude — bf16 keeps 8 significant bits and
    the frameworks round intermediate products at different places."""
    jcfg, tcfg = configs(dtype="bfloat16")
    jp, tp = converted(jcfg, tcfg)
    assert tp["blocks"][0]["attn"]["wqkv"].dtype == torch.bfloat16
    toks = prompts(2, 8, tcfg.vocab)
    jl, _ = jax_prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, max_len=12)
    tl, _ = prefill(tp, tcfg, {"tokens": tokens(toks)}, max_len=12)
    want = np.asarray(jl, np.float32)
    err = np.abs(tl.numpy() - want).max()
    assert err <= 2e-2 * np.abs(want).max(), (err, np.abs(want).max())
