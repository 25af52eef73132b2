"""The port's MLA (multi-head latent attention, minicpm3-4B) against the
reference, on the CPU, and the attention wrappers at MLA's split head dims.

Inputs and weights come from seeded generators (numpy, or the reference's
``init`` converted with ``from_jax_params``) and go to both packages.
Tolerances: f32 1e-4 for model outputs (the frameworks' CPU matmuls sum in
different orders), 3e-5 for the kernels' plain versions (the reference's
kernel sweep), bf16 2e-2.  MLA's q and k have a head dim of 96 (qk_nope 64 +
qk_rope 32) and its v 64; the CUDA kernels at those dims are held against
these plain versions on the card in ``tests/test_torch_gpu.py``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import repro.configs as JC
from repro.kernels import ref as jax_ref
from repro.kernels.decode_attention import decode_attention as pallas_decode_attention
from repro.kernels.flash_attention import flash_attention as pallas_flash_attention
from repro.models import attention as jax_attn
from repro.models import decode_step as jax_decode_step
from repro.models import init_params as jax_init_params
from repro.models import prefill as jax_prefill
from repro.runtime.serve import ServeConfig as JaxServeConfig
from repro.runtime.serve import Server as JaxServer
from repro_torch import configs as TC
from repro_torch.kernels import decode_attention as decode_mod
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve as launch_serve
from repro_torch.models import (attention, decode_step, from_jax_params, init_cache,
                                init_params, prefill)
from repro_torch.models.transformer import cache_shapes, check_config
from repro_torch.runtime.serve import ServeConfig, Server

F32 = dict(rtol=1e-4, atol=1e-4)
KERNEL = dict(rtol=3e-5, atol=3e-5)
MLA_SCALE = 96 ** -0.5


def normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def configs(dtype="float32", **kw):
    """minicpm3's reduced config from each package (MLA ranks 32 / 16, head
    dims 8 + 8 and 8)."""
    kw = dict(n_layers=2, d_model=64, vocab=512, **kw)
    jcfg = JC.get_config("minicpm3_4b").reduced(**kw)
    tcfg = TC.get_config("minicpm3_4b").reduced(**kw)
    dt = dict(param_dtype=dtype, compute_dtype=dtype)
    return dataclasses.replace(jcfg, **dt), dataclasses.replace(tcfg, **dt)


def tokens(a):
    return torch.from_numpy(np.asarray(a, np.int64))


def prompts(B, S, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, S), dtype=np.int32)


@pytest.fixture(scope="module")
def f32_model():
    jcfg, tcfg = configs()
    jp = jax_init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, from_jax_params(jax.tree.map(np.asarray, jp), tcfg, device="cpu")


def _layer(f32_model, layer=0):
    jcfg, tcfg, jp, tp = f32_model
    pat = len(jcfg.block_pattern)
    jl = jax.tree.map(lambda a: a[layer // pat], jp["blocks"][layer % pat]["mla"])
    return jcfg, tcfg, jl, tp["blocks"][layer]["mla"]


# --- the MLA layer ----------------------------------------------------------

def test_mla_apply_matches_reference(f32_model):
    jcfg, tcfg, jl, tl = _layer(f32_model)
    x = normal(0, 2, 12, tcfg.d_model)
    pos = np.arange(12)
    jy, jlat = jax_attn.mla_apply(jl, jcfg, jnp.asarray(x), jnp.asarray(pos))
    ty, tlat = attention.mla_apply(tl, tcfg, t(x), torch.from_numpy(pos))
    m = tcfg.mla
    assert tlat.shape == (2, 12, m.kv_lora_rank + m.qk_rope_head_dim)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **F32)
    np.testing.assert_allclose(tlat.numpy(), np.asarray(jlat), **F32)


def test_mla_decode_matches_reference_with_its_latent_cache(f32_model):
    """Prefill 9 positions into a 12-slot latent cache, then decode three
    steps; the port writes slot ``pos`` in place, the reference returns the
    updated cache: both are compared after every step."""
    jcfg, tcfg, jl, tl = _layer(f32_model, layer=1)
    m = tcfg.mla
    S, smax = 9, 12
    _, jlat = jax_attn.mla_apply(jl, jcfg, jnp.asarray(normal(1, 2, S, tcfg.d_model)),
                                 jnp.arange(S))
    jcache = jnp.zeros((2, smax, m.kv_lora_rank + m.qk_rope_head_dim)).at[:, :S].set(jlat)
    tcache = t(np.asarray(jcache))
    assert tcache.shape == attention.mla_cache_shape(tcfg, 2, smax)
    for i in range(3):
        x = normal(10 + i, 2, 1, tcfg.d_model)
        jy, jcache = jax_attn.mla_decode(jl, jcfg, jnp.asarray(x), jcache, jnp.int32(S + i))
        ty = attention.mla_decode(tl, tcfg, t(x), tcache, S + i)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **F32, err_msg=f"step {i}")
        np.testing.assert_allclose(tcache.numpy(), np.asarray(jcache), **F32,
                                   err_msg=f"cache after step {i}")


def test_mla_norms_and_attention_go_through_the_kernel_dispatch(f32_model, monkeypatch):
    """norm_q and norm_kv reach ``ops.rmsnorm`` (the RMSNorm kernel on the
    card); prefill reaches ``ops.attention`` and decode
    ``ops.decode_attention`` at MLA's scale with a v of v_head_dim."""
    _, tcfg, _, tl = _layer(f32_model)
    seen = []
    for name in ("rmsnorm", "attention", "decode_attention"):
        real = getattr(ops, name)

        def spy(*a, _real=real, _name=name, **kw):
            seen.append((_name, a[0].shape[-1], a[2].shape[-1] if _name != "rmsnorm" else None,
                         kw.get("scale")))
            return _real(*a, **kw)
        monkeypatch.setattr(ops, name, spy)
    m = tcfg.mla
    qk, scale = m.qk_nope_head_dim + m.qk_rope_head_dim, (m.qk_nope_head_dim
                                                          + m.qk_rope_head_dim) ** -0.5
    _, lat = attention.mla_apply(tl, tcfg, t(normal(0, 1, 5, tcfg.d_model)), torch.arange(5))
    cache = torch.zeros(attention.mla_cache_shape(tcfg, 1, 8))
    cache[:, :5] = lat
    attention.mla_decode(tl, tcfg, t(normal(1, 1, 1, tcfg.d_model)), cache, 5)
    norms = [(m.q_lora_rank, None, None), (m.kv_lora_rank, None, None)]
    assert [s[1:] for s in seen] == [
        *norms, (qk, m.v_head_dim, scale), *norms, (qk, m.v_head_dim, scale)]
    assert [s[0] for s in seen] == ["rmsnorm", "rmsnorm", "attention",
                                    "rmsnorm", "rmsnorm", "decode_attention"]


# --- minicpm3 end to end ----------------------------------------------------

def test_minicpm3_prefill_latent_caches_and_decode_match_reference(f32_model):
    jcfg, tcfg, jp, tp = f32_model
    B, S, steps = 2, 8, 4
    toks = prompts(B, S, tcfg.vocab)
    jl, jc = jax_prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, max_len=S + steps)
    tl, tc = prefill(tp, tcfg, {"tokens": tokens(toks)}, max_len=S + steps)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32, err_msg="prefill")
    pat = len(jcfg.block_pattern)
    assert [list(c) for c in tc] == [["latent"]] * tcfg.n_layers
    for layer, c in enumerate(tc):   # the reference's layer cache is the bare latent
        want = np.asarray(jc[layer % pat][layer // pat])
        assert c["latent"].shape == want.shape == (B, S + steps, 24)
        np.testing.assert_allclose(c["latent"].numpy(), want, **F32, err_msg=f"cache {layer}")
    rng = np.random.default_rng(1)
    for i in range(steps):
        tok = rng.integers(0, tcfg.vocab, (B, 1), dtype=np.int32)
        jl, jc = jax_decode_step(jp, jcfg, jnp.asarray(tok), jc, jnp.int32(S + i))
        tl, tc = decode_step(tp, tcfg, tokens(tok), tc, S + i)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32, err_msg=f"decode {i}")
        for layer, c in enumerate(tc):
            np.testing.assert_allclose(c["latent"].numpy(),
                                       np.asarray(jc[layer % pat][layer // pat]), **F32)


def test_minicpm3_generate_tokens_equal_reference(f32_model):
    jcfg, tcfg, jp, tp = f32_model
    toks = prompts(2, 8, tcfg.vocab, seed=3)
    want = JaxServer(jcfg, jp, JaxServeConfig(max_len=16, batch_size=2)).generate(toks, 6)
    got = Server(tcfg, tp, ServeConfig(max_len=16, batch_size=2), device="cpu").generate(toks, 6)
    assert got.dtype == np.int32 and got.shape == (2, 6)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_minicpm3_bf16_prefill_logits_match_reference():
    """production_cfg's bf16 form: 2e-2 of the logits' magnitude."""
    jcfg, tcfg = configs("bfloat16")
    jp = jax_init_params(jax.random.PRNGKey(0), jcfg)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    assert tp["blocks"][0]["mla"]["wkv_b"].dtype == torch.bfloat16
    toks = prompts(2, 8, tcfg.vocab)
    jl, _ = jax_prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, max_len=12)
    tl, _ = prefill(tp, tcfg, {"tokens": tokens(toks)}, max_len=12)
    want = np.asarray(jl, np.float32)
    assert np.abs(tl.numpy() - want).max() <= 2e-2 * np.abs(want).max()


def test_minicpm3_production_config_is_accepted_with_its_latent_cache():
    cfg = TC.production_cfg(TC.get_config("minicpm3_4b"))
    check_config(cfg)
    shapes = cache_shapes(cfg, 4, 1089)
    assert len(shapes) == 62 and shapes[0] == {"latent": ((4, 1089, 288), torch.bfloat16)}
    small = configs()[1]
    params = init_params(0, small, device="cpu")
    assert set(params["blocks"][0]) == {"norm1", "mla", "norm2", "mlp"}
    assert params["blocks"][0]["mla"]["norm_q"]["scale"].shape == (small.mla.q_lora_rank,)
    assert init_cache(small, 2, 10, device="cpu")[1]["latent"].shape == (2, 10, 24)


def test_launcher_serves_minicpm3_on_cpu_when_asked():
    out = launch_serve.main(["--arch", "minicpm3_4b", "--reduced", "--device", "cpu",
                             "--prompt-len", "6", "--steps", "3", "--batch", "2"])
    assert out.shape == (2, 3)


# --- the attention wrappers at MLA's head dims, on the CPU ------------------

@pytest.mark.parametrize("window", [None, 30])
def test_flash_wrapper_takes_mla_head_dims_and_matches_reference(window):
    """q, k (1, 40, 4, 96), v (1, 40, 4, 64) as a strided slice, at MLA's
    scale: the output is 64 wide and equals the reference's plain
    attention within 3e-5.  (A window under S/2 would send the reference to
    its banded form, which reshapes v to q's head dim.)"""
    q, k, vv = normal(0, 1, 40, 4, 96), normal(1, 1, 40, 4, 96), normal(2, 1, 40, 4, 128)
    v = t(vv)[..., 64:]
    got = flash_mod.flash_attention(t(q), t(k), v, window=window, scale=MLA_SCALE)
    want = jax_ref.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(vv[..., 64:]),
                             window=window, scale=MLA_SCALE)
    assert got.shape == (1, 40, 4, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **KERNEL)


def test_decode_wrapper_takes_mla_head_dims_and_matches_reference():
    q, kc, vv = normal(0, 2, 4, 96), normal(1, 2, 50, 4, 96), normal(2, 2, 50, 4, 128)
    got = decode_mod.decode_attention(t(q), t(kc), t(vv)[..., 64:], 37, scale=MLA_SCALE)
    want = jax_ref.decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vv[..., 64:]),
                                    37, scale=MLA_SCALE)
    assert got.shape == (2, 4, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **KERNEL)


@pytest.mark.parametrize("dk,dv", [(32, 32), (64, 64), (128, 128), (96, 64), (96, 96),
                                   (120, 120)])
def test_wrappers_name_the_head_dims_they_launch(dk, dv):
    """The checks a CUDA tensor meets before launch, run on CPU tensors:
    each instantiated (DK, DV) passes."""
    q, k, v = torch.zeros(1, 8, 4, dk), torch.zeros(1, 8, 2, dk), torch.zeros(1, 8, 2, dv)
    assert flash_mod.head_dims(q, k, v) == (dk, dv)
    assert decode_mod.head_dims(q[:, 0], k, v) == (dk, dv)


@pytest.mark.parametrize("dk,dv", [(48, 48), (64, 96), (120, 64), (96, 32), (16, 8), (80, 80)])
def test_wrappers_refuse_pairs_without_a_kernel(dk, dv):
    q, k, v = torch.zeros(1, 8, 4, dk), torch.zeros(1, 8, 2, dk), torch.zeros(1, 8, 2, dv)
    with pytest.raises(ValueError, match=rf"head dims \(k {dk}, v {dv}\)"):
        flash_mod.head_dims(q, k, v)
    with pytest.raises(ValueError, match=rf"head dims \(k {dk}, v {dv}\)"):
        decode_mod.head_dims(q[:, 0], k, v)
    with pytest.raises(ValueError, match="shapes"):    # k and v must share B, S, H
        flash_mod.head_dims(q, k, torch.zeros(1, 9, 2, dv))


@pytest.mark.parametrize("scale", [0.3, -0.2, None])
def test_bf16_scheme_takes_scale_and_a_narrower_v(scale):
    """``attention_bf16_scheme`` with the caller's scale and DV < DK against
    ``attention`` in f32: the scheme differs only by P's bf16 split (~2^-17
    of each weight), within the kernels' 3e-5."""
    q, k, vv = (t(normal(i, 1, 130, 4, d)) for i, d in enumerate((96, 96, 128)))
    v = vv[..., 64:]
    kw = dict(window=50, scale=scale)
    got = ref.attention_bf16_scheme(q, k, v, **kw)
    assert got.shape == (1, 130, 4, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref.attention(q, k, v, **kw).numpy(), **KERNEL)


def test_reference_pallas_kernels_refuse_mla_head_dims():
    """Why the port follows the reference's ``ref.py`` for MLA: both Pallas
    kernels reshape v to q's head dim, so they cannot run v 64 beside q/k
    96 (the reference's plain versions can)."""
    q, k = jnp.asarray(normal(0, 1, 16, 2, 96)), jnp.asarray(normal(1, 1, 16, 2, 96))
    v = jnp.asarray(normal(2, 1, 16, 2, 64))
    with pytest.raises(TypeError, match="reshape"):
        pallas_flash_attention(q, k, v, block_q=16, block_k=16, interpret=True)
    with pytest.raises(TypeError, match="reshape"):
        pallas_decode_attention(q[:, 0], k, v, 16, block_k=16, interpret=True)
    assert jax_ref.attention(q, k, v).shape == (1, 16, 2, 64)
