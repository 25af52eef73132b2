"""The port's MoE FFN (granite-moe-3B, llama4-maverick) against the
reference, on the CPU.

Weights come from the reference's ``init`` converted with
``from_jax_params`` (or its ``moe_init``), inputs from a seeded numpy
generator.  Tolerances: f32 1e-4 for model outputs (the frameworks' CPU
matmuls sum in different orders), bf16 2e-2.  Routing is exact top-k in
both packages; the ``scatter`` impl drops the slots past an expert's
capacity, and which slots it keeps is checked directly.
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
from repro.models import moe as jax_moe
from repro.models import prefill as jax_prefill
from repro.runtime.serve import ServeConfig as JaxServeConfig
from repro.runtime.serve import Server as JaxServer
from repro_torch import configs as TC
from repro_torch.models import decode_step, from_jax_params, init_params, moe, prefill
from repro_torch.models.convert import _map, _tensor
from repro_torch.models.transformer import check_config
from repro_torch.runtime.serve import ServeConfig, Server

F32 = dict(rtol=1e-4, atol=1e-4)


def normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def tokens(a):
    return torch.from_numpy(np.asarray(a, np.int64))


def prompts(B, S, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, S), dtype=np.int32)


def moe_configs(arch="granite_moe_3b", impl="scatter", dtype="float32", experts=4, **kw):
    """The same reduced MoE config from each package, under ``impl``."""
    kw = dict(n_layers=2, d_model=64, vocab=512, experts=experts, **kw)
    out = []
    for pkg in (JC, TC):
        cfg = pkg.get_config(arch).reduced(**kw)
        out.append(dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, impl=impl),
                                       param_dtype=dtype, compute_dtype=dtype))
    return out


def layer_params(jcfg, seed=0):
    """One MoE layer's weights from the reference's ``moe_init``, in both
    packages' form (the router stays f32)."""
    jp = jax_moe.moe_init(jax.random.PRNGKey(seed), jcfg)
    return jp, _map(jax.tree.map(np.asarray, jp), lambda a: _tensor(a, torch.device("cpu")))


@pytest.mark.parametrize("impl", ["einsum", "scatter"])
@pytest.mark.parametrize("B,S", [(2, 8), (4, 1), (1, 3)])
def test_moe_apply_matches_reference_y_and_aux(impl, B, S):
    jcfg, tcfg = moe_configs(impl=impl)
    jp, tp = layer_params(jcfg)
    assert tp["router"].dtype == torch.float32
    x = normal(1, B, S, tcfg.d_model)
    jy, jaux = jax_moe.moe_apply(jp, jcfg, jnp.asarray(x))
    ty, taux = moe.moe_apply(tp, tcfg, torch.from_numpy(x))
    assert ty.shape == x.shape and taux.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **F32)
    np.testing.assert_allclose(taux.item(), float(jaux), rtol=1e-5)


def _kept_slot_sum(tp, cfg, x2):
    """The scatter impl's output written out slot by slot: token t's k-th
    choice (flat slot t*K + k) counts only if fewer than ``cap`` lower flat
    slots chose the same expert."""
    m = cfg.moe
    T, K = x2.shape[0], m.top_k
    cap = max(1, int(T * K * m.capacity_factor / m.num_experts))
    gates, topi, _ = moe._route(tp, cfg, x2)
    y, taken, kept = torch.zeros_like(x2), {}, []
    for t in range(T):
        for k in range(K):
            e = int(topi[t, k])
            taken[e] = taken.get(e, 0) + 1
            if taken[e] <= cap:
                kept.append(t * K + k)
                one = {n: w[e:e + 1] for n, w in tp.items() if n != "router"}
                y[t] += gates[t, k] * moe._expert_ffn(one, x2[None, t:t + 1])[0, 0]
    return y, kept, cap


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_capacity_drops_the_reference_slots_at_decode(dtype):
    """granite's routing at decode: T = B = 4 tokens, top-8 of 40 experts,
    so cap = max(1, int(4*8*1.25/40)) = 1 and each expert keeps one slot a
    step, the lowest flat slot t*K + k that chose it.  Inputs are the
    reference's bf16 values in both packages."""
    jcfg, tcfg = moe_configs(impl="scatter", dtype=dtype, experts=40, n_heads=4)
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, top_k=8))
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe, top_k=8))
    jp, tp = layer_params(jcfg, seed=3)
    x = jnp.asarray(normal(2, 4, 1, tcfg.d_model), jnp.bfloat16 if dtype == "bfloat16"
                    else jnp.float32)
    xt = _tensor(np.asarray(x), torch.device("cpu"))
    jy, _ = jax_moe.moe_apply(jp, jcfg, x)
    ty, _ = moe.moe_apply(tp, tcfg, xt)
    want = np.asarray(jy, np.float32)
    # the same experts in the same order for every token, so the same slots kept
    _, jtopi, _ = jax_moe._route(jp, jcfg, x[:, 0])
    _, ttopi, _ = moe._route(tp, tcfg, xt[:, 0])
    np.testing.assert_array_equal(ttopi.numpy(), np.asarray(jtopi))
    if dtype == "float32":
        np.testing.assert_allclose(ty.numpy(), want, **F32)
        y, kept, cap = _kept_slot_sum(tp, tcfg, xt[:, 0])
        assert cap == 1 and len(kept) < 4 * 8   # slots were dropped
        np.testing.assert_allclose(ty[:, 0].numpy(), y.numpy(), **F32)
        # the einsum impl drops nothing: it differs wherever a slot was dropped
        full, _ = moe.moe_apply(tp, dataclasses.replace(
            tcfg, moe=dataclasses.replace(tcfg.moe, impl="einsum")), xt)
        assert not torch.allclose(full, ty, **F32)
    else:
        assert np.abs(ty.float().numpy() - want).max() <= 2e-2 * np.abs(want).max()


@pytest.mark.parametrize("arch,impl", [
    ("granite_moe_3b", "einsum"), ("granite_moe_3b", "scatter"),
    ("llama4_maverick_400b", "scatter"), ("llama4_maverick_400b", "einsum")])
def test_moe_model_prefill_caches_and_decode_match_reference(arch, impl):
    """Reduced granite (top-2 of 4 experts) under both impls and reduced
    llama4-maverick (top-1): at decode T = B = 2 and cap = 1 under scatter."""
    jcfg, tcfg = moe_configs(arch, impl)
    jp = jax_init_params(jax.random.PRNGKey(0), jcfg)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    assert set(tp["blocks"][0]) == {"norm1", "attn", "norm2", "moe"}
    assert tp["blocks"][1]["moe"]["w_in"].shape == (4, 64, tcfg.d_ff)
    B, S, steps = 2, 8, 4
    toks = prompts(B, S, tcfg.vocab)
    jl, jc = jax_prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, max_len=S + steps)
    tl, tc = prefill(tp, tcfg, {"tokens": tokens(toks)}, max_len=S + steps)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32, err_msg="prefill")
    pat = len(jcfg.block_pattern)
    for layer, c in enumerate(tc):
        for kv in ("k", "v"):
            want = np.asarray(jc[layer % pat][kv][layer // pat])
            np.testing.assert_allclose(c[kv].numpy(), want, **F32, err_msg=f"cache {layer} {kv}")
    rng = np.random.default_rng(1)
    for i in range(steps):
        tok = rng.integers(0, tcfg.vocab, (B, 1), dtype=np.int32)
        jl, jc = jax_decode_step(jp, jcfg, jnp.asarray(tok), jc, jnp.int32(S + i))
        tl, tc = decode_step(tp, tcfg, tokens(tok), tc, S + i)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32, err_msg=f"decode {i}")


@pytest.mark.parametrize("impl", ["einsum", "scatter"])
def test_granite_generate_tokens_equal_reference(impl):
    jcfg, tcfg = moe_configs("granite_moe_3b", impl)
    jp = jax_init_params(jax.random.PRNGKey(0), jcfg)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    toks = prompts(2, 8, tcfg.vocab, seed=3)
    want = JaxServer(jcfg, jp, JaxServeConfig(max_len=16, batch_size=2)).generate(toks, 6)
    got = Server(tcfg, tp, ServeConfig(max_len=16, batch_size=2), device="cpu").generate(toks, 6)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_granite_bf16_prefill_logits_match_reference():
    jcfg, tcfg = moe_configs("granite_moe_3b", "scatter", dtype="bfloat16")
    jp = jax_init_params(jax.random.PRNGKey(0), jcfg)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    blk = tp["blocks"][0]["moe"]
    assert blk["router"].dtype == torch.float32 and blk["w_out"].dtype == torch.bfloat16
    toks = prompts(2, 8, tcfg.vocab)
    jl, _ = jax_prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, max_len=12)
    tl, _ = prefill(tp, tcfg, {"tokens": tokens(toks)}, max_len=12)
    want = np.asarray(jl, np.float32)
    assert np.abs(tl.numpy() - want).max() <= 2e-2 * np.abs(want).max()


def test_published_moe_configs_are_accepted_and_init_on_their_shapes():
    """granite and llama4's production configs pass ``check_config`` (the
    shard_map impl runs the scatter path on one card); init keeps the
    router in f32 beside bf16 experts."""
    for arch in ("granite_moe_3b", "llama4_maverick_400b"):
        check_config(TC.production_cfg(TC.get_config(arch)))
    cfg = dataclasses.replace(TC.production_cfg(TC.get_config("granite_moe_3b")), n_layers=1,
                              vocab=1000)
    p = init_params(0, cfg, device="cpu")["blocks"][0]["moe"]
    assert p["router"].shape == (1536, 40) and p["router"].dtype == torch.float32
    assert p["w_gate"].shape == (40, 1536, 512) and p["w_gate"].dtype == torch.bfloat16
    assert p["w_out"].shape == (40, 512, 1536)


def test_launcher_serves_granite_on_cpu_when_asked():
    from repro_torch.launch import serve as launch_serve
    out = launch_serve.main(["--arch", "granite_moe_3b", "--reduced", "--device", "cpu",
                             "--prompt-len", "6", "--steps", "3", "--batch", "2"])
    assert out.shape == (2, 3)
