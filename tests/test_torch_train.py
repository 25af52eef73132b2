"""The port's training path against the reference, on the CPU: the RMSNorm
backward's plain version and the autograd Function around the kernels, whole
model gradients, the train step and AdamW, gradient compression, the data
pipeline, checkpoints, the fault-tolerant loop and the elastic re-plans.

Inputs come from seeded numpy generators (or the reference's own weights,
converted) and go to both packages.  Tolerances: the RMSNorm gradient at the
reference's kernel tolerances (f32 3e-5, bf16 2e-2); losses and params at
1e-5; whole-model gradients within 1e-4 x each leaf's max|g| (the
frameworks' CPU matmuls sum in different orders); the data pipeline, the
quantiser and the loop's resume bit for bit.  The CUDA backward kernel is
held against the plain version on the card in ``tests/test_torch_gpu.py``
and ``chip_smoke.py``.
"""

import dataclasses
import json
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import repro.configs as JC
from repro.checkpointing import CheckpointManager as JaxCheckpointManager
from repro.core.profiles import lm_profile as jax_lm_profile
from repro.data import DataConfig as JaxDataConfig
from repro.data import batch_specs as jax_batch_specs
from repro.data.pipeline import _batch_at as jax_batch_at
from repro.kernels import ref as jax_ref
from repro.models import init_params as jax_init_params
from repro.models import transformer as jax_transformer
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import compression as jax_comp
from repro.optim import global_norm as jax_global_norm
from repro.optim import schedule as jax_schedule
from repro.runtime import TrainConfig as JaxTrainConfig
from repro.runtime import elastic as jax_elastic
from repro.runtime import train_loop as jax_train_loop
from repro.runtime.steps import init_opt_state as jax_init_opt_state
from repro.runtime.steps import make_train_step as jax_make_train_step
from repro_torch import configs as TC
from repro_torch.checkpointing import AsyncCheckpointer, CheckpointManager
from repro_torch.core.profiles import lm_profile
from repro_torch.data import DataConfig, DataLoader, batch_specs
from repro_torch.data.pipeline import _batch_at
from repro_torch.kernels import ops
from repro_torch.kernels import ref as torch_ref
from repro_torch.kernels import rmsnorm as rmsnorm_mod
from repro_torch.models import from_jax_params, init_params
from repro_torch.models import transformer as torch_transformer
from repro_torch.optim import AdamWConfig, global_norm, schedule, tree_leaves, tree_map
from repro_torch.optim import compression as torch_comp
from repro_torch.runtime import TrainConfig, elastic, init_opt_state, make_train_step, train_loop

TOL = {"float32": 3e-5, "bfloat16": 2e-2}


def configs(arch="xlstm_1p3b"):
    kw = dict(n_layers=2, d_model=64, vocab=512)
    return JC.get_config(arch).reduced(**kw), TC.get_config(arch).reduced(**kw)


def converted(jcfg, tcfg, seed=0):
    jp = jax_init_params(jax.random.PRNGKey(seed), jcfg)
    return jp, from_jax_params(jax.tree.map(np.asarray, jp), tcfg, device="cpu")


def tokens(B, S, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, S), dtype=np.int32)


def rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max() / max(np.abs(want).max(),
                                                                       1e-30))


# ---------------------------------------------------------------------------
# RMSNorm backward: the plain version and the autograd Function
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 37, 256), (5, 100), (3, 7, 2048)])
def test_rmsnorm_plain_backward_matches_jax_grad(shape, dtype):
    """``ref.rmsnorm_bwd`` (autograd through the plain ``ref.rmsnorm``)
    against ``jax.vjp`` of the reference's ``ref.rmsnorm``: dx and dscale,
    each within the dtype's tolerance of max|ref|."""
    rng = np.random.default_rng(len(shape))
    x, g = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    s = (rng.standard_normal(shape[-1]) * 0.1 + 1).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jx, js, jg = (jnp.asarray(a, jdt) for a in (x, s, g))
    _, vjp = jax.vjp(lambda a, b: jax_ref.rmsnorm(a, b, 1e-5), jx, js)
    jdx, jds = vjp(jg)
    tdx, tds = torch_ref.rmsnorm_bwd(*(torch.from_numpy(a).to(tdt) for a in (x, s, g)))
    assert tdx.dtype == tds.dtype == tdt and tdx.shape == shape
    assert rel(tdx.float().numpy(), np.asarray(jdx, np.float32)) <= TOL[dtype]
    assert rel(tds.float().numpy(), np.asarray(jds, np.float32)) <= TOL[dtype]


class FakeLaunches:
    """Stands in for the two kernel launches of ``kernels/rmsnorm.py`` (the
    forward's ``_forward`` and ``rmsnorm_bwd``) with their plain versions,
    counting calls, so the autograd plumbing around them runs on the CPU."""

    def __init__(self, monkeypatch):
        self.fwd = self.bwd = 0

        def fwd(x, scale, eps):
            self.fwd += 1
            return torch_ref.rmsnorm(x, scale, eps)

        def bwd(x, scale, g, eps=1e-5):
            self.bwd += 1
            assert g.is_contiguous()
            return torch_ref.rmsnorm_bwd(x, scale, g, eps)

        monkeypatch.setattr(rmsnorm_mod, "_forward", fwd)
        monkeypatch.setattr(rmsnorm_mod, "rmsnorm_bwd", bwd)


def test_rmsnorm_function_carries_gradients_to_x_and_scale(monkeypatch):
    """The Function's output carries a gradient to x and to scale, equal to
    autograd through the plain version; under ``torch.utils.checkpoint``
    each norm launches its forward twice (run, recompute) and its backward
    once."""
    from torch.utils.checkpoint import checkpoint
    fake = FakeLaunches(monkeypatch)
    norm = rmsnorm_mod._RmsnormFunction.apply
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((6, 32)).astype(np.float32)).requires_grad_(True)
    s = torch.from_numpy((rng.standard_normal(32) * 0.1 + 1).astype(np.float32)
                         ).requires_grad_(True)
    y = norm(norm(x, s, 1e-5), s, 1e-5)
    assert y.grad_fn is not None
    got = torch.autograd.grad((y * y).sum(), (x, s))
    assert (fake.fwd, fake.bwd) == (2, 2)
    want = torch.autograd.grad((torch_ref.rmsnorm(torch_ref.rmsnorm(x, s), s) ** 2).sum(), (x, s))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    fake.fwd = fake.bwd = 0
    y = checkpoint(lambda a, b: norm(norm(a, b, 1e-5), b, 1e-5), x, s, use_reentrant=False)
    again = torch.autograd.grad((y * y).sum(), (x, s))
    assert (fake.fwd, fake.bwd) == (4, 2)
    for a, b in zip(again, got):
        assert torch.equal(a, b)
    # only x requires grad: no gradient is made for scale
    xs = x.detach().requires_grad_(True)
    (gx,) = torch.autograd.grad(norm(xs, s.detach(), 1e-5).sum(), (xs,))
    torch.testing.assert_close(gx, torch_ref.rmsnorm_bwd(xs, s, torch.ones_like(xs))[0])


def test_rmsnorm_bwd_plan():
    """The backward's launch: 16-byte vectors where aligned, a team of the
    fewest threads (a warp at least, a block at most) that hold a row in 2
    accesses each, 512-thread blocks of teams, at most one block an SM and
    no more than the rows need; rows wider than a block holds are refused."""
    plan = rmsnorm_mod.rmsnorm_bwd_plan
    assert plan(2048, 2, True, 2048, 132) == (8, 2, 128, 132)   # xlstm's train d
    assert plan(4096, 2, True, 2048, 132) == (8, 2, 256, 132)   # its mLSTM inner
    assert plan(2048, 4, True, 2048, 132) == (4, 2, 256, 132)
    assert plan(4096, 2, True, 4, 132) == (8, 2, 256, 2)
    assert plan(64, 2, True, 100, 132) == (8, 1, 32, 7)         # 16 teams a block
    assert plan(1600, 2, True, 2048, 132) == (8, 2, 128, 132)   # 200 of 256 vectors
    assert plan(100, 2, True, 5, 132) == (1, 2, 64, 1)          # d not a multiple of 8
    assert plan(2048, 2, False, 6, 132) == (1, 4, 512, 6)       # unaligned: the scalar path
    assert plan(16384, 2, True, 2, 132) == (8, 4, 512, 2)
    assert plan(16392, 2, True, 2, 132) is None and plan(2056, 2, False, 2, 132) is None
    assert [rmsnorm_mod.max_bwd_d(v) for v in (8, 4, 1)] == [16384, 8192, 2048]


@pytest.mark.parametrize("d,elem_bytes,aligned", [
    (2048, 2, True), (4096, 2, True), (1600, 2, True), (3200, 2, True), (2560, 2, True),
    (768, 2, True), (256, 2, True), (1536, 2, True), (2048, 4, True), (100, 2, True),
    (8192, 4, True), (2048, 2, False), (7, 4, False)])
@pytest.mark.parametrize("n_rows", [1, 4, 300, 2048])
def test_rmsnorm_bwd_plan_holds_each_row_in_registers(d, elem_bytes, aligned, n_rows):
    """At every width the training paths and the sweeps give the norm: the
    team's accesses cover the row (at most 4 a thread, the team a power of
    two from a warp to a block, no narrower team holds it in 2 accesses a
    thread), and every team
    of the grid has a row to start on unless the rows run out first."""
    p = rmsnorm_mod.rmsnorm_bwd_plan(d, elem_bytes, aligned, n_rows, 132)
    nv = d // p.vec
    assert p.vec == (16 // elem_bytes if aligned and d % (16 // elem_bytes) == 0 else 1)
    assert p.vpt in rmsnorm_mod.BWD_VPT_CHOICES and p.vpt * p.tpr >= nv
    assert p.tpr & (p.tpr - 1) == 0 and 32 <= p.tpr <= rmsnorm_mod.BWD_THREADS
    assert p.tpr == 32 or (p.tpr // 2) * rmsnorm_mod.BWD_TARGET_VPT < nv
    teams = rmsnorm_mod.BWD_THREADS // p.tpr
    assert 1 <= p.blocks <= 132 and (p.blocks - 1) * teams < n_rows


def emulate_bwd(x, s, g, plan, eps=1e-5):
    """csrc/rmsnorm.cu's backward schedule in f32: team t of block b takes
    rows b*teams + t, then every (blocks*teams)-th row after it; a thread's
    columns sum g*(x*r) over its team's rows in that order; a block's
    partial adds its teams' sums in team order; the dscale kernel sums
    the partials over blocks in 16 interleaved groups (each in steps of 8
    loads), then the groups in order.  Returns (dx, dscale, rows visited)."""
    n, d = x.shape
    teams = rmsnorm_mod.BWD_THREADS // plan.tpr
    stride = plan.blocks * teams
    xf, gf, sf = x.float(), g.float(), s.float()
    dx = torch.empty_like(xf)
    seen = torch.zeros(n, dtype=torch.int64)
    part = torch.zeros(plan.blocks, d)
    for b in range(plan.blocks):
        for t in range(teams):
            acc = torch.zeros(d)
            for row in range(b * teams + t, n, stride):
                seen[row] += 1
                r = torch.rsqrt((xf[row] * xf[row]).sum() / d + eps)
                c = r * r * r * ((gf[row] * sf * xf[row]).sum() / d)
                dx[row] = (gf[row] * sf) * r - xf[row] * c
                acc = acc + gf[row] * (xf[row] * r)
            part[b] = acc if t == 0 else part[b] + acc
    groups = []
    for y in range(16):
        acc = torch.zeros(d)
        for b0 in range(y, plan.blocks, 16 * 8):
            for u in range(8):
                if b0 + 16 * u < plan.blocks:
                    acc = acc + part[b0 + 16 * u]
        groups.append(acc)
    ds = groups[0]
    for grp in groups[1:]:
        ds = ds + grp
    return dx, ds, seen


@pytest.mark.parametrize("n,d,sms", [(300, 64, 132), (2048, 256, 132), (37, 512, 4),
                                     (9, 1600, 2)])
def test_rmsnorm_bwd_schedule_emulation_matches_plain(n, d, sms):
    """The kernel's row assignment visits every row exactly once, and its
    fixed-order sums (teams, blocks, the 16 groups) give dx and dscale
    within f32's 3e-5 of autograd through the plain rmsnorm."""
    x, g = (torch.from_numpy(np.random.default_rng(i).standard_normal((n, d)).astype(np.float32))
            for i in (0, 2))
    s = torch.from_numpy(np.random.default_rng(1).standard_normal(d).astype(np.float32)) * 0.1 + 1
    plan = rmsnorm_mod.rmsnorm_bwd_plan(d, 4, True, n, sms)
    dx, ds, seen = emulate_bwd(x, s, g, plan)
    assert torch.equal(seen, torch.ones(n, dtype=torch.int64))
    px, ps = torch_ref.rmsnorm_bwd(x, s, g)
    for got, want in ((dx, px), (ds, ps)):
        err = (got - want).abs().max() / want.abs().max()
        assert err <= TOL["float32"], err.item()


def test_rmsnorm_wrapper_cpu_paths_launch_nothing():
    """On the CPU both wrappers run their plain versions, with or without
    grad; no launch is counted."""
    x = torch.randn(4, 64, requires_grad=True)
    s = torch.ones(64, requires_grad=True)
    n0 = (rmsnorm_mod.rmsnorm.n_launches, rmsnorm_mod.rmsnorm_bwd.n_launches)
    y = rmsnorm_mod.rmsnorm(x, s)
    y.sum().backward()
    dx, ds = rmsnorm_mod.rmsnorm_bwd(x.detach(), s.detach(), torch.ones(4, 64))
    torch.testing.assert_close(dx, x.grad)
    torch.testing.assert_close(ds, s.grad)
    assert (rmsnorm_mod.rmsnorm.n_launches, rmsnorm_mod.rmsnorm_bwd.n_launches) == n0


# ---------------------------------------------------------------------------
# model gradients, the train step, AdamW, compression
# ---------------------------------------------------------------------------

def torch_grads(tp, tcfg, batch, remat=False):
    leaves = tree_leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    loss, _ = torch_transformer.loss_fn(tp, tcfg, batch, remat=remat)
    grads = torch.autograd.grad(loss, leaves)
    for t in leaves:
        t.requires_grad_(False)
    return loss.item(), [g.numpy() for g in grads]


@pytest.mark.parametrize("arch", ["xlstm_1p3b", "internlm2_1p8b"])
def test_model_grads_match_reference(arch):
    """``loss_fn`` and its gradient over every parameter against
    ``jax.value_and_grad`` of the reference's: loss at 1e-5, each leaf
    within 1e-4 x its max|g| (remat on, as the train step runs it)."""
    jcfg, tcfg = configs(arch)
    jp, tp = converted(jcfg, tcfg)
    toks = tokens(2, 24, jcfg.vocab, seed=5)
    (jloss, _), jg = jax.value_and_grad(
        lambda p: jax_transformer.loss_fn(p, jcfg, {"tokens": jnp.asarray(toks)}, remat=True),
        has_aux=True)(jp)
    tloss, tg = torch_grads(tp, tcfg, {"tokens": torch.from_numpy(toks)}, remat=True)
    np.testing.assert_allclose(tloss, float(jloss), rtol=1e-5, atol=1e-5)
    want = tree_leaves(from_jax_params(jax.tree.map(np.asarray, jg), tcfg, device="cpu"))
    assert len(want) == len(tg)
    for g, w in zip(tg, want):
        w = w.numpy()
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= 1e-4 * max(np.abs(w).max(), 1e-30)


@pytest.mark.parametrize("compression", [False, True])
def test_three_train_steps_match_reference(compression):
    """The eager train step (remat, AdamW with warm-up 2, optionally int8
    compression with error feedback) against the reference's jitted one for
    three steps: each step's loss, grad norm and lr within 1e-5 (the later
    losses see the earlier updates), and the params after the first step
    within 1e-5.  Later params are not compared element by element: where a
    gradient is rounding noise (the sLSTM bias's z part gets ~1e-11 where
    the reference gets 0), AdamW divides it by sqrt(v) + 1e-8 and turns it
    into a step of up to a few percent of lr; AdamW itself is held on equal
    gradients below."""
    jcfg, tcfg = configs()
    jp, tp = converted(jcfg, tcfg, seed=1)
    jt = JaxTrainConfig(grad_compression=compression,
                        optimizer=JaxAdamWConfig(warmup_steps=2, total_steps=10))
    tt = TrainConfig(grad_compression=compression,
                     optimizer=AdamWConfig(warmup_steps=2, total_steps=10))
    jstep = jax.jit(jax_make_train_step(jcfg, jt))
    tstep = make_train_step(tcfg, tt)
    jopt, topt = jax_init_opt_state(jp, jt), init_opt_state(tp, tt)
    assert set(topt) == set(jopt)
    for i in range(3):
        toks = tokens(2, 16, jcfg.vocab, seed=10 + i)
        jp, jopt, jm = jstep(jp, jopt, {"tokens": jnp.asarray(toks)})
        tp, topt, tm = tstep(tp, topt, {"tokens": torch.from_numpy(toks)})
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-5, atol=1e-5,
                                       err_msg=f"step {i} {key}")
        if i == 0:
            want = from_jax_params(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
            for a, b in zip(tree_leaves(tp), tree_leaves(want)):
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)
    assert int(topt["step"]) == int(jopt["step"]) == 3 and topt["step"].dtype == torch.int32
    assert all(not t.requires_grad for t in tree_leaves(tp))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_three_steps_match_reference(dtype):
    """``adamw.update`` on the same gradients as the reference's, three
    steps (clipping active on the second): params, m and v within 1e-5 (a
    bf16 param within one bf16 rounding, 2^-8 of its magnitude)."""
    from repro.optim import init as jax_adam_init
    from repro.optim import update as jax_adam_update
    from repro_torch.optim import init as adam_init
    from repro_torch.optim import update as adam_update
    rng = np.random.default_rng(4)
    params = {"w": rng.standard_normal((16, 8)).astype(np.float32) * 0.1,
              "b": [rng.standard_normal(8).astype(np.float32), np.float32(0.5) * np.ones(3,
                                                                                     np.float32)]}
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jdt), params)
    tp = tree_map(lambda a: torch.from_numpy(np.array(a)).to(tdt), params)
    cfg, jcfg = AdamWConfig(warmup_steps=2, total_steps=10), \
        JaxAdamWConfig(warmup_steps=2, total_steps=10)
    jst, tst = jax_adam_init(jp), adam_init(tp)
    for i in range(3):
        grads = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32)
                             * (30.0 if i == 1 else 0.3), params)
        jp, jst, jm = jax_adam_update(jcfg, jax.tree.map(jnp.asarray, grads), jst, jp)
        tp, tst, tm = adam_update(cfg, tree_map(torch.from_numpy, grads), tst, tp)
        np.testing.assert_allclose(tm["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-6)
        tol = dict(rtol=2.0 ** -8, atol=1e-5) if dtype == "bfloat16" else dict(rtol=1e-5,
                                                                               atol=1e-5)
        for a, b in zip(tree_leaves(tp), jax.tree.leaves(jp)):
            assert a.dtype == tdt
            np.testing.assert_allclose(a.float().numpy(), np.asarray(b, np.float32), **tol)
        for a, b in zip(tree_leaves((tst["m"], tst["v"])), jax.tree.leaves((jst["m"], jst["v"]))):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
    assert int(tst["step"]) == 3


@pytest.mark.parametrize("cfg", [dict(), dict(warmup_steps=0, total_steps=50),
                                 dict(lr=1e-3, warmup_steps=10, total_steps=10)])
def test_schedule_and_global_norm_match_reference(cfg):
    steps = [0, 1, 5, 10, 50, 99, 100, 101, 5000, 9999, 10000, 20000]
    for s in steps:
        got = schedule(AdamWConfig(**cfg), torch.tensor(s, dtype=torch.int32))
        want = jax_schedule(JaxAdamWConfig(**cfg), jnp.int32(s))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, atol=1e-12)
    rng = np.random.default_rng(0)
    tree = {"a": rng.standard_normal((3, 5)).astype(np.float32),
            "b": [rng.standard_normal(7).astype(np.float32), {"c": np.float32(2.5)}]}
    got = global_norm(tree_map(lambda a: torch.as_tensor(a), tree))
    np.testing.assert_allclose(got.item(), float(jax_global_norm(tree)), rtol=1e-6)


def test_compression_matches_reference():
    """int8 quantisation bit for bit; three rounds of error feedback at 1e-6."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((40, 9)).astype(np.float32)
    q, s = torch_comp.quantize(torch.from_numpy(x))
    jq, js = jax_comp.quantize(jnp.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s.item() == float(js)
    np.testing.assert_array_equal(torch_comp.dequantize(q, s).numpy(),
                                  np.asarray(jax_comp.dequantize(jq, js)))
    grads = {"w": x, "v": [rng.standard_normal(5).astype(np.float32)]}
    terr = torch_comp.init_error(tree_map(torch.from_numpy, grads))
    jerr = jax_comp.init_error(grads)
    for _ in range(3):
        tg, terr = torch_comp.compress_with_feedback(tree_map(torch.from_numpy, grads), terr)
        jg, jerr = jax_comp.compress_with_feedback(grads, jerr)
        for a, b in zip(tree_leaves(tg) + tree_leaves(terr), jax.tree.leaves(jg)
                        + jax.tree.leaves(jerr)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)


def test_train_step_norm_calls_match_the_card_path(monkeypatch):
    """The train step reaches the norm's dispatch as the card path launches
    its kernel: with remat, at xlstm's full depth (48 layers, 6 groups of
    16 norms), 193 forward calls a step (each group's norms twice, the final
    norm once).  chip_smoke.py holds the card to this count, and to 97
    backward launches."""
    calls = []
    real = ops.rmsnorm
    monkeypatch.setattr(ops, "rmsnorm", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    cfg = TC.get_config("xlstm_1p3b").reduced(n_layers=48, d_model=32, vocab=256)
    assert cfg.block_pattern == TC.get_config("xlstm_1p3b").block_pattern
    params = init_params(0, cfg, device="cpu")
    tcfg = TrainConfig()
    step = make_train_step(cfg, tcfg)
    step(params, init_opt_state(params, tcfg), {"tokens": torch.zeros(2, 4, dtype=torch.int32)})
    assert len(calls) == 2 * 6 * 16 + 1


# ---------------------------------------------------------------------------
# data, checkpoints, the loop, elastic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("embed", [None, 16])
def test_batch_at_is_bitwise_the_reference(embed):
    kw = dict(vocab=300, seq_len=12, global_batch=4, seed=7, embed_stub_dim=embed)
    for step in (0, 1, 5):
        for host, hosts in ((0, 1), (0, 2), (1, 2)):
            got = _batch_at(DataConfig(**kw), step, host, hosts)
            want = jax_batch_at(JaxDataConfig(**kw), step, host, hosts)
            assert set(got) == set(want)
            for k in got:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])


def test_data_loader_resume_sharding_and_specs():
    cfg = DataConfig(vocab=64, seq_len=8, global_batch=4)
    first = DataLoader(cfg, device="cpu")
    batches = [next(first) for _ in range(5)]
    first.close()
    assert batches[0]["tokens"].dtype == torch.int32 and batches[0]["tokens"].device.type == "cpu"
    resumed = DataLoader(cfg, start_step=3, device="cpu")
    assert torch.equal(next(resumed)["tokens"], batches[3]["tokens"])
    resumed.close()
    h0, h1 = (DataLoader(cfg, host_id=h, num_hosts=2, device="cpu") for h in (0, 1))
    a, b = next(h0), next(h1)
    h0.close(), h1.close()
    assert a["tokens"].shape == (2, 8) and not torch.equal(a["tokens"], b["tokens"])
    for c in (cfg, DataConfig(vocab=64, seq_len=8, global_batch=4, embed_stub_dim=16)):
        got = batch_specs(c)
        want = jax_batch_specs(JaxDataConfig(**dataclasses.asdict(c)))
        assert {k: shape for k, (shape, _) in got.items()} == {k: v.shape for k, v in want.items()}


def sample_tree():
    g = torch.Generator().manual_seed(0)
    return {"a": torch.randn(2, 3, generator=g),
            "b": [torch.randn(5, generator=g).bfloat16(),
                  {"c": torch.tensor(7, dtype=torch.int32)}]}


def test_checkpoint_roundtrip_atomicity_and_bf16(tmp_path):
    tree = sample_tree()
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3):
        mgr.save(s, tree, extra={"next_step": s + 1})
    assert mgr.all_steps() == [2, 3] and mgr.latest_step() == 3
    assert not list(tmp_path.glob("*.tmp"))            # no partial write left visible
    manifest = json.loads((tmp_path / "step_00000003" / "manifest.json").read_text())
    assert manifest["leaves"]["b/0"]["dtype"] == "bfloat16"
    assert np.load(tmp_path / "step_00000003" / "b__0.npy").dtype == np.uint16
    restored, extra = mgr.restore(3, tree)
    assert extra == {"next_step": 4}
    for a, b in zip(tree_leaves(restored), tree_leaves(tree)):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
    # a stale temp directory of an interrupted write is replaced, not published
    (tmp_path / "step_00000004.tmp").mkdir()
    (tmp_path / "step_00000004.tmp" / "junk.npy").write_text("x")
    assert mgr.all_steps() == [2, 3]
    mgr.save(4, tree)
    assert mgr.all_steps() == [3, 4] and not (tmp_path / "step_00000004" / "junk.npy").exists()


def test_async_checkpointer_snapshot_isolation(tmp_path):
    w = torch.zeros(4)
    ck = AsyncCheckpointer(CheckpointManager(tmp_path))
    ck.save(0, {"w": w})
    w += 99.0  # an in-place update after the snapshot: the save holds the old value
    ck.wait()
    restored, _ = CheckpointManager(tmp_path).restore(0, {"w": w})
    assert torch.equal(restored["w"], torch.zeros(4))


def test_reference_checkpoint_restores_into_the_port(tmp_path):
    """A checkpoint the reference's CheckpointManager wrote (f32 params and
    AdamW state of reduced xlstm, stacked) restores into the port, leaf for
    leaf, bit for bit; its params then convert to the port's layers."""
    jcfg, tcfg = configs()
    jp = jax_init_params(jax.random.PRNGKey(2), jcfg)
    jopt = jax_init_opt_state(jp, JaxTrainConfig())
    JaxCheckpointManager(tmp_path).save(5, (jp, jopt), extra={"next_step": 6})
    template = jax.tree.map(lambda a: torch.zeros(a.shape, dtype=getattr(torch, str(a.dtype))),
                            (jp, jopt))
    restored, extra = CheckpointManager(tmp_path).restore(5, template)
    assert extra == {"next_step": 6}
    got, want = tree_leaves(restored), jax.tree.leaves((jp, jopt))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    tp = from_jax_params(jax.tree.map(lambda t: t.numpy(), restored[0]), tcfg, device="cpu")
    assert tp["blocks"][1]["slstm"]["r"].shape == (4, 16, 64)


def test_train_resume_exact(tmp_path):
    """A crash at step 7, a restart from step 4's checkpoint: the resumed
    losses, the final params and the optimizer state equal an uninterrupted
    run's bit for bit."""
    cfg = TC.get_config("xlstm_1p3b").reduced(n_layers=2, d_model=64, vocab=256)
    tcfg = TrainConfig(optimizer=AdamWConfig(warmup_steps=2, total_steps=10))
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=2)
    lcfg = train_loop.LoopConfig(total_steps=10, ckpt_every=5, ckpt_dir=str(tmp_path / "run"))
    ref = train_loop.run(cfg, tcfg, dataclasses.replace(lcfg, ckpt_dir=str(tmp_path / "ref")),
                         dcfg, device="cpu")
    fired = []

    def fail_at(s):
        if s == 7 and not fired:
            fired.append(s)
            return True
        return False

    out = train_loop.run_with_restarts(cfg, tcfg, lcfg, dcfg, fail_at=fail_at, device="cpu")
    assert out["restarts"] == 1 and len(ref["losses"]) == 10 and len(ref["walls"]) == 10
    assert out["losses"] == ref["losses"][5:]
    for a, b in zip(tree_leaves((out["params"], out["opt_state"])),
                    tree_leaves((ref["params"], ref["opt_state"]))):
        assert a.shape == b.shape and torch.equal(a, b)


def test_straggler_detector_matches_reference():
    det = train_loop.StragglerDetector(train_loop.LoopConfig())
    jdet = jax_train_loop.StragglerDetector(jax_train_loop.LoopConfig())
    walls = [1.0] * 10 + [10.0, 1.0, 1.2, 5.0, 0.9, 2.9]
    flags = [det.observe(i, w) for i, w in enumerate(walls)]
    assert flags == [jdet.observe(i, w) for i, w in enumerate(walls)]
    assert flags[10] and not flags[11]
    assert det.events == jdet.events and det.ewma == jdet.ewma


def stages(xs):
    return [dataclasses.astuple(s) for s in xs]


def test_elastic_replans_match_reference():
    for n, mp in ((256, 16), (240, 16), (12, 16), (7, 4), (1, 8)):
        got, want = elastic.plan_elastic_mesh(n, model_parallel=mp), \
            jax_elastic.plan_elastic_mesh(n, model_parallel=mp)
        assert (got.data, got.model, got.devices) == (want.data, want.model, want.devices)
    kw = dict(name="toy", n_layers=8, d_model=256, n_heads=4, n_kv=4, d_ff=512, vocab=1000,
              seq=128)
    prof, jprof = lm_profile(**kw), jax_lm_profile(**kw)
    failed = np.array([False, True, False, False])
    got = elastic.replan_placement(prof, n_groups=4, hbm_bytes=prof.total_memory / 2.5,
                                   flops_budget=1e18, failed=failed)
    want = jax_elastic.replan_placement(jprof, n_groups=4, hbm_bytes=jprof.total_memory / 2.5,
                                        flops_budget=1e18, failed=failed)
    assert stages(got) == stages(want) and all(s.node != 1 for s in got)
    slow = np.ones((3, 4))
    slow[1:, 2] = 4.0  # node 2 degrades over the horizon
    got = elastic.predictive_replan(prof, n_groups=4, hbm_bytes=prof.total_memory / 2.5,
                                    flops_budget=1e18, predicted_slowdown=slow)
    want = jax_elastic.predictive_replan(jprof, n_groups=4, hbm_bytes=jprof.total_memory / 2.5,
                                         flops_budget=1e18, predicted_slowdown=slow)
    assert stages(got) == stages(want)


def test_train_launcher_runs_on_cpu_when_asked(tmp_path):
    from repro_torch.launch import train as launch_train
    out = launch_train.main(["--arch", "xlstm_1p3b", "--device", "cpu", "--steps", "2",
                             "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path)])
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    assert CheckpointManager(tmp_path).latest_step() == 1
    with tempfile.TemporaryDirectory() as d:  # a fresh directory: the loop starts at 0
        out = launch_train.main(["--arch", "internlm2_1p8b", "--device", "cpu", "--steps", "1",
                                 "--batch", "2", "--seq", "8", "--ckpt-dir", d])
        assert len(out["losses"]) == 1
