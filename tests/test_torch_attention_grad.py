"""Attention's gradient in the port against the reference, on the CPU.

The reference trains attention through XLA's autodiff of ``ref.attention``
(its Pallas kernel has no VJP); the port's card path launches a hand-written
backward kernel whose plain version is ``ref.attention_bwd``, the closed
form, from the forward's output and its row log-sum-exp
(``ref.attention_lse``).  Here:

- ``ref.attention_bwd`` and ``ref.attention_lse`` against ``jax.vjp`` of the
  reference's ``ref.attention`` and its masked logsumexp, at every head-dim
  pair the kernels take, causal and not, a window, kv_offset > 0 and < 0,
  GQA groups of 1, 3 and 4, ragged Sq != Skv, and rows with no valid key;
  f32 within 1e-5 x max|ref|, bf16 inputs within the repo's bf16 kernel
  tolerance (2e-2 x max|ref|) of the reference's bf16 result;
- ``_FlashAttentionFunction`` with its two launches faked by their plain
  versions: launch counts with and without ``torch.utils.checkpoint``,
  ``needs_input_grad``, a double backward raising;
- the wrappers' meta branch: the outputs' shapes and dtypes and the work
  each gives the recording trace (``cost.flash_attention_bwd``);
- every reduced attention arch's ``loss_fn`` gradient against
  ``jax.value_and_grad``, remat on and off, each leaf within 1e-4 x its
  max|g| (the two frameworks' CPU matmuls sum in different orders).

The CUDA kernel is held against the plain version on the card in
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
from torch.utils._python_dispatch import TorchDispatchMode

import repro.configs as JC
from repro.kernels import ref as jax_ref
from repro.models import init_params as jax_init_params
from repro.models import transformer as jax_transformer
from repro_torch import configs as TC
from repro_torch.kernels import cost
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref
from repro_torch.models import from_jax_params
from repro_torch.models import transformer as torch_transformer
from repro_torch.optim import tree_leaves

TOL = {"float32": 1e-5, "bfloat16": 2e-2}

# (B, Sq, Skv, Hq, Hkv, causal, window, kv_offset): prefill, GQA g 3 with a
# window (and past twice the window, where both packages' forward takes its
# banded form: v's head dim must equal q's there, so not at MLA's 96 x 64),
# decode-like ragged rows past a prefix, non-causal, g 4 with empty leading
# rows (kv_offset < 0), and empty trailing rows (kv_offset past Skv under a
# window).
CASES = {
    "causal": (2, 12, 12, 4, 2, True, None, 0),
    "window_g3": (1, 14, 14, 6, 2, True, 7, 0),
    "banded_g3": (1, 14, 14, 6, 2, True, 5, 0),
    "ragged_offset": (1, 6, 17, 4, 4, True, None, 11),
    "noncausal_g1": (1, 9, 7, 2, 2, False, None, 0),
    "empty_lead_g4": (1, 10, 10, 4, 1, True, 4, -3),
    "empty_tail": (1, 8, 9, 3, 3, False, 3, 9),
}


def inputs(case, dk, dv, seed=0):
    B, Sq, Skv, Hq, Hkv, *_ = CASES[case]
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, Hq, dk), (B, Skv, Hkv, dk), (B, Skv, Hkv, dv), (B, Sq, Hq, dv))]


def kwargs(case):
    *_, causal, window, kv_offset = CASES[case]
    return dict(causal=causal, window=window, kv_offset=kv_offset)


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def jax_lse(q, k, *, causal, window, kv_offset, scale=None):
    """The reference's masked logits (``ref.attention``'s, -1e30 where
    masked) under ``jax.nn.logsumexp``, as (B, Hq, Sq)."""
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, _ = k.shape
    scale = scale if scale is not None else D ** -0.5
    qf = (jnp.asarray(q) * scale).reshape(B, Sq, Hkv, Hq // Hkv, D)
    logits = jnp.einsum("bqhgd,bkhd->bhgqk", qf, jnp.asarray(k))
    qp, kp = jnp.arange(Sq)[:, None] + kv_offset, jnp.arange(Skv)[None, :]
    mask = jnp.ones((Sq, Skv), bool)
    if causal:
        mask &= kp <= qp
    if window is not None:
        mask &= kp > qp - window
    return jax.nn.logsumexp(jnp.where(mask, logits, -1e30), axis=-1).reshape(B, Hq, Sq)


VJP_CASES = [(dk, dv, case) for dk, dv in fa.HEAD_DIMS for case in CASES
             if not (case == "banded_g3" and dk != dv)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dk,dv,case", VJP_CASES,
                         ids=[f"{dk}x{dv}-{case}" for dk, dv, case in VJP_CASES])
def test_plain_backward_matches_jax_vjp(dk, dv, case, dtype):
    q, k, v, do = inputs(case, dk, dv)
    kw = kwargs(case)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jq, jk, jv, jdo = (jnp.asarray(a, jdt) for a in (q, k, v, do))
    jo, vjp = jax.vjp(lambda a, b, c: jax_ref.attention(a, b, c, **kw), jq, jk, jv)
    want = vjp(jdo)
    tq, tk, tv, tdo = (torch.from_numpy(a).to(tdt) for a in (q, k, v, do))
    to = ref.attention(tq, tk, tv, **kw)
    lse = ref.attention_lse(tq, tk, **kw)
    assert lse.dtype == torch.float32 and lse.shape == (q.shape[0], q.shape[2], q.shape[1])
    assert rel(to.float().numpy(), np.asarray(jo, np.float32)) <= TOL[dtype]
    got = ref.attention_bwd(tq, tk, tv, to, lse, tdo, **kw)
    for g, w, t in zip(got, want, (tq, tk, tv)):
        assert g.dtype == tdt and g.shape == t.shape
        assert rel(g.float().numpy(), np.asarray(w, np.float32)) <= TOL[dtype]


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dk,dv", [(64, 64), (96, 64), (120, 120)], ids=["64", "96x64", "120"])
def test_plain_lse_matches_jax_logsumexp(dk, dv, case):
    """f32 at 1e-5 of |lse| (a row with no valid key at -1e30 in both)."""
    q, k, _, _ = inputs(case, dk, dv, seed=1)
    got = ref.attention_lse(torch.from_numpy(q), torch.from_numpy(k), **kwargs(case)).numpy()
    want = np.asarray(jax_lse(q, k, **kwargs(case)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if case.startswith("empty"):
        assert (got == -1e30).any()


def test_plain_backward_takes_a_scale_and_a_strided_v():
    """MLA's call: q/k of 96, v a strided slice of a wider product, scale
    96^-0.5 given, against jax.vjp with the same scale."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((1, 11, 4, 96)).astype(np.float32)
    k = rng.standard_normal((1, 11, 4, 96)).astype(np.float32)
    kv = rng.standard_normal((1, 11, 4, 160)).astype(np.float32)
    do = rng.standard_normal((1, 11, 4, 64)).astype(np.float32)
    kw = dict(causal=True, scale=0.3)
    _, vjp = jax.vjp(lambda a, b, c: jax_ref.attention(a, b, c, **kw), q, k, kv[..., 96:])
    want = vjp(jnp.asarray(do))
    tv = torch.from_numpy(kv)[..., 96:]
    assert not tv.is_contiguous()
    tq, tk = torch.from_numpy(q), torch.from_numpy(k)
    to = ref.attention(tq, tk, tv, **kw)
    got = ref.attention_bwd(tq, tk, tv, to, ref.attention_lse(tq, tk, **kw),
                            torch.from_numpy(do), **kw)
    for g, w in zip(got, want):
        assert rel(g.numpy(), w) <= 1e-5


# ---------------------------------------------------------------------------
# the autograd Function, its launches faked
# ---------------------------------------------------------------------------

class FakeLaunches:
    """Stands in for the two launches of ``kernels/flash_attention.py`` (the
    forward's ``_forward`` and ``flash_attention_bwd``) with their plain
    versions, counting calls, so the autograd plumbing runs on the CPU."""

    def __init__(self, monkeypatch):
        self.fwd = self.bwd = 0
        self.lse = []

        def fwd(q, k, v, causal, window, scale, kv_offset, with_lse):
            self.fwd += 1
            self.lse.append(with_lse)
            kw = dict(causal=causal, window=window, scale=scale, kv_offset=kv_offset)
            return (ref.attention(q, k, v, **kw),
                    ref.attention_lse(q, k, **kw) if with_lse else None)

        def bwd(q, k, v, o, lse, do, **kw):
            self.bwd += 1
            assert do.is_contiguous() and lse.dtype == torch.float32
            return ref.attention_bwd(q, k, v, o, lse, do, **kw)

        monkeypatch.setattr(fa, "_forward", fwd)
        monkeypatch.setattr(fa, "flash_attention_bwd", bwd)


def qkv(requires=(True, True, True), seed=0, g=2):
    rng = np.random.default_rng(seed)
    ts = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
          for s in ((2, 10, 2 * g, 32), (2, 10, 2, 32), (2, 10, 2, 32))]
    return [t.requires_grad_(r) for t, r in zip(ts, requires)]


def apply(q, k, v, window=None):
    return fa._FlashAttentionFunction.apply(q, k, v, True, window, 32 ** -0.5, 0)


def test_function_carries_gradients_and_counts_launches(monkeypatch):
    """The Function's output carries gradients to q, k and v equal to
    autograd through ``ref.attention`` (1e-5); its forward asks for the lse,
    its backward takes a contiguous dO; under ``torch.utils.checkpoint``
    each call launches its forward twice (run, recompute) and its backward
    once, with the same gradients bit for bit."""
    from torch.utils.checkpoint import checkpoint
    fake = FakeLaunches(monkeypatch)
    q, k, v = qkv()
    y = apply(apply(q, k, v), k, v)
    assert y.grad_fn is not None
    got = torch.autograd.grad((y * y).sum(), (q, k, v))
    assert (fake.fwd, fake.bwd) == (2, 2) and all(fake.lse)
    want = torch.autograd.grad(
        (ref.attention(ref.attention(q, k, v), k, v) ** 2).sum(), (q, k, v))
    for a, b in zip(got, want):
        assert rel(a.numpy(), b.numpy()) <= 1e-5
    fake.fwd = fake.bwd = 0
    y = checkpoint(lambda a, b, c: apply(apply(a, b, c), b, c), q, k, v, use_reentrant=False)
    again = torch.autograd.grad((y * y).sum(), (q, k, v))
    assert (fake.fwd, fake.bwd) == (4, 2)
    for a, b in zip(again, got):
        assert torch.equal(a, b)
    # a transposed output gradient reaches the backward contiguous
    y = apply(q, k, v)
    (gq,) = torch.autograd.grad(y, (q,), torch.ones(y.shape[::-1]).permute(3, 2, 1, 0))
    assert gq.shape == q.shape


@pytest.mark.parametrize("requires", [(True, False, False), (False, True, True),
                                      (False, False, True)], ids=["q", "kv", "v"])
def test_function_returns_only_the_gradients_asked_for(monkeypatch, requires):
    """``needs_input_grad``: an input that does not require grad gets None,
    the others the plain gradient."""
    FakeLaunches(monkeypatch)
    ts = qkv(requires, seed=1)
    y = apply(*ts, window=4)
    asked = [t for t in ts if t.requires_grad]
    got = torch.autograd.grad(y.sum(), asked)
    want = torch.autograd.grad(ref.attention(*ts, window=4).sum(), asked)
    for a, b in zip(got, want):
        assert rel(a.numpy(), b.numpy()) <= 1e-5
    seen = []

    class Spy(fa._FlashAttentionFunction):
        @staticmethod
        def backward(ctx, do):
            out = fa._FlashAttentionFunction.backward(ctx, do)
            seen.append([o is not None for o in out[:3]])
            return out

    torch.autograd.grad(Spy.apply(*ts, True, 4, 32 ** -0.5, 0).sum(), asked)
    assert seen == [list(requires)]


def test_function_refuses_a_double_backward(monkeypatch):
    """A backward that would record a graph (``create_graph=True``, the way
    to a second derivative) raises before the backward kernel runs; the same
    graph then still gives its first derivative."""
    fake = FakeLaunches(monkeypatch)
    q, k, v = qkv()
    y = apply(q, k, v)
    with pytest.raises(NotImplementedError, match="double backward"):
        torch.autograd.grad(y.sum(), (q,), create_graph=True, retain_graph=True)
    assert fake.bwd == 0
    (gq,) = torch.autograd.grad(y.sum(), (q,))
    assert fake.bwd == 1 and gq.shape == q.shape


def test_wrapper_cpu_paths_launch_nothing():
    """On the CPU the wrappers run the plain versions (no Function, no
    launch): a grad-requiring input's gradient is autograd's through
    ``ref.attention``, and ``flash_attention_bwd`` is ``ref.attention_bwd``."""
    n0 = (fa.flash_attention.n_launches, fa.flash_attention_bwd.n_launches)
    q, k, v = qkv()
    y = fa.flash_attention(q, k, v)
    assert type(y.grad_fn).__name__ != "BackwardCFunction"
    with torch.no_grad():
        lse = ref.attention_lse(q, k)
    do = torch.ones_like(y)
    got = fa.flash_attention_bwd(q.detach(), k.detach(), v.detach(), y.detach(), lse, do)
    want = torch.autograd.grad(y, (q, k, v), do)
    for a, b in zip(got, want):
        assert rel(a.numpy(), b.numpy()) <= 1e-5
    assert (fa.flash_attention.n_launches, fa.flash_attention_bwd.n_launches) == n0


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("dk,dv", fa.HEAD_DIMS, ids=[f"{a}x{b}" for a, b in fa.HEAD_DIMS])
def test_meta_branch_shapes_and_work(dk, dv, dtype):
    """On meta tensors under autograd: the forward records
    ``cost.flash_attention`` and the backward ``cost.flash_attention_bwd``
    (at a window and a GQA group of 4), the gradients come back in the
    inputs' shapes and dtypes, nothing launches."""
    B, S, hq, hkv, w = 2, 96, 8, 2, 40
    q, k, v = (torch.empty(s, dtype=dtype, device="meta").requires_grad_(True)
               for s in ((B, S, hq, dk), (B, S, hkv, dk), (B, S, hkv, dv)))
    n0 = (fa.flash_attention.n_launches, fa.flash_attention_bwd.n_launches)
    with Record() as rec:
        y = fa.flash_attention(q, k, v, window=w)
        grads = torch.autograd.grad(y, (q, k, v), torch.empty_like(y))
    assert y.shape == (B, S, hq, dv) and y.dtype == dtype
    for g, t in zip(grads, (q, k, v)):
        assert g.shape == t.shape and g.dtype == dtype and g.is_meta
    eb = q.element_size()
    assert rec.log == [
        ("flash_attention", cost.flash_attention(B, S, S, hq, hkv, dk, dv, eb, True, w)),
        ("flash_attention_bwd", cost.flash_attention_bwd(B, S, S, hq, hkv, dk, dv, eb, True, w))]
    assert (fa.flash_attention.n_launches, fa.flash_attention_bwd.n_launches) == n0


def test_backward_work_counts_five_products_and_each_tensor_once():
    """``cost.flash_attention_bwd``: 2 (3 dk + 2 dv) operations a kept pair
    and query head; q, k, v, o, dO read and dq, dk, dv written in the input
    dtype, the f32 lse read."""
    B, S, hq, hkv, dk, dv = 2, 64, 6, 2, 96, 64
    w = cost.flash_attention_bwd(B, S, S, hq, hkv, dk, dv, 2, True, None)
    pairs = S * (S + 1) // 2
    assert w.flops == 2 * B * hq * (3 * dk + 2 * dv) * pairs
    q, kk, vv, o = B * S * hq * dk, B * S * hkv * dk, B * S * hkv * dv, B * S * hq * dv
    assert w.bytes == 2 * (2 * (q + kk + vv) + 2 * o) + 4 * B * hq * S
    fwd = cost.flash_attention(B, S, S, hq, hkv, dk, dv, 2, True, None)
    assert w.flops * (dk + dv) == fwd.flops * (3 * dk + 2 * dv)


# ---------------------------------------------------------------------------
# whole-model gradients of every attention arch
# ---------------------------------------------------------------------------

ATTENTION_ARCHS = [a for a in TC.ARCH_IDS if a != "xlstm_1p3b"]


@pytest.mark.parametrize("remat", [False, True], ids=["no_remat", "remat"])
@pytest.mark.parametrize("arch", ATTENTION_ARCHS)
def test_attention_arch_grads_match_reference(arch, remat):
    """Reduced (2 layers, d 64, vocab 512), the reference's weights
    converted: ``loss_fn`` at 1e-5 and its gradient over every parameter
    against ``jax.value_and_grad`` of the reference's, each leaf within
    1e-4 x its max|g|.  Embedding-stub archs take embeddings and labels."""
    kw = dict(n_layers=2, d_model=64, vocab=512)
    jcfg, tcfg = JC.get_config(arch).reduced(**kw), TC.get_config(arch).reduced(**kw)
    jp = jax_init_params(jax.random.PRNGKey(0), jcfg)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    rng = np.random.default_rng(5)
    B, S = 2, 24
    if jcfg.embed_stub:
        batch = {"embeds": rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32),
                 "labels": rng.integers(0, jcfg.vocab, (B, S), dtype=np.int32)}
    else:
        batch = {"tokens": rng.integers(0, jcfg.vocab, (B, S), dtype=np.int32)}
    (jloss, _), jg = jax.value_and_grad(
        lambda p: jax_transformer.loss_fn(p, jcfg, {k: jnp.asarray(a) for k, a in batch.items()},
                                          remat=remat), has_aux=True)(jp)
    leaves = tree_leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    loss, _ = torch_transformer.loss_fn(tp, tcfg, {k: torch.from_numpy(a)
                                                   for k, a in batch.items()}, remat=remat)
    # an embedding-stub arch's token table is not read (the reference's
    # gradient of it is zeros)
    got = torch.autograd.grad(loss, leaves, allow_unused=bool(tcfg.embed_stub))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5, atol=1e-5)
    want = tree_leaves(from_jax_params(jax.tree.map(np.asarray, jg), tcfg, device="cpu"))
    assert len(want) == len(got)
    for g, w, t in zip(got, want, leaves):
        g, w = (torch.zeros_like(t) if g is None else g).numpy(), w.numpy()
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= 1e-4 * max(np.abs(w).max(), 1e-30)
