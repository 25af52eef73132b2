"""The port's kernels against the reference's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; it is held against
the reference's Pallas function in interpret mode over the same shape sweep
and tolerances as ``tests/test_kernels.py``.  Inputs come from a seeded numpy
generator and go to both packages.  The CUDA kernels themselves are held
against these plain versions on the card in ``tests/test_torch_gpu.py``; the
arithmetic the kernels do differently from their plain versions (flash
attention's bf16 tensor-core scheme, decode attention's split-K combine) is
emulated here in plain PyTorch and held against the Pallas kernels too.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels.decode_attention import decode_attention as pallas_decode_attention
from repro.kernels.flash_attention import flash_attention as pallas_flash_attention
from repro.kernels.rmsnorm import rmsnorm as pallas_rmsnorm
from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import (BLOCKS_PER_SM, MIN_SPLIT, decode_attention,
                                                  num_splits, split_plan)
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.rmsnorm import VPT_CHOICES, rmsnorm, rmsnorm_plan

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}

FLASH_CASES = [  # B, Sq, Skv, Hq, Hkv, D, causal, window, kv_offset
    (2, 128, 128, 4, 2, 64, True, None, 0),
    (1, 100, 100, 3, 1, 32, True, None, 0),
    (2, 64, 192, 4, 4, 64, True, None, 128),
    (1, 256, 256, 8, 2, 64, True, 64, 0),
    (2, 128, 128, 4, 2, 64, False, None, 0),
    (1, 64, 64, 2, 2, 128, True, None, 0),
]
DECODE_CASES = [  # B, Smax, Hq, Hkv, D, valid length
    (2, 256, 4, 2, 64, 100), (3, 100, 6, 6, 32, 100),
    (2, 512, 8, 2, 128, 511), (1, 64, 4, 1, 64, 64),
]
RMSNORM_SHAPES = [(4, 37, 256), (2, 8, 64), (1, 1, 512)]


def tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" else dict(rtol=3e-5, atol=3e-5)


def normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def both(a, name):
    jdt, tdt = DTYPES[name]
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def f32(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,D,causal,window,off", FLASH_CASES)
def test_flash_attention_plain_matches_pallas(B, Sq, Skv, Hq, Hkv, D, causal, window, off,
                                              name):
    (jq, tq), (jk, tk), (jv, tv) = (both(normal(i, B, s, h, D), name)
                                    for i, (s, h) in enumerate([(Sq, Hq), (Skv, Hkv), (Skv, Hkv)]))
    kw = dict(causal=causal, window=window, kv_offset=off)
    got = flash_attention(tq, tk, tv, **kw)
    want = pallas_flash_attention(jq, jk, jv, **kw, block_q=32, block_k=32, interpret=True)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(f32(got), f32(want), **tol(name))


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("B,Smax,Hq,Hkv,D,ln", DECODE_CASES)
def test_decode_attention_plain_matches_pallas(B, Smax, Hq, Hkv, D, ln, name):
    jq, tq = both(normal(0, B, Hq, D), name)
    jk, tk = both(normal(1, B, Smax, Hkv, D), name)
    jv, tv = both(normal(2, B, Smax, Hkv, D), name)
    got = decode_attention(tq, tk, tv, ln)
    want = pallas_decode_attention(jq, jk, jv, ln, block_k=64, interpret=True)
    np.testing.assert_allclose(f32(got), f32(want), **tol(name))


def test_decode_attention_per_seq_lengths_plain_matches_pallas():
    jq, tq = both(normal(0, 3, 4, 32), "float32")
    jk, tk = both(normal(1, 3, 128, 2, 32), "float32")
    jv, tv = both(normal(2, 3, 128, 2, 32), "float32")
    lens = np.array([5, 77, 128], np.int32)
    got = decode_attention(tq, tk, tv, torch.from_numpy(lens))
    want = pallas_decode_attention(jq, jk, jv, jnp.asarray(lens), block_k=32, interpret=True)
    np.testing.assert_allclose(f32(got), f32(want), rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("shape", RMSNORM_SHAPES)
def test_rmsnorm_plain_matches_pallas(shape, name):
    jx, tx = both(normal(0, *shape), name)
    s = normal(1, shape[-1]) * 0.1 + 1
    got = rmsnorm(tx, torch.from_numpy(s))
    want = pallas_rmsnorm(jx, jnp.asarray(s), block_rows=16, interpret=True)
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(f32(got), f32(want), **tol(name))


# --- Banded sliding-window attention (the plain path's long-prompt form) ---

from repro.kernels import ref as jax_ref  # noqa: E402

BANDED_CASES = [  # B, S, Hq, Hkv, D, window: S past twice the window, ragged or whole blocks
    (2, 70, 4, 2, 32, 16), (1, 128, 2, 2, 64, 32), (1, 200, 6, 2, 32, 24), (2, 33, 2, 1, 16, 16)]


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("B,S,Hq,Hkv,D,window", BANDED_CASES)
def test_banded_attention_matches_reference_banded(B, S, Hq, Hkv, D, window, name):
    """At S > 2·window the plain ``attention`` takes the banded O(S·window)
    form (the same tensor as ``attention_banded``), as the reference does:
    held against the reference's ``attention_banded``."""
    (jq, tq), (jk, tk), (jv, tv) = (both(normal(i, B, S, h, D), name)
                                    for i, h in enumerate((Hq, Hkv, Hkv)))
    got = ref.attention(tq, tk, tv, window=window)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    assert torch.equal(got, ref.attention_banded(tq, tk, tv, window=window))
    np.testing.assert_allclose(f32(got), f32(jax_ref.attention_banded(jq, jk, jv, window=window)),
                               **tol(name))


@pytest.mark.parametrize("window", [16, 24])
def test_banded_equals_the_masked_form_in_f32(window):
    """The band holds each row's whole window: the masked O(S²) form (here a
    query block on its own, so Sq != Skv keeps it masked) agrees within f32
    summation order."""
    q, k, v = (torch.from_numpy(normal(i, 1, 100, 2, 32)) for i in range(3))
    banded = ref.attention(q, k, v, window=window)
    masked = torch.cat([ref.attention(q[:, i:i + 10], k[:, :i + 10], v[:, :i + 10],
                                      window=window, kv_offset=i) for i in range(0, 100, 10)], 1)
    np.testing.assert_allclose(banded.numpy(), masked.numpy(), rtol=3e-5, atol=3e-5)


# --- The redesigned kernels' arithmetic, emulated in plain PyTorch ---------

LOG2E = 1.4426950408889634
H100_SMS = 132


def split_decode(q, kc, vc, cache_len, splits, chunk):
    """csrc/decode_attention.cu's algorithm: each split s of the slots
    [s*chunk, (s+1)*chunk) within a sequence's valid range keeps (m, l, acc)
    in log2 units of the pre-scaled q; a split with no slot writes (-1e30,
    0, 0); the combine weighs the splits by 2^(m_s - M) over those with
    l > 0.  With no valid slot every Smax slot counts at logit -1e30."""
    B, Hq, D = q.shape
    _, Smax, Hkv, _ = kc.shape
    g = Hq // Hkv
    qf = q.float().reshape(B, Hkv, g, D) * (D ** -0.5 * LOG2E)
    lens = torch.as_tensor(cache_len).broadcast_to((B,)).clamp(max=Smax)
    out = torch.empty(B, Hkv, g, D)
    for b in range(B):
        n = int(lens[b])
        none = n <= 0
        n = Smax if none else n
        ms, ls, accs = [], [], []
        for s in range(splits):
            lo, hi = s * chunk, min((s + 1) * chunk, n)
            if lo >= hi:
                ms.append(torch.full((Hkv, g), -1e30))
                ls.append(torch.zeros(Hkv, g))
                accs.append(torch.zeros(Hkv, g, D))
                continue
            sc = torch.einsum("hgd,khd->hgk", qf[b], kc[b, lo:hi].float())
            if none:
                sc = torch.full_like(sc, -1e30)
            m = sc.amax(-1)
            p = torch.exp2(sc - m[..., None])
            ms.append(m)
            ls.append(p.sum(-1))
            accs.append(torch.einsum("hgk,khd->hgd", p, vc[b, lo:hi].float()))
        m, l, acc = torch.stack(ms), torch.stack(ls), torch.stack(accs)
        big = torch.where(l > 0, m, torch.tensor(-torch.inf)).amax(0)
        w = torch.where(l > 0, torch.exp2(m - big), torch.zeros(()))
        out[b] = (w[..., None] * acc).sum(0) / torch.clamp((w * l).sum(0), min=1e-30)[..., None]
    return out.reshape(B, Hq, D).to(q.dtype)


SPLIT_CASES = DECODE_CASES + [  # + no valid slot, and hymba's group of 5 at D 64
    (2, 96, 4, 2, 64, 0), (2, 256, 25, 5, 64, 200)]
SPLIT_MODES = ("host", "ragged", "past")


def split_for(mode, B, Hkv, Smax, ln):
    """host: split_plan's own choice; ragged: 3 splits that do not divide the
    length; past: quarters of Smax and two splits more, wholly past it."""
    splits, chunk = split_plan(B, Hkv, Smax, ln, H100_SMS)
    if mode == "past":
        return 6, -(-Smax // 4)
    k = {"host": splits, "ragged": 3}[mode]
    return k, -(-min(splits * chunk, Smax) // k)


@functools.lru_cache(maxsize=None)
def _pallas_decode(B, Smax, Hq, Hkv, D, lens, name, block_k):
    jq, _ = both(normal(0, B, Hq, D), name)
    jk, _ = both(normal(1, B, Smax, Hkv, D), name)
    jv, _ = both(normal(2, B, Smax, Hkv, D), name)
    ln = jnp.asarray(np.array(lens, np.int32)) if isinstance(lens, tuple) else lens
    return f32(pallas_decode_attention(jq, jk, jv, ln, block_k=block_k, interpret=True))


@pytest.mark.parametrize("mode", SPLIT_MODES)
@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("B,Smax,Hq,Hkv,D,ln", SPLIT_CASES)
def test_split_k_decode_emulation_matches_plain_and_pallas(B, Smax, Hq, Hkv, D, ln, name, mode):
    _, tq = both(normal(0, B, Hq, D), name)
    _, tk = both(normal(1, B, Smax, Hkv, D), name)
    _, tv = both(normal(2, B, Smax, Hkv, D), name)
    splits, chunk = split_for(mode, B, Hkv, Smax, ln)
    if mode == "past":
        assert (splits - 1) * chunk >= Smax  # a split wholly past every length
    got = split_decode(tq, tk, tv, ln, splits, chunk)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(f32(got), f32(ref.decode_attention(tq, tk, tv, ln)), **tol(name))
    # block_k dividing Smax: the Pallas kernel's padding would join a no-slot average
    block_k = 32 if Smax % 64 else 64
    np.testing.assert_allclose(f32(got), _pallas_decode(B, Smax, Hq, Hkv, D, ln, name, block_k),
                               **tol(name))


@pytest.mark.parametrize("mode", SPLIT_MODES)
@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("lens", [(5, 77, 128), (0, 1, 128)])
def test_split_k_decode_emulation_per_sequence_lengths(lens, name, mode):
    """A (B,) length tensor: splits are sized from Smax, so a short sequence
    has splits wholly past its length, and a zero length averages all slots."""
    _, tq = both(normal(0, 3, 4, 32), name)
    _, tk = both(normal(1, 3, 128, 2, 32), name)
    _, tv = both(normal(2, 3, 128, 2, 32), name)
    tl = torch.tensor(lens, dtype=torch.int32)
    splits, chunk = split_for(mode, 3, 2, 128, tl)
    got = split_decode(tq, tk, tv, tl, splits, chunk)
    np.testing.assert_allclose(f32(got), f32(ref.decode_attention(tq, tk, tv, tl)), **tol(name))
    np.testing.assert_allclose(f32(got), _pallas_decode(3, 128, 4, 2, 32, lens, name, 32),
                               **tol(name))


@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,D,causal,window,off", FLASH_CASES + [
    (1, 64, 64, 2, 1, 64, True, 8, 100)])   # rows with no valid key
def test_flash_bf16_scheme_matches_pallas(B, Sq, Skv, Hq, Hkv, D, causal, window, off):
    (jq, tq), (jk, tk), (jv, tv) = (both(normal(i, B, s, h, D), "bfloat16")
                                    for i, (s, h) in enumerate([(Sq, Hq), (Skv, Hkv), (Skv, Hkv)]))
    kw = dict(causal=causal, window=window, kv_offset=off)
    got = ref.attention_bf16_scheme(tq, tk, tv, **kw).to(tq.dtype)
    want = pallas_flash_attention(jq, jk, jv, **kw, block_q=32, block_k=32, interpret=True)
    assert got.dtype == torch.bfloat16 and got.shape == tq.shape
    np.testing.assert_allclose(f32(got), f32(want), **tol("bfloat16"))
    np.testing.assert_allclose(f32(got), f32(ref.attention(tq, tk, tv, **kw)), **tol("bfloat16"))


# (B, Hkv, Smax, valid slots) of each served decode: internlm2's cache of
# prompt 1024 + 64 steps at its first and last step, hymba's full ring.
SERVED_DECODES = [(4, 8, 1089, 1025), (4, 8, 1089, 1088), (4, 5, 1024, 1024)]


@pytest.mark.parametrize("B,Hkv,Smax,ln", SERVED_DECODES)
def test_num_splits_fills_the_card_at_served_shapes(B, Hkv, Smax, ln):
    splits, chunk = split_plan(B, Hkv, Smax, ln, H100_SMS)
    assert B * Hkv * splits >= 2 * H100_SMS
    assert chunk >= MIN_SPLIT and (splits - 1) * chunk < ln <= splits * chunk


@pytest.mark.parametrize("bh", [1, 2, 5, 20, 32, 132, 264, 1000])
def test_num_splits_never_cuts_below_the_minimum(bh):
    for n in (1, 63, 64, 65, 127, 128, 1000, 1088, 4096, 16897, 100000):
        k = num_splits(bh, n, H100_SMS)
        assert k >= 1 and (k == 1 or n // k >= MIN_SPLIT)
        assert bh * k >= BLOCKS_PER_SM * H100_SMS or k == max(1, n // MIN_SPLIT)
        for cache_len in (n, torch.tensor([n])):
            smax = n + 7
            splits, chunk = split_plan(bh, 1, smax, cache_len, H100_SMS)
            covered = n if not isinstance(cache_len, torch.Tensor) else smax
            assert (splits - 1) * chunk < covered <= splits * chunk
            assert chunk >= min(MIN_SPLIT, covered)


# --- RMSNorm's host plan ------------------------------------------------------

@pytest.mark.parametrize("d,elem_bytes,rows", [
    (2048, 2, 4), (1600, 2, 4), (3200, 2, 2),   # the served widths in bf16 (internlm2, hymba)
    (2048, 4, 2), (64, 2, 16), (8, 2, 128), (100, 4, 4), (8192, 2, 1), (32768, 2, 1)])
def test_rmsnorm_plan_takes_the_vector_path_where_it_can(d, elem_bytes, rows):
    plan = rmsnorm_plan(d, elem_bytes, aligned=True)
    team = plan.threads // plan.rows
    assert plan.vec * elem_bytes == 16 and plan.vpt in VPT_CHOICES and plan.rows == rows
    assert team & (team - 1) == 0 and plan.threads % 32 == 0 and plan.threads <= 256
    assert plan.vpt * team * plan.vec >= d > (plan.vpt * team * plan.vec) // 2 or plan.vpt == 1


@pytest.mark.parametrize("d,elem_bytes,vpt", [(2048, 2, 1), (1600, 2, 1), (3200, 2, 2),
                                              (2048, 4, 2), (64, 2, 1)])
def test_rmsnorm_plan_spreads_a_few_rows_over_wide_blocks(d, elem_bytes, vpt):
    """A decode step's 4 rows: one block a row, as many threads as the row
    has vectors (up to 256), instead of four rows in one block of 128."""
    plan = rmsnorm_plan(d, elem_bytes, True, 4)
    nv = d * elem_bytes // 16
    team = min(256, 1 << (nv - 1).bit_length())
    assert plan.vpt == vpt and plan.vec * elem_bytes == 16
    assert plan.threads == max(32, team) and plan.rows == max(1, 32 // team)
    assert plan.vpt * plan.threads >= nv
    assert rmsnorm_plan(d, elem_bytes, True, 4096) == rmsnorm_plan(d, elem_bytes, True)


@pytest.mark.parametrize("d,elem_bytes,aligned", [
    (100, 2, True),      # d not a multiple of 8 bf16
    (2050, 4, True),     # nor of 4 f32
    (2048, 2, False),    # a pointer off 16 bytes
    (65536, 2, True)])   # wider than 256 threads of 16 vectors
def test_rmsnorm_plan_takes_the_scalar_path_where_it_must(d, elem_bytes, aligned):
    assert rmsnorm_plan(d, elem_bytes, aligned) == (1, 0, 256, 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_offset_view_is_not_aligned(dtype):
    """A contiguous view with a storage offset starts off 16 bytes, so the
    plan for it (as the wrapper makes it) is the scalar path."""
    flat = torch.zeros(1 + 6 * 2048, dtype=dtype)
    x = flat[1:].view(6, 2048)
    assert x.is_contiguous() and x.data_ptr() % 16
    assert rmsnorm_plan(2048, x.element_size(), x.data_ptr() % 16 == 0).vec == 1
    np.testing.assert_allclose(f32(rmsnorm(x, torch.ones(2048))), f32(x))
