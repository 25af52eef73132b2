"""The port's kernels against the reference's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; it is held against
the reference's Pallas function in interpret mode over the same shape sweep
and tolerances as ``tests/test_kernels.py``.  Inputs come from a seeded numpy
generator and go to both packages.  The CUDA kernels themselves are held
against these plain versions on the card in ``tests/test_torch_gpu.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels.decode_attention import decode_attention as pallas_decode_attention
from repro.kernels.flash_attention import flash_attention as pallas_flash_attention
from repro.kernels.rmsnorm import rmsnorm as pallas_rmsnorm
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.rmsnorm import rmsnorm

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
