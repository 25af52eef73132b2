"""The DP sweep kernel's host plan and a numpy model of its schedule, on the
CPU (``kernels/dp_sweep.py``, ``csrc/dp_sweep.cu``).

The kernel itself runs only on the card (``tests/test_torch_gpu.py``).  Here:

* ``sweep_plan`` fits the H100 (232,448 shared bytes, 1024 threads a block)
  at every k the kernel takes, at LeNet's M 7 and VGG-16's M 18, and
  refuses the first k above its cap; at k 1, 65, 128, 512 and 1024 it keeps
  the candidates in shared memory up to its envelope in M and runs the ring
  without them past it;
* the kernel's argmin -- lanes holding strided predecessors, tiles in
  ascending order, then a shuffle butterfly, under the source's total order
  -- is numpy's ``argmin`` and the value at that index, on drawn columns
  with ties, +inf and NaNs anywhere;
* a numpy model of the whole kernel (its staging ring, tile by tile, with
  the same index arithmetic) equals the oracle ``repro/core/ould.py::
  _sparse_run`` bit for bit, for the plans the wrapper makes and for
  small hand-made plans that drive the ring:

    PYTHONPATH=src python -m pytest -q tests/test_torch_sweep_plan.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core import ould as j_ould  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.dp_sweep import (  # noqa: E402
    MAX_K, MAX_THREADS, SMEM_BYTES, SweepPlan, lanes_for, smem_bytes, stagers_for, sweep_plan)

INT_MAX = 2 ** 31 - 1
H100_SMS = 132
I64 = np.iinfo(np.int64)


def order_key(v):
    """``csrc/dp_sweep.cu::order_key``, elementwise: every NaN lowest, -0 as
    +0, otherwise the double's bits made monotone."""
    x = np.asarray(v, np.float64).view(np.int64).copy()
    nan = (x & I64.max) > 0x7FF0000000000000
    x[x == I64.min] = 0
    x = np.where(x < 0, x ^ I64.max, x)
    return np.where(nan, I64.min, x)


def before(key, i, other, j):
    """``csrc/dp_sweep.cu::before``: the smaller key, the smaller index
    first on equal keys."""
    return (key < other) | ((key == other) & (i < j))


def butterfly(key, best, arg, lanes):
    """The xor-shuffle merge of each group of ``lanes`` neighbouring lanes;
    every lane ends with its group's winner."""
    idx = np.arange(best.size)
    off = lanes // 2
    while off:
        ok, ov, oi = key[idx ^ off], best[idx ^ off], arg[idx ^ off]
        take = before(ok, oi, key, arg)
        key, best, arg = (np.where(take, ok, key), np.where(take, ov, best),
                          np.where(take, oi, arg))
        off //= 2
    return key, best, arg


CHUNK = 8  # csrc/dp_sweep.cu::kChunk


def fold(key, best, arg, kx, v, at):
    """A lane's fold of its steps of one tile (ascending a) as the kernel
    does it: chunks of ``CHUNK``, each reduced by a tree in which the later
    half wins only on a strictly smaller key, then the running pair takes
    the chunk's winner only on a strictly smaller key."""
    for c0 in range(0, len(kx), CHUNK):
        ck = list(kx[c0:c0 + CHUNK]) + [I64.max] * (CHUNK - len(kx[c0:c0 + CHUNK]))
        cv, ca = list(v[c0:c0 + CHUNK]) + [0.0] * CHUNK, list(at[c0:c0 + CHUNK]) + [0] * CHUNK
        span = 1
        while span < CHUNK:
            for u in range(0, CHUNK - span, 2 * span):
                if ck[u + span] < ck[u]:
                    ck[u], cv[u], ca[u] = ck[u + span], cv[u + span], ca[u + span]
            span *= 2
        if ck[0] < key:
            key, best, arg = ck[0], cv[0], ca[0]
    return key, best, arg


def merge_model(col, lanes, tile):
    """One column's argmin as the kernel takes it: tiles of ``tile`` a in
    ascending order, lane l folding a = a0 + l, a0 + l + lanes, ... into its
    running pair (``fold``), then the butterfly (``before``)."""
    k = col.size
    key, best, arg = np.full(lanes, I64.max), np.full(lanes, np.inf), np.full(lanes, INT_MAX)
    for a0 in range(0, k, tile):
        for lane in range(lanes):
            at = list(range(a0 + lane, min(a0 + tile, k), lanes))
            key[lane], best[lane], arg[lane] = fold(key[lane], best[lane], arg[lane],
                                                    order_key(col[at]), col[at], at)
    key, best, arg = butterfly(key, best, arg, lanes)
    assert (arg[0] == arg).all()
    return best[0], int(arg[0])


def kernel_model(plan: SweepPlan, spb, Kv, Ks, srcs, cand, valid, cc):
    """The kernel's schedule in numpy, one row at a time: the staging ring
    (copies of tile i + ahead issued before tile i is reduced and formed
    after it, into slot (i + ahead) % slots; where every tile is staged at
    once, a layer repeating the previous layer's candidates copies nothing
    and is formed from its source's raw entries), the lanes' running pairs
    and the butterfly at each layer's last tile.  Stale slot contents are
    NaN, so a slot read before it is staged, or overwritten before it is
    read, shows in the result."""
    S, M, k = cand.shape
    Q, L, TA, NS, ahead = plan.stagers, plan.lanes, plan.tile, plan.slots, plan.ahead
    RT, RP, tpl = k * Q, k * L, -(-k // TA)  # a row's threads; those in the pass
    n_tiles = (M - 1) * tpl
    whole = ahead == n_tiles
    assert plan.threads >= plan.rows * RT and plan.threads % 32 == 0 and L <= Q
    assert 1 <= TA <= k and (ahead == n_tiles == NS or ahead < NS) and ahead <= n_tiles
    lt = np.arange(RT)
    cs, q = lt // Q, lt % Q                     # staging: column cs, predecessors q + u * Q
    b, lane = np.arange(RP) // L, np.arange(RP) % L  # the pass: column b, lane + u * L
    final = np.empty((S, k))
    backs = np.empty((max(M - 1, 0), S, k), np.int64)

    def entries(t):  # every (thread, a_local) staged for tile t: q + u * Q
        al = q[:, None] + Q * np.arange(-(-TA // Q))[None, :]
        keep = al < min(TA, k - (t % tpl) * TA)
        return np.broadcast_to(lt[:, None], al.shape)[keep], al[keep]

    for row in range(S):
        cnd, vld = cand[row], valid[row]
        dif = np.r_[True, (cnd[1:] != cnd[:-1]).any(axis=1)]

        def repeats(jj):
            return whole and 0 < jj < 63 and not dif[jj] and not dif[jj + 1]

        slab = np.full((max(NS, 1), k, TA | 1), np.nan)
        ccp = np.full((max(NS, 1), RT), np.nan)

        def issue(t0, t1):
            for t in range(t0, t1):
                jj, a0, s = t // tpl, (t % tpl) * TA, t % NS
                if cc is not None:
                    ccp[s] = cc[jj + 1, cnd[jj + 1, cs]]
                if repeats(jj):
                    continue
                th, al = entries(t)
                slab[s, cs[th], al] = spb[cnd[jj, a0 + al], cnd[jj + 1, cs[th]]]

        def form(t0, t1):
            for t in range(t0, t1):
                jj, s = t // tpl, t % NS
                if repeats(jj):
                    continue
                run = 1
                while jj + run < M - 1 and repeats(jj + run):
                    run += 1
                th, al = entries(t)
                raw = slab[s, cs[th], al].copy()
                for u in range(run):
                    su = s + u * tpl
                    with np.errstate(invalid="ignore"):
                        v = Kv[jj + u] * raw + np.where(vld[jj + u + 1, cs[th]], 0.0, np.inf)
                    if cc is not None:
                        v = v + ccp[su, th]
                    slab[su, cs[th], al] = v

        cost = np.full((2, k), np.nan)
        c0 = Ks * spb[srcs[row], cnd[0]] + np.where(vld[0], 0.0, np.inf)
        cost[0] = c0 if cc is None else c0 + cc[0, cnd[0]]
        carried = cost[0].copy()
        if ahead:
            issue(0, ahead)
            form(0, ahead)
        cur = 0
        key, best, arg = np.full(RP, I64.max), np.full(RP, np.inf), np.full(RP, INT_MAX)
        for i in range(n_tiles):
            nt = i + ahead
            if nt < n_tiles:
                issue(nt, nt + 1)
            jj, a0 = i // tpl, (i % tpl) * TA
            ta = min(TA, k - a0)
            with np.errstate(invalid="ignore"):
                v_all = cost[cur, a0:a0 + ta][None, :] + slab[i % NS, b, :ta]  # (RP, ta)
            for th in range(RP):
                at = list(range(lane[th], ta, L))
                key[th], best[th], arg[th] = fold(key[th], best[th], arg[th],
                                                  order_key(v_all[th, at]), v_all[th, at],
                                                  [a0 + x for x in at])
            if i % tpl == tpl - 1:
                key, best, arg = butterfly(key, best, arg, L)
                own = lane == 0
                cost[cur ^ 1, b[own]] = best[own]
                backs[jj, row, b[own]] = arg[own]
                carried = cost[cur ^ 1].copy()
                key, arg = np.full(RP, I64.max), np.full(RP, INT_MAX)
                cur ^= 1
            if nt < n_tiles:
                form(nt, nt + 1)
        final[row] = carried
    return final, backs


def oracle(spb, Ks, srcs, cc, cand, valid, Kv):
    """Per row, ``_sparse_run``'s sweep: final costs and back-pointers."""
    S, M, k = cand.shape
    finals, backs = [], []
    for q in range(S):
        pen = np.where(valid[q], 0.0, np.inf)
        cost = Ks * spb[srcs[q], cand[q][0]] + pen[0]
        if cc is not None:
            cost = cost + cc[0, cand[q][0]]
        with np.errstate(invalid="ignore"):
            trans = Kv[:M - 1, None, None] * spb[cand[q][:-1, :, None], cand[q][1:, None, :]]
        trans += pen[1:, None, :]
        if cc is not None:
            trans += cc[np.arange(1, M)[:, None], cand[q][1:]][:, None, :]
        bq = np.empty((M - 1, k), np.int64)
        for j in range(1, M):
            with np.errstate(invalid="ignore"):
                step = cost[:, None] + trans[j - 1]
            bq[j - 1] = step.argmin(axis=0)
            cost = step[bq[j - 1], np.arange(k)]
        finals.append(cost)
        backs.append(bq)
    return np.stack(finals), np.stack(backs, axis=1).reshape(M - 1, S, k)


def sweep_inputs(seed, N, S, M, k, with_cc, inf_share, nan=False, same=()):
    """``tests/test_torch_gpu.py::sweep_inputs`` in numpy: spb with
    disconnected (1e12) pairs and a zero diagonal, sorted candidates, a share
    infeasible; with ``nan``, infinite links and a zero-byte layer, so
    0 x inf makes NaNs; the layers in ``same`` keep the previous layer's
    candidates."""
    rng = np.random.default_rng(seed)
    spb = rng.uniform(0, 1e-6, (N, N))
    spb[rng.random((N, N)) < 0.05] = 1e12
    Kv = rng.uniform(1e3, 1e7, M)
    if nan:
        spb[rng.random((N, N)) < 0.2] = np.inf
        Kv[min(2, M - 1)] = 0.0
    np.fill_diagonal(spb, 0.0)
    cand = np.sort(rng.integers(0, N, (S, M, k)), axis=2)
    for x in same:
        cand[:, x] = cand[:, x - 1]
    return (spb, Kv, float(rng.uniform(1e5, 1e6)), rng.integers(0, N, S), cand,
            rng.random((S, M, k)) >= inf_share, rng.uniform(0, 1e-3, (M, N)) if with_cc else None)


def assert_bits(got, want):
    (gf, gb), (wf, wb) = got, want
    assert gf.shape == wf.shape and gb.shape == wb.shape
    assert np.array_equal(np.isnan(gf), np.isnan(wf))
    assert np.nan_to_num(gf).tobytes() == np.nan_to_num(wf).tobytes()
    np.testing.assert_array_equal(gb, wb)


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_cc", [False, True])
@pytest.mark.parametrize("M", [7, 18])
def test_sweep_plan_fits_the_card_at_every_k(M, with_cc):
    assert MAX_K >= 1024
    for k in range(1, MAX_K + 1):
        for S in (1, 64, 1024):
            p = sweep_plan(S, M, k, with_cc, H100_SMS)
            rt = k * p.stagers
            assert p.smem == smem_bytes(M, k, p.rows, p.stagers, p.tile, p.slots, with_cc,
                                        p.resident)
            assert p.resident and p.smem <= SMEM_BYTES and p.threads <= MAX_THREADS
            assert p.threads % 32 == 0 and p.threads - 32 < p.rows * rt <= p.threads
            assert p.lanes in (1, 2, 4, 8) and p.lanes == lanes_for(k)  # what lanes_for yields
            assert p.lanes <= p.stagers == stagers_for(k) <= 32
            assert p.threads <= 544 or p.lanes == p.stagers == 1
            assert p.grid * p.rows >= S > (p.grid - 1) * p.rows
            n_tiles = (M - 1) * -(-k // p.tile)
            assert 1 <= p.tile <= k
            assert (p.ahead == n_tiles == p.slots) or (2 <= p.slots and p.ahead == p.slots - 1)
    with pytest.raises(ValueError, match=f"k {MAX_K + 1} outside 1..{MAX_K}"):
        sweep_plan(8, M, MAX_K + 1, with_cc, H100_SMS)


@pytest.mark.parametrize("S,M,k", [(64, 7, 32), (32, 18, 16), (64, 7, 65)])
def test_sweep_plan_stages_the_placement_path_whole(S, M, k):
    """The first launches of the S7, VGG-16 N 256 and LeNet N 4097 swarms:
    every layer staged before the serial pass, a row a block, all k columns
    side by side."""
    for with_cc in (False, True):
        p = sweep_plan(S, M, k, with_cc, H100_SMS)
        assert (p.tile, p.slots, p.ahead, p.rows, p.grid) == (k, M - 1, M - 1, 1, S)
        assert k * p.stagers <= p.threads and (p.stagers, p.lanes) == (stagers_for(k), lanes_for(k))


# The largest M at each k, without and with a compute cost, whose
# candidates, feasibility bytes and Kv (5·M·k + 8·M) fit in shared memory
# beside a ring of two tiles.
M_ENVELOPE = [(1, 17877, 17876), (65, 691, 666), (128, 352, 339), (512, 84, 80),
              (1024, 38, 35)]


@pytest.mark.parametrize("with_cc", [False, True])
@pytest.mark.parametrize("k,m_plain,m_cc", M_ENVELOPE)
def test_sweep_plan_keeps_candidates_resident_up_to_its_envelope(k, m_plain, m_cc, with_cc):
    """Up to the envelope the candidates sit in shared memory; past it the
    ring runs without them, at any M."""
    top = m_cc if with_cc else m_plain
    for S in (1, 64):
        for M in (top, top + 1, 20 * top):
            p = sweep_plan(S, M, k, with_cc, H100_SMS)
            assert p.resident == (M == top)
            assert p.smem <= SMEM_BYTES and p.threads <= MAX_THREADS
            assert p.smem == smem_bytes(M, k, p.rows, p.stagers, p.tile, p.slots, with_cc,
                                        p.resident)
            assert p.slots >= 2 and p.ahead == p.slots - 1 and p.grid * p.rows >= S


def test_sweep_plan_spreads_rows_over_the_cards_sms():
    """Narrow rows share a block only as far as the rows outnumber the SMs."""
    assert sweep_plan(64, 7, 4, False, 132).rows == 1
    assert sweep_plan(264, 7, 4, False, 132).rows == 2
    assert sweep_plan(264, 7, 4, False, 66).rows == 4
    assert sweep_plan(264, 7, 4, False, 264).rows == 1


def test_lanes_fold_about_eight_and_stagers_fill_the_block():
    ks = (1, 2, 3, 8, 15, 16, 17, 32, 33, 64, 65, 128, 129, 257, 513, 545, 1024)
    assert [lanes_for(k) for k in ks] == [1, 1, 1, 1, 1, 2, 2, 4, 4, 8, 8, 4, 4, 2, 1, 1, 1]
    assert [stagers_for(k) for k in ks] == [1, 2, 4, 8, 16, 16, 8, 8, 4, 8, 8, 4, 4, 2, 1, 1, 1]


# ---------------------------------------------------------------------------
# the merge
# ---------------------------------------------------------------------------

VALUES = st.sampled_from([0.0, -0.0, 1.0, 2.5, 1e-300, -1.0, -2.5, np.inf, -np.inf, np.nan])


@settings(max_examples=300, deadline=None)
@given(col=st.lists(VALUES, min_size=1, max_size=80), lanes_log=st.integers(0, 5),
       tile_frac=st.floats(0.0, 1.0))
def test_merge_model_is_numpy_argmin(col, lanes_log, tile_frac):
    col = np.array(col)
    tile = max(1, int(round(tile_frac * col.size)))
    v, i = merge_model(col, 2 ** lanes_log, tile)
    assert i == int(np.argmin(col))
    assert (np.isnan(v) and np.isnan(col[i])) or v == col[i]
    assert np.signbit(v) == np.signbit(col[i])


@pytest.mark.parametrize("fill", [np.inf, np.nan])
@pytest.mark.parametrize("lanes", [1, 4, 32])
def test_merge_model_on_uniform_columns(fill, lanes):
    """A column of +inf: a = 0, as numpy's argmin; all NaN: the first."""
    for k in (1, 5, 33, 70):
        v, i = merge_model(np.full(k, fill), lanes, max(1, k // 3))
        assert i == 0 and (v == fill or (np.isnan(v) and np.isnan(fill)))


# ---------------------------------------------------------------------------
# the whole schedule
# ---------------------------------------------------------------------------

MODEL_CASES = [  # seed, N, S, M, k, with compute cost, infeasible share, NaNs
    (0, 48, 3, 7, 4, False, 0.0, False), (1, 64, 2, 18, 16, True, 0.2, False),
    (2, 96, 2, 7, 33, True, 0.3, False), (3, 120, 1, 7, 65, False, 0.3, False),
    (4, 40, 4, 5, 6, True, 1.0, False), (5, 40, 3, 6, 9, True, 0.2, True),
    (6, 300, 1, 3, 128, False, 0.3, False), (7, 30, 2, 1, 5, True, 0.0, False)]


@pytest.mark.parametrize("case", MODEL_CASES)
def test_kernel_model_with_the_wrappers_plan_equals_sparse_run(case):
    seed, N, S, M, k, with_cc, inf_share, nan = case
    spb, Kv, Ks, srcs, cand, valid, cc = sweep_inputs(seed, N, S, M, k, with_cc, inf_share, nan)
    got = kernel_model(sweep_plan(S, M, k, with_cc, H100_SMS), spb, Kv, Ks, srcs, cand, valid, cc)
    assert_bits(got, oracle(spb, Ks, srcs, cc, cand, valid, Kv))


SAME_CASES = [  # M, k, layers that keep the previous layer's candidates
    (7, 32, (1, 2, 3, 4, 5, 6)), (18, 16, tuple(range(1, 18))), (7, 65, (1, 2, 3, 4, 5, 6)),
    (7, 9, (1, 2, 4, 5)), (8, 6, (2, 3, 4, 7)), (6, 5, (1,)), (6, 5, (5,)),
    (70, 3, tuple(range(1, 70)))]  # from layer 63 on, every layer gathers


@pytest.mark.parametrize("with_cc", [False, True])
@pytest.mark.parametrize("M,k,same", SAME_CASES)
def test_kernel_model_with_repeated_candidates_equals_sparse_run(M, k, same, with_cc):
    """Layers whose candidate pair repeats the previous layer's copy no spb
    entry and are formed from their source's raw entries: all layers on one
    set (the placement path's rows), runs broken in the middle, a lone
    repeat."""
    S = 3
    spb, Kv, Ks, srcs, cand, valid, cc = sweep_inputs(M * k, 4 * k, S, M, k, with_cc, 0.3,
                                                      nan=k == 9, same=same)
    got = kernel_model(sweep_plan(S, M, k, with_cc, H100_SMS), spb, Kv, Ks, srcs, cand, valid, cc)
    assert_bits(got, oracle(spb, Ks, srcs, cc, cand, valid, Kv))


RING_PLANS = [  # k, stagers, lanes, tile, slots, ahead: tiles cycling through a ring
    (7, 2, 2, 3, 2, 1), (7, 4, 1, 3, 3, 2), (7, 8, 4, 7, 2, 1), (9, 1, 1, 2, 4, 3),
    (10, 4, 4, 4, 5, 4), (5, 2, 2, 1, 2, 1), (40, 32, 8, 13, 3, 2)]


@pytest.mark.parametrize("with_cc", [False, True])
@pytest.mark.parametrize("k,stagers,lanes,tile,slots,ahead", RING_PLANS)
def test_kernel_model_through_a_ring_equals_sparse_run(k, stagers, lanes, tile, slots, ahead,
                                                       with_cc):
    """Plans smaller than the wrapper would make, so that small shapes
    cycle tiles, ragged ones included, through the ring."""
    M, S = 6, 3
    spb, Kv, Ks, srcs, cand, valid, cc = sweep_inputs(k + slots, 40, S, M, k, with_cc, 0.2,
                                                      nan=tile == 1)
    rows = 1
    plan = SweepPlan(-(-k * stagers // 32) * 32, rows, stagers, lanes, tile, slots, ahead,
                     True, smem_bytes(M, k, rows, stagers, tile, slots, with_cc), S)
    got = kernel_model(plan, spb, Kv, Ks, srcs, cand, valid, cc)
    assert_bits(got, oracle(spb, Ks, srcs, cc, cand, valid, Kv))


def test_oracle_here_is_sparse_run_and_the_plain_sweep():
    """The oracle above is ``_sparse_run``'s sweep: its back-pointers walk
    to the reference's path, and the plain version equals it bit for bit."""
    spb, Kv, Ks, srcs, cand, valid, cc = sweep_inputs(11, 64, 4, 7, 12, True, 0.2)
    consts = (Kv, None, None, None)
    f, b = oracle(spb, Ks, srcs, cc, cand, valid, Kv)
    pf, pb = ref.dp_sweep(*(torch.from_numpy(a) for a in (spb, Kv)), Ks,
                          *(torch.from_numpy(a) for a in (srcs, cand, valid, cc)))
    assert_bits((pf.numpy(), pb.numpy()), (f, b))
    for q in range(len(srcs)):
        path, cost = j_ould._sparse_run(spb, Ks, int(srcs[q]), cc, cand[q], valid[q], consts)
        end = int(np.argmin(f[q]))
        if path is None:
            assert not np.isfinite(f[q, end])
            continue
        assert cost == f[q, end]
        idx, nodes = end, [cand[q, -1, end]]
        for j in range(cand.shape[1] - 1, 0, -1):
            idx = b[j - 1, q, idx]
            nodes.append(cand[q, j - 1, idx])
        np.testing.assert_array_equal(path, nodes[::-1])
