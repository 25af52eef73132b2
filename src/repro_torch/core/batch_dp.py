"""Batched min-plus DP sweep: one launch per epoch, not per request (the
port of ``repro/core/batch_dp.py``).

The sparse k-candidate DP (:mod:`repro_torch.core.ould`) solves each request
as an ``(M-1, k, k)`` min-plus sweep over pre-selected candidate nodes.
:func:`solve_batch` runs a whole batch of rows (one per distinct request
source) through one sweep on a device:

* rows are stacked ``(S, M, k)`` candidate/validity arrays from
  :func:`~repro_torch.core.ould._sparse_select_batch`;
* on the card the sweep is the hand-written CUDA kernel
  (``kernels/dp_sweep.py``, ``csrc/dp_sweep.cu``): all M-1 transitions in one
  launch, the transition entries gathered inside the kernel from ``spb``,
  which is pushed to the device once per topology and kept there; on the
  CPU it is the kernel's plain version (``kernels/ref.py::dp_sweep``);
* argmin backtracking recovers per-row placements on the host, vectorized
  over rows (O(S·M) index chasing, not worth a kernel).

Bit-identity contract
---------------------
The sweep reproduces :func:`~repro_torch.core.ould._sparse_run` bit for bit
(the admission decision of the greedy solve hangs on float comparisons
against the ``max_path_cost`` bar and the ``_BIG`` sentinel): all arithmetic
is f64 in the oracle's per-element operation order with no contraction
into FMAs, the back-pointer is numpy's first argmin, and the element
gathered for a transition is the very ``spb`` float the oracle reads.

Padding contract
----------------
Rows are padded up to the next power-of-two bucket (floor
:data:`MIN_BUCKET`) before the launch and sliced back after, as in the
reference: the launch shapes an epoch loop sees stay few.  Padded rows carry
source 0, candidates 0 and feasible bits, and are never read back.
:func:`compile_count` counts the distinct padded launch shapes
``(device type, Sp, M, k, cc is None)`` dispatched in this process, so
``ResolveStats.n_jit_compiles`` / ``cold_dispatch`` keep their meaning: the
solve paid for a first launch at a shape.  Under PyTorch nothing is traced
or compiled per shape; what a first launch at a new shape pays is the
caching allocator's first allocation of the padded inputs and outputs at
that size, and, on the very first launch in the process, the nvcc build of
the kernels (``kernels/build.py``; tens of seconds) and the library load.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.dp_sweep import dp_sweep

MIN_BUCKET = 8

_shapes: set[tuple] = set()          # padded launch shapes dispatched so far
_spb_cache: tuple | None = None      # (numpy spb, device, device spb): `is`-keyed


def bucket_rows(n_rows: int) -> int:
    """Pad ``n_rows`` up to the next power-of-two bucket (≥ MIN_BUCKET)."""
    b = MIN_BUCKET
    while b < n_rows:
        b *= 2
    return b


def compile_count() -> int:
    """Number of distinct padded launch shapes dispatched so far (tests pin
    the padding contract: same bucket ⇒ the count does not move)."""
    return len(_shapes)


def _device_spb(spb: np.ndarray, dev: torch.device) -> torch.Tensor:
    """The seconds-per-bit matrix on ``dev``, pushed once per topology.

    Keyed by object identity and device; holding the numpy reference keeps
    the id alive, so a stale hit is impossible.  One slot suffices — a solve
    works one topology at a time.
    """
    global _spb_cache
    if _spb_cache is None or _spb_cache[0] is not spb or _spb_cache[1] != dev:
        _spb_cache = (spb, dev, torch.from_numpy(np.ascontiguousarray(spb, np.float64)).to(dev))
    return _spb_cache[2]


def solve_batch(spb: np.ndarray, Ks: float, compute_cost: np.ndarray | None,
                srcs: np.ndarray, cand: np.ndarray, valid: np.ndarray,
                consts: tuple, device: str | torch.device = "cuda"
                ) -> tuple[list[np.ndarray | None], np.ndarray]:
    """Solve a batch of pruned DPs in one sweep on ``device``.

    ``srcs`` (S,) request sources; ``cand``/``valid`` (S, M, k) stacked
    per-row candidate selections (:func:`~repro_torch.core.ould._sparse_select`).
    Returns ``(paths, costs)`` — per row the argmin-backtracked placement
    (None when no finite path survives the feasibility penalty) and its
    cost, bit-identical to running :func:`~repro_torch.core.ould._sparse_run`
    on each row sequentially.  ``device="cuda"`` (the default) launches the
    kernel and raises without a card; ``"cpu"`` runs the plain version.
    """
    dev = resolve_device(device)
    S, M, kk = cand.shape
    Sp = bucket_rows(S)
    valid = np.asarray(valid, bool)
    if Sp != S:
        srcs = np.concatenate([srcs, np.zeros(Sp - S, srcs.dtype)])
        cand = np.concatenate([cand, np.zeros((Sp - S, M, kk), cand.dtype)])
        valid = np.concatenate([valid, np.ones((Sp - S, M, kk), bool)])
    _shapes.add((dev.type, Sp, M, kk, compute_cost is None))

    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

    f, b = dp_sweep(_device_spb(spb, dev), put(consts[0], np.float64), float(Ks),
                    put(srcs, np.int64), put(cand, np.int64), put(valid, bool),
                    None if compute_cost is None else put(compute_cost, np.float64))
    final = f[:S].cpu().numpy()
    backs = b[:, :S].cpu().numpy()
    # Vectorized backtrack — mirrors _sparse_run's per-row argmin walk.
    rows = np.arange(S)
    ends = np.argmin(final, axis=1)
    finite = np.isfinite(final[rows, ends])
    nodes = np.empty((S, M), np.int64)
    idx = ends.copy()
    nodes[:, M - 1] = cand[rows, M - 1, idx]
    for j in range(M - 1, 0, -1):
        idx = backs[j - 1, rows, idx]
        nodes[:, j - 1] = cand[rows, j - 1, idx]
    paths: list[np.ndarray | None] = [
        nodes[q] if finite[q] else None for q in range(S)]
    costs = np.where(finite, final[rows, ends], np.inf)
    return paths, costs
