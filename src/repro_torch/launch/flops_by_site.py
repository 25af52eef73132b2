"""Rank 0's matmul FLOPs of a dry-run step split by the model code that
issued them, beside each site's share of the whole step (its FLOPs over the
chips): where a sharded step does more than its share, and which product.

    PYTHONPATH=src python -m repro_torch.launch.flops_by_site --arch xlstm_1p3b \\
        --shape train_4k --layers 8 --seq 512 [--mesh single] [--top 12]

A matmul-class op is put to the innermost frame of ``repro_torch/models`` on
its Python stack (a remat's recompute runs the model's code again, so it
lands there too); an op of the backward pass, which has no such frame, to
the frame that made the forward op it differentiates (autograd keeps the
forward's stack in anomaly mode).  A kernel wrapper's work (its meta
branch's ``cost.record``) counts under its site with the kernel's name
beside it, ``models/x.py fn [kernel]``.  Both traces run on meta tensors as
``dryrun.trace`` runs them: rank 0's program on a fake group of the
production mesh, and the unsharded step, at the cell's global batch.
``--layers`` and ``--seq`` cut the depth and the length; a cut to whole
pattern periods keeps each site's ratio to its share.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import math
import re
import traceback
import warnings

import torch

from .. import configs as C
from ..configs.base import SHAPES, production_cfg
from . import dryrun as D

_FRAME = re.compile(r'File "([^"]+)", line (\d+), in (\w+)')


def _site(frames: list[tuple[str, int, str]]) -> tuple[str, int] | None:
    """The innermost frame in the package's models: (``models/x.py fn``, line)."""
    for path, line, fn in reversed(frames):
        path = path.replace("\\", "/")
        if "/repro_torch/models/" in path:
            return f"models/{path.rsplit('/repro_torch/models/', 1)[1]} {fn}", line
    return None


def _where() -> tuple[str, int]:
    """An op's site (a function of the models, ``(backward)`` for the
    backward pass's ops) and the line within it."""
    here = _site([(f.filename, f.lineno, f.name) for f in traceback.extract_stack()])
    if here is not None:
        return here
    node = torch._C._current_autograd_node()
    stack = node.metadata.get("traceback_", []) if node is not None else []
    made = _site([(m[1], int(m[2]), m[3]) for s in stack for m in _FRAME.finditer(s)])
    return (f"{made[0]} (backward)", made[1]) if made else ("elsewhere", 0)


def by_site(cfg, shape, mesh_name: str | None
            ) -> tuple[collections.Counter, dict[str, set[int]]]:
    """Matmul FLOPs by site of one trace (rank 0's on ``mesh_name``, or the
    whole step with None), and the lines seen within each site; a kernel's
    work (``cost.record``) under its site with the kernel's name beside it,
    ``models/x.py fn [kernel]``."""
    flops: collections.Counter = collections.Counter()
    lines: dict[str, set[int]] = collections.defaultdict(set)

    class SiteTrace(D.Trace):
        """``dryrun.Trace`` that also adds each matmul-class op's FLOPs to
        its site."""

        def _info(self, func):
            composite, kind, flop, alloc_only, n_ret = super()._info(func)
            if flop is not None:
                def counted(*args, _flop=flop, **kwargs):
                    n = _flop(*args, **kwargs)
                    site, line = _where()
                    flops[site] += int(n)
                    lines[site].add(line)
                    return n
                flop = counted
            return composite, kind, flop, alloc_only, n_ret

        def record_kernel(self, kernel, work):
            super().record_kernel(kernel, work)
            site, line = _where()
            flops[f"{site} [{kernel}]"] += int(work.flops)
            lines[f"{site} [{kernel}]"].add(line)

    trace_cls = D.Trace
    D.Trace = SiteTrace
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with torch.autograd.detect_anomaly(check_nan=False):
                D.trace(cfg, shape, shape.global_batch, mesh_name=mesh_name)
    finally:
        D.Trace = trace_cls
    return flops, lines


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k", choices=sorted(SHAPES))
    ap.add_argument("--mesh", default="single", choices=sorted(D.MESHES))
    ap.add_argument("--layers", type=int, default=None, help="cut the depth")
    ap.add_argument("--seq", type=int, default=None, help="cut the sequence length")
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    cfg = production_cfg(C.get_config(args.arch))
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    shape = SHAPES[args.shape]
    if args.seq:
        shape = dataclasses.replace(shape, seq_len=args.seq)
    chips = math.prod(D.MESHES[args.mesh][0].values())
    rank, lines = by_site(cfg, shape, args.mesh)
    step, _ = by_site(cfg, shape, None)
    total_r, total_s = sum(rank.values()), sum(step.values())
    print(f"[flops_by_site] {args.arch} {shape.name} (seq {shape.seq_len}, "
          f"{cfg.n_layers} layers, batch {shape.global_batch}) on {args.mesh} ({chips} chips): "
          f"rank 0 {total_r:.4e} matmul FLOPs, share {total_s / chips:.4e} "
          f"({total_r * chips / total_s:.3f} x)")
    rows = sorted(set(rank) | set(step), key=lambda k: rank[k] - step[k] / chips, reverse=True)
    for k in rows[:args.top]:
        share = step[k] / chips
        at = ",".join(map(str, sorted(lines.get(k, ()))))
        print(f"  {k} (lines {at}): rank 0 {rank[k]:.4e}, share {share:.4e}, "
              f"over {rank[k] - share:.4e}"
              + (f" ({rank[k] / share:.2f} x)" if share else ""))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
