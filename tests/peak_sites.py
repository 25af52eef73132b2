"""What rank 0 of a sharded train step holds at its peak, by the model
function that made each storage (the dry-run's trace on meta tensors).

    PYTHONPATH=src python tests/peak_sites.py xlstm_1p3b [--remat layer|group]
        [--layers 8] [--seq 1024] [--mesh single] [--top 12]
    PYTHONPATH=src python tests/peak_sites.py xlstm_1p3b --record [--remat group]

``--remat layer`` traces the port's step as it is (``transformer.forward``
checkpoints each layer); ``--remat group`` checkpoints each pattern group
instead, the reference's policy (its scan body), so the two can be set side
by side.  ``--record`` prints the dry-run's own per-device peak of the
published train_4k cell instead (``dryrun.run_cell``, whose length solve
traces xLSTM's sLSTM loop at shorter lengths: a 4096-step loop's graph
crashes a single trace).  Otherwise prints the trace's peak and, for the storages live at it, their
bytes by site (``launch/flops_by_site``'s sites: a backward op's under its
forward's name with "(backward)"), each with its largest shapes.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import pathlib
import sys
import warnings

import torch
from torch.utils.checkpoint import checkpoint

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch import configs as C  # noqa: E402
from repro_torch.configs.base import SHAPES, production_cfg  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import flops_by_site  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402


class LiveSites(D.Trace):
    """``dryrun.Trace`` that keeps (shape, dtype, site, bytes) of each
    storage live at its peak."""

    last: "LiveSites"

    def __init__(self, args):
        self._made: dict = {}
        self.at_peak: list = []
        super().__init__(args)
        LiveSites.last = self

    def _track(self, t):
        key = t.untyped_storage()._cdata
        if key not in self._alive:
            self._made[key] = (tuple(t.shape), t.dtype, flops_by_site._where()[0],
                               t.untyped_storage().nbytes())
        peak = self.peak
        super()._track(t)
        if self.peak > peak:
            self.at_peak = [self._made[k] for k in self._alive if k in self._made]

    def _free(self, key, n):
        self._made.pop(key, None)
        super()._free(key, n)


def group_remat_forward(params, cfg, batch, remat=False, keep_padded=False, *, plain=False):
    """``transformer.forward`` with each pattern group checkpointed whole."""
    T.check_config(cfg)
    x = T._embed_in(params, cfg, batch)
    positions = torch.arange(x.shape[1], device=x.device)
    period, blocks = len(cfg.block_pattern), params["blocks"]

    def group(x, *group_blocks):
        aux = sharding.replicated_like(torch.zeros((), dtype=torch.float32, device=x.device), x)
        for p in group_blocks:
            x, a = T._block_apply(p, cfg, x, positions, plain)
            aux = aux + a
        return x, aux

    auxs = []
    for g in range(0, len(blocks), period):
        gb = blocks[g:g + period]
        x, aux = checkpoint(group, x, *gb, use_reentrant=False) if remat else group(x, *gb)
        auxs.append(aux)
    return T._lm_logits(params, cfg, x, plain, keep_padded), torch.stack(auxs).sum()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("arch")
    ap.add_argument("--remat", choices=("layer", "group"), default="layer")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--mesh", choices=("single", "multi"), default="single")
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--record", action="store_true",
                    help="the dry-run's record of the published cell: its peak only")
    args = ap.parse_args(argv)
    warnings.filterwarnings("ignore")
    if args.remat == "group":
        T.forward = group_remat_forward
    if args.record:
        rec = D.run_cell(args.arch, "train_4k", args.mesh == "multi", save=False,
                         verbose=False)
        print(f"[peak_sites] {args.arch} train_4k on {args.mesh}, remat a {args.remat}: "
              f"{rec['status']}, rank 0 peak {rec['memory']['peak_memory_in_bytes'] / 1e9:.3f} "
              f"GB (the dry-run's record)")
        return
    cfg = production_cfg(C.get_config(args.arch))
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    shape = SHAPES["train_4k"]
    if args.seq:
        shape = dataclasses.replace(shape, seq_len=args.seq)
    D.Trace = LiveSites
    with torch.autograd.detect_anomaly(check_nan=False):
        res = D.trace(cfg, shape, shape.global_batch, mesh_name=args.mesh)
    by, n = collections.Counter(), collections.Counter()
    shapes: dict = collections.defaultdict(collections.Counter)
    for shp, dt, site, nb in LiveSites.last.at_peak:
        by[site] += nb
        n[site] += 1
        shapes[site][(shp, str(dt).replace("torch.", ""))] += nb
    print(f"[peak_sites] {args.arch} train (seq {shape.seq_len}, {cfg.n_layers} layers, batch "
          f"{shape.global_batch}) on {args.mesh}, remat a {args.remat}: rank 0 peak "
          f"{res['peak_bytes'] / 1e9:.3f} GB; live at it by site:")
    for site, b in by.most_common(args.top):
        top = ", ".join(f"{s} {d} {v / 1e6:.0f} MB" for (s, d), v in shapes[site].most_common(3))
        print(f"  {b / 1e9:8.3f} GB  {n[site]:5d}  {site}: {top}")


if __name__ == "__main__":
    main()
