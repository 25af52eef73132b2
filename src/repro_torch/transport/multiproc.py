"""Multi-process transport: one torch process per simulated node group
(port of ``repro/transport/multiproc.py``).

SNIPPETS.md §2's multi-controller model — each process owns its local
devices and must be launched explicitly — scaled down to one machine: every
worker is a torch process (``worker.py --torch --device cuda|cpu``) and each
shipped activation is landed on the worker's device and synchronised before
being echoed, so the bytes cross a process boundary *and* a host→device
buffer copy on the receiving side.

Node → process ownership follows the swarm's mobility groups when a
``group_of`` array is supplied (one worker process per group, the SNIPPETS
§2 "one process per host" unit), else round-robin over ``n_workers``.  On
the card every worker holds a CUDA context of its own on the one card, a
few hundred MB each: the swarm's executed mode spawns one per mobility
group (two for the default two-group scenario).

``device`` defaults to ``"cuda"``, like every entry point of the port.  A
``cuda`` worker with no card exits before its hello and :meth:`start`
raises with its exit code; a worker whose hello names another backend than
the one asked for fails :meth:`start` too.  Nothing falls back to the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from .loopback import LoopbackTransport


class MultiProcTransport(LoopbackTransport):
    name = "multiproc"

    def __init__(self, *, n_workers: int | None = None,
                 group_of: np.ndarray | None = None,
                 device: str | torch.device = "cuda",
                 timeout_s: float = 300.0):
        node_of = None
        if group_of is not None:
            group_of = np.asarray(group_of, np.int64)
            n_groups = int(group_of.max()) + 1 if group_of.size else 1
            n_workers = n_workers if n_workers is not None else n_groups
            node_of = {int(i): int(g) for i, g in enumerate(group_of)}
        super().__init__(n_workers=n_workers or 2, node_of=node_of,
                         timeout_s=timeout_s)
        self.device = str(torch.device(device))
