"""Transport smoke CLI (port of ``repro/transport/__main__.py``).

    PYTHONPATH=src python -m repro_torch.transport --workers 2 --mb 4
    PYTHONPATH=src python -m repro_torch.transport --workers 2 --mb 4 --multiproc [--device cpu]

Ships random torch tensors (float32, bfloat16 and int32 in turn) through
worker OS processes, asserts that each comes back byte-exact, with its
dtype and shape, on the device it left, and prints realized bandwidth + the
worker PIDs (which must differ from the parent's — that is the "real
processes" claim, checked, not assumed).  ``--multiproc`` runs torch workers
that land each buffer on ``--device`` (default ``cuda``; the shipped
tensors live there too) instead of plain workers; without it the tensors
are host tensors unless ``--device`` is given, since plain workers touch no
device.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from ..device import resolve_device
from . import LoopbackTransport, MultiProcTransport

DTYPES = (torch.float32, torch.bfloat16, torch.int32)


def byte_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Same dtype, shape, device and bytes (NaN payloads included)."""
    if a.dtype != b.dtype or a.shape != b.shape or a.device != b.device:
        return False
    return torch.equal(a.contiguous().reshape(-1).view(torch.uint8),
                       b.contiguous().reshape(-1).view(torch.uint8))


def payload(rng: np.random.Generator, n: int, dtype: torch.dtype,
            device: torch.device) -> torch.Tensor:
    """``n`` elements of ``dtype`` from ``rng``, on ``device``."""
    if dtype == torch.int32:
        host = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, n, dtype=np.int32))
    else:
        host = torch.from_numpy(rng.standard_normal(n, dtype=np.float32)).to(dtype)
    return host.to(device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="transport loopback smoke")
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--mb", type=float, default=4.0,
                    help="payload size per shipment")
    ap.add_argument("--ships", type=int, default=4)
    ap.add_argument("--multiproc", action="store_true",
                    help="torch worker processes (device hop) instead of plain")
    ap.add_argument("--device", default=None,
                    help="cuda or cpu: where the tensors live and where --multiproc "
                         "workers land them (default: cuda with --multiproc, else cpu)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device or ("cuda" if args.multiproc else "cpu"))
    tp = (MultiProcTransport(n_workers=args.workers, device=dev) if args.multiproc
          else LoopbackTransport(n_workers=args.workers))
    rng = np.random.default_rng(0)
    with tp:
        pids = set(tp.worker_pids)
        if os.getpid() in pids or len(pids) != args.workers:
            print(f"FAIL: expected {args.workers} worker processes apart from the "
                  f"parent {os.getpid()}, got pids {sorted(pids)}", file=sys.stderr)
            return 1
        for i in range(args.ships):
            dtype = DTYPES[i % len(DTYPES)]
            n = max(1, int(args.mb * 1e6 / torch.empty(0, dtype=dtype).element_size()))
            x = payload(rng, n, dtype, dev)
            res = tp.ship(i % args.workers, (i + 1) % args.workers, x)
            if not byte_equal(res.array, x):
                print(f"FAIL: shipped {dtype} tensor came back different", file=sys.stderr)
                return 1
        moved = tp.moved_bytes / 1e6
        bw = [f"{s}->{d}: {ls.bytes_per_s / 1e6:.0f} MB/s"
              for (s, d), ls in sorted(tp.link_stats.items())]
        print(f"[transport] {tp.name}: {args.ships} shipments "
              f"({', '.join(str(d).removeprefix('torch.') for d in DTYPES[:args.ships])}) "
              f"on {dev}, byte-exact, {moved:.1f} MB moved through {len(pids)} worker "
              f"processes (pids {sorted(pids)}, parent {os.getpid()})")
        print(f"[transport] realized bandwidth: {', '.join(bw)}")
        if args.multiproc:
            print(f"[transport] worker backends: {tp.worker_backends} "
                  f"devices: {tp.worker_devices}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
