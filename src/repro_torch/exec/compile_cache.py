"""The port's warm-start layer (port of ``repro/exec/compile_cache.py``).

The reference persists XLA's compiled executables on disk, so a node that
rejoins mid-scenario recompiles its stage closures from the cache.  The
port has no XLA compile.  What it compiles and persists is the nvcc build of
the hand-written kernels: ``kernels/build.py`` builds each ``csrc/*.cu`` into
``<dir>/<name>-<source hash>.so`` the first time any kernel launches (tens
of seconds for all five) and loads it with ctypes, so a process that finds
the libraries built pays a load, not a build.  The placed CNN's stages are
cuDNN and cuBLAS calls, for which torch persists nothing to disk: what a
rejoining node pays there is in-process (cuDNN's first calls, the caching
allocator's growth, the CUDA context), and a restart pays it again.  So:

* :func:`enable` — point the kernels' build directory at ``dir`` (default:
  the gitignored ``kernels/_build/``; there is no environment variable) and
  drop the handles loaded from the old one (``build.set_build_dir``), the
  hazard the reference's ``_reset_backend_cache`` exists for;
* :func:`disable` — back to the default directory, handles dropped;
* :func:`clear_in_memory` — drop what torch lets a process drop, standing
  in for a restart: the kernels' handle tables and, on the card, the caching
  allocator's blocks (``torch.cuda.empty_cache``).  The CUDA context and
  cuDNN's handles cannot be dropped in-process, so a warm pass after it
  still finds them; :func:`measure_warm_start` reports what it sees.
"""

from __future__ import annotations

import dataclasses
import os
import time
from pathlib import Path
from typing import Callable, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import build
from ..models import cnn

DEFAULT_DIR = build.DEFAULT_BUILD_DIR


def enable(cache_dir: str | os.PathLike | None = None) -> Path:
    """Build and load the kernels in ``cache_dir`` (default: the gitignored
    ``kernels/_build/``), created if missing; returns the directory."""
    path = Path(cache_dir) if cache_dir is not None else DEFAULT_DIR
    path.mkdir(parents=True, exist_ok=True)
    return build.set_build_dir(path)


def disable() -> None:
    """Back to the default build directory (loaded handles dropped)."""
    build.set_build_dir(DEFAULT_DIR)


def is_enabled() -> bool:
    """True while the build directory is one a caller chose over the default."""
    return build.BUILD_DIR != DEFAULT_DIR


def cache_dir() -> Path | None:
    """The chosen build directory, None while the default serves."""
    return build.BUILD_DIR if is_enabled() else None


def clear_in_memory() -> None:
    """Drop the kernels' loaded handles and the caching allocator's free
    blocks, what torch lets a process drop of a restart; the build directory
    is untouched, so the next launch loads from it (no nvcc)."""
    build.set_build_dir(build.BUILD_DIR)
    torch.cuda.empty_cache()     # a no-op where CUDA was never initialised


@dataclasses.dataclass(frozen=True)
class WarmStartReport:
    """Cold-vs-warm walls over one set of layer ranges."""

    ranges: tuple[tuple[int, int], ...]
    cold_s: tuple[float, ...]     # the ranges' first calls in this process
    warm_s: tuple[float, ...]     # the same calls after clear_in_memory()

    @property
    def cold_total_s(self) -> float:
        return float(sum(self.cold_s))

    @property
    def warm_total_s(self) -> float:
        return float(sum(self.warm_s))

    @property
    def speedup(self) -> float:
        return (self.cold_total_s / self.warm_total_s
                if self.warm_total_s > 0 else float("inf"))

    def summary(self) -> str:
        return (f"warm start: {len(self.ranges)} ranges, "
                f"cold {self.cold_total_s:.3f}s -> warm "
                f"{self.warm_total_s * 1e3:.1f}ms "
                f"({self.speedup:.1f}x)")


def measure_warm_start(layer_fns: Sequence[Callable],
                       ranges: Sequence[tuple[int, int]],
                       frame: np.ndarray, *, cache_dir: str | os.PathLike,
                       device: str | torch.device = "cuda") -> WarmStartReport:
    """Cold and warm walls of ``ranges`` on ``device`` (the card by default).

    The build directory points at ``cache_dir`` for the measurement.  Pass
    one runs each range once: the first calls of those ranges in a process
    that has not run them (cuDNN's first calls, allocator growth).  Then
    :func:`clear_in_memory` stands in for the process restart of a
    rejoining node and pass two runs the same ranges again.  ``ranges`` must
    chain from layer 0 (each start produced by an earlier range) so boundary
    activations can propagate; ``layer_fns`` hold their weights on
    ``device``.  Each wall ends in a synchronise.  The previous build
    directory is restored on exit.
    """
    ranges = tuple((int(s), int(e)) for s, e in ranges)
    if not ranges or ranges[0][0] != 0:
        raise ValueError(f"ranges must chain from layer 0, got {ranges}")
    dev = resolve_device(device)
    prev = build.BUILD_DIR
    enable(cache_dir)
    fns = list(layer_fns)

    def sync() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def timed_pass() -> list[float]:
        acts = {0: torch.from_numpy(np.ascontiguousarray(frame)[None]).to(dev)}
        walls = []
        for s, e in ranges:
            if s not in acts:
                raise ValueError(f"range ({s}, {e}) has no produced start")
            sync()
            t0 = time.perf_counter()
            with torch.inference_mode():
                acts[e] = cnn.apply_layers(fns, acts[s], s, e)
            sync()
            walls.append(time.perf_counter() - t0)
        return walls

    try:
        cold = timed_pass()
        clear_in_memory()                  # the "process restart"
        warm = timed_pass()
    finally:
        build.set_build_dir(prev)
    return WarmStartReport(ranges, tuple(cold), tuple(warm))
