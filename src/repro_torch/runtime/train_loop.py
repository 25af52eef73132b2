"""Fault-tolerant training loop (port of ``repro.runtime.train_loop``).

* **checkpoint/restart**: async checkpoints every ``ckpt_every`` steps with
  the data cursor saved alongside; ``run()`` resumes from the latest
  checkpoint, exactly (the synthetic pipeline is a pure function of (seed,
  step), and checkpoints hold every bit of params and optimizer state).
* **node-failure handling**: ``fail_at`` (tests) raises mid-run; the
  ``run_with_restarts`` wrapper plays the cluster scheduler and restarts.
  A restart onto a changed device set re-shards through
  ``CheckpointManager.restore(shardings=)``; the loop itself passes none, as
  the reference's does.
* **straggler mitigation**: each step's wall (ended by
  ``torch.cuda.synchronize()`` on the card) feeds an EWMA detector, which
  calls the ``on_straggler`` hook on a slow step (``elastic.py`` re-plans).
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Any, Callable

import torch

from ..checkpointing import AsyncCheckpointer, CheckpointManager
from ..configs.base import ModelConfig
from ..data import DataConfig, DataLoader
from ..device import resolve_device
from ..models import transformer
from ..optim import tree_map
from . import steps as steps_mod


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = dataclasses.field(
        default_factory=lambda: os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    keep: int = 3
    log_every: int = 10
    straggler_ewma: float = 0.9
    straggler_factor: float = 3.0   # step > factor x EWMA => straggler event


class StragglerDetector:
    def __init__(self, cfg: LoopConfig):
        self.cfg = cfg
        self.ewma: float | None = None
        self.events: list[int] = []

    def observe(self, step: int, dt: float) -> bool:
        if self.ewma is None:
            self.ewma = dt
            return False
        is_straggler = dt > self.cfg.straggler_factor * self.ewma
        self.ewma = (self.cfg.straggler_ewma * self.ewma
                     + (1 - self.cfg.straggler_ewma) * dt)
        if is_straggler:
            self.events.append(step)
        return is_straggler


def run(cfg: ModelConfig, tcfg: steps_mod.TrainConfig, lcfg: LoopConfig,
        dcfg: DataConfig, *, seed: int = 0,
        fail_at: Callable[[int], bool] | None = None,
        on_straggler: Callable[[int], None] | None = None,
        params: Any = None, device: str | torch.device = "cuda") -> dict:
    """Train with auto-resume on ``device``.  Returns summary metrics, the
    per-step walls and each checkpoint save's wall (the snapshot to the
    host, after the previous write) among them.  ``fail_at(step)`` lets
    tests inject a crash; ``run_with_restarts`` restarts the job as a
    cluster scheduler would.  ``params=None`` initialises from ``seed`` on
    ``device``; given ``params`` are copied, never trained in place, so a
    restart before the first checkpoint starts from them again (the
    reference's arrays are immutable)."""
    dev = resolve_device(device)
    mgr = CheckpointManager(lcfg.ckpt_dir, keep=lcfg.keep)
    ckpt = AsyncCheckpointer(mgr)
    train_step = steps_mod.make_train_step(cfg, tcfg)

    if params is None:
        params = transformer.init_params(seed, cfg, device=dev)
    else:
        params = tree_map(torch.clone, params)
    opt_state = steps_mod.init_opt_state(params, tcfg)
    start_step = 0

    latest = mgr.latest_step()
    if latest is not None:  # resume
        (params, opt_state), extra = mgr.restore(latest, (params, opt_state))
        start_step = int(extra["next_step"])

    loader = DataLoader(dcfg, start_step=start_step, device=dev)
    detector = StragglerDetector(lcfg)
    losses: list[float] = []
    walls: list[float] = []
    saves: list[float] = []
    step = start_step

    def save(step: int, extra: dict) -> None:
        t0 = time.perf_counter()
        ckpt.save(step, (params, opt_state), extra=extra)
        saves.append(time.perf_counter() - t0)
    try:
        for step in range(start_step, lcfg.total_steps):
            batch = next(loader)
            if fail_at is not None and fail_at(step):
                raise RuntimeError(f"injected node failure at step {step}")
            t0 = time.perf_counter()
            params, opt_state, metrics = train_step(params, opt_state, batch)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            dt = time.perf_counter() - t0
            walls.append(dt)
            if detector.observe(step, dt) and on_straggler is not None:
                on_straggler(step)
            losses.append(float(metrics["loss"]))
            if (step + 1) % lcfg.ckpt_every == 0:
                save(step, {"next_step": step + 1, "loss": losses[-1]})
        save(lcfg.total_steps - 1, {"next_step": lcfg.total_steps,
                                    "loss": losses[-1] if losses else float("nan")})
    finally:
        ckpt.wait()
        loader.close()
    return {"losses": losses, "walls": walls, "ckpt_walls": saves, "last_step": step,
            "straggler_events": detector.events,
            "params": params, "opt_state": opt_state}


def run_with_restarts(cfg, tcfg, lcfg, dcfg, *, max_restarts: int = 3,
                      fail_at=None, **kw) -> dict:
    """The cluster-scheduler wrapper: restart on failure up to N times.
    Each restart resumes from the latest atomic checkpoint."""
    attempts = 0
    while True:
        try:
            out = run(cfg, tcfg, lcfg, dcfg, fail_at=fail_at, **kw)
            out["restarts"] = attempts
            return out
        except RuntimeError:
            attempts += 1
            if attempts > max_restarts:
                raise
